"""The port's data-parallel train step against the JAX package's: a JAX
dp=8 sharded step (8 virtual CPU devices, node-sharded histories, graph,
features and labels, owner-routed transports) and the port's dp=2 step
(two gloo ranks, parallel/checks.py::train_steps) take the same three
JAX-drawn schedules, the same params and histories and the same numpy
dropout masks and Gaussian noise, seeded by the whole tensor's shape as in
test_torch_estimators.py's ``shared_noise`` (each rank takes its rows).
After 3 steps each step's loss, the params and the histories must match to
rtol 1e-4 / atol 1e-6, for CV+PP, CVD+PP, Exact and det-dropout+PP (float32
histories, so the tolerance is not a bfloat16 rounding step).

Under ``--owner_batching`` the field layout depends on the width, so the
JAX step runs on the first 2 virtual devices (dp=2, owner-aligned packs
from ``JS.schedule(owner_blocks=2)`` of owner-grouped batches) against the
port's dp=2 step: the losses, the params, the Adam first moments (a
decaying sum of the gradients) and the histories within rtol 1e-5 / atol
1e-6.  So do the halo transports' two other settings at dp=2, on shuffled
packs: ``--scatter_cap_mult 0.25`` on the append-only layout (the input
field's 48 rows a rank, in draw order, meet a capacity of 8, so the
history scatter drops writes, the same ones in both packages; no dropout,
so repeated ids write equal rows; a dedup-compacted field is sorted by id,
so each rank's block is mostly its own and hardly drops) and
``--halo_exchange false`` (exact accesses; JAX's step then takes no halo
spec and GSPMD lowers every access, which writes the sentinel row N that
the port's mesh skips, so the histories are held on their node rows);
each step's ``hist_dropped`` must be equal too.  The capacity case then
runs two evaluation steps on the first nodes in id order, as the CV
refresh before a prediction walks them, where the eval-history scatter
drops too: the class probabilities and refreshed histories within the
same tolerance.  Every other case drops nothing."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.data import loaders as JLd
from stochastic_gcn_tpu.models import gcn as JM
from stochastic_gcn_tpu.ops import layers as JL
from stochastic_gcn_tpu.parallel import mesh as JMesh
from stochastic_gcn_tpu.parallel.mesh import (_halo_spec, data_shardings,
                                              make_mesh, state_shardings)
from stochastic_gcn_tpu.sampler import scheduler as JS
from stochastic_gcn_tpu.training import step as JStep

from stochastic_gcn_tpu_torch.parallel import checks, launch

N_NODES, WIDTH, STEPS, JAX_DP, PORT_DP = 240, 30, 3, 8, 2
TOL = dict(rtol=1e-4, atol=1e-6)
OWNER_TOL = dict(rtol=1e-5, atol=1e-6)
ESTIMATORS = {
    "cv_pp": dict(cv=True, test_cv=True, degree=2, field_dedup=True),
    "cvd_pp": dict(cv=True, cvd=True, test_cv=True, test_cvd=True, degree=2,
                   field_dedup=True),
    "exact": dict(cv=False, test_cv=False, degree=10000, preprocess=False,
                  test_preprocess=False),
    "det_dropout_pp": dict(cv=True, det_dropout=True, test_cv=True,
                           degree=2),
}


def _cfg(name):
    return Config(**{**dict(batch_size=32, hidden1=16,
                            normalization="graphsage", layer_norm=True,
                            num_fc_layers=2, weight_decay=5e-4, dropout=0.2,
                            pad_degree=64, seed=1, dp=JAX_DP,
                            history_dtype="float32",
                            test_batch_size=32), **ESTIMATORS[name]})


def _rng(shape, salt):
    return np.random.default_rng([salt, len(shape), *shape])


@pytest.fixture
def jax_noise(monkeypatch):
    """checks.shape_seeded_noise's masks and noise on the JAX side."""
    def dropout(key, x, keep_prob):
        if keep_prob >= 1.0:
            return x
        keep = _rng(x.shape, 1).random(x.shape) < keep_prob
        return jnp.where(jnp.asarray(keep), x, 0.0) * (1.0 / keep_prob)

    monkeypatch.setattr(JL, "dropout", dropout)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            _rng(tuple(shape), 2).standard_normal(
                                tuple(shape)).astype(np.float32)))


def _put_pack(arrays, pre, pack):
    for i, f in enumerate(pack.fields):
        arrays[f"{pre}:field{i}"] = np.asarray(f)
    for l, ls in enumerate(pack.layers):
        arrays[f"{pre}:pos{l}"] = np.asarray(ls.slot_pos)
        arrays[f"{pre}:w{l}"] = np.asarray(ls.slot_w)
        arrays[f"{pre}:scales{l}"] = np.asarray(ls.scales)
        if ls.slot_aw is not None:
            arrays[f"{pre}:aw{l}"] = np.asarray(ls.slot_aw)
        if ls.self_pos is not None:
            arrays[f"{pre}:self{l}"] = np.asarray(ls.self_pos)


def _jax_run(name, ds, jg, feats, out, dp=JAX_DP, owner=False, over=None,
             evals=0):
    """Three JAX steps at width ``dp`` (owner-aligned with ``owner``; the
    config's fields ``over`` replaced), then with ``evals`` that many
    evaluation steps of the trained state (JAX ``build_eval_epoch``'s
    forward and history scatter) on the first nodes in id order, as the
    CV refresh before a prediction walks them; their inputs go to ``out``
    for the port.  Returns the config, each step's loss and
    ``hist_dropped``, the state, and the evaluation's class probabilities
    ([E, B, C]), refreshed histories and dropped counts."""
    cfg = _cfg(name).replace(dp=dp, owner_batching=owner, **(over or {}))
    n = ds.num_data
    spec = JM.build_model_spec(cfg, ds.feature_dim, ds.num_classes,
                               cfg.preprocess, cfg.cv, cfg.cvd)
    degrees = (cfg.degree,) * spec.num_agg_layers
    rng = np.random.default_rng(49)
    rows = JMesh.shard_rows(n, dp)
    hists = tuple(tuple(
        (np.abs(rng.normal(size=(rows, d))) * 0.3 if j == 1
         else rng.normal(size=(rows, d))).astype(np.float32)
        for j in range(spec.n_history_per_layer))
        for d in spec.history_dims) if spec.cv else ()
    params = JM.init_params(jax.random.PRNGKey(4), spec)
    arrays = {"nbr": np.asarray(jg.nbr), "w": np.asarray(jg.w),
              "deg": np.asarray(jg.deg), "features": feats,
              "labels": np.asarray(JG.dense_rows(ds.labels, n)),
              "in_dim": ds.feature_dim, "steps": STEPS}
    arrays.update({f"param:{l}/{k}": np.asarray(v)
                   for l, p in params.items() for k, v in p.items()})
    arrays.update({f"hist:{l}/{j}": h for l, hl in enumerate(hists)
                   for j, h in enumerate(hl)})
    packs = []
    for s in range(STEPS):
        batch = np.r_[rng.choice(ds.train_d, 28, replace=False),
                      [n] * 4].astype(np.int32)
        if owner:
            batch = JMesh.owner_grouped_batch_matrix(batch[:28], 32, n,
                                                     dp)[0]
        pack = JS.schedule(jax.random.PRNGKey(3 + s), jg, jnp.asarray(batch),
                           degrees, cv=cfg.cv, need_aw=cfg.det_dropout,
                           round_multiple=dp, dedup=cfg.field_dedup,
                           owner_blocks=dp if owner else 0)
        packs.append(pack)
        _put_pack(arrays, f"s{s}", pack)
    eval_packs = [JS.schedule(
        jax.random.PRNGKey(50 + s), jg,
        jnp.arange(32 * s, 32 * (s + 1), dtype=jnp.int32), degrees,
        cv=cfg.cv, need_aw=cfg.det_dropout, round_multiple=dp,
        dedup=cfg.field_dedup) for s in range(evals)]
    for s, pack in enumerate(eval_packs):
        _put_pack(arrays, f"e{s}", pack)
    if evals:
        arrays["eval_steps"] = evals
    np.savez(out, **arrays)

    mesh = make_mesh(dp)
    state = JStep.TrainState(
        params=params, opt_state=JStep.make_optimizer(cfg).init(params),
        histories=jax.tree_util.tree_map(jnp.asarray, hists),
        step=jnp.zeros((), jnp.int32))
    data = (JG.pad_graph_rows(jg, dp),
            JG.pad_table_rows(jnp.asarray(feats), dp),
            JG.pad_table_rows(JG.dense_rows(ds.labels, n), dp))
    inner = JStep.build_train_step(
        cfg, spec, degrees, n,
        mesh=_halo_spec(cfg, mesh) if cfg.halo_exchange else None)
    repl = NamedSharding(mesh, P())
    st_sh = state_shardings(mesh, state, True)
    step = jax.jit(lambda st, g, f, l, imp, b, k, pk: inner(
        st, g, f, l, imp, b, k, pack=pk),
        in_shardings=(st_sh, *data_shardings(mesh, data, True), repl,
                      NamedSharding(mesh, P("data")), repl, repl),
        out_shardings=(st_sh, repl))
    state = jax.device_put(state, st_sh)
    data = jax.device_put(data, data_shardings(mesh, data, True))
    losses, drops = [], []
    for pack in packs:
        state, m = step(state, *data, jnp.zeros((n + 1,)),
                        pack.fields[-1], jax.random.PRNGKey(0), pack)
        drops.append(int(m["hist_dropped"]))
        losses.append(float(m["loss"]))
    if not evals:
        return cfg, losses, drops, state, None
    hmesh = _halo_spec(cfg, mesh)

    def ev(params, hist, g, f, pk):
        logits, new_h = JM.forward(params, spec, pk, g, hist, f,
                                   jax.random.PRNGKey(0), cfg.keep_prob,
                                   train=False, mesh=hmesh)
        hist, dropped = JStep.scatter_histories(
            hist, new_h, pk.fields, n, mesh=hmesh,
            scatter_cap_mult=cfg.scatter_cap_mult, unique=cfg.field_dedup)
        return hist, JM.predict(spec, logits), dropped

    dsh = data_shardings(mesh, data, True)
    ev = jax.jit(ev, in_shardings=(st_sh.params, st_sh.histories, dsh[0],
                                   dsh[1], repl),
                 out_shardings=(st_sh.histories, repl, repl))
    hist, preds, eval_drops = state.histories, [], []
    for pack in eval_packs:
        hist, pred, dropped = ev(state.params, hist, data[0], data[1], pack)
        preds.append(np.asarray(pred))
        eval_drops.append(int(dropped))
    return cfg, losses, drops, state, (np.stack(preds), hist, eval_drops)


@pytest.fixture(scope="module")
def dataset():
    ds = JLd.synthetic_dataset(num_nodes=N_NODES, feature_dim=WIDTH,
                               num_classes=5, normalization="graphsage",
                               seed=0)
    return ds, JG.pad_csr(ds.train_adj)


def _port_against_jax(dataset, tmp_path, name, dp, owner, tol, over=None,
                      hist_rows=None, evals=0):
    """Returns each step's ``hist_dropped`` (the port's and JAX's are
    held equal), and with ``evals`` JAX's dropped counts of that many
    evaluation steps after them, whose class probabilities and refreshed
    histories are held equal too.  ``hist_rows``: the histories' rows
    held (all of them by default)."""
    ds, jg = dataset
    n = ds.num_data
    cfg = _cfg(name)
    feats = (np.hstack((ds.feats, ds.train_feats)) if cfg.preprocess
             else ds.feats).astype(np.float32)
    feats = np.asarray(JG.dense_rows(feats, n))
    cfg, losses, drops, jstate, jeval = _jax_run(
        name, ds, jg, feats, tmp_path / "in.npz", dp, owner, over, evals)
    fields = {**dataclasses.asdict(cfg), "dp": PORT_DP}
    launch.spawn(checks.train_steps, PORT_DP,
                 (str(tmp_path / "in.npz"), str(tmp_path / "out.npz"),
                  fields), "cpu", store_dir=str(tmp_path))
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose([float(got[f"loss{s}"]) for s in range(STEPS)],
                               losses, **tol)
    assert [int(got[f"dropped{s}"]) for s in range(STEPS)] == drops
    for l, p in jstate.params.items():
        for k, v in p.items():
            np.testing.assert_allclose(got[f"param:{l}/{k}"], np.asarray(v),
                                       **tol)
            mu = jstate.opt_state[0].mu[l][k]
            np.testing.assert_allclose(got[f"mu:{l}/{k}"], np.asarray(mu),
                                       **tol)
    for l, hl in enumerate(jstate.histories):
        for j, h in enumerate(hl):
            np.testing.assert_allclose(got[f"hist:{l}/{j}"][:hist_rows],
                                       np.asarray(h)[:hist_rows], **tol)
    if not evals:
        return drops
    preds, hist, eval_drops = jeval
    np.testing.assert_allclose(got["pred"], preds, **tol)
    for l, hl in enumerate(hist):
        for j, h in enumerate(hl):
            np.testing.assert_allclose(got[f"ehist:{l}/{j}"], np.asarray(h),
                                       **tol)
    return drops, eval_drops


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_port_dp2_step_matches_jax_dp8(dataset, jax_noise, tmp_path, name):
    drops = _port_against_jax(dataset, tmp_path, name, JAX_DP, False, TOL)
    assert drops == [0] * STEPS


@pytest.mark.parametrize("name", ["cv_pp", "cvd_pp"])
def test_port_owner_batched_dp2_step_matches_jax(dataset, jax_noise,
                                                 tmp_path, name):
    """``--dp 2 --owner_batching``: the port's step on JAX's owner-aligned
    packs (``self_pos`` set, fields not prefixes) equals JAX's dp=2
    owner-batched step."""
    drops = _port_against_jax(dataset, tmp_path, name, PORT_DP, True,
                              OWNER_TOL)
    assert drops == [0] * STEPS


@pytest.mark.parametrize("over", [
    {"scatter_cap_mult": 0.25, "field_dedup": False, "dropout": 0.0},
    {"halo_exchange": False}], ids=["scatter_cap_0.25", "halo_exchange_false"])
def test_port_dp2_halo_transport_matches_jax(dataset, jax_noise, tmp_path,
                                             over):
    """CV+PP at dp=2 on shuffled packs: with a scatter capacity that
    binds, the histories keep the same stale rows in both packages; with
    exact accesses nothing is dropped."""
    exact = over.get("halo_exchange") is False
    drops = _port_against_jax(dataset, tmp_path, "cv_pp", PORT_DP, False,
                              OWNER_TOL, over,
                              hist_rows=dataset[0].num_data if exact
                              else None)
    if exact:
        assert drops == [0] * STEPS
    else:
        assert all(d > 0 for d in drops)


def test_port_dp2_eval_at_binding_scatter_capacity_matches_jax(
        dataset, jax_noise, tmp_path):
    """The evaluation that refreshes the histories before a prediction,
    at dp=2 with ``--scatter_cap_mult 0.25``, after the three train
    steps: its batches are the first nodes in id order, so both ranks'
    blocks of a field are mostly rank 0's rows and the eval-history
    scatter drops writes.  The class probabilities and the refreshed
    histories equal JAX's, which drops the same writes."""
    drops, eval_drops = _port_against_jax(
        dataset, tmp_path, "cv_pp", PORT_DP, False, OWNER_TOL,
        {"scatter_cap_mult": 0.25, "field_dedup": False, "dropout": 0.0},
        evals=2)
    assert all(d > 0 for d in drops) and all(d > 0 for d in eval_drops)
