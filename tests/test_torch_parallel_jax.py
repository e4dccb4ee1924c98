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
1e-6."""

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


def _jax_run(name, ds, jg, feats, out, dp=JAX_DP, owner=False):
    """Three JAX steps at width ``dp`` (owner-aligned with ``owner``);
    their inputs go to ``out`` for the port."""
    cfg = _cfg(name).replace(dp=dp, owner_batching=owner)
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
        for i, f in enumerate(pack.fields):
            arrays[f"s{s}:field{i}"] = np.asarray(f)
        for l, ls in enumerate(pack.layers):
            arrays[f"s{s}:pos{l}"] = np.asarray(ls.slot_pos)
            arrays[f"s{s}:w{l}"] = np.asarray(ls.slot_w)
            arrays[f"s{s}:scales{l}"] = np.asarray(ls.scales)
            if ls.slot_aw is not None:
                arrays[f"s{s}:aw{l}"] = np.asarray(ls.slot_aw)
            if ls.self_pos is not None:
                arrays[f"s{s}:self{l}"] = np.asarray(ls.self_pos)
    np.savez(out, **arrays)

    mesh = make_mesh(dp)
    state = JStep.TrainState(
        params=params, opt_state=JStep.make_optimizer(cfg).init(params),
        histories=jax.tree_util.tree_map(jnp.asarray, hists),
        step=jnp.zeros((), jnp.int32))
    data = (JG.pad_graph_rows(jg, dp),
            JG.pad_table_rows(jnp.asarray(feats), dp),
            JG.pad_table_rows(JG.dense_rows(ds.labels, n), dp))
    inner = JStep.build_train_step(cfg, spec, degrees, n,
                                   mesh=_halo_spec(cfg, mesh))
    repl = NamedSharding(mesh, P())
    st_sh = state_shardings(mesh, state, True)
    step = jax.jit(lambda st, g, f, l, imp, b, k, pk: inner(
        st, g, f, l, imp, b, k, pack=pk),
        in_shardings=(st_sh, *data_shardings(mesh, data, True), repl,
                      NamedSharding(mesh, P("data")), repl, repl),
        out_shardings=(st_sh, repl))
    state = jax.device_put(state, st_sh)
    data = jax.device_put(data, data_shardings(mesh, data, True))
    losses = []
    for pack in packs:
        state, m = step(state, *data, jnp.zeros((n + 1,)),
                        pack.fields[-1], jax.random.PRNGKey(0), pack)
        assert int(m["hist_dropped"]) == 0
        losses.append(float(m["loss"]))
    return cfg, losses, state


@pytest.fixture(scope="module")
def dataset():
    ds = JLd.synthetic_dataset(num_nodes=N_NODES, feature_dim=WIDTH,
                               num_classes=5, normalization="graphsage",
                               seed=0)
    return ds, JG.pad_csr(ds.train_adj)


def _port_against_jax(dataset, tmp_path, name, dp, owner, tol):
    ds, jg = dataset
    n = ds.num_data
    cfg = _cfg(name)
    feats = (np.hstack((ds.feats, ds.train_feats)) if cfg.preprocess
             else ds.feats).astype(np.float32)
    feats = np.asarray(JG.dense_rows(feats, n))
    cfg, losses, jstate = _jax_run(name, ds, jg, feats, tmp_path / "in.npz",
                                   dp, owner)
    fields = {**dataclasses.asdict(cfg), "dp": PORT_DP}
    launch.spawn(checks.train_steps, PORT_DP,
                 (str(tmp_path / "in.npz"), str(tmp_path / "out.npz"),
                  fields), "cpu", store_dir=str(tmp_path))
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose([float(got[f"loss{s}"]) for s in range(STEPS)],
                               losses, **tol)
    for l, p in jstate.params.items():
        for k, v in p.items():
            np.testing.assert_allclose(got[f"param:{l}/{k}"], np.asarray(v),
                                       **tol)
            mu = jstate.opt_state[0].mu[l][k]
            np.testing.assert_allclose(got[f"mu:{l}/{k}"], np.asarray(mu),
                                       **tol)
    for l, hl in enumerate(jstate.histories):
        for j, h in enumerate(hl):
            np.testing.assert_allclose(got[f"hist:{l}/{j}"], np.asarray(h),
                                       **tol)


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_port_dp2_step_matches_jax_dp8(dataset, jax_noise, tmp_path, name):
    _port_against_jax(dataset, tmp_path, name, JAX_DP, False, TOL)


@pytest.mark.parametrize("name", ["cv_pp", "cvd_pp"])
def test_port_owner_batched_dp2_step_matches_jax(dataset, jax_noise,
                                                 tmp_path, name):
    """``--dp 2 --owner_batching``: the port's step on JAX's owner-aligned
    packs (``self_pos`` set, fields not prefixes) equals JAX's dp=2
    owner-batched step."""
    _port_against_jax(dataset, tmp_path, name, PORT_DP, True, OWNER_TOL)
