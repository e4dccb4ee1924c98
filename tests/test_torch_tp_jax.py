"""The port's tensor-parallel train step against the JAX package's: a JAX
``--dp 4 --tp 2`` sharded step (the 8 virtual CPU devices as a ('data',
'model') mesh: params, Adam state and history columns over 'model',
history rows, graph, features and labels over 'data', owner-routed
transports) and the port's dp 2 x tp 2 step (four gloo ranks,
parallel/checks.py::train_steps, one group for every estimator) take the
same three JAX-drawn schedules, the same params and histories and the same
numpy dropout masks and Gaussian noise, seeded by the whole tensor's shape
(each rank takes its rows and its columns), as in
test_torch_parallel_jax.py.  After 3 steps each step's loss, the params,
the Adam first moments and the histories must match to rtol 1e-4 / atol
1e-6, for CV+PP, CVD+PP, Exact and det-dropout+PP (float32 histories)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

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

from test_torch_parallel_jax import (ESTIMATORS, N_NODES, STEPS, TOL, WIDTH,
                                     _cfg, _rng)

JAX_DP, JAX_TP, PORT_DP, PORT_TP = 4, 2, 2, 2


def _noise(mp):
    """checks.shape_seeded_noise's masks and noise on the JAX side (GSPMD
    draws the whole logical tensor)."""
    def dropout(key, x, keep_prob):
        if keep_prob >= 1.0:
            return x
        keep = _rng(x.shape, 1).random(x.shape) < keep_prob
        return jnp.where(jnp.asarray(keep), x, 0.0) * (1.0 / keep_prob)

    mp.setattr(JL, "dropout", dropout)
    mp.setattr(jax.random, "normal",
               lambda key, shape, dtype=None: jnp.asarray(
                   _rng(tuple(shape), 2).standard_normal(
                       tuple(shape)).astype(np.float32)))


def _jax_tp_run(name, ds, jg, feats, out):
    """Three JAX steps at dp 4 x tp 2; their inputs go to ``out`` for the
    port."""
    cfg = _cfg(name).replace(dp=JAX_DP, tp=JAX_TP)
    n = ds.num_data
    spec = JM.build_model_spec(cfg, ds.feature_dim, ds.num_classes,
                               cfg.preprocess, cfg.cv, cfg.cvd)
    degrees = (cfg.degree,) * spec.num_agg_layers
    rng = np.random.default_rng(49)
    rows = JMesh.shard_rows(n, JAX_DP)
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
        pack = JS.schedule(jax.random.PRNGKey(3 + s), jg, jnp.asarray(batch),
                           degrees, cv=cfg.cv, need_aw=cfg.det_dropout,
                           round_multiple=JAX_DP, dedup=cfg.field_dedup)
        packs.append(pack)
        for i, f in enumerate(pack.fields):
            arrays[f"s{s}:field{i}"] = np.asarray(f)
        for l, ls in enumerate(pack.layers):
            arrays[f"s{s}:pos{l}"] = np.asarray(ls.slot_pos)
            arrays[f"s{s}:w{l}"] = np.asarray(ls.slot_w)
            arrays[f"s{s}:scales{l}"] = np.asarray(ls.scales)
            if ls.slot_aw is not None:
                arrays[f"s{s}:aw{l}"] = np.asarray(ls.slot_aw)
    np.savez(out, **arrays)

    mesh = make_mesh(JAX_DP, tp=JAX_TP)
    assert dict(mesh.shape) == {"data": JAX_DP, "model": JAX_TP}
    state = JStep.TrainState(
        params=params, opt_state=JStep.make_optimizer(cfg).init(params),
        histories=jax.tree_util.tree_map(jnp.asarray, hists),
        step=jnp.zeros((), jnp.int32))
    data = (JG.pad_graph_rows(jg, JAX_DP),
            JG.pad_table_rows(jnp.asarray(feats), JAX_DP),
            JG.pad_table_rows(JG.dense_rows(ds.labels, n), JAX_DP))
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
def runs(tmp_path_factory):
    """Every estimator's JAX run, then one 4-rank group running the port's
    steps of all of them."""
    root = tmp_path_factory.mktemp("tp_jax")
    ds = JLd.synthetic_dataset(num_nodes=N_NODES, feature_dim=WIDTH,
                               num_classes=5, normalization="graphsage",
                               seed=0)
    jg = JG.pad_csr(ds.train_adj)
    want, jobs = {}, []
    with pytest.MonkeyPatch.context() as mp:
        _noise(mp)
        for name in ESTIMATORS:
            cfg = _cfg(name)
            feats = (np.hstack((ds.feats, ds.train_feats)) if cfg.preprocess
                     else ds.feats).astype(np.float32)
            feats = np.asarray(JG.dense_rows(feats, ds.num_data))
            inp, out = root / f"{name}_in.npz", root / f"{name}_out.npz"
            cfg, losses, state = _jax_tp_run(name, ds, jg, feats, inp)
            want[name] = (losses, state)
            fields = {**dataclasses.asdict(cfg), "dp": PORT_DP,
                      "tp": PORT_TP}
            jobs.append(("train_steps", (str(inp), str(out), fields)))
    launch.spawn(checks.run_jobs, PORT_DP * PORT_TP, (jobs,), "cpu",
                 store_dir=str(root))
    return root, want


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_port_dp2_tp2_step_matches_jax_dp4_tp2(runs, name):
    root, want = runs
    losses, jstate = want[name]
    got = np.load(root / f"{name}_out.npz")
    np.testing.assert_allclose([float(got[f"loss{s}"]) for s in range(STEPS)],
                               losses, **TOL)
    for l, p in jstate.params.items():
        for k, v in p.items():
            np.testing.assert_allclose(got[f"param:{l}/{k}"], np.asarray(v),
                                       **TOL)
            mu = jstate.opt_state[0].mu[l][k]
            np.testing.assert_allclose(got[f"mu:{l}/{k}"], np.asarray(mu),
                                       **TOL)
    for l, hl in enumerate(jstate.histories):
        for j, h in enumerate(hl):
            np.testing.assert_allclose(got[f"hist:{l}/{j}"], np.asarray(h),
                                       **TOL)
