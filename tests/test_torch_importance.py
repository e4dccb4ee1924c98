"""Importance sampling, the activation taps and the NeighbourMLP of the port
on the CPU, against the JAX package.

The same numpy inputs go through the JAX function and its port.  The
selection is sampled: where a test needs the two packages to draw the same
members, the port's Gumbel noise (``scheduler._gumbel``) is replaced by the
noise ``jax.random.gumbel`` draws from the JAX scheduler's key, and the JAX
side takes the exact top-k (``is_approx_topk=False``), the only one torch
has.  Dropout masks are shared through numpy (``shared_noise``).  The
selection graph carries random edge weights, so no two slots of a row tie
in weight.  Tolerances:

* fields, positions, selections, ``n_samples`` and ``is_dropped``: exact;
* importance, ``total_imp`` and slot weights: rtol 1e-6 (float32 sums in
  another order);
* IS slots after the slot cap: per row, the same positions with the same
  weights (torch and XLA order a row's top-k differently);
* one IS+PP and one IS+CV train step, the activation moments and the MLP:
  rtol = atol = 1e-5;
* a sampled IS+PP run: val micro-F1 within 0.03 of JAX's, mean of 3 seeds;
* the unbiasedness of the IS estimator over 400 draws: atol 0.12, as the
  JAX package's own test.
"""

import dataclasses
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.cli import train as jax_train_cli
from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.data import loaders as JLd
from stochastic_gcn_tpu.models import gcn as JM
from stochastic_gcn_tpu.models import mlp as JMlp
from stochastic_gcn_tpu.ops import layers as JL
from stochastic_gcn_tpu.sampler import scheduler as JS
from stochastic_gcn_tpu.training import step as JStep
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer
from stochastic_gcn_tpu.utils import metrics as JMet

from stochastic_gcn_tpu_torch.cli import train as train_cli
from stochastic_gcn_tpu_torch.config import from_fields
from stochastic_gcn_tpu_torch.data import graph as G
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.models import mlp as Mlp
from stochastic_gcn_tpu_torch.ops import layers as L
from stochastic_gcn_tpu_torch.sampler import scheduler as S
from stochastic_gcn_tpu_torch.training import checkpoint as C
from stochastic_gcn_tpu_torch.training import step as St
from stochastic_gcn_tpu_torch.training.loop import Trainer
from stochastic_gcn_tpu_torch.utils import metrics as Met

TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = dict(rtol=1e-6, atol=0.0)
WIDTH = 30
N_NODES = 240


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_cfg(cfg):
    """The port's own ``Config`` with the fields of the JAX package's."""
    return from_fields(dataclasses.asdict(cfg))


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().cpu().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def dataset():
    return JLd.synthetic_dataset(num_nodes=N_NODES, feature_dim=WIDTH,
                                 num_classes=5, normalization="graphsage",
                                 seed=0)


@pytest.fixture(scope="module")
def graphs(dataset):
    """The normalised train graph in both packages."""
    return dataset, JG.pad_csr(dataset.train_adj), G.pad_csr(dataset.train_adj)


@pytest.fixture(scope="module")
def random_graph(dataset):
    """The full graph (degrees 1-16) with random edge weights: no ties."""
    adj = dataset.full_adj.copy().tocsr()
    adj.data = np.random.default_rng(60).uniform(
        0.05, 1.0, adj.nnz).astype(np.float32)
    return dataset, JG.pad_csr(adj), G.pad_csr(adj)


def _batch(rng, ds, real, pad):
    return np.r_[rng.choice(ds.train_d, real, replace=False),
                 [ds.num_data] * pad].astype(np.int32)


def _jax_noise(monkeypatch, key):
    """The port's Gumbel draws become the ones the JAX scheduler draws from
    ``key``: one split per layer, as ``JS.schedule`` does."""
    state = {"key": key}

    def gumbel(gen, n, device):
        state["key"], sub = jax.random.split(state["key"])
        return T(jax.random.gumbel(sub, (n,)))

    monkeypatch.setattr(S, "_gumbel", gumbel)


def _to_torch_pack(jpack):
    return S.BatchFields(
        fields=tuple(T(f) for f in jpack.fields),
        layers=tuple(S.LayerSample(
            slot_pos=T(ls.slot_pos), slot_w=T(ls.slot_w),
            slot_aw=None if ls.slot_aw is None else T(ls.slot_aw),
            scales=T(ls.scales)) for ls in jpack.layers),
        is_dropped=T(jpack.is_dropped))


def _assert_same_slots(pos, w, jpos, jw):
    """Per row, the live slots name the same positions with the same
    weights, in whatever order; every dead slot is parked."""
    pos, w, jpos, jw = (np.asarray(a) for a in (pos, w, jpos, jw))
    assert pos.shape == jpos.shape and pos.dtype == np.int32
    for r in range(len(w)):
        live, jlive = w[r] != 0, jw[r] != 0
        order, jorder = np.argsort(pos[r][live]), np.argsort(jpos[r][jlive])
        np.testing.assert_array_equal(pos[r][live][order],
                                      jpos[r][jlive][jorder])
        np.testing.assert_allclose(w[r][live][order], jw[r][jlive][jorder],
                                   **SUM_TOL)
        assert (pos[r][~live] == S.PARKED_POS).all()


@pytest.fixture
def shared_noise(monkeypatch):
    """Both packages take their dropout masks from numpy, seeded by the
    shape alone, in place of their own random streams."""
    def mask(shape, keep_prob):
        return np.random.default_rng([1, len(shape), *shape]).random(
            shape) < keep_prob

    def jdropout(key, x, keep_prob):
        if keep_prob >= 1.0:
            return x
        return jnp.where(jnp.asarray(mask(x.shape, keep_prob)), x, 0.0) \
            * (1.0 / keep_prob)

    def tdropout(gen, x, keep_prob):
        if keep_prob >= 1.0:
            return x
        return torch.where(T(mask(tuple(x.shape), keep_prob)), x, 0.0) \
            * (1.0 / keep_prob)

    monkeypatch.setattr(JL, "dropout", jdropout)
    monkeypatch.setattr(L, "dropout", tdropout)


# ------------------------------ the selection -----------------------------

@pytest.mark.parametrize("which", ["train", "random"])
def test_compute_importance_matches_jax(graphs, random_graph, which):
    _, jg, tg = graphs if which == "train" else random_graph
    got = S.compute_importance(tg)
    assert got.dtype == torch.float32 and tuple(got.shape) == \
        (tg.num_nodes + 1,)
    np.testing.assert_allclose(N(got), np.asarray(JS.compute_importance(jg)),
                               **SUM_TOL)
    assert float(got[-1]) == np.float32(1e-6)


def test_gumbel_draws_are_standard_gumbel():
    """The port's own noise: a standard Gumbel (mean Euler's gamma,
    variance pi^2/6), finite even where the uniform is 0."""
    g = N(S._gumbel(torch.Generator().manual_seed(0), 200_000, "cpu"))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g.mean(), np.euler_gamma, atol=0.01)
    np.testing.assert_allclose(g.var(), np.pi ** 2 / 6, rtol=0.02)


@pytest.mark.parametrize("degree, real, pad", [(1, 28, 4), (2, 32, 0),
                                               (8, 30, 2)])
def test_is_select_matches_jax(random_graph, monkeypatch, degree, real, pad):
    """With JAX's noise the same members are drawn; ``n_samples`` is
    ``min(real ids x degree, |union|)`` and stays a device scalar."""
    ds, jg, tg = random_graph
    n = ds.num_data
    imp = np.asarray(JS.compute_importance(jg))
    field = _batch(np.random.default_rng(61 + degree), ds, real, pad)
    key = jax.random.PRNGKey(11)
    want = JS.is_select(key, jg, jnp.asarray(field), degree,
                        jnp.asarray(imp), approx_topk=False)
    monkeypatch.setattr(S, "_gumbel", lambda gen, m, device: T(
        jax.random.gumbel(key, (m,))))
    got = S.is_select(torch.Generator(), tg, T(field), degree, T(imp),
                      approx_topk=False)
    assert got.sel_ids.dtype == torch.int32
    assert tuple(got.sel_ids.shape) == tuple(want.sel_ids.shape) == \
        (min(len(field) * degree, n),)
    np.testing.assert_array_equal(np.sort(N(got.sel_ids)),
                                  np.sort(np.asarray(want.sel_ids)))
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(want.selected))
    for name in ("rows_nbr", "rows_w", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(float(got.total_imp), float(want.total_imp),
                               **SUM_TOL)
    assert got.n_samples.dtype == torch.float32 and got.n_samples.dim() == 0
    assert float(got.n_samples) == float(want.n_samples)
    union = set(np.asarray(want.rows_nbr)[np.asarray(want.valid)]) - {n}
    assert float(got.n_samples) == min(real * degree, len(union))
    assert int(got.selected.sum()) == float(got.n_samples)


@pytest.mark.parametrize("cap", [0, 1, 3, 8, 16, 10000])
def test_is_slots_and_slot_compact_match_jax(random_graph, cap):
    ds, jg, tg = random_graph
    n = ds.num_data
    imp = JS.compute_importance(jg)
    field = jnp.asarray(_batch(np.random.default_rng(62), ds, 28, 4))
    sel = JS.is_select(jax.random.PRNGKey(12), jg, field, 2, imp,
                       approx_topk=False)
    capacity = JS.field_capacities(32, (2,), n, jg.pad_degree,
                                   importance=True)[0]
    _, pos_table = JS.compact_field(field, sel.sel_ids, n, capacity)
    jpos, jw = JS.is_slots(sel, imp, pos_table)
    tsel = S.ISSelection(*(T(x) for x in sel))
    pos, w = S.is_slots(tsel, T(imp), T(pos_table))
    assert pos.dtype == torch.int32 and w.dtype == torch.float32
    assert tuple(pos.shape) == (32, jg.pad_degree)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **SUM_TOL)

    cpos, cw, drop = S.is_slot_compact(pos, w, cap)
    jcpos, jcw, jdrop = JS.is_slot_compact(jpos, jw, cap)
    assert drop.dtype == torch.int32 and drop.dim() == 0
    assert int(drop) == int(jdrop)
    assert cpos.is_contiguous() and cw.is_contiguous()
    _assert_same_slots(cpos, cw, jcpos, jcw)
    live = (w.numpy() > 0).sum(1)
    kept = min(cap, jg.pad_degree) if cap > 0 else jg.pad_degree
    assert int(drop) == int(np.maximum(live - kept, 0).sum())
    if 0 < cap < jg.pad_degree:
        assert int(drop) > 0 or live.max() <= cap


@pytest.mark.parametrize("degrees, cap, real, pad, dedup", [
    ((2,), 0, 28, 4, True),
    ((2, 2), 3, 30, 2, True),
    ((1,), -1, 32, 0, False),            # dedup is forced by IS
    ((3, 2), 8, 25, 7, True),
    ((2,), -1, 30, 2018, True),          # batch 2048: the auto cap is 8
])
def test_schedule_with_importance_matches_jax(random_graph, monkeypatch,
                                              degrees, cap, real, pad, dedup):
    ds, jg, tg = random_graph
    n = ds.num_data
    imp = JS.compute_importance(jg)
    batch = _batch(np.random.default_rng(63), ds, real, pad)
    key = jax.random.PRNGKey(13)
    want = JS.schedule(key, jg, jnp.asarray(batch), degrees, cv=True,
                       importance=imp, is_approx_topk=False,
                       is_slot_cap=cap, dedup=dedup)
    _jax_noise(monkeypatch, key)
    got = S.schedule(torch.Generator(), tg, T(batch), degrees, cv=True,
                     importance=T(imp), is_approx_topk=False,
                     is_slot_cap=cap, dedup=dedup)
    assert [f.shape[0] for f in got.fields] == S.field_capacities(
        len(batch), degrees, n, tg.pad_degree, importance=True)
    for f, jf in zip(got.fields, want.fields):
        assert f.dtype == torch.int32
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    for ls, jls in zip(got.layers, want.layers):
        assert ls.slot_aw is None
        np.testing.assert_array_equal(ls.scales.numpy(),
                                      np.asarray(jls.scales))
        _assert_same_slots(ls.slot_pos, ls.slot_w, jls.slot_pos, jls.slot_w)
    assert got.is_dropped.dtype == torch.int32
    assert int(got.is_dropped) == int(want.is_dropped)
    resolved = (8 if len(batch) >= 2048 else 0) if cap < 0 else cap
    if 0 < resolved < tg.pad_degree:
        assert got.layers[0].slot_pos.shape[1] == resolved


def test_schedule_without_importance_reports_no_drops(random_graph):
    ds, _, tg = random_graph
    pack = S.schedule(torch.Generator().manual_seed(0), tg,
                      T(_batch(np.random.default_rng(64), ds, 30, 2)), (2,),
                      cv=True)
    assert pack.is_dropped.dtype == torch.int32 and int(pack.is_dropped) == 0


def _sampled_adj_dense(pack, n):
    ls = pack.layers[0]
    field_in = pack.fields[0].numpy()
    pos, w = ls.slot_pos.numpy(), ls.slot_w.numpy()
    dense = np.zeros((pos.shape[0], n + 1), np.float64)
    live = w != 0
    rows = np.repeat(np.arange(pos.shape[0]), pos.shape[1])[live.ravel()]
    np.add.at(dense, (rows, field_in[pos[live]]), w[live])
    return dense[:, :n]


@pytest.mark.parametrize("cap", [0, 2])
def test_importance_sampling_is_unbiased(cap):
    """E[A_IS] = A with the port's own draws (the JAX package's test:
    50 nodes, 8 rows, degree 3, 400 draws, atol 0.12).  Under a cap that
    drops slots the estimator is biased, so the cap case only checks that
    it never adds mass where the graph has none."""
    ds = Ld.synthetic_dataset(num_nodes=50, feature_dim=8, num_classes=3,
                              avg_degree=5, seed=0)
    g = G.pad_csr(ds.full_adj)
    n = ds.num_data
    imp = S.compute_importance(g)
    batch = torch.arange(8, dtype=torch.int32)
    gen = torch.Generator().manual_seed(5)
    acc = np.zeros((8, n), np.float64)
    trials = 400
    for _ in range(trials):
        acc += _sampled_adj_dense(S.schedule(gen, g, batch, (3,), cv=False,
                                             importance=imp,
                                             is_slot_cap=cap), n)
    acc /= trials
    full = ds.full_adj.toarray()[:8]
    assert (acc[full == 0] == 0).all()
    if cap == 0:
        np.testing.assert_allclose(acc, full, atol=0.12)


# ------------------------------ train steps --------------------------------

IS_ARMS = {
    # (cv, slot cap): IS+PP on [F, 4] slots, IS+CV on [F, Dcap] slots
    "IS+PP": (False, 4),
    "IS+CV": (True, 0),
}


def _is_cfg(name, **over):
    cv, cap = IS_ARMS[name]
    return Config(**{**dict(batch_size=32, degree=2, test_degree=2, cv=cv,
                            test_cv=cv, importance=True, test_importance=True,
                            is_slot_cap=cap, hidden1=16,
                            normalization="graphsage", layer_norm=True,
                            num_fc_layers=2, weight_decay=5e-4, dropout=0.0,
                            pad_degree=64, seed=1), **over})


def _specs(cfg, ds, cv):
    args = (ds.feature_dim, ds.num_classes, True, cv, False)
    return JM.build_model_spec(cfg, *args), \
        M.build_model_spec(port_cfg(cfg), *args)


def _hist(rng, n, d):
    """A float32 history of values exact in bf16; row N garbage."""
    h = rng.normal(size=(248, d)).astype(np.float32)
    h[n] = 1e3
    return N(T(h).to(torch.bfloat16))


@pytest.mark.parametrize("name", list(IS_ARMS))
def test_is_train_step_matches_jax(graphs, name):
    ds, jg, tg = graphs
    n = ds.num_data
    cfg = _is_cfg(name)
    cv = IS_ARMS[name][0]
    jspec, spec = _specs(cfg, ds, cv)
    feats = np.hstack((ds.feats, ds.train_feats)).astype(np.float32)
    rng = np.random.default_rng(65)
    hist = _hist(rng, n, cfg.hidden1)
    batch = _batch(rng, ds, 28, 4)
    jimp = JS.compute_importance(jg)
    jpack = JS.schedule(jax.random.PRNGKey(3), jg, jnp.asarray(batch), (2,),
                        cv=cv, importance=jimp, is_slot_cap=cfg.is_slot_cap)
    k = jpack.layers[0].slot_pos.shape[1]
    assert k == (cfg.is_slot_cap or jg.pad_degree)

    jparams = JM.init_params(jax.random.PRNGKey(4), jspec)
    jhists = ((jnp.asarray(hist).astype(jnp.bfloat16),),) if cv else ()
    jstate = JStep.TrainState(
        params=jparams, opt_state=JStep.make_optimizer(cfg).init(jparams),
        histories=jhists, step=jnp.zeros((), jnp.int32))
    jstep = JStep.build_train_step(cfg, jspec, (2,), n)
    jstate, jm = jstep(jstate, jg, JG.dense_rows(feats, n),
                       JG.dense_rows(ds.labels, n), jimp, jnp.asarray(batch),
                       jax.random.PRNGKey(0), pack=jpack)

    params = C.params_from_jax(_np_tree(jparams))
    pcfg = port_cfg(cfg)
    state = St.TrainState(
        params=params, opt_state=St.make_optimizer(pcfg).init(params),
        histories=((T(hist).to(torch.bfloat16),),) if cv else (),
        step=torch.zeros((), dtype=torch.int32))
    step = St.build_train_step(pcfg, spec, (2,), n)
    state, m = step(state, tg, G.dense_rows(feats, n),
                    G.dense_rows(ds.labels, n), T(batch), torch.Generator(),
                    pack=_to_torch_pack(jpack), importance=T(jimp))

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]),
                               **TOL)
    jopt = jstate.opt_state[0]
    for l, key in St.param_keys(params):
        # after one update mu = (1 - b1) * grad exactly: the gradients
        np.testing.assert_allclose(
            N(state.opt_state.mu[l][key]) / (1 - cfg.beta1),
            np.asarray(jopt.mu[l][key]) / (1 - cfg.beta1), **TOL)
        np.testing.assert_allclose(N(state.params[l][key]),
                                   np.asarray(jstate.params[l][key]), **TOL)
    if cv:
        want = np.asarray(jstate.histories[0][0].astype(jnp.float32))
        ulp = np.spacing(np.abs(want)) * 2 ** 16
        assert (np.abs(N(state.histories[0][0]) - want) <= ulp + 1e-5).all()
    assert m["is_dropped"].dtype == torch.int32
    assert int(m["is_dropped"]) == int(jm["is_dropped"])
    assert int(m["amt_data"]) == int(jm["amt_data"])
    for key in ("field_sizes", "adj_sizes", "fadj_sizes"):
        np.testing.assert_array_equal(N(m[key]).astype(np.int64),
                                      np.asarray(jm[key]))


@pytest.mark.parametrize("train_mode", [True, False])
def test_schedule_takes_each_modes_flag_and_cap(graphs, monkeypatch,
                                                train_mode):
    """Training samples by ``importance`` with ``is_slot_cap``, evaluation
    by ``test_importance`` with the auto cap resolved to 0 (JAX
    step.py:468-488, :627-628)."""
    ds, _, tg = graphs
    seen = {}

    def fake(gen, graph, batch_ids, degrees, cv, **kw):
        seen.update(kw)
        return "pack"

    monkeypatch.setattr(St, "schedule", fake)
    imp = torch.ones(ds.num_data + 1)
    for importance, test_importance in [(True, False), (False, True)]:
        cfg = port_cfg(_is_cfg("IS+PP", importance=importance,
                               test_importance=test_importance,
                               is_slot_cap=-1))
        spec = M.build_model_spec(cfg, WIDTH, 5, True, False, False)
        St._schedule(cfg, spec, (2,), tg, torch.zeros(4), None, imp,
                     train_mode)
        use = importance if train_mode else test_importance
        assert (seen["importance"] is imp) == use
        assert seen["is_slot_cap"] == (-1 if train_mode else 0)
    with pytest.raises(ValueError, match="importance table"):
        St._schedule(cfg.replace(importance=True, test_importance=True),
                     spec, (2,), tg, torch.zeros(4), None, None, train_mode)


# ------------------------------ whole runs ---------------------------------

IS_FLAGS = ["--dataset", f"synthetic:{N_NODES}:16:5", "--batch_size", "32",
            "--degree", "2", "--test_degree", "2", "--hidden1", "16",
            "--normalization", "graphsage", "--layer_norm",
            "--num_fc_layers", "2", "--dropout", "0.2", "--pad_degree", "64",
            "--seed", "1", "--test_batch_size", "48", "--importance",
            "--test_importance"]


@pytest.mark.parametrize("extra", [[], ["--cv", "--test_cv"],
                                   ["--is_slot_cap", "3"]])
def test_importance_trains_evaluates_and_predicts(tmp_path, extra):
    from stochastic_gcn_tpu_torch.config import parse_flags
    cfg = parse_flags(IS_FLAGS + ["--ckpt_dir", str(tmp_path), *extra])
    ds = Ld.load_data(cfg)
    tr = Trainer(cfg, ds, device="cpu")
    first = tr.evaluate(ds.val_d)[0]
    for _ in range(4):
        loss = tr.train_epoch()[0]
    assert np.isfinite(loss)
    assert isinstance(tr.epoch_stats["is_dropped"], int)
    if "--is_slot_cap" in extra:
        assert tr.epoch_stats["is_dropped"] > 0
    last = tr.evaluate(ds.val_d)
    assert np.isfinite(last[0]) and last[0] < first
    probs = tr.predict(ds.test_d[:7])
    assert probs.shape == (7, 5) and np.allclose(probs.sum(1), 1, atol=1e-5)
    stats = tr.activation_stats()
    assert all(np.isfinite(v) for s in stats.values() for v in s.values())


@pytest.mark.parametrize("which", ["importance", "test_importance"])
def test_gradient_variance_runs_under_importance(tmp_path, which):
    from stochastic_gcn_tpu_torch.config import parse_flags
    cfg = parse_flags(IS_FLAGS + ["--ckpt_dir", str(tmp_path), "--cv",
                                  "--test_cv"]).replace(
        **{"importance": False, "test_importance": False, which: True})
    ds = Ld.load_data(cfg)
    out = Trainer(cfg, ds, device="cpu").gradient_variance(
        times=3, log=lambda s: None)
    assert all(np.isfinite(v) for v in out.values())


def test_sampled_ispp_accuracy_matches_jax(tmp_path):
    """IS+PP at degree 2, dropout 0.2: the sampling streams differ, so the
    runs are held by their outcome, val micro-F1 averaged over 3 seeds."""
    ds = Ld.community_sbm_dataset(num_nodes=1024, num_classes=4,
                                  feature_dim=16, mean_degree=12, p_in=0.8,
                                  snr=0.35, max_degree=16, val_frac=0.3,
                                  seed=0)
    f1 = {"jax": [], "port": []}
    for seed in (1, 2, 3):
        cfg = Config(dataset="sbm", batch_size=64, degree=2, test_degree=2,
                     cv=False, test_cv=False, importance=True,
                     test_importance=True, is_approx_topk=False, hidden1=16,
                     normalization="graphsage", layer_norm=True,
                     num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                     test_batch_size=256, pad_degree=16, seed=seed,
                     ckpt_dir=str(tmp_path))
        for name, tr in (("jax", JaxTrainer(cfg, ds)),
                         ("port", Trainer(port_cfg(cfg), ds, device="cpu"))):
            for _ in range(6):
                tr.train_epoch()
            f1[name].append(tr.evaluate(ds.val_d)[2])
    mean = {k: float(np.mean(v)) for k, v in f1.items()}
    assert mean["jax"] > 0.6, f1           # the task was learnt
    assert abs(mean["port"] - mean["jax"]) <= 0.03, f1


@pytest.mark.parametrize("over", [{"importance": True, "is_row_table": True},
                                  {"test_importance": True,
                                   "is_row_table": True}])
def test_is_row_table_is_refused(tmp_path, over):
    """``--is_row_table`` was refused with importance sampling until the
    row table was ported: now it is taken, and its slots are the fused
    path's, so an epoch and an evaluation equal those without it."""
    from stochastic_gcn_tpu_torch.config import parse_flags
    cfg = parse_flags(IS_FLAGS + ["--ckpt_dir", str(tmp_path)]).replace(
        importance=False, test_importance=False)
    ds = Ld.load_data(cfg)
    Trainer(cfg.replace(is_row_table=True), ds, device="cpu")  # alone: fine
    got, want = (Trainer(cfg.replace(**{**over, "is_row_table": rt}), ds,
                         device="cpu") for rt in (True, False))
    np.testing.assert_allclose(got.train_epoch()[0], want.train_epoch()[0],
                               rtol=1e-6)
    np.testing.assert_allclose(got.evaluate(ds.val_d)[:4],
                               want.evaluate(ds.val_d)[:4], rtol=1e-6)


# --------------------------- activation moments ----------------------------

@pytest.mark.parametrize("train_mode", [True, False])
@pytest.mark.parametrize("cv", [True, False])
def test_activation_taps_match_jax(graphs, shared_noise, monkeypatch,
                                   train_mode, cv):
    """The same IS pack (the schedule is replaced in both packages),
    params, histories and dropout masks."""
    ds, jg, tg = graphs
    n = ds.num_data
    cfg = _is_cfg("IS+CV" if cv else "IS+PP", dropout=0.2)
    jspec, spec = _specs(cfg, ds, cv)
    feats = np.hstack((ds.feats, ds.train_feats)).astype(np.float32)
    rng = np.random.default_rng(66)
    hist = _hist(rng, n, cfg.hidden1)
    batch = _batch(rng, ds, 28, 4)
    jimp = JS.compute_importance(jg)
    jpack = JS.schedule(jax.random.PRNGKey(5), jg, jnp.asarray(batch), (2,),
                        cv=cv, importance=jimp, is_slot_cap=cfg.is_slot_cap)
    monkeypatch.setattr(JStep, "schedule", lambda *a, **kw: jpack)
    monkeypatch.setattr(St, "schedule",
                        lambda *a, **kw: _to_torch_pack(jpack))
    jparams = JM.init_params(jax.random.PRNGKey(6), jspec)
    want = JStep.make_activation_taps(cfg, jspec, (2,), n, train_mode)(
        jparams, ((jnp.asarray(hist),),) if cv else (), jg,
        JG.dense_rows(feats, n), JG.dense_rows(ds.labels, n), jimp,
        jnp.asarray(batch), jax.random.PRNGKey(0))
    got = St.make_activation_taps(port_cfg(cfg), spec, (2,), n, train_mode)(
        C.params_from_jax(_np_tree(jparams)),
        ((T(hist),),) if cv else (), tg, G.dense_rows(feats, n),
        G.dense_rows(ds.labels, n), T(batch), torch.Generator(), T(jimp))
    # a jitted function's dict comes back with its keys sorted
    assert sorted(got) == sorted(want)
    assert list(got)[0] == "input"
    assert any(label.endswith(":AggSpec") for label in got)
    for label, stats in want.items():
        np.testing.assert_allclose([float(v) for v in got[label]],
                                   [float(v) for v in stats], **TOL)


def test_trainer_activation_stats_match_jax(tmp_path):
    """Exhaustive degree and no dropout, so both Trainers run the same
    forward: a JAX checkpoint served by the port gives JAX's moments."""
    from stochastic_gcn_tpu.config import parse_flags as jparse
    cfg = jparse(["--dataset", f"synthetic:{N_NODES}:16:5", "--batch_size",
                  "16", "--degree", "10000", "--test_degree", "10000",
                  "--cv", "--test_cv", "--hidden1", "16", "--normalization",
                  "graphsage", "--layer_norm", "--dropout", "0",
                  "--pad_degree", "-1", "--seed", "1", "--test_batch_size",
                  "24", "--ckpt_dir", str(tmp_path)])
    ds = JLd.load_data(cfg)
    jt = JaxTrainer(cfg, ds)
    jt.train_epoch()
    jt.save()
    tt = Trainer(port_cfg(cfg), ds, device="cpu")
    tt.load(load_history=True)
    for train in (True, False):
        want, got = jt.activation_stats(train=train), \
            tt.activation_stats(train=train)
        assert sorted(got) == sorted(want)
        for label, stats in want.items():
            assert set(got[label]) == {"mean", "std", "absmax"}
            for k, v in stats.items():
                assert isinstance(got[label][k], float)
                np.testing.assert_allclose(got[label][k], v, **TOL)


def test_tap_is_population_std_of_the_mean_stream():
    taps = []
    x = torch.tensor([[1.0, 2.0], [3.0, 6.0]])
    M._tap(taps, "a", x)
    M._tap(taps, "b", (x, torch.ones(2, 2)))
    M._tap(None, "c", x)
    assert [t[0] for t in taps] == ["a", "b"]
    for _, mean, std, absmax in taps:
        assert float(mean) == 3.0 and float(absmax) == 6.0
        np.testing.assert_allclose(float(std), np.std([1, 2, 3, 6]),
                                   rtol=1e-6)


# ------------------------------ the MLP ------------------------------------

MLP_FLAGS = ["--dataset", "synthetic:200:12:4", "--model", "mlp",
             "--batch_size", "32", "--test_batch_size", "40", "--hidden1",
             "16", "--layer_norm", "--dropout", "0.2", "--seed", "2",
             "--epochs", "2", "--weight_decay", "5e-4"]


@pytest.fixture(scope="module")
def mlp_setup():
    from stochastic_gcn_tpu.config import parse_flags as jparse
    cfg = jparse(MLP_FLAGS)
    return cfg, JLd.load_data(cfg)


@pytest.mark.parametrize("sparse", [False, True])
def test_multihop_features_match_jax(mlp_setup, sparse):
    _, ds = mlp_setup
    feats = sp.csr_matrix(ds.feats) if sparse else ds.feats
    got = Mlp.multihop_features(feats, ds.full_adj, 2)
    want = JMlp.multihop_features(feats, ds.full_adj, 2)
    assert sp.issparse(got) == sparse and got.shape == want.shape
    np.testing.assert_array_equal(got.toarray() if sparse else got,
                                  want.toarray() if sparse else want)


def test_mlp_trainer_takes_sparse_features_like_jax(mlp_setup):
    """Sparse features without ``--dense_input``: both MLP trainers densify
    the multi-hop matrix (the JAX one through ``dense_rows``), to the same
    values, and train on it."""
    cfg, ds = mlp_setup
    ds = dataclasses.replace(ds, feats=sp.csr_matrix(ds.feats))
    assert not cfg.dense_input
    jt = JMlp.MLPTrainer(cfg, ds)
    pt = Mlp.MLPTrainer(port_cfg(cfg), ds, device="cpu")
    assert pt.features.dtype == torch.float32
    np.testing.assert_array_equal(N(pt.features), np.asarray(jt.features))
    assert pt.spec == jt.spec
    loss, _ = pt.train_epoch()
    assert np.isfinite(loss)


def _mlp_pair(cfg, ds):
    jt = JMlp.MLPTrainer(cfg, ds)
    pt = Mlp.MLPTrainer(port_cfg(cfg), ds, device="cpu")
    assert pt.spec == jt.spec
    pt.params = C.params_from_jax(_np_tree(jt.params))
    pt.opt_state = pt.tx.init(pt.params)
    return jt, pt


@pytest.mark.parametrize("train", [True, False])
def test_mlp_forward_matches_jax(mlp_setup, shared_noise, train):
    cfg, ds = mlp_setup
    jt, pt = _mlp_pair(cfg, ds)
    x = np.asarray(jt.features)[:37]
    want = JMlp.mlp_forward(jt.params, jt.spec, jnp.asarray(x),
                            jax.random.PRNGKey(0), cfg.keep_prob, train)
    got = Mlp.mlp_forward(pt.params, pt.spec, T(x), torch.Generator(),
                          cfg.keep_prob, train)
    np.testing.assert_allclose(N(got), np.asarray(want), **TOL)


def test_mlp_train_step_and_evaluation_match_jax(mlp_setup, shared_noise):
    cfg, ds = mlp_setup
    jt, pt = _mlp_pair(cfg, ds)
    n = ds.num_data
    batch = _batch(np.random.default_rng(67), ds, 28, 4)
    jparams, _, jloss, jacc = jt._train_step(
        jt.params, jt.opt_state, jt.features, jt.labels, jnp.asarray(batch),
        jax.random.PRNGKey(1))
    loss, acc = pt.train_step(T(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(acc), float(jacc), **TOL)
    for layer, p in _np_tree(jparams).items():
        for name, v in p.items():
            np.testing.assert_allclose(N(pt.params[layer][name]), v, **TOL)
    jt.params = jparams
    np.testing.assert_allclose(pt.evaluate(ds.val_d), jt.evaluate(ds.val_d),
                               **TOL)
    assert tuple(pt.features.shape) == (n + 1, 3 * ds.feature_dim)


@pytest.mark.parametrize("multitask", [False, True])
def test_calc_f1_matches_jax(multitask):
    rng = np.random.default_rng(68)
    for trial in range(30):
        rows, c = int(rng.integers(1, 60)), int(rng.integers(1, 9))
        y_pred = rng.random((rows, c)).astype(np.float32)
        if multitask:
            y_true = (rng.random((rows, c)) < rng.random()).astype(np.float32)
        else:
            # some classes absent from y_true, some from y_pred
            y_true = np.eye(c, dtype=np.float32)[
                rng.integers(0, max(1, c - trial % 3), rows)]
        np.testing.assert_allclose(Met.calc_f1(y_pred, y_true, multitask),
                                   JMet.calc_f1(y_pred, y_true, multitask),
                                   rtol=0, atol=1e-12)


def _shape(line):
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


def test_cli_train_mlp_prints_the_jax_lines(capsys):
    jax_train_cli.main(MLP_FLAGS)
    want = capsys.readouterr().out.splitlines()
    tr = train_cli.main(MLP_FLAGS + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert isinstance(tr, Mlp.MLPTrainer)
    assert [_shape(s) for s in got] == [_shape(s) for s in want]
    assert got[:2] == want[:2]
    assert [s[:11] for s in got if s.startswith("Epoch")] == \
        ["Epoch: 0001", "Epoch: 0002"]
    assert got[-1].startswith("Test set results: cost= ")
