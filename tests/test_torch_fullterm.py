"""The other forms of the CV full-neighbourhood term on the CPU, against the
JAX package: the edge-list graph layout (``flat_csr``, ``flat_row_windows``,
the edge-list term, samplers and importance on row windows), the two-tier
term on either layout, the epoch-frozen a-bar table of ``--lazy_fullterm``
and ``ema_aggregate``; then the Trainer and the artifact on the edge list.

The same numpy inputs go through the JAX function and its port.
Tolerances:

* graph arrays and statics, row windows, big-row positions, schedules
  drawn from the same generator: exact;
* the full term in every form, plain and squared: rtol 1e-5, atol 1e-6
  (float32 sums in another order); the a-bar table and ``ema_aggregate``:
  1e-5;
* one lazy train step: rtol = atol = 1e-4, as tests/test_torch_estimators.py
  holds the eager one;
* lazy against eager with the batch covering all nodes, 4 epochs: rtol
  1e-4, atol 1e-5; edge-list trajectories against padded ones from the same
  generator: rtol 1e-5; against JAX's with exhaustive sampling and no
  dropout: atol 1e-4, as tests/test_torch_train.py holds the padded one.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.data import loaders as JLd
from stochastic_gcn_tpu.data import preprocess as JP
from stochastic_gcn_tpu.models import aggregators as JA
from stochastic_gcn_tpu.models import gcn as JM
from stochastic_gcn_tpu.sampler import scheduler as JS
from stochastic_gcn_tpu.training import step as JStep
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer

from stochastic_gcn_tpu_torch.data import graph as G
from stochastic_gcn_tpu_torch.models import aggregators as A
from stochastic_gcn_tpu_torch.sampler import scheduler as S
from stochastic_gcn_tpu_torch.serving import load_predictor, export_predictor
from stochastic_gcn_tpu_torch.training import checkpoint as C
from stochastic_gcn_tpu_torch.training import step as St
from stochastic_gcn_tpu_torch.training.loop import Trainer

from test_torch_estimators import (STEP_TOL, N, T, _batch, _estimator_cfg,
                                   _jax_histories, _np_tree,
                                   _random_histories, _specs,
                                   _to_torch_pack, graphs, port_cfg,
                                   shared_noise)

TERM_TOL = dict(rtol=1e-5, atol=1e-6)
GRAPH_STATICS = ("max_degree", "edge_cap_per_row", "parts", "tier_w",
                 "tier_frac", "truncated_frac")


def skewed_adj(n=400, seed=0):
    """Most rows of degree 5-12, one in 20 a hub of 40-64 (the JAX tier
    tests' graph), graphsage-normalised."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(4 + rng.geometric(0.25, n), 12)
    hubs = rng.choice(n, size=n // 20, replace=False)
    deg[hubs] = rng.integers(40, 65, size=hubs.size)
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = rng.integers(0, n, size=src.shape[0], dtype=np.int32)
    keep = src != dst
    adj01 = (JP.adj_from_edges(np.stack([src[keep], dst[keep]], 1), n)
             > 0).astype(np.float32)
    return JP.graphsage_normalize_adj(adj01)


@pytest.fixture(scope="module")
def adj():
    return skewed_adj()


def both_flat(adj, *args, **kw):
    """The JAX and the port's ``flat_csr`` of ``adj``, with the warnings
    each gave."""
    out = []
    for fn in (JG.flat_csr, G.flat_csr):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append((fn(adj, *args, **kw),
                        [str(w.message) for w in caught]))
    return out


def _hist(rows, d, seed):
    h = np.random.default_rng(seed).normal(size=(rows, d)).astype(np.float32)
    h[rows - 1] = 0.0
    return h


# ------------------------------ the layout --------------------------------

@pytest.mark.parametrize("edge_mult", [0.0, 1e9, 2.0, 0.5])
@pytest.mark.parametrize("tier", [False, True])
def test_flat_csr_matches_jax(adj, edge_mult, tier):
    """Auto and explicit budgets, a budget that truncates (and warns), with
    and without the tier split: every array and static exactly equal."""
    (jg, jwarn), (tg, twarn) = both_flat(adj, edge_mult, tier=tier)
    for name in ("bstart", "idx", "w", "deg", "renorm"):
        want = np.asarray(getattr(jg, name))
        got = getattr(tg, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in GRAPH_STATICS:
        assert getattr(tg, name) == getattr(jg, name), name
    assert tg.num_nodes == jg.num_nodes and tg.pad_degree == jg.pad_degree
    assert twarn == jwarn
    if edge_mult == 0.5:
        assert tg.truncated_frac > 0.01 and len(twarn) == 1
        assert (tg.renorm.numpy() > 1.0).any()
    if tier and edge_mult == 1e9:
        assert tg.tier_w > 0


def test_flat_csr_explicit_tier_width_matches_jax(adj):
    for tier_w in (16, 12):       # on the block grid, and off it (refused)
        (jg, _), (tg, _) = both_flat(adj, 1e9, tier=True, tier_w=tier_w)
        assert (tg.tier_w, tg.tier_frac) == (jg.tier_w, jg.tier_frac)
    assert tg.tier_w == -1


def test_flat_csr_parts_raises(adj):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        G.flat_csr(adj, parts=2)


@pytest.mark.parametrize("width, start", [(None, 0), (24, 0), (40, 16)])
def test_flat_row_windows_match_jax(adj, width, start):
    (jg, _), (tg, _) = both_flat(adj, 1e9, tier=True)
    n = tg.num_nodes
    width = width or tg.max_degree - start
    field = np.r_[np.random.default_rng(3).permutation(n)[:60],
                  [n, n]].astype(np.int32)
    want = JG.flat_row_windows(jg, jnp.asarray(field), width, start=start)
    got = G.flat_row_windows(tg, T(field), width, start=start)
    for g_, w_ in zip(got, want):
        assert g_.is_contiguous()
        np.testing.assert_array_equal(N(g_), np.asarray(w_))


def test_graph_rows_and_slots_equal_on_both_layouts(adj):
    pg, fg = G.pad_csr(adj), G.flat_csr(adj)
    assert fg.pad_degree == pg.pad_degree
    n = pg.num_nodes
    field = T(np.r_[np.arange(0, n, 7), [n, n]].astype(np.int32))
    for a, b in zip(G.graph_rows(pg, field), G.graph_rows(fg, field)):
        np.testing.assert_array_equal(N(a), N(b))
    deg = pg.deg[field.long()]
    sel = torch.clamp(deg - 1, min=0) // 2
    for a, b in zip(G.graph_slots(pg, field, sel),
                    G.graph_slots(fg, field, sel)):
        np.testing.assert_array_equal(N(a), N(b))
    assert (N(G.graph_slots(fg, field, sel)[0])[-2:] == n).all()


# ------------------------------ the full term -----------------------------

def _layouts(adj, tier):
    """(JAX graph, port graph) per layout: padded, and an edge list whose
    budget covers every row."""
    jp, tp = JG.pad_csr(adj, -1), G.pad_csr(adj, -1, tier=tier)
    if tier:
        jp = dataclasses.replace(jp, tier_w=tp.tier_w, tier_frac=tp.tier_frac)
    else:
        jp = dataclasses.replace(jp, tier_w=-1)
    (jf, _), (tf, _) = both_flat(adj, 1e9, tier=tier)
    return {"padded": (jp, tp), "edgelist": (jf, tf)}


@pytest.mark.parametrize("layout", ["padded", "edgelist"])
@pytest.mark.parametrize("tier", [False, True])
@pytest.mark.parametrize("square", [False, True])
def test_full_neighborhood_mean_matches_jax(adj, monkeypatch, layout, tier,
                                            square):
    monkeypatch.setattr(JA, "TIER_MIN_ROWS", 0)
    monkeypatch.setattr(A, "TIER_MIN_ROWS", 0)
    calls = []
    tiered = A._tiered
    monkeypatch.setattr(A, "_tiered",
                        lambda *a: calls.append(1) or tiered(*a))
    jg, tg = _layouts(adj, tier)[layout]
    assert (tg.tier_w > 0) == tier
    n = tg.num_nodes
    hist = _hist(n + 1, 12, seed=4)
    field = np.r_[np.random.default_rng(5).integers(0, n, 120),
                  [n, n]].astype(np.int32)
    want = JA.full_neighborhood_mean(jnp.asarray(hist), jg,
                                     jnp.asarray(field), square=square)
    got = A.full_neighborhood_mean(T(hist), tg, T(field), square=square)
    np.testing.assert_allclose(N(got), np.asarray(want), **TERM_TOL)
    assert len(calls) == int(tier)       # --fadj_tier picks the calls


def test_truncated_edgelist_term_matches_jax(adj):
    """A budget that truncates: the kept edges renormalised, then squared."""
    (jg, _), (tg, _) = both_flat(adj, 0.5)
    n = tg.num_nodes
    hist = _hist(n + 1, 8, seed=6)
    field = np.arange(0, n, 3, dtype=np.int32)
    for square in (False, True):
        want = JA.full_neighborhood_mean(jnp.asarray(hist), jg,
                                         jnp.asarray(field), square=square)
        got = A.full_neighborhood_mean(T(hist), tg, T(field), square=square)
        np.testing.assert_allclose(N(got), np.asarray(want), **TERM_TOL)


@pytest.mark.parametrize("frac", [None, 1e-6])
def test_tiered_full_contract_matches_jax(adj, frac):
    """The gathered-rows form, at the graph's tail capacity and at one
    below the big-row count (the full-width fallback)."""
    g = JG.pad_csr(adj, -1, tier=True)
    n = g.num_nodes
    deg = np.asarray(g.deg)[:n]
    big = np.where(deg > g.tier_w)[0]
    field = np.resize(big, 96).astype(np.int32) if frac else \
        np.random.default_rng(7).integers(0, n, 128).astype(np.int32)
    frac = frac or g.tier_frac
    hist = _hist(n + 1, 8, seed=8)
    rows = [np.asarray(t)[field] for t in (g.nbr, g.w, g.deg)]
    want = JA.tiered_full_contract(jnp.asarray(hist), *map(jnp.asarray, rows),
                                   g.tier_w, frac)
    got = A.tiered_full_contract(T(hist), *map(T, rows), g.tier_w, frac)
    np.testing.assert_allclose(N(got), np.asarray(want), **TERM_TOL)
    plain = np.einsum("fk,fkd->fd", rows[1], hist[rows[0]])
    np.testing.assert_allclose(N(got), plain, **TERM_TOL)


@pytest.mark.parametrize("layout", ["padded", "edgelist"])
def test_overflow_falls_back_exactly(adj, monkeypatch, layout):
    """A field of big rows only, with a tail capacity below their count:
    the full-width tail keeps the value exact."""
    monkeypatch.setattr(A, "TIER_MIN_ROWS", 0)
    _, tg = _layouts(adj, True)[layout]
    tiny = dataclasses.replace(tg, tier_frac=1e-6)
    off = dataclasses.replace(tg, tier_w=-1)
    deg = N(tg.deg)[:-1]
    field = T(np.resize(np.where(deg > tg.tier_w)[0], 96).astype(np.int32))
    assert int((deg[N(field).astype(int)] > tg.tier_w).sum()) \
        > A._tier_cap(96, 1e-6)
    hist = T(_hist(tg.num_nodes + 1, 8, seed=9))
    np.testing.assert_allclose(N(A.full_neighborhood_mean(hist, tiny, field)),
                               N(A.full_neighborhood_mean(hist, off, field)),
                               **TERM_TOL)


@pytest.mark.parametrize("jimpl", ["topk", "cumsum"])
@pytest.mark.parametrize("p_big, big_cap", [(0.1, 16), (0.5, 16), (0.0, 8),
                                            (1.0, 40)])
def test_big_row_positions_match_jax(monkeypatch, jimpl, p_big, big_cap):
    """The first big_cap flagged positions in ascending order, then the
    sentinel F, and the flagged count, as each JAX lowering gives them;
    overflowing counts included."""
    monkeypatch.setattr(JA, "TIER_POS_IMPL", jimpl)
    is_big = np.random.default_rng(10).random(40) < p_big
    pos, n_big = A._big_row_positions(T(is_big), big_cap)
    assert pos.dtype == torch.int32 and tuple(pos.shape) == (big_cap,)
    jpos, jn = JA._big_row_positions(jnp.asarray(is_big), big_cap)
    np.testing.assert_array_equal(N(pos), np.asarray(jpos))
    assert int(n_big) == int(jn)


# ------------------------------ the a-bar table ---------------------------

@pytest.mark.parametrize("layout, square", [("padded", False),
                                            ("padded", True),
                                            ("edgelist", False),
                                            ("edgelist", True)])
def test_full_abar_matches_jax(adj, layout, square):
    """Every row to 1e-5 (the edge list in chunks of 64 rows, JAX in
    chunks of 40); rows N and up, to the history's rounded row count,
    zero."""
    jg, tg = _layouts(adj, False)[layout]
    n = tg.num_nodes
    rows = -(-(n + 1) // 8) * 8
    hist = _hist(rows, 8, seed=11)
    hist[n:] = 0.0
    want = np.asarray(JA.full_abar(jnp.asarray(hist), jg, n, square=square,
                                   chunk=40))
    got = N(A.full_abar(T(hist), tg, n, square=square, chunk=64))
    assert got.shape == want.shape == (rows, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[n:] == 0.0).all()


def test_full_abar_rows_equal_the_per_step_term(adj):
    (_, _), (tg, _) = both_flat(adj, 0.5, tier=True)
    n = tg.num_nodes
    hist = T(_hist(n + 1, 8, seed=12))
    field = T(np.arange(n, dtype=np.int32))
    np.testing.assert_allclose(
        N(A.full_abar(hist, tg, n)[:n]),
        N(A.full_neighborhood_mean(hist, tg, field)), **TERM_TOL)


@pytest.mark.parametrize("name", ["cv_nopp", "cvd", "det_dropout"])
def test_lazy_train_step_matches_jax(graphs, shared_noise, name):
    """One train step under a frozen anchor: a shared pack, shared dropout
    noise, live histories and a snapshot that differ, each package's
    a-bar of the same snapshot."""
    ds, jg, tg = graphs
    n = ds.num_data
    cfg = _estimator_cfg(name, lazy_fullterm=True)
    jspec, spec = _specs(cfg, ds)
    degrees = (cfg.degree,) * spec.num_agg_layers
    feats = (np.hstack((ds.feats, ds.train_feats)) if cfg.preprocess
             else ds.feats).astype(np.float32)
    rng = np.random.default_rng(50)
    live = _random_histories(rng, spec, n, torch.bfloat16)
    snap = _random_histories(rng, spec, n, torch.bfloat16)
    batch = _batch(rng, ds, 28, 4)
    jpack = JS.schedule(jax.random.PRNGKey(3), jg, jnp.asarray(batch),
                        degrees, cv=True, need_aw=cfg.det_dropout,
                        dedup=cfg.field_dedup)
    jsnap = _jax_histories(snap)
    jlazy = (jsnap, tuple(tuple(
        JA.full_abar(h, jg, n, square=cfg.det_dropout and j == 1)
        for j, h in enumerate(hl)) for hl in jsnap))

    jparams = JM.init_params(jax.random.PRNGKey(4), jspec)
    jstate = JStep.TrainState(
        params=jparams, opt_state=JStep.make_optimizer(cfg).init(jparams),
        histories=_jax_histories(live), step=jnp.zeros((), jnp.int32))
    jstep = JStep.build_train_step(cfg, jspec, degrees, n)
    jstate, jm = jstep(jstate, jg, JG.dense_rows(feats, n),
                       JG.dense_rows(ds.labels, n), jnp.zeros((n + 1,)),
                       jnp.asarray(batch), jax.random.PRNGKey(0), pack=jpack,
                       lazy=jlazy)

    params = C.params_from_jax(_np_tree(jparams))
    pcfg = port_cfg(cfg)
    state = St.TrainState(
        params=params, opt_state=St.make_optimizer(pcfg).init(params),
        histories=tuple(tuple(h.clone() for h in hl) for hl in live),
        step=torch.zeros((), dtype=torch.int32))
    lazy = St.lazy_anchor(spec, snap, tg, n)
    for hl, jhl in zip(lazy[1], jlazy[1]):
        for a, ja in zip(hl, jhl):
            np.testing.assert_allclose(N(a), np.asarray(ja), rtol=1e-5,
                                       atol=1e-5)
    step = St.build_train_step(pcfg, spec, degrees, n)
    state, m = step(state, tg, G.dense_rows(feats, n),
                    G.dense_rows(ds.labels, n), T(batch), torch.Generator(),
                    pack=_to_torch_pack(jpack), lazy=lazy)

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **STEP_TOL)
    jopt = jstate.opt_state[0]
    for l, k in St.param_keys(params):
        np.testing.assert_allclose(N(state.opt_state.mu[l][k]),
                                   np.asarray(jopt.mu[l][k]), **STEP_TOL)
        np.testing.assert_allclose(N(state.params[l][k]),
                                   np.asarray(jstate.params[l][k]),
                                   **STEP_TOL)
    for hl, jhl in zip(state.histories, jstate.histories):
        for h, jh in zip(hl, jhl):
            want = np.asarray(jh.astype(jnp.float32))
            ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
            assert (np.abs(N(h) - want) <= ulp + 1e-4).all()
    # the snapshot is a copy: the step's scatter left it as it was
    for hl, old in zip(lazy[0], snap):
        for h, o in zip(hl, old):
            assert torch.equal(h, o)


@pytest.fixture(scope="module")
def small_ds():
    return JLd.synthetic_dataset(num_nodes=96, feature_dim=12, num_classes=4,
                                 avg_degree=6, seed=3)


def _lazy_run(ds, epochs, **kw):
    cfg = Config(**{**dict(dataset="synthetic", batch_size=ds.num_data,
                           hidden1=16, dropout=0.0, seed=7, cv=True,
                           test_cv=True, degree=1, test_degree=1,
                           history_dtype="float32"), **kw})
    tr = Trainer(port_cfg(cfg), ds, device="cpu")
    return [float(tr.train_epoch()[0]) for _ in range(epochs)], tr


def test_lazy_matches_eager_when_batch_covers_all_nodes(small_ds):
    """With the batch all N nodes every eager anchor is refreshed each step,
    so the epoch-start snapshot equals it and the two trajectories agree;
    a snapshot that aliased the live history would diverge from epoch 2."""
    eager, _ = _lazy_run(small_ds, 4, lazy_fullterm=False)
    lazy, _ = _lazy_run(small_ds, 4, lazy_fullterm=True)
    np.testing.assert_allclose(lazy, eager, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", ["cv", "cvd", "det"])
def test_lazy_trains_all_estimator_families(small_ds, variant):
    kw = {"cv": {}, "cvd": dict(cvd=True, test_cvd=True, dropout=0.2),
          "det": dict(det_dropout=True, dropout=0.2)}[variant]
    losses, tr = _lazy_run(small_ds, 10, lazy_fullterm=True, **kw)
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    # the live histories kept taking the scatters under the frozen anchor
    assert tr.state.histories[0][0][:small_ds.num_data].abs().max() > 0


# ------------------------- samplers on the edge list ----------------------

@pytest.mark.filterwarnings("ignore:flat_csr")
@pytest.mark.parametrize("degree", [1, 3, 10000])
def test_expand_uniform_draws_equal_on_both_layouts(adj, degree):
    pg, fg = G.pad_csr(adj), G.flat_csr(adj, 0.5)
    n = pg.num_nodes
    field = T(np.r_[np.random.default_rng(13).permutation(n)[:50],
                    [n]].astype(np.int32))
    outs = [S.expand_uniform(torch.Generator().manual_seed(4), g, field,
                             degree, True) for g in (pg, fg)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(N(a), N(b))


@pytest.mark.filterwarnings("ignore:flat_csr")
@pytest.mark.parametrize("importance", [False, True])
def test_schedule_equal_on_both_layouts(adj, importance):
    pg, fg = G.pad_csr(adj), G.flat_csr(adj, 0.5)
    n = pg.num_nodes
    imp = S.compute_importance(pg) if importance else None
    batch = T(np.r_[np.arange(0, 60, 2), [n, n]].astype(np.int32))
    packs = [S.schedule(torch.Generator().manual_seed(5), g, batch, (2, 2),
                        True, importance=imp) for g in (pg, fg)]
    for fa, fb in zip(packs[0].fields, packs[1].fields):
        np.testing.assert_array_equal(N(fa), N(fb))
    for la, lb in zip(packs[0].layers, packs[1].layers):
        np.testing.assert_array_equal(N(la.slot_pos), N(lb.slot_pos))
        np.testing.assert_array_equal(N(la.slot_w), N(lb.slot_w))


def test_compute_importance_matches_jax(adj):
    (jg, _), (tg, _) = both_flat(adj)
    np.testing.assert_allclose(N(S.compute_importance(tg)),
                               np.asarray(JS.compute_importance(jg)),
                               rtol=1e-6)
    np.testing.assert_allclose(N(S.compute_importance(tg)),
                               N(S.compute_importance(G.pad_csr(adj))),
                               rtol=1e-6)


def test_batch_stats_count_the_edge_budget_as_jax(adj):
    """fadj counts min(deg, edge_cap_per_row) a row on the edge list."""
    (jg, _), (tg, _) = both_flat(adj, 0.5)
    n = tg.num_nodes
    batch = np.r_[np.arange(0, 80), [n]].astype(np.int32)
    jpack = JS.schedule(jax.random.PRNGKey(2), jg, jnp.asarray(batch), (2,),
                        cv=True)
    want = JStep._batch_stats(jpack, jg, n, True)
    got = St._batch_stats(_to_torch_pack(jpack), tg, n, True)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(N(g_).astype(np.int64), np.asarray(w_))
    full = int(N(tg.deg)[np.asarray(jpack.fields[1])].sum())
    assert int(got[3][0]) < full


def test_ema_aggregate_matches_jax(adj):
    g = JG.pad_csr(adj)
    n = g.num_nodes
    batch = np.r_[np.arange(0, 60), [n, n]].astype(np.int32)
    jpack = JS.schedule(jax.random.PRNGKey(1), g, jnp.asarray(batch), (3,),
                        cv=True)
    pack = _to_torch_pack(jpack)
    rng = np.random.default_rng(14)
    h = rng.normal(size=(jpack.fields[0].shape[0], 8)).astype(np.float32)
    hist = rng.normal(size=(n + 1, 8)).astype(np.float32)
    for norm in ("gcn", "graphsage"):
        want, (wh,) = JA.ema_aggregate(jnp.asarray(h), jpack.layers[0],
                                       jpack.fields[0], (jnp.asarray(hist),),
                                       0.3, norm)
        got, (gh,) = A.ema_aggregate(T(h), pack.layers[0], pack.fields[0],
                                     (T(hist),), 0.3, norm)
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(N(gh), np.asarray(wh), rtol=1e-5,
                                   atol=1e-5)


# ------------------------- the Trainer and the artifact -------------------

@pytest.fixture(scope="module")
def tds():
    return JLd.synthetic_dataset(num_nodes=150, feature_dim=16,
                                 num_classes=4, avg_degree=5, seed=0)


BASE = dict(dataset="synthetic", batch_size=64, degree=1, test_degree=1,
            cv=True, test_cv=True, hidden1=16, dropout=0.2, seed=1,
            test_batch_size=75)


def test_edgelist_cv_trajectory_matches_padded(tds):
    """Same generator, same adjacency: the same trajectory."""
    tr_a = Trainer(port_cfg(Config(**BASE)), tds, device="cpu")
    tr_b = Trainer(port_cfg(Config(**BASE, graph_format="edgelist",
                                   fadj_edge_mult=1e9)), tds, device="cpu")
    assert isinstance(tr_b.graph_train, G.FlatGraph)
    for _ in range(3):
        la = tr_a.train_epoch()[0]
        lb = tr_b.train_epoch()[0]
    np.testing.assert_allclose(lb, la, rtol=1e-5)
    np.testing.assert_allclose(tr_b.evaluate(tds.val_d)[0],
                               tr_a.evaluate(tds.val_d)[0], rtol=1e-4)


def test_edgelist_importance_trajectory_matches_padded(tds):
    base = dict(dataset="synthetic", batch_size=64, degree=2, test_degree=2,
                importance=True, test_importance=True, hidden1=16,
                dropout=0.0, seed=3)
    tr_a = Trainer(port_cfg(Config(**base)), tds, device="cpu")
    tr_b = Trainer(port_cfg(Config(**base, graph_format="edgelist",
                                   fadj_edge_mult=1e9)), tds, device="cpu")
    for _ in range(2):
        la = tr_a.train_epoch()[0]
        lb = tr_b.train_epoch()[0]
    np.testing.assert_allclose(lb, la, rtol=1e-5)


@pytest.mark.parametrize("over", [
    dict(cv=True, test_cv=True),
    # every union member selected: the Gumbel draws do not matter
    dict(importance=True, test_importance=True, is_approx_topk=False)])
def test_edgelist_trajectory_matches_jax(tds, over):
    """Exhaustive degree and no dropout, so both packages sample the same
    fields: two epochs and an evaluation on the edge list, as
    tests/test_torch_train.py holds the padded trajectory."""
    cfg = Config(**{**BASE, "degree": 10000, "test_degree": 10000,
                    "dropout": 0.0, "batch_size": 16, "test_batch_size": 24,
                    "cv": False, "test_cv": False, **over,
                    "graph_format": "edgelist", "fadj_edge_mult": 1e9})
    jt = JaxTrainer(cfg, tds)
    tt = Trainer(port_cfg(cfg), tds, device="cpu")
    init = _np_tree(jt.state.params)
    for l, k in St.param_keys(tt.params):
        tt.params[l][k].copy_(T(init[l][k]))
    for _ in range(2):
        jloss = jt.train_epoch()[0]
        loss = tt.train_epoch()[0]
        np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-4)
    assert tt.amt_data == jt.amt_data
    np.testing.assert_allclose(tt.evaluate(tds.val_d)[:4],
                               jt.evaluate(tds.val_d)[:4], rtol=0, atol=1e-4)


def test_truncated_edges_frac_matches_jax(tds):
    cfg = Config(**BASE, graph_format="edgelist", fadj_edge_mult=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = JaxTrainer(cfg, tds)
        tt = Trainer(port_cfg(cfg), tds, device="cpu")
    assert tt.truncated_edges_frac == jt.truncated_edges_frac > 0.0
    assert Trainer(port_cfg(Config(**BASE)), tds,
                   device="cpu").truncated_edges_frac == 0.0
    loss = tt.train_epoch()[0]
    assert np.isfinite(loss)


def test_use_pallas_rule(tds):
    with pytest.raises(ValueError, match="padded"):
        Trainer(port_cfg(Config(**BASE, use_pallas=True,
                                graph_format="edgelist")), tds, device="cpu")
    for over in (dict(use_pallas=True), dict(graph_format="csr")):
        tr = Trainer(port_cfg(Config(**BASE, **over)), tds, device="cpu")
        assert isinstance(tr.graph_train, G.PaddedGraph)


def test_fadj_tier_changes_the_kernel_calls(monkeypatch):
    """With the gate lowered, ``--fadj_tier`` (a forced width) runs the
    two-tier term in the train step, and the trajectory is the untiered
    one."""
    ds = JLd.synthetic_dataset(num_nodes=150, feature_dim=16, num_classes=4,
                               avg_degree=16, seed=0)
    monkeypatch.setattr(A, "TIER_MIN_ROWS", 0)
    calls = []
    tiered = A._tiered
    monkeypatch.setattr(A, "_tiered",
                        lambda *a: calls.append(1) or tiered(*a))
    losses = []
    for fmt in ("padded", "edgelist"):
        for tier in (False, True):
            cfg = Config(**BASE, graph_format=fmt, fadj_edge_mult=1e9,
                         fadj_tier=tier, fadj_tier_w=8)
            tr = Trainer(port_cfg(cfg), ds, device="cpu")
            assert (tr.graph_train.tier_w > 0) == tier
            before = len(calls)
            losses.append(tr.train_epoch()[0])
            assert (len(calls) > before) == tier
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)


def test_edgelist_artifact_serves_bitwise(tds, tmp_path):
    cfg = Config(**BASE, graph_format="edgelist", fadj_edge_mult=0.0,
                 ckpt_dir=str(tmp_path))
    tr = Trainer(port_cfg(cfg), tds, device="cpu")
    for _ in range(2):
        tr.train_epoch()
    ids = np.asarray(tds.test_d)
    live = tr.predict(ids)
    path = export_predictor(tr, str(tmp_path / "art"))
    pred = load_predictor(path, device="cpu")
    assert isinstance(pred._graph, G.FlatGraph)
    for name in GRAPH_STATICS:
        assert getattr(pred._graph, name) == getattr(tr.graph_full, name)
    np.testing.assert_array_equal(pred.predict(ids), live)
    np.testing.assert_array_equal(pred.predict(ids[::-1]), live[::-1])
