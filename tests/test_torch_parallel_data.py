"""The data axis of the port's data parallelism on the CPU: owner-aligned
batches and fields (``--owner_batching``) and node-sharded edge lists
(``flat_csr(parts > 1)``, ``--graph_format edgelist --dp P
--shard_graph``), against the JAX package and the port's own runs without
them.  The ranks are gloo process groups of 2 running the port's rank
functions (stochastic_gcn_tpu_torch/parallel/checks.py).  Tolerances:

* ``owner_grouped_batch_matrix``, ``compact_field_aligned``, the aligned
  schedule's fields, ``self_pos`` and slot positions, and ``flat_csr``'s
  tables at any ``parts``: exact (integer layouts);
* the aligned schedule samples the classic schedule's edges from the same
  generator: exact;
* a dp=2 owner-batched run, exhaustive and without dropout, against dp=1:
  the first step's loss and params, the activation moments and the
  gradient-variance table to rtol 1e-4 (float32 sums in another order);
  the CV estimator with dropout: validation micro-F1 within 0.1 of dp=1's;
* the dp=2 sharded edge list against the dp=2 padded graph: rtol 1e-5;
* the sharded edge list's artifact against the same artifact on the
  ``parts=1`` tables: bitwise.

The JAX side of the aligned schedule draws its uniforms by node id
(``_node_keyed_draws``), which the port's draws by classic position then
reproduce; the JAX package's own draws are by aligned position, so under
its own sampler the two layouts draw different edges.
"""

import json
import shutil
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.data import loaders as JLd
from stochastic_gcn_tpu.parallel import mesh as JMesh
from stochastic_gcn_tpu.sampler import scheduler as JS

from stochastic_gcn_tpu_torch import serving
from stochastic_gcn_tpu_torch.config import parse_flags
from stochastic_gcn_tpu_torch.data import graph as G
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.data.preprocess import cap_adj_degree
from stochastic_gcn_tpu_torch.parallel import checks, launch
from stochastic_gcn_tpu_torch.parallel import mesh as PM
from stochastic_gcn_tpu_torch.sampler import scheduler as S
from stochastic_gcn_tpu_torch.training.loop import Trainer

DATASET = "synthetic:300:32:5"
BASE = ["--dataset", DATASET, "--hidden1", "16", "--batch_size", "48",
        "--test_batch_size", "96", "--normalization", "graphsage",
        "--layer_norm", "--seed", "3"]
EXACT = ["--degree", "100", "--test_degree", "100", "--dropout", "0",
         "--field_dedup"]
CV = ["--cv", "--test_cv", "--degree", "2", "--test_degree", "2",
      "--field_dedup", "--dropout", "0"]
IS = ["--importance", "--test_importance", "--degree", "2",
      "--test_degree", "2", "--dropout", "0"]
EDGELIST = ["--graph_format", "edgelist", "--fadj_edge_mult", "1e9"]
OWNER = ["--owner_batching", "--partition_nodes", "rcm"]
CASES = {
    "owner_exact": (EXACT + OWNER, 0),      # untrained: comparable weights
    "owner_cv": (CV[:-1] + ["0.2"] + OWNER, 3),
    "padded": (CV, 2),
    "edgelist": (CV + EDGELIST, 2),
    "padded_is": (IS, 2),
    "edgelist_is": (IS + EDGELIST, 2),
}
TOL = dict(rtol=1e-4, atol=1e-6)
EDGE_TOL = dict(rtol=1e-5, atol=1e-7)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _flags(name, dp):
    return BASE + CASES[name][0] + ["--dp", str(dp)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at dp=2 (one spawned group), and the owner cases' dp=1
    runs without --owner_batching here."""
    root = tmp_path_factory.mktemp("data")
    cases = {name: (_flags(name, 2), epochs)
             for name, (_, epochs) in CASES.items()}
    launch.spawn(checks.trainer_runs, 2, (cases, str(root / "dp2.npz")),
                 "cpu", store_dir=str(root))
    got = dict(np.load(root / "dp2.npz"))
    want = {}
    for name in ("owner_exact", "owner_cv"):
        flags = [f for f in _flags(name, 1) if f != "--owner_batching"]
        cfg = parse_flags(flags)
        ds = Ld.load_data(cfg)
        want[f"{name}:step0"] = checks._first_step(Trainer(cfg, ds, "cpu"))
        tr = Trainer(cfg, ds, device="cpu")
        for _ in range(CASES[name][1]):
            tr.train_epoch()
        want[f"{name}:eval"] = tr.evaluate(ds.val_d)[:4]
        want[f"{name}:probes"] = checks.probes(tr)
    return root, got, want


# ------------------------- owner-aligned batches --------------------------

@pytest.mark.parametrize("n, p, batch, take", [
    (1000, 2, 64, 600), (1000, 4, 64, 600), (1000, 8, 64, 600),
    (300, 4, 48, 210), (257, 8, 32, 257), (500, 2, 40, 17)])
def test_owner_grouped_batch_matrix_matches_jax(n, p, batch, take):
    ids = np.random.default_rng(n + p).permutation(n)[:take].astype(np.int32)
    got = PM.owner_grouped_batch_matrix(ids, batch, n, p)
    np.testing.assert_array_equal(
        got, JMesh.owner_grouped_batch_matrix(ids, batch, n, p))
    real = got[got < n]
    assert sorted(real.tolist()) == sorted(ids.tolist())    # each id once


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("skew", [False, True])
def test_compact_field_aligned_matches_jax(p, skew):
    """Random fields, and fields whose ids one rank owns (they spill)."""
    n, f, k = 400, 32, 4
    rng = np.random.default_rng(p)
    # skewed: every id is rank 0's, more of them than its block holds
    top = PM.shard_rows(n, p) // p if skew else n + 1
    field_out = np.r_[rng.choice(min(top, n), f - 3, replace=False),
                      [n] * 3].astype(np.int32)
    new = rng.integers(0, top, (f, k)).astype(np.int32)
    cap = -(-(f + min(f * k, n)) // p) * p
    jf, jpos = JS.compact_field_aligned(jnp.asarray(field_out),
                                        jnp.asarray(new), n, cap, p)
    tf, tpos = S.compact_field_aligned(T(field_out), T(new), n, cap, p)
    np.testing.assert_array_equal(N(tf), np.asarray(jf))
    real = N(tf)[N(tf) < n]
    np.testing.assert_array_equal(N(tpos)[real], np.asarray(jpos)[real])
    # the classic layout's id set, each id in its owner's block unless
    # that block is full of its owner's ids
    classic, _ = S.compact_field(T(field_out), T(new), n, cap)
    assert set(real) == set(N(classic)[N(classic) < n])
    n_loc = PM.shard_rows(n, p) // p
    blocks = N(tf).reshape(p, -1)
    owner = np.minimum(blocks // n_loc, p - 1)
    full = [(blocks[q] < n).all() and (owner[q] == q).all()
            for q in range(p)]
    for q in range(p):
        foreign = owner[q][(blocks[q] < n) & (owner[q] != q)]
        assert all(full[o] for o in foreign)
    if skew:
        assert (blocks[1:] < n).any()                    # the spill


def _node_keyed_draws(monkeypatch, jg, key):
    """Both packages' uniform draws by node id: the JAX scheduler's
    ``expand_uniform`` takes its uniforms from an ``[N+1]`` (or ``[N+1,
    Dcap]``) draw indexed by node id, and the port's expander calls it with
    the same per-layer keys, so the neighbours a node draws do not depend
    on where the field puts it."""
    jax_expand = JS.expand_uniform

    def keyed(sub, graph, field_out, degree, need_aw, mesh=None):
        n1, dcap = graph.num_nodes + 1, graph.pad_degree
        rows = jax.random.uniform(sub, (n1,) if min(degree, dcap) == 1
                                  else (n1, dcap))

        def uniform(k, shape):
            return jnp.take(rows, field_out, axis=0)
        with monkeypatch.context() as m:
            m.setattr(jax.random, "uniform", uniform)
            return jax_expand(sub, graph, field_out, degree, need_aw, mesh)

    monkeypatch.setattr(JS, "expand_uniform", keyed)
    state = {"key": key}

    def port_expand(gen, graph, field_out, degree, need_aw):
        state["key"], sub = jax.random.split(state["key"])
        out = keyed(sub, jg, jnp.asarray(N(field_out)), degree, need_aw)
        return tuple(None if o is None else T(o) for o in out)

    monkeypatch.setattr(S, "expand_uniform", port_expand)


@pytest.fixture(scope="module")
def graphs():
    ds = JLd.synthetic_dataset(num_nodes=240, feature_dim=8, num_classes=3,
                               seed=0)
    adj = ds.full_adj.copy().tocsr()
    adj.data = np.random.default_rng(60).uniform(
        0.05, 1.0, adj.nnz).astype(np.float32)      # IS: no weight ties
    return ds, JG.pad_csr(adj), G.pad_csr(adj)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("mode", ["dedup", "nodedup", "importance"])
def test_aligned_schedule_matches_jax(graphs, monkeypatch, p, mode):
    """``schedule(owner_blocks=P)`` against JAX's on the same draws: the
    fields, ``self_pos`` and the slots exactly; the no-dedup flag is
    overridden (aligned fields are compacted); under IS the port's Gumbel
    noise is JAX's."""
    ds, jg, tg = graphs
    n = ds.num_data
    rng = np.random.default_rng(7 + p)
    batch = JMesh.owner_grouped_batch_matrix(
        rng.choice(ds.train_d, 30, replace=False).astype(np.int32), 32, n,
        p)[0]
    key = jax.random.PRNGKey(11)
    kw = dict(degrees=(2, 3), cv=True, need_aw=mode != "importance",
              dedup=mode == "dedup", round_multiple=p)
    if mode == "importance":
        kw.update(degrees=(2, 2))
        imp = JS.compute_importance(jg)
        state = {"key": key}

        def gumbel(gen, m, device):
            state["key"], sub = jax.random.split(state["key"])
            return T(jax.random.gumbel(sub, (m,)))
        monkeypatch.setattr(S, "_gumbel", gumbel)
        want = JS.schedule(key, jg, jnp.asarray(batch), importance=imp,
                           is_approx_topk=False, owner_blocks=p, **kw)
        got = S.schedule(torch.Generator(), tg, T(batch),
                         importance=T(imp), owner_blocks=p, **kw)
    else:
        _node_keyed_draws(monkeypatch, jg, key)
        want = JS.schedule(key, jg, jnp.asarray(batch), owner_blocks=p, **kw)
        got = S.schedule(torch.Generator(), tg, T(batch), owner_blocks=p,
                         **kw)
    for f, jf in zip(got.fields, want.fields):
        np.testing.assert_array_equal(N(f), np.asarray(jf))
    for ls, jls in zip(got.layers, want.layers):
        np.testing.assert_array_equal(N(ls.self_pos), np.asarray(jls.self_pos))
        np.testing.assert_array_equal(N(ls.slot_pos), np.asarray(jls.slot_pos))
        np.testing.assert_allclose(N(ls.slot_w), np.asarray(jls.slot_w),
                                   rtol=1e-6)
        np.testing.assert_allclose(N(ls.scales), np.asarray(jls.scales),
                                   rtol=1e-6)


@pytest.mark.parametrize("degrees, importance", [((1, 1), False),
                                                 ((2, 3), False),
                                                 ((2, 2), True)])
def test_aligned_schedule_samples_the_classic_edges(graphs, degrees,
                                                    importance):
    """The port's aligned layout relabels the classic schedule of the same
    generator: every output node has the same (neighbour, weight) slots,
    and its self row and slots name the same node ids."""
    ds, _, tg = graphs
    n = ds.num_data
    batch = T(np.r_[ds.train_d[:60], [n] * 4].astype(np.int32))
    imp = S.compute_importance(tg) if importance else None

    def sched(blocks):
        return S.schedule(torch.Generator().manual_seed(5), tg, batch,
                          degrees, cv=True, importance=imp, dedup=True,
                          round_multiple=4, owner_blocks=blocks)
    classic, aligned = sched(0), sched(4)
    for l, (lc, la) in enumerate(zip(classic.layers, aligned.layers)):
        fc_in, fa_in = N(classic.fields[l]), N(aligned.fields[l])
        fc_out, fa_out = N(classic.fields[l + 1]), N(aligned.fields[l + 1])
        assert sorted(fc_in) == sorted(fa_in)
        at = {v: i for i, v in enumerate(fc_out) if v < n}

        def slots(field_in, pos, w, row):
            live = w[row] != 0
            return sorted(zip(field_in[pos[row][live]], w[row][live]))
        for i, v in enumerate(fa_out):
            if v == n:
                assert N(la.self_pos)[i] == S.PARKED_POS
                assert (N(la.slot_w)[i] == 0).all()
                continue
            assert fa_in[N(la.self_pos)[i]] == v
            assert slots(fa_in, N(la.slot_pos), N(la.slot_w), i) == \
                slots(fc_in, N(lc.slot_pos), N(lc.slot_w), at[v])


def test_owner_batched_epoch_covers_every_train_id():
    cfg = parse_flags(_flags("owner_cv", 2))
    ds = Ld.load_data(cfg)
    ids = np.random.default_rng(0).permutation(ds.train_d).astype(np.int32)
    bm = PM.owner_grouped_batch_matrix(ids, cfg.batch_size, ds.num_data,
                                       cfg.dp)
    assert bm.shape == (-(-len(ids) // cfg.batch_size), cfg.batch_size)
    real = bm[bm < ds.num_data]
    assert sorted(real.tolist()) == sorted(ids.tolist())


def test_owner_batched_dp2_exact_matches_dp1(runs):
    """Exhaustive sampling, no dropout, the initial weights: the
    owner-aligned dp=2 step, the evaluation (over owner-grouped batches),
    the activation moments and the gradient-variance table (measured
    through the owner-grouped batch) equal dp=1's without owner
    batching."""
    _, got, want = runs
    for key in ("step0", "eval", "probes"):
        np.testing.assert_allclose(got[f"owner_exact:{key}"],
                                   want[f"owner_exact:{key}"], **TOL)


def test_owner_batched_dp2_cv_trains_in_the_dp1_band(runs):
    """CV+PP with dropout (whose masks fall on other rows under the
    aligned layout): it trains and evaluates in dp=1's micro-F1 band."""
    _, got, want = runs
    assert np.isfinite(got["owner_cv:losses"]).all()
    assert abs(got["owner_cv:eval"][2] - want["owner_cv:eval"][2]) <= 0.1


# ------------------------- node-sharded edge lists ------------------------

@pytest.fixture(scope="module")
def skewed():
    """A power-law-ish graph: a few hubs among sparse rows, raw weights."""
    rng = np.random.default_rng(3)
    n = 203
    rows = [rng.choice(n, size=int(d), replace=False)
            for d in np.minimum(rng.zipf(1.8, n), n // 2)]
    rows[5] = np.arange(n)                                # a hub
    indptr = np.r_[0, np.cumsum([len(r) for r in rows])]
    adj = sp.csr_matrix((rng.random(indptr[-1]).astype(np.float32),
                         np.concatenate(rows), indptr), shape=(n, n))
    return adj


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("edge_mult", [0.0, 1.0])
def test_flat_csr_parts_matches_jax(skewed, parts, edge_mult):
    """The partitioned tables equal JAX's, and their windows the whole
    table layout's (a budget below the hubs' degree truncates and warns
    in both packages)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want = JG.flat_csr(skewed, edge_mult, parts=parts)
        got = G.flat_csr(skewed, edge_mult, parts=parts)
        one = G.flat_csr(skewed, edge_mult)
    for name in ("bstart", "idx", "w", "deg", "renorm"):
        np.testing.assert_array_equal(N(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    assert (got.parts, got.max_degree, got.edge_cap_per_row) == \
        (want.parts, want.max_degree, want.edge_cap_per_row)
    assert got.idx.shape[0] % parts == 0
    n = skewed.shape[0]
    field = T(np.r_[np.arange(n), [n, n]].astype(np.int32))
    for width, start in ((3, 0), (one.max_degree, 0), (24, 8)):
        for a, b in zip(G.flat_row_windows(got, field, width, start),
                        G.flat_row_windows(one, field, width, start)):
            np.testing.assert_array_equal(N(a), N(b))


@pytest.mark.parametrize("pair", [("padded", "edgelist"),
                                  ("padded_is", "edgelist_is")])
def test_dp2_sharded_edgelist_matches_padded(runs, pair):
    """Two epochs, evaluation and predictions of the node-sharded edge list
    at dp=2 against the row-sharded padded graph at dp=2; each rank holds
    NB/2 block rows of the edge list's tables."""
    _, got, _ = runs
    padded, edgelist = pair
    for key in ("losses", "eval", "pred", "step0"):
        np.testing.assert_allclose(got[f"{edgelist}:{key}"],
                                   got[f"{padded}:{key}"], **EDGE_TOL)
    rows, parts = got[f"{edgelist}:tile"]
    assert parts == 2
    cfg = parse_flags(_flags(edgelist, 1))
    ds = Ld.load_data(cfg)
    adj = ds.train_adj if cfg.pad_degree == -1 else cap_adj_degree(
        ds.train_adj, cfg.pad_degree, cfg.seed)
    assert rows == G.flat_csr(adj, cfg.fadj_edge_mult,
                              parts=2).idx.shape[0] // 2


def test_sharded_edgelist_artifact_serves_like_the_whole_tables(tmp_path):
    """A dp=2 sharded edge-list run exports its artifact (the tables whole,
    in their ``parts=2`` layout); one process serves it, and serves the
    same artifact with the ``parts=1`` tables of the same graph: the
    answers are bitwise equal."""
    flags = _flags("edgelist", 2)
    art = tmp_path / "art"
    launch.spawn(checks.export_run, 2, (flags, str(art), 1), "cpu",
                 store_dir=str(tmp_path))
    with open(art / "manifest.json") as f:
        assert json.load(f)["graph_statics"]["parts"] == 2
    one = tmp_path / "one"
    shutil.copytree(art, one)
    cfg = parse_flags(_flags("edgelist", 1))
    g = Trainer(cfg, Ld.load_data(cfg), device="cpu").graph_full
    assert g.parts == 1
    with np.load(one / "state.npz") as z:
        arrays = {k: z[k] for k in z.files}
    before = arrays["graph/idx"].shape
    for name in ("bstart", "idx", "w", "deg", "renorm"):
        arrays[f"graph/{name}"] = N(getattr(g, name))
    assert arrays["graph/idx"].shape != before
    np.savez(one / "state.npz", **arrays)
    with open(one / "manifest.json") as f:
        manifest = json.load(f)
    manifest["graph_statics"]["parts"] = 1
    with open(one / "manifest.json", "w") as f:
        json.dump(manifest, f)
    ids = np.arange(0, 300, 7)
    got = serving.load_predictor(str(art), device="cpu").predict(ids)
    want = serving.load_predictor(str(one), device="cpu").predict(ids)
    np.testing.assert_array_equal(got, want)
