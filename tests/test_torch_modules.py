"""Module-by-module parity of the PyTorch port against the JAX package.

The same numpy inputs (from ``np.random.default_rng``) go through the JAX
function and its port, on the CPU.  Deterministic functions get the exact
JAX inputs, including a JAX-produced ``BatchFields`` pack, and must agree
to float32 tolerance: rtol = atol = 1e-5 unless a test says otherwise.
The port's own sampler is held by statistics, since its torch.Generator
stream differs from JAX's threefry.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.data import loaders as JLd
from stochastic_gcn_tpu.data import preprocess as JP
from stochastic_gcn_tpu.models import aggregators as JA
from stochastic_gcn_tpu.models import gcn as JM
from stochastic_gcn_tpu.ops import layers as JL
from stochastic_gcn_tpu.parallel import halo as JH
from stochastic_gcn_tpu.sampler import scheduler as JS
from stochastic_gcn_tpu.training import loop as JLoop
from stochastic_gcn_tpu.training import step as JStep
from stochastic_gcn_tpu.utils import metrics as JMet

from stochastic_gcn_tpu_torch.config import from_fields
from stochastic_gcn_tpu_torch.data import graph as G
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.data import preprocess as P
from stochastic_gcn_tpu_torch.models import aggregators as A
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.ops import gather
from stochastic_gcn_tpu_torch.ops import layers as L
from stochastic_gcn_tpu_torch.sampler import scheduler as S
from stochastic_gcn_tpu_torch.training import checkpoint as C
from stochastic_gcn_tpu_torch.training import step as St
from stochastic_gcn_tpu_torch.utils import metrics as Met


def port_cfg(cfg):
    """The port's own ``Config`` with the fields of the JAX package's."""
    return from_fields(dataclasses.asdict(cfg))

TOL = dict(rtol=1e-5, atol=1e-5)
SLICE = dict(batch_size=32, degree=1, test_degree=1, cv=True, test_cv=True,
             hidden1=16, normalization="graphsage", layer_norm=True,
             num_fc_layers=2, weight_decay=0.0, dropout=0.2, pad_degree=64,
             seed=1, test_batch_size=24)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def small():
    """A graphsage synthetic dataset and its padded full graph in both
    packages (built from the same scipy matrix)."""
    ds = JLd.synthetic_dataset(num_nodes=120, feature_dim=12, num_classes=5,
                               avg_degree=6, normalization="graphsage",
                               seed=0)
    return ds, JG.pad_csr(ds.full_adj), G.pad_csr(ds.full_adj)


def test_port_imports_no_jax_or_sklearn():
    code = (
        "import sys\n"
        "import stochastic_gcn_tpu_torch\n"
        "from stochastic_gcn_tpu_torch.cli import infer, train\n"
        "from stochastic_gcn_tpu_torch.data import graph, loaders, preprocess\n"
        "from stochastic_gcn_tpu_torch.models import aggregators, gcn\n"
        "from stochastic_gcn_tpu_torch.ops import _build, cuda_spmm, gather, "
        "layers\n"
        "from stochastic_gcn_tpu_torch.sampler import scheduler\n"
        "from stochastic_gcn_tpu_torch.training import checkpoint, loop, step\n"
        "from stochastic_gcn_tpu_torch.utils import metrics\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sklearn')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_synthetic_dataset_and_pad_csr_match(small):
    ds, jg, tg = small
    tds = Ld.synthetic_dataset(num_nodes=120, feature_dim=12, num_classes=5,
                               avg_degree=6, normalization="graphsage",
                               seed=0)
    for a, b in ((ds.full_adj, tds.full_adj), (ds.train_adj, tds.train_adj)):
        assert (a != b).nnz == 0
    for name in ("feats", "test_feats", "labels", "train_d", "test_d"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(tds, name))
    for name in ("nbr", "w", "deg"):
        np.testing.assert_array_equal(N(getattr(tg, name)),
                                      np.asarray(getattr(jg, name)))


def test_pad_csr_tier_matches():
    """The tier split the port records is the JAX one (on a graph wide
    enough for tiering to pay)."""
    rng = np.random.default_rng(7)
    deg = np.full(400, 6)
    deg[:4] = 64                        # a few hubs: tiering pays
    rows = np.repeat(np.arange(400), deg)
    cols = rng.integers(0, 400, rows.size)
    adj = P.graphsage_normalize_adj(
        (P.sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                         shape=(400, 400)) > 0).astype(np.float32))
    jg, tg = JG.pad_csr(adj, tier=True), G.pad_csr(adj, tier=True)
    assert tg.tier_w > 0
    assert (tg.tier_w, tg.tier_frac) == (jg.tier_w, jg.tier_frac)


@pytest.mark.parametrize("rescale", [True, False])
def test_cap_adj_degree(rescale):
    """The JAX copy's draws exactly: the same kept entries, in the same
    order, with the same (rescaled) weights and dtype."""
    rng = np.random.default_rng(8)
    deg = rng.integers(1, 30, 200)
    rows = np.repeat(np.arange(200), deg)
    adj = P.sp.csr_matrix((rng.random(rows.size).astype(np.float32),
                           (rows, rng.integers(0, 500, rows.size))),
                          shape=(200, 500))
    cap = 10
    assert (np.diff(adj.indptr) > cap).sum() > 100
    got = P.cap_adj_degree(adj, cap, seed=1, rescale=rescale)
    want = JP.cap_adj_degree(adj, cap, seed=1, rescale=rescale)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)


def test_row_gather_sentinel():
    rng = np.random.default_rng(9)
    table = rng.normal(size=(11, 4)).astype(np.float32)
    ids = np.array([[0, 10, 11], [3, 1 << 30, 5]], np.int32)
    got = gather.row_gather(T(table), T(ids), sentinel=10)
    want = JH.row_gather(jnp.asarray(table), jnp.asarray(ids), sentinel=10)
    np.testing.assert_array_equal(N(got), np.asarray(want))


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_dense_layer(norm, relu):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(17, 9)).astype(np.float32)
    x[3] = 0.0                          # a sentinel row: zero variance
    p = {"weights": rng.normal(size=(9, 6)).astype(np.float32),
         "offset": rng.normal(size=(1, 6)).astype(np.float32),
         "scale": rng.normal(size=(1, 6)).astype(np.float32)}
    got = L.dense({k: T(v) for k, v in p.items()}, T(x),
                  L.relu if relu else L.identity, norm)
    want = JL.dense({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), JL.relu if relu else JL.identity, norm)
    np.testing.assert_allclose(N(got), np.asarray(want), **TOL)


def test_dropout_is_generator_driven():
    """Identity at keep_prob 1; otherwise inverted dropout whose mask comes
    from the given generator alone (same seed, same mask)."""
    x = torch.ones(200, 50)
    assert L.dropout(torch.Generator(), x, 1.0) is x
    a = L.dropout(torch.Generator().manual_seed(3), x, 0.8)
    b = L.dropout(torch.Generator().manual_seed(3), x, 0.8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.02
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.8))


def test_glorot_and_init_params(small):
    ds = small[0]
    cfg = Config(**SLICE)
    spec = M.build_model_spec(port_cfg(cfg), ds.feature_dim, ds.num_classes, True,
                              True, False)
    params = M.init_params(torch.Generator().manual_seed(0), spec)
    jparams = JM.init_params(jax.random.PRNGKey(0), JM.build_model_spec(
        cfg, ds.feature_dim, ds.num_classes, True, True, False))
    assert {k: {n: tuple(v.shape) for n, v in p.items()}
            for k, p in params.items()} == \
        {k: {n: v.shape for n, v in p.items()} for k, p in jparams.items()}
    w = N(params["dense0"]["weights"])
    limit = np.sqrt(6.0 / sum(w.shape))
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.9 * limit


@pytest.mark.parametrize("over", [
    {}, {"normalization": "gcn"}, {"cvd": True}, {"det_dropout": True},
    {"reverse": True}, {"num_layers": 3, "num_fc_layers": 1}])
@pytest.mark.parametrize("preprocess", [True, False])
def test_build_model_spec_matches(over, preprocess):
    cfg = Config(**{**SLICE, **over})
    got = M.build_model_spec(port_cfg(cfg), 12, 5, preprocess, True, cfg.cvd)
    want = JM.build_model_spec(cfg, 12, 5, preprocess, True, cfg.cvd)
    for f in ("reverse_input_dropout", "num_agg_layers", "agg0_dim",
              "input_dim", "output_dim", "cv", "cvd", "det_dropout",
              "normalization", "multitask", "history_dims",
              "n_history_per_layer", "layer_comp"):
        assert getattr(got, f) == getattr(want, f), f
    assert [(type(s).__name__, vars(s)) for s in got.specs] == \
        [(type(s).__name__, vars(s)) for s in want.specs]
    assert M.weight_decay_param_names(got) == \
        JM.weight_decay_param_names(want)
    assert M.first_param_layer(got) == JM.first_param_layer(want)


@pytest.mark.parametrize("case", [
    (32, (1,), 120, 8), (512, (1, 1), 233000, 64), (64, (3, 2), 50, 4),
    (100, (20, 20), 50, 30), (16, (64,), 100, 64)])
@pytest.mark.parametrize("dedup", [True, False])
def test_field_capacities_and_effective_dedup(case, dedup):
    b, degrees, n, dcap = case
    assert S.field_capacities(b, degrees, n, dcap, dedup=dedup,
                              round_multiple=8) == \
        JS.field_capacities(b, degrees, n, dcap, dedup=dedup,
                            round_multiple=8)
    assert S.effective_dedup(dedup, b, degrees, n, dcap) == \
        JS.effective_dedup(dedup, b, degrees, n, dcap)


def test_append_field():
    rng = np.random.default_rng(11)
    field = np.array([4, 9, 2, 20], np.int32)
    new = rng.integers(0, 21, (4, 3)).astype(np.int32)
    got = S.append_field(T(field), T(new), 20, 4 + 12 + 5)
    want = JS.append_field(jnp.asarray(field), jnp.asarray(new), 20,
                           4 + 12 + 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))


def test_expand_uniform_degree1_is_uniform(small):
    """The degree-1 fast path picks each valid slot of a row with equal
    probability (chi-square), never a padded slot, and rescales the weight
    by deg / min(deg, 1)."""
    _, _, g = small
    deg = N(g.deg)
    row = int(np.argmax(deg))
    d = int(deg[row])
    draws = 6000
    field = torch.full((draws,), row, dtype=torch.int32)
    nbr, w, aw, scales = S.expand_uniform(torch.Generator().manual_seed(0),
                                          g, field, 1, need_aw=True)
    slots = N(g.nbr[row])
    picked = N(nbr[:, 0])
    assert set(picked) <= set(slots[:d])
    counts = np.array([(picked == s).sum() for s in slots[:d]])
    assert counts.sum() == draws          # distinct neighbour ids per row
    assert scipy.stats.chisquare(counts).pvalue > 1e-3
    base = dict(zip(slots[:d], N(g.w[row])[:d]))
    np.testing.assert_allclose(N(w[:, 0]), [base[p] * d for p in picked],
                               rtol=1e-6)
    np.testing.assert_allclose(N(aw[:, 0]), [base[p] ** 2 * d
                                             for p in picked], rtol=1e-6)
    np.testing.assert_allclose(N(scales), 1.0 / np.sqrt(d), rtol=1e-6)


def test_expand_uniform_topk_and_empty_rows(small):
    """k > 1: distinct valid picks, each slot included with probability
    min(k, deg)/deg (chi-square), weights rescaled by deg/min(deg, k); a
    degree-0 (sentinel) row yields masked slots only."""
    _, _, g = small
    deg = N(g.deg)
    row = int(np.argmax(deg))
    d, k, draws = int(deg[row]), 3, 4000
    field = torch.tensor([row] * draws + [g.num_nodes], dtype=torch.int32)
    nbr, w, _, _ = S.expand_uniform(torch.Generator().manual_seed(1), g,
                                    field, k, need_aw=False)
    nbr, w = N(nbr), N(w)
    assert (w[-1] == 0).all() and (nbr[-1] == g.num_nodes).all()
    slots = N(g.nbr[row])[:d]
    for r in range(draws):
        assert len(set(nbr[r])) == k and set(nbr[r]) <= set(slots)
    counts = np.array([(nbr[:draws] == s).sum() for s in slots])
    assert scipy.stats.chisquare(counts).pvalue > 1e-3
    base = dict(zip(slots, N(g.w[row])[:d]))
    np.testing.assert_allclose(
        w[:draws], np.vectorize(base.get)(nbr[:draws]) * d / k, rtol=1e-6)


def _jax_pack(jg, batch, degrees, seed):
    return JS.schedule(jax.random.PRNGKey(seed), jg,
                       jnp.asarray(batch, jnp.int32), degrees, cv=True,
                       dedup=False)


def _to_torch_pack(jpack):
    """A JAX-produced BatchFields pack converted to the port's."""
    return S.BatchFields(
        fields=tuple(T(f) for f in jpack.fields),
        layers=tuple(S.LayerSample(
            slot_pos=T(ls.slot_pos), slot_w=T(ls.slot_w),
            slot_aw=None if ls.slot_aw is None else T(ls.slot_aw),
            scales=T(ls.scales)) for ls in jpack.layers))


def test_schedule_shapes_match_jax(small):
    _, jg, tg = small
    batch = np.r_[np.arange(20), [120] * 4].astype(np.int32)
    jpack = _jax_pack(jg, batch, (1, 1), 0)
    pack = S.schedule(torch.Generator().manual_seed(0), tg, T(batch), (1, 1),
                      cv=True, dedup=False)
    for f, jf in zip(pack.fields, jpack.fields):
        assert tuple(f.shape) == jf.shape and f.dtype == torch.int32
    for ls, jls in zip(pack.layers, jpack.layers):
        np.testing.assert_array_equal(N(ls.slot_pos),
                                      np.asarray(jls.slot_pos))
    np.testing.assert_array_equal(N(pack.fields[-1]), batch)
    # dedup is the default, as in the JAX scheduler: compacted capacities
    dedup = S.schedule(torch.Generator().manual_seed(0), tg, T(batch), (1, 1),
                       cv=True)
    want = JS.schedule(
        jax.random.PRNGKey(0), jg, jnp.asarray(batch, jnp.int32), (1, 1),
        cv=True)
    assert [tuple(f.shape) for f in dedup.fields] == \
        [f.shape for f in want.fields]
    # the owner-aligned layout: dedup capacities, and self_pos
    aligned = S.schedule(torch.Generator(), tg, T(batch), (1, 1), cv=True,
                         owner_blocks=2, round_multiple=2)
    want = JS.schedule(jax.random.PRNGKey(0), jg,
                       jnp.asarray(batch, jnp.int32), (1, 1), cv=True,
                       owner_blocks=2, round_multiple=2)
    assert [tuple(f.shape) for f in aligned.fields] == \
        [f.shape for f in want.fields]
    for ls, jls in zip(aligned.layers, want.layers):
        assert tuple(ls.self_pos.shape) == jls.self_pos.shape


def _history(rng, rows, d):
    h = rng.normal(size=(rows, d)).astype(np.float32)
    h[120] = 1e3                 # sentinel row N: garbage by design
    return h


def test_vr_aggregate_matches_jax(small):
    _, jg, tg = small
    rng = np.random.default_rng(12)
    batch = np.r_[rng.choice(120, 28, replace=False), [120] * 4]
    jpack = _jax_pack(jg, batch, (1,), 3)
    pack = _to_torch_pack(jpack)
    c_in = jpack.fields[0].shape[0]
    x = rng.normal(size=(c_in, 7)).astype(np.float32)
    hist = _history(rng, 128, 7)
    for norm in ("graphsage", "gcn"):
        got, (new_h,) = A.vr_aggregate(T(x), pack.layers[0], pack.fields[0],
                                       pack.fields[1], tg, (T(hist),),
                                       False, norm)
        want, (jnew,) = JA.vr_aggregate(
            jnp.asarray(x), jpack.layers[0], jpack.fields[0],
            jpack.fields[1], jg, (jnp.asarray(hist),), False, norm)
        np.testing.assert_allclose(N(got), np.asarray(want), **TOL)
        np.testing.assert_array_equal(N(new_h), np.asarray(jnew))
        got_p = A.plain_aggregate(T(x), pack.layers[0], norm)
        want_p = JA.plain_aggregate(jnp.asarray(x), jpack.layers[0], norm)
        np.testing.assert_allclose(N(got_p), np.asarray(want_p), **TOL)


def test_full_neighborhood_mean_matches_tiered_jax():
    """At F >= TIER_MIN_ROWS the JAX package contracts in two tiers; the
    port's full-width kernel gives the same (exact) value."""
    rng = np.random.default_rng(13)
    n = 300
    deg = np.full(n, 5)
    deg[:3] = 64
    rows = np.repeat(np.arange(n), deg)
    adj = P.graphsage_normalize_adj(
        (P.sp.csr_matrix((np.ones(rows.size, np.float32),
                          (rows, rng.integers(0, n, rows.size))),
                         shape=(n, n)) > 0).astype(np.float32))
    jg, tg = JG.pad_csr(adj, tier=True), G.pad_csr(adj, tier=True)
    field = rng.integers(0, n + 1, JA.TIER_MIN_ROWS).astype(np.int32)
    hist = rng.normal(size=(n + 4, 16)).astype(np.float32)
    hist[n] = 0.0
    assert jg.tier_w > 0
    want = JA.full_neighborhood_mean(jnp.asarray(hist), jg,
                                     jnp.asarray(field))
    got = A.full_neighborhood_mean(T(hist), tg, T(field))
    np.testing.assert_allclose(N(got), np.asarray(want), **TOL)


def test_forward_and_loss_match_jax(small):
    """The full eval forward on a JAX-produced pack, with the JAX params,
    histories and features."""
    ds, jg, tg = small
    cfg = Config(**SLICE)
    feats = np.hstack((ds.feats, ds.test_feats)).astype(np.float32)
    jspec = JM.build_model_spec(cfg, ds.feature_dim, ds.num_classes, True,
                                True, False)
    spec = M.build_model_spec(port_cfg(cfg), ds.feature_dim, ds.num_classes, True,
                              True, False)
    jparams = JM.init_params(jax.random.PRNGKey(4), jspec)
    params = C.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(14)
    hist = _history(rng, 128, cfg.hidden1)
    batch = np.r_[rng.choice(120, 20, replace=False), [120] * 4]
    jpack = _jax_pack(jg, batch, (1,), 5)
    pack = _to_torch_pack(jpack)
    jfeat = JG.dense_rows(feats, 120)
    tfeat = G.dense_rows(feats, 120)

    logits, (new_h,) = M.forward(params, spec, pack, tg, ((T(hist),),),
                                 tfeat, torch.Generator(), cfg.keep_prob,
                                 train=False)
    jlogits, (jnew,) = JM.forward(jparams, jspec, jpack, jg,
                                  ((jnp.asarray(hist),),), jfeat,
                                  jax.random.PRNGKey(0), cfg.keep_prob,
                                  train=False)
    np.testing.assert_allclose(N(logits), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(N(new_h[0]), np.asarray(jnew[0]), **TOL)

    labels = G.dense_rows(ds.labels, 120)
    y = St._labels_gather(labels, pack.fields[-1], 120)
    valid = (pack.fields[-1] < 120).float()
    jy = JStep._labels_gather(JG.dense_rows(ds.labels, 120),
                              jpack.fields[-1], num_nodes=120)
    loss, acc = M.loss_and_metrics(params, spec, logits, y, valid, 5e-4)
    jloss, jacc = JM.loss_and_metrics(jparams, jspec, jlogits, jy,
                                      jnp.asarray(N(valid)), 5e-4)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(acc), float(jacc), **TOL)
    np.testing.assert_allclose(N(M.predict(spec, logits)),
                               np.asarray(JM.predict(jspec, jlogits)), **TOL)


def test_scatter_histories_unique_ids():
    rng = np.random.default_rng(15)
    hist = rng.normal(size=(24, 5)).astype(np.float32)
    field0 = rng.choice(20, 12, replace=False).astype(np.int32)
    fields = (field0, field0[:4])
    rows = rng.normal(size=(12, 5)).astype(np.float32)
    th = (T(hist),)
    got, dropped = St.scatter_histories((th,), ((T(rows),),),
                                        tuple(T(f) for f in fields), 20)
    assert got[0][0] is th[0]                  # updated in place
    want, jdropped = JStep.scatter_histories(
        ((jnp.asarray(hist),),), ((jnp.asarray(rows),),),
        tuple(jnp.asarray(f) for f in fields), 20)
    np.testing.assert_array_equal(N(got[0][0]), np.asarray(want[0][0]))
    assert dropped.dtype == torch.int32 and int(dropped) == int(jdropped) == 0


@pytest.mark.parametrize("multitask", [False, True])
def test_device_f1_counts_match_jax(multitask):
    rng = np.random.default_rng(16)
    logits = rng.normal(size=(40, 6)).astype(np.float32)
    if multitask:
        labels = (rng.random((40, 6)) < 0.4).astype(np.float32)
    else:
        labels = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 40)]
    valid = (rng.random(40) < 0.8).astype(np.float32)
    got = Met.device_f1_counts(T(logits), T(labels), T(valid), multitask)
    want = JMet.device_f1_counts(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(valid), multitask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))
    assert Met.f1_from_counts(*map(N, got), multitask) == \
        JMet.f1_from_counts(*want, multitask)


def test_load_jax_checkpoint_widens_bf16(tmp_path):
    """A ``bf16leaf:`` history in a JAX-layout file loads into a float32
    history (a bfloat16 train history read by a float32 trainer)."""
    bits = np.array([[0x3F80, 0xC040], [0x0000, 0x7F80]], np.uint16)
    params = {"dense0": {"weights": torch.zeros(2, 3)}}
    state = St.TrainState(
        params=params, opt_state=St.make_optimizer(port_cfg(Config())).init(params),
        histories=((torch.zeros(2, 2),),),
        step=torch.zeros((), dtype=torch.int32))
    arrays = {"leaf:" + k: np.full(tuple(t.shape), 7, N(t).dtype)
              for k, t in C._state_leaves(state, ())}
    del arrays["leaf:['state'].histories[0][0]"]
    arrays["bf16leaf:['state'].histories[0][0]"] = bits
    arrays["extra:completed_epochs"] = np.int64(2)
    np.savez(C.checkpoint_path(str(tmp_path)), **arrays)
    C.load_checkpoint(str(tmp_path), state, ())
    assert state.histories[0][0].dtype == torch.float32
    np.testing.assert_array_equal(N(state.histories[0][0]),
                                  [[1.0, -3.0], [0.0, np.inf]])
    np.testing.assert_array_equal(N(state.params["dense0"]["weights"]),
                                  np.full((2, 3), 7.0))
    assert int(state.step) == 7
    assert int(C.load_loop_extras(str(tmp_path))["completed_epochs"]) == 2


def test_assemble_input_features_matches(small):
    from stochastic_gcn_tpu_torch.training import loop
    ds = small[0]
    for norm in ("graphsage", "gcn"):
        cfg = Config(**{**SLICE, "normalization": norm})
        got, _ = loop.assemble_input_features(port_cfg(cfg), ds.feats, ds.test_feats,
                                              True)
        want, _ = JLoop.assemble_input_features(cfg, ds.feats, ds.test_feats,
                                                True)
        np.testing.assert_array_equal(got, want)
