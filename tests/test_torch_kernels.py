"""The port's gather-aggregate kernels (stochastic_gcn_tpu_torch/ops/cuda_spmm.py).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX Pallas kernels (interpret mode) and their XLA references
on test_pallas.py's shapes.  The CUDA kernels themselves are compared with
the plain versions by tests/test_torch_cuda.py, which needs a card.

Tolerances: rtol = atol = 1e-5 in float32 (only the summation order
differs).  A bfloat16 table is compared with the float32 upcast of the
same bfloat16 values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stochastic_gcn_tpu.models import aggregators as JA
from stochastic_gcn_tpu.ops import pallas_spmm as PS
from stochastic_gcn_tpu_torch.ops import cuda_spmm as K

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(seed, rows, d, f, k, zero_frac=0.3):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    idx = rng.integers(0, rows, (f, k)).astype(np.int32)
    w = (rng.random((f, k)) * (rng.random((f, k)) >= zero_frac)
         ).astype(np.float32)
    return table, idx, w


def _bf16_pair(table):
    """The same bfloat16 values as a torch bf16 tensor and a float32 array."""
    t = torch.from_numpy(table).to(torch.bfloat16)
    return t, t.float().numpy()


# (rows, d, F, K): test_pallas.py's fanout, ragged-F, zero-weight and HBM
# shapes
SHAPES = [(100, 32, 24, 5), (50, 16, 13, 3), (40, 8, 8, 4), (300, 32, 16, 11)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fanout_plain_matches_pallas(shape):
    x, pos, w = _inputs(1, *shape)
    got = K.fanout_aggregate(torch.from_numpy(x), torch.from_numpy(pos),
                             torch.from_numpy(w)).numpy()
    pallas = PS.fanout_aggregate(jnp.asarray(x), jnp.asarray(pos),
                                 jnp.asarray(w), interpret=True)
    xla = PS.fanout_aggregate_xla(jnp.asarray(x), jnp.asarray(pos),
                                  jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hbm_gather_plain_matches_pallas(shape, dtype):
    table, idx, w = _inputs(2, *shape)
    if dtype == "bfloat16":
        t_table, table = _bf16_pair(table)
    else:
        t_table = torch.from_numpy(table)
    got = K.hbm_gather_aggregate(t_table, torch.from_numpy(idx),
                                 torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32
    pallas = PS.hbm_gather_aggregate(jnp.asarray(table), jnp.asarray(idx),
                                     jnp.asarray(w), interpret=True)
    xla = PS.hbm_gather_aggregate_xla(jnp.asarray(table), jnp.asarray(idx),
                                      jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)


def test_fanout_parked_positions_read_zero():
    """pos >= C (parked slots, up to scheduler.PARKED_POS) contributes
    nothing, like the JAX model's fanout_gather (row_gather sentinel C)."""
    x, pos, w = _inputs(3, 30, 8, 12, 6, zero_frac=0.0)
    pos[::2, 1] = 30
    pos[1::3, 4] = 1 << 30
    got = K.fanout_aggregate(torch.from_numpy(x), torch.from_numpy(pos),
                             torch.from_numpy(w)).numpy()
    want = JA.fanout_gather(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    keep = w * (pos < 30)
    dense = np.einsum("fk,fkd->fd", keep, x[np.minimum(pos, 29)])
    np.testing.assert_allclose(got, dense, **TOL)


@pytest.mark.parametrize("fn", [K.fanout_aggregate, K.hbm_gather_aggregate])
def test_masked_slots_are_never_read(fn):
    """A zero-weight slot may point at a garbage row (the history's
    sentinel row N takes garbage writes by design): it must not leak."""
    table, idx, w = _inputs(4, 20, 8, 6, 5)
    table[7] = np.nan
    w[idx == 7] = 0.0
    got = fn(torch.from_numpy(table), torch.from_numpy(idx),
             torch.from_numpy(w)).numpy()
    assert np.isfinite(got).all()
    clean = np.where(np.isnan(table), 0.0, table)
    np.testing.assert_allclose(got, np.einsum("fk,fkd->fd", w, clean[idx]),
                               **TOL)


@pytest.mark.parametrize("fn", [K.fanout_aggregate, K.hbm_gather_aggregate])
def test_non_cuda_device_raises(fn):
    """Only CPU tensors take the plain version; any other device must
    launch the kernel or raise, never fall back."""
    table, idx, w = (torch.from_numpy(a).to("meta")
                     for a in _inputs(5, 10, 8, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        fn(table, idx, w)


# ---- edge cases of the split kernels, on the plain versions ----

def _edge_inputs(seed, rows, d, f, k):
    """Dead slots (w == 0) point at the sentinel row ``rows - 1`` filled
    with NaN; row ``f // 2`` has no live slot at all."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    table[rows - 1] = np.nan
    w = rng.uniform(0.1, 1.0, (f, k)).astype(np.float32)
    if k > 1:
        w[rng.random((f, k)) < 0.3] = 0.0
    w[f // 2] = 0.0
    idx = rng.integers(0, rows - 1, (f, k)).astype(np.int32)
    idx[w == 0] = rows - 1
    return table, idx, w


# (rows, d, F, K): K = 1, F = 1, K below and not a multiple of any split
EDGE_SHAPES = [(60, 16, 12, 1), (60, 16, 1, 64), (60, 32, 9, 3),
               (60, 32, 37, 50)]


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("name", ["fanout_aggregate", "hbm_gather_aggregate"])
def test_plain_versions_on_edge_cases_match_jax(shape, name):
    table, idx, w = _edge_inputs(21, *shape)
    got = getattr(K, name)(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(w)).numpy()
    assert np.isfinite(got).all()
    assert not got[shape[2] // 2].any()          # the all-dead row
    # the JAX functions multiply a dead slot's row by its zero weight, so
    # they get the sentinel row zeroed instead of NaN
    clean = jnp.asarray(np.nan_to_num(table))
    pallas = getattr(PS, name)(clean, jnp.asarray(idx), jnp.asarray(w),
                               interpret=True)
    xla = getattr(PS, name + "_xla")(clean, jnp.asarray(idx), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_backward_plain_on_edge_cases_matches_jax_vjp(shape):
    import jax
    rows, d, f, k = shape
    x, pos, w = _edge_inputs(22, *shape)
    pos[0, 0] = 1 << 30                          # a parked position
    g = np.random.default_rng(23).normal(size=(f, d)).astype(np.float32)
    got = K.fanout_aggregate_backward(
        torch.from_numpy(g), torch.from_numpy(pos), torch.from_numpy(w),
        rows).numpy()
    _, vjp = jax.vjp(lambda x_: JA.fanout_gather(x_, jnp.asarray(pos),
                                                 jnp.asarray(w)),
                     jnp.asarray(np.nan_to_num(x)))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


# ---- the CV estimator's sampled term in one call ----

def _cv_inputs(seed, n, c, d, f, k):
    """x [c, d], hist [n + 8, d] with garbage in row n (the sentinel),
    field_in [c] with sentinel ids, pos/w [f, k] with repeated and parked
    positions and zero weights, base [f, d]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, d)).astype(np.float32)
    hist = rng.normal(size=(n + 8, d)).astype(np.float32)
    hist[n] = 1e3
    field_in = rng.integers(0, n, c).astype(np.int32)
    field_in[rng.random(c) < 0.2] = n
    pos = rng.integers(0, max(1, c // 2), (f, k)).astype(np.int32)  # repeats
    pos[rng.random((f, k)) < 0.15] = c + 3                          # parked
    w = rng.uniform(0.1, 1.0, (f, k)).astype(np.float32)
    w[rng.random((f, k)) < 0.2] = 0.0
    base = rng.normal(size=(f, d)).astype(np.float32)
    return x, hist, field_in, pos, w, base


def _jax_cv_expression(x, hist, field_in, n, pos, w, base):
    """The JAX model's plain CV branch (models/aggregators.py): the fanout
    of the history delta, plus the full term's output."""
    delta = x - JA.history_gather(jnp.asarray(hist), jnp.asarray(field_in),
                                  None, n)
    return JA.fanout_gather(delta, jnp.asarray(pos), jnp.asarray(w)) + base


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cv_fanout_plain_matches_jax_expression(dtype, k):
    n = 40
    x, hist, field_in, pos, w, base = _cv_inputs(31, n, 60, 16, 21, k)
    if dtype == "bfloat16":
        t_hist, hist = _bf16_pair(hist)
        j_hist = jnp.asarray(hist).astype(jnp.bfloat16)
    else:
        t_hist, j_hist = torch.from_numpy(hist), jnp.asarray(hist)
    args = [torch.from_numpy(a) for a in (field_in, pos, w, base)]
    got = K.cv_fanout_aggregate(torch.from_numpy(x), t_hist, args[0], n,
                                *args[1:])
    assert got.dtype == torch.float32 and got.grad_fn is None
    want = _jax_cv_expression(jnp.asarray(x), j_hist, field_in, n, pos, w,
                              jnp.asarray(base))
    assert want.dtype == jnp.float32     # JAX widens before it subtracts
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the sum written out slot by slot
    live = (w != 0) & (pos < 60)
    p = np.where(live, pos, 0)
    hbar = np.where((field_in < n)[:, None], hist[np.minimum(field_in, n)],
                    0.0)
    dense = base + np.einsum("fk,fkd->fd", np.where(live, w, 0.0),
                             (x - hbar)[p])
    np.testing.assert_allclose(got.numpy(), dense, **TOL)


def test_cv_fanout_never_reads_the_sentinel_row_or_a_dead_slot():
    n = 30
    x, hist, field_in, pos, w, base = _cv_inputs(32, n, 50, 8, 12, 4)
    hist[n:] = np.nan                    # at and past the sentinel
    x[7] = np.nan
    w[pos == 7] = 0.0                    # every slot at the NaN row is dead
    got = K.cv_fanout_aggregate(
        torch.from_numpy(x), torch.from_numpy(hist),
        torch.from_numpy(field_in), n, torch.from_numpy(pos),
        torch.from_numpy(w), torch.from_numpy(base)).numpy()
    assert np.isfinite(got).all()
    # all slots parked, and a field of sentinels only
    parked = np.full_like(pos, 1 << 30)
    got = K.cv_fanout_aggregate(
        torch.from_numpy(x), torch.from_numpy(hist),
        torch.from_numpy(field_in), n, torch.from_numpy(parked),
        torch.from_numpy(w), torch.from_numpy(base)).numpy()
    np.testing.assert_array_equal(got, base)
    x[7] = 0.0
    all_sentinel = np.full_like(field_in, n)
    got = K.cv_fanout_aggregate(
        torch.from_numpy(x), torch.from_numpy(hist),
        torch.from_numpy(all_sentinel), n, torch.from_numpy(pos),
        torch.from_numpy(w), torch.from_numpy(base))
    want = K.fanout_aggregate(torch.from_numpy(x), torch.from_numpy(pos),
                              torch.from_numpy(w)) + torch.from_numpy(base)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_cv_fanout_refuses_what_it_does_not_take():
    n = 30
    x, hist, field_in, pos, w, base = (
        torch.from_numpy(a) for a in _cv_inputs(33, n, 50, 8, 12, 4))
    for bad in (dict(hist=hist.clone().requires_grad_()),
                dict(base=base.clone().requires_grad_()),
                dict(w=w.clone().requires_grad_())):
        kw = dict(x=x, hist=hist, field_in=field_in, sentinel=n, pos=pos,
                  w=w, base=base)
        kw.update(bad)
        with pytest.raises(ValueError, match="require grad"):
            K.cv_fanout_aggregate(**kw)
        with pytest.raises(ValueError, match="require grad"):
            K.CVFanoutAggregate.apply(*kw.values())
    with pytest.raises(ValueError, match="one width"):
        K.cv_fanout_aggregate(x, hist[:, :4], field_in, n, pos, w, base)
    with pytest.raises(ValueError, match="field_in"):
        K.cv_fanout_aggregate(x, hist, field_in[:-1], n, pos, w, base)
    with pytest.raises(ValueError, match="field_in"):
        K.cv_fanout_aggregate(x, hist, field_in.long(), n, pos, w, base)
    with pytest.raises(ValueError, match="base"):
        K.cv_fanout_aggregate(x, hist, field_in, n, pos, w, base[:-1])
    with pytest.raises(TypeError, match="int32"):
        K.cv_fanout_aggregate(x, hist, field_in, n, pos.long(), w, base)
    meta = [t.to("meta") for t in (x, hist, field_in, pos, w, base)]
    with pytest.raises(ValueError, match="CUDA"):        # no plain fallback
        K.cv_fanout_aggregate(meta[0], meta[1], meta[2], n, *meta[3:])


def test_cv_fanout_without_grad_skips_the_autograd_function():
    n = 30
    x, hist, field_in, pos, w, base = (
        torch.from_numpy(a) for a in _cv_inputs(34, n, 50, 8, 12, 4))
    xg = x.clone().requires_grad_()
    assert K.cv_fanout_aggregate(x, hist, field_in, n, pos, w,
                                 base).grad_fn is None
    with torch.no_grad():
        out = K.cv_fanout_aggregate(xg, hist, field_in, n, pos, w, base)
    assert out.grad_fn is None
    out = K.cv_fanout_aggregate(xg, hist, field_in, n, pos, w, base)
    assert type(out.grad_fn).__name__.startswith("CVFanoutAggregate")


# ---- chip_smoke.py's yardsticks: the bound and the library call ----

@pytest.fixture(scope="module")
def smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("case", [
    # (kind, live slots, row bytes, F, K, d, rows out, MB counted by hand)
    ("gather", 0.7 * 512 * 64, 256, 512, 64, 128, 512, 6.40),
    ("gather", 0.7 * 2048 * 64, 512, 2048, 64, 128, 2048, 49.07),
    ("gather", 512, 512, 512, 1, 128, 512, 0.53),
    ("backward", 512, 512, 512, 1, 128, 1024, 0.79),
])
def test_kernel_bytes_on_hand_counted_inputs(smoke, case):
    *args, want_mb = case
    got = smoke.kernel_bytes(*args)
    assert abs(got / 1e6 - want_mb) <= 0.01 * want_mb
    ms, by = smoke.bound_ms(got, 2 * args[1] * args[5])
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * got / 3.35e12)


@pytest.mark.parametrize("case", [
    # (x rows, F, K, d, history rows, history row bytes, MB counted by hand)
    # training: 512 x rows of 512 B + 4 B of field_in, 480 bf16 history
    # rows of 256 B, 512 slots of 8 B, base and out of 512 x 512 B each
    (512, 512, 1, 128, 480, 256, 0.9155),
    # exhaustive evaluation: 51,200 live of 131,072 slots, 35,000 distinct
    # float32 history rows, base and out of 2048 x 512 B each
    (51200, 2048, 64, 128, 35000, 512, 47.485),
])
def test_kernel_bytes_of_the_cv_kind_on_hand_counted_inputs(smoke, case):
    x_rows, f, k, d, hist_rows, hist_row_bytes, want_mb = case
    got = smoke.kernel_bytes("cv", x_rows, 4 * d, f, k, d, f, hist_rows,
                             hist_row_bytes)
    assert got == (x_rows * (4 * d + 4) + hist_rows * hist_row_bytes
                   + f * k * 8 + 2 * f * d * 4)
    assert abs(got / 1e6 - want_mb) <= 1e-3 * want_mb
    assert smoke.bound_ms(got, 3 * x_rows * d)[1] == "bytes"


def test_kernel_bytes_exact_counts_and_the_operations_bound(smoke):
    # 3 live rows of 64 B, [2, 4] slots of 8 B, [2, 16] float32 out
    assert smoke.kernel_bytes("gather", 3, 64, 2, 4, 16, 2) == \
        3 * 64 + 2 * 4 * 8 + 2 * 16 * 4
    # g [2, 16] float32, the same slots, grad_x [5, 16] float32
    assert smoke.kernel_bytes("backward", 3, 64, 2, 4, 16, 5) == \
        2 * 16 * 4 + 2 * 4 * 8 + 5 * 16 * 4
    with pytest.raises(ValueError):
        smoke.kernel_bytes("scatter", 3, 64, 2, 4, 16, 2)
    assert smoke.bound_ms(3.35e9, 0.0) == (1.0, "bytes")
    assert smoke.bound_ms(3.35e9, 2 * 67e9) == (2.0, "operations")


@pytest.mark.parametrize("shape", [(300, 32, 16, 11), (60, 16, 12, 1)])
def test_library_yardstick_equals_plain_and_jax(smoke, shape):
    """``embedding_bag`` with a padding row, as chip_smoke.py times it,
    computes the full term: equal to the plain version and to the JAX
    kernel (interpret mode) and its XLA reference, dead slots included."""
    table, idx, w = _edge_inputs(24, *shape)
    idx[1, 0] = 1 << 30                          # out of range, w != 0
    t_table, t_idx, t_w = (torch.from_numpy(a) for a in (table, idx, w))
    plain = K.hbm_gather_aggregate_ref(t_table, t_idx, t_w)
    call, note = smoke._library_gather(t_table, [(t_idx, t_w)], [plain])
    assert note == "embedding_bag"
    got = call(0).numpy()
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=1e-5)
    live = (w != 0) & (idx < shape[0])
    j_idx, j_w = np.where(live, idx, 0), np.where(live, w, 0.0)
    clean = jnp.asarray(np.nan_to_num(table))
    pallas = PS.hbm_gather_aggregate(clean, jnp.asarray(j_idx),
                                     jnp.asarray(j_w), interpret=True)
    xla = PS.hbm_gather_aggregate_xla(clean, jnp.asarray(j_idx),
                                      jnp.asarray(j_w))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=0, atol=1e-5)


def test_library_backward_yardstick_equals_plain(smoke):
    rows, d, f, k = 60, 16, 12, 4
    _, pos, w = _edge_inputs(25, rows, d, f, k)
    pos[0, 1] = 1 << 30
    g = torch.from_numpy(np.random.default_rng(26).normal(
        size=(f, d)).astype(np.float32))
    sets = [(torch.from_numpy(pos), torch.from_numpy(w))]
    plain = K.fanout_aggregate_backward_ref(g, *sets[0], rows)
    call, note = smoke._library_backward(rows)(g, sets, [plain])
    assert "index_add_" in note
    np.testing.assert_allclose(call(0).numpy(), plain.numpy(), rtol=0,
                               atol=1e-5)


def test_fanout_without_grad_skips_the_autograd_function():
    """Nothing to record: the forward runs directly; weights that require
    grad still raise."""
    x, pos, w = (torch.from_numpy(a) for a in _inputs(27, 30, 8, 12, 6))
    assert K.fanout_aggregate(x, pos, w).grad_fn is None
    with torch.no_grad():
        out = K.fanout_aggregate(x.clone().requires_grad_(), pos, w)
    assert out.grad_fn is None
    assert K.fanout_aggregate(x.clone().requires_grad_(), pos,
                              w).grad_fn is not None
    with pytest.raises(ValueError, match="require grad"):
        K.fanout_aggregate(x, pos, w.clone().requires_grad_())
