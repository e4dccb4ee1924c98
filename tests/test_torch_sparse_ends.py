"""The padded-sparse table's row ends, on the CPU, against the JAX package.

``pad_sparse_features`` gives each row of the table the end of its live
slots (1 + the position of its last slot whose column is below ``dim``);
``_slice_inputs`` carries them with the field's rows, and the gradient of
the sparse first layer in W reads no slot past them
(``fanout_aggregate_backward`` with ``ends``; its plain version on the
CPU).  Here the ends are held against a numpy recomputation, and the
layer's forward and gradient in W with the ends against the JAX layer
(``ops/layers.py::matmul``) and ``jax.vjp`` of it on the same inputs,
including tables whose live slots are not a prefix of the row and values
zeroed by dropout in mid-row.  Tolerance: rtol = atol = 1e-5 in float32
(sums in another order).  The CUDA kernels are held against these plain
versions by tests/test_torch_cuda.py on a card.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.models import gcn as JM
from stochastic_gcn_tpu.ops import layers as JL
from stochastic_gcn_tpu.ops import pallas_spmm as PS
from stochastic_gcn_tpu_torch.data import graph as G
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.ops import cuda_spmm as K
from stochastic_gcn_tpu_torch.ops import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _ends_by_loop(idx: np.ndarray, dim: int) -> np.ndarray:
    """The ends recomputed row by row: 1 + the last slot below ``dim``."""
    out = np.zeros(idx.shape[0], np.int32)
    for r, row in enumerate(idx):
        live = np.flatnonzero(row < dim)
        out[r] = live[-1] + 1 if len(live) else 0
    return out


def _csr_with_row_kinds(seed, dim=40, cap=6):
    """Rows full to the cap, above it (truncated to the cap), empty, and
    short, in one matrix; and the cap."""
    rng = np.random.default_rng(seed)
    nnz = [cap, 0, cap + 5, 2, 1, 0, cap - 1, 3]
    rows, cols = [], []
    for r, n in enumerate(nnz):
        rows += [r] * n
        cols += list(rng.choice(dim, n, replace=False))
    data = rng.normal(size=len(rows))
    x = sp.csr_matrix((data, (rows, cols)), shape=(len(nnz), dim))
    return x, cap


@pytest.mark.parametrize("num_nodes", [None, 11])
def test_pad_sparse_features_ends_match_numpy(num_nodes):
    """Full rows end at the cap, empty rows and the sentinel row N (and the
    rows past the matrix up to ``num_nodes``) at 0, short rows at their
    count; the table is the JAX package's."""
    x, cap = _csr_with_row_kinds(1)
    feats = G.pad_sparse_features(x, cap, num_nodes)
    jx = JG.pad_sparse_features(x, cap, num_nodes)
    np.testing.assert_array_equal(feats.idx.numpy(), np.asarray(jx.idx))
    ends = feats.ends.numpy()
    assert feats.ends.dtype == torch.int32
    assert ends.shape == (feats.idx.shape[0],)
    np.testing.assert_array_equal(ends, _ends_by_loop(np.asarray(jx.idx),
                                                      x.shape[1]))
    np.testing.assert_array_equal(ends[:8], [cap, 0, cap, 2, 1, 0, cap - 1,
                                             3])
    assert (ends[8:] == 0).all()                 # empty rows and row N


def test_live_ends_of_rows_whose_live_slots_are_not_a_prefix():
    """A hand-made table: live slots after dead ones and dead ones between
    live ones; the end is past the last live slot, whatever comes before."""
    dim = 9
    idx = np.array([[dim, 3, dim, 7, dim, dim],
                    [dim, dim, dim, dim, dim, 0],
                    [dim] * 6,
                    [1, 2, 3, 4, 5, 6],
                    [5, dim, dim, dim, dim, dim],
                    [dim, dim, 8, dim, dim, dim]], np.int32)
    ends = G.live_ends(idx, dim)
    np.testing.assert_array_equal(ends, [4, 6, 0, 6, 1, 3])
    np.testing.assert_array_equal(ends, _ends_by_loop(idx, dim))


def _non_prefix_table(seed, rows, dim, cap, drop=0.3):
    """A padded-sparse table whose live slots sit anywhere in the row (a
    shuffled ``pad_sparse_features`` table), with a share of the values
    zeroed in mid-row as dropout leaves them; its ends from the shuffled
    columns.  Returns the port's table and the JAX package's."""
    rng = np.random.default_rng(seed)
    x = sp.random(rows, dim, density=0.3, random_state=seed, format="csr",
                  dtype=np.float64)
    x.data = rng.normal(size=x.nnz)
    base = G.pad_sparse_features(x, cap)
    idx, val = base.idx.numpy().copy(), base.val.numpy().copy()
    for r in range(idx.shape[0] - 1):             # row N stays empty
        perm = rng.permutation(idx.shape[1])
        idx[r], val[r] = idx[r, perm], val[r, perm]
    val[(rng.random(val.shape) < drop) & (idx < dim)] = 0.0
    feats = G.PaddedSparseFeatures(idx=torch.from_numpy(idx),
                                   val=torch.from_numpy(val), dim=dim,
                                   ends=torch.from_numpy(G.live_ends(idx,
                                                                     dim)))
    jx = JG.PaddedSparseFeatures(idx=jnp.asarray(idx), val=jnp.asarray(val),
                                 dim=dim)
    return feats, jx


def _prefix_table(seed, rows, dim, cap, drop=0.3):
    """``pad_sparse_features``' own table (live slots first), values
    zeroed in mid-row by dropout's mask."""
    rng = np.random.default_rng(seed)
    x = sp.random(rows, dim, density=0.3, random_state=seed, format="csr",
                  dtype=np.float64)
    x.data = rng.normal(size=x.nnz)
    feats = G.pad_sparse_features(x, cap)
    val = feats.val.numpy().copy()
    val[rng.random(val.shape) < drop] = 0.0
    feats = feats.replace(val=torch.from_numpy(val))
    jx = JG.PaddedSparseFeatures(idx=jnp.asarray(feats.idx.numpy()),
                                 val=jnp.asarray(val), dim=dim)
    return feats, jx


TABLES = {"prefix": _prefix_table, "not a prefix": _non_prefix_table}


@pytest.mark.parametrize("kind", list(TABLES))
@pytest.mark.parametrize("rows, dim, cap, out", [(37, 50, 12, 8),
                                                 (64, 500, 40, 32),
                                                 (9, 7, 7, 3)])
def test_sparse_matmul_with_ends_matches_jax_and_its_vjp(kind, rows, dim,
                                                         cap, out):
    """``matmul`` of padded-sparse rows by W, and its gradient in W through
    the plain backward with the ends, against JAX's ``matmul`` and
    ``jax.vjp`` of it."""
    feats, jx = TABLES[kind](2, rows, dim, cap)
    assert feats.ends is not None
    rng = np.random.default_rng(3)
    w = rng.normal(size=(dim, out)).astype(np.float32)
    g = rng.normal(size=(rows + 1, out)).astype(np.float32)
    want, vjp = jax.vjp(lambda w_: JL.matmul(jx, w_), jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    got = L.matmul(feats, tw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


def test_sparse_matmul_hands_the_ends_to_the_backward(monkeypatch):
    """The layer's gradient is the backward called with the table's ends."""
    feats, _ = _prefix_table(4, 20, 30, 8)
    seen = []
    real = K.fanout_aggregate_backward

    def spy(g, pos, w, rows, ends=None):
        seen.append(ends)
        return real(g, pos, w, rows, ends)

    monkeypatch.setattr(K, "fanout_aggregate_backward", spy)
    tw = torch.randn(30, 4, requires_grad=True)
    L.matmul(feats, tw).sum().backward()
    assert len(seen) == 1 and torch.equal(seen[0], feats.ends)


@pytest.mark.parametrize("seed", [5, 6])
def test_backward_with_ends_skips_exactly_the_slots_past_them(seed):
    """The plain backward with ends equals the one without on weights
    zeroed at and past each row's end, whatever those slots hold; ends
    beyond K and below 0 clamp."""
    rng = np.random.default_rng(seed)
    f, k, rows, d = 23, 9, 15, 6
    g = torch.from_numpy(rng.normal(size=(f, d)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, rows, (f, k)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (f, k)).astype(np.float32))
    ends = torch.from_numpy(rng.integers(-2, k + 3, f).astype(np.int32))
    cut = torch.arange(k)[None, :] < ends[:, None]
    want = K.fanout_aggregate_backward_ref(g, pos, torch.where(cut, w, 0.0),
                                           rows)
    got = K.fanout_aggregate_backward(g, pos, w, rows, ends)
    torch.testing.assert_close(got, want, **TOL)
    # with every slot before its end, the ends change nothing
    full = torch.full((f,), k, dtype=torch.int32)
    torch.testing.assert_close(
        K.fanout_aggregate_backward(g, pos, w, rows, full),
        K.fanout_aggregate_backward_ref(g, pos, w, rows), **TOL)


def test_backward_refuses_ends_it_does_not_take():
    g, pos, w = torch.zeros(4, 3), torch.zeros((4, 2), dtype=torch.int32), \
        torch.zeros(4, 2)
    for bad in (torch.zeros(4, dtype=torch.int64),
                torch.zeros(5, dtype=torch.int32),
                torch.zeros((4, 1), dtype=torch.int32)):
        with pytest.raises(ValueError, match="ends"):
            K.fanout_aggregate_backward(g, pos, w, 6, bad)
        with pytest.raises(ValueError, match="ends"):
            K.fanout_aggregate(torch.zeros(6, 3), pos, w, bad)


def test_slice_inputs_carries_the_ends():
    """The field's rows keep their ends; sentinel ids read row N's, 0; the
    rows and values are JAX's."""
    x, cap = _csr_with_row_kinds(7)
    feats = G.pad_sparse_features(x, cap)
    jx = JG.pad_sparse_features(x, cap)
    n = x.shape[0]
    field = np.array([0, 2, n, 3, n + 4, 1, 7, n], np.int32)
    got = M._slice_inputs(feats, torch.from_numpy(field), n)
    jrows = JM._slice_inputs(jx, jnp.asarray(field), num_nodes=n)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(jrows.idx))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(jrows.val))
    ends = got.ends.numpy()
    np.testing.assert_array_equal(ends, _ends_by_loop(got.idx.numpy(),
                                                      x.shape[1]))
    assert (ends[field >= n] == 0).all()
    np.testing.assert_array_equal(ends[field < n],
                                  feats.ends.numpy()[field[field < n]])


def test_row_padding_and_sharding_keep_the_ends():
    """A table padded for a mesh gets empty rows ending at 0; a table
    without ends stays without."""
    x, cap = _csr_with_row_kinds(8)
    feats = G.pad_sparse_features(x, cap)
    padded = G.pad_features_rows(feats, 16)
    assert padded.ends.shape == (padded.idx.shape[0],) == (16,)
    np.testing.assert_array_equal(padded.ends.numpy()[:feats.ends.shape[0]],
                                  feats.ends.numpy())
    assert (padded.ends.numpy()[feats.ends.shape[0]:] == 0).all()
    np.testing.assert_array_equal(padded.ends.numpy(),
                                  G.live_ends(padded.idx.numpy(), feats.dim))
    bare = G.pad_features_rows(feats.replace(ends=None), 16)
    assert bare.ends is None


@pytest.mark.parametrize("d", [602, 1433])
@pytest.mark.parametrize("f, k", [(24, 40), (13, 1)])
def test_fanout_plain_at_raw_feature_widths_matches_jax(d, f, k):
    """The plain version of the gather that the column-split kernel is held
    to, at 602 and 1433 columns, against JAX's ``fanout_aggregate_xla``:
    dead slots carry zero weight, every position in range."""
    rng = np.random.default_rng(d + k)
    c = 300
    x = rng.normal(size=(c, d)).astype(np.float32)
    pos = rng.integers(0, c, (f, k)).astype(np.int32)
    w = (rng.uniform(0.1, 1.0, (f, k))
         * (rng.random((f, k)) >= 0.3)).astype(np.float32)
    got = K.fanout_aggregate(torch.from_numpy(x), torch.from_numpy(pos),
                             torch.from_numpy(w)).numpy()
    want = PS.fanout_aggregate_xla(jnp.asarray(x), jnp.asarray(pos),
                                   jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_kernel_bytes_of_the_backward_with_ends_on_hand_counted_inputs():
    """chip_smoke's bound for the backward given the ends: the ends, the
    slots before them, the g rows that own a live slot and grad_x written
    once; the slots past the ends are not counted."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    # F = 15,000 rows of K = 333, 59,040 slots before the ends, 342 g rows
    # of 32 floats, grad_x [500, 32]
    got = chip_smoke.kernel_bytes("backward ends", 342, 128, 15_000, 333,
                                  32, 500, ranged=59_040)
    assert got == 15_000 * 4 + 59_040 * 8 + 342 * 128 + 500 * 128
    every_slot = chip_smoke.kernel_bytes("backward", 342, 128, 15_000, 333,
                                         32, 500)
    assert got < every_slot / 40
    assert chip_smoke.bound_ms(got, 2 * 59_040 * 32)[1] == "bytes"


# ---- the forward with the ends ----

@pytest.mark.parametrize("kind", list(TABLES))
@pytest.mark.parametrize("rows, dim, cap, out", [(37, 50, 12, 8),
                                                 (64, 500, 40, 32)])
def test_plain_forward_with_the_true_ends_equals_it_without_and_jax(
        kind, rows, dim, cap, out):
    """The plain forward given a table's own ends is bitwise the one
    without them (only dead slots lie past them), and equals JAX's sparse
    ``matmul`` on the same numpy rows."""
    feats, jx = TABLES[kind](9, rows, dim, cap)
    w = np.random.default_rng(10).normal(size=(dim, out)).astype(np.float32)
    tw = torch.from_numpy(w)
    val = feats.val.float()
    with_ends = K.fanout_aggregate_ref(tw, feats.idx, val, feats.ends)
    assert torch.equal(with_ends,
                       K.fanout_aggregate_ref(tw, feats.idx, val))
    assert torch.equal(K.fanout_aggregate(tw, feats.idx, val, feats.ends),
                       with_ends)
    np.testing.assert_allclose(with_ends.numpy(),
                               np.asarray(JL.matmul(jx, jnp.asarray(w))),
                               **TOL)


@pytest.mark.parametrize("seed", [5, 6])
def test_forward_with_ends_skips_exactly_the_slots_past_them(seed):
    """The forward with ends equals the one without on weights zeroed at
    and past each row's end, whatever those slots hold; ends beyond K and
    below 0 clamp.  Tolerance: TOL (the same sums, float32)."""
    rng = np.random.default_rng(seed)
    f, k, rows, d = 23, 9, 15, 6
    x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, rows, (f, k)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (f, k)).astype(np.float32))
    ends = torch.from_numpy(rng.integers(-2, k + 3, f).astype(np.int32))
    cut = torch.arange(k)[None, :] < ends[:, None]
    want = K.fanout_aggregate_ref(x, pos, torch.where(cut, w, 0.0))
    torch.testing.assert_close(K.fanout_aggregate(x, pos, w, ends), want,
                               **TOL)
    assert (K.fanout_aggregate(x, pos, w, ends)[ends <= 0] == 0).all()
    # with every slot before its end, the ends change nothing
    full = torch.full((f,), k, dtype=torch.int32)
    torch.testing.assert_close(K.fanout_aggregate(x, pos, w, full),
                               K.fanout_aggregate_ref(x, pos, w), **TOL)


def test_sparse_matmul_hands_the_ends_to_the_forward(monkeypatch):
    """The layer's forward is the kernel's wrapper called with the table's
    ends, under no-grad (evaluation, ``predict``, the artifact) and with a
    gradient to record (``FanoutAggregate.forward``)."""
    feats, _ = _prefix_table(4, 20, 30, 8)
    seen = []
    real = K._fanout_forward

    def spy(x, pos, w, ends=None):
        seen.append(ends)
        return real(x, pos, w, ends)

    monkeypatch.setattr(K, "_fanout_forward", spy)
    tw = torch.randn(30, 4)
    with torch.no_grad():
        L.matmul(feats, tw)
    L.matmul(feats, tw.requires_grad_()).sum().backward()
    assert len(seen) == 2
    assert all(torch.equal(e, feats.ends) for e in seen)


def test_kernel_bytes_of_the_forward_with_ends_on_hand_counted_inputs():
    """chip_smoke's bound for the forward given the ends: the ends, the
    slots before them, the rows of W under a live slot once and the output
    written once; the slots past the ends are not counted.  At the real
    PubMed batches' counts that is ~2.5 MB, ~0.75 us at 3.35 TB/s."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    # F = 15,000 rows of K = 333, 59,040 slots before the ends, all 500
    # rows of W (128 bytes each) named, out [15000, 32] float32
    got = chip_smoke.kernel_bytes("gather ends", 500, 128, 15_000, 333, 32,
                                  15_000, ranged=59_040)
    assert got == 15_000 * 4 + 59_040 * 8 + 500 * 128 + 15_000 * 32 * 4
    every_slot = chip_smoke.kernel_bytes("gather", 500, 128, 15_000, 333,
                                         32, 15_000)
    assert every_slot == 500 * 128 + 15_000 * 333 * 8 + 15_000 * 32 * 4
    assert got < every_slot / 16
    ms, by = chip_smoke.bound_ms(got, 2 * 59_040 * 32)
    assert by == "bytes" and abs(ms - 7.5e-4) < 2e-5


def test_sharded_slices_carry_the_unsharded_ends_in_one_exchange(tmp_path):
    """Under ``--dp 2 --shard_graph`` (two gloo ranks) the sliced rows of a
    row-sharded padded-sparse table carry the ends of the unsharded slice
    (``parallel/checks.py::sparse_slices`` also holds the rows and values
    there); they ride in the rows' one exchange: the same all-to-all calls
    as without them, the last one's rows one column wider, 4 more wire
    bytes a row served to the other rank.  The calls are read from the
    profiler's record of the collectives: (values a row, rows) of each
    call's input."""
    from stochastic_gcn_tpu_torch.parallel import checks, launch
    out = str(tmp_path / "slices.npz")
    launch.spawn(checks.run_jobs, 2, ([("sparse_slices", (out,))],), "cpu",
                 store_dir=str(tmp_path))
    z = np.load(out)
    np.testing.assert_array_equal(z["ends"], z["want"])
    assert (z["want"] == 0).any() and (z["want"] > 0).any()
    with_e, without = z["calls_with"], z["calls_without"]
    assert with_e.shape == without.shape
    np.testing.assert_array_equal(with_e[:-1], without[:-1])
    assert with_e[-1, 0] == without[-1, 0] + 1       # one more column
    assert with_e[-1, 1] == without[-1, 1] >= z["served"] > 0
    assert z["wire_delta"] == 4 * z["served"]


def test_predictor_carries_the_trainers_ends(tmp_path, monkeypatch):
    """A Predictor loaded from the artifact of a Trainer on padded-sparse
    features computes the Trainer's row ends from the stored columns (the
    artifact holds no key for them), hands them to the sparse layer's
    kernel wrapper, and answers bitwise as ``Trainer.predict`` does."""
    import os
    from stochastic_gcn_tpu_torch import serving
    from stochastic_gcn_tpu_torch.config import Config
    from stochastic_gcn_tpu_torch.data import fixtures as F
    from stochastic_gcn_tpu_torch.data.loaders import load_data
    from stochastic_gcn_tpu_torch.training.loop import Trainer
    data = str(tmp_path / "data")
    F.write_planetoid_fixture(data, F.PlanetoidSpec(
        name="cora", num_extra=520, num_test=60, feature_dim=40,
        num_classes=4))
    cfg = Config(dataset="cora", data_dir=data, cv=True, test_cv=True,
                 degree=1, test_degree=1, batch_size=64, test_batch_size=50,
                 hidden1=16, seed=3, ckpt_dir=str(tmp_path))
    ds = load_data(cfg)
    tr = Trainer(cfg, ds, device="cpu")
    tr.train_epoch()
    path = serving.export_predictor(tr, str(tmp_path / "art"))
    ids = np.asarray(ds.test_d)
    live = tr.predict(ids)
    with np.load(os.path.join(path, "state.npz")) as z:
        assert not any("ends" in key for key in z.files)
    pred = serving.load_predictor(path, device="cpu")
    assert tr.test_features.ends is not None
    assert torch.equal(pred._features.ends, tr.test_features.ends)
    seen = []
    real = K._fanout_forward

    def spy(x, pos, w, ends=None):
        seen.append(ends)
        return real(x, pos, w, ends)

    monkeypatch.setattr(K, "_fanout_forward", spy)
    got = pred.predict(ids)
    np.testing.assert_array_equal(got, live)
    assert seen and all(e is not None for e in seen)
