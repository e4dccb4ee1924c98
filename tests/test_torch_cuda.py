"""The port's CUDA kernels on the card (skipped without one).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
tensors: rtol = atol = 1e-5 (float32 sums differ only in order, and the
fanout backward's atomics add in a different order on every run; a
bfloat16 table is compared with the plain version on its float32 upcast).
Train steps on the card are held against the same steps on the CPU at
atol 1e-4.
"""

import numpy as np
import pytest
import torch

from stochastic_gcn_tpu_torch.config import Config
from stochastic_gcn_tpu_torch.data.graph import live_ends
from stochastic_gcn_tpu_torch.data.loaders import synthetic_dataset
from stochastic_gcn_tpu_torch.ops import cuda_spmm as K
from stochastic_gcn_tpu_torch.sampler.scheduler import MinibatchIterator
from stochastic_gcn_tpu_torch.training import step as St
from stochastic_gcn_tpu_torch.training.loop import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, rows, d, f, k):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    idx = rng.integers(0, rows, (f, k)).astype(np.int32)
    w = (rng.random((f, k)) * (rng.random((f, k)) >= 0.3)).astype(np.float32)
    idx[w == 0] = rows + 5                    # out of range under w == 0
    return table, idx, w


# A row is d * itemsize / 16 sixteen-byte chunks; a lane takes up to 1, 2
# or 4 of them (the kernel's template argument kCpl).  The cases cover all
# six instantiations, and 96 chunks (3 per lane, run by the kCpl = 4 one).
CASES = [  # (rows, d, F, K, dtype)
    (4096, 128, 2048, 1, torch.float32),      # the serving fanout shape
    (1024, 128, 512, 1, torch.float32),       # the training fanout shape
    (5000, 128, 512, 64, torch.float32),      # full term, Dcap 64
    (5000, 128, 512, 64, torch.bfloat16),
    (300, 32, 13, 11, torch.float32),         # ragged F, narrow rows
    (300, 256, 24, 40, torch.bfloat16),       # 32 chunks: 1 per lane
    (300, 256, 24, 40, torch.float32),        # 64 chunks: 2 per lane
    (300, 512, 24, 40, torch.bfloat16),       # 64 chunks: 2 per lane
    (300, 384, 24, 40, torch.float32),        # 96 chunks: 3 per lane
    (300, 512, 24, 40, torch.float32),        # 128 chunks: 4 per lane
    (300, 1024, 24, 40, torch.bfloat16),      # 128 chunks: 4 per lane
    # rows that are not whole 16-byte chunks, or more than 128 of them: the
    # same functions by element
    (300, 602, 24, 40, torch.float32),        # raw features: 2408-byte rows
    (300, 602, 24, 40, torch.bfloat16),       # their bf16 history: 1204 bytes
    (300, 1, 24, 40, torch.float32),          # one column
    (300, 1, 13, 1, torch.bfloat16),
    (300, 3, 24, 40, torch.float32),
    (300, 513, 24, 40, torch.float32),        # one column past 128 chunks
    (300, 516, 24, 40, torch.float32),        # 129 chunks
    (300, 1433, 24, 40, torch.float32),       # Cora's width
    (300, 1433, 13, 11, torch.bfloat16),
    (300, 2048, 24, 40, torch.bfloat16),      # 256 chunks
    (5000, 602, 512, 64, torch.float32),      # the full term at Dcap 64
    (5000, 602, 512, 1, torch.float32),       # K = 1
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["fanout_aggregate", "hbm_gather_aggregate"])
def test_kernel_matches_plain_on_card(cuda, case, name):
    rows, d, f, k, dtype = case
    table, idx, w = _inputs(6, rows, d, f, k)
    table = torch.from_numpy(table).to(cuda, dtype)
    idx, w = torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda)
    before = K.LAUNCHES[name]
    got = getattr(K, name)(table, idx, w)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    want = getattr(K, name + "_ref")(table.float(), idx, w)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.requires_cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    table, idx, w = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(7, 50, 8, 6, 4))
    fn = K.hbm_gather_aggregate
    with pytest.raises(TypeError):
        fn(table, idx.long(), w)
    with pytest.raises(TypeError):
        fn(table.double(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        fn(table[:, ::2], idx, w)
    with pytest.raises(ValueError, match="no columns"):
        fn(table[:, :0].contiguous(), idx, w)
    with pytest.raises(ValueError, match="device"):
        fn(table, idx.cpu(), w)


@pytest.mark.requires_cuda
def test_rows_of_any_width_compute(cuda):
    """Rows that are not whole 16-byte chunks, rows above 128 chunks and a
    table whose first row is not 16-byte aligned used to be refused; they
    compute, and what they compute is the plain version's."""
    table, idx, w = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(7, 50, 8, 6, 4))
    for t in (table[:, :3].contiguous(),                  # 12-byte rows
              torch.randn(50, 516, device=cuda)):         # 129 chunks
        got = K.hbm_gather_aggregate(t, idx, w)
        torch.testing.assert_close(
            got, K.hbm_gather_aggregate_ref(t, idx, w), **TOL)
    # 32-byte rows that start 4 bytes into an allocation
    odd = torch.randn(50 * 8 + 1, device=cuda)[1:].view(50, 8)
    assert odd.data_ptr() % 16 == 4 and odd.is_contiguous()
    for fn, ref in ((K.hbm_gather_aggregate, K.hbm_gather_aggregate_ref),
                    (K.fanout_aggregate, K.fanout_aggregate_ref)):
        torch.testing.assert_close(fn(odd, idx, w), ref(odd, idx, w), **TOL)
    # rows by unit split like the rest: 602 float32 columns by 8-byte pairs
    assert K.gather_plan(torch.zeros(8, 602, device=cuda), 512, 64) == 4
    # where a float32 row plans one warp it is split by columns over warps
    # (wide_cols_kernel): 602 columns by pairs over 3 warps, 1433 by
    # element over 6, 4096 by 4-float units over 8 (two passes a warp,
    # through the measuring entry's one warp a row); and the CV delta off
    # 16-byte chunks the same way
    _, sidx, sw = (torch.from_numpy(a).to(cuda)
                   for a in _inputs(8, 50, 8, 2048, 64))
    for d in (602, 1433, 3):
        t = torch.randn(50, d, device=cuda)
        assert K.gather_plan(t, 2048, 64) == 0
        torch.testing.assert_close(K.fanout_aggregate(t, sidx, sw),
                                   K.fanout_aggregate_ref(t, sidx, sw), **TOL)
    t = torch.randn(50, 4096, device=cuda)
    torch.testing.assert_close(K.gather_aggregate_split(t, sidx, sw, 0),
                               K.fanout_aggregate_ref(t, sidx, sw), **TOL)
    for d, dtype in ((602, torch.float32), (602, torch.bfloat16),
                     (1433, torch.float32), (6, torch.bfloat16)):
        x = torch.randn(50, d, device=cuda)
        hist = torch.randn(40, d, device=cuda).to(dtype)
        field_in = torch.randint(0, 45, (50,), dtype=torch.int32,
                                 device=cuda)          # 30 on: the sentinel
        base = torch.randn(2048, d, device=cuda)
        torch.testing.assert_close(
            K.cv_fanout_aggregate(x, hist, field_in, 30, sidx, sw, base),
            K.cv_fanout_aggregate_ref(x, hist.float(), field_in, 30, sidx,
                                      sw, base), **TOL)
    # the measuring entry: every split at any width, and no other
    narrow = table[:, :3].contiguous()
    for split in (0, 1, 2, 4, 8):
        torch.testing.assert_close(
            K.gather_aggregate_split(narrow, idx, w, split),
            K.hbm_gather_aggregate_ref(narrow, idx, w), **TOL)
    with pytest.raises(RuntimeError, match="cudaError"):
        K.gather_aggregate_split(narrow, idx, w, 3)


@pytest.mark.requires_cuda
def test_serving_slice_on_card_matches_cpu(cuda):
    """The CV serving path on the card goes through both kernels and gives
    the CPU run's predictions (both equal exact inference after the
    refresh; the sampling streams differ)."""
    ds = synthetic_dataset(num_nodes=600, feature_dim=24, num_classes=6,
                           avg_degree=8, normalization="graphsage", seed=0)
    cfg = Config(dataset="synthetic", batch_size=64, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=32,
                 normalization="graphsage", layer_norm=True,
                 num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                 pad_degree=64, seed=1, test_batch_size=128)
    ids = np.asarray(ds.test_d)
    want = Trainer(cfg, ds, device="cpu").predict(ids)
    K.reset_launches()
    got = Trainer(cfg, ds, device=cuda).predict(ids)
    assert K.LAUNCHES["cv_fanout_aggregate"] > 0, K.LAUNCHES
    assert K.LAUNCHES["hbm_gather_aggregate"] > 0, K.LAUNCHES
    assert K.LAUNCHES["fanout_aggregate"] == 0, K.LAUNCHES
    assert K.LAUNCHES["fanout_aggregate_backward"] == 0, K.LAUNCHES
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.requires_cuda
def test_exact_evaluation_on_card_runs_the_standalone_fanout(cuda):
    """Without a control variate (the paper's Exact test: ``test_cv``
    off, exhaustive degree) evaluation goes through ``plain_aggregate``,
    so the standalone fanout kernel and no other; at the exhaustive degree
    it agrees with the CV evaluation of the same weights."""
    ds = synthetic_dataset(num_nodes=600, feature_dim=24, num_classes=6,
                           avg_degree=8, normalization="graphsage", seed=0)
    kw = dict(dataset="synthetic", batch_size=64, degree=1,
              test_degree=10000, cv=True, test_cv=True, hidden1=32,
              normalization="graphsage", layer_norm=True, num_fc_layers=2,
              weight_decay=0.0, dropout=0.2, pad_degree=64, seed=1,
              test_batch_size=16)
    cv = Trainer(Config(**kw), ds, device=cuda)
    cv.train_epoch()
    exact = Trainer(Config(**{**kw, "test_cv": False}), ds, device=cuda)
    exact.state = cv.state
    want = cv.evaluate(ds.val_d)
    K.reset_launches()
    got = exact.evaluate(ds.val_d)
    assert K.LAUNCHES["fanout_aggregate"] > 0, K.LAUNCHES
    assert sum(K.LAUNCHES.values()) == K.LAUNCHES["fanout_aggregate"]
    assert abs(got[0] - want[0]) <= 1e-4 and abs(got[2] - want[2]) <= 0.02


def _backward_inputs(seed, c, f, k, d):
    """g [f, d], pos/w [f, k]: at k = 1 the no-dedup iota ``f + j``; wider
    slots repeat positions (atomic contention), park some at ``>= c`` and
    zero some weights."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(f, d)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (f, k)).astype(np.float32)
    if k == 1:
        pos = (c - f + np.arange(f, dtype=np.int32))[:, None].copy()
    else:
        pos = rng.integers(0, max(1, c // 4), (f, k)).astype(np.int32)
        pos[rng.random((f, k)) < 0.1] = 1 << 30
        w[rng.random((f, k)) < 0.2] = 0.0
    return g, pos, w


BACKWARD_CASES = [  # (C, F, K, d)
    (1024, 512, 1, 128),      # the training shape
    (1024, 512, 8, 128),      # repeats, parked, zero weights
    # a g row's slots dealt over 2-8 warps: K not a multiple of the split,
    # F = 1, rows by unit
    (5000, 37, 50, 128),
    (5000, 1, 64, 128),
    (5000, 512, 64, 128),
    (5000, 9, 50, 602),
    (300, 13, 8, 128),        # ragged F
    (300, 24, 8, 32),         # narrow rows
    (300, 24, 8, 256),        # 2 float4 chunks per lane
    (300, 24, 8, 384),        # 3 -> the 4-per-lane instantiation
    (300, 24, 8, 512),        # 4 per lane
    # any other width scatters by element
    (300, 24, 8, 602),
    (300, 24, 8, 1),
    (300, 13, 8, 3),
    (300, 24, 8, 513),
    (300, 24, 8, 1433),
    (1024, 512, 1, 602),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_fanout_backward_kernel_matches_plain_on_card(cuda, case):
    c, f, k, d = case
    g, pos, w = (torch.from_numpy(a).to(cuda)
                 for a in _backward_inputs(8, c, f, k, d))
    before = K.LAUNCHES["fanout_aggregate_backward"]
    got = K.fanout_aggregate_backward(g, pos, w, c)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fanout_aggregate_backward"] == before + 1
    want = K.fanout_aggregate_backward_ref(g, pos, w, c)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("g_rows, rows", [(23, 300), (25, 300), (1, 300),
                                          (24, -1)])
def test_fanout_backward_on_card_refuses_mismatched_shapes(cuda, g_rows,
                                                           rows):
    """One gradient row per row of ``pos`` and rows >= 0, or it raises
    before the kernel could read past the end of ``g``."""
    g, pos, w = (torch.from_numpy(a).to(cuda)
                 for a in _backward_inputs(12, 300, 24, 8, 32))
    before = K.LAUNCHES["fanout_aggregate_backward"]
    with pytest.raises(ValueError, match="one row per row|rows must be"):
        K.fanout_aggregate_backward(g[:1].expand(g_rows, 32).contiguous(),
                                    pos, w, rows)
    assert K.LAUNCHES["fanout_aggregate_backward"] == before


@pytest.mark.requires_cuda
def test_fanout_aggregate_gradient_on_card(cuda):
    """The gradient through FanoutAggregate (both kernels) equals autograd
    through the plain forward, on the card."""
    g, pos, w = (torch.from_numpy(a).to(cuda)
                 for a in _backward_inputs(9, 1024, 512, 8, 128))
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(1024, 128)).astype(np.float32)).to(cuda)
    xk = x.clone().requires_grad_()
    before = dict(K.LAUNCHES)
    K.fanout_aggregate(xk, pos, w).backward(g)
    assert K.LAUNCHES["fanout_aggregate"] == before["fanout_aggregate"] + 1
    assert K.LAUNCHES["fanout_aggregate_backward"] == \
        before["fanout_aggregate_backward"] + 1
    xr = x.clone().requires_grad_()
    K.fanout_aggregate_ref(xr, pos, w).backward(g)
    torch.testing.assert_close(xk.grad, xr.grad, **TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [602, 1, 513])
def test_gradients_on_card_at_any_width(cuda, d):
    """The gradient through FanoutAggregate and CVFanoutAggregate at widths
    that go by element, on compacted slots (repeated and parked
    positions), equals autograd through the plain versions."""
    n, c, f, k = 3000, 1024, 512, 8
    x, hist, field_in, pos, w, base = (
        t.to(cuda) for t in _cv_inputs(26, n, c, d, f, k, torch.bfloat16))
    x = torch.nan_to_num(x)
    g = torch.from_numpy(np.random.default_rng(27).normal(
        size=(f, d)).astype(np.float32)).to(cuda)
    for kernel, ref in (
            (lambda t: K.fanout_aggregate(t, pos, w),
             lambda t: K.fanout_aggregate_ref(t, pos, w)),
            (lambda t: K.cv_fanout_aggregate(t, hist, field_in, n, pos, w,
                                             base),
             lambda t: K.cv_fanout_aggregate_ref(t, hist, field_in, n, pos,
                                                 w, base))):
        xk, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
        before = K.LAUNCHES["fanout_aggregate_backward"]
        out, want = kernel(xk), ref(xr)
        torch.testing.assert_close(out, want, **TOL)
        out.backward(g)
        want.backward(g)
        assert K.LAUNCHES["fanout_aggregate_backward"] == before + 1
        torch.testing.assert_close(xk.grad, xr.grad, **TOL)


@pytest.mark.requires_cuda
def test_full_term_on_card_refuses_a_table_that_requires_grad(cuda):
    table, idx, w = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(11, 50, 8, 6, 4))
    with pytest.raises(ValueError, match="no backward"):
        K.hbm_gather_aggregate(table.requires_grad_(), idx, w)


@pytest.mark.requires_cuda
def test_train_steps_on_card_match_cpu(cuda):
    """20 train steps at exhaustive degree with dropout off (deterministic
    sampling) on the card and on the CPU from the same initial weights;
    every step launches the CV path's three kernels once each and the
    standalone fanout not at all."""
    ds = synthetic_dataset(num_nodes=240, feature_dim=16, num_classes=5,
                           normalization="graphsage", seed=0)
    cfg = Config(dataset="synthetic", batch_size=16, degree=10000,
                 test_degree=10000, cv=True, test_cv=True, hidden1=16,
                 normalization="graphsage", layer_norm=True,
                 num_fc_layers=2, weight_decay=5e-4, dropout=0.0,
                 pad_degree=-1, seed=1, test_batch_size=24)
    it = MinibatchIterator(ds.train_d, 3)
    rows = []
    while len(rows) < 20:
        it.shuffle()
        rows += list(Trainer._batch_matrix(it.data, cfg.batch_size,
                                           ds.num_data))
    bm = np.stack(rows[:20])
    out = {}
    for dev in ("cpu", cuda):
        tr = Trainer(cfg, ds, device=dev)
        K.reset_launches()
        tr.state, m = tr._train_epoch(
            tr.state, tr.graph_train, tr.train_features, tr.labels,
            torch.from_numpy(bm).to(dev), tr.gen)
        out[str(dev)] = (tr, float(m["loss"]), dict(K.LAUNCHES))
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert gpu[2] == {"cv_fanout_aggregate": 20, "fanout_aggregate": 0,
                      "fanout_aggregate_backward": 20,
                      "hbm_gather_aggregate": 20}
    assert abs(gpu[1] - cpu[1]) <= 1e-4
    for l, k in St.param_keys(cpu[0].params):
        torch.testing.assert_close(gpu[0].params[l][k].cpu(),
                                   cpu[0].params[l][k], rtol=0, atol=1e-4)


# launches per train step, and what is compared with the CPU run
ESTIMATOR_STEPS = {
    "cvd": (dict(cv=True, cvd=True, test_cv=True, test_cvd=True),
            {"cv_fanout_aggregate": 1, "hbm_gather_aggregate": 1,
             "fanout_aggregate": 1, "fanout_aggregate_backward": 1}),
    # no preprocessing: the first layer aggregates 30-wide rows, which the
    # kernels take by element; two layers, dedup forced by the batch size
    "exact": (dict(cv=False, test_cv=False, preprocess=False,
                   test_preprocess=False, batch_size=64),
              {"cv_fanout_aggregate": 0, "hbm_gather_aggregate": 0,
               "fanout_aggregate": 2, "fanout_aggregate_backward": 1}),
    "cv_nopp": (dict(cv=True, test_cv=True, preprocess=False,
                     test_preprocess=False, field_dedup=True),
                {"cv_fanout_aggregate": 2, "hbm_gather_aggregate": 2,
                 "fanout_aggregate": 0, "fanout_aggregate_backward": 1}),
    "det_dropout": (dict(cv=True, test_cv=True, det_dropout=True),
                    {"cv_fanout_aggregate": 1, "hbm_gather_aggregate": 2,
                     "fanout_aggregate": 2, "fanout_aggregate_backward": 3}),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(ESTIMATOR_STEPS))
def test_estimator_train_steps_on_card_match_cpu(cuda, name):
    """10 train steps of each estimator at exhaustive degree with dropout
    off (deterministic) on the card and on the CPU from the same weights,
    at a feature width of 30 (not a multiple of 4): the launches per step
    are the estimator's, and the weights agree (det-dropout, whose moments
    at keep_prob 1 divide by a zero variance's floor, is held to a finite
    loss only)."""
    over, per_step = ESTIMATOR_STEPS[name]
    ds = synthetic_dataset(num_nodes=240, feature_dim=30, num_classes=5,
                           normalization="graphsage", seed=0)
    cfg = Config(**{**dict(dataset="synthetic", batch_size=16, degree=10000,
                           test_degree=10000, hidden1=16,
                           normalization="graphsage", layer_norm=True,
                           num_fc_layers=2, weight_decay=5e-4, dropout=0.0,
                           pad_degree=-1, seed=1, test_batch_size=24),
                    **over})
    it = MinibatchIterator(ds.train_d, 3)
    it.shuffle()
    bm = Trainer._batch_matrix(it.data, cfg.batch_size, ds.num_data)[:10]
    out = {}
    for dev in ("cpu", cuda):
        tr = Trainer(cfg, ds, device=dev)
        K.reset_launches()
        tr.state, m = tr._train_epoch(
            tr.state, tr.graph_train, tr.train_features, tr.labels,
            torch.from_numpy(bm).to(dev), tr.gen)
        out[str(dev)] = (tr, float(m["loss"]), dict(K.LAUNCHES))
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert gpu[2] == {k: v * len(bm) for k, v in per_step.items()}
    assert np.isfinite(gpu[1])
    if name != "det_dropout":
        assert abs(gpu[1] - cpu[1]) <= 1e-4
        for l, k in St.param_keys(cpu[0].params):
            torch.testing.assert_close(gpu[0].params[l][k].cpu(),
                                       cpu[0].params[l][k], rtol=0,
                                       atol=1e-4)
        got = gpu[0].evaluate(ds.val_d)
        want = cpu[0].evaluate(ds.val_d)
        assert abs(got[0] - want[0]) <= 1e-4


@pytest.mark.requires_cuda
def test_dedup_schedule_on_card_keeps_its_invariants(cuda):
    """compact_field and the dedup schedule on the card: int32 contiguous
    slots, the prefix invariant, each real id once, a live slot's position
    holding a neighbour of its row, dead slots parked."""
    from stochastic_gcn_tpu_torch.data.graph import pad_csr
    from stochastic_gcn_tpu_torch.sampler import scheduler as S
    ds = synthetic_dataset(num_nodes=600, feature_dim=8, num_classes=4,
                           avg_degree=8, normalization="graphsage", seed=0)
    g = pad_csr(ds.full_adj, -1, device=cuda)
    n = ds.num_data
    batch = torch.from_numpy(np.r_[ds.train_d[:60], [n] * 4].astype(
        np.int32)).to(cuda)
    pack = S.schedule(torch.Generator(device=cuda).manual_seed(1), g, batch,
                      (3, 2), cv=True, need_aw=True)
    assert [f.shape[0] for f in pack.fields] == S.field_capacities(
        64, (3, 2), n, g.pad_degree)
    nbr = g.nbr.cpu().numpy()
    for l, ls in enumerate(pack.layers):
        assert ls.slot_pos.dtype == torch.int32 and ls.slot_pos.is_contiguous()
        f_in = pack.fields[l].cpu().numpy()
        f_out = pack.fields[l + 1].cpu().numpy()
        np.testing.assert_array_equal(f_in[:len(f_out)], f_out)
        real = f_in[f_in < n]
        assert len(set(real)) == len(real)
        pos, w = ls.slot_pos.cpu().numpy(), ls.slot_w.cpu().numpy()
        assert (pos[w == 0] == S.PARKED_POS).all()
        rows, cols = np.nonzero(w)
        for r, c in zip(rows, cols):
            assert f_in[pos[r, c]] in nbr[f_out[r]]


# ---- the split kernel: every split on the shapes the split must get
# right ----

def _edge_inputs(seed, rows, d, f, k):
    """Dead slots (w == 0) point at a NaN sentinel row, one slot is out of
    range under a live weight, and row ``f // 2`` has no live slot."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    table[rows - 1] = np.nan
    w = rng.uniform(0.1, 1.0, (f, k)).astype(np.float32)
    if k > 1:
        w[rng.random((f, k)) < 0.3] = 0.0
    w[f // 2] = 0.0
    idx = rng.integers(0, rows - 1, (f, k)).astype(np.int32)
    idx[w == 0] = rows - 1
    idx[0, 0] = 1 << 30
    return table, idx, w


EDGE_SHAPES = [  # (F, K)
    (37, 50),             # K not a multiple of the split
    (9, 3),               # K below the warps per row
    (512, 1),             # K = 1 through the full-term entry
    (1, 64),              # F = 1
    (132 * 8 + 1, 64),    # one row more than 132 blocks of 8 rows
]
EDGE_ROWS = [(64, torch.bfloat16), (64, torch.float32),    # 128, 256 B
             (128, torch.bfloat16), (128, torch.float32),  # 256, 512 B
             # wide_tma_kernel: 1024- and 2048-byte rows; wide_split_kernel
             # by 8-byte (602 f32), 4-byte (602 and 301 bf16) and 2-byte
             # units (37 bf16); 13 f32 by element, one warp per row
             (256, torch.float32), (512, torch.bfloat16), (512, torch.float32),
             (602, torch.float32), (602, torch.bfloat16), (301, torch.bfloat16),
             (13, torch.float32), (37, torch.bfloat16)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("row", EDGE_ROWS, ids=lambda r: f"{r[0]}-{r[1]}")
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_every_gather_split_on_edge_cases(cuda, shape, row):
    (f, k), (d, dtype) = shape, row
    table, idx, w = _edge_inputs(13, 5001, d, f, k)
    table = torch.from_numpy(table).to(cuda, dtype)
    idx, w = torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda)
    want = K.hbm_gather_aggregate_ref(table.float(), idx, w)
    before = dict(K.LAUNCHES)
    outs = {"public": K.hbm_gather_aggregate(table, idx, w),
            "fanout": K.fanout_aggregate(table, idx, w),
            "row": K.gather_aggregate_split(table, idx, w, 0)}
    assert K.LAUNCHES["hbm_gather_aggregate"] == \
        before["hbm_gather_aggregate"] + 1
    for split in (1, 2, 4, 8):
        outs[f"split x{split}"] = K.gather_aggregate_split(table, idx, w,
                                                           split)
    torch.cuda.synchronize()
    # the named splits are for measurement and do not count
    assert K.LAUNCHES["hbm_gather_aggregate"] == \
        before["hbm_gather_aggregate"] + 1
    for name, got in outs.items():
        torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{name}: {m}")
        assert not got[f // 2].any(), name           # the all-dead row


@pytest.mark.requires_cuda
def test_split_entry_refuses_what_it_does_not_take(cuda):
    table, idx, w = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(14, 50, 256, 6, 4))     # 1024 B rows
    want = K.hbm_gather_aggregate_ref(table, idx, w)
    for split in (0, 2):                                      # rows > 512 B
        torch.testing.assert_close(
            K.gather_aggregate_split(table, idx, w, split), want, **TOL)
    for t in (table, table[:, :64].contiguous(), table[:, :3].contiguous()):
        for split in (3, -1, 16):
            with pytest.raises(RuntimeError, match="cudaError"):
                K.gather_aggregate_split(t, idx, w, split)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 256, 602, 13])
def test_full_term_is_bitwise_reproducible(cuda, dtype, d):
    """No atomics and a fixed split: the sum order, and so every bit of
    the result, is the same from run to run, in every gather kernel."""
    table, idx, w = _inputs(15, 20000, d, 512, 64)
    table = torch.from_numpy(table).to(cuda, dtype)
    idx, w = torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda)
    # a split kernel runs; 13 columns (fewer units than a warp's lanes)
    # one warp per row
    assert (K.gather_plan(table, 512, 64) > 1) == (d != 13)
    first = K.hbm_gather_aggregate(table, idx, w)
    for _ in range(5):
        assert torch.equal(K.hbm_gather_aggregate(table, idx, w), first)
    # one warp a row's plan at F = 2048 (a float32 row: split by columns
    # over warps), and the CV delta over this width
    big = torch.from_numpy(np.concatenate([idx.cpu().numpy()] * 4)).to(cuda)
    bw = torch.cat([w] * 4)
    first = K.fanout_aggregate(table, big, bw)
    x = table.float()[:5000].contiguous()
    field_in = torch.arange(5000, dtype=torch.int32, device=cuda) % 19000
    base = torch.ones((2048, d), device=cuda)
    cv = K.cv_fanout_aggregate(x, table, field_in, 19000, big % 5000, bw,
                               base)
    for _ in range(3):
        assert torch.equal(K.fanout_aggregate(table, big, bw), first)
        assert torch.equal(K.cv_fanout_aggregate(x, table, field_in, 19000,
                                                 big % 5000, bw, base), cv)


@pytest.mark.requires_cuda
def test_plan_is_a_fixed_function_of_the_shape(cuda):
    def table(d, dtype=torch.float32):
        return torch.zeros(8, d, device=cuda, dtype=dtype)

    bf16 = table(128, torch.bfloat16)
    f32 = table(128)
    wide = table(256)
    # the main path's shapes keep their plans
    assert K.gather_plan(bf16, 512, 64) == 4      # the training shape
    assert K.gather_plan(f32, 2048, 64) == 2      # the serving shape
    assert K.gather_plan(f32, 512, 1) == 0        # K = 1: one warp per row
    assert K.gather_plan(f32, 2048, 1) == 0
    assert K.backward_plan(512, 1) == 1           # one warp per g row
    assert K.backward_plan(2048, 1) == 1
    # rows above 512 bytes split where the row's slots allow it
    # (wide_tma_kernel: two rounds of its 3-row ring a warp)
    assert K.gather_plan(wide, 512, 64) == 8
    assert K.gather_plan(table(512, torch.bfloat16), 512, 64) == 8
    assert K.gather_plan(table(512, torch.bfloat16), 512, 41) == 4  # PPI
    assert K.gather_plan(table(512), 512, 41) == 4
    assert K.gather_plan(table(512), 2048, 64) == 2
    assert K.gather_plan(wide, 512, 1) == 0       # rows of 64 chunks, K=1
    assert K.gather_plan(wide, 33280, 64) == 0
    # rows by unit: the full term of raw features, the Exact fanouts; one
    # float32 row a warp by element where F fills the card alone (Exact
    # training's first layer and evaluation), at K = 1, and on rows
    # narrower than a warp; bfloat16 rows by unit at split 1 there
    assert K.gather_plan(table(602, torch.bfloat16), 512, 64) == 4
    assert K.gather_plan(table(602), 512, 64) == 4
    assert K.gather_plan(table(602), 2048, 64) == 0
    assert K.gather_plan(table(602, torch.bfloat16), 2048, 64) == 1
    assert K.gather_plan(table(602, torch.bfloat16), 512, 1) == 1
    assert K.gather_plan(table(602), 33280, 64) == 0
    assert K.gather_plan(table(602), 27648, 53) == 0
    assert K.gather_plan(table(602), 512, 1) == 0
    assert K.gather_plan(table(1433), 512, 64) == 4
    assert K.gather_plan(table(13), 512, 64) == 0
    assert K.gather_plan(table(1), 512, 64) == 0
    # the backward: slots dealt over warps at K = 64 (Exact layer 1), one
    # warp a row of the sparse first layer's 15,000 rows
    assert K.backward_plan(512, 64) == 8
    assert K.backward_plan(15000, 333) == 1
    assert K.backward_plan(4096, 64) == 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", BACKWARD_CASES + [
    (300, 1, 8, 128),           # F = 1
    (40000, 9000, 2, 128),      # more than one resident grid covers
])
def test_backward_zero_fills_on_edge_cases(cuda, case):
    c, f, k, d = case
    g, pos, w = _backward_inputs(16, c, f, k, d)
    w[f // 2] = 0.0                                  # a row with no live slot
    g, pos, w = (torch.from_numpy(a).to(cuda) for a in (g, pos, w))
    want = K.fanout_aggregate_backward_ref(g, pos, w, c)
    # the kernel zero-fills grad_x itself: a dirty allocation must not leak
    torch.full((c, d), 7.0, device=cuda)         # freed into the allocator
    before = K.LAUNCHES["fanout_aggregate_backward"]
    got = K.fanout_aggregate_backward(g, pos, w, c)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fanout_aggregate_backward"] == before + 1
    torch.testing.assert_close(got, want, **TOL)


def _many_slot_inputs(seed, c, f, k, d, live=0.05):
    """Slots that outnumber the rows of grad_x: repeated positions, zero
    weights, parked positions, and a row with no live slot whose g row is
    NaN (it must never be read)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(f, d)).astype(np.float32)
    w = (rng.uniform(0.1, 1.0, (f, k)) * (rng.random((f, k)) < live)
         ).astype(np.float32)
    pos = rng.integers(0, c, (f, k)).astype(np.int32)
    pos[rng.random((f, k)) < 0.05] = 1 << 30
    w[f // 2] = 0.0
    g[f // 2] = np.nan
    return g, pos, w


MANY_SLOT_CASES = [  # (C, F, K, d): slots many times the rows of grad_x
    (500, 3000, 40, 32),              # the sparse layer's shape, cut down
    (500, 3000, 333, 32),             # its 333 slots a row: one load round
    (20, 300, 7, 32),                 # K below one round
    (10, 1, 600, 32),                 # F = 1, K past 16 rounds
    (300, 2500, 50, 128),             # 4 columns a lane
    (50, 3000, 37, 13),               # d not a multiple of 4
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", MANY_SLOT_CASES, ids=str)
def test_backward_on_many_slots_on_few_rows(cuda, case):
    c, f, k, d = case
    g, pos, w = (torch.from_numpy(a).to(cuda)
                 for a in _many_slot_inputs(28, c, f, k, d))
    want = K.fanout_aggregate_backward_ref(torch.nan_to_num(g), pos, w, c)
    torch.full((c, d), 7.0, device=cuda)         # a dirty allocation
    before = K.LAUNCHES["fanout_aggregate_backward"]
    got = K.fanout_aggregate_backward(g, pos, w, c)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fanout_aggregate_backward"] == before + 1
    torch.testing.assert_close(got, want, **TOL)


def _ended_slots(seed, c, f, k, d, kind, share=0.3):
    """Slots of a padded-sparse layer's rows with their ends: live slots
    a prefix of the row (``pad_sparse_features``' layout), or anywhere
    before the end (``not a prefix``), or clustered on few columns with a
    live slot at K - 1; the rest hold the sentinel column ``c`` and weight
    0, and a row with no live slot has a NaN g row.  A ``share`` of the
    rows own live slots, the others none."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(f, d)).astype(np.float32)
    n_live = np.where(rng.random(f) < share, rng.integers(0, k + 1, f), 0)
    pos = np.full((f, k), c, np.int32)
    w = np.zeros((f, k), np.float32)
    for r in range(f):
        n = n_live[r]
        at = (np.arange(n) if kind != "not a prefix"
              else np.sort(rng.choice(k, n, replace=False)))
        cols = (rng.integers(0, min(c, 3), n) if kind == "clustered"
                else rng.integers(0, c, n))
        pos[r, at], w[r, at] = cols, rng.uniform(0.1, 1.0, n)
        if n and rng.random() < 0.2:
            w[r, at[0]] = 0.0          # a dropout zero inside the range
    if kind == "clustered":
        pos[0, k - 1], w[0, k - 1] = c - 1, 0.5      # live at K - 1
    ends = live_ends(pos, c)
    g[ends == 0] = np.nan
    return g, pos, w, ends


ENDED_CASES = [  # (C, F, K, d, kind)
    (500, 3000, 333, 32, "prefix"),        # the sparse layer, cut down
    (500, 3000, 333, 32, "not a prefix"),
    (500, 3000, 40, 32, "clustered"),      # contention, live at K - 1
    (20, 1, 600, 32, "not a prefix"),      # F = 1, a range past 16 rounds
    (300, 2501, 50, 128, "prefix"),        # 32 units a row, F not of 8
    (50, 3000, 37, 13, "not a prefix"),    # d not a multiple of 4
    (40, 777, 9, 64, "clustered"),         # 16 units a row
    # small fields, whose plan splits a row over warps: the cooperative
    # kernel with the ends (8 and 2 warps a row), and rows of more than
    # 32 units, which keep the ends kernel
    (500, 25, 333, 32, "prefix"),
    (500, 2000, 333, 32, "not a prefix"),
    (50, 64, 300, 13, "clustered"),
    (50, 16, 300, 602, "prefix"),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ENDED_CASES, ids=str)
def test_backward_with_ends_matches_plain(cuda, case):
    """The backward given the rows' ends (fanout_backward_ends_kernel, or
    for a small field fanout_backward_coop_kernel with the ends) equals the
    plain version with the same ends, and the kernel without them; slots
    past the ends are never read (live-looking slots there, column 0 and
    weight 1, add nothing; rows that end at 0 have NaN g)."""
    c, f, k, d, kind = case
    g, pos, w, ends = (torch.from_numpy(a).to(cuda)
                       for a in _ended_slots(29, c, f, k, d, kind))
    past = torch.arange(k, device=cuda)[None, :] >= ends[:, None]
    noisy_pos = torch.where(past, torch.zeros_like(pos), pos)
    noisy_w = torch.where(past, torch.ones_like(w), w)
    clean = torch.nan_to_num(g)
    want = K.fanout_aggregate_backward_ref(clean, pos, w, c, ends)
    torch.full((c, d), 7.0, device=cuda)         # a dirty allocation
    before = K.LAUNCHES["fanout_aggregate_backward"]
    got = K.fanout_aggregate_backward(g, noisy_pos, noisy_w, c, ends)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fanout_aggregate_backward"] == before + 1
    # ~100 slots of unit scale on one row of grad_x differ by ~1e-5
    # between summation orders: the float32 order bound on top
    n = int(torch.bincount(pos[(w != 0) & (pos < c)].long(),
                           minlength=c).max())
    slack = 2 * n * 2.0 ** -24 * K.fanout_aggregate_backward_ref(
        clean.abs(), pos, w.abs(), c)
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs() + slack).all()
    assert ((K.fanout_aggregate_backward(clean, pos, w, c) - want).abs()
            <= 1e-5 + 1e-5 * want.abs() + slack).all()


# (C, F, K, d, kind, share of rows with live slots, table dtype)
ENDED_FORWARD_CASES = [
    (500, 3000, 333, 32, "prefix", 0.3, torch.float32),  # the sparse layer
    (500, 3000, 333, 32, "not a prefix", 0.3, torch.float32),
    (500, 3000, 40, 32, "clustered", 0.3, torch.float32),
    (500, 777, 200, 32, "prefix", 1.0, torch.float32),   # every row long
    (20, 1, 600, 32, "not a prefix", 1.0, torch.float32),  # F = 1
    (300, 2501, 50, 128, "prefix", 0.5, torch.float32),   # 32 units a row
    (50, 3000, 37, 13, "not a prefix", 0.5, torch.float32),  # by element
    (40, 777, 90, 64, "clustered", 0.6, torch.float32),   # 16 units
    (50, 16, 300, 602, "prefix", 0.8, torch.float32),     # passes of units
    (500, 999, 333, 64, "prefix", 0.3, torch.bfloat16),   # bf16 by 16 B
    (50, 300, 80, 13, "not a prefix", 0.5, torch.bfloat16),  # bf16 by 2 B
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ENDED_FORWARD_CASES, ids=str)
def test_forward_with_ends_matches_plain(cuda, case):
    """The forward given the rows' ends (ends_gather_kernel: each row that
    does not end at 0 over the block's 8 warps) equals the plain version
    with the same ends on seeded fields of long and empty rows; it reads
    no slot past a row's end (live-looking slots there, column 0 and
    weight 1, add nothing), writes rows that end at 0 as zeros, gives the
    same bits on a second call, and counts one launch given ends.
    Tolerance: TOL plus the float32 summation-order bound, 2 n 2^-24 times
    the sum of the terms' magnitudes (n the most live slots on a row: up
    to ~330 unit-scale terms, whose sums differ by ~1e-5 between
    orders)."""
    c, f, k, d, kind, share, dtype = case
    _, pos, w, ends = (torch.from_numpy(a).to(cuda) for a in _ended_slots(
        31, c, f, k, d, kind, share))
    table = torch.from_numpy(np.random.default_rng(32).normal(
        size=(c, d)).astype(np.float32)).to(cuda, dtype)
    past = torch.arange(k, device=cuda)[None, :] >= ends[:, None]
    noisy_pos = torch.where(past, torch.zeros_like(pos), pos)
    noisy_w = torch.where(past, torch.ones_like(w), w)
    want = K.fanout_aggregate_ref(table.float(), pos, w, ends)
    before = dict(K.ENDS_LAUNCHES), K.LAUNCHES["fanout_aggregate"]
    got = K.fanout_aggregate(table, noisy_pos, noisy_w, ends)
    again = K.fanout_aggregate(table, noisy_pos, noisy_w, ends)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fanout_aggregate"] == before[1] + 2
    assert K.ENDS_LAUNCHES["fanout_aggregate"] == \
        before[0]["fanout_aggregate"] + 2
    n = int(((w != 0) & (pos < c)).sum(1).max())
    bound = 1e-5 + 1e-5 * want.abs() + 2 * n * 2.0 ** -24 * \
        K.fanout_aggregate_ref(table.float().abs(), pos, w.abs(), ends)
    assert torch.isfinite(got).all() and ((got - want).abs() <= bound).all()
    assert torch.equal(got, again)
    assert (got[ends == 0] == 0).all()
    # the same slots without the ends: the gather's own plan, same sums
    assert ((K.fanout_aggregate(table, pos, w) - want).abs() <= bound).all()


@pytest.mark.requires_cuda
def test_misaligned_views_go_by_element(cuda):
    """Rows whose pointer is only 4-byte aligned take the 4-byte units of
    the same kernels: a 1024-byte-row table, a 602-wide one, and the
    backward's gradient rows."""
    _, idx, w = (torch.from_numpy(a).to(cuda)
                 for a in _inputs(30, 50, 8, 512, 64))
    for d in (256, 602):
        t = torch.randn(50 * d + 1, device=cuda)[1:].view(50, d)
        assert t.data_ptr() % 8 == 4 and t.is_contiguous()
        torch.testing.assert_close(K.hbm_gather_aggregate(t, idx, w),
                                   K.hbm_gather_aggregate_ref(t, idx, w),
                                   **TOL)
    g, pos, pw = (torch.from_numpy(a).to(cuda)
                  for a in _backward_inputs(31, 5000, 512, 64, 128))
    odd = torch.empty(g.numel() + 1, device=cuda)[1:].view_as(g).copy_(g)
    assert odd.data_ptr() % 16 == 4
    torch.testing.assert_close(
        K.fanout_aggregate_backward(odd, pos, pw, 5000),
        K.fanout_aggregate_backward_ref(g, pos, pw, 5000), **TOL)


@pytest.mark.requires_cuda
def test_kernels_replay_in_a_cuda_graph(cuda):
    """The four wrappers captured once in a CUDA graph and replayed on
    refilled static inputs give the eager results: no wrapper hides a
    synchronisation or an allocation outside the graph's pool.  The launch
    counters count the capture, not the replays."""
    def inputs(seed):
        table, idx, w = _inputs(seed, 20000, 128, 512, 64)
        g, pos, pw = _backward_inputs(seed, 1024, 512, 1, 128)
        x = np.random.default_rng(seed).normal(size=(1024, 128)).astype(
            np.float32)
        field_in = np.random.default_rng(seed + 50).integers(
            0, 20001, 1024).astype(np.int32)          # 20000: the sentinel
        many = _many_slot_inputs(seed, 500, 3000, 40, 32)
        many = (np.nan_to_num(many[0]),) + many[1:] + (
            live_ends(many[1], 500),)
        return [torch.from_numpy(a).to(cuda)
                for a in (table, idx, w, x, pos, pw, g, field_in, *many)]

    def run(table, idx, w, x, pos, pw, g, field_in, mg, mpos, mw, mends):
        hist = table.bfloat16()
        base = K.hbm_gather_aggregate(hist, idx, w)
        return (base, K.fanout_aggregate(x, pos, pw),
                K.fanout_aggregate_backward(g, pos, pw, 1024),
                K.cv_fanout_aggregate(x, hist, field_in, 20000, pos, pw,
                                      base),
                # the redesigned branches: rows by unit
                # (wide_split_kernel) and of 33-128 chunks
                # (wide_tma_kernel), a g row's slots over 8 warps, rows of
                # several load rounds
                K.hbm_gather_aggregate(hist.repeat(1, 5)[:, :602]
                                       .contiguous(), idx, w),
                K.hbm_gather_aggregate(table.repeat(1, 2), idx, w),
                K.fanout_aggregate_backward(g, idx, w, 20000),
                K.fanout_aggregate_backward(mg, mpos, mw, 500),
                # a float32 row split by columns over warps
                # (wide_cols_kernel: K = 1 plans one warp a row), the CV
                # delta so, and the backward with the rows' ends
                K.fanout_aggregate(x.repeat(1, 5)[:, :602].contiguous(),
                                   pos, pw),
                K.cv_fanout_aggregate(
                    x.repeat(1, 5)[:, :602].contiguous(),
                    hist.repeat(1, 5)[:, :602].contiguous(), field_in, 20000,
                    pos, pw, table.repeat(1, 5)[:512, :602].contiguous()),
                K.fanout_aggregate_backward(mg, mpos, mw, 500, mends),
                # the forward with the rows' ends (ends_gather_kernel)
                K.fanout_aggregate(table[:500, :32].contiguous(), mpos, mw,
                                   mends))

    static = inputs(17)
    run(*static)                                     # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    K.reset_launches()
    with torch.cuda.graph(graph):
        outs = run(*static)
    assert K.LAUNCHES == {"fanout_aggregate": 3, "hbm_gather_aggregate": 3,
                          "fanout_aggregate_backward": 4,
                          "cv_fanout_aggregate": 2}
    assert K.gather_plan(torch.zeros(8, 602, device=cuda), 512, 1) == 0
    assert K.backward_plan(512, 64) == 8
    for seed in (18, 19):
        fresh = inputs(seed)
        for s, t in zip(static, fresh):
            s.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        want = run(*fresh)
        for i in (0, 1, 3, 4, 5, 8, 9, 11):          # fixed sum order
            assert torch.equal(outs[i], want[i]), i
        for i in (2, 6, 7, 10):                      # atomics
            torch.testing.assert_close(outs[i], want[i], **TOL)
    assert K.LAUNCHES["hbm_gather_aggregate"] == 9   # 3 capture + 6 eager


# ---- the CV estimator's sampled term ----

def _cv_inputs(seed, n, c, d, f, k, dtype):
    """x [c, d]; hist [n + 8, d] of ``dtype``, NaN from the sentinel row n
    on; field_in [c] with sentinel ids; pos/w [f, k] with repeated
    positions, parked positions, zero weights pointing at a NaN row of x,
    and an all-dead row ``f // 2``; base [f, d]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, d)).astype(np.float32)
    x[c - 1] = np.nan
    hist = rng.normal(size=(n + 8, d)).astype(np.float32)
    hist[n:] = np.nan
    field_in = rng.integers(0, n, c).astype(np.int32)
    field_in[rng.random(c) < 0.2] = n
    pos = rng.integers(0, max(1, c // 4), (f, k)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (f, k)).astype(np.float32)
    if k > 1:
        dead = rng.random((f, k)) < 0.3
        w[dead], pos[dead] = 0.0, c - 1
        pos[rng.random((f, k)) < 0.1] = 1 << 30
    w[f // 2] = 0.0
    base = rng.normal(size=(f, d)).astype(np.float32)
    x, hist, field_in, pos, w, base = (
        torch.from_numpy(a) for a in (x, hist, field_in, pos, w, base))
    return x, hist.to(dtype), field_in, pos, w, base


# (d, history dtype): x rows that fill a quarter, a half and all of a warp's
# lanes, and 2, 3 and 4 chunks per lane, each with both history types
# somewhere: every instantiation of the kernel
CV_ROWS = [(32, torch.float32), (32, torch.bfloat16), (64, torch.bfloat16),
           (64, torch.float32), (128, torch.bfloat16), (128, torch.float32),
           (256, torch.float32), (256, torch.bfloat16), (384, torch.float32),
           (512, torch.bfloat16), (512, torch.float32),
           # by element: x and history rows paired by column
           (602, torch.float32), (602, torch.bfloat16), (1, torch.float32),
           (1, torch.bfloat16), (513, torch.bfloat16), (516, torch.float32),
           (1433, torch.float32), (1433, torch.bfloat16)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("row", CV_ROWS, ids=lambda r: f"{r[0]}-{r[1]}")
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_cv_fanout_kernel_on_edge_cases(cuda, shape, row):
    (f, k), (d, dtype) = shape, row
    n, c = 3000, f * k + 16
    x, hist, field_in, pos, w, base = (
        t.to(cuda) for t in _cv_inputs(20, n, c, d, f, k, dtype))
    want = K.cv_fanout_aggregate_ref(x, hist.float(), field_in, n, pos, w,
                                     base)
    before = K.LAUNCHES["cv_fanout_aggregate"]
    got = K.cv_fanout_aggregate(x, hist, field_in, n, pos, w, base)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cv_fanout_aggregate"] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got[f // 2], base[f // 2])            # all-dead row
    # all slots parked: base comes through; a field of sentinels only: the
    # fanout of x alone
    parked = K.cv_fanout_aggregate(x, hist, field_in, n,
                                   torch.full_like(pos, 1 << 30), w, base)
    assert torch.equal(parked, base)
    alone = K.cv_fanout_aggregate(x, hist, torch.full_like(field_in, n), n,
                                  pos, w, base)
    torch.testing.assert_close(
        alone, K.fanout_aggregate_ref(x, pos, w) + base, **TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cv_fanout_is_bitwise_reproducible_at_k64(cuda, dtype):
    x, hist, field_in, pos, w, base = (
        t.to(cuda) for t in _cv_inputs(21, 20000, 512 * 65, 128, 512, 64,
                                       dtype))
    first = K.cv_fanout_aggregate(x, hist, field_in, 20000, pos, w, base)
    for _ in range(5):
        assert torch.equal(K.cv_fanout_aggregate(x, hist, field_in, 20000,
                                                 pos, w, base), first)


@pytest.mark.requires_cuda
def test_cv_fanout_equals_the_composition_it_replaces(cuda):
    """``history_gather``, subtract, the fanout kernel, add: the same
    value, and a sentinel id past the history's rows reads zero."""
    from stochastic_gcn_tpu_torch.models.aggregators import history_gather
    x, hist, field_in, pos, w, base = (
        t.to(cuda) for t in _cv_inputs(22, 3000, 1024, 128, 512, 1,
                                       torch.bfloat16))
    got = K.cv_fanout_aggregate(x, hist, field_in, 3000, pos, w, base)
    want = K.fanout_aggregate(x - history_gather(hist, field_in, 3000),
                              pos, w) + base
    torch.testing.assert_close(got, want, **TOL)
    short = hist[:2000].contiguous()              # ids 2000..2999: no row
    got = K.cv_fanout_aggregate(x, short, field_in, 3000, pos, w, base)
    want = K.cv_fanout_aggregate_ref(
        x, short.float(), torch.where(field_in >= 2000, 3000, field_in),
        3000, pos, w, base)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.requires_cuda
def test_cv_fanout_gradient_and_history_scatter_on_card(cuda):
    """Forward, an in-place scatter into the history, then backward: the
    gradient is the fanout backward kernel's, and nothing raises."""
    x, hist, field_in, pos, w, base = (
        t.to(cuda) for t in _cv_inputs(23, 3000, 1024, 128, 512, 8,
                                       torch.bfloat16))
    x = torch.nan_to_num(x)
    g = torch.from_numpy(np.random.default_rng(24).normal(
        size=(512, 128)).astype(np.float32)).to(cuda)
    xk = x.clone().requires_grad_()
    before = dict(K.LAUNCHES)
    out = K.cv_fanout_aggregate(xk, hist, field_in, 3000, pos, w, base)
    hist.index_copy_(0, torch.arange(5, device=cuda),
                     torch.ones(5, 128, device=cuda, dtype=hist.dtype))
    out.backward(g)
    assert K.LAUNCHES["cv_fanout_aggregate"] == \
        before["cv_fanout_aggregate"] + 1
    assert K.LAUNCHES["fanout_aggregate_backward"] == \
        before["fanout_aggregate_backward"] + 1
    assert K.LAUNCHES["fanout_aggregate"] == before["fanout_aggregate"]
    torch.testing.assert_close(
        xk.grad, K.fanout_aggregate_backward_ref(g, pos, w, 1024), **TOL)


@pytest.mark.requires_cuda
def test_cv_fanout_on_card_refuses_what_the_kernel_does_not_take(cuda):
    x, hist, field_in, pos, w, base = (
        t.to(cuda) for t in _cv_inputs(25, 300, 80, 8, 6, 4, torch.float32))
    fn = K.cv_fanout_aggregate
    before = K.LAUNCHES["cv_fanout_aggregate"]
    with pytest.raises(TypeError, match="float32"):
        fn(x.bfloat16(), hist, field_in, 300, pos, w, base)
    with pytest.raises(TypeError, match="history dtype"):
        fn(x, hist.double(), field_in, 300, pos, w, base)
    with pytest.raises(ValueError, match="contiguous"):
        fn(x, hist.t().contiguous().t(), field_in, 300, pos, w, base)
    # three columns, once refused: computed by element
    narrow = (x[:, :3].contiguous(), hist[:, :3].contiguous(), field_in, 300,
              pos, w, base[:, :3].contiguous())
    torch.testing.assert_close(fn(*narrow),
                               K.cv_fanout_aggregate_ref(*narrow), **TOL)
    before += 1
    with pytest.raises(ValueError, match="device"):
        fn(x, hist.cpu(), field_in, 300, pos, w, base)
    with pytest.raises(ValueError, match="device"):
        fn(x, hist, field_in, 300, pos, w, base.cpu())
    with pytest.raises(ValueError, match="require grad"):
        fn(x, hist.clone().requires_grad_(), field_in, 300, pos, w, base)
    assert K.LAUNCHES["cv_fanout_aggregate"] == before


# ---- importance sampling: the kernels on IS slots ----

def _is_pack(dev, batch: int, cap: int, seed: int = 1):
    """One importance-sampled schedule on ``dev`` of a 3000-node graph with
    degrees up to 64: ``[F, Dcap]`` slots, or ``[F, cap]`` under the slot
    cap, mostly parked, with positions repeated across rows."""
    from stochastic_gcn_tpu_torch.data.graph import pad_csr
    from stochastic_gcn_tpu_torch.sampler import scheduler as S
    ds = synthetic_dataset(num_nodes=3000, feature_dim=8, num_classes=4,
                           avg_degree=40, normalization="graphsage", seed=0,
                           max_degree=64)
    g = pad_csr(ds.full_adj, -1, device=dev)
    n = ds.num_data
    ids = np.full(batch, n, np.int32)
    real = ds.train_d[:batch - 8]
    ids[:len(real)] = real
    pack = S.schedule(torch.Generator(device=dev).manual_seed(seed), g,
                      torch.from_numpy(ids).to(dev), (1,), cv=True,
                      importance=S.compute_importance(g), is_slot_cap=cap)
    return pack, g


IS_SHAPES = [(256, 0), (256, 8), (2048, -1)]     # (batch, slot cap)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("batch, cap", IS_SHAPES)
def test_kernels_on_importance_slots(cuda, batch, cap):
    """The fanout, its backward and the CV kernel on the slots of a real IS
    schedule made on the card, plus two rows the IS layout makes common:
    every slot parked, and every slot naming one position."""
    pack, g = _is_pack(cuda, batch, cap)
    ls = pack.layers[0]
    pos, w = ls.slot_pos.clone(), ls.slot_w.clone()
    f, k = pos.shape
    assert k == (g.pad_degree if cap == 0 else 8)
    assert (pos[w == 0] == (1 << 30)).all()
    c = pack.fields[0].shape[0]
    live = pos[w != 0]
    assert live.numel() and int(live.max()) < c
    pos[0], w[0] = 1 << 30, 0.0                         # all parked
    pos[1], w[1] = int(live[0]), 0.5                    # one position
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.normal(size=(c, 128)).astype(np.float32)).to(
        cuda)
    gr = torch.from_numpy(rng.normal(size=(f, 128)).astype(np.float32)).to(
        cuda)
    got = K.fanout_aggregate(x, pos, w)
    torch.testing.assert_close(got, K.fanout_aggregate_ref(x, pos, w), **TOL)
    assert not got[0].any()
    torch.testing.assert_close(got[1], 0.5 * k * x[int(live[0])], **TOL)
    grad = K.fanout_aggregate_backward(gr, pos, w, c)
    torch.testing.assert_close(
        grad, K.fanout_aggregate_backward_ref(gr, pos, w, c), **TOL)
    hist = torch.from_numpy(rng.normal(size=(g.num_nodes + 8, 128)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    base = torch.from_numpy(rng.normal(size=(f, 128)).astype(
        np.float32)).to(cuda)
    n = g.num_nodes
    got = K.cv_fanout_aggregate(x, hist, pack.fields[0], n, pos, w, base)
    torch.testing.assert_close(got, K.cv_fanout_aggregate_ref(
        x, hist.float(), pack.fields[0], n, pos, w, base), **TOL)
    assert torch.equal(got[0], base[0])


# launches per train step of the IS arms
IS_STEPS = {
    "IS+PP": (dict(cv=False, test_cv=False),
              {"fanout_aggregate": 1, "fanout_aggregate_backward": 1}),
    "IS+CV": (dict(cv=True, test_cv=True),
              {"cv_fanout_aggregate": 1, "hbm_gather_aggregate": 1,
               "fanout_aggregate_backward": 1}),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(IS_STEPS))
def test_importance_train_steps_on_card_match_cpu(cuda, name):
    """10 IS train steps on the card and on the CPU from the same weights:
    the degree is large enough that every member of the union is drawn, so
    the selection and the weights are deterministic; dropout off."""
    over, per_step = IS_STEPS[name]
    ds = synthetic_dataset(num_nodes=240, feature_dim=16, num_classes=5,
                           normalization="graphsage", seed=0)
    cfg = Config(**{**dict(dataset="synthetic", batch_size=16, degree=10000,
                           test_degree=10000, hidden1=16, importance=True,
                           test_importance=True, normalization="graphsage",
                           layer_norm=True, num_fc_layers=2,
                           weight_decay=5e-4, dropout=0.0, pad_degree=-1,
                           seed=1, test_batch_size=24), **over})
    it = MinibatchIterator(ds.train_d, 3)
    it.shuffle()
    bm = Trainer._batch_matrix(it.data, cfg.batch_size, ds.num_data)[:10]
    out = {}
    for dev in ("cpu", cuda):
        tr = Trainer(cfg, ds, device=dev)
        K.reset_launches()
        tr.state, m = tr._train_epoch(
            tr.state, tr.graph_train, tr.train_features, tr.labels,
            torch.from_numpy(bm).to(dev), tr.gen, tr.importance_train)
        out[str(dev)] = (tr, float(m["loss"]), dict(K.LAUNCHES))
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert gpu[2] == {k: per_step.get(k, 0) * len(bm) for k in gpu[2]}
    assert abs(gpu[1] - cpu[1]) <= 1e-4
    for l, k in St.param_keys(cpu[0].params):
        torch.testing.assert_close(gpu[0].params[l][k].cpu(),
                                   cpu[0].params[l][k], rtol=0, atol=1e-4)
    assert abs(gpu[0].evaluate(ds.val_d)[0]
               - cpu[0].evaluate(ds.val_d)[0]) <= 1e-4


# --------------------- padded-sparse features, serving ---------------------

def _sparse_first_layer(seed, rows, dim, k, hidden, dev):
    """Padded-sparse rows as ``pad_sparse_features`` gives them (sentinel
    column ``dim`` in the empty slots) and a ``[dim, hidden]`` weight."""
    import scipy.sparse as sp
    from stochastic_gcn_tpu_torch.data.graph import pad_sparse_features
    rng = np.random.default_rng(seed)
    x = sp.random(rows, dim, density=min(1.0, 0.7 * k / dim),
                  random_state=seed, format="csr", dtype=np.float64)
    x.data = rng.normal(size=x.nnz)
    feats = pad_sparse_features(x, k, device=dev)
    w = torch.from_numpy(rng.normal(size=(dim, hidden)).astype(np.float32))
    return feats, w.to(dev)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows, dim, k, hidden", [
    (2000, 500, 300, 32),          # PubMed's width, hundreds of nonzeros
    (300, 1433, 40, 16),           # Cora's width
    (257, 50, 64, 512),            # PPI's hidden width
])
def test_sparse_first_layer_kernels_match_plain_on_card(cuda, rows, dim, k,
                                                        hidden):
    """``matmul`` of padded-sparse rows by W on the card: one
    ``fanout_aggregate`` over the rows of W (the sentinel column reads
    zero) and, for the gradient in W, one ``fanout_aggregate_backward``;
    both against the plain versions on the CPU."""
    from stochastic_gcn_tpu_torch.ops import layers as L
    feats, w = _sparse_first_layer(7, rows, dim, k, hidden, cuda)
    g = torch.from_numpy(np.random.default_rng(8).normal(
        size=(rows + 1, hidden)).astype(np.float32))
    wc = w.cpu().requires_grad_()
    cpu_feats = feats.replace(idx=feats.idx.cpu(), val=feats.val.cpu(),
                              ends=feats.ends.cpu())
    want = L.matmul(cpu_feats, wc)
    (want * g).sum().backward()
    wg = w.clone().requires_grad_()
    K.reset_launches()
    got = L.matmul(feats, wg)
    (got * g.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"cv_fanout_aggregate": 0, "fanout_aggregate": 1,
                          "fanout_aggregate_backward": 1,
                          "hbm_gather_aggregate": 0}
    torch.testing.assert_close(got.cpu(), want.detach(), **TOL)
    torch.testing.assert_close(wg.grad.cpu(), wc.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_predictor_on_card_equals_trainer_predict(cuda, tmp_path):
    """A Planetoid fixture (padded-sparse PP features) trained on the card
    for an epoch; its artifact served on the card equals
    ``Trainer.predict`` bitwise, through the two CV kernels and the sparse
    first layer's fanout, and repeated requests are bitwise equal."""
    from stochastic_gcn_tpu_torch import serving
    from stochastic_gcn_tpu_torch.data import fixtures
    from stochastic_gcn_tpu_torch.data.loaders import load_data
    d = str(tmp_path / "data")
    fixtures.write_planetoid_fixture(d, fixtures.PlanetoidSpec(
        name="pubmed", num_extra=600, num_test=100, feature_dim=60,
        num_classes=3))
    cfg = Config(dataset="pubmed", data_dir=d, cv=True, test_cv=True,
                 degree=1, test_degree=1, batch_size=100,
                 test_batch_size=64, ckpt_dir=str(tmp_path))
    ds = load_data(cfg)
    tr = Trainer(cfg, ds, device=cuda)
    tr.train_epoch()
    ids = np.asarray(ds.test_d)
    path = serving.export_predictor(tr, str(tmp_path / "art"))
    live = tr.predict(ids)
    pred = serving.load_predictor(path, device=cuda)
    K.reset_launches()
    got = pred.predict(ids)
    assert K.LAUNCHES["fanout_aggregate"] > 0, K.LAUNCHES
    assert K.LAUNCHES["cv_fanout_aggregate"] > 0, K.LAUNCHES
    assert K.LAUNCHES["hbm_gather_aggregate"] > 0, K.LAUNCHES
    np.testing.assert_array_equal(got, live)
    np.testing.assert_array_equal(pred.predict(ids[::-1]), got[::-1])
    cpu = serving.load_predictor(path, device="cpu").predict(ids)
    np.testing.assert_allclose(got, cpu, rtol=0, atol=1e-5)


def _fullterm_graphs(dev):
    """A padded graph and an edge list of one 300-node graph with rows of
    up to ~40 neighbours, both with a forced tier split at 8 slots."""
    from stochastic_gcn_tpu_torch.data.graph import flat_csr, pad_csr
    ds = synthetic_dataset(num_nodes=300, feature_dim=8, num_classes=4,
                           avg_degree=16, normalization="graphsage", seed=2)
    return ds, {"padded": pad_csr(ds.full_adj, -1, tier=True, tier_w=8,
                                  device=dev),
                "edgelist": flat_csr(ds.full_adj, 1.5, tier=True, tier_w=8,
                                     device=dev)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["padded", "edgelist"])
@pytest.mark.parametrize("tier", [False, True])
@pytest.mark.parametrize("square", [False, True])
def test_fullterm_forms_on_card_match_cpu(cuda, monkeypatch, layout, tier,
                                          square):
    """Padded rows, edge-list windows (a truncating budget: renormalised
    weights) and the two-tier split of either, on the card against the
    plain versions on the CPU; the tier launches the full-term kernel twice
    (main and tail), the untiered term once."""
    from stochastic_gcn_tpu_torch.models import aggregators as A
    monkeypatch.setattr(A, "TIER_MIN_ROWS", 0 if tier else 1 << 30)
    ds, cpu_graphs = _fullterm_graphs("cpu")
    _, card_graphs = _fullterm_graphs(cuda)
    n = ds.num_data
    rng = np.random.default_rng(5)
    hist = rng.normal(size=(n + 8, 16)).astype(np.float32)
    field = np.r_[rng.integers(0, n, 200), [n, n]].astype(np.int32)
    want = A.full_neighborhood_mean(torch.from_numpy(hist),
                                    cpu_graphs[layout],
                                    torch.from_numpy(field), square=square)
    K.reset_launches()
    got = A.full_neighborhood_mean(torch.from_numpy(hist).to(cuda),
                                   card_graphs[layout],
                                   torch.from_numpy(field).to(cuda),
                                   square=square)
    assert K.LAUNCHES["hbm_gather_aggregate"] == (2 if tier else 1)
    torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["padded", "edgelist"])
def test_full_abar_on_card_matches_cpu(cuda, monkeypatch, layout):
    """The a-bar table on the card against the CPU's: one kernel call over
    the padded graph's rows, one per chunk of the edge list's."""
    from stochastic_gcn_tpu_torch.models import aggregators as A
    monkeypatch.setattr(A, "ABAR_CHUNK", 64)
    ds, cpu_graphs = _fullterm_graphs("cpu")
    _, card_graphs = _fullterm_graphs(cuda)
    n = ds.num_data
    hist = torch.from_numpy(np.random.default_rng(6).normal(
        size=(n + 5, 16)).astype(np.float32)).to(torch.bfloat16)
    want = A.full_abar(hist, cpu_graphs[layout], n)
    K.reset_launches()
    got = A.full_abar(hist.to(cuda), card_graphs[layout], n)
    assert K.LAUNCHES["hbm_gather_aggregate"] == \
        (1 if layout == "padded" else -(-(n + 1) // 64))
    torch.testing.assert_close(got.cpu(), want, **TOL)
    assert (got[n:] == 0).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("over, per_step, per_epoch", [
    (dict(graph_format="edgelist"),
     {"cv_fanout_aggregate": 1, "hbm_gather_aggregate": 1,
      "fanout_aggregate_backward": 1}, {}),
    (dict(lazy_fullterm=True),
     {"cv_fanout_aggregate": 1, "fanout_aggregate_backward": 1},
     {"hbm_gather_aggregate": 1}),
    (dict(lazy_fullterm=True, graph_format="edgelist"),
     {"cv_fanout_aggregate": 1, "fanout_aggregate_backward": 1},
     {"hbm_gather_aggregate": 1})])
def test_fullterm_train_steps_on_card_match_cpu(cuda, over, per_step,
                                                per_epoch):
    """10 CV+PP train steps on the edge list and under the frozen anchor,
    exhaustive degree and no dropout, on the card and on the CPU from the
    same weights: the launches (the lazy epoch's one a-bar call and no
    per-step full term) and the weights after."""
    ds = synthetic_dataset(num_nodes=240, feature_dim=16, num_classes=5,
                           normalization="graphsage", seed=0)
    cfg = Config(**{**dict(dataset="synthetic", batch_size=16, degree=10000,
                           test_degree=10000, cv=True, test_cv=True,
                           hidden1=16, normalization="graphsage",
                           layer_norm=True, num_fc_layers=2, dropout=0.0,
                           pad_degree=-1, seed=1, test_batch_size=24),
                    **over})
    it = MinibatchIterator(ds.train_d, 3)
    it.shuffle()
    bm = Trainer._batch_matrix(it.data, cfg.batch_size, ds.num_data)[:10]
    out = {}
    for dev in ("cpu", cuda):
        tr = Trainer(cfg, ds, device=dev)
        K.reset_launches()
        tr.state, m = tr._train_epoch(
            tr.state, tr.graph_train, tr.train_features, tr.labels,
            torch.from_numpy(bm).to(dev), tr.gen)
        out[str(dev)] = (tr, float(m["loss"]), dict(K.LAUNCHES))
    cpu, gpu = out["cpu"], out[str(cuda)]
    want = {k: per_step.get(k, 0) * len(bm) + per_epoch.get(k, 0)
            for k in K.LAUNCHES}
    assert gpu[2] == want
    assert abs(gpu[1] - cpu[1]) <= 1e-4
    for l, k in St.param_keys(cpu[0].params):
        torch.testing.assert_close(gpu[0].params[l][k].cpu(),
                                   cpu[0].params[l][k], rtol=0, atol=1e-4)


@pytest.mark.requires_cuda
def test_async_save_on_card_snapshots_before_the_next_step(cuda, tmp_path):
    """``--ckpt_async`` on the card: the snapshot is taken on the current
    stream ahead of the next epoch's in-place updates, copied on a side
    stream into pinned buffers (reused by the next save), and the file
    holds the arrays of a sync save of the same state, bit for bit."""
    ds = synthetic_dataset(num_nodes=300, feature_dim=16, num_classes=4,
                           normalization="graphsage", seed=0)
    cfg = Config(dataset="synthetic", batch_size=32, degree=1, test_degree=1,
                 cv=True, test_cv=True, hidden1=16, seed=1,
                 test_batch_size=64, ckpt_dir=str(tmp_path / "sync"))
    tr = Trainer(cfg, ds, device=cuda)
    tr.train_epoch()
    want = tr.save()
    tr.cfg = cfg.replace(ckpt_async=True, ckpt_dir=str(tmp_path / "async"))
    got = tr.save()
    tr.train_epoch()               # updates the live state in place
    tr.finish_checkpoints()
    ck = tr._async_ckpt
    assert ck._stream is not None and all(h.is_pinned() for h in ck._host)
    with np.load(want) as w, np.load(got) as g:
        assert g.files == w.files
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    host = list(ck._host)
    tr.save()
    tr.finish_checkpoints()
    assert all(a is b for a, b in zip(host, ck._host))
