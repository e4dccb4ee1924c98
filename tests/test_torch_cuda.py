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
    with pytest.raises(ValueError, match="16 bytes"):
        fn(table[:, :3].contiguous(), idx, w)
    with pytest.raises(ValueError, match="16 bytes"):     # 129 chunks
        fn(torch.zeros(50, 516, device=cuda), idx, w)
    with pytest.raises(ValueError, match="device"):
        fn(table, idx.cpu(), w)


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
    assert K.LAUNCHES["fanout_aggregate"] > 0, K.LAUNCHES
    assert K.LAUNCHES["hbm_gather_aggregate"] > 0, K.LAUNCHES
    assert K.LAUNCHES["fanout_aggregate_backward"] == 0, K.LAUNCHES
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


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
    (300, 13, 8, 128),        # ragged F
    (300, 24, 8, 32),         # narrow rows
    (300, 24, 8, 256),        # 2 float4 chunks per lane
    (300, 24, 8, 384),        # 3 -> the 4-per-lane instantiation
    (300, 24, 8, 512),        # 4 per lane
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
def test_full_term_on_card_refuses_a_table_that_requires_grad(cuda):
    table, idx, w = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(11, 50, 8, 6, 4))
    with pytest.raises(ValueError, match="no backward"):
        K.hbm_gather_aggregate(table.requires_grad_(), idx, w)


@pytest.mark.requires_cuda
def test_train_steps_on_card_match_cpu(cuda):
    """20 train steps at exhaustive degree with dropout off (deterministic
    sampling) on the card and on the CPU from the same initial weights;
    every step launches each of the three kernels once."""
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
    assert gpu[2] == {"fanout_aggregate": 20,
                      "fanout_aggregate_backward": 20,
                      "hbm_gather_aggregate": 20}
    assert abs(gpu[1] - cpu[1]) <= 1e-4
    for l, k in St.param_keys(cpu[0].params):
        torch.testing.assert_close(gpu[0].params[l][k].cpu(),
                                   cpu[0].params[l][k], rtol=0, atol=1e-4)
