"""Smoke run of the PyTorch/CUDA port (stochastic_gcn_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, one or more lines each:

1. card  — ``nvidia-smi`` name and power limit, torch and CUDA versions;
   exits non-zero before printing anything when CUDA is not available.
2. build — compiles the hand-written kernels (csrc/spmm.cu) with nvcc into
   the git-ignored ``stochastic_gcn_tpu_torch/_build/``.
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge cases, from seeded numpy inputs:
   atol 1e-5 + rtol 1e-5 (float32 sums differ only in order, and the
   fanout backward's atomics add in another order on every run; a
   bfloat16 table is compared with the plain version computed in float32
   from the same bfloat16 values).  Rows 2-8x wider than the main path's
   run every instantiation of the one-warp-per-row kernel; every split
   of the split kernel runs on K not a multiple of the split,
   K below the warps per row, K = 1, an all-dead row, F = 1 and F = 1057
   at 128-, 256- and 512-byte rows; the full term must be bitwise equal
   from run to run.  The backward also runs with repeated positions
   (atomic contention), parked positions, zero weights, F = 1 and more
   rows than one resident grid covers, and the gradient through ``FanoutAggregate`` is held against autograd
   through the plain forward.  Times, at the training shapes (fanout
   C=1024 F=512 K=1, full term on the bf16 [233008,128] history at F=512
   K=64, backward C=1024 F=512 K=1) and the serving shapes (F=2048):
   device time per call of the kernel, of its plain version and of the
   one PyTorch call nearest to it (``embedding_bag``; ``index_add_`` for
   the backward; timed here, used nowhere in the port), by CUDA events
   around 32 back-to-back calls queued behind a spin kernel, median of 5
   windows (the full term cycles through 4 index sets); the bound, the
   least time the card could take (``kernel_bytes`` of these inputs, each
   distinct live table row counted once, over 3.35 TB/s, or the
   multiply-adds over 67 TFLOP/s); the time of an empty kernel in the
   same window (``launch_floor_ms``); every split of the gather; and the
   wrapper's host time per call apart from all these.
4. train — CV+PP training at the JAX benchmark's recipe and full width
   (233k-node Reddit-shaped graph, batch 512, degree 1, 1204 -> 128 -> 128
   | CV | 256 -> 128 -> 41, bf16 train history): one warm-up epoch, then
   one timed epoch of 301 steps with the launch counters reset just before
   it.  Prints ms/step, steps/s, sampled edges/s (``amt_data`` over the
   train seconds), its ratio to BASELINE.md's reference host bound, peak
   device memory and the launch counts; fails unless each of the three
   kernels launched at least once per step and the loss is finite (the
   launches per step are printed and go into the kernels line).  Then
   the three kernels on 4 real scheduled batches of the recipe (the
   layer's sampled slots, the train graph's full rows, the trained bf16
   history), held against their plain versions and timed as in phase 3;
   these times are the kernels JSON line's.  Then a ``torch.profiler``
   window of 10 more steps: the top device ops, kernels per step and the
   device's busy share.
5. slice — the serving path from the trained weights (test batch 2048):
   ``Trainer.predict`` answers 3 requests of 2048 test ids (the first pays
   the CV history refresh), with the launch counters reset just before.
   Checks finite probability rows summing to 1, both forward kernels
   launched, and predictions equal to exact inference computed on the
   card with the plain versions (atol 1e-4).  Prints the launches per
   later request, and those of the refresh apart.
6. converge — the JAX benchmark's convergence check (bench.py:134-158):
   CV+PP at degree 1 on the 65,536-node community SBM, up to 15 epochs;
   fails unless the best val micro-F1 reaches 0.90.

The line before the last is a JSON object describing the kernels (times in
device ms per call on real train batches, ``bound_ms`` and ``bound_by``,
``library_ms``, launches per train step and per later request); the last
is ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from stochastic_gcn_tpu_torch.config import Config
from stochastic_gcn_tpu_torch.data.graph import graph_rows
from stochastic_gcn_tpu_torch.data.loaders import (community_sbm_dataset,
                                                   reddit_like)
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.ops import cuda_spmm as K
from stochastic_gcn_tpu_torch.ops import layers as L
from stochastic_gcn_tpu_torch.ops.gather import row_gather
from stochastic_gcn_tpu_torch.sampler.scheduler import schedule
from stochastic_gcn_tpu_torch.training.loop import Trainer

ROOT = Path(__file__).resolve().parent
SOURCE = "stochastic_gcn_tpu_torch/csrc/spmm.cu"
REPLACES = {"fanout_aggregate": "stochastic_gcn_tpu/ops/pallas_spmm.py:100",
            # no TPU kernel: the transpose of fanout_aggregate_xla, which
            # the JAX model differentiates
            "fanout_aggregate_backward":
                "stochastic_gcn_tpu/ops/pallas_spmm.py:242",
            "hbm_gather_aggregate": "stochastic_gcn_tpu/ops/pallas_spmm.py:195"}

# the JAX benchmark recipe (bench.py:628-633)
SLICE_CFG = dict(dataset="reddit_like", batch_size=512, degree=1,
                 test_degree=1, cv=True, test_cv=True, hidden1=128,
                 normalization="graphsage", layer_norm=True, num_fc_layers=2,
                 weight_decay=0.0, dropout=0.2, pad_degree=64, seed=1,
                 test_batch_size=2048)
HIST_ROWS = 233_008          # N + 1 rounded up to a multiple of 8
REQUESTS, REQUEST_IDS = 3, 2048
KERNEL_TOL = (1e-5, 1e-5)    # atol, rtol
SLICE_ATOL = 1e-4
# BASELINE.md: the reference's own C++ scheduler + feature slice + feed
# copy take >= 1.31 ms per batch-512 step on the host, so the reference
# samples at most 512 / 1.31 ms = 3.9e5 edges/s (GPU compute excluded)
REFERENCE_EDGES_PER_S = 3.9e5
PROFILE_STEPS = 10
# the convergence check of bench.py:134-158,344-348
SBM_KW = dict(num_nodes=65536, num_classes=41, feature_dim=602,
              mean_degree=25, p_in=0.7, snr=0.04, seed=0, max_degree=64)
CONVERGE_CFG = dict(dataset="sbm_reddit", batch_size=512, degree=1,
                    test_degree=10000, cv=True, test_cv=True, hidden1=128,
                    normalization="graphsage", layer_norm=True,
                    num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                    test_batch_size=2048, pad_degree=64, seed=1)
CONVERGE_EPOCHS, CONVERGE_F1 = 15, 0.90
SPIN_CYCLES = 50_000_000     # ~25 ms at the H100's ~2 GHz SM clock
# the H100's published peaks (SXM data sheet): device memory rate, and
# float32 rate outside the tensor cores (the kernels' multiply-adds)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SPLITS = (1, 2, 4, 8)        # warps per output row of the split kernel


def kernel_bytes(kind: str, live_rows: float, row_bytes: int, f: int,
                 k: int, d: int, rows_out: int) -> float:
    """Bytes a kernel must move for one call, each input read once and each
    output written once.  ``kind`` "gather" (both forward kernels):
    ``live_rows`` table rows of ``row_bytes`` (the distinct rows under a
    live slot, ``w != 0`` and the index in range as the kernels define it:
    a row that several slots name is read from memory once), the int32
    index and float32 weight arrays ``[f, k]``, and the float32 output
    ``[rows_out, d]``.  ``kind`` "backward": the float32 gradient
    ``[f, d]``, the same slot arrays, and all of the float32
    ``grad_x [rows_out, d]`` written once."""
    slot_arrays = f * k * (4 + 4)
    if kind == "backward":
        return f * d * 4 + slot_arrays + rows_out * d * 4
    if kind != "gather":
        raise ValueError(f"unknown kernel kind {kind!r}")
    return live_rows * row_bytes + slot_arrays + rows_out * d * 4


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over its
    memory rate and float32 operations over its rate for them, and which
    of the two it is."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, TF32 off")


def phase_build() -> None:
    from stochastic_gcn_tpu_torch.ops import _build
    path, seconds, log = _build.build()
    _build.library()
    print(f"build: {seconds:.2f} s -> {path.relative_to(ROOT)}")
    kernel = "?"         # the entry function the next ptxas lines describe
    for line in log.splitlines():
        m = re.search(r"(row_gather_kernel|split_gather_kernel|"
                      r"fanout_backward_coop_kernel)I"
                      r"((?:Li\d+E)+)E", line)
        if "Compiling entry function" in line:
            kernel = "empty_kernel" if "empty_kernel" in line else "?"
            if m:
                args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
                kernel = f"{m.group(1)}<{args}>"
        elif "Used" in line or "spill" in line:
            print(f"build: ptxas {kernel}: {line.strip()}")


def _device_ms(fn, calls: int = 32, reps: int = 5) -> float:
    """Device time per call: ``calls`` back-to-back calls ``fn(i)`` between
    two CUDA events, queued behind a spin kernel so that the host's time to
    enqueue them (a wrapper's checks and ctypes call, the plain version's
    dispatch) stays out of the window.  Median over ``reps`` windows."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    spin, times = SPIN_CYCLES, []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        covered = not start.query()   # the spin still ran: all were queued
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end) / calls)
        elif spin >= 16 * SPIN_CYCLES:
            fail("cannot queue the timed calls ahead of the device")
        else:
            spin *= 2
    return statistics.median(times)


def _host_ms(fn, calls: int = 200) -> float:
    """Host time per wrapper call: checks, allocation and the launch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * seconds / calls


def _live(idx, w, rows: int):
    """The slots a kernel reads: non-zero weight and an index in range."""
    return (w != 0) & (idx >= 0) & (idx < rows)


def _agree(name: str, got, want, atol: float, rtol: float) -> float:
    err = (got.float() - want).abs()
    if not (torch.isfinite(got).all()
            and (err <= atol + rtol * want.abs()).all()):
        fail(f"{name}: disagrees with the plain version, max abs err "
             f"{err.max().item():.3e}")
    return err.max().item()


def _library_gather(table, sets, wants):
    """The one PyTorch call nearest to both forward kernels:
    ``embedding_bag`` with per-sample weights, dead slots remapped (outside
    the timed window) to a padding row appended to the table.  On a
    float32 table it computes the same function; a bfloat16 table needs
    bfloat16 weights and is summed in bfloat16, so there it is only the
    nearest call."""
    pad = table.shape[0]
    ext = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    prepared = [(torch.where(_live(idx, w, pad), idx, pad).contiguous(),
                 w.to(table.dtype)) for idx, w in sets]

    def call(i):
        idx, w = prepared[i % len(prepared)]
        return F.embedding_bag(idx, ext, per_sample_weights=w, mode="sum",
                               padding_idx=pad)

    exact = table.dtype == torch.float32
    for i, want in enumerate(wants):
        _agree("library embedding_bag", call(i), want,
               *(KERNEL_TOL if exact else (5e-2, 5e-2)))
    return call, ("embedding_bag" if exact
                  else "embedding_bag, nearest call, bf16 sums")


def _library_backward(rows: int):
    """No single call does the masked weighted scatter-add:
    ``zeros.index_add_`` alone, with the products ``w * g`` made outside
    the timed window."""
    def make(g, sets, wants):
        prepared = []
        for pos, w in sets:
            live = _live(pos, w, rows)
            contrib = torch.where(live, w, 0.0).unsqueeze(-1) * g.unsqueeze(1)
            prepared.append((torch.where(live, pos, 0).long().reshape(-1),
                             contrib.reshape(-1, g.shape[1]).contiguous()))

        def call(i):
            pos, contrib = prepared[i % len(prepared)]
            return torch.zeros((rows, g.shape[1]), dtype=g.dtype,
                               device=g.device).index_add_(0, pos, contrib)

        for i, want in enumerate(wants):
            _agree("library index_add_", call(i), want, *KERNEL_TOL)
        return call, "index_add_ alone, product excluded"
    return make


def _compare(name, kernel, ref, table, sets, timing: bool,
             kind: str = "gather", rows: int | None = None, library=None):
    """Kernel vs plain version on every ``(idx, w)`` of ``sets``; timed
    calls cycle through the sets, so consecutive calls read other rows.
    ``rows`` bounds a live index (default: the table's rows; for the
    backward, whose ``table`` is the output gradient, the rows of
    ``grad_x``).  Timed cases also get their bound (``kernel_bytes`` of
    these inputs, each distinct live row once, over the card's memory
    rate, or the live slots' multiply-adds over its float32 rate) and the
    time of ``library(table, sets, wants)``'s call."""
    rows = table.shape[0] if rows is None else rows
    worst, wants = 0.0, []
    for idx, w in sets:
        out = kernel(table, idx, w)
        want = ref(table.float(), idx, w)
        torch.cuda.synchronize()
        worst = max(worst, _agree(name, out, want, *KERNEL_TOL))
        wants.append(want)
    res = {"max_abs_err": worst}
    if timing:
        def call(fn):
            return lambda i: fn(table, *sets[i % len(sets)])
        res["ms"] = _device_ms(call(kernel))
        res["plain_ms"] = _device_ms(call(ref))
        res["host_ms"] = _host_ms(call(kernel))
        masks = [_live(idx, w, rows) for idx, w in sets]
        live = sum(int(m.sum()) for m in masks) / len(sets)
        distinct = sum(torch.unique(idx[m]).numel()
                       for (idx, _), m in zip(sets, masks)) / len(sets)
        f, k = sets[0][0].shape
        d = table.shape[1]
        row_bytes = d * table.element_size()
        res["gb_s"] = live * row_bytes / (res["ms"] * 1e6)
        res["live"], res["distinct"] = live, distinct
        res["bytes"] = kernel_bytes(kind, distinct, row_bytes, f, k, d,
                                    rows if kind == "backward" else f)
        res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"],
                                                    2 * live * d)
        res["library_ms"], res["library"] = None, "none"
        if library is not None:
            lib_call, res["library"] = library(table, sets, wants)
            res["library_ms"] = _device_ms(lib_call)
    return res


MAIN_KEYS = ("ms", "plain_ms", "host_ms", "bound_ms", "bound_by",
             "library_ms")


def _report(results: dict, kname: str, case: str, res: dict,
            main: bool = False) -> None:
    """Print one case and fold it into ``results[kname]``: the worst error
    of every case, and the times of the ``main`` case (the main path's own
    inputs), which the kernels JSON line reports."""
    agg = results[kname]
    agg["max_abs_err"] = max(agg.get("max_abs_err", 0.0), res["max_abs_err"])
    if main:
        agg.update((key, res[key]) for key in MAIN_KEYS)
    times = ""
    if "ms" in res:
        lib = ("none" if res["library_ms"] is None else
               f"{res['library_ms']:.5f} ms/call ({res['library']})")
        times = (f"; device {res['ms']:.5f} ms/call ({res['gb_s']:.0f} GB/s "
                 f"of live slots) vs plain {res['plain_ms']:.5f} ms/call; "
                 f"bound {res['bound_ms']:.5f} ms ({res['bytes'] / 1e6:.3f} "
                 f"MB: {res['distinct']:.0f} distinct rows under "
                 f"{res['live']:.0f} live slots; by {res['bound_by']}) = "
                 f"{res['bound_ms'] / res['ms']:.3f} of the time; library "
                 f"{lib}; wrapper host {res['host_ms']:.5f} ms/call")
    print(f"kernels: {kname} {case}: max abs err "
          f"{res['max_abs_err']:.3e}{times}")


def _gather_splits(label: str, table, sets) -> None:
    """Every split of the gather kernel on ``sets`` (0: one warp per row):
    held against the plain version, then timed like the public function."""
    f, k = sets[0][0].shape
    wants = [K.hbm_gather_aggregate_ref(table.float(), idx, w)
             for idx, w in sets]
    cells = []
    for split in (0, *SPLITS):
        def call(i, split=split):
            return K.gather_aggregate_split(table, *sets[i % len(sets)],
                                            split)
        for i, want in enumerate(wants):
            _agree(f"{label} split {split}", call(i), want, *KERNEL_TOL)
        cells.append(f"{'row' if split == 0 else f'x{split}'} "
                     f"{_device_ms(call):.5f}")
    print(f"kernels: splits, {label}, device ms/call: {'; '.join(cells)}; "
          f"the public function plans split "
          f"{K.gather_plan(table, f, k)} (0 = row)")


def _gather_edge_cases(rng, dev) -> float:
    """Every split, and the public function, on the shapes the split must
    get right: K not a multiple of the split, K below the
    warps per row, K = 1, a row whose slots are all dead, F = 1, and
    F = 132 * 8 + 1, at 128-, 256- and 512-byte rows.  Returns the worst
    error."""
    worst = 0.0
    for d, dtype in [(64, torch.bfloat16), (64, torch.float32),
                     (128, torch.bfloat16), (128, torch.float32)]:
        table = torch.from_numpy(rng.normal(size=(5008, d)).astype(
            np.float32)).to(dev, dtype)
        table[5000] = float("nan")        # a dead slot must never be read
        for f, k in [(37, 50), (9, 3), (512, 1), (1, 64), (132 * 8 + 1, 64)]:
            w = rng.uniform(0.0, 2.0 / k, (f, k)).astype(np.float32)
            if k > 1:
                w[rng.random((f, k)) < 0.3] = 0.0
            w[f // 2] = 0.0               # a row whose slots are all dead
            idx = rng.integers(0, 5000, (f, k)).astype(np.int32)
            idx[w == 0] = 5000
            idx, w = torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)
            want = K.hbm_gather_aggregate_ref(table.float(), idx, w)
            outs = [K.hbm_gather_aggregate(table, idx, w)]
            outs += [K.gather_aggregate_split(table, idx, w, split)
                     for split in (0, *SPLITS)]
            torch.cuda.synchronize()
            for out in outs:
                worst = max(worst, _agree(
                    f"gather edge case d={d} {dtype} F={f} K={k}", out, want,
                    *KERNEL_TOL))
            if outs[0][f // 2].abs().max().item() != 0.0:
                fail("an all-dead row did not come out zero")
    return worst


def phase_kernels(seed: int = 0) -> dict:
    """Kernel vs plain version on the card; returns per-kernel results."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    results = {name: {} for name in REPLACES}

    def report(kname, case, res):
        _report(results, kname, case, res)

    # the floor under any single launch, in the same 32-call window
    floor_ms = _device_ms(lambda i: K.empty_launch(dev))
    print(f"kernels: launch_floor_ms {floor_ms:.5f} (an empty kernel, device "
          f"ms/call in the same window; the K=1 fanout shapes are read "
          f"against it)")

    def full_term_inputs(f, k, n_nodes, n_sets=1):
        # ~30% zero-weight slots, all pointing at the sentinel row N
        sets = []
        for _ in range(n_sets):
            w = rng.uniform(0.0, 2.0 / k, (f, k)).astype(np.float32)
            w[rng.random((f, k)) < 0.3] = 0.0
            idx = rng.integers(0, n_nodes, (f, k)).astype(np.int32)
            idx[w == 0] = n_nodes
            sets.append((torch.from_numpy(idx).to(dev),
                         torch.from_numpy(w).to(dev)))
        return sets

    n_nodes, d = HIST_ROWS - 8, 128
    table = torch.from_numpy(
        rng.normal(size=(HIST_ROWS, d)).astype(np.float32)).to(dev)
    table[n_nodes] = float("nan")     # a masked slot must never be read
    hbm, hbm_ref = K.hbm_gather_aggregate, K.hbm_gather_aggregate_ref
    bf16 = table.to(torch.bfloat16)
    # training: the bf16 train history, F = batch 512, K = the train
    # graph's pad degree (64 at the recipe)
    train_sets = full_term_inputs(512, 64, n_nodes, n_sets=4)
    report("hbm_gather_aggregate", "bf16 [233008,128] F=512 K=64 (training)",
           _compare("full bf16 training", hbm, hbm_ref, bf16, train_sets,
                    True, library=_library_gather))
    _gather_splits("bf16 [233008,128] F=512 K=64", bf16, train_sets)
    # serving: the f32 eval history (and bf16), F = test batch 2048
    sets = full_term_inputs(2048, 64, n_nodes, n_sets=4)
    report("hbm_gather_aggregate", "f32 [233008,128] F=2048 K=64",
           _compare("full f32", hbm, hbm_ref, table, sets, True,
                    library=_library_gather))
    _gather_splits("f32 [233008,128] F=2048 K=64", table, sets)
    res = _compare("full bf16", hbm, hbm_ref, bf16, sets, True,
                   library=_library_gather)
    report("hbm_gather_aggregate", "bf16 [233008,128] F=2048 K=64", res)
    _gather_splits("bf16 [233008,128] F=2048 K=64", bf16, sets)
    # the fixed sum order: two runs on the same inputs are bitwise equal
    if not torch.equal(hbm(bf16, *train_sets[0]), hbm(bf16, *train_sets[0])):
        fail("the full term is not bitwise reproducible from run to run")
    print(f"kernels: gather edge cases (K not a multiple of the split, "
          f"K < warps per row, K=1, an all-dead row, F=1, F=1057; bf16 and "
          f"f32 at d=64 and 128; every split): max abs err "
          f"{_gather_edge_cases(rng, dev):.3e}; the full term is bitwise "
          f"reproducible")
    report("hbm_gather_aggregate", "f32 ragged F=13 K=64",
           _compare("full ragged", hbm, hbm_ref, table,
                    full_term_inputs(13, 64, n_nodes), False))
    # wider rows: 2, 3 and 4 sixteen-byte chunks per lane, f32 and bf16
    for wide_d, dtype in [(256, torch.float32), (384, torch.float32),
                          (512, torch.float32), (512, torch.bfloat16),
                          (1024, torch.bfloat16)]:
        wide = torch.from_numpy(rng.normal(size=(5008, wide_d)).astype(
            np.float32)).to(dev, dtype)
        wide[5000] = float("nan")
        report("hbm_gather_aggregate",
               f"{str(dtype)[6:]} [5008,{wide_d}] F=64 K=64",
               _compare("full wide", hbm, hbm_ref, wide,
                        full_term_inputs(64, 64, 5000), False))

    fan, fan_ref = K.fanout_aggregate, K.fanout_aggregate_ref
    # training: x [C=1024, 128], F = 512, K = 1, the no-dedup iota 512 + f
    x = torch.from_numpy(rng.normal(size=(1024, d)).astype(np.float32)).to(dev)
    pos1 = (512 + torch.arange(512, dtype=torch.int32, device=dev))[:, None]
    w1 = torch.from_numpy(
        rng.uniform(0.5, 1.5, (512, 1)).astype(np.float32)).to(dev)
    report("fanout_aggregate", "f32 C=1024 F=512 K=1 (training, iota pos)",
           _compare("fanout training", fan, fan_ref, x,
                    [(pos1.contiguous(), w1)], True,
                    library=_library_gather))
    # serving: C = 4096, F = test batch 2048
    c = 4096
    x = torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32)).to(dev)
    pos1 = (2048 + torch.arange(2048, dtype=torch.int32, device=dev))[:, None]
    w1 = torch.from_numpy(
        rng.uniform(0.5, 1.5, (2048, 1)).astype(np.float32)).to(dev)
    report("fanout_aggregate", "f32 C=4096 F=2048 K=1",
           _compare("fanout K=1", fan, fan_ref, x,
                    [(pos1.contiguous(), w1)], True,
                    library=_library_gather))
    pos8 = rng.integers(0, c, (2048, 8)).astype(np.int32)
    pos8[rng.random((2048, 8)) < 0.1] = 1 << 30      # parked positions
    w8 = rng.uniform(0.0, 0.25, (2048, 8)).astype(np.float32)
    w8[rng.random((2048, 8)) < 0.2] = 0.0
    report("fanout_aggregate", "f32 C=4096 F=2048 K=8, pos >= C",
           _compare("fanout K=8", fan, fan_ref, x,
                    [(torch.from_numpy(pos8).to(dev),
                      torch.from_numpy(w8).to(dev))], False))
    report("fanout_aggregate", "f32 ragged F=13 K=8",
           _compare("fanout ragged", fan, fan_ref, x,
                    [(torch.from_numpy(pos8[:13].copy()).to(dev),
                      torch.from_numpy(w8[:13].copy()).to(dev))], False))

    # the backward at the training shape: x [C=1024, 128], F=512, K=1 with
    # the no-dedup iota pos = 512 + f
    def backward_inputs(c, f, k, d, iota=False):
        g = torch.from_numpy(rng.normal(size=(f, d)).astype(np.float32))
        w = rng.uniform(0.1, 1.0, (f, k)).astype(np.float32)
        if iota:
            pos = (c - f + np.arange(f, dtype=np.int32))[:, None].copy()
        else:     # repeats (atomic contention), parked slots, zero weights
            pos = rng.integers(0, c // 4, (f, k)).astype(np.int32)
            pos[rng.random((f, k)) < 0.1] = 1 << 30
            w[rng.random((f, k)) < 0.2] = 0.0
        return (g.to(dev), torch.from_numpy(pos).to(dev),
                torch.from_numpy(w).to(dev))

    bwd, bwd_ref = K.fanout_aggregate_backward, K.fanout_aggregate_backward_ref
    for case, c, args, timing in [
            ("C=1024 F=512 K=1 d=128 (iota pos)", 1024,
             backward_inputs(1024, 512, 1, 128, iota=True), True),
            ("C=1024 F=512 K=8 d=128, repeated/parked/zero", 1024,
             backward_inputs(1024, 512, 8, 128), False),
            ("ragged F=13 K=8 d=128", 1024,
             backward_inputs(1024, 13, 8, 128), False),
            ("C=300 F=64 K=8 d=256", 300, backward_inputs(300, 64, 8, 256),
             False),
            ("C=300 F=64 K=8 d=512", 300, backward_inputs(300, 64, 8, 512),
             False),
            ("C=300 F=1 K=8 d=128", 300, backward_inputs(300, 1, 8, 128),
             False),
            # more rows and more of grad_x than one resident grid covers
            ("C=40000 F=9000 K=2 d=128", 40000,
             backward_inputs(40000, 9000, 2, 128), False)]:
        if not timing:
            args[2][args[0].shape[0] // 2] = 0.0     # a row with no live slot
        report("fanout_aggregate_backward", case,
               _compare(f"backward {case}", lambda g, p, w, c=c: bwd(g, p, w, c),
                        lambda g, p, w, c=c: bwd_ref(g, p, w, c),
                        args[0], [args[1:]], timing, kind="backward", rows=c,
                        library=_library_backward(c)))

    # the gradient through FanoutAggregate (both kernels) against autograd
    # through the plain forward
    g, pos, w = backward_inputs(1024, 512, 8, 128)
    x = torch.from_numpy(rng.normal(size=(1024, 128)).astype(
        np.float32)).to(dev)
    xk, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    K.fanout_aggregate(xk, pos, w).backward(g)
    K.fanout_aggregate_ref(xr, pos, w).backward(g)
    torch.cuda.synchronize()
    err = (xk.grad - xr.grad).abs()
    if not (err <= KERNEL_TOL[0] + KERNEL_TOL[1] * xr.grad.abs()).all():
        fail(f"FanoutAggregate gradient disagrees with autograd through the "
             f"plain forward, max abs err {err.max().item():.3e}")
    print(f"kernels: FanoutAggregate gradient vs autograd through the plain "
          f"forward: max abs err {err.max().item():.3e}")
    return results


def exact_probs(tr: Trainer, ids: np.ndarray, chunk: int = 8192):
    """Exact inference with the plain versions: the dense chain on every
    node, ``A_full . H`` over all rows in chunks, then the head."""
    spec, g = tr.test_spec, tr.graph_full
    with torch.no_grad():
        h = tr.test_features
        for s in spec.specs:
            if isinstance(s, M.DenseSpec):
                h = L.dense(tr.params[s.name], h,
                            L.relu if s.relu else L.identity, s.norm)
            elif isinstance(s, M.AggSpec):
                rows = h.shape[0]
                a = torch.cat([K.hbm_gather_aggregate_ref(
                    h, g.nbr[i:i + chunk], g.w[i:i + chunk])
                    for i in range(0, rows, chunk)])
                h = torch.cat([h, a], dim=1)
        return M.predict(spec, h[torch.from_numpy(ids).to(h.device).long()])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_gib(device) -> float:
    if torch.device(device).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2 ** 30


def phase_train(ds, device: str = "cuda", cfg_kw=SLICE_CFG):
    """A warm-up epoch, then one timed epoch with the counters reset just
    before it.  Returns (trainer, launch counts of the timed epoch, its
    steps)."""
    cfg = Config(**cfg_kw)
    t0 = time.perf_counter()
    tr = Trainer(cfg, ds, device=device)
    t_setup = time.perf_counter() - t0
    hist = tr.state.histories[0][0]
    print(f"train: {ds.num_data} nodes, {ds.train_adj.nnz} train / "
          f"{ds.full_adj.nnz} full edges; Trainer set-up {t_setup:.2f} s "
          f"(train history {tuple(hist.shape)} {str(hist.dtype)[6:]}, train "
          f"graph padded to {tr.graph_train.pad_degree})")
    t0 = time.perf_counter()
    warm_loss = tr.train_epoch()[0]
    _sync(device)
    warm_s = time.perf_counter() - t0

    K.reset_launches()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    amt0 = tr.amt_data
    _sync(device)
    t0 = time.perf_counter()
    loss, acc, _, steps = tr.train_epoch()
    _sync(device)
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    edges = tr.amt_data - amt0
    rate = edges / secs
    print(f"train: warm-up epoch {warm_s:.3f} s (last loss {warm_loss:.5f});"
          f" timed epoch {steps} steps in {secs:.3f} s -> "
          f"{1e3 * secs / steps:.3f} ms/step, {steps / secs:.1f} steps/s; "
          f"{edges} sampled edges -> {rate:.0f} edges/s = "
          f"{rate / REFERENCE_EDGES_PER_S:.3f}x the reference's host bound "
          f"({REFERENCE_EDGES_PER_S:.1e} edges/s, BASELINE.md); last loss "
          f"{loss:.5f}, accuracy {acc:.5f}; peak device memory "
          f"{_peak_gib(device):.3f} GiB")
    print(f"train: kernel launches {launches} = "
          f"{ {k: v / steps for k, v in launches.items()} } per step")
    if not np.isfinite(loss):
        fail(f"non-finite training loss {loss}")
    low = {k: v for k, v in launches.items() if v < steps}
    if low:
        fail(f"kernels launched less than once per step ({steps}): {low}")
    return tr, launches, steps


def phase_train_kernels(tr: Trainer, results: dict, batches: int = 4,
                        seed: int = 1) -> None:
    """The three kernels on the slots of ``batches`` real scheduled batches
    of the training recipe, against their plain versions and timed: the
    fanout and its backward on the layer's sampled slots, the full term on
    the trained bf16 history with the train graph's rows of the output
    field.  The fanout reads the history rows of the first batch's input
    field and the backward a seeded gradient.  These times are the kernels
    JSON line's."""
    bs, n = tr.cfg.batch_size, tr.ds.num_data
    bm = torch.from_numpy(tr._batch_matrix(
        tr.train_iter.data[:batches * bs], bs, n)).to(tr.device)
    hist = tr.state.histories[0][0]
    packs = [schedule(tr.gen, tr.graph_train, ids, tr.train_degrees, True,
                      dedup=tr.cfg.field_dedup) for ids in bm]
    c, f = packs[0].fields[0].shape[0], packs[0].fields[1].shape[0]
    slots = [(p.layers[0].slot_pos, p.layers[0].slot_w) for p in packs]
    full = [graph_rows(tr.graph_train, p.fields[1])[:2] for p in packs]
    k_full = full[0][0].shape[1]
    x = row_gather(hist, packs[0].fields[0], sentinel=n).float()
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(f, hist.shape[1])).astype(np.float32)).to(tr.device)
    k_fan = slots[0][0].shape[1]
    _report(results, "fanout_aggregate",
            f"train batch: f32 C={c} F={f} K={k_fan}",
            _compare("fanout train batch", K.fanout_aggregate,
                     K.fanout_aggregate_ref, x, slots, True,
                     library=_library_gather), main=True)
    _report(results, "fanout_aggregate_backward",
            f"train batch: C={c} F={f} K={k_fan} d={g.shape[1]}",
            _compare("backward train batch",
                     lambda g_, p, w: K.fanout_aggregate_backward(g_, p, w, c),
                     lambda g_, p, w: K.fanout_aggregate_backward_ref(
                         g_, p, w, c), g, slots, True, kind="backward",
                     rows=c, library=_library_backward(c)), main=True)
    _report(results, "hbm_gather_aggregate",
            f"train batch: bf16 history {list(hist.shape)} F={f} "
            f"K={k_full}",
            _compare("full term train batch", K.hbm_gather_aggregate,
                     K.hbm_gather_aggregate_ref, hist, full, True,
                     library=_library_gather), main=True)
    _gather_splits(f"train batch: bf16 history F={f} K={k_full}", hist,
                     full)


def phase_profile(tr: Trainer, steps: int = PROFILE_STEPS) -> None:
    """``steps`` more train steps, first timed without the profiler, then
    under ``torch.profiler``: the top device ops, kernels per step and the
    device's busy share of the unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bs, n = tr.cfg.batch_size, tr.ds.num_data
    bm = torch.from_numpy(tr._batch_matrix(
        tr.train_iter.data[:steps * bs], bs, n)).to(tr.device)

    def run():
        tr.state, _ = tr._train_epoch(tr.state, tr.graph_train,
                                      tr.train_features, tr.labels, bm,
                                      tr.gen)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kernels:
        print("profile: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profile: {steps} train steps, {wall_ms / steps:.3f} ms/step "
          f"unprofiled; device busy {busy_ms / steps:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 - 100 * busy_ms / wall_ms:.1f}% idle); "
          f"{launches / steps:.1f} device kernels per step")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"profile:   {dev_us(e) / steps:9.2f} us/step "
              f"{e.count / steps:5.1f}x  {e.key[:90]}")
    # the host side: operators by their own CPU time (profiled, so
    # inflated), with the device time of the kernels they launched
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        dev_total = getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0))
        print(f"profile:   host {e.self_cpu_time_total / steps:8.1f} us/step"
              f" {e.count / steps:5.1f}x  device {dev_total / steps:7.1f} "
              f"us/step  {e.key}")


def phase_slice(tr: Trainer, n_ids: int = REQUEST_IDS) -> dict:
    """Serve from ``tr``'s current (trained) weights."""
    ds, cfg, device = tr.ds, tr.cfg, tr.device
    requests = [ds.test_d[i * n_ids:(i + 1) * n_ids] for i in range(REQUESTS)]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    times, outs, first = [], [], None
    for ids in requests:
        t0 = time.perf_counter()
        outs.append(tr.predict(ids))
        _sync(device)
        times.append(time.perf_counter() - t0)
        first = first or dict(K.LAUNCHES)    # the refresh and one request
    launches = dict(K.LAUNCHES)
    per_request = {k: (launches[k] - first[k]) / (len(requests) - 1)
                   for k in launches}
    refresh = {k: first[k] - per_request[k] for k in launches}
    later_ms = 1e3 * statistics.median(times[1:])

    # the first request also paid one-time warm-up: time the refresh
    # again, warm, outside the counted run
    t0 = time.perf_counter()
    tr.predict(requests[0], refresh="force")
    _sync(device)
    refresh_s = time.perf_counter() - t0 - later_ms / 1e3
    print(f"slice: first request {times[0]:.3f} s (refresh + one-time "
          f"warm-up); warm refresh {refresh_s:.3f} s ({cfg.num_layers} passes"
          f" over {ds.num_data} nodes); later requests "
          f"{', '.join(f'{1e3 * t:.2f}' for t in times[1:])} ms -> "
          f"{later_ms:.2f} ms/request, {n_ids / later_ms * 1e3:.0f} nodes/s; "
          f"peak device memory {_peak_gib(device):.3f} GiB (train state "
          f"resident)")
    print(f"slice: kernel launches {launches} = {per_request} per later "
          f"request, and {refresh} for the refresh")

    worst = 0.0
    for ids, probs in zip(requests, outs):
        if probs.shape != (len(ids), ds.num_classes):
            fail(f"predict shape {probs.shape}")
        if not np.isfinite(probs).all():
            fail("non-finite probabilities")
        if np.abs(probs.sum(1) - 1.0).max() > 1e-5:
            fail("probability rows do not sum to 1")
        exact = exact_probs(tr, ids).cpu().numpy()
        worst = max(worst, float(np.abs(probs - exact).max()))
    print(f"slice: max |predict - exact inference| = {worst:.3e} "
          f"(atol {SLICE_ATOL}), from the trained weights")
    if worst > SLICE_ATOL:
        fail("CV predictions differ from exact inference")
    missing = [k for k in ("fanout_aggregate", "hbm_gather_aggregate")
               if launches[k] == 0]
    if missing:
        fail(f"the serving path never launched {missing}")
    if launches["fanout_aggregate_backward"]:
        fail("serving launched the backward kernel")
    return per_request


def phase_converge(device: str = "cuda", sbm_kw=SBM_KW, cfg_kw=CONVERGE_CFG,
                   max_epochs: int = CONVERGE_EPOCHS,
                   target: float = CONVERGE_F1) -> None:
    """CV+PP on the community SBM until ``max_epochs``; fails unless the
    best val micro-F1 reaches ``target``."""
    t0 = time.perf_counter()
    ds = community_sbm_dataset(**sbm_kw)
    t_graph = time.perf_counter() - t0
    tr = Trainer(Config(**cfg_kw), ds, device=device)
    print(f"converge: SBM {ds.num_data} nodes, {ds.full_adj.nnz} edges, "
          f"built in {t_graph:.2f} s; {len(ds.train_d)} train / "
          f"{len(ds.val_d)} val ids")
    train_s, curve, hit = 0.0, [], None
    for epoch in range(max_epochs):
        _sync(device)
        t0 = time.perf_counter()
        tr.train_epoch()
        _sync(device)
        train_s += time.perf_counter() - t0
        f1 = tr.evaluate(ds.val_d)[2]
        curve.append(f1)
        if hit is None and f1 >= target:
            hit = (epoch + 1, train_s)
    print(f"converge: val micro-F1 by epoch "
          f"{', '.join(f'{f:.4f}' for f in curve)}")
    reached = (f"reached {target} at epoch {hit[0]} after {hit[1]:.3f} s of "
               f"training" if hit else f"never reached {target}")
    print(f"converge: best {max(curve):.4f}; {reached}; {max_epochs} epochs "
          f"trained in {train_s:.3f} s")
    if max(curve) < target:
        fail(f"CV+PP val micro-F1 {max(curve):.4f} < {target} in "
             f"{max_epochs} epochs")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    phase_build()
    kernels = phase_kernels()
    t0 = time.perf_counter()
    ds = reddit_like()
    print(f"graph: Reddit-shaped, {ds.num_data} nodes, built in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    tr, launches, steps = phase_train(ds)
    phase_train_kernels(tr, kernels)
    phase_profile(tr)
    per_request = phase_slice(tr)
    del tr
    phase_converge()
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": res["max_abs_err"],
         **{key: res[key] for key in MAIN_KEYS},
         "launches_per_step": launches[name] / steps,
         "launches_per_request": per_request[name]}
        for name, res in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
