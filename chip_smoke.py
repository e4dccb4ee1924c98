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
   through the plain forward.  The CV estimator's sampled term
   (``cv_fanout_aggregate``, the whole control-variate delta in one launch)
   runs at the training shape (C=1024 F=512 K=1, bf16 [233008,128]
   history), the serving shape (C=4096 F=2048 K=1, float32 history) and
   the exhaustive evaluation shape (C=133,120 F=2048 K=64, a float32
   [65544,128] history), and on repeated and parked positions, zero
   weights, sentinel field ids, an all-dead row, all slots parked, a field
   of sentinels only, F=1, F=1057 and K=50 at every row width it is built
   for; beside its time stands the composition it replaces
   (``history_gather``, subtract, ``fanout_aggregate``, add: 8 launches),
   timed in the same window; it must be bitwise equal from run to run and
   its gradient equal autograd's through the plain version.  The
   standalone fanout term also runs at the Exact evaluation's shape
   (C=133,120 F=2048 K=64), the only one a counted path gives it.  Times,
   at the training shapes (fanout C=1024 F=512 K=1, full term on the bf16
   [233008,128] history at F=512 K=64, backward C=1024 F=512 K=1) and the
   serving shapes (F=2048):
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
   device memory and the launch counts; fails unless a step launched
   ``cv_fanout_aggregate``, ``hbm_gather_aggregate`` and
   ``fanout_aggregate_backward`` once each and ``fanout_aggregate`` (the
   estimators without a control variate) not at all, and the loss is
   finite (the launches per step are printed and go into the kernels
   line).  Then the kernels on 4 real scheduled batches of the recipe (the
   layer's sampled slots, the train graph's full rows, the trained bf16
   history), held against their plain versions and timed as in phase 3;
   these times are the kernels JSON line's for the three kernels a train
   step launches.  Then a ``torch.profiler``
   window of 10 more steps: the top device ops, kernels per step and the
   device's busy share.
5. slice — the serving path from the trained weights (test batch 2048):
   ``Trainer.predict`` answers 3 requests of 2048 test ids (the first pays
   the CV history refresh), with the launch counters reset just before.
   Checks finite probability rows summing to 1, the CV path's two forward
   kernels launched (and no other), and predictions equal to exact
   inference computed on the card with the plain versions (atol 1e-4).
   Prints the launches per later request, and those of the refresh apart.
6. converge — the JAX benchmark's convergence check (bench.py:134-158):
   CV+PP at degree 1 on the 65,536-node community SBM, up to 15 epochs;
   fails unless the best val micro-F1 reaches 0.90.  Then the paper's
   Exact test from the same weights (``test_cv=False``, exhaustive test
   degree: ``plain_aggregate``, the standalone fanout kernel at K=64) over
   the validation ids, with the counters reset just before: it must launch
   ``fanout_aggregate`` and nothing else, and its micro-F1 must agree with
   the CV evaluation's within 0.01.  Then that kernel on the slots of 4
   real batches of the Exact evaluation (C=133,120 F=2048 K=64), held
   against its plain version and timed as in phase 3, with every split:
   these are the kernels JSON line's times for ``fanout_aggregate``.

   The kernels phase also runs every entry on rows that are not whole
   16-byte chunks or wider than 2048 bytes (d = 602 with float32 and
   bfloat16 tables, d = 1, 513 and 1433: the same functions by element),
   timed like the rest, on append-only and on dedup-compacted slots
   (repeated positions, ``PARKED_POS``); the standalone fanout at the Exact
   training shape (x [98816, 602], F = 33,280, K = 64), where the plain
   version would materialise 5 GB, is held against it on 1024 of its rows
   (and again in phase 7 on the first layer of a real Exact train batch).
7. estimators — on the same SBM, at full width (hidden 128, 602 features):
   CVD+PP (``cvd``, ``test_cvd``) up to 15 epochs and Exact (exhaustive
   degree, no preprocessing, no control variate: dedup-compacted fields are
   forced and the first layer aggregates 602-wide rows) up to 6, each
   failing unless its best val micro-F1 reaches 0.90; det-dropout+PP for
   one epoch (finite loss).  One epoch of each runs with the counters reset
   just before it, and its launches per step are checked exactly (CVD: 1
   full term, 1 CV kernel, 1 fanout, 1 backward; Exact: 2 fanouts, 1
   backward; det-dropout: 2, 1, 2, 3).  Exact's predictions on 2048
   validation ids must equal a dense computation over the whole graph with
   the plain versions (atol 1e-4).  Then the gradient-variance harness
   (``Trainer.gradient_variance``, 100 resamples of one batch) from the
   trained CV+PP and CVD+PP weights with converged float32 histories, by
   the protocol of scripts/validate_gradvar.py: NS+PP and CV+PP without
   dropout, NS+PP, CV+PP and CVD+PP with it; fails unless CV+PP's forward
   is exact without dropout (bias and stdev < 1e-5), its gradient bias is
   within 3 standard errors while NS+PP's is not, its gradient stdev is
   below NS+PP's, CVD+PP's is below NS+PP's under dropout, and every value
   is finite.

The line before the last is a JSON object describing the kernels (times in
device ms per call on real batches of the path that launches the kernel,
``bound_ms`` and ``bound_by``,
``library_ms``, ``replaced_ms`` where the kernel took over a composition;
``launches`` summed over the counted paths, the train epoch, the
served requests, the Exact evaluation and one train epoch of each of CVD+PP,
Exact and det-dropout+PP, and apart per train step of each estimator and
per later request); the last is ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
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
from stochastic_gcn_tpu_torch.models import aggregators as A
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.ops import cuda_spmm as K
from stochastic_gcn_tpu_torch.ops import layers as L
from stochastic_gcn_tpu_torch.ops.gather import row_gather
from stochastic_gcn_tpu_torch.sampler.scheduler import (PARKED_POS,
                                                        effective_dedup,
                                                        field_capacities,
                                                        schedule)
from stochastic_gcn_tpu_torch.training.loop import Trainer

ROOT = Path(__file__).resolve().parent
SOURCE = "stochastic_gcn_tpu_torch/csrc/spmm.cu"
REPLACES = {"fanout_aggregate": "stochastic_gcn_tpu/ops/pallas_spmm.py:100",
            # the same TPU kernel, redesigned for the CV path: the whole
            # control-variate delta, which the JAX model composes around it
            # (stochastic_gcn_tpu/models/aggregators.py:504-508)
            "cv_fanout_aggregate": "stochastic_gcn_tpu/ops/pallas_spmm.py:100",
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
EXACT_F1_ATOL = 0.01         # the Exact test against the CV evaluation
NO_LIBRARY_CV = "none: no single PyTorch call computes this function"
SPIN_CYCLES = 50_000_000     # ~25 ms at the H100's ~2 GHz SM clock
# the H100's published peaks (SXM data sheet): device memory rate, and
# float32 rate outside the tensor cores (the kernels' multiply-adds)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SPLITS = (1, 2, 4, 8)        # warps per output row of the split kernel
# widths the kernels take by element: raw Reddit-shaped features, one
# column, one column past 128 chunks, Cora's features
WIDE_WIDTHS = (602, 1, 513, 1433)
CVD_EPOCHS, EXACT_EPOCHS = 15, 6
GRADVAR_TIMES = 100
EXACT_DENSE_IDS, EXACT_DENSE_ATOL = 2048, 1e-4
# kernel launches per train step of each estimator
STEP_LAUNCHES = {
    "CV+PP": {"cv_fanout_aggregate": 1, "hbm_gather_aggregate": 1,
              "fanout_aggregate_backward": 1},
    "CVD+PP": {"cv_fanout_aggregate": 1, "hbm_gather_aggregate": 1,
               "fanout_aggregate": 1, "fanout_aggregate_backward": 1},
    # two aggregation layers; the first one's input, the features, takes
    # no gradient
    "Exact": {"fanout_aggregate": 2, "fanout_aggregate_backward": 1},
    "det-dropout+PP": {"cv_fanout_aggregate": 1, "hbm_gather_aggregate": 2,
                       "fanout_aggregate": 2,
                       "fanout_aggregate_backward": 3},
}


def kernel_bytes(kind: str, live_rows: float, row_bytes: int, f: int,
                 k: int, d: int, rows_out: int, hist_rows: float = 0.0,
                 hist_row_bytes: int = 0) -> float:
    """Bytes a kernel must move for one call, each input read once and each
    output written once.  ``kind`` "gather" (both forward kernels):
    ``live_rows`` table rows of ``row_bytes`` (the distinct rows under a
    live slot, ``w != 0`` and the index in range as the kernels define it:
    a row that several slots name is read from memory once), the int32
    index and float32 weight arrays ``[f, k]``, and the float32 output
    ``[rows_out, d]``.  ``kind`` "backward": the float32 gradient
    ``[f, d]``, the same slot arrays, and all of the float32
    ``grad_x [rows_out, d]`` written once.  ``kind`` "cv" (the CV
    estimator's sampled term): ``live_rows`` distinct rows of ``x`` under a
    live slot and the int32 ``field_in`` entry of each, ``hist_rows``
    distinct history rows of ``hist_row_bytes`` (the nodes at those
    positions, below the sentinel), the slot arrays, and the float32
    ``base`` and output ``[rows_out, d]``."""
    slot_arrays = f * k * (4 + 4)
    if kind == "backward":
        return f * d * 4 + slot_arrays + rows_out * d * 4
    if kind == "cv":
        return (live_rows * (row_bytes + 4) + hist_rows * hist_row_bytes
                + slot_arrays + 2 * rows_out * d * 4)
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


def check_launches(path: str, launches: dict, expected: dict) -> None:
    """Fail unless ``launches`` is what ``path`` should have launched:
    ``expected[name]`` is an exact count, or ``None`` for at least one; a
    kernel that is not named must not have launched at all."""
    wrong = {name: count for name, count in launches.items()
             if (count < 1 if name in expected and expected[name] is None
                 else count != expected.get(name, 0))}
    if wrong:
        fail(f"{path}: launches {wrong} of {launches}, expected {expected} "
             f"(None: at least one; not named: none)")


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
        m = re.search(r"(wide_row_gather_kernel|row_gather_kernel|"
                      r"split_gather_kernel|fanout_backward_coop_kernel|"
                      r"fanout_backward_wide_kernel)(?:I(\S*))?", line)
        if "Compiling entry function" in line:
            kernel = "empty_kernel" if "empty_kernel" in line else "?"
            if m and m.group(2) is None:
                kernel = m.group(1)
            elif m:  # a mangled name: the slot source, then the integers
                src = re.search(r"(Table|Cv)(Source|Elems)", m.group(2))
                args = re.findall(r"Li(\d+)E", m.group(2))
                if src:
                    args[0] = f"{src.group(0)}<{args[0]}>"
                kernel = f"{m.group(1)}<{','.join(args)}>"
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
             kind: str = "gather", rows: int | None = None, library=None,
             sentinel: int | None = None, replaced=None):
    """Kernel vs plain version on every ``(idx, w, *more)`` of ``sets``,
    called as ``kernel(table, idx, w, *more)``; timed calls cycle through
    the sets, so consecutive calls read other rows.  ``rows`` bounds a live
    index (default: the table's rows; for the backward, whose ``table`` is
    the output gradient, the rows of ``grad_x``).  For kind "cv" ``table``
    is the history, ``more`` is ``(x, field_in, base)``, ``rows`` the rows
    of ``x`` and ``sentinel`` the node count.  Timed cases also get their
    bound (``kernel_bytes`` of these inputs, each distinct live row once,
    over the card's memory rate, or the live slots' operations over its
    float32 rate), the time of ``library(table, sets, wants)``'s call (or,
    for a string, that note and no time), and the time of ``replaced``,
    the composition the kernel took over, held against the plain version
    like the kernel."""
    rows = table.shape[0] if rows is None else rows
    worst, wants = 0.0, []
    for args in sets:
        out = kernel(table, *args)
        want = ref(table.float(), *args)
        torch.cuda.synchronize()
        worst = max(worst, _agree(name, out, want, *KERNEL_TOL))
        if replaced is not None:
            _agree(f"{name}, the replaced composition",
                   replaced(table, *args), want, *KERNEL_TOL)
        wants.append(want)
    res = {"max_abs_err": worst}
    if timing:
        def call(fn):
            return lambda i: fn(table, *sets[i % len(sets)])
        res["ms"] = _device_ms(call(kernel))
        res["plain_ms"] = _device_ms(call(ref))
        res["host_ms"] = _host_ms(call(kernel))
        if replaced is not None:
            res["replaced_ms"] = _device_ms(call(replaced))
        masks = [_live(args[0], args[1], rows) for args in sets]
        live = sum(int(m.sum()) for m in masks) / len(sets)
        named = [torch.unique(args[0][m]) for args, m in zip(sets, masks)]
        distinct = sum(p.numel() for p in named) / len(sets)
        f, k = sets[0][0].shape
        d = table.shape[1]
        row_bytes = d * table.element_size()
        res["live"], res["distinct"] = live, distinct
        if kind == "cv":       # an x row and, below the sentinel, a history row
            nodes = [args[3][p.long()] for args, p in zip(sets, named)]
            res["hist_distinct"] = sum(
                torch.unique(n[(n >= 0) & (n < sentinel)]).numel()
                for n in nodes) / len(sets)
            res["gb_s"] = live * (4 * d + row_bytes) / (res["ms"] * 1e6)
            res["bytes"] = kernel_bytes(kind, distinct, 4 * d, f, k, d, f,
                                        res["hist_distinct"], row_bytes)
            flops = 3 * live * d + f * d
        else:
            res["gb_s"] = live * row_bytes / (res["ms"] * 1e6)
            res["bytes"] = kernel_bytes(kind, distinct, row_bytes, f, k, d,
                                        rows if kind == "backward" else f)
            flops = 2 * live * d
        res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], flops)
        res["library_ms"], res["library"] = None, "none"
        if isinstance(library, str):
            res["library"] = library
        elif library is not None:
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
        agg.update((key, res.get(key))
                   for key in (*MAIN_KEYS, "library", "replaced_ms"))
    times = ""
    if "ms" in res:
        lib = (res["library"] if res["library_ms"] is None else
               f"{res['library_ms']:.5f} ms/call ({res['library']})")
        hist = (f" and {res['hist_distinct']:.0f} distinct history rows"
                if "hist_distinct" in res else "")
        took_over = (f"; the composition it replaces "
                     f"{res['replaced_ms']:.5f} ms/call"
                     if "replaced_ms" in res else "")
        times = (f"; device {res['ms']:.5f} ms/call ({res['gb_s']:.0f} GB/s "
                 f"of live slots) vs plain {res['plain_ms']:.5f} ms/call"
                 f"{took_over}; "
                 f"bound {res['bound_ms']:.5f} ms ({res['bytes'] / 1e6:.3f} "
                 f"MB: {res['distinct']:.0f} distinct rows{hist} under "
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


def _cv_calls(sentinel: int):
    """The CV estimator's sampled term as ``fn(hist, pos, w, x, field_in,
    base)``: the kernel, its plain version, and the composition the kernel
    took over (8 launches: the history gather's cast, compare, ``where``,
    ``index_select`` and ``masked_fill``, the subtraction, the fanout
    kernel, the addition)."""
    def kernel(hist, pos, w, x, field_in, base):
        return K.cv_fanout_aggregate(x, hist, field_in, sentinel, pos, w,
                                     base)

    def ref(hist, pos, w, x, field_in, base):
        return K.cv_fanout_aggregate_ref(x, hist, field_in, sentinel, pos, w,
                                         base)

    def replaced(hist, pos, w, x, field_in, base):
        delta = x - A.history_gather(hist, field_in, sentinel)
        return K.fanout_aggregate(delta, pos, w) + base

    return kernel, ref, replaced


def _cv_inputs(rng, dev, f: int, k: int, d: int, n_nodes: int,
               live_frac: float, n_sets: int = 1):
    """Slots in the scheduler's append-only layout: slot (f, s) owns
    position F + f*k + s of an input field of C = F + F*k positions; a dead
    slot has zero weight and the sentinel id at its position.  Returns
    ``(pos, w, x, field_in, base)`` tuples."""
    c, sets = f + f * k, []
    for _ in range(n_sets):
        w = (rng.uniform(0.5, 1.5, (f, k)) / k).astype(np.float32)
        w[rng.random((f, k)) >= live_frac] = 0.0
        pos = (f + np.arange(f * k, dtype=np.int32)).reshape(f, k)
        field_in = np.empty(c, np.int32)
        field_in[:f] = rng.integers(0, n_nodes, f)
        field_in[f:] = np.where(w != 0, rng.integers(0, n_nodes, (f, k)),
                                n_nodes).reshape(-1)
        x = rng.standard_normal((c, d), dtype=np.float32)
        base = rng.standard_normal((f, d), dtype=np.float32)
        sets.append(tuple(torch.from_numpy(a).to(dev)
                          for a in (pos, w, x, field_in, base)))
    return sets


def _cv_edge_cases(rng, dev) -> float:
    """The CV kernel on repeated and parked positions, zero weights,
    sentinel field ids over a history whose rows from the sentinel on are
    NaN, an all-dead row, all slots parked, a field of sentinels only,
    F = 1, F = 1057, K = 1 and K = 50, for float32 and bfloat16 histories
    at every row width the kernel is built for.  Returns the worst
    error."""
    worst, n = 0.0, 3000
    for d, dtype in [(32, torch.float32), (64, torch.bfloat16),
                     (64, torch.float32), (128, torch.bfloat16),
                     (128, torch.float32), (256, torch.float32),
                     (256, torch.bfloat16), (384, torch.float32),
                     (512, torch.bfloat16)]:
        hist = torch.from_numpy(rng.standard_normal(
            (n + 8, d), dtype=np.float32)).to(dev, dtype)
        hist[n:] = float("nan")           # never read at or past the sentinel
        kernel, ref, _ = _cv_calls(n)
        for f, k in [(37, 50), (9, 3), (512, 1), (1, 64), (132 * 8 + 1, 64)]:
            c = f * k + 16
            x = rng.standard_normal((c, d), dtype=np.float32)
            x[c // 2:] = np.nan           # only dead and parked slots go there
            field_in = rng.integers(0, n, c).astype(np.int32)
            field_in[rng.random(c) < 0.2] = n
            pos = rng.integers(0, c // 4, (f, k)).astype(np.int32)  # repeats
            w = rng.uniform(0.1, 1.0, (f, k)).astype(np.float32)
            if k > 1:
                dead = rng.random((f, k)) < 0.3
                w[dead], pos[dead] = 0.0, c - 1
                pos[rng.random((f, k)) < 0.1] = 1 << 30              # parked
            w[f // 2] = 0.0               # a row whose slots are all dead
            base = rng.standard_normal((f, d), dtype=np.float32)
            pos, w, x, field_in, base = (
                torch.from_numpy(a).to(dev)
                for a in (pos, w, x, field_in, base))
            cases = {"mixed": (pos, w, x, field_in, base),
                     "all parked": (torch.full_like(pos, 1 << 30), w, x,
                                    field_in, base),
                     "all sentinel": (pos, w, x, torch.full_like(field_in, n),
                                      base)}
            for case, args in cases.items():
                label = f"cv edge case {case} d={d} {dtype} F={f} K={k}"
                got = kernel(hist, *args)
                worst = max(worst, _agree(label, got, ref(hist.float(), *args),
                                          *KERNEL_TOL))
                if case == "all parked" and not torch.equal(got, base):
                    fail(f"{label}: base did not come through unchanged")
            if not torch.equal(kernel(hist, *cases["mixed"])[f // 2],
                               base[f // 2]):
                fail("an all-dead row did not come out as base")
    return worst


def phase_cv_kernel(rng, dev, results: dict, train_hist) -> None:
    """The CV estimator's sampled term against its plain version and the
    composition it replaces, at the training, serving and exhaustive
    evaluation shapes; its edge cases; reproducibility; its gradient."""
    d = train_hist.shape[1]
    n_train = HIST_ROWS - 8
    n_eval = SBM_KW["num_nodes"]
    eval_hist = torch.from_numpy(rng.standard_normal(
        (n_eval + 8, d), dtype=np.float32)).to(dev)
    eval_hist[n_eval:] = float("nan")
    for case, hist, n, (f, k), live, n_sets in [
            ("training: bf16 [233008,128] history, C=1024 F=512 K=1",
             train_hist, n_train, (512, 1), 1.0, 4),
            ("serving: f32 [233008,128] history, C=4096 F=2048 K=1",
             train_hist.float(), n_train, (2048, 1), 1.0, 4),
            # the SBM's mean degree 25 of 64 padded slots
            ("exhaustive evaluation: f32 [65544,128] history, C=133120 "
             "F=2048 K=64", eval_hist, n_eval, (2048, 64), 25 / 64, 1)]:
        sets = _cv_inputs(rng, dev, f, k, d, n, live, n_sets)
        kernel, ref, replaced = _cv_calls(n)
        _report(results, "cv_fanout_aggregate", case,
                _compare(f"cv {case}", kernel, ref, hist, sets, True,
                         kind="cv", rows=f + f * k, sentinel=n,
                         library=NO_LIBRARY_CV, replaced=replaced))
    # the last case's inputs: the exhaustive evaluation shape
    if not torch.equal(kernel(eval_hist, *sets[0]),
                       kernel(eval_hist, *sets[0])):
        fail("the CV kernel is not bitwise reproducible at K=64")
    print(f"kernels: cv edge cases (repeated and parked positions, zero "
          f"weights, sentinel field ids, an all-dead row, all slots parked, "
          f"a field of sentinels only, F=1, F=1057, K=1, K=50; f32 and "
          f"bf16 histories at d=32..512): max abs err "
          f"{_cv_edge_cases(rng, dev):.3e}; bitwise reproducible at K=64")

    # the gradient through CVFanoutAggregate (this kernel forward, the
    # fanout backward kernel) against autograd through the plain version
    pos, w, x, field_in, base = _cv_inputs(rng, dev, 512, 8, d, n_train,
                                           0.7)[0]
    pos = torch.randint(0, 1024, pos.shape, dtype=torch.int32,
                        device=dev)          # repeats: atomic contention
    g = torch.from_numpy(rng.standard_normal((512, d), dtype=np.float32)
                         ).to(dev)
    xk, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    K.cv_fanout_aggregate(xk, train_hist, field_in, n_train, pos, w,
                          base).backward(g)
    K.cv_fanout_aggregate_ref(xr, train_hist, field_in, n_train, pos, w,
                              base).backward(g)
    torch.cuda.synchronize()
    err = (xk.grad - xr.grad).abs()
    if not (err <= KERNEL_TOL[0] + KERNEL_TOL[1] * xr.grad.abs()).all():
        fail(f"CVFanoutAggregate gradient disagrees with autograd through "
             f"the plain version, max abs err {err.max().item():.3e}")
    print(f"kernels: CVFanoutAggregate gradient vs autograd through the "
          f"plain version: max abs err {err.max().item():.3e}")


def _compacted_slots(rng, dev, f: int, k: int, c: int, live_frac: float):
    """Slots as a dedup-compacted field gives them: several slots name one
    position, and a dead slot has zero weight and the parked position."""
    w = (rng.uniform(0.5, 1.5, (f, k)) / k).astype(np.float32)
    dead = rng.random((f, k)) >= live_frac
    w[dead] = 0.0
    pos = rng.integers(0, c, (f, k)).astype(np.int32)
    pos[dead] = PARKED_POS
    return torch.from_numpy(pos).to(dev), torch.from_numpy(w).to(dev)


def _fanout_on_row_subset(results: dict, case: str, x, pos, w,
                          sub: int = 1024) -> None:
    """The standalone fanout at a shape where the plain version would
    materialise ``[F*K, d]`` float32 of several GB: the kernel runs on
    every row, is held against the plain version on the first ``sub`` of
    them, must be bitwise reproducible, and is timed with its bound."""
    fan, fan_ref = K.fanout_aggregate, K.fanout_aggregate_ref
    (c, d), (f, k) = x.shape, pos.shape
    out = fan(x, pos, w)
    pos_s, w_s = pos[:sub].contiguous(), w[:sub].contiguous()
    want = fan_ref(x, pos_s, w_s)
    torch.cuda.synchronize()
    err = _agree(f"fanout {case}", out[:sub], want, *KERNEL_TOL)
    if not torch.equal(out, fan(x, pos, w)):
        fail(f"fanout {case}: not bitwise reproducible")
    ms = _device_ms(lambda i: fan(x, pos, w), calls=8, reps=3)
    sub_ms = _device_ms(lambda i: fan(x, pos_s, w_s))
    plain_ms = _device_ms(lambda i: fan_ref(x, pos_s, w_s), calls=8, reps=3)
    live = _live(pos, w, c)
    n_live = int(live.sum())
    distinct = torch.unique(pos[live]).numel()
    nbytes = kernel_bytes("gather", distinct, 4 * d, f, k, d, f)
    bound, by = bound_ms(nbytes, 2 * n_live * d)
    results["fanout_aggregate"]["max_abs_err"] = max(
        results["fanout_aggregate"].get("max_abs_err", 0.0), err)
    print(f"kernels: fanout_aggregate {case}: max abs err {err:.3e} on "
          f"{sub} of the rows; device {ms:.5f} ms/call "
          f"({n_live * 4 * d / (ms * 1e6):.0f} GB/s of live slots); bound "
          f"{bound:.5f} ms ({nbytes / 1e6:.3f} MB: {distinct} distinct rows "
          f"under {n_live} live slots; by {by}) = {bound / ms:.3f} of the "
          f"time; on the {sub} rows alone {sub_ms:.5f} ms/call vs plain "
          f"{plain_ms:.5f} ms/call; bitwise reproducible")


def phase_wide_kernels(rng, dev, results: dict) -> None:
    """Every entry at widths that go by element (``WIDE_WIDTHS``; at 602
    also a bfloat16 table), against its plain version and timed with its
    bound and library call; the fanout forward and backward on compacted
    slots; and the standalone fanout at the Exact training shape, held
    against the plain version on a subset of its rows."""
    floor_ms = _device_ms(lambda i: K.empty_launch(dev))
    print(f"kernels: rows of any width (by element): launch_floor_ms "
          f"{floor_ms:.5f} in this part's windows")
    n = SBM_KW["num_nodes"]
    hbm, hbm_ref = K.hbm_gather_aggregate, K.hbm_gather_aggregate_ref
    fan, fan_ref = K.fanout_aggregate, K.fanout_aggregate_ref
    bwd, bwd_ref = K.fanout_aggregate_backward, K.fanout_aggregate_backward_ref

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev)

    for d in WIDE_WIDTHS:
        dtypes = (torch.float32, torch.bfloat16) if d == 602 \
            else (torch.float32,)
        hist32 = normal(n + 8, d)
        hist32[n:] = float("nan")        # never read at or past the sentinel
        for dtype in dtypes:
            name = str(dtype)[6:]
            hist = hist32.to(dtype)
            # the full term of CV without preprocessing: F = batch 512,
            # K = pad degree 64, ~30% dead slots naming the sentinel row
            sets = []
            for _ in range(4):
                w = rng.uniform(0.0, 2.0 / 64, (512, 64)).astype(np.float32)
                w[rng.random((512, 64)) < 0.3] = 0.0
                idx = rng.integers(0, n, (512, 64)).astype(np.int32)
                idx[w == 0] = n
                sets.append((torch.from_numpy(idx).to(dev),
                             torch.from_numpy(w).to(dev)))
            _report(results, "hbm_gather_aggregate",
                    f"{name} [{n + 8},{d}] F=512 K=64 (by element)",
                    _compare(f"full term d={d} {name}", hbm, hbm_ref, hist,
                             sets, True, library=_library_gather))
            # the CV kernel on top of it: C = 1024, F = 512, K = 1
            kernel, ref, replaced = _cv_calls(n)
            _report(results, "cv_fanout_aggregate",
                    f"{name} [{n + 8},{d}] history C=1024 F=512 K=1 "
                    f"(by element)",
                    _compare(f"cv d={d} {name}", kernel, ref, hist,
                             _cv_inputs(rng, dev, 512, 1, d, n, 1.0, 4), True,
                             kind="cv", rows=1024, sentinel=n,
                             library=NO_LIBRARY_CV, replaced=replaced))
            # and on compacted slots at K = 8 (repeats, parked, sentinels)
            c = 4096
            pos, w = _compacted_slots(rng, dev, 512, 8, c, 0.7)
            field_in = torch.from_numpy(np.where(
                rng.random(c) < 0.2, n, rng.integers(0, n, c)).astype(
                    np.int32)).to(dev)
            _report(results, "cv_fanout_aggregate",
                    f"{name} history d={d} C={c} F=512 K=8, compacted slots",
                    _compare(f"cv compacted d={d} {name}", kernel, ref, hist,
                             [(pos, w, normal(c, d), field_in,
                               normal(512, d))], False, kind="cv", rows=c,
                             sentinel=n))
            # the standalone fanout on compacted slots: at 602 the Exact
            # evaluation's width, F = 2048, K = 64, 25/64 live
            f, k, c = (2048, 64, 67_584) if d == 602 else (512, 64, 33_280)
            x = normal(c, d).to(dtype)
            _report(results, "fanout_aggregate",
                    f"{name} C={c} F={f} K={k} d={d}, compacted slots "
                    f"(by element)",
                    _compare(f"fanout d={d} {name}", fan, fan_ref, x,
                             [_compacted_slots(rng, dev, f, k, c, 25 / 64)],
                             True, library=_library_gather))
            del x, hist
        del hist32
        # the backward: the training shape's iota, then compacted slots
        g = normal(512, d)
        iota = (512 + torch.arange(512, dtype=torch.int32, device=dev)
                )[:, None].contiguous()
        w1 = torch.from_numpy(rng.uniform(0.5, 1.5, (512, 1)).astype(
            np.float32)).to(dev)
        for case, c, slots, timing in [
                (f"C=1024 F=512 K=1 d={d} (by element)", 1024, (iota, w1),
                 True),
                (f"C=1024 F=512 K=8 d={d}, compacted slots", 1024,
                 _compacted_slots(rng, dev, 512, 8, 1024, 0.7), False)]:
            _report(results, "fanout_aggregate_backward", case,
                    _compare(f"backward {case}",
                             lambda g_, p, w, c=c: bwd(g_, p, w, c),
                             lambda g_, p, w, c=c: bwd_ref(g_, p, w, c), g,
                             [slots], timing, kind="backward", rows=c,
                             library=_library_backward(c)))

    # compacted slots at the chunked width: Exact training's second layer
    # (x [33280, 128], F = 512, K = 64), forward and backward
    c, f, k, d = 33_280, 512, 64, 128
    slots = [_compacted_slots(rng, dev, f, k, c, 17 / 64) for _ in range(4)]
    _report(results, "fanout_aggregate",
            f"f32 C={c} F={f} K={k} d={d}, compacted slots (Exact training, "
            f"layer 1)",
            _compare("fanout compacted d=128", fan, fan_ref, normal(c, d),
                     slots, True, library=_library_gather))
    _report(results, "fanout_aggregate_backward",
            f"C={c} F={f} K={k} d={d}, compacted slots (Exact training, "
            f"layer 1)",
            _compare("backward compacted d=128",
                     lambda g_, p, w: bwd(g_, p, w, c),
                     lambda g_, p, w: bwd_ref(g_, p, w, c), normal(f, d),
                     slots, True, kind="backward", rows=c,
                     library=_library_backward(c)))

    # Exact training's first layer at the capacities a pad degree of 64
    # gives: x [98816, 602], F = 33,280, K = 64, ~17 of 64 slots live (the
    # estimators phase repeats this on a real batch of the run)
    c, f, k, d = 98_816, 33_280, 64, 602
    pos, w = _compacted_slots(rng, dev, f, k, c, 17 / 64)
    _fanout_on_row_subset(
        results, f"f32 C={c} F={f} K={k} d={d}, compacted slots (Exact "
        f"training, layer 0; by element)", normal(c, d), pos, w)


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
    # the Exact evaluation: exhaustive test degree, the SBM's mean degree
    # 25 of 64 padded slots, the scheduler's append-only positions
    pos64, w64, x64 = _cv_inputs(rng, dev, 2048, 64, d,
                                 SBM_KW["num_nodes"], 25 / 64)[0][:3]
    report("fanout_aggregate", "f32 C=133120 F=2048 K=64 (Exact evaluation)",
           _compare("fanout K=64", fan, fan_ref, x64, [(pos64, w64)], True,
                    library=_library_gather))
    _gather_splits("fanout f32 C=133120 F=2048 K=64", x64, [(pos64, w64)])
    del pos64, w64, x64
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
    phase_cv_kernel(rng, dev, results, bf16)
    del table, bf16
    phase_wide_kernels(rng, dev, results)
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
    check_launches("a CV train epoch", launches, {
        name: per * steps for name, per in STEP_LAUNCHES["CV+PP"].items()})
    return tr, launches, steps


def phase_train_kernels(tr: Trainer, results: dict, batches: int = 4,
                        seed: int = 1) -> None:
    """The kernels on the slots of ``batches`` real scheduled batches of
    the training recipe, against their plain versions and timed: the two
    fanout kernels and the backward on the layer's sampled slots, the full
    term on the trained bf16 history with the train graph's rows of the
    output field.  The standalone fanout reads the history rows of the
    first batch's input field; the CV kernel reads seeded activations, each
    batch's own input field, the trained history and that batch's full
    term; the backward a seeded gradient.  These times are the kernels
    JSON line's, but for the standalone fanout's: a train step no longer
    launches it, so its line comes from the Exact evaluation's batches
    (``phase_converge``)."""
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
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(
        size=(f, hist.shape[1])).astype(np.float32)).to(tr.device)
    k_fan = slots[0][0].shape[1]
    acts = torch.from_numpy(rng.standard_normal(
        (c, hist.shape[1]), dtype=np.float32)).to(tr.device)
    cv_sets = [(pos, w, acts, p.fields[0],
                K.hbm_gather_aggregate(hist, *rows))
               for (pos, w), p, rows in zip(slots, packs, full)]
    kernel, ref, replaced = _cv_calls(n)
    _report(results, "cv_fanout_aggregate",
            f"train batch: bf16 history {list(hist.shape)} C={c} F={f} "
            f"K={k_fan}",
            _compare("cv fanout train batch", kernel, ref, hist, cv_sets,
                     True, kind="cv", rows=c, sentinel=n,
                     library=NO_LIBRARY_CV, replaced=replaced), main=True)
    _report(results, "fanout_aggregate",
            f"train batch: f32 C={c} F={f} K={k_fan}",
            _compare("fanout train batch", K.fanout_aggregate,
                     K.fanout_aggregate_ref, x, slots, True,
                     library=_library_gather))
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
    check_launches("CV serving", launches, {
        "cv_fanout_aggregate": None, "hbm_gather_aggregate": None})
    return launches, per_request


def phase_converge(results: dict, device: str = "cuda", sbm_kw=SBM_KW,
                   cfg_kw=CONVERGE_CFG, max_epochs: int = CONVERGE_EPOCHS,
                   target: float = CONVERGE_F1, batches: int = 4) -> dict:
    """CV+PP on the community SBM until ``max_epochs``; fails unless the
    best val micro-F1 reaches ``target``.  Then the paper's Exact test of
    the same weights over the validation ids (``test_cv=False`` at the
    exhaustive test degree: ``plain_aggregate``, so the standalone fanout
    kernel), counted apart; fails unless it launched that kernel and no
    other and lands within ``EXACT_F1_ATOL`` of the CV evaluation.  Then
    that kernel on the slots of ``batches`` real scheduled batches of the
    Exact evaluation over seeded activations, against its plain version and
    timed, with every split: the kernels JSON line's times for it, folded
    into ``results``.  Returns the Exact evaluation's launch counts, the
    dataset, the trained CV+PP trainer and its val micro-F1 curve."""
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

    exact = Trainer(Config(**{**cfg_kw, "test_cv": False}), ds, device=device)
    exact.state = tr.state               # the trained weights, shared
    exact.evaluate(ds.val_d)             # warm-up
    _sync(device)
    K.reset_launches()
    _, _, f1_exact, _, exact_s = exact.evaluate(ds.val_d)
    launches = dict(K.LAUNCHES)
    cv_s = tr.evaluate(ds.val_d)[4]
    print(f"converge: Exact test (test_cv=False, test degree "
          f"{cfg_kw['test_degree']}) of the same weights: val micro-F1 "
          f"{f1_exact:.4f} in {exact_s:.3f} s against the CV evaluation's "
          f"{curve[-1]:.4f} in {cv_s:.3f} s (atol {EXACT_F1_ATOL}); kernel "
          f"launches {launches}")
    check_launches("the Exact evaluation", launches,
                   {"fanout_aggregate": None})
    if abs(f1_exact - curve[-1]) > EXACT_F1_ATOL:
        fail(f"the Exact test's micro-F1 {f1_exact:.4f} is not within "
             f"{EXACT_F1_ATOL} of the CV evaluation's {curve[-1]:.4f}")

    tbs = exact.cfg.test_batch_size
    bm = torch.from_numpy(exact._batch_matrix(
        ds.val_d[:batches * tbs], tbs, ds.num_data)).to(exact.device)
    packs = [schedule(exact.gen, exact.graph_full, ids, exact.test_degrees,
                      False, dedup=exact.cfg.field_dedup) for ids in bm]
    slots = [(p.layers[0].slot_pos, p.layers[0].slot_w) for p in packs]
    c, (f, k) = packs[0].fields[0].shape[0], slots[0][0].shape
    x = torch.from_numpy(np.random.default_rng(cfg_kw["seed"]).standard_normal(
        (c, tr.state.histories[0][0].shape[1]), dtype=np.float32)).to(
            exact.device)
    case = f"Exact evaluation batch: f32 C={c} F={f} K={k}"
    _report(results, "fanout_aggregate", case,
            _compare("fanout Exact evaluation batch", K.fanout_aggregate,
                     K.fanout_aggregate_ref, x, slots, True,
                     library=_library_gather), main=True)
    _gather_splits(case, x, slots)
    return launches, ds, tr, curve


def _copy_params(dst: Trainer, src: Trainer) -> None:
    with torch.no_grad():
        for layer, p in src.params.items():
            for name, t in p.items():
                dst.params[layer][name].copy_(t)


def _train_to_target(label: str, tr: Trainer, max_epochs: int, target,
                     per_step: dict):
    """Train ``tr`` until its val micro-F1 reaches ``target`` (None: for
    ``max_epochs``), at most ``max_epochs`` epochs.  The second epoch (the
    only one, where there is one) runs with the launch counters reset just
    before it and read just after, is timed, and must have launched exactly
    ``per_step`` kernels a step.  Returns (its launch counts, its steps,
    the curve)."""
    device, ds = tr.device, tr.ds
    curve, counted = [], None
    for epoch in range(max_epochs):
        count = epoch == min(1, max_epochs - 1)
        if count:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            _sync(device)
            K.reset_launches()
            t0 = time.perf_counter()
        loss, _, _, steps = tr.train_epoch()
        if count:
            _sync(device)
            secs = time.perf_counter() - t0
            counted = (dict(K.LAUNCHES), steps)
            print(f"estimators: {label}: epoch {epoch + 1}, {steps} steps in "
                  f"{secs:.3f} s -> {1e3 * secs / steps:.3f} ms/step; last "
                  f"loss {loss:.5f}; peak device memory "
                  f"{_peak_gib(device):.3f} GiB; kernel launches "
                  f"{counted[0]} = "
                  f"{ {k: v / steps for k, v in counted[0].items()} } per "
                  f"step")
            check_launches(f"a {label} train epoch", counted[0],
                           {name: per * steps
                            for name, per in per_step.items()})
        if not np.isfinite(loss):
            fail(f"{label}: non-finite training loss {loss}")
        curve.append(tr.evaluate(ds.val_d)[2])
        if target is not None and counted and curve[-1] >= target:
            break
    print(f"estimators: {label}: val micro-F1 by epoch "
          f"{', '.join(f'{f:.4f}' for f in curve)}")
    if target is not None and max(curve) < target:
        fail(f"{label} val micro-F1 {max(curve):.4f} < {target} in "
             f"{max_epochs} epochs")
    return (*counted, curve)


def _gradvar_arm(ds, cfg_kw: dict, over: dict, source: Trainer, device,
                 times: int) -> dict:
    """One arm of the gradient-variance table, by the protocol of
    scripts/validate_gradvar.py: a ``gradvar`` trainer (the eval graph is
    the train graph) with float32 histories and an exhaustive test degree
    takes ``source``'s weights; ``num_layers + 1`` evaluation passes over
    all nodes converge the eval histories, which the train state then
    takes; then ``times`` resamples of the first train batch."""
    cfg = Config(**{**cfg_kw, "gradvar": True, "history_dtype": "float32",
                    "test_degree": 10000, **over})
    tr = Trainer(cfg, ds, device=device)
    _copy_params(tr, source)
    if tr.state.histories:
        all_ids = np.arange(ds.num_data, dtype=np.int32)
        for _ in range(cfg.num_layers + 1):
            tr.evaluate(all_ids)
        with torch.no_grad():
            for hl, el in zip(tr.state.histories, tr.eval_histories):
                for h, e in zip(hl, el):
                    h.copy_(e)
    return {k: float(v) for k, v in tr.gradient_variance(
        times=times, log=lambda s: None).items()}


def phase_estimators(ds, cv_tr: Trainer, cv_curve, device: str = "cuda",
                     cfg_kw=CONVERGE_CFG, target: float = CONVERGE_F1,
                     cvd_epochs: int = CVD_EPOCHS,
                     exact_epochs: int = EXACT_EPOCHS,
                     times: int = GRADVAR_TIMES,
                     dense_ids: int = EXACT_DENSE_IDS, results=None):
    """The other estimators of the repository's A/B on the convergence
    phase's SBM: CVD+PP and Exact to ``target``, det-dropout+PP for an
    epoch, then the gradient-variance table from the trained CV+PP
    (``cv_tr``) and CVD+PP weights.  With ``results`` (the per-kernel
    results, on the card) the standalone fanout is also held against its
    plain version on the first layer of a real Exact train batch.  Returns
    ({path: launch counts of its counted epoch}, {estimator: launches per
    step})."""
    paths, per_step = {}, {}

    def counted(label, name, tr, max_epochs, goal):
        launches, steps, curve = _train_to_target(
            label, tr, max_epochs, goal, STEP_LAUNCHES[name])
        paths[f"{name} train epoch"] = launches
        per_step[name] = {k: v / steps for k, v in launches.items()}
        return curve

    cvd = Trainer(Config(**{**cfg_kw, "cvd": True, "test_cvd": True}), ds,
                  device=device)
    counted("CVD+PP (cvd, test_cvd)", "CVD+PP", cvd, cvd_epochs, target)
    print(f"estimators: CV+PP's curve, for comparison: "
          f"{', '.join(f'{f:.4f}' for f in cv_curve)}")

    exact_kw = {**cfg_kw, "cv": False, "test_cv": False, "degree": 10000,
                "preprocess": False, "test_preprocess": False}
    exact = Trainer(Config(**exact_kw), ds, device=device)
    n, dcap = ds.num_data, exact.graph_train.pad_degree
    bs = exact.cfg.batch_size
    if exact.cfg.field_dedup or not effective_dedup(
            False, bs, exact.train_degrees, n, dcap):
        fail("Exact at this batch size should force dedup-compacted fields")
    print(f"estimators: Exact (degree 10000, no preprocessing, no control "
          f"variate): dedup forced; train field capacities "
          f"{field_capacities(bs, exact.train_degrees, n, dcap)}, "
          f"evaluation "
          f"{field_capacities(exact.cfg.test_batch_size, exact.test_degrees, n, exact.graph_full.pad_degree)}"
          f"; first layer {ds.feature_dim} wide")
    counted("Exact", "Exact", exact, exact_epochs, target)
    ids = np.asarray(ds.val_d[:dense_ids])
    worst = float(np.abs(exact.predict(ids)
                         - exact_probs(exact, ids).cpu().numpy()).max())
    print(f"estimators: Exact: max |predict - dense full-batch computation| "
          f"= {worst:.3e} on {len(ids)} validation ids (atol "
          f"{EXACT_DENSE_ATOL})")
    if not worst <= EXACT_DENSE_ATOL:
        fail("Exact predictions differ from the dense computation")
    if results is not None:
        batch = torch.from_numpy(exact._batch_matrix(
            ds.train_d[:bs], bs, n)[0]).to(exact.device)
        pack = schedule(exact.gen, exact.graph_train, batch,
                        exact.train_degrees, False,
                        dedup=exact.cfg.field_dedup)
        x = row_gather(exact.train_features, pack.fields[0], sentinel=n)
        pos, w = pack.layers[0].slot_pos, pack.layers[0].slot_w
        _fanout_on_row_subset(
            results, f"Exact train batch, layer 0: f32 C={x.shape[0]} "
            f"F={pos.shape[0]} K={pos.shape[1]} d={x.shape[1]} (by element)",
            x, pos, w)
        del x, pack
    del exact

    det = Trainer(Config(**{**cfg_kw, "det_dropout": True}), ds,
                  device=device)
    counted("det-dropout+PP (cv, det_dropout)", "det-dropout+PP", det, 1,
            None)
    del det

    ns = {"cv": False, "test_cv": False}
    arms = [("no dropout", "NS+PP", {**ns, "dropout": 0.0}, cv_tr),
            ("no dropout", "CV+PP", {"dropout": 0.0}, cv_tr),
            ("dropout", "NS+PP", ns, cv_tr),
            ("dropout", "CV+PP", {}, cv_tr),
            ("dropout", "CVD+PP", {"cvd": True, "test_cvd": True}, cvd)]
    table = {}
    t0 = time.perf_counter()
    for suite, name, over, source in arms:
        r = table[suite, name] = _gradvar_arm(ds, cfg_kw, over, source,
                                              device, times)
        print(f"estimators: gradient variance, {suite}, {name}: "
              + ", ".join(f"{k} {v:.6g}" for k, v in r.items()))
        if not all(np.isfinite(v) for v in r.values()):
            fail(f"gradient variance {suite} {name}: non-finite values {r}")
    print(f"estimators: gradient variance: {len(arms)} arms x {times} "
          f"resamples of a batch of {bs} in {time.perf_counter() - t0:.1f} s")

    def se(r):
        return r["grad_stdev"] / np.sqrt(times)

    cv0, ns0 = table["no dropout", "CV+PP"], table["no dropout", "NS+PP"]
    ns1, cvd1 = table["dropout", "NS+PP"], table["dropout", "CVD+PP"]
    orderings = {
        "without dropout CV+PP's forward is exact (bias, stdev < 1e-5)":
            cv0["pred_bias"] < 1e-5 and cv0["pred_stdev"] < 1e-5,
        "without dropout CV+PP's gradient bias is within 3 standard errors":
            cv0["grad_bias"] < 3 * se(cv0),
        "without dropout NS+PP's gradient bias is above 3 standard errors":
            ns0["grad_bias"] > 3 * se(ns0),
        "without dropout CV+PP's gradient stdev is below NS+PP's":
            cv0["grad_stdev"] < ns0["grad_stdev"],
        "with dropout CVD+PP's gradient stdev is below NS+PP's":
            cvd1["grad_stdev"] < ns1["grad_stdev"],
    }
    broken = [what for what, holds in orderings.items() if not holds]
    if broken:
        fail(f"gradient variance orderings do not hold: {broken}")
    print(f"estimators: gradient variance orderings hold: "
          f"{'; '.join(orderings)}")
    return paths, per_step


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
    served, per_request = phase_slice(tr)
    del tr
    exact, sbm, cv_tr, cv_curve = phase_converge(kernels)
    estimator_paths, per_step = phase_estimators(sbm, cv_tr, cv_curve,
                                                 results=kernels)
    per_step["CV+PP"] = {name: count / steps
                         for name, count in launches.items()}
    # the counted paths: each had the counters at 0 just before it and was
    # read just after
    paths = {"train epoch": launches, "served requests": served,
             "Exact evaluation": exact, **estimator_paths}
    total = {name: sum(p[name] for p in paths.values()) for name in kernels}
    idle = [name for name, count in total.items() if count == 0]
    if idle:
        fail(f"no counted path launched {idle}: {paths}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": res["max_abs_err"],
         **{key: res[key] for key in MAIN_KEYS},
         "library": res["library"], "replaced_ms": res["replaced_ms"],
         "launches_by_path": {path: p[name] for path, p in paths.items()},
         "launches_per_step": launches[name] / steps,
         "launches_per_step_by_estimator": {
             est: counts[name] for est, counts in per_step.items()},
         "launches_per_request": per_request[name]}
        for name, res in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
