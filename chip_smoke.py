"""Smoke run of the PyTorch/CUDA port (stochastic_gcn_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card
    python3 chip_smoke.py --phase kernels   # card, build and kernels phases
    python3 chip_smoke.py --phase kernels --parent tmp/parent   # in turns
                                   # with another tree's kernels (any phase)

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
   step launches.  Then the four kernels at the column widths a rank of
   ``--tp 2`` gives them (``phase_tp_kernels``: d = 64, a rank's block of
   the trained bf16 train and f32 eval histories, and d = 256, hidden
   512's block, seeded), on the same real batches, held and timed the same
   way (``tp_cases`` in the kernels line); then ``Trainer.save()``,
   compressed and not, after a validation pass (``phase_save``): runs of 3
   epochs with a save after each (``--ckpt_every 1``), sync against
   ``--ckpt_async`` (the snapshot on the card, the side-stream copy into
   pinned buffers, the writer thread) in turns, every epoch, save() call
   and npz write timed: the save's latency on the critical path, an epoch
   with a write in flight against one without, the cycle, and the save's
   share of a ``--ckpt_every`` 1 and 10 cycle; then one more async save
   held bitwise against the last sync file, and a ``--resume`` from it
   against the saved state.  Then a ``torch.profiler``
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
   bfloat16 tables, d = 1, 513 and 1433: by unit, or where the plan gives
   a float32 row one warp, and for the CV delta, by column range over
   several warps),
   timed like the rest, on append-only and on dedup-compacted slots
   (repeated positions, ``PARKED_POS``); the standalone fanout at the Exact
   training shape (x [98816, 602], F = 33,280, K = 64), where the plain
   version would materialise 5 GB, is held against it on 1024 of its rows
   (and again in phase 7 on the first layer of a real Exact train batch).
   The full term on 1024- and 2048-byte rows at the training shape (f32
   d=256 and 512, bf16 d=512); the gather's edge cases at every row kind
   (``EDGE_ROWS``); the backward with many slots on few rows (W [500,32],
   F=15,000, K=333, seeded) given the rows' ends, against its plain
   version with them, beside the same kernel with the ends left out,
   ``index_add_`` and ``torch.sparse.mm``, and on adversarial layouts
   (live slots not a prefix of the row, a live slot at K - 1, every live
   slot on 4 columns of W).
   Each redesigned case also goes into the kernels JSON line under
   ``redesigned_cases``; the PPI phase adds the full term on 4 real PPI
   batches (bf16 train and f32 eval histories, ``ppi_cases``), with every
   split.  ``--phase kernels`` adds the sweeps that chose the wide rows'
   plans and do not run in the whole smoke: every split at those widths
   and at Exact training's first layer, and where the many-slot backward's
   time goes, with and without the ends (the same call with every weight
   zero, on uniform rows, on 25 rows; the compacted backward on dead
   slots); then the real batches of the formats and estimators phases
   without their training (``phase_real_batches``: the sparse first
   layer's kernels on 4 PubMed-sized batches with the same split of the
   backward's time, the fanout on a real Exact batch's first layer).
   ``--parent DIR`` (repeatable) loads another tree's ``ops.cuda_spmm``
   under a package name of its own, builds its kernels beside this tree's
   and times both in turns (theirs, ours, ours, theirs) wherever a case
   names the other tree's kernel: the main path's shapes, the CV delta
   and backward at every width, Exact layer 0 (seeded and real) and the
   sparse layer's backward (seeded and real).
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
   is finite.  Each of CVD+PP, Exact, det-dropout+PP and IS+PP also gets
   the 10-step profile of phase 4.

8. formats — the reference's data formats at published sizes, written by
   the port's fixture writers into a temporary directory and read by
   ``load_data``.  PubMed-sized Planetoid files (19,717 nodes, 500
   features, 3 classes, the 60/500/1000 split): the features must come out
   sparse and go on the card padded-sparse (set-up time, ``nnz_cap`` and
   ``pad_sparse_features``' seconds printed); ``configs/pubmed.sh``'s
   command line (the package defaults: NS+PP, degree 20) and the CV recipe
   (``--cv --test_cv --degree 1 --test_degree 1``) train 30 epochs each
   (one 1000-id step an epoch): ms/step, peak memory, launches a step
   checked exactly (the dense path's plus one ``fanout_aggregate`` over the
   rows of W and its backward), and the best val micro-F1, which fails
   below the JAX package's on the CPU (``PUBMED_REFERENCE_F1``,
   scripts/formats_reference_f1.py) by more than 0.03.  The sparse first
   layer's two kernels on 4 real train batches (field 0 of the NS+PP
   arm's sampled rows, ``nnz_cap`` slots a row with the rows' ends, the
   trained ``[500, 32]`` W): against their plain versions on every row and
   timed beside ``embedding_bag``, ``zeros().index_add_`` and
   ``torch.sparse.mm`` (a CSR built before, and built in the call) and
   their bound, the backward also with the ends left out and on the first
   25 and 2,000 rows of each batch (a small field of long rows), and
   every split of the gather.  The CV arm is exported
   (``export_predictor``) and served from a fresh ``load_predictor(...,
   device="cuda")``: its answers on the 1000 test ids must equal
   ``Trainer.predict`` bitwise and exact inference within 1e-4, and a
   repeated request must be bitwise equal (export and load seconds, the
   artifact's bytes, ms per request, launches per request); the sparse
   layer's forward on a request's field (every row live) held against its
   plain version and timed beside the same call with the ends left out
   and ``torch.sparse.mm``.  Then PPI-sized GraphSAGE JSON files (56,944
   nodes, 50 features, 121 labels, multi-label): ``configs/ppi.sh``'s
   flags with the CV recipe for one timed epoch (CV kernels on 2048-byte
   float32 eval rows), launches checked exactly, then 2048 test ids served
   from its artifact with the same checks.  Phase 5 also serves its 3
   requests from an artifact of the trained Reddit-shaped model, bitwise
   equal to ``Trainer.predict``'s.
9. fullterm — the other forms of the CV full-neighbourhood term, each
   through ``hbm_gather_aggregate`` and ``cv_fanout_aggregate``:
   ``--lazy_fullterm`` at the Reddit-shaped recipe beside the per-step
   term at batch 512 and 4096 (a warm-up and a counted epoch each: a lazy
   step launches no full term, a lazy epoch one a-bar call; the a-bar
   build timed alone, its rows held against the per-step term on 4 real
   fields, the a-bar kernel call over every row against its plain
   version), after phase 5; ``ema_aggregate`` on a real SBM batch (one
   fanout launch) and lazy CV+PP to 0.90 on the SBM, then lazy CVD+PP and
   det-dropout+PP for an epoch (the squared a-bar table checked), after
   phase 7; then the SBM without its degree cap (max degree 1,243):
   padded, edge-list with a covering budget and with the auto budget,
   CV+PP for 3 epochs each (one train step of the covering edge list from
   the padded arm's state within 1e-5, val micro-F1, the mean of 3 runs
   an arm, within 0.01 and 0.02,
   the auto budget dropping at most 0.1% of the edges, device graph bytes
   and peak memory), 2 x 2048 test ids served from the edge-list artifact
   (bitwise), the a-bar build on both train graphs, and the full term on
   real fields as edge-list windows (K=576) against padded rows (K=1243)
   at F=512 and 1024; then the two-tier term at batch 4096 (the gate
   lowered to that batch for the phase) on both layouts: tiered and
   untiered epochs in turns, the tiered term against the untiered call on
   4 real fields and on a forced overflow, both timed on the host clock,
   and the main, tail and untiered kernel calls timed on the device; and
   the gate sweep: the full term on the full graph over fields of 4,096
   to 131,072 rows, tiered against untiered, on the host clock.
10. dp — data parallelism, one NCCL rank per card (``python3 chip_smoke.py
   --phase dp`` runs the card, build and dp phases alone; ``phase_dp``):
   the halo primitives, the scatter's static-capacity cases among them;
   the SBM's first dp epoch against one process, CV+PP to 0.90 and its
   checkpoint served by one process, and at world > 1 the SBM plain
   against owner batching (``--partition_nodes rcm``) in turns;
   the Reddit-shaped recipe timed per rank; the owner arm (the same recipe
   with ``--owner_batching --partition_nodes rcm``: a timed epoch, the
   share of the routed history reads and writes, and of the layer's input
   rows, that the rank owns, and at world > 1 the share under each flag
   alone); both arms in turns against ``--halo_exchange false`` (exact
   splits), each printing on a ``dp halo:`` line ms/step, stream syncs a
   step, collective bytes a step and ``hist_dropped`` per epoch; the
   edge-list arm (the uncapped SBM as a node-sharded edge
   list against the row-sharded padded graph: graph bytes per rank, the
   first ``DP_HELD_STEPS`` steps within ``DP_FIRST_EPOCH_RTOL``, then in
   turns against ``--halo_exchange false``); each arm's
   launches checked exactly per rank and the four kernels on its inputs
   held against their plain versions and timed on rank 0; then the
   coordinator arm: the ranks started as hosts through the multi-host
   launch (two hosts of two ranks on four cards, one host of one rank on
   one card) through a TCP store, which must agree.  At an even world the
   ranks are declared as two hosts, and the collective bytes split into
   those that stay on a host and those that cross.  Then the tp arm
   (``phase_tp``; it needs two cards, and one card says so and runs none):
   at world 4 dp 2 x tp 2 and dp 4 in one group and dp 2 in a group of its
   own, at world 2 dp 1 x tp 2 and dp 2 against one process: the first
   ``DP_HELD_STEPS`` losses held, ms/step in turns at hidden 128 and 512,
   collective bytes with the model group's apart, a 10-step profile, the
   save of the tp Trainer with ``--ckpt_async`` timed (a mesh keeps the
   sync gathered save), and a Polyak arm whose checkpoint a fresh tp
   Trainer and one process serve.

The line before the last is a JSON object describing the kernels (times in
device ms per call on real batches of the path that launches the kernel,
``bound_ms`` and ``bound_by``,
``library_ms``, ``replaced_ms`` where the kernel took over a composition;
``launches`` summed over the counted paths, the train epoch, the
served requests, the Exact evaluation, one train epoch of each of CVD+PP,
Exact and det-dropout+PP, the PubMed and PPI arms, the requests served
from the four artifacts and the full-term phase's epochs, and apart per
train step of each estimator and per request of each serving path; the
sparse first layer's cases under ``sparse_layer_batches``; the full-term
phase's kernel cases under ``fullterm_cases`` with ``launch_floor_ms``,
the redesigned branches' synthetic cases under ``redesigned_cases`` and the
PPI batches under ``ppi_cases``,
the tier's host-clock times under ``tier_wall_ms`` and the a-bar builds
under ``lazy_anchor_ms``); the last is ``{"ok": true, "device":
{...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import statistics
import subprocess
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from stochastic_gcn_tpu_torch.config import Config
from stochastic_gcn_tpu_torch.data.fixtures import (PlanetoidSpec,
                                                    write_graphsage_fixture,
                                                    write_planetoid_fixture)
from stochastic_gcn_tpu_torch.data.graph import (FlatGraph,
                                                 PaddedSparseFeatures,
                                                 flat_row_windows,
                                                 graph_rows, live_ends,
                                                 pad_sparse_features)
from stochastic_gcn_tpu_torch.data.loaders import (community_sbm_dataset,
                                                   load_data, reddit_like)
from stochastic_gcn_tpu_torch.data.preprocess import cap_adj_degree
from stochastic_gcn_tpu_torch.models import aggregators as A
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.models.mlp import MLPTrainer
from stochastic_gcn_tpu_torch.ops import cuda_spmm as K
from stochastic_gcn_tpu_torch.ops import layers as L
from stochastic_gcn_tpu_torch.ops.gather import row_gather
from stochastic_gcn_tpu_torch.sampler.scheduler import (PARKED_POS,
                                                        compact_field,
                                                        effective_dedup,
                                                        field_capacities,
                                                        is_select, schedule)
from stochastic_gcn_tpu_torch.serving import (export_predictor,
                                              load_predictor)
from stochastic_gcn_tpu_torch.training import checkpoint as Ckpt
from stochastic_gcn_tpu_torch.training import step as St
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
# other trees of the port (``--parent DIR``): (label, that tree's
# ``ops.cuda_spmm``, its kernels built from its own sources), timed in turns
# with this tree's on the cases that name their counterpart (``_in_turns``)
TREES: list = []
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
# Exact training on the convergence phase's SBM: every neighbour, no
# preprocessing (its first layer gathers the raw 602-wide feature rows)
EXACT_KW = dict(cv=False, test_cv=False, degree=10000, preprocess=False,
                test_preprocess=False)
EXACT_F1_ATOL = 0.01         # the Exact test against the CV evaluation
NO_LIBRARY_CV = "none: no single PyTorch call computes this function"
SPIN_CYCLES = 20_000_000     # ~10 ms at the H100's ~2 GHz SM clock; doubled
                             # while a window's calls outlast it
# the H100's published peaks (SXM data sheet): device memory rate, and
# float32 rate outside the tensor cores (the kernels' multiply-adds)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SPLITS = (1, 2, 4, 8)        # warps per output row of the split kernels
# the padded-sparse first layer on PubMed-sized data: rows of W, its
# width, field rows, nnz_cap slots a row
MANY_SLOTS = (500, 32, 15_000, 333)
# the sparse first layer's backward also on the first rows of each real
# batch's field: a small field of long rows (the ends with rows split over
# warps, 25 rows; and at 2,000 rows, split 2)
SMALL_FIELDS = (25, 2000)
# widths the kernels take by unit: raw Reddit-shaped features, one
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
    # importance sampling and NS, both without a control variate: one
    # aggregation layer under PP
    "IS+PP": {"fanout_aggregate": 1, "fanout_aggregate_backward": 1},
    "NS+PP": {"fanout_aggregate": 1, "fanout_aggregate_backward": 1},
}
# importance sampling on the Reddit-shaped graph at the JAX benchmark's IS
# batch (bench.py:861-874): the auto slot cap (8 at this batch) and cap 0,
# beside NS+PP at the same batch
IS_BATCH = 4096
IS_ARMS = (("IS+PP, slot cap auto", "IS+PP", {"importance": True,
                                               "test_importance": True,
                                               "is_slot_cap": -1}),
           ("IS+PP, slot cap 0", "IS+PP", {"importance": True,
                                           "test_importance": True,
                                           "is_slot_cap": 0}),
           ("NS+PP", "NS+PP", {}))
# IS+PP on the SBM: NS+PP reached 0.66 at epoch 3 in ESTIMATOR_AB.json, so
# this floor only catches a broken estimator
IS_EPOCHS, IS_F1_FLOOR = 3, 0.40
MLP_EPOCHS = 2
# the PubMed-sized Planetoid fixture: PubMed's published 19,717 nodes, 500
# features, 3 classes and 60/500/1000 split (scripts/formats_reference_f1.py
# writes the same files with the JAX package's writer)
PUBMED_SPEC = dict(name="pubmed", num_train=60, num_extra=18657,
                   num_val=500, num_test=1000, feature_dim=500,
                   num_classes=3, avg_degree=4, words_per_node=50)
PUBMED_EPOCHS = 30
# configs/pubmed.sh's command line (the package defaults: NS+PP, degree
# 20, batch 1000, hidden 32) and the paper's CV recipe
PUBMED_ARMS = (("NS+PP", "NS+PP (configs/pubmed.sh)", {}),
               ("CV+PP", "CV+PP (--cv --test_cv --degree 1 --test_degree 1)",
                dict(cv=True, test_cv=True, degree=1, test_degree=1)))
# the best val micro-F1 in PUBMED_EPOCHS epochs of the JAX package on the
# CPU, same fixture and flags, mean over seeds 1, 2, 3
# (scripts/formats_reference_f1.py --epochs 30 --seeds 1,2,3); the card
# fails below it by more than PUBMED_F1_ATOL
PUBMED_REFERENCE_F1 = {"NS+PP": 0.9900, "CV+PP": 0.99067}
PUBMED_F1_ATOL = 0.03
# PPI's published node, feature and label counts (multi-label)
PPI_FIXTURE = dict(num_nodes=56944, feature_dim=50, num_classes=121,
                   avg_degree=28, multilabel=True)
# configs/ppi.sh's flags, with the CV recipe
PPI_CFG = dict(dataset="ppi", normalization="graphsage", weight_decay=0.0,
               dropout=0.2, layer_norm=True, batch_size=512, hidden1=512,
               num_fc_layers=2, cv=True, test_cv=True, degree=1,
               test_degree=1)
PPI_SERVE_IDS = 2048
# what a padded-sparse first layer adds to a train step: the fanout over
# the rows of W, and its backward for the gradient in W, both given the
# rows' ends (K.ENDS_LAUNCHES counts those launches apart)
SPARSE_LAYER = {"fanout_aggregate": 1, "fanout_aggregate_backward": 1}
# the forward given the rows' ends (ends_gather_kernel behind the
# fanout_aggregate wrapper): its own entry of the kernels JSON line, its
# times from the real PubMed batches (ENDS_RESULT) and its launches from
# the paths that run the padded-sparse layer (ENDS_PATHS)
ENDS_KERNEL = "fanout_aggregate, rows with ends"
ENDS_RESULT: dict = {}
ENDS_PATHS: dict = {}
# the other forms of the full term.  The convergence SBM without its degree
# cap: power-law hubs trained without --pad_degree, the edge-list layout's
# case; evaluated as served (test degree 1, test_cv), so that exhaustive
# evaluation of 1,243-wide rows does not dominate the run
UNCAPPED_SBM_KW = {**SBM_KW, "max_degree": -1}
FULLTERM_CFG = {**CONVERGE_CFG, "pad_degree": -1, "test_degree": 1}
FULLTERM_EPOCHS = 3
# each arm's val micro-F1 is the mean of this many runs from the same seed:
# two runs of one arm differ (which write of a repeated field id lands in
# the history, and the backward's atomics, are unordered on the card), by
# more than COVER_F1_ATOL at 3 epochs in one run of three
FULLTERM_REPEATS = 3
# an edge budget that covers every edge: edge_cap_per_row = max_degree
COVER_EDGE_MULT = 1e9
COVER_F1_ATOL, AUTO_F1_ATOL = 0.01, 0.02
AUTO_TRUNCATED_MAX = 0.001   # the auto budget covers 99.9% of the edges
STEP_ATOL = 1e-5             # one step of two layouts: logits and params
FULLTERM_SERVE_IDS = 2048
# the two-tier term's phase: the train field at batch 4096, with the gate
# lowered to it; then the full term on fields of these many rows of the
# full graph, tiered against untiered, which places the gate
TIER_BATCH = 4096
TIER_SWEEP_ROWS = (4096, 16384, 65536, 131072)
# a-bar builds a device-time window: an edge list's build is ~110 launches,
# and a window's launches must fit in the queue of pending launches
ABAR_DEVICE_CALLS = 2
TIER_LAUNCHES = {"cv_fanout_aggregate": 1, "hbm_gather_aggregate": 2,
                 "fanout_aggregate_backward": 1}
LAZY_BATCHES = (512, 4096)
# --lazy_fullterm: launches a step, and once an epoch (the a-bar tables,
# one per history table)
LAZY_LAUNCHES = {
    "lazy CV+PP": ({"cv_fanout_aggregate": 1, "fanout_aggregate_backward": 1},
                   {"hbm_gather_aggregate": 1}),
    "lazy CVD+PP": ({"cv_fanout_aggregate": 1, "fanout_aggregate": 1,
                     "fanout_aggregate_backward": 1},
                    {"hbm_gather_aggregate": 1}),
    "lazy det-dropout+PP": ({"cv_fanout_aggregate": 1, "fanout_aggregate": 2,
                             "fanout_aggregate_backward": 3},
                            {"hbm_gather_aggregate": 2}),
}
# the JAX package's lazy CV+PP on the CPU at CONVERGE_CFG on the capped SBM
# (scripts/lazy_reference_f1.py --epochs 15): 0.90 first at epoch 7, best
# 0.9466 in 15; the card must reach CONVERGE_F1 in CONVERGE_EPOCHS
LAZY_REFERENCE = {"first_epoch": 7, "best": 0.9466}
EMA_ALPHA = 0.3
# tensor parallelism: the column widths a kernel gets on one rank of --tp 2
TP_KERNEL_WIDTHS = {64: "hidden 128 over 2 model ranks",
                    256: "hidden 512 over 2 model ranks"}
CKPT_EVERY = (1, 10)         # epochs a --ckpt_every cycle the save joins
CYCLE_EPOCHS = 2             # epochs of a timed --ckpt_every 1 run
SAVE_TURNS = (False, True, True, False)   # sync, async, async, sync


def kernel_bytes(kind: str, live_rows: float, row_bytes: int, f: int,
                 k: int, d: int, rows_out: int, hist_rows: float = 0.0,
                 hist_row_bytes: int = 0, ranged: float = 0.0) -> float:
    """Bytes a kernel must move for one call, each input read once and each
    output written once.  ``kind`` "gather" (both forward kernels):
    ``live_rows`` table rows of ``row_bytes`` (the distinct rows under a
    live slot, ``w != 0`` and the index in range as the kernels define it:
    a row that several slots name is read from memory once), the int32
    index and float32 weight arrays ``[f, k]``, and the float32 output
    ``[rows_out, d]``.  ``kind`` "backward": the float32 gradient
    ``[f, d]``, the same slot arrays, and all of the float32
    ``grad_x [rows_out, d]`` written once.  ``kind`` "backward ends" (the
    backward given each row's end of live slots): the int32 ends ``[f]``,
    the ``ranged`` slots before the ends (8 bytes each), the ``live_rows``
    rows of ``g`` that own a live slot, and ``grad_x`` written once.
    ``kind`` "gather ends" (the sampled term given each row's end, the
    padded-sparse first layer's forward): the int32 ends ``[f]``, the
    ``ranged`` slots before the ends (8 bytes each), the ``live_rows``
    distinct table rows under a live slot, and the float32 output
    ``[rows_out, d]`` written once.  ``kind`` "cv" (the CV
    estimator's sampled term): ``live_rows`` distinct rows of ``x`` under a
    live slot and the int32 ``field_in`` entry of each, ``hist_rows``
    distinct history rows of ``hist_row_bytes`` (the nodes at those
    positions, below the sentinel), the slot arrays, and the float32
    ``base`` and output ``[rows_out, d]``."""
    slot_arrays = f * k * (4 + 4)
    if kind == "backward":
        return f * d * 4 + slot_arrays + rows_out * d * 4
    if kind == "backward ends":
        return f * 4 + ranged * 8 + live_rows * d * 4 + rows_out * d * 4
    if kind == "gather ends":
        return f * 4 + ranged * 8 + live_rows * row_bytes + rows_out * d * 4
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


def _load_tree(tree: str, i: int):
    """``ops.cuda_spmm`` of the port in another tree, imported under the
    package name ``sgt_tree<i>`` so that it lives beside this tree's."""
    import importlib.util
    import sys
    pkg = Path(tree).resolve() / "stochastic_gcn_tpu_torch"
    if not (pkg / "csrc").is_dir():
        fail(f"--parent {tree}: no tree of the port there")
    name = f"sgt_tree{i}"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.cuda_spmm")


def phase_build() -> None:
    """Build this tree's kernels and, side by side, those of ``TREES``."""
    from concurrent.futures import ThreadPoolExecutor

    from stochastic_gcn_tpu_torch.ops import _build
    with ThreadPoolExecutor(max(1, len(TREES))) as pool:
        others = [pool.submit(PK._build.build) for _, PK in TREES]
        path, seconds, log = _build.build()
        _build.library()
        print(f"build: {seconds:.2f} s -> {path.relative_to(ROOT)}")
        for (label, PK), built in zip(TREES, others):
            other, other_s, _ = built.result()
            PK._build.library()
            print(f"build: {label}: {other_s:.2f} s -> {other}")
    kernel = "?"         # the entry function the next ptxas lines describe
    for line in log.splitlines():
        m = re.search(r"(wide_cols_kernel|row_gather_kernel|"
                      r"wide_split_kernel|wide_tma_kernel|"
                      r"split_gather_kernel|fanout_backward_ends_kernel|"
                      r"fanout_backward_coop_kernel|"
                      r"fanout_backward_row_kernel)(?:I(\S*))?", line)
        if "Compiling entry function" in line:
            kernel = "empty_kernel" if "empty_kernel" in line else "?"
            if m and m.group(2) is None:
                kernel = m.group(1)
            elif m:  # a mangled name: the slot source, then the integers
                src = re.search(r"(Table|Cv)(Source|Cols)", m.group(2))
                args = [v if t == "i" else ("false", "true")[int(v)]
                        for t, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
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


def _agree(name: str, got, want, atol: float, rtol: float,
           slack=0.0) -> float:
    err = (got.float() - want).abs()
    if not (torch.isfinite(got).all()
            and (err <= atol + rtol * want.abs() + slack).all()):
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
                 w.to(table.dtype)) for idx, w, *_ in sets]

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


def _library_backward(rows: int, order_bound: bool = False):
    """No single call does the masked weighted scatter-add:
    ``zeros.index_add_`` alone, over the live slots only, with the products
    ``w * g`` made outside the timed window (dead slots sent to one row
    would time that row's atomic contention, not the scatter).  Held
    against the plain version at ``KERNEL_TOL``, with ``order_bound`` plus
    ``_order_slack`` (rows of grad_x that gather ~100 or more slots, whose
    sums differ by ~1e-5 between orders)."""
    def make(g, sets, wants):
        prepared = []
        for pos, w, *_ in sets:
            live = _live(pos, w, rows)
            contrib = w.unsqueeze(-1) * g.unsqueeze(1)
            prepared.append((pos[live].long(), contrib[live].contiguous()))

        def call(i):
            pos, contrib = prepared[i % len(prepared)]
            return torch.zeros((rows, g.shape[1]), dtype=g.dtype,
                               device=g.device).index_add_(0, pos, contrib)

        for i, want in enumerate(wants):
            pos, w = sets[i][:2]
            _agree("library index_add_", call(i), want, *KERNEL_TOL,
                   slack=_order_slack(g, pos, w, rows) if order_bound
                   else 0.0)
        return call, "index_add_ alone over the live slots, product excluded"
    return make


def _in_turns(theirs, ours, **timing) -> list:
    """Device ms a call of another tree's kernel and this tree's on the same
    inputs, in turns: theirs, ours, ours, theirs (``_device_ms``)."""
    return [_device_ms(fn, **timing) for fn in (theirs, ours, ours, theirs)]


def _compare(name, kernel, ref, table, sets, timing: bool,
             kind: str = "gather", rows: int | None = None, library=None,
             sentinel: int | None = None, replaced=None, slack=None,
             other=None):
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
    like the kernel.  ``slack(table, *args)``, where given, is added to the
    tolerance (``_order_slack``).  ``other(module)``, where given, is the
    same kernel of another tree's ``cuda_spmm``: with ``--parent`` it is
    held against the plain version like this one and timed in turns with
    it (``_in_turns``)."""
    rows = table.shape[0] if rows is None else rows
    worst, wants = 0.0, []
    for args in sets:
        out = kernel(table, *args)
        want = ref(table.float(), *args)
        torch.cuda.synchronize()
        worst = max(worst, _agree(name, out, want, *KERNEL_TOL,
                                  slack=0.0 if slack is None
                                  else slack(table, *args)))
        if replaced is not None:
            _agree(f"{name}, the replaced composition",
                   replaced(table, *args), want, *KERNEL_TOL)
        wants.append(want)
    res = {"max_abs_err": worst}
    if timing:
        def call(fn):
            return lambda i: fn(table, *sets[i % len(sets)])
        res["ms"] = _device_ms(call(kernel))
        if other is not None:
            for label, PK in TREES:
                theirs = other(PK)
                for args, want in zip(sets, wants):
                    _agree(f"{name}, {label}", theirs(table, *args), want,
                           *KERNEL_TOL, slack=0.0 if slack is None
                           else slack(table, *args))
                res.setdefault("turns", {})[label] = _in_turns(
                    call(theirs), call(kernel))
        # the plain versions take 30 us to 25 ms a call: 3 windows of 8
        res["plain_ms"] = _device_ms(call(ref), calls=8, reps=3)
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
        elif kind in ("backward ends", "gather ends"):  # (idx, w, ends)
            res["gb_s"] = live * row_bytes / (res["ms"] * 1e6)
            res["ranged"] = sum(int(args[2].clamp(0, k).sum())
                                for args in sets) / len(sets)
            if kind == "gather ends":
                res["bytes"] = kernel_bytes(kind, distinct, row_bytes, f, k,
                                            d, f, ranged=res["ranged"])
            else:
                g_rows = sum(int(m.any(1).sum()) for m in masks) / len(sets)
                res["bytes"] = kernel_bytes(kind, g_rows, row_bytes, f, k,
                                            d, rows, ranged=res["ranged"])
            flops = 2 * live * d
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
    for label, ms in res.get("turns", {}).items():
        times += (f"; in turns with {label}: {label} {ms[0]:.5f}, this tree "
                  f"{ms[1]:.5f}, {ms[2]:.5f}, {label} {ms[3]:.5f} ms/call")
    print(f"kernels: {kname} {case}: max abs err "
          f"{res['max_abs_err']:.3e}{times}")


def _ends_result(res: dict, main: bool = False) -> None:
    """Fold a case of the forward with the ends into ``ENDS_RESULT``: its
    worst error, and the times of the ``main`` case (the real batches)."""
    ENDS_RESULT["max_abs_err"] = max(ENDS_RESULT.get("max_abs_err", 0.0),
                                     res["max_abs_err"])
    if main:
        ENDS_RESULT.update((key, res.get(key)) for key in (
            *MAIN_KEYS, "library", "without_ends_ms", "sparse_mm_ms",
            "turns"))


def _check_ends_launches(label: str, sparse: bool, ends: dict,
                         expected: dict) -> None:
    """Fail unless the fanout launches given the rows' ends on a path
    (``K.ENDS_LAUNCHES``) are ``expected`` where its features are
    padded-sparse (``check_launches``' rules) and none where they are
    dense; record the forward's in ``ENDS_PATHS``."""
    check_launches(f"{label}, given the rows' ends", ends,
                   expected if sparse else {})
    if sparse:
        ENDS_PATHS[label] = ends["fanout_aggregate"]


def _kept_case(results: dict, kname: str, key: str, case: str,
               res: dict) -> None:
    """Print a case and keep it under ``key`` of the kernels JSON line."""
    _report(results, kname, case, res)
    results[kname].setdefault(key, []).append({
        "case": case, **{k: res.get(k) for k in
                         ("max_abs_err", *MAIN_KEYS, "library", "plan",
                          "sparse_mm_ms", "without_ends_ms", "turns")
                         if k in res}})


def _gather_splits(label: str, table, sets, timing: bool = True) -> None:
    """Every split of the gather kernels on ``sets`` (0: one warp per row),
    at any width: held against the plain version, then (``timing``) timed
    like the public function."""
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
        name = "row" if split == 0 else f"x{split}"
        cells.append(f"{name} {_device_ms(call):.5f}" if timing else name)
    print(f"kernels: splits, {label}, "
          f"{'device ms/call' if timing else 'held, not timed'}: "
          f"{'; '.join(cells)}; the public function plans split "
          f"{K.gather_plan(table, f, k)} (0 = row)")


# rows of every kind the gather kernels take: whole 16-byte chunks of 128,
# 256 and 512 bytes (split_gather_kernel), 1024 and 2048 bytes
# (wide_tma_kernel), and rows by 8-, 4- and 2-byte units (602 float32 and
# bfloat16 columns, 301 bfloat16; 13 float32 by element)
EDGE_ROWS = ((64, torch.bfloat16), (64, torch.float32), (128, torch.bfloat16),
             (128, torch.float32), (256, torch.float32),
             (512, torch.bfloat16), (512, torch.float32),
             (602, torch.float32), (602, torch.bfloat16),
             (301, torch.bfloat16), (13, torch.float32))


def _gather_edge_cases(rng, dev) -> float:
    """Every split, and the public function, on the shapes the split must
    get right: K not a multiple of the split, K below the
    warps per row, K = 1, a row whose slots are all dead, F = 1, and
    F = 132 * 8 + 1, at every row kind of ``EDGE_ROWS``.  Returns the
    worst error."""
    worst = 0.0
    for d, dtype in EDGE_ROWS:
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


def _device_table(rows: int, d: int, dtype, sentinel: int, seed: int):
    """A seeded normal ``[rows, d]`` table made on the card, NaN from row
    ``sentinel`` on (a dead slot must never read it)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    table[sentinel:] = float("nan")
    return table


def _order_slack(g, pos, w, rows: int):
    """The most two float32 sums of the same n terms can differ by when
    they add them in different orders: 2 n 2^-24 times the sum of the
    terms' magnitudes, per element of ``grad_x`` (n the most live slots on
    one of its rows).  Atomics, ``index_add_`` and a sparse product each
    add a row's slots in an order of their own; where a row of grad_x
    gathers ~150 slots of unit scale, that is ~1e-5, the size of
    ``KERNEL_TOL`` itself."""
    n = int(torch.bincount(pos[_live(pos, w, rows)].long(),
                           minlength=rows).max())
    return 2 * n * 2.0 ** -24 * K.fanout_aggregate_backward_ref(
        g.abs(), pos, w.abs(), rows)


def _gather_order_slack(table, idx, w, ends):
    """``_order_slack`` for the forward given the rows' ends: 2 n 2^-24
    times the sum of the terms' magnitudes of each output row, n the most
    live slots on a row."""
    live = _live(idx, w, table.shape[0])
    n = int(live.sum(1).max())
    return 2 * n * 2.0 ** -24 * K.fanout_aggregate_ref(
        table.float().abs(), idx, w.abs(), ends)


def _field_csr(i, v, rows: int, transpose: bool = True):
    """The live slots of padded rows ``(i, v)`` as a CSR ``X^T [rows, F]``,
    or ``X [F, rows]`` without ``transpose`` (a host read of the live
    count: not for a spin-queued window)."""
    f = i.shape[0]
    m = _live(i, v, rows)
    r = torch.arange(f, device=i.device)[:, None].expand_as(i)[m]
    at, shape = (([i[m].long(), r], (rows, f)) if transpose
                 else ([r, i[m].long()], (f, rows)))
    with warnings.catch_warnings():      # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack(at), v[m], shape,
            check_invariants=True).coalesce().to_sparse_csr()


def _sparse_mm_ms(g, sets, rows: int, order_bound: bool = False,
                  converted: bool = False):
    """``torch.sparse.mm(X^T, g)``, the one PyTorch call for the gradient in
    W of a padded-sparse layer: each set's live slots as a CSR ``X^T
    [rows, F]``, built outside the timed window and held against the plain
    backward at ``KERNEL_TOL``, with ``order_bound`` plus
    ``_order_slack``.  With ``converted`` also ``(host ms a call with the
    CSR built from the padded rows inside the call, host ms a call of
    sparse.mm alone)``, both on the host clock through a synchronise."""
    xts = [_field_csr(i, v, rows) for i, v, *_ in sets]
    for j, xt in enumerate(xts):
        i, v = sets[j][:2]
        _agree("library torch.sparse.mm", torch.sparse.mm(xt, g),
               K.fanout_aggregate_backward_ref(g, i, v, rows), *KERNEL_TOL,
               slack=_order_slack(g, i, v, rows) if order_bound else 0.0)
    ms = _device_ms(lambda i: torch.sparse.mm(xts[i % len(xts)], g))
    if not converted:
        return ms
    return ms, (_wall_ms(lambda i: torch.sparse.mm(_field_csr(
        *sets[i % len(sets)][:2], rows), g)),
        _wall_ms(lambda i: torch.sparse.mm(xts[i % len(xts)], g)))


def _sparse_mm_forward_ms(table, sets, wants) -> float:
    """``torch.sparse.mm(X, W)``, the one PyTorch call for the forward of a
    padded-sparse layer: each set's live slots as a CSR ``X [F, dim]``,
    built outside the timed window and held against the plain forward's
    ``wants`` at ``KERNEL_TOL``."""
    xs = [_field_csr(i, v, table.shape[0], transpose=False)
          for i, v, *_ in sets]
    for x, want in zip(xs, wants):
        _agree("library torch.sparse.mm (forward)", torch.sparse.mm(x, table),
               want, *KERNEL_TOL)
    return _device_ms(lambda i: torch.sparse.mm(xs[i % len(xs)], table))


def _padded_rows(rng, f: int, k: int, dim: int, kind: str):
    """Padded-sparse rows at the first layer's shape on PubMed-sized data,
    as ``pad_sparse_features`` lays them out (dead slots ``(dim, 0)``) with
    their ends (``live_ends``): ~3.9 live slots a row on average, clustered
    as on a real field (a fifth of the rows hold them, with a geometric
    tail, the others none), columns skewed as word counts are.  ``kind``:
    "prefix" (the live slots first, as the table has them), "not a prefix"
    (the same counts at random places of the row), "live at K-1" (prefix,
    and a fiftieth of the rows also live in their last slot), "clustered
    columns" (prefix, every live slot on one of 4 columns of W)."""
    n_live = np.where(rng.random(f) < 0.2,
                      np.minimum(rng.geometric(1 / 19.5, f), k), 0)
    if kind == "not a prefix":
        rank = np.argsort(np.argsort(rng.random((f, k)), axis=1), axis=1)
        live = rank < n_live[:, None]
    else:
        live = np.arange(k)[None, :] < n_live[:, None]
    if kind == "live at K-1":
        live[rng.random(f) < 0.02, k - 1] = True
    weights = 1.0 / (np.arange(dim) + 10.0)
    cols = 4 if kind == "clustered columns" else dim
    idx = np.full((f, k), dim, np.int32)
    w = np.zeros((f, k), np.float32)
    idx[live] = rng.choice(cols, int(live.sum()),
                           p=weights[:cols] / weights[:cols].sum())
    w[live] = rng.uniform(0.01, 0.2, int(live.sum()))
    return idx, w, live_ends(idx, dim)


def _ends_split(label: str, g, sets, rows: int) -> None:
    """Where the backward's time goes, with and without the ends: the same
    call with every weight zero (the walk, the zero-fill and the barrier),
    with the live slots on uniform rows of ``grad_x`` (no contention), and
    on 25 rows (the fixed cost)."""
    bwd = K.fanout_aggregate_backward
    idx0, w0, ends0 = sets[0][:3]
    dead = torch.zeros_like(w0)
    uniform = torch.where(_live(idx0, w0, rows), torch.randint_like(
        idx0, 0, rows), idx0)
    parts = {"every weight zero": (g, idx0, dead, ends0),
             "the live slots on uniform rows": (g, uniform, w0, ends0),
             "25 rows": (g[:25], idx0[:25], w0[:25], ends0[:25])}
    for with_ends in (True, False):
        times = "; ".join(
            f"{name} {_device_ms(lambda i, a=a: bwd(*a[:3], rows, a[3] if with_ends else None)):.5f}"
            for name, a in parts.items())
        print(f"kernels: fanout_aggregate_backward {label}, "
              f"{'with' if with_ends else 'without'} the ends: {times} "
              f"ms/call")


def _ends_forward_split(label: str, table, sets) -> None:
    """Where the forward with the ends spends its time: an empty launch,
    the same call with every end 0 (reading the ends and writing zero
    rows), with every weight 0 (the walk without a row of the table), and
    on the first 25 and 2,000 rows of each set (a long row to a block, and
    up to 4)."""
    calls = {"an empty launch": lambda i: K.empty_launch(table.device)}
    for name, cut in (("every end 0", lambda i, w, e: (i, w, 0 * e)),
                      ("every weight 0", lambda i, w, e: (i, 0 * w, e)),
                      ("the first 25 rows", lambda *a: tuple(
                          t[:25].contiguous() for t in a)),
                      ("the first 2000 rows", lambda *a: tuple(
                          t[:2000].contiguous() for t in a))):
        cases = [cut(*s_) for s_ in sets]
        calls[name] = (lambda i, cases=cases: K.fanout_aggregate(
            table, *cases[i % len(cases)]))
    times = "; ".join(f"{name} {_device_ms(fn):.5f}"
                      for name, fn in calls.items())
    print(f"kernels: {ENDS_KERNEL} {label}, where the time goes: {times} "
          f"ms/call")


def _many_slots_case(rng, dev, results: dict, sweeps: bool) -> None:
    """The backward with many slots on few rows at the padded-sparse first
    layer's shape on PubMed-sized data (W [500, 32], F = 15,000 field rows
    of nnz_cap = 333 slots, ``_padded_rows``): given the rows' ends
    against the plain version with them, and timed beside the kernel
    without them (every slot read), ``index_add_`` and
    ``torch.sparse.mm``; then the adversarial layouts (live slots not a
    prefix, a live slot at K - 1, every live slot on 4 columns of W), with
    the ends; with ``sweeps``, where the time goes.  On every layout the
    forward with the ends (a seeded W) is held against its plain
    version."""
    rows, d, f, k = MANY_SLOTS
    g = torch.from_numpy(rng.standard_normal((f, d), dtype=np.float32)).to(dev)
    table = torch.from_numpy(rng.standard_normal((rows, d),
                                                 dtype=np.float32)).to(dev)
    bwd, bwd_ref = K.fanout_aggregate_backward, K.fanout_aggregate_backward_ref
    # held at KERNEL_TOL plus the float32 summation-order bound: ~118 live
    # slots of unit scale gather on a row of W
    slack = lambda g_, p, w, *_: _order_slack(g_, p, w, rows)   # noqa: E731
    for kind in ("prefix", "not a prefix", "live at K-1",
                 "clustered columns"):
        sets = [tuple(torch.from_numpy(a).to(dev)
                      for a in _padded_rows(rng, f, k, rows, kind))
                for _ in range(4 if kind == "prefix" else 1)]
        case = (f"many slots on few rows: W [{rows},{d}] F={f} K={k}, "
                f"{kind}, with the rows' ends")
        # held at KERNEL_TOL plus the float32 summation-order bound: up
        # to 333 live slots of unit-scale rows on one output row
        _ends_result(_compare(f"forward {case}", K.fanout_aggregate,
                              K.fanout_aggregate_ref, table, sets, False,
                              slack=_gather_order_slack))
        res = _compare(f"backward {case}",
                       lambda g_, p, w, e: bwd(g_, p, w, rows, e),
                       lambda g_, p, w, e: bwd_ref(g_, p, w, rows, e), g,
                       sets, True, kind="backward ends", rows=rows,
                       library=_library_backward(rows, order_bound=True),
                       slack=slack,
                       other=lambda PK: lambda g_, p, w, e:
                       PK.fanout_aggregate_backward(g_, p, w, rows))
        res["plan"] = "ends"
        if kind == "prefix":
            old = _compare(f"backward {case}, ends left out",
                           lambda g_, p, w, e: bwd(g_, p, w, rows),
                           lambda g_, p, w, e: bwd_ref(g_, p, w, rows), g,
                           sets, True, kind="backward", rows=rows,
                           slack=slack)
            res["without_ends_ms"] = old["ms"]
            res["sparse_mm_ms"] = _sparse_mm_ms(g, sets, rows,
                                                order_bound=True)
            print(f"kernels: fanout_aggregate_backward {case}: without the "
                  f"ends (every slot read, plan {K.backward_plan(f, k)}) "
                  f"{old['ms']:.5f} ms/call, bound {old['bound_ms']:.5f}; "
                  f"torch.sparse.mm of X^T (CSR) {res['sparse_mm_ms']:.5f} "
                  f"ms/call")
            if sweeps:
                _ends_split(f"{case} (seeded)", g, sets, rows)
        _kept_case(results, "fanout_aggregate_backward", "redesigned_cases",
                   case, res)


def _cv_calls(sentinel: int, mod=K):
    """The CV estimator's sampled term as ``fn(hist, pos, w, x, field_in,
    base)``: the kernel (of ``mod``, a tree's ``cuda_spmm``), its plain
    version, and the composition the kernel took over (8 launches: the
    history gather's cast, compare, ``where``, ``index_select`` and
    ``masked_fill``, the subtraction, the fanout kernel, the addition)."""
    def kernel(hist, pos, w, x, field_in, base):
        return mod.cv_fanout_aggregate(x, hist, field_in, sentinel, pos, w,
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
                         library=NO_LIBRARY_CV, replaced=replaced,
                         other=lambda PK, n=n: _cv_calls(n, PK)[0]))
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
    them, must be bitwise reproducible, and is timed with its bound and
    ``embedding_bag`` (the library call, on every row); with ``--parent``,
    in turns with the other trees' kernels (held alike)."""
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
    turns = ""
    for label, PK in TREES:
        _agree(f"fanout {case}, {label}", PK.fanout_aggregate(x, pos, w)[:sub],
               want, *KERNEL_TOL)
        t = _in_turns(lambda i: PK.fanout_aggregate(x, pos, w),
                   lambda i: fan(x, pos, w), calls=8, reps=3)
        turns += (f"; in turns with {label}: {label} {t[0]:.5f}, this tree "
                  f"{t[1]:.5f}, {t[2]:.5f}, {label} {t[3]:.5f} ms/call")
    sub_ms = _device_ms(lambda i: fan(x, pos_s, w_s))
    plain_ms = _device_ms(lambda i: fan_ref(x, pos_s, w_s), calls=8, reps=3)
    # the library call on every row: embedding_bag over x with a zero row
    # appended for the dead slots (remapped outside the window), held
    # against the plain version on the same rows
    ext = torch.cat([x, x.new_zeros((1, d))])
    lib_pos = torch.where(_live(pos, w, c), pos, c).contiguous()
    lib_w = w.to(x.dtype)

    def lib(i):
        return F.embedding_bag(lib_pos, ext, per_sample_weights=lib_w,
                               mode="sum", padding_idx=c)
    _agree(f"fanout {case}, library embedding_bag", lib(0)[:sub], want,
           *KERNEL_TOL)
    lib_ms = _device_ms(lib, calls=8, reps=3)
    del ext
    live = _live(pos, w, c)
    n_live = int(live.sum())
    distinct = torch.unique(pos[live]).numel()
    nbytes = kernel_bytes("gather", distinct, 4 * d, f, k, d, f)
    bound, by = bound_ms(nbytes, 2 * n_live * d)
    # the same count with a row read once per live slot that names it: the
    # traffic where the L2 serves no repeat (not a measurement of it)
    per_slot = kernel_bytes("gather", n_live, 4 * d, f, k, d, f)
    results["fanout_aggregate"]["max_abs_err"] = max(
        results["fanout_aggregate"].get("max_abs_err", 0.0), err)
    print(f"kernels: fanout_aggregate {case}: max abs err {err:.3e} on "
          f"{sub} of the rows; device {ms:.5f} ms/call "
          f"({n_live * 4 * d / (ms * 1e6):.0f} GB/s of live slots); bound "
          f"{bound:.5f} ms ({nbytes / 1e6:.3f} MB: {distinct} distinct rows "
          f"under {n_live} live slots; by {by}) = {bound / ms:.3f} of the "
          f"time; a row read once per live slot {per_slot / 1e6:.3f} MB, "
          f"{1e3 * per_slot / HBM_BYTES_PER_S:.5f} ms = "
          f"{1e3 * per_slot / HBM_BYTES_PER_S / ms:.3f} of the time; "
          f"library {lib_ms:.5f} ms/call (embedding_bag, every row); "
          f"on the {sub} rows alone {sub_ms:.5f} ms/call vs plain "
          f"{plain_ms:.5f} ms/call; bitwise reproducible{turns}")


def _subset_splits(label: str, x, pos, w, sub: int = 1024) -> None:
    """Every split of the gather kernels at a shape too large for the plain
    version: each held against it on the first ``sub`` rows, then timed on
    every row."""
    want = K.fanout_aggregate_ref(x, pos[:sub], w[:sub])
    cells = []
    for split in (0, *SPLITS):
        _agree(f"{label} split {split}", K.gather_aggregate_split(
            x, pos[:sub].contiguous(), w[:sub].contiguous(), split), want,
            *KERNEL_TOL)
        ms = _device_ms(lambda i, s=split: K.gather_aggregate_split(
            x, pos, w, s), calls=8, reps=3)
        cells.append(f"{'row' if split == 0 else f'x{split}'} {ms:.5f}")
    print(f"kernels: splits, {label}, device ms/call: {'; '.join(cells)}; "
          f"the public function plans split "
          f"{K.gather_plan(x, *pos.shape)} (0 = row)")


def phase_wide_kernels(rng, dev, results: dict, sweeps: bool) -> None:
    """Every entry at widths that do not go by 16-byte chunks
    (``WIDE_WIDTHS``; at 602 also a bfloat16 table), against its plain
    version and timed with its bound and library call; the fanout forward
    and backward on compacted slots; the standalone fanout at the Exact
    training shape, held against the plain version on a subset of its
    rows; and the backward with many slots on few rows.  With ``sweeps``,
    every split of the gathers too."""
    floor_ms = _device_ms(lambda i: K.empty_launch(dev))
    print(f"kernels: rows of any width (by unit): launch_floor_ms "
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
            label = (f"{name} [{n + 8},{d}] F=512 K=64 (plan "
                     f"{K.gather_plan(hist, 512, 64)})")
            res = _compare(f"full term d={d} {name}", hbm, hbm_ref, hist,
                           sets, True, library=_library_gather)
            if d == 602:
                _kept_case(results, "hbm_gather_aggregate",
                           "redesigned_cases", label, res)
            else:
                _report(results, "hbm_gather_aggregate", label, res)
            if sweeps:
                _gather_splits(label, hist, sets)
            # the CV kernel on top of it: C = 1024, F = 512, K = 1, a row's
            # columns over warps (wide_cols_kernel); bitwise reproducible
            kernel, ref, replaced = _cv_calls(n)
            cv_sets = _cv_inputs(rng, dev, 512, 1, d, n, 1.0, 4)
            _report(results, "cv_fanout_aggregate",
                    f"{name} [{n + 8},{d}] history C=1024 F=512 K=1 "
                    f"(by column range)",
                    _compare(f"cv d={d} {name}", kernel, ref, hist, cv_sets,
                             True, kind="cv", rows=1024, sentinel=n,
                             library=NO_LIBRARY_CV, replaced=replaced,
                             other=lambda PK: _cv_calls(n, PK)[0]))
            if not torch.equal(kernel(hist, *cv_sets[0]),
                               kernel(hist, *cv_sets[0])):
                fail(f"the CV kernel is not bitwise reproducible at d={d} "
                     f"{name}")
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
            fan_sets = [_compacted_slots(rng, dev, f, k, c, 25 / 64)]
            label = (f"{name} C={c} F={f} K={k} d={d}, compacted slots "
                     f"(plan {K.gather_plan(x, f, k)})")
            _report(results, "fanout_aggregate", label,
                    _compare(f"fanout d={d} {name}", fan, fan_ref, x,
                             fan_sets, True, library=_library_gather))
            if sweeps and d == 602:
                _gather_splits(label, x, fan_sets)
            del x, hist
        del hist32
        # the backward: the training shape's iota, then compacted slots
        g = normal(512, d)
        iota = (512 + torch.arange(512, dtype=torch.int32, device=dev)
                )[:, None].contiguous()
        w1 = torch.from_numpy(rng.uniform(0.5, 1.5, (512, 1)).astype(
            np.float32)).to(dev)
        for case, c, slots, timing in [
                (f"C=1024 F=512 K=1 d={d} (by unit)", 1024, (iota, w1),
                 True),
                (f"C=1024 F=512 K=8 d={d}, compacted slots", 1024,
                 _compacted_slots(rng, dev, 512, 8, 1024, 0.7), False)]:
            res = _compare(f"backward {case}",
                           lambda g_, p, w, c=c: bwd(g_, p, w, c),
                           lambda g_, p, w, c=c: bwd_ref(g_, p, w, c), g,
                           [slots], timing, kind="backward", rows=c,
                           library=_library_backward(c),
                           other=lambda PK, c=c: lambda g_, p, w:
                           PK.fanout_aggregate_backward(g_, p, w, c))
            if timing:
                _kept_case(results, "fanout_aggregate_backward",
                           "redesigned_cases", case, res)
            else:
                _report(results, "fanout_aggregate_backward", case, res)

    # compacted slots at the chunked width: Exact training's second layer
    # (x [33280, 128], F = 512, K = 64), forward and backward
    c, f, k, d = 33_280, 512, 64, 128
    slots = [_compacted_slots(rng, dev, f, k, c, 17 / 64) for _ in range(4)]
    _report(results, "fanout_aggregate",
            f"f32 C={c} F={f} K={k} d={d}, compacted slots (Exact training, "
            f"layer 1)",
            _compare("fanout compacted d=128", fan, fan_ref, normal(c, d),
                     slots, True, library=_library_gather))
    g = normal(f, d)
    _kept_case(results, "fanout_aggregate_backward", "redesigned_cases",
               f"C={c} F={f} K={k} d={d}, compacted slots (Exact training, "
               f"layer 1; plan {K.backward_plan(f, k)})",
               _compare("backward compacted d=128",
                        lambda g_, p, w: bwd(g_, p, w, c),
                        lambda g_, p, w: bwd_ref(g_, p, w, c), g,
                        slots, True, kind="backward", rows=c,
                        library=_library_backward(c)))
    if sweeps:
        dead = torch.zeros_like(slots[0][1])
        print(f"kernels: fanout_aggregate_backward C={c} F={f} K={k} d={d}, "
              f"every slot dead (the zero-fill and the barrier alone): "
              f"device {_device_ms(lambda i: bwd(g, slots[0][0], dead, c)):.5f}"
              f" ms/call")

    # Exact training's first layer at the capacities a pad degree of 64
    # gives: x [98816, 602], F = 33,280, K = 64, ~17 of 64 slots live (the
    # estimators phase repeats this on a real batch of the run)
    c, f, k, d = 98_816, 33_280, 64, 602
    pos, w = _compacted_slots(rng, dev, f, k, c, 17 / 64)
    x = normal(c, d)
    label = (f"f32 C={c} F={f} K={k} d={d}, compacted slots (Exact "
             f"training, layer 0; plan {K.gather_plan(x, f, k)})")
    _fanout_on_row_subset(results, label, x, pos, w)
    if sweeps:
        _subset_splits(label, x, pos, w)
    del x
    _many_slots_case(rng, dev, results, sweeps)


def phase_kernels(seed: int = 0, sweeps: bool = False) -> dict:
    """Kernel vs plain version on the card; returns per-kernel results.
    ``sweeps`` adds the split sweeps that chose the wide rows' plans."""
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
                    True, library=_library_gather,
                    other=lambda PK: PK.hbm_gather_aggregate))
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
    # rows above 512 bytes at the training shape (F=512, K=64): 1024-byte
    # f32 rows (hidden 256+ served in f32), 1024-byte bf16 and 2048-byte
    # f32 rows (PPI's hidden 512); with sweeps, every split
    for wide_d, dtype in [(256, torch.float32), (512, torch.bfloat16),
                          (512, torch.float32)]:
        wide = _device_table(HIST_ROWS, wide_d, dtype, n_nodes, seed=wide_d)
        label = (f"{str(dtype)[6:]} [233008,{wide_d}] F=512 K=64 "
                 f"({wide_d * wide.element_size()}-byte rows, plan "
                 f"{K.gather_plan(wide, 512, 64)})")
        _kept_case(results, "hbm_gather_aggregate", "redesigned_cases", label,
                   _compare(f"full {label}", hbm, hbm_ref, wide, train_sets,
                            True, library=_library_gather))
        if sweeps:
            _gather_splits(label, wide, train_sets)
        del wide

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
                        library=_library_backward(c),
                        other=lambda PK, c=c: lambda g, p, w:
                        PK.fanout_aggregate_backward(g, p, w, c)))

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
    phase_wide_kernels(rng, dev, results, sweeps)
    return results


def _plain_matmul(h, w: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """``L.matmul`` with the plain versions: padded-sparse rows in chunks
    of ``chunk`` rows (the plain version materialises ``[rows, K, out]``)."""
    if not isinstance(h, PaddedSparseFeatures):
        return L.matmul(h, w)
    return torch.cat([K.fanout_aggregate_ref(w, h.idx[i:i + chunk],
                                             h.val[i:i + chunk].float())
                      for i in range(0, h.idx.shape[0], chunk)])


def exact_probs(tr: Trainer, ids: np.ndarray, chunk: int = 8192):
    """Exact inference with the plain versions: the dense chain on every
    node (padded-sparse features through the plain sparse product),
    ``A_full . H`` over all rows in chunks, then the head."""
    spec, g = tr.test_spec, tr.graph_full
    with torch.no_grad():
        h = tr.test_features
        for s in spec.specs:
            if isinstance(s, M.DenseSpec):
                p = tr._eval_params()[s.name]
                h = _plain_matmul(h, p["weights"])
                if s.norm:
                    h = L.layer_norm(h, p["offset"], p["scale"], eps=1e-9)
                h = torch.relu(h) if s.relu else h
            elif isinstance(s, M.AggSpec):
                rows = h.shape[0]
                a = torch.cat([K.hbm_gather_aggregate_ref(
                    h, g.nbr[i:i + chunk], g.w[i:i + chunk])
                    for i in range(0, rows, chunk)])
                # graphsage concatenates the node's own row, gcn does not
                h = a if spec.normalization == "gcn" else torch.cat([h, a],
                                                                     dim=1)
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
    if any(K.ENDS_LAUNCHES.values()):
        fail(f"the main path launched a kernel given row ends: "
             f"{K.ENDS_LAUNCHES}")
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


def _tp_case(results: dict, kname: str, case: str, res: dict) -> None:
    """Print a tensor-parallel width case and keep it under ``tp_cases``
    of the kernels JSON line."""
    _kept_case(results, kname, "tp_cases", case, res)


def phase_tp_kernels(tr: Trainer, results: dict, batches: int = 4,
                     seed: int = 3) -> None:
    """The four kernels at the column widths tensor parallelism gives them
    on one rank of ``--tp 2`` (``TP_KERNEL_WIDTHS``): the recipe's hidden
    128 as 64-column blocks, and hidden 512 as 256-column blocks, on the
    slots of ``batches`` real scheduled batches of the one-process recipe
    (the layer's sampled slots, the train graph's full rows).  The tables
    at d = 64 are a rank's block of the trained histories: the first 64
    columns of the bf16 train history (128-byte rows) and of the f32 eval
    history (256-byte rows, serving's); at d = 256 seeded tables of the
    same rows, bf16 and f32.  Each case held against its plain version and
    timed as in phase 3 (bound, plain version, library call); the cases go
    into the kernels JSON line under
    ``tp_cases``; every split of the full term held against the plain
    version, not timed (the plans were chosen from those times before;
    PERF.md keeps them)."""
    bs, n, dev = tr.cfg.batch_size, tr.ds.num_data, tr.device
    bm = torch.from_numpy(tr._batch_matrix(
        tr.train_iter.data[:batches * bs], bs, n)).to(dev)
    packs = [schedule(tr.gen, tr.graph_train, ids, tr.train_degrees, True,
                      dedup=tr.cfg.field_dedup) for ids in bm]
    c, f = packs[0].fields[0].shape[0], packs[0].fields[1].shape[0]
    slots = [(p.layers[0].slot_pos, p.layers[0].slot_w) for p in packs]
    full = [graph_rows(tr.graph_train, p.fields[1])[:2] for p in packs]
    k_fan, k_full = slots[0][0].shape[1], full[0][0].shape[1]
    rng = np.random.default_rng(seed)
    rows = tr.state.histories[0][0].shape[0]
    wide = torch.from_numpy(rng.standard_normal(
        (rows, 256), dtype=np.float32)).to(dev)
    tables = {64: (tr.state.histories[0][0][:, :64].contiguous(),
                   tr.eval_histories[0][0][:, :64].contiguous(),
                   "a rank's block of the trained"),
              256: (wide.to(torch.bfloat16), wide, "seeded")}
    kernel, ref, replaced = _cv_calls(n)
    for d, (train_h, eval_h, source) in tables.items():
        tag = f"tp width d={d} ({TP_KERNEL_WIDTHS[d]}), train batch"
        acts = torch.from_numpy(rng.standard_normal(
            (c, d), dtype=np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal(
            (f, d), dtype=np.float32)).to(dev)
        x = row_gather(train_h, packs[0].fields[0], sentinel=n).float()
        for hist, kind in ((train_h, "train"), (eval_h, "eval")):
            dt = str(hist.dtype)[6:]
            cv_sets = [(pos, w, acts, p.fields[0],
                        K.hbm_gather_aggregate(hist, *fr))
                       for (pos, w), p, fr in zip(slots, packs, full)]
            _tp_case(results, "cv_fanout_aggregate",
                     f"{tag}: {source} {dt} {kind} history "
                     f"{list(hist.shape)} C={c} F={f} K={k_fan}",
                     _compare(f"cv fanout tp d={d} {kind}", kernel, ref,
                              hist, cv_sets, True, kind="cv", rows=c,
                              sentinel=n, library=NO_LIBRARY_CV,
                              replaced=replaced))
            _tp_case(results, "hbm_gather_aggregate",
                     f"{tag}: {source} {dt} {kind} history "
                     f"{list(hist.shape)} F={f} K={k_full}",
                     _compare(f"full term tp d={d} {kind}",
                              K.hbm_gather_aggregate,
                              K.hbm_gather_aggregate_ref, hist, full, True,
                              library=_library_gather))
            _gather_splits(f"{tag}: {dt} {kind} history d={d} F={f} "
                           f"K={k_full}", hist, full, timing=False)
        _tp_case(results, "fanout_aggregate",
                 f"{tag}: f32 C={c} F={f} K={k_fan}",
                 _compare(f"fanout tp d={d}", K.fanout_aggregate,
                          K.fanout_aggregate_ref, x, slots, True,
                          library=_library_gather))
        _tp_case(results, "fanout_aggregate_backward",
                 f"{tag}: C={c} F={f} K={k_fan} d={d}",
                 _compare(f"backward tp d={d}",
                          lambda g_, p, w: K.fanout_aggregate_backward(
                              g_, p, w, c),
                          lambda g_, p, w: K.fanout_aggregate_backward_ref(
                              g_, p, w, c), g, slots, True, kind="backward",
                          rows=c, library=_library_backward(c)))


def _cycle_shares(save_s: float, epoch_s: float) -> str:
    """A save of ``save_s`` as a share of a ``--ckpt_every k`` cycle (k
    epochs of ``epoch_s`` and the save) for each k of ``CKPT_EVERY``."""
    return ", ".join(f"{100 * save_s / (k * epoch_s + save_s):.1f}% of a "
                     f"--ckpt_every {k} cycle" for k in CKPT_EVERY)


def _secs(xs) -> str:
    return ", ".join(f"{x:.3f}" for x in xs)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _ckpt_run(tr: Trainer, writes: list,
              epochs: int = CYCLE_EPOCHS) -> dict:
    """``epochs`` epochs with a ``Trainer.save()`` after each
    (``--ckpt_every 1`` under ``tr.cfg``), the last write durable: the
    seconds a cycle, each epoch's, each save() call's, the final wait's and
    each npz write's (``writes`` collects them as they end).
    ``train_epoch`` ends reading the loss, so the device is done."""
    n = len(writes)
    epoch_s, save_s = [], []
    _sync(tr.device)
    t0 = time.perf_counter()
    for _ in range(epochs):
        epoch_s.append(_timed(tr.train_epoch))
        save_s.append(_timed(tr.save))
    finish_s = _timed(tr.finish_checkpoints)
    return dict(cycle_s=(time.perf_counter() - t0) / epochs,
                epoch_s=epoch_s, save_s=save_s, finish_s=finish_s,
                write_s=writes[n:])


def _same_files(want: str, got: str) -> int:
    """Fails unless the two npz files hold the same entries in the same
    order, each of the same dtype and bitwise equal; returns the count."""
    with np.load(want) as w, np.load(got) as g:
        if g.files != w.files:
            fail(f"{got} holds other entries than {want}")
        bad = [k for k in w.files if g[k].dtype != w[k].dtype
               or not np.array_equal(g[k], w[k])]
        if bad:
            fail(f"{got} differs from {want} in {bad}")
        return len(w.files)


def _state_copy(tr: Trainer) -> list:
    """Clones of the train state's checkpoint leaves."""
    return [(k, t.clone()) for k, t in
            Ckpt._state_leaves(tr.state, tr.eval_histories)
            if k.startswith("['state']")]


def _resume_check(tr: Trainer, path: str) -> str:
    """A ``--resume`` of ``tr`` from ``path`` (its last save), after one
    more epoch moved the live state on: the counters and every train
    state leaf must come back bitwise."""
    want = _state_copy(tr)
    counters = (tr.completed_epochs, tr.amt_data, list(tr.cost_val))
    tr.train_epoch()
    cfg = tr.cfg
    tr.cfg = cfg.replace(ckpt_dir=os.path.dirname(path), resume=True)
    try:
        epoch = tr._try_resume(log=lambda *a: None)
    finally:
        tr.cfg = cfg
    if (epoch, tr.amt_data, tr.cost_val) != counters:
        fail(f"--resume restored {(epoch, tr.amt_data, tr.cost_val)}, "
             f"saved {counters}")
    bad = [k for (k, w), (_, g) in zip(want, _state_copy(tr))
           if not torch.equal(w, g)]
    if bad:
        fail(f"--resume from the async file differs in {bad}")
    return f"--resume from it restored the counters (completed epochs " \
        f"{epoch}, amt_data {tr.amt_data}) and {len(want)} state leaves " \
        f"bitwise"


def _save_arm(tr: Trainer, sync_cfg, async_cfg, writes: list) -> dict:
    """One ``--ckpt_compress`` setting of :func:`phase_save`: the
    ``--ckpt_every 1`` runs in turns, then one more async save of the last
    (sync) run's state, timed to its return and to the file on disk,
    whose file must equal that run's bitwise."""
    res = {"first": tr._async_ckpt is None, "sync": [], "async": []}
    for mode in SAVE_TURNS:
        tr.cfg = async_cfg if mode else sync_cfg
        res["async" if mode else "sync"].append(_ckpt_run(tr, writes))
    tr.cfg = async_cfg
    t0 = time.perf_counter()
    path = tr.save()
    res["latency_s"] = time.perf_counter() - t0
    if async_cfg.ckpt_compress and not tr._async_ckpt.pending:
        fail("a compressed async save returned after its write")
    tr.finish_checkpoints()
    res["durable_s"] = time.perf_counter() - t0
    res["alone_write_s"] = writes[-1]
    ck = tr._async_ckpt
    if ck._stream is None or not all(h.is_pinned() for h in ck._host):
        fail("the async save ran without its side stream or pinned buffers")
    res["pinned_bytes"] = sum(h.numel() * h.element_size()
                              for h in ck._host or ())
    res["arrays"] = _same_files(
        Ckpt.checkpoint_path(sync_cfg.ckpt_dir), path)
    res["path"] = path
    return res


def _print_save_arm(kind: str, r: dict) -> None:
    """The lines of one ``_save_arm``: the save's latency, its writes, the
    epoch with and without a write in flight, the cycles and the shares."""
    med = statistics.median
    sync, asy = r["sync"], r["async"]
    alone = [e for x in sync for e in x["epoch_s"]]
    beside = [e for x in asy for e in x["epoch_s"][1:]]
    epoch_s, slow_s = med(alone), med(beside) - med(alone)
    sync_save = med([t for x in sync for t in x["save_s"]])
    # a save() that found no write in flight: each async run's first, and
    # the closing one
    free = [x["save_s"][0] for x in asy] + [r["latency_s"]]
    later = med(free[1:] if r["first"] else free)
    on_path = later + max(slow_s, 0.0)
    k = CKPT_EVERY[-1]
    cyc = {m: med([x["cycle_s"] for x in r[m]]) for m in ("sync", "async")}
    print(f"save: Reddit-shaped recipe, one process, {kind} npz of "
          f"{os.path.getsize(r['path'])} bytes; --ckpt_every 1 over "
          f"{CYCLE_EPOCHS} epochs, runs in turns "
          f"{['async' if m else 'sync' for m in SAVE_TURNS]}:", flush=True)
    for mode in ("sync", "async"):
        for x in r[mode]:
            print(f"save: {kind}, {mode}: {x['cycle_s']:.3f} s a cycle; "
                  f"epochs {_secs(x['epoch_s'])} s, save() calls "
                  f"{_secs(x['save_s'])} s, the final wait "
                  f"{x['finish_s']:.3f} s, npz writes {_secs(x['write_s'])}"
                  f" s", flush=True)
    print(f"save: {kind}: a save() with no write in flight returned in "
          f"{_secs(free)} s"
          f"{' (the first allocates the pinned buffers)' if r['first'] else ''}"
          f", against the sync save's {sync_save:.3f} s (median); "
          f"{r['pinned_bytes']} pinned bytes; one more async save of the "
          f"last run's state was on disk {r['durable_s']:.3f} s after the "
          f"call with nothing else running (its npz write "
          f"{r['alone_write_s']:.3f} s), and its {r['arrays']} arrays equal "
          f"the sync file's bitwise", flush=True)
    print(f"save: {kind}: an epoch alone (the sync runs) {epoch_s:.3f} s, "
          f"with an async write in flight (the async runs' epochs 2 on) "
          f"{_secs(beside)} s: {100 * slow_s / epoch_s:+.1f}% (medians)",
          flush=True)
    print(f"save: {kind}: the save's share of a --ckpt_every 1 cycle "
          f"(measured: 1 - epoch alone / cycle, medians): sync "
          f"{100 * (cyc['sync'] - epoch_s) / cyc['sync']:.1f}%, async "
          f"{100 * (cyc['async'] - epoch_s) / cyc['async']:.1f}% (cycle "
          f"{cyc['sync']:.3f} -> {cyc['async']:.3f} s, "
          f"{100 * (1 - cyc['async'] / cyc['sync']):.1f}% shorter); of a "
          f"--ckpt_every {k} cycle (reckoned: the sync save "
          f"{sync_save:.3f} s; the async save's return {later:.3f} s plus "
          f"the epoch's slowdown): sync "
          f"{100 * sync_save / (k * epoch_s + sync_save):.1f}%, async "
          f"{100 * on_path / (k * epoch_s + on_path):.1f}%", flush=True)


def phase_save(tr: Trainer) -> dict:
    """``Trainer.save()`` of the trained recipe, one process, into a
    temporary directory, compressed (the default ``--ckpt_compress``) and
    not, on the host clock, from the state ``sgd_train`` saves (after a
    validation pass, which fills the eval histories).  Each setting
    (``_save_arm``): ``CYCLE_EPOCHS`` epochs with a save after each
    (``--ckpt_every 1``), sync against ``--ckpt_async`` in turns
    (``SAVE_TURNS``; the first async save allocates the pinned buffers),
    every epoch, save() call and npz write timed where it runs: an async
    run's later epochs are the epochs with a write in flight, the sync
    runs' the epochs alone.  The save's share of a ``--ckpt_every k``
    cycle: at k = 1 measured, at k = 10 reckoned from the save's time on
    the critical path.  Fails unless the async save runs on a side stream
    into pinned buffers, a compressed one returns with its write pending,
    the async file holds the sync file's arrays bitwise, and a
    ``--resume`` from the last async file restores the state bitwise."""
    cfg = tr.cfg
    tr.evaluate(tr.ds.val_d)
    writes = []
    write = Ckpt._write_npz

    def timed_write(*args):
        writes.append(_timed(lambda: write(*args)))

    Ckpt._write_npz = timed_write
    out = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_save_") as tmp:
            for compress in (True, False):
                kind = "compressed" if compress else "uncompressed"
                sync_cfg = cfg.replace(
                    ckpt_dir=os.path.join(tmp, kind, "sync"),
                    ckpt_compress=compress, ckpt_async=False)
                async_cfg = sync_cfg.replace(
                    ckpt_dir=os.path.join(tmp, kind, "async"),
                    ckpt_async=True)
                out[kind] = _save_arm(tr, sync_cfg, async_cfg, writes)
                _print_save_arm(kind, out[kind])
            tr.cfg = cfg
            print(f"save: {_resume_check(tr, out[kind]['path'])}",
                  flush=True)
    finally:
        Ckpt._write_npz = write
        tr.cfg = cfg
    return out


def phase_profile(tr: Trainer, steps: int = PROFILE_STEPS,
                  label: str = "CV+PP") -> None:
    """``steps`` more train steps of ``tr`` (the estimator ``label``), first
    timed without the profiler, then under ``torch.profiler``: the top
    device ops, kernels per step and the device's busy share of the
    unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bs, n = tr.cfg.batch_size, tr.ds.num_data
    bm = torch.from_numpy(tr._batch_matrix(
        tr.train_iter.data[:steps * bs], bs, n)).to(tr.device)

    def run():
        tr.state, _ = tr._train_epoch(tr.state, tr.graph_train,
                                      tr.train_features, tr.labels, bm,
                                      tr.gen, tr.importance_train)
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
        print(f"profile: {label}: the profiler recorded no device time (not "
              f"measured)")
        return
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profile: {label}, {steps} train steps, {wall_ms / steps:.3f} "
          f"ms/step "
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
    """Serve from ``tr``'s current (trained) weights: ``Trainer.predict``,
    then the same requests from its exported artifact."""
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        art, art_per_request, art_ms = _serve_from_artifact(
            "Reddit-shaped slice artifact", tr, requests, outs, tmp)
    print(f"slice: from the artifact {art_ms:.2f} ms per later request, "
          f"Trainer.predict {later_ms:.2f}; launches per request "
          f"{art_per_request} from the artifact, {per_request} live")
    check_launches("CV serving from the artifact", art, {
        "cv_fanout_aggregate": None, "hbm_gather_aggregate": None})
    return launches, per_request, art, art_per_request


def phase_activation_stats(tr: Trainer) -> None:
    """``Trainer.activation_stats`` in both modes: every layer's moments
    printed, and all finite."""
    for train in (True, False):
        stats = tr.activation_stats(train=train)
        mode = "training" if train else "evaluation"
        print(f"activation_stats ({mode}): " + "; ".join(
            f"{label} mean {v['mean']:.5g} std {v['std']:.5g} absmax "
            f"{v['absmax']:.5g}" for label, v in stats.items()))
        if not all(np.isfinite(x) for v in stats.values()
                   for x in v.values()):
            fail(f"activation_stats ({mode}): non-finite moments {stats}")


def _is_slot_gathers(tr: Trainer, ids: torch.Tensor) -> None:
    """The two ways to give each IS slot its node's weight multiplier and
    field position: two ``[N+1]`` gathers (what ``is_slots`` does) or one
    gather of a packed ``[N+1, 2]`` table (the JAX package's TPU layout),
    its stack included, timed on one real batch."""
    n, imp = tr.ds.num_data, tr.importance_train
    sel = is_select(tr.gen, tr.graph_train, ids, tr.train_degrees[0], imp)
    cap = field_capacities(ids.shape[0], tr.train_degrees, n,
                           tr.graph_train.pad_degree, importance=True)[0]
    _, pos_table = compact_field(ids, sel.sel_ids, n, cap)
    inv_col = torch.where(sel.selected, sel.total_imp / (
        imp * torch.clamp(sel.n_samples, min=1.0)), 0.0)
    idx = sel.rows_nbr.reshape(-1).to(torch.int64)

    def two(i):
        return inv_col.index_select(0, idx), pos_table.index_select(0, idx)

    def packed(i):
        return torch.stack([inv_col, pos_table.view(torch.float32)],
                           dim=1).index_select(0, idx)

    a, b = two(0)
    got = packed(0)
    if not (torch.equal(got[:, 0], a)
            and torch.equal(got[:, 1].contiguous().view(torch.int32), b)):
        fail("is_slots: the packed gather disagrees with the two gathers")
    print(f"importance: is_slots' lookups on a real batch ({idx.numel()} "
          f"slots over [{n + 1}] tables): two gathers "
          f"{_device_ms(two):.5f} ms, one packed [N+1, 2] gather with its "
          f"stack {_device_ms(packed):.5f} ms")


def _is_kernels(tr: Trainer, results: dict, label: str,
                batches: int) -> None:
    """The fanout and its backward on the slots of ``batches`` real IS
    batches of ``tr``'s recipe, against their plain versions and timed,
    with every split of the gather: seeded activations of the layer's
    width, a seeded gradient.  Folded into ``results[kernel]["is_batches"]``
    beside the main path's shapes."""
    cfg, n = tr.cfg, tr.ds.num_data
    bs = cfg.batch_size
    bm = torch.from_numpy(tr._batch_matrix(
        tr.train_iter.data[:batches * bs], bs, n)).to(tr.device)
    packs = [schedule(tr.gen, tr.graph_train, ids, tr.train_degrees, False,
                      importance=tr.importance_train, dedup=cfg.field_dedup,
                      is_slot_cap=cfg.is_slot_cap) for ids in bm]
    slots = [(p.layers[0].slot_pos, p.layers[0].slot_w) for p in packs]
    c, (f, k) = packs[0].fields[0].shape[0], slots[0][0].shape
    d = cfg.hidden1
    rng = np.random.default_rng(cfg.seed)
    x = torch.from_numpy(rng.standard_normal((c, d), dtype=np.float32)).to(
        tr.device)
    g = torch.from_numpy(rng.standard_normal((f, d), dtype=np.float32)).to(
        tr.device)
    live = sum(int((w != 0).sum()) for _, w in slots) / len(slots)
    hits = [torch.unique(p[w != 0], return_counts=True)[1] for p, w in slots]
    print(f"importance: {label}: {batches} real batches, C={c} F={f} K={k}: "
          f"{live / f:.3f} live slots a row; a position is named by at most "
          f"{max(int(h.max()) for h in hits)} slots, "
          f"{sum(h.float().mean().item() for h in hits) / len(hits):.2f} on "
          f"average (the backward's atomic contention)")
    for kname, res in [
            ("fanout_aggregate", _compare(
                f"fanout {label}", K.fanout_aggregate,
                K.fanout_aggregate_ref, x, slots, True,
                library=_library_gather)),
            ("fanout_aggregate_backward", _compare(
                f"backward {label}",
                lambda g_, p, w: K.fanout_aggregate_backward(g_, p, w, c),
                lambda g_, p, w: K.fanout_aggregate_backward_ref(g_, p, w, c),
                g, slots, True, kind="backward", rows=c,
                library=_library_backward(c)))]:
        case = f"{label} train batch: C={c} F={f} K={k} d={d}"
        _report(results, kname, case, res)
        results[kname].setdefault("is_batches", {})[case] = {
            key: res.get(key) for key in (*MAIN_KEYS, "live", "distinct")}
    _gather_splits(f"{label} train batch: f32 C={c} F={f} K={k}", x, slots)


def phase_importance(ds, results: dict, device: str = "cuda",
                     batches: int = 4) -> dict:
    """Importance sampling on the Reddit-shaped graph at batch
    ``IS_BATCH``, the JAX benchmark's IS record (bench.py:861-874): IS+PP
    with the auto slot cap and with cap 0, and NS+PP at the same batch for
    the ratio.  Each arm: a warm-up epoch, then a timed epoch with the
    counters reset just before it, its launches per step checked exactly;
    ms/step, sampled edges/s, the share of selected slots the cap dropped,
    peak memory.  Then, for each IS arm, the kernels on ``batches`` real
    batches (``_is_kernels``), and for the first the two layouts of
    ``is_slots``' lookups.  Returns {path: launch counts}."""
    paths, ms = {}, {}
    for label, name, over in IS_ARMS:
        cfg = Config(**{**SLICE_CFG, "cv": False, "test_cv": False,
                        "batch_size": IS_BATCH, **over})
        t0 = time.perf_counter()
        tr = Trainer(cfg, ds, device=device)
        t_setup = time.perf_counter() - t0
        tr.train_epoch()
        _sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        amt0 = tr.amt_data
        t0 = time.perf_counter()
        loss, _, _, steps = tr.train_epoch()
        _sync(device)
        secs = time.perf_counter() - t0
        launches = paths[f"{label} train epoch (Reddit, batch {IS_BATCH})"] \
            = dict(K.LAUNCHES)
        es = tr.epoch_stats
        kept = int(es["adj_sizes"].sum())
        dropped = es["is_dropped"]
        ms[label] = 1e3 * secs / steps
        print(f"importance: {label} (batch {IS_BATCH}, Trainer set-up "
              f"{t_setup:.2f} s): {steps} steps in {secs:.3f} s -> "
              f"{ms[label]:.3f} ms/step; {tr.amt_data - amt0} sampled edges "
              f"-> {(tr.amt_data - amt0) / secs:.0f} edges/s; slot cap "
              f"dropped {dropped} of {kept + dropped} selected slots "
              f"({100 * dropped / max(kept + dropped, 1):.4f}%); last loss "
              f"{loss:.5f}; peak device memory {_peak_gib(device):.3f} GiB; "
              f"kernel launches {launches} = "
              f"{ {k: v / steps for k, v in launches.items()} } per step")
        if not np.isfinite(loss):
            fail(f"{label}: non-finite training loss {loss}")
        check_launches(f"a {label} train epoch", launches, {
            k: per * steps for k, per in STEP_LAUNCHES[name].items()})
        if name == "IS+PP":
            if label == IS_ARMS[0][0]:
                _is_slot_gathers(tr, torch.from_numpy(tr._batch_matrix(
                    tr.train_iter.data[:IS_BATCH], IS_BATCH,
                    ds.num_data)[0]).to(tr.device))
            _is_kernels(tr, results, label, batches)
        del tr
    ns = ms["NS+PP"]
    print("importance: ms/step against NS+PP at the same batch: " + "; ".join(
        f"{label} {t / ns:.2f}x" for label, t in ms.items()
        if label != "NS+PP"))
    return paths


def phase_mlp(ds, device: str = "cuda", cfg_kw=CONVERGE_CFG,
              epochs: int = MLP_EPOCHS) -> None:
    """The NeighbourMLP (``--model mlp``) on the SBM: ``epochs`` epochs,
    ms per epoch and val micro-F1 after each; fails on a non-finite
    loss."""
    t0 = time.perf_counter()
    tr = MLPTrainer(Config(**{**cfg_kw, "model": "mlp"}), ds, device=device)
    t_setup = time.perf_counter() - t0
    for epoch in range(epochs):
        _sync(device)
        t0 = time.perf_counter()
        loss, _ = tr.train_epoch()
        _sync(device)
        secs = time.perf_counter() - t0
        f1 = tr.evaluate(ds.val_d)[2]
        print(f"mlp: epoch {epoch + 1}: {1e3 * secs:.1f} ms, last loss "
              f"{loss:.5f}, val micro-F1 {f1:.4f} (features "
              f"{tuple(tr.features.shape)}, set-up {t_setup:.2f} s)")
        if not np.isfinite(loss):
            fail(f"mlp: non-finite training loss {loss}")


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


def _exact_batch_case(exact: Trainer, ds, results: dict) -> None:
    """The standalone fanout on the first layer of a real Exact train batch
    (``_fanout_on_row_subset``): the batch's dedup-compacted slots over
    its field's raw feature rows."""
    n, bs = ds.num_data, exact.cfg.batch_size
    batch = torch.from_numpy(exact._batch_matrix(
        ds.train_d[:bs], bs, n)[0]).to(exact.device)
    pack = schedule(exact.gen, exact.graph_train, batch, exact.train_degrees,
                    False, dedup=exact.cfg.field_dedup)
    x = row_gather(exact.train_features, pack.fields[0], sentinel=n)
    pos, w = pack.layers[0].slot_pos, pack.layers[0].slot_w
    _fanout_on_row_subset(
        results, f"Exact train batch, layer 0: f32 C={x.shape[0]} "
        f"F={pos.shape[0]} K={pos.shape[1]} d={x.shape[1]} (plan "
        f"{K.gather_plan(x, *pos.shape)})", x, pos, w)


def phase_real_batches(results: dict, device: str = "cuda") -> None:
    """For ``--phase kernels``: the kernels on the real batches of the full
    run, without its training: the sparse first layer's on 4 batches of the
    PubMed-sized fixture (``_sparse_layer_kernels`` with its sweeps, ``W``
    as initialised), its forward on the CV arm's served field
    (``_served_field_case``) and the fanout on a real Exact batch's first
    layer of the convergence phase's SBM (``_exact_batch_case``)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_planetoid_fixture(tmp, PlanetoidSpec(**PUBMED_SPEC))
        ds = load_data(Config(dataset="pubmed", data_dir=tmp))
        tr = Trainer(Config(dataset="pubmed", data_dir=tmp, ckpt_dir=tmp),
                     ds, device=device)
        _sparse_layer_kernels(tr, results, sweeps=True)
        # the served field of the CV arm's requests, from its artifact
        key, _, over = PUBMED_ARMS[1]
        tr = Trainer(Config(dataset="pubmed", data_dir=tmp, ckpt_dir=tmp,
                            **over), ds, device=device)
        export_predictor(tr, os.path.join(tmp, "artifact"))
        pred = load_predictor(os.path.join(tmp, "artifact"), device=device)
        _served_field_case(f"PubMed {key} artifact (W as initialised), a "
                           f"request of {len(ds.test_d)} ids", pred.predict,
                           np.asarray(ds.test_d))
        del tr, ds, pred
    sbm = community_sbm_dataset(**SBM_KW)
    _exact_batch_case(Trainer(Config(**{**CONVERGE_CFG, **EXACT_KW}), sbm,
                              device=device), sbm, results)


def phase_estimators(ds, cv_tr: Trainer, cv_curve, device: str = "cuda",
                     cfg_kw=CONVERGE_CFG, target: float = CONVERGE_F1,
                     cvd_epochs: int = CVD_EPOCHS,
                     exact_epochs: int = EXACT_EPOCHS,
                     times: int = GRADVAR_TIMES,
                     dense_ids: int = EXACT_DENSE_IDS, results=None,
                     is_epochs: int = IS_EPOCHS):
    """The other estimators of the repository's A/B on the convergence
    phase's SBM: CVD+PP and Exact to ``target``, det-dropout+PP for an
    epoch, IS+PP for ``is_epochs`` (best val micro-F1 at least
    ``IS_F1_FLOOR``), then the gradient-variance table from the trained CV+PP
    (``cv_tr``) and CVD+PP weights.  With ``results`` (the per-kernel
    results, on the card) the standalone fanout is also held against its
    plain version on the first layer of a real Exact train batch, and each
    estimator's steps are profiled (``phase_profile``).  Returns
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
    if results is not None:
        phase_profile(cvd, label="CVD+PP")
    print(f"estimators: CV+PP's curve, for comparison: "
          f"{', '.join(f'{f:.4f}' for f in cv_curve)}")

    exact = Trainer(Config(**{**cfg_kw, **EXACT_KW}), ds, device=device)
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
        _exact_batch_case(exact, ds, results)
        phase_profile(exact, label="Exact")
    del exact

    det = Trainer(Config(**{**cfg_kw, "det_dropout": True}), ds,
                  device=device)
    counted("det-dropout+PP (cv, det_dropout)", "det-dropout+PP", det, 1,
            None)
    if results is not None:
        phase_profile(det, label="det-dropout+PP")
    del det

    ispp = Trainer(Config(**{**cfg_kw, "cv": False, "test_cv": False,
                             "importance": True, "test_importance": True}),
                   ds, device=device)
    curve = counted("IS+PP (importance, test_importance)", "IS+PP", ispp,
                    is_epochs, None)
    if not max(curve) >= IS_F1_FLOOR:
        fail(f"IS+PP val micro-F1 {max(curve):.4f} < {IS_F1_FLOOR} in "
             f"{is_epochs} epochs")
    if results is not None:
        phase_profile(ispp, label="IS+PP")
    del ispp

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


def _with_sparse_layer(per_step: dict) -> dict:
    """``per_step`` launches plus those of a padded-sparse first layer."""
    return {k: per_step.get(k, 0) + SPARSE_LAYER.get(k, 0)
            for k in {*per_step, *SPARSE_LAYER}}


def _epochs_counted(label: str, tr: Trainer, epochs: int, per_step: dict):
    """``epochs`` epochs of ``tr``, the validation micro-F1 after each.  The
    first is a warm-up; every later train epoch runs with the counters
    reset just before it and read just after, and is timed; their sum must
    be exactly ``per_step`` launches a step.  Returns (launches, steps,
    ms/step, the F1 curve)."""
    total = {name: 0 for name in K.LAUNCHES}
    ends = {name: 0 for name in K.ENDS_LAUNCHES}
    steps, secs, curve = 0, 0.0, []
    if tr.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for epoch in range(epochs):
        if epoch:
            _sync(tr.device)
            K.reset_launches()
            t0 = time.perf_counter()
        loss, _, _, n_steps = tr.train_epoch()
        if epoch:
            _sync(tr.device)
            secs += time.perf_counter() - t0
            steps += n_steps
            for name, count in K.LAUNCHES.items():
                total[name] += count
            for name, count in K.ENDS_LAUNCHES.items():
                ends[name] += count
        if not np.isfinite(loss):
            fail(f"{label}: non-finite training loss {loss}")
        curve.append(tr.evaluate(tr.ds.val_d)[2])
    ms = 1e3 * secs / steps
    print(f"formats: {label}: {steps} timed steps ({epochs - 1} epochs after "
          f"a warm-up) -> {ms:.3f} ms/step; peak device memory "
          f"{_peak_gib(tr.device):.3f} GiB; kernel launches {total} = "
          f"{ {k: v / steps for k, v in total.items()} } per step; val "
          f"micro-F1 by epoch {', '.join(f'{f:.4f}' for f in curve)}")
    check_launches(f"{label} train epochs", total,
                   {k: v * steps for k, v in per_step.items()})
    _check_ends_launches(f"{label} train epochs",
                         isinstance(tr.train_features, PaddedSparseFeatures),
                         ends, {k: v * steps for k, v in SPARSE_LAYER.items()})
    return total, steps, ms, curve


def _serve_from_artifact(label: str, tr: Trainer, requests, live,
                         tmp: str, exact_ids=None):
    """Export ``tr`` (``export_predictor``), load the artifact into a fresh
    ``load_predictor(device="cuda")`` and serve ``requests`` from it, with
    the counters reset just before and read just after.  Fails unless
    every answer equals ``Trainer.predict``'s (``live``) bitwise, a
    repeated first request gives the same bits, and (``exact_ids``) the
    answers on those ids equal exact inference within ``SLICE_ATOL``.
    Returns (launches, launches per request, ms per later request)."""
    path = os.path.join(tmp, f"artifact_{len(os.listdir(tmp))}")
    t0 = time.perf_counter()
    export_predictor(tr, path)
    export_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    t0 = time.perf_counter()
    pred = load_predictor(path, device=tr.device)
    load_s = time.perf_counter() - t0
    _sync(tr.device)
    K.reset_launches()
    outs, times = [], []
    for ids in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(ids))
        _sync(tr.device)
        times.append(time.perf_counter() - t0)
    launches, ends = dict(K.LAUNCHES), dict(K.ENDS_LAUNCHES)
    per_request = {k: v / len(requests) for k, v in launches.items()}
    again = pred.predict(requests[0])
    later_ms = 1e3 * statistics.median(times[1:])
    print(f"artifact: {label}: export_predictor {export_s:.3f} s, artifact "
          f"{nbytes} bytes ({', '.join(sorted(os.listdir(path)))}); "
          f"load_predictor {load_s:.3f} s; {len(requests)} requests of "
          f"{', '.join(str(len(r)) for r in requests)} ids: "
          f"{', '.join(f'{1e3 * t:.2f}' for t in times)} ms -> "
          f"{later_ms:.2f} ms per later request; kernel launches "
          f"{launches} = {per_request} per request")
    for i, (got, want) in enumerate(zip(outs, live)):
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"{label}: request {i} from the artifact differs from "
                 f"Trainer.predict, max abs diff "
                 f"{np.abs(got - want).max() if got.shape == want.shape else got.shape}")
    if not np.array_equal(again, outs[0]):
        fail(f"{label}: a repeated request is not bitwise equal")
    msg = "equal to Trainer.predict bitwise, repeated request bitwise equal"
    if exact_ids is not None:
        exact = exact_probs(tr, exact_ids).cpu().numpy()
        got = pred.predict(exact_ids)
        worst = float(np.abs(got - exact).max())
        if not worst <= SLICE_ATOL:
            fail(f"{label}: the artifact's answers differ from exact "
                 f"inference by {worst:.3e}")
        msg += (f"; max |artifact - exact inference| = {worst:.3e} on "
                f"{len(exact_ids)} ids (atol {SLICE_ATOL})")
    print(f"artifact: {label}: {msg}")
    check_launches(f"{label} requests", launches,
                   {k: None for k, v in launches.items() if v})
    # the Predictor's sparse layer stops at each row's end: ends computed
    # from the artifact's columns at load, the (one-process) Trainer's
    sparse = isinstance(tr.test_features, PaddedSparseFeatures)
    if sparse and not torch.equal(pred._features.ends,
                                  tr.test_features.ends):
        fail(f"{label}: the Predictor's row ends differ from the Trainer's")
    _check_ends_launches(f"{label} requests", sparse, ends,
                         {"fanout_aggregate": None})
    if sparse:
        _served_field_case(f"{label}, a request of {len(requests[0])} ids",
                           pred.predict, requests[0])
    return launches, per_request, later_ms


def _served_field_case(label: str, predict, ids) -> None:
    """The sparse layer's forward given the rows' ends on the layer-0 field
    of a served request: the rows ``predict(ids)`` hands the kernel wrapper
    (caught on their way through ``ops/layers.py``), held against the plain
    version at ``KERNEL_TOL`` and timed (in turns with ``--parent``'s)
    beside the same call with the ends left out (the gather's plan over
    every slot) and ``torch.sparse.mm`` of the field's ``X`` (a CSR built
    before).  A served field holds mostly real nodes, the train batches'
    mostly empty rows; kept in ``ENDS_RESULT["served_field"]``."""
    seen, real = [], L.fanout_aggregate

    def caught(table, idx, w, ends=None):
        seen.append((table.detach(), idx, w, ends))
        return real(table, idx, w, ends)

    L.fanout_aggregate = caught
    try:
        predict(ids)
    finally:
        L.fanout_aggregate = real
    if len(seen) != 1 or seen[0][3] is None:
        fail(f"{label}: the sparse layer was called {len(seen)} times, or "
             f"without the rows' ends")
    table, idx, w, ends = seen[0]
    f, k = idx.shape
    fwd = _compare(f"{label}: forward, with the ends", K.fanout_aggregate,
                   K.fanout_aggregate_ref, table, [(idx, w, ends)], True,
                   kind="gather ends", other=lambda PK: PK.fanout_aggregate)
    old = _compare(f"{label}: forward, the ends left out", K.fanout_aggregate,
                   K.fanout_aggregate_ref, table, [(idx, w)], True)
    mm = _sparse_mm_forward_ms(table, [(idx, w)],
                               [K.fanout_aggregate_ref(table, idx, w)])
    live_rows = int((ends > 0).sum())
    ENDS_RESULT["max_abs_err"] = max(ENDS_RESULT.get("max_abs_err", 0.0),
                                     fwd["max_abs_err"])
    ENDS_RESULT["served_field"] = {
        "case": label, "f": f, "k": k, "live_rows": live_rows,
        "live": fwd["live"], "ranged": fwd["ranged"], "ms": fwd["ms"],
        "bound_ms": fwd["bound_ms"], "without_ends_ms": old["ms"],
        "without_ends_bound_ms": old["bound_ms"], "sparse_mm_ms": mm,
        "turns": fwd.get("turns")}
    turns = "".join(f"; in turns with {tree}: " + ", ".join(
        f"{t:.5f}" for t in ts) for tree, ts in fwd.get("turns", {}).items())
    print(f"kernels: {ENDS_KERNEL}, served field, {label}: W "
          f"{list(table.shape)} F={f} K={k}, {live_rows} rows that own a "
          f"live slot, {fwd['live']:.0f} live slots, {fwd['ranged']:.0f} "
          f"before the ends: max abs err {fwd['max_abs_err']:.3e}; with the "
          f"ends {fwd['ms']:.5f} ms/call (bound {fwd['bound_ms']:.5f}); the "
          f"ends left out (every slot read, the gather's plan split "
          f"{K.gather_plan(table, f, k)}) {old['ms']:.5f} ms/call (bound "
          f"{old['bound_ms']:.5f}); torch.sparse.mm of the field's X (CSR "
          f"built before) {mm:.5f} ms/call{turns}")


def _sparse_layer_kernels(tr: Trainer, results: dict, batches: int = 4,
                          seed: int = 2, sweeps: bool = False) -> None:
    """The sparse first layer's kernels on ``batches`` real train batches:
    the layer-0 field's padded-sparse rows of each freshly scheduled batch
    with their ends, the trained ``W`` as the table (forward) and a seeded
    output gradient (backward), against their plain versions with the ends
    on every row and timed.  Beside the forward with the ends: the same
    kernel with the ends left out (every slot read), ``embedding_bag`` and
    ``torch.sparse.mm`` of the field's ``X`` (a CSR built before); beside
    the backward with the ends: the same kernel with the ends left out,
    ``zeros().index_add_`` over the live slots and ``torch.sparse.mm`` of
    the field's ``X^T`` (a CSR built before, and built inside the call).
    The backward on the first ``SMALL_FIELDS`` rows of each batch (a small
    field of long rows) timed with the ends and held without them; every
    split of the gather held against the plain version; with ``sweeps``,
    where the backward's time goes (``_ends_split``).  Folded into
    ``results[kernel]["sparse_layer_batches"]``, the forward with the ends
    also into ``ENDS_RESULT``."""
    t_phase = time.perf_counter()
    cfg, n = tr.cfg, tr.ds.num_data
    bs = cfg.batch_size
    packs = []
    for _ in range(batches):
        tr.train_iter.shuffle()
        ids = torch.from_numpy(tr._batch_matrix(
            tr.train_iter.data[:bs], bs, n)[0]).to(tr.device)
        packs.append(schedule(tr.gen, tr.graph_train, ids, tr.train_degrees,
                              tr.train_spec.cv, dedup=cfg.field_dedup))
    rows = [M._slice_inputs(tr.train_features, p.fields[0], n)
            for p in packs]
    if any(r.ends is None for r in rows):
        fail("the sliced padded-sparse rows carry no ends")
    sets = [(r.idx, r.val.float().contiguous(), r.ends) for r in rows]
    w = tr.params[M.first_param_layer(tr.train_spec)]["weights"].detach()
    dim, hidden = w.shape
    f, k = sets[0][0].shape
    live = sum(int(_live(i, v, dim).sum()) for i, v, _ in sets) / batches
    ranged = sum(int(e.sum()) for _, _, e in sets) / batches
    long_rows = sum(int((e > 0).sum()) for _, _, e in sets) / batches
    hits = [torch.unique(i[_live(i, v, dim)], return_counts=True)[1]
            for i, v, _ in sets]
    print(f"formats: sparse first layer, {batches} real train batches: "
          f"F={f} field-0 rows, K={k} slots a row (nnz_cap), table W "
          f"[{dim}, {hidden}] f32; {live:.0f} live slots a batch "
          f"({live / f:.1f} a row), {ranged:.0f} slots before the rows' "
          f"ends on {long_rows:.0f} rows that own one; a row of W is named "
          f"by at most {max(int(h.max()) for h in hits)} slots, "
          f"{sum(h.float().mean().item() for h in hits) / batches:.0f} on "
          f"average (the backward's atomic contention)")
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (f, hidden), dtype=np.float32)).to(tr.device)
    case = f"sparse first layer, PubMed train batch: W [{dim},{hidden}] F={f} K={k}"
    fwd = _compare("sparse layer fanout, with the ends", K.fanout_aggregate,
                   K.fanout_aggregate_ref, w, sets, True, kind="gather ends",
                   library=_library_gather,
                   other=lambda PK: PK.fanout_aggregate)
    old_fwd = _compare("sparse layer fanout, the ends left out",
                       K.fanout_aggregate, K.fanout_aggregate_ref, w,
                       [s_[:2] for s_ in sets], True)
    fwd["without_ends_ms"] = old_fwd["ms"]
    fwd["without_ends_bound_ms"] = old_fwd["bound_ms"]
    fwd["sparse_mm_ms"] = _sparse_mm_forward_ms(
        w, sets, [K.fanout_aggregate_ref(w, *s_) for s_ in sets])
    fwd["plan"] = "ends"
    bwd_ends, bwd_ref = K.fanout_aggregate_backward, \
        K.fanout_aggregate_backward_ref

    def with_ends(name, g_, sets_):
        # held at KERNEL_TOL plus the float32 summation-order bound: ~118
        # live slots gather on a row of W
        return _compare(name, lambda g2, p, v, e: bwd_ends(g2, p, v, dim, e),
                        lambda g2, p, v, e: bwd_ref(g2, p, v, dim, e), g_,
                        sets_, True, kind="backward ends", rows=dim,
                        library=_library_backward(dim),
                        slack=lambda g2, p, v, e: _order_slack(g2, p, v, dim),
                        other=lambda PK: lambda g2, p, v, e:
                        PK.fanout_aggregate_backward(g2, p, v, dim))

    def ends_left_out(name, g_, sets_, timing=True):
        return _compare(name, lambda g2, p, v, e: bwd_ends(g2, p, v, dim),
                        lambda g2, p, v, e: bwd_ref(g2, p, v, dim), g_,
                        sets_, timing, kind="backward", rows=dim)

    bwd = with_ends("sparse layer backward", g, sets)
    old = ends_left_out("sparse layer backward, the ends left out", g, sets)
    bwd["without_ends_ms"] = old["ms"]
    bwd["without_ends_bound_ms"] = old["bound_ms"]
    # torch.sparse.mm(X_field^T, g): the field's rows as a CSR matrix
    bwd["sparse_mm_ms"], (conv_ms, mm_wall_ms) = _sparse_mm_ms(
        g, sets, dim, converted=True)
    bwd["sparse_mm_converted_host_ms"] = conv_ms
    bwd["sparse_mm_host_ms"] = mm_wall_ms
    bwd["host_clock_ms"] = _wall_ms(
        lambda i: K.fanout_aggregate_backward(g, *sets[i % batches][:2], dim,
                                              sets[i % batches][2]))
    bwd["plan"] = "ends"
    keys = (*MAIN_KEYS, "live", "distinct", "ranged", "sparse_mm_ms",
            "sparse_mm_converted_host_ms", "sparse_mm_host_ms",
            "host_clock_ms", "without_ends_ms", "without_ends_bound_ms",
            "plan", "turns")
    for kname, res in (("fanout_aggregate", fwd),
                       ("fanout_aggregate_backward", bwd)):
        _report(results, kname, case, res)
        results[kname].setdefault("sparse_layer_batches", {})[case] = {
            key: res.get(key) for key in keys if key in res}
    _ends_result(fwd, main=True)
    print(f"kernels: {ENDS_KERNEL} {case}: {fwd['ms']:.5f} ms/call, bound "
          f"{fwd['bound_ms']:.5f} on the live slots "
          f"({fwd['bytes'] / 1e6:.3f} MB: the ends, {fwd['ranged']:.0f} "
          f"slots before them, {fwd['distinct']:.0f} rows of W, the output) "
          f"= {fwd['bound_ms'] / fwd['ms']:.3f} of the time; the ends left "
          f"out (every slot read, the gather's plan split "
          f"{K.gather_plan(w, f, k)}) {old_fwd['ms']:.5f} ms/call, bound "
          f"{old_fwd['bound_ms']:.5f}; embedding_bag "
          f"{fwd['library_ms']:.5f}; torch.sparse.mm of the field's X (CSR "
          f"built before) {fwd['sparse_mm_ms']:.5f} ms/call")
    print(f"kernels: fanout_aggregate_backward {case}: with the ends "
          f"{bwd['ms']:.5f} ms/call (bound {bwd['bound_ms']:.5f}); the "
          f"ends left out (every slot read, plan {K.backward_plan(f, k)}) "
          f"{old['ms']:.5f} ms/call (bound {old['bound_ms']:.5f}); "
          f"torch.sparse.mm of the field's X^T (CSR built before) "
          f"{bwd['sparse_mm_ms']:.5f} ms/call; on the host clock through a "
          f"synchronise: the kernel {bwd['host_clock_ms']:.5f}, sparse.mm "
          f"{mm_wall_ms:.5f}, sparse.mm with the CSR built from the padded "
          f"rows in the call {conv_ms:.5f} ms/call")
    # a small field of long rows: the first rows of each batch's field,
    # timed with the ends (the ends left out: held, not timed)
    for rows_n in SMALL_FIELDS:
        small = [tuple(t[:rows_n].contiguous() for t in s_) for s_ in sets]
        label = (f"{case}, its first {rows_n} rows (plan "
                 f"{K.backward_plan(rows_n, k)} warps a row)")
        res = with_ends(f"sparse layer backward, first {rows_n} rows",
                        g[:rows_n], small)
        ends_left_out(f"sparse layer backward, first {rows_n} rows, the "
                      f"ends left out", g[:rows_n], small, timing=False)
        res["sparse_mm_ms"] = _sparse_mm_ms(g[:rows_n], small, dim)
        res["plan"] = K.backward_plan(rows_n, k)
        _report(results, "fanout_aggregate_backward", label, res)
        results["fanout_aggregate_backward"]["sparse_layer_batches"][
            label] = {key: res.get(key) for key in keys if key in res}
        print(f"kernels: fanout_aggregate_backward {label}: with the ends "
              f"{res['ms']:.5f} ms/call, torch.sparse.mm "
              f"{res['sparse_mm_ms']:.5f}")
    if sweeps:
        _ends_forward_split(f"{case} (real)", w, sets)
        _ends_split(f"{case} (real)", g, sets, dim)
    _gather_splits(case, w, [s_[:2] for s_ in sets], timing=False)
    print(f"formats: the sparse first layer's kernels on real batches took "
          f"{time.perf_counter() - t_phase:.1f} s (host clock, checks "
          f"included)")


def phase_pubmed(tmp: str, results: dict, epochs: int = PUBMED_EPOCHS,
                 device: str = "cuda"):
    """The Planetoid format at PubMed's size: the port's fixture writer,
    ``load_data``, padded-sparse features on the card; the two arms of
    ``PUBMED_ARMS`` for ``epochs`` epochs each, their launches a step
    checked exactly (the dense path's plus one sparse-layer fanout and its
    backward) and their best val micro-F1 held against
    ``PUBMED_REFERENCE_F1``; the sparse first layer's kernels on real
    batches; the CV arm exported and served from its artifact.  Returns
    ({path: launches}, {arm: launches per step}, launches per request)."""
    t0 = time.perf_counter()
    n = write_planetoid_fixture(tmp, PlanetoidSpec(**PUBMED_SPEC))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = load_data(Config(dataset="pubmed", data_dir=tmp))
    load_s = time.perf_counter() - t0
    if not (sp.issparse(ds.feats) and sp.issparse(ds.test_feats)):
        fail("the Planetoid loader gave dense features")
    nnz = np.diff(ds.test_feats.tocsr().indptr)
    t0 = time.perf_counter()
    pf = pad_sparse_features(ds.test_feats, Config().feat_nnz_cap, n)
    pad_s = time.perf_counter() - t0
    print(f"formats: PubMed-sized Planetoid files: {n} nodes, "
          f"{ds.feature_dim} features, {ds.num_classes} classes, "
          f"{len(ds.train_d)}/{len(ds.val_d)}/{len(ds.test_d)} split, "
          f"{ds.full_adj.nnz} edges; written in {write_s:.2f} s, loaded in "
          f"{load_s:.2f} s (host); PP features (ÂX) {ds.test_feats.nnz} "
          f"nonzeros, {nnz.mean():.1f} a row, at most {nnz.max()}; "
          f"pad_sparse_features {pad_s:.3f} s -> nnz_cap "
          f"{pf.idx.shape[1]} (host)")
    paths, per_step, per_request = {}, {}, None
    for key, label, over in PUBMED_ARMS:
        cfg = Config(dataset="pubmed", data_dir=tmp, ckpt_dir=tmp, **over)
        t0 = time.perf_counter()
        tr = Trainer(cfg, ds, device=device)
        setup_s = time.perf_counter() - t0
        feats = tr.train_features
        if not (isinstance(feats, PaddedSparseFeatures)
                and feats.idx.device.type == feats.val.device.type
                == tr.device.type):
            fail(f"{label}: the features are not padded-sparse on the card")
        print(f"formats: PubMed {label}: Trainer set-up {setup_s:.2f} s; "
              f"features padded-sparse on the card, idx "
              f"{list(feats.idx.shape)} int32, val {str(feats.val.dtype)[6:]}"
              f", nnz_cap {feats.idx.shape[1]}")
        want = _with_sparse_layer(STEP_LAUNCHES[key])
        launches, steps, _, curve = _epochs_counted(
            f"PubMed {label}", tr, epochs, want)
        paths[f"PubMed {key} train epochs"] = launches
        per_step[f"PubMed {key}"] = {k: v / steps
                                     for k, v in launches.items()}
        ref = PUBMED_REFERENCE_F1[key]
        print(f"formats: PubMed {label}: best val micro-F1 {max(curve):.4f} "
              f"against the JAX package's {ref:.4f} on the CPU (fails "
              f"below by more than {PUBMED_F1_ATOL})")
        if max(curve) < ref - PUBMED_F1_ATOL:
            fail(f"PubMed {label}: val micro-F1 {max(curve):.4f} below the "
                 f"reference {ref:.4f} by more than {PUBMED_F1_ATOL}")
        if key == "NS+PP" and results is not None:
            _sparse_layer_kernels(tr, results)
        else:
            ids = np.asarray(ds.test_d)
            live = tr.predict(ids)
            served, per_request, _ = _serve_from_artifact(
                f"PubMed {label} artifact", tr, [ids] * REQUESTS,
                [live] * REQUESTS, tmp, exact_ids=ids)
            paths["PubMed served requests (artifact)"] = served
        del tr
    return paths, per_step, per_request


def _ppi_kernels(tr: Trainer, results: dict, batches: int = 4) -> None:
    """The full term on ``batches`` real PPI train batches (the train
    graph's rows of the output field, F = batch 512, K = its pad degree)
    over the trained bf16 train history and the f32 eval history, rows of
    1024 and 2048 bytes: against the plain version, timed with its bound
    and ``embedding_bag``, with every split; kept under ``ppi_cases``."""
    bs, n = tr.cfg.batch_size, tr.ds.num_data
    bm = torch.from_numpy(tr._batch_matrix(
        tr.train_iter.data[:batches * bs], bs, n)).to(tr.device)
    packs = [schedule(tr.gen, tr.graph_train, ids, tr.train_degrees, True,
                      dedup=tr.cfg.field_dedup) for ids in bm]
    full = [graph_rows(tr.graph_train, p.fields[1])[:2] for p in packs]
    f, k = full[0][0].shape
    for hist, kind in ((tr.state.histories[0][0], "train"),
                       (tr.eval_histories[0][0], "eval")):
        label = (f"PPI train batch: {str(hist.dtype)[6:]} {kind} history "
                 f"{list(hist.shape)} F={f} K={k} "
                 f"({hist.shape[1] * hist.element_size()}-byte rows, plan "
                 f"{K.gather_plan(hist, f, k)})")
        _kept_case(results, "hbm_gather_aggregate", "ppi_cases", label,
                   _compare(f"full term {label}", K.hbm_gather_aggregate,
                            K.hbm_gather_aggregate_ref, hist, full, True,
                            library=_library_gather))
        _gather_splits(label, hist, full)


def phase_ppi(tmp: str, device: str = "cuda", fixture=PPI_FIXTURE,
              cfg_kw=PPI_CFG, serve_ids: int = PPI_SERVE_IDS,
              results: dict | None = None):
    """The GraphSAGE JSON format at PPI's size (multi-label, 121 labels):
    ``configs/ppi.sh``'s flags with the CV recipe for one timed epoch (the
    CV kernels on 2048-byte float32 eval rows), its launches a step checked
    exactly; then the trained model exported and ``PPI_SERVE_IDS`` test
    ids served from the artifact; with ``results``, the full term on real
    batches (``_ppi_kernels``).  Returns ({path: launches}, launches a
    step, launches per request)."""
    os.makedirs(tmp, exist_ok=True)
    prefix = os.path.join(tmp, "ppi")
    t0 = time.perf_counter()
    write_graphsage_fixture(prefix, **fixture)
    write_s = time.perf_counter() - t0
    cfg = Config(**cfg_kw, data_dir=tmp, ckpt_dir=tmp)
    t0 = time.perf_counter()
    ds = load_data(cfg)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = Trainer(cfg, ds, device=device)
    setup_s = time.perf_counter() - t0
    hist = tr.eval_histories[0][0]
    print(f"formats: PPI-sized GraphSAGE files: {ds.num_data} nodes, "
          f"{ds.feature_dim} features, {ds.num_classes} labels "
          f"(multitask {cfg.multitask}), {ds.full_adj.nnz} edges; written "
          f"in {write_s:.2f} s, loaded in {load_s:.2f} s (host); Trainer "
          f"set-up {setup_s:.2f} s, graph padded to "
          f"{tr.graph_full.pad_degree}, eval history {list(hist.shape)} "
          f"{str(hist.dtype)[6:]} ({hist.shape[1] * hist.element_size()}-"
          f"byte rows)")
    if tr.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(tr.device)
    K.reset_launches()
    t0 = time.perf_counter()
    loss, _, _, steps = tr.train_epoch()
    _sync(tr.device)
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    f1 = tr.evaluate(ds.val_d)[2]
    print(f"formats: PPI CV+PP: one epoch of {steps} steps in {secs:.3f} s "
          f"-> {1e3 * secs / steps:.3f} ms/step (first epoch: one-time "
          f"warm-up included); last loss {loss:.5f}; val micro-F1 {f1:.4f}; "
          f"peak device memory {_peak_gib(tr.device):.3f} GiB; kernel "
          f"launches {launches} = "
          f"{ {k: v / steps for k, v in launches.items()} } per step")
    if not np.isfinite(loss):
        fail(f"PPI: non-finite training loss {loss}")
    check_launches("the PPI CV+PP train epoch", launches, {
        k: v * steps for k, v in STEP_LAUNCHES["CV+PP"].items()})
    ids = np.asarray(ds.test_d[:serve_ids])
    live = tr.predict(ids)
    served, per_request, _ = _serve_from_artifact(
        "PPI CV+PP artifact", tr, [ids] * REQUESTS, [live] * REQUESTS, tmp,
        exact_ids=ids)
    if results is not None:
        _ppi_kernels(tr, results)
    return ({"PPI CV+PP train epoch": launches,
             "PPI served requests (artifact)": served},
            {k: v / steps for k, v in launches.items()}, per_request)


def _graph_bytes(g) -> int:
    """Device bytes of a graph's tensors."""
    return sum(t.numel() * t.element_size() for t in vars(g).values()
               if isinstance(t, torch.Tensor))


def _degree_line(adj) -> str:
    deg = np.diff(adj.indptr)
    return (f"{adj.shape[0]} nodes, {adj.nnz} edges, mean degree "
            f"{deg.mean():.1f}, max {deg.max()}, p99 "
            f"{np.percentile(deg, 99):.0f}, p99.9 "
            f"{np.percentile(deg, 99.9):.0f}")


def _graph_line(tr: Trainer) -> str:
    parts = []
    for name, g in (("train", tr.graph_train), ("full", tr.graph_full)):
        if isinstance(g, FlatGraph):
            shape = (f"edge list, budget {g.edge_cap_per_row} of max degree "
                     f"{g.max_degree}, truncated {g.truncated_frac}")
        else:
            shape = f"padded to {g.pad_degree}"
        parts.append(f"{name} graph {shape}, tier_w {g.tier_w} (tier_frac "
                     f"{g.tier_frac:.3f}), {_graph_bytes(g) / 1e6:.1f} MB on "
                     f"the device")
    return "; ".join(parts)


def _counted_epoch(label: str, tr: Trainer, per_step: dict,
                   per_epoch: dict | None = None):
    """One train epoch of ``tr`` with the counters reset just before it and
    read just after, timed; fails unless it launched exactly ``per_step``
    a step plus ``per_epoch`` once, and its loss is finite.  Returns
    (launches, steps, ms/step, loss)."""
    _sync(tr.device)
    K.reset_launches()
    t0 = time.perf_counter()
    loss, _, _, steps = tr.train_epoch()
    _sync(tr.device)
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    expected = {k: v * steps for k, v in per_step.items()}
    for k, v in (per_epoch or {}).items():
        expected[k] = expected.get(k, 0) + v
    if not np.isfinite(loss):
        fail(f"{label}: non-finite training loss {loss}")
    check_launches(f"a {label} train epoch", launches, expected)
    return launches, steps, 1e3 * secs / steps, loss


def _wall_ms(fn, calls: int = 16) -> float:
    """Host time per call of ``fn(i)`` ending in a synchronise: for calls
    that read a value on the host (the two-tier term's big-row count), which
    ``_device_ms`` cannot queue behind its spin."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def _profiled(fn):
    """One call of ``fn()`` under ``torch.profiler``, after a warm-up call:
    (device kernel ms, device kernels, {CUDA runtime call: count}, the
    three kernels of most device time as (name, ms, count)), the runtime
    calls naming any allocation or synchronisation the call makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    runtime = {e.key: e.count for e in events
               if e.device_type == DeviceType.CPU and e.key.startswith("cu")}
    top = [(e.key[:70], dev_us(e) / 1e3, e.count)
           for e in sorted(kernels, key=dev_us, reverse=True)[:3]]
    # None where the profiler recorded no device time (not measured)
    return (sum(dev_us(e) for e in kernels) / 1e3 if kernels else None,
            sum(e.count for e in kernels), runtime, top)


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _fullterm_case(results: dict, case: str, table, sets,
                   floor_ms: float) -> dict:
    """``hbm_gather_aggregate`` on ``sets`` over ``table`` against its plain
    version, timed with its bound and ``embedding_bag``; printed and kept
    under ``results["hbm_gather_aggregate"]["fullterm_cases"]`` with the
    empty launch's time in the same phase."""
    res = _compare(f"full term {case}", K.hbm_gather_aggregate,
                   K.hbm_gather_aggregate_ref, table, sets, True,
                   library=_library_gather)
    _report(results, "hbm_gather_aggregate", case, res)
    results["hbm_gather_aggregate"].setdefault("fullterm_cases", {})[case] = {
        **{key: res.get(key) for key in (*MAIN_KEYS, "live", "distinct")},
        "launch_floor_ms": floor_ms}
    return res


def _edgelist_slots(g: FlatGraph, field, width: int, start: int = 0):
    """The edge-list full term's (neighbour, weight) windows of ``field``,
    renormalised as ``full_neighborhood_mean_edgelist`` gives them."""
    nbr, w, _ = flat_row_windows(g, field, width, start=start)
    return nbr, A._apply_renorm(w, g, field)


def _same_step(a: Trainer, b: Trainer, state, batch) -> tuple:
    """One train step of ``a`` and of ``b`` on ``batch``, each from a copy
    of ``state`` with generators seeded alike; fails unless the two
    schedules are equal.  Returns the largest difference of the logits and
    of the updated parameters."""
    outs = []
    for tr in (a, b):
        st = copy.deepcopy(state)
        dev = tr.device
        pack = schedule(torch.Generator(device=dev).manual_seed(11),
                        tr.graph_train, batch, tr.train_degrees, True,
                        dedup=tr.cfg.field_dedup)
        with torch.no_grad():
            logits, _ = M.forward(st.params, tr.train_spec, pack,
                                  tr.graph_train, st.histories,
                                  tr.train_features,
                                  torch.Generator(device=dev).manual_seed(12),
                                  tr.cfg.keep_prob, train=True)
        step = St.build_train_step(tr.cfg, tr.train_spec, tr.train_degrees,
                                   tr.ds.num_data)
        st, _ = step(st, tr.graph_train, tr.train_features, tr.labels, batch,
                     torch.Generator(device=dev).manual_seed(12), pack=pack)
        outs.append((pack, logits, st.params))
    (pa, la, qa), (pb, lb, qb) = outs
    for fa, fb in zip(pa.fields, pb.fields):
        if not torch.equal(fa, fb):
            fail("the padded and edge-list schedules differ")
    return ((la - lb).abs().max().item(),
            max((qa[l][k] - qb[l][k]).abs().max().item()
                for l in qa for k in qa[l]))


def phase_edgelist(results: dict, device: str = "cuda",
                   sbm_kw=UNCAPPED_SBM_KW, cfg_kw=FULLTERM_CFG,
                   epochs: int = FULLTERM_EPOCHS,
                   repeats: int = FULLTERM_REPEATS,
                   serve_ids: int = FULLTERM_SERVE_IDS,
                   batches: int = 4, widths=(512, 1024)):
    """The edge-list layout on the uncapped SBM at full width (CV+PP, batch
    512): the padded graph, an edge list whose budget covers every edge and
    one with the auto budget, ``epochs`` epochs each, the second counted
    (launches a step exactly the padded CV+PP step's).  Fails unless one
    train step of the covering arm from the padded arm's trained state
    gives its logits and parameters within ``STEP_ATOL``, the covering
    arm's val micro-F1 after ``epochs`` epochs (the mean of ``repeats``
    runs of each arm) lies within ``COVER_F1_ATOL`` of the padded arm's and
    the auto arm's within ``AUTO_F1_ATOL``, the auto budget drops at most
    ``AUTO_TRUNCATED_MAX`` of the edges, and two requests of ``serve_ids``
    test ids served from the auto arm's artifact equal
    ``Trainer.predict``'s bitwise.  Then the full term on the edge list's
    windows of ``batches`` real validation fields against the padded rows
    of the same fields, F in ``widths``.  Returns (the dataset, {path:
    launches}, {estimator: launches a step}, {path: launches a request})."""
    t0 = time.perf_counter()
    ds = community_sbm_dataset(**sbm_kw)
    print(f"fullterm: uncapped SBM built in {time.perf_counter() - t0:.2f} s;"
          f" full graph {_degree_line(ds.full_adj)}; train graph "
          f"{_degree_line(ds.train_adj)}")
    arms = {"padded": {},
            "edge list, covering budget": {"graph_format": "edgelist",
                                           "fadj_edge_mult": COVER_EDGE_MULT},
            "edge list, auto budget": {"graph_format": "edgelist"}}
    trainers, curves, paths, per_step, finals = {}, {}, {}, {}, {}
    for label, over in arms.items():
        before = torch.cuda.memory_allocated() / 2 ** 30 \
            if torch.device(device).type == "cuda" else float("nan")
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = trainers[label] = Trainer(Config(**{**cfg_kw, **over}), ds,
                                       device=device)
        t_setup = time.perf_counter() - t0
        curve, counted = [], None
        for epoch in range(epochs):
            if epoch == 1:
                counted = _counted_epoch(f"{label} CV+PP", tr,
                                         STEP_LAUNCHES["CV+PP"])
            else:
                tr.train_epoch()
            curve.append(tr.evaluate(ds.val_d)[2])
        curves[label] = curve
        finals[label] = [curve[-1]]
        launches, steps, ms, _ = counted
        paths[f"{label} CV+PP train epoch (uncapped SBM)"] = launches
        per_step[f"{label} CV+PP (uncapped SBM)"] = {
            k: v / steps for k, v in launches.items()}
        print(f"fullterm: {label}: set-up {t_setup:.2f} s; {_graph_line(tr)};"
              f" truncated_edges_frac {tr.truncated_edges_frac}; "
              f"{ms:.3f} ms/step (epoch 2, {steps} steps); peak device "
              f"memory {_peak_gib(device):.3f} GiB ({before:.3f} GiB "
              f"resident before the arm); val micro-F1 by epoch "
              f"{', '.join(f'{f:.4f}' for f in curve)}")
        for _ in range(repeats - 1):
            # the first run's protocol: evaluation after every epoch draws
            # from the Trainer's generator too
            again = Trainer(Config(**{**cfg_kw, **over}), ds, device=device)
            for _ in range(epochs):
                again.train_epoch()
                f1_again = again.evaluate(ds.val_d)[2]
            finals[label].append(f1_again)
            del again
    tp = trainers["padded"]
    tc = trainers["edge list, covering budget"]
    ta = trainers["edge list, auto budget"]
    if tc.graph_train.edge_cap_per_row != tc.graph_train.max_degree:
        fail("the covering budget does not cover every edge")
    batch = torch.from_numpy(tp._batch_matrix(
        ds.train_d[:tp.cfg.batch_size], tp.cfg.batch_size,
        ds.num_data)[0]).to(tp.device)
    dl, dp = _same_step(tp, tc, tp.state, batch)
    print(f"fullterm: one train step from the padded arm's trained state, "
          f"padded against the covering edge list: max |logits diff| "
          f"{dl:.3e}, max |params diff| {dp:.3e} (atol {STEP_ATOL})")
    if not (dl <= STEP_ATOL and dp <= STEP_ATOL):
        fail("one train step differs between the padded and edge-list "
             "layouts")
    f1 = {label: statistics.fmean(v) for label, v in finals.items()}
    print(f"fullterm: val micro-F1 after {epochs} epochs, {repeats} runs "
          f"an arm {finals}, means {f1} (covering within {COVER_F1_ATOL} "
          f"of padded, auto within {AUTO_F1_ATOL})")
    if abs(f1["edge list, covering budget"] - f1["padded"]) > COVER_F1_ATOL:
        fail("the covering edge list's val micro-F1 is not the padded one's")
    if abs(f1["edge list, auto budget"] - f1["padded"]) > AUTO_F1_ATOL:
        fail("the auto-budget edge list's val micro-F1 strays from padded")
    if ta.truncated_edges_frac > AUTO_TRUNCATED_MAX:
        fail(f"the auto budget drops {ta.truncated_edges_frac} of the edges")

    requests = [ds.test_d[i * serve_ids:(i + 1) * serve_ids]
                for i in range(2)]
    live = [ta.predict(r) for r in requests]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        art, art_per_request, _ = _serve_from_artifact(
            "uncapped SBM, edge list (auto budget)", ta, requests, live, tmp)
    paths["edge-list requests (artifact)"] = art
    check_launches("edge-list serving from the artifact", art, {
        "cv_fanout_aggregate": None, "hbm_gather_aggregate": None})

    # the full term on real fields: edge-list windows against padded rows
    floor_ms = _device_ms(lambda i: K.empty_launch(device))
    hist = ta.state.histories[0][0]
    for label, g in (("edge list, auto budget", ta.graph_train),
                     ("padded", tp.graph_train)):
        # the build on the host clock, as a lazy epoch pays it; then its
        # device time alone
        build = _wall_ms(lambda i, g=g: A.full_abar(hist, g, ds.num_data),
                         calls=4)
        calls = (-(-(ds.num_data + 1) // A.ABAR_CHUNK)
                 if isinstance(g, FlatGraph) else 1)
        print(f"fullterm: a-bar build on the uncapped train graph, {label} "
              f"({calls} kernel calls): {build:.4f} ms a table, host clock "
              f"with synchronise", flush=True)
        results["hbm_gather_aggregate"].setdefault("lazy_anchor_ms", {})[
            f"a-bar build, uncapped SBM train graph, {label}"] = build
        dev_ms = _device_ms(lambda i, g=g: A.full_abar(hist, g, ds.num_data),
                            calls=ABAR_DEVICE_CALLS)
        prof_ms, kernels, runtime, top = _profiled(
            lambda g=g: A.full_abar(hist, g, ds.num_data))
        nbytes = _abar_bytes(g, hist, ds.num_data)
        print(f"fullterm: a-bar build, {label}: device {dev_ms:.4f} ms a "
              f"table, bound {bound_ms(nbytes, 0)[0]:.4f} ms "
              f"({nbytes / 1e6:.1f} MB: the graph's slots, the history and "
              f"the table once); profiled once: {kernels} kernels recorded, "
              f"{_ms_text(prof_ms)}, CUDA runtime calls {runtime}, most "
              f"device time {top}", flush=True)
        results["hbm_gather_aggregate"].setdefault("lazy_anchor_ms", {})[
            f"a-bar build, uncapped SBM train graph, {label}, device"] = \
            dev_ms
    gf, gp = ta.graph_full, tp.graph_full
    width = min(gf.edge_cap_per_row, gf.max_degree)
    ids = torch.from_numpy(ds.val_d.astype(np.int32)).to(hist.device)
    for f in widths:
        fields = [ids[i * f:(i + 1) * f] for i in range(batches)]
        _fullterm_case(results, f"edge-list windows, bf16 history "
                       f"{list(hist.shape)} F={f} K={width} (real fields)",
                       hist, [_edgelist_slots(gf, fld, width)
                              for fld in fields], floor_ms)
        _fullterm_case(results, f"padded rows, bf16 history "
                       f"{list(hist.shape)} F={f} K={gp.pad_degree} (real "
                       f"fields)", hist,
                       [graph_rows(gp, fld)[:2] for fld in fields], floor_ms)
    return ds, paths, per_step, {"uncapped SBM edge list, artifact":
                                 art_per_request}


def _abar_bytes(g, hist, n: int) -> float:
    """The bytes an a-bar build must move: the graph's (neighbour, weight)
    slots once (the padded rows, or the edge list's blocks), each history
    row once and the ``[R, d]`` float32 table once."""
    slots = g.idx.numel() if isinstance(g, FlatGraph) else g.nbr.numel()
    return (8 * slots + hist.shape[0] * hist.shape[1] * hist.element_size()
            + 4 * hist.shape[0] * hist.shape[1])


def _tier_slots(g, field):
    """The two-tier term's kernel inputs for ``field``: the main slots
    ``[F, tier_w]`` and the compacted tail slots ``[big_cap, width -
    tier_w]``, as ``full_neighborhood_mean`` builds them; and the big-row
    count and capacity."""
    w1, f = g.tier_w, field.shape[0]
    ids = field.to(torch.int64)
    if isinstance(g, FlatGraph):
        width = min(g.edge_cap_per_row, g.max_degree)
        deg = torch.clamp(g.deg.index_select(0, ids), max=width)
    else:
        width, deg = g.pad_degree, g.deg.index_select(0, ids)
    big_cap = A._tier_cap(f, g.tier_frac)
    pos, n_big = A._big_row_positions(deg > w1, big_cap)
    at = torch.cat([ids, ids.new_full((1,), g.num_nodes)]).index_select(
        0, pos.to(torch.int64))
    if isinstance(g, FlatGraph):
        main = _edgelist_slots(g, field, w1)
        tail = _edgelist_slots(g, at.to(torch.int32), width - w1, start=w1)
    else:
        main = (g.nbr[:, :w1].index_select(0, ids),
                g.w[:, :w1].index_select(0, ids))
        tail = (g.nbr[:, w1:].index_select(0, at),
                g.w[:, w1:].index_select(0, at))
    return main, tail, int(n_big), big_cap


def phase_tier(ds, results: dict, device: str = "cuda",
               cfg_kw=FULLTERM_CFG, batch_size: int = TIER_BATCH,
               batches: int = 4):
    """The two-tier full term on the uncapped SBM at batch ``batch_size``,
    where the train field reaches ``TIER_MIN_ROWS``: padded and edge list
    (auto budget), a warm-up and a counted epoch each (2 full-term launches
    a step: main and tail).  On ``batches`` real fields the tiered term
    equals the untiered kernel call within ``KERNEL_TOL``, and a forced
    overflow (a tail capacity below the big-row count) too; both timed on
    the host clock in one window (the tier reads its big-row count on the
    host), and the main and tail kernel calls on the device.  Then
    :func:`_tier_sweep` on each layout's full graph, at the module's own
    gate.  Returns ({path: launches}, {estimator: launches a step})."""
    paths, per_step = {}, {}
    floor_ms = _device_ms(lambda i: K.empty_launch(device))
    gate = A.TIER_MIN_ROWS
    # the port's gate lies above this batch (models/aggregators.py): lowered
    # for this phase, which measures the tier
    A.TIER_MIN_ROWS = batch_size
    full = {}
    try:
        for label, over in (("padded", {}), ("edge list", {"graph_format":
                                                           "edgelist"})):
            full[label] = _tier_arm(
                label, Config(**{**cfg_kw, **over, "batch_size": batch_size}),
                ds, results, device, batches, floor_ms, paths, per_step)
    finally:
        A.TIER_MIN_ROWS = gate
    for label, (g, hist) in full.items():
        _tier_sweep(label, g, hist, results)
    return paths, per_step


def _tier_arm(label: str, cfg, ds, results: dict, device, batches: int,
              floor_ms: float, paths: dict, per_step: dict):
    """One layout of ``phase_tier``; returns its full graph and history
    for :func:`_tier_sweep`."""
    batch_size = cfg.batch_size
    tr = Trainer(cfg, ds, device=device)
    g = tr.graph_train
    if g.tier_w <= 0:
        fail(f"tier: the {label} train graph has no tier split")
    off = dataclasses.replace(g, tier_w=-1)
    tr.train_epoch()
    ms_tier, ms_off = [], []
    for tiered in (True, False, False, True):    # in turns
        tr.graph_train = g if tiered else off
        launches, steps, ms, _ = _counted_epoch(
            f"{'tiered' if tiered else 'untiered'} {label} CV+PP (batch "
            f"{batch_size})", tr,
            TIER_LAUNCHES if tiered else STEP_LAUNCHES["CV+PP"])
        (ms_tier if tiered else ms_off).append(ms)
    tr.graph_train = g
    paths[f"tiered {label} CV+PP train epoch (batch {batch_size})"] = \
        launches
    per_step[f"tiered {label} CV+PP (batch {batch_size})"] = {
        k: v / steps for k, v in launches.items()}
    print(f"tier: {label} (batch {batch_size}): train epochs in turns, "
          f"ms/step: tiered {ms_tier}, untiered {ms_off} ({steps} steps "
          f"an epoch)")
    n = ds.num_data
    bm = torch.from_numpy(tr._batch_matrix(
        tr.train_iter.data[:batches * batch_size], batch_size,
        n)).to(tr.device)
    hist = tr.state.histories[0][0]
    tiny = dataclasses.replace(g, tier_frac=1e-6)
    worst, counts = 0.0, []
    for field in bm:
        want = A.full_neighborhood_mean(hist, off, field)
        got = A.full_neighborhood_mean(hist, g, field)
        worst = max(worst, _agree(f"tiered {label}", got, want,
                                  *KERNEL_TOL))
        counts.append(_tier_slots(g, field)[2:])
    # the forced overflow: a field of the graph's big rows only, with
    # the smallest tail capacity
    deg = g.deg[:n]
    if isinstance(g, FlatGraph):
        deg = torch.clamp(deg, max=min(g.edge_cap_per_row, g.max_degree))
    big = torch.nonzero(deg > g.tier_w).flatten().to(torch.int32)
    over_field = big.repeat(-(-batch_size // big.shape[0]))[:batch_size]
    n_big, cap_tiny = _tier_slots(tiny, over_field)[2:]
    if n_big <= cap_tiny:
        fail("tier: the forced overflow did not overflow")
    worst = max(worst, _agree(
        f"tiered {label}, forced overflow",
        A.full_neighborhood_mean(hist, tiny, over_field),
        A.full_neighborhood_mean(hist, off, over_field), *KERNEL_TOL))
    print(f"tier: {label} (batch {batch_size}): {_graph_line(tr)}; "
          f"launches {launches} in a tiered epoch; on "
          f"{len(bm)} real fields of {batch_size} rows (big rows, "
          f"capacity) {counts}; a forced overflow ({n_big} big rows, "
          f"capacity {cap_tiny}) too: max abs err against the untiered "
          f"call {worst:.3e}")
    fields = list(bm)
    t_tier, t_off = [], []
    for order in range(2):          # tiered, untiered, untiered, tiered
        for graph, times in ((g, t_tier), (off, t_off))[::1 - 2 * order]:
            times.append(_wall_ms(
                lambda i, graph=graph: A.full_neighborhood_mean(
                    hist, graph, fields[i % len(fields)])))
    print(f"tier: {label}: host clock with synchronise, ms per call "
          f"(in turns): tiered {t_tier}, untiered {t_off}")
    slots = [_tier_slots(g, fld) for fld in fields]
    results["hbm_gather_aggregate"].setdefault("tier_wall_ms", {})[
        label] = {"tiered": t_tier, "untiered": t_off}
    width = g.pad_degree if not isinstance(g, FlatGraph) \
        else min(g.edge_cap_per_row, g.max_degree)
    untiered = [_edgelist_slots(g, fld, width) if isinstance(
        g, FlatGraph) else graph_rows(g, fld)[:2] for fld in fields]
    k1, k2 = slots[0][0][0].shape[1], slots[0][1][0].shape[1]
    _fullterm_case(results, f"tier main, {label}, bf16 history "
                   f"{list(hist.shape)} F={batch_size} K={k1} (real "
                   f"fields)", hist, [s[0] for s in slots], floor_ms)
    _fullterm_case(results, f"tier tail, {label}, bf16 history "
                   f"{list(hist.shape)} F={slots[0][3]} K={k2} (real "
                   f"fields)", hist, [s[1] for s in slots], floor_ms)
    _fullterm_case(results, f"untiered, {label}, bf16 history "
                   f"{list(hist.shape)} F={batch_size} K={width} (real "
                   f"fields)", hist, untiered, floor_ms)
    return tr.graph_full, hist


def _tier_sweep(label: str, g, hist, results: dict,
                sizes=TIER_SWEEP_ROWS) -> None:
    """The full term on the full graph ``g`` over fields of ``sizes`` rows
    (prefixes of a seeded permutation of every node, the largest tiling
    it: what an exhaustive pass over the nodes gathers), tiered against
    untiered: equal within ``KERNEL_TOL``, and timed in turns on the host
    clock with synchronise (the tier reads its big-row count on the host,
    so its calls cannot be queued behind a spin).  Where the tier is faster at
    every size from some size on, that size is where ``TIER_MIN_ROWS``
    belongs; printed beside the gate, not checked."""
    n = g.num_nodes
    perm = torch.from_numpy(np.random.default_rng(0).permutation(n).astype(
        np.int32)).to(hist.device)
    off = dataclasses.replace(g, tier_w=-1)
    gate = A.TIER_MIN_ROWS
    A.TIER_MIN_ROWS = 0              # every swept field tiers
    rows = {}
    try:
        for f in sizes:
            field = perm.repeat(-(-f // n))[:f]
            big = _tier_slots(g, field)[2:]
            _agree(f"tier sweep, {label}, F={f}",
                   A.full_neighborhood_mean(hist, g, field),
                   A.full_neighborhood_mean(hist, off, field), *KERNEL_TOL)
            wall = {"tiered": [], "untiered": []}
            for order in range(2):      # tiered, untiered, untiered, tiered
                for key, graph in (("tiered", g),
                                   ("untiered", off))[::1 - 2 * order]:
                    wall[key].append(_wall_ms(
                        lambda i, graph=graph: A.full_neighborhood_mean(
                            hist, graph, field), calls=8))
            rows[f] = {"wall_ms": wall, "big_rows_capacity": list(big)}
            print(f"tier sweep: {label} full graph, F={f} (big rows, "
                  f"capacity {big}): host clock with synchronise, ms a call "
                  f"(in turns) tiered {wall['tiered']}, untiered "
                  f"{wall['untiered']}", flush=True)
    finally:
        A.TIER_MIN_ROWS = gate
    wins = [f for f in sizes
            if max(rows[f]["wall_ms"]["tiered"])
            < min(rows[f]["wall_ms"]["untiered"])]
    tier_from = next((f for f in sizes
                      if all(f2 in wins for f2 in sizes if f2 >= f)), None)
    print(f"tier sweep: {label}: the tier is faster in both turns at F in "
          f"{wins}, at every swept size from {tier_from}; the gate "
          f"TIER_MIN_ROWS is {gate}")
    results["hbm_gather_aggregate"].setdefault("tier_sweep", {})[label] = \
        rows


def phase_lazy(ds, results: dict, device: str = "cuda", cfg_kw=SLICE_CFG,
               batch_sizes=LAZY_BATCHES, batches: int = 4):
    """``--lazy_fullterm`` at the Reddit-shaped recipe, beside the per-step
    (eager) term at the same batch: for each batch size a warm-up and a
    counted epoch of each (lazy: a step launches the CV kernel and the
    backward and no full term, an epoch one full-term call per history
    table, the a-bar table, built inside the timed epoch).  The a-bar build
    is also timed alone, its rows held against the per-step term on
    ``batches`` real fields, and the a-bar kernel call (F = every row)
    against its plain version.  Every Trainer takes the graphs
    ``cap_adj_degree`` gives at the recipe's pad degree (capped once here;
    the cap is seeded).  Returns ({path: launches}, {estimator: launches a
    step})."""
    cuda = torch.device(device).type == "cuda"
    pad = cfg_kw["pad_degree"]
    t0 = time.perf_counter()
    capped = dataclasses.replace(
        ds, train_adj=cap_adj_degree(ds.train_adj, pad, cfg_kw["seed"]),
        full_adj=cap_adj_degree(ds.full_adj, pad, cfg_kw["seed"]))
    print(f"lazy: both graphs capped at degree {pad} in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    kw = {**cfg_kw, "pad_degree": -1}
    paths, per_step, ms = {}, {}, {}
    floor_ms = _device_ms(lambda i: K.empty_launch(device))
    for b in batch_sizes:
        for lazy in (False, True):
            label = f"{'lazy ' if lazy else ''}CV+PP (batch {b})"
            tr = Trainer(Config(**{**kw, "batch_size": b,
                                   "lazy_fullterm": lazy}), capped,
                         device=device)
            g, n = tr.graph_train, capped.num_data
            tr.train_epoch()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            if lazy:
                each, once = LAZY_LAUNCHES["lazy CV+PP"]
            else:
                each, once = (TIER_LAUNCHES if A._tiers(
                    g.tier_w, g.pad_degree, b) else STEP_LAUNCHES["CV+PP"]
                    ), None
            launches, steps, ms[label], loss = _counted_epoch(label, tr,
                                                              each, once)
            paths[f"{label} train epoch (Reddit)"] = launches
            per_step[f"{label} (Reddit)"] = {k: v / steps
                                             for k, v in launches.items()}
            print(f"lazy: {label}: {steps} steps, {ms[label]:.3f} ms/step, "
                  f"epoch {ms[label] * steps / 1e3:.3f} s; last loss "
                  f"{loss:.5f}; peak device memory {_peak_gib(device):.3f} "
                  f"GiB; launches {launches}")
            if not lazy:
                continue
            hist = tr.state.histories[0][0]
            snap, abar = St.lazy_anchor(tr.train_spec, tr.state.histories, g,
                                        n)
            worst = 0.0
            bm = torch.from_numpy(tr._batch_matrix(
                tr.train_iter.data[:batches * b], b, n)).to(tr.device)
            for ids in bm:
                pack = schedule(tr.gen, g, ids, tr.train_degrees, True,
                                dedup=tr.cfg.field_dedup)
                field = pack.fields[1]
                worst = max(worst, _agree(
                    "the a-bar table", abar[0][0].index_select(
                        0, field.long()),
                    A.full_neighborhood_mean(snap[0][0], g, field),
                    *KERNEL_TOL))
            print(f"lazy: {label}: a-bar rows of {len(bm)} real fields "
                  f"against the per-step term: max abs err {worst:.3e}")
            build = _device_ms(lambda i: A.full_abar(hist, g, n), calls=8)
            anchor = _device_ms(lambda i: St.lazy_anchor(
                tr.train_spec, tr.state.histories, g, n), calls=8)
            print(f"lazy: {label}: a-bar build (one kernel call over "
                  f"{g.nbr.shape[0]} rows x {g.pad_degree} slots) "
                  f"{build:.4f} ms, the epoch's anchor (snapshot copy + "
                  f"a-bar) {anchor:.4f} ms, device time; {steps} steps of "
                  f"the epoch")
            results["hbm_gather_aggregate"].setdefault(
                "lazy_anchor_ms", {})[f"batch {b}"] = {
                "abar_build_ms": build, "anchor_ms": anchor}
            if b == batch_sizes[0]:
                _fullterm_case(results, f"a-bar table, bf16 history "
                               f"{list(hist.shape)} F={g.nbr.shape[0]} "
                               f"K={g.pad_degree} (every row of the train "
                               f"graph)", hist, [(g.nbr, g.w)], floor_ms)
            del snap, abar
        print(f"lazy: batch {b}: lazy against eager ms/step "
              f"{ms[f'lazy CV+PP (batch {b})']:.3f} / "
              f"{ms[f'CV+PP (batch {b})']:.3f} = "
              f"{ms[f'lazy CV+PP (batch {b})'] / ms[f'CV+PP (batch {b})']:.3f}"
              f"x")
        del tr
    return paths, per_step


def phase_lazy_converge(ds, device: str = "cuda", cfg_kw=CONVERGE_CFG,
                        max_epochs: int = CONVERGE_EPOCHS,
                        target: float = CONVERGE_F1):
    """Lazy CV+PP on the convergence phase's SBM until its val micro-F1
    reaches ``target`` (fails if not in ``max_epochs``; JAX's on the CPU:
    ``LAZY_REFERENCE``), its second epoch counted; then lazy CVD+PP and
    det-dropout+PP for one counted epoch each (finite losses), with
    det-dropout's j = 1 a-bar table held against the squared-weights term.
    Returns ({path: launches}, {estimator: launches a step})."""
    paths, per_step = {}, {}

    def counted(label, tr):
        launches, steps, ms, loss = _counted_epoch(
            label, tr, *LAZY_LAUNCHES[label])
        paths[f"{label} train epoch (SBM)"] = launches
        per_step[f"{label} (SBM)"] = {k: v / steps
                                      for k, v in launches.items()}
        return ms, loss

    tr = Trainer(Config(**{**cfg_kw, "lazy_fullterm": True}), ds,
                 device=device)
    curve, ms = [], None
    for epoch in range(max_epochs):
        if epoch == 1:
            ms, _ = counted("lazy CV+PP", tr)
        else:
            tr.train_epoch()
        curve.append(tr.evaluate(ds.val_d)[2])
        if epoch and curve[-1] >= target:
            break
    hit = next((i + 1 for i, f in enumerate(curve) if f >= target), None)
    print(f"lazy: lazy CV+PP on the SBM: {ms:.3f} ms/step (epoch 2); val "
          f"micro-F1 by epoch {', '.join(f'{f:.4f}' for f in curve)}; "
          f"reached {target} at epoch {hit} (the JAX package on the CPU: "
          f"epoch {LAZY_REFERENCE['first_epoch']}, best "
          f"{LAZY_REFERENCE['best']} in 15)")
    if hit is None:
        fail(f"lazy CV+PP val micro-F1 {max(curve):.4f} < {target} in "
             f"{max_epochs} epochs")
    del tr
    for label, over in (("lazy CVD+PP", {"cvd": True, "test_cvd": True}),
                        ("lazy det-dropout+PP", {"det_dropout": True})):
        tr = Trainer(Config(**{**cfg_kw, **over, "lazy_fullterm": True}), ds,
                     device=device)
        ms, loss = counted(label, tr)
        msg = ""
        if over.get("det_dropout"):
            g, n = tr.graph_train, ds.num_data
            snap, abar = St.lazy_anchor(tr.train_spec, tr.state.histories,
                                        g, n)
            field = torch.from_numpy(ds.train_d[:cfg_kw["batch_size"]].astype(
                np.int32)).to(tr.device)
            err = _agree("det-dropout's squared a-bar table",
                         abar[0][1].index_select(0, field.long()),
                         A.full_neighborhood_mean(snap[0][1], g, field,
                                                  square=True), *KERNEL_TOL)
            msg = (f"; its j = 1 a-bar table against the squared-weights "
                   f"term: max abs err {err:.3e}")
        print(f"lazy: {label} on the SBM: one epoch, {ms:.3f} ms/step, last "
              f"loss {loss:.5f}{msg}")
        del tr
    return paths, per_step


def phase_ema(tr: Trainer, alpha: float = EMA_ALPHA):
    """``ema_aggregate`` on a real scheduled batch of ``tr`` (the trained
    CV+PP trainer of the SBM: its sampled slots and trained history, seeded
    activations) against its plain computation; fails unless it launched
    one ``fanout_aggregate`` and nothing else.  Returns its launches."""
    n, bs = tr.ds.num_data, tr.cfg.batch_size
    ids = torch.from_numpy(tr._batch_matrix(tr.train_iter.data[:bs], bs,
                                            n)[0]).to(tr.device)
    pack = schedule(tr.gen, tr.graph_train, ids, tr.train_degrees, True,
                    dedup=tr.cfg.field_dedup)
    ls, field_in = pack.layers[0], pack.fields[0]
    hist = tr.state.histories[0]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (field_in.shape[0], hist[0].shape[1]), dtype=np.float32)).to(
            tr.device)
    _sync(tr.device)
    K.reset_launches()
    out, (new_h,) = A.ema_aggregate(x, ls, field_in, hist, alpha,
                                    tr.cfg.normalization)
    _sync(tr.device)
    launches = dict(K.LAUNCHES)
    f = ls.slot_pos.shape[0]
    z = (K.fanout_aggregate_ref(x, ls.slot_pos, ls.slot_w) * alpha
         + hist[0].index_select(0, field_in[:f].long()) * (1 - alpha))
    want_out = torch.cat([x[:f], z], dim=1) \
        if tr.cfg.normalization != "gcn" else z
    err = max(_agree("ema_aggregate", out, want_out, *KERNEL_TOL),
              _agree("ema_aggregate's history", new_h[:f], z, *KERNEL_TOL))
    if not torch.equal(new_h[f:], hist[0].index_select(
            0, field_in[f:].long()).float()):
        fail("ema_aggregate rewrote history rows outside the output field")
    print(f"ema: ema_aggregate (alpha {alpha}) on a real SBM batch (C="
          f"{field_in.shape[0]} F={f} K={ls.slot_pos.shape[1]}, bf16 "
          f"history): max abs err {err:.3e} against its plain computation; "
          f"launches {launches}")
    check_launches("ema_aggregate", launches, {"fanout_aggregate": 1})
    return launches


# ----------------------------- data parallelism ----------------------------

DP_HALO = dict(rows_per_rank=4096, d=128, k=64, n_req=8192)
DP_FIRST_EPOCH_RTOL = 1e-4   # dp against one process, same seed, no dropout
# runs held against a run at another data width keep every history write:
# a scatter capacity multiplier of at least the data width never drops
# (parallel/halo.py::scatter_capacity), and a dropped write would leave a
# staler history row that the other run does not have
NO_DROP = {"scatter_cap_mult": 8.0}
# over the epoch's first steps: then the atomics' order, the ranks' sum
# order and the bf16 history make any two runs drift apart (at world 4 the
# sums differ from step 1 and reached 4.4e-4 by step 32; PERF.md, PR 9)
DP_HELD_STEPS = 8
DP_PREDICT_ATOL = 1e-5       # a dp checkpoint served by one process
DP_PREDICT_IDS = 2048
DP_WARMUP_STEPS = 16         # the owner arm's warm-up before its timed epoch
DP_SHARE_STEPS = 16          # steps of each flag alone (world > 1)
# owner blocks of the aligned step checked at world 1, where the Trainer's
# own layout (owner_blocks = dp) is the classic one
DP_ALIGNED_BLOCKS = 4
OWNER_OVER = {"owner_batching": True, "partition_nodes": "rcm"}
# each arm against --halo_exchange false (exact splits), in turns
EXACT_OVER = {"halo_exchange": False}
DP_ARMS = {"plain": {}, "plain exact": EXACT_OVER, "owner": OWNER_OVER,
           "owner exact": {**OWNER_OVER, **EXACT_OVER}}
# two arms alive at a time, timed in turns: the host-bound step's time
# depends on what else the process holds (on four H100s the
# static-capacity arm ran ~31 ms/step beside three other Trainers and
# ~20 beside one), and a user's run holds one Trainer
DP_PAIRS = (("plain", "plain exact"), ("owner", "owner exact"))
DP_TIMED_TURNS = (0, 1, 1, 0)    # indices into a pair
# at world 1 nothing is routed (parallel/halo.py), so both arms of a pair
# run the same code: each is timed once (turns there time the noise)
DP_TIMED_TURNS_WORLD1 = DP_TIMED_TURNS[:2]
# the edge-list arm's transports in turns, steps a turn
DP_EDGE_TURNS = ("default", "exact", "exact", "default")
DP_EDGE_STEPS = 32
# the SBM owner arm (world > 1): plain and owner-batched CV+PP in turns
DP_SBM_TURNS = ("plain", "owner", "owner", "plain")
# the coordinator arm: a small graph, CV+PP, a checkpoint round trip.  Its
# scatter drops nothing (NO_DROP): the CV refresh before a prediction
# walks the nodes in id order, so at world 4 a rank's block of a refresh
# field is all another rank's rows and the default capacity drops
# eval-history writes; the round trip's two predictions refresh from two
# history states (the second from the rows the first refreshed and saved),
# and only an exact scatter makes them equal.  The default's dropping
# evaluation is held against the JAX package's on the CPU
# (tests/test_torch_parallel_jax.py)
COORD_FLAGS = ["--dataset", "synthetic:8192:64:8", "--cv", "--test_cv",
               "--degree", "1", "--test_degree", "1", "--hidden1", "64",
               "--batch_size", "256", "--test_batch_size", "1024",
               "--epochs", "2", "--seed", "1",
               "--scatter_cap_mult", str(NO_DROP["scatter_cap_mult"])]
COORD_TIMEOUT = 300
# the tp arm: held steps in f32 histories and dedup fields (duplicate
# history writes race on CUDA), timed steps at the recipe and at hidden 512
TP_HELD = {"history_dtype": "float32", "field_dedup": True, **NO_DROP}
TP_HIDDENS = (128, 512)
TP_WARMUP_STEPS = 16
TP_TIMED_STEPS = 64
TP_TIMED_TURNS = (0, 1, 1, 0)    # arm indices: tp, dp, dp, tp
TP_SAVE_REPEATS = 2
TP_POLYAK_STEPS = 64


def _dp_log(*args) -> None:
    if torch.distributed.get_rank() == 0:
        print(*args, flush=True)


def _dp_kernels(tr: Trainer, tag: str = "", seed: int = 2) -> dict:
    """The four kernels on the inputs the data-parallel path gives them on
    this rank, from one real scheduled batch of ``tr``'s recipe (its first
    train batch, owner-grouped and owner-aligned under
    ``--owner_batching``): the CV kernel and the two fanout kernels on the
    gathered ``[R, d]`` buffer of the layer's input rows (``_HaloReader``:
    remapped slots, the buffer's history rows behind an identity field),
    the full term on this rank's history block with the all-gathered
    neighbour rows (of an edge list, its windows built from blocks routed
    from their owners), the slots other ranks own made dead.  Each is held
    against its plain version; rank 0 times them as phase 3 does.
    ``tag`` prefixes the cases.  Returns ``{kernel: (case, result)}``."""
    from stochastic_gcn_tpu_torch.parallel.mesh import all_gather_rows
    mesh, n = tr.mesh, tr.ds.num_data
    timing = mesh.global_rank == 0 and tr.device.type == "cuda"
    bs = tr.cfg.batch_size
    ids = torch.from_numpy(tr._epoch_matrix(tr.train_iter.data[:bs],
                                            bs)[0]).to(tr.device)
    pack = schedule(tr.gen, tr.graph_train, ids, tr.train_degrees, True,
                    dedup=tr.cfg.field_dedup, round_multiple=mesh.size,
                    owner_blocks=mesh.size if tr.cfg.owner_batching else 0)
    ls, field_in, field_out = pack.layers[0], pack.fields[0], pack.fields[1]
    v = A._HaloReader(ls, field_in.shape[0], mesh, field_in, field_out, n)
    hist = tr.state.histories[0][0]
    d = hist.shape[1]
    rng = np.random.default_rng(seed + mesh.rank)
    x = v.rows(torch.from_numpy(rng.standard_normal(
        (field_in.shape[0] // mesh.size, d), dtype=np.float32)).to(
            tr.device))
    hbar = v.hist_rows(hist)
    r, (f, k) = x.shape[0], v.pos.shape
    g = tr.graph_train
    if isinstance(g, FlatGraph):
        fnbr, fw = _edgelist_slots(g, v.field_out,
                                   min(g.edge_cap_per_row, g.max_degree))
    else:
        fnbr, fw, _ = graph_rows(g, v.field_out)
    nbr_all = all_gather_rows(fnbr, mesh).long() - mesh.rank * hist.shape[0]
    w_all = all_gather_rows(fw, mesh)
    mine = (nbr_all >= 0) & (nbr_all < hist.shape[0])
    full_idx = torch.where(mine, nbr_all, hist.shape[0]).to(
        torch.int32).contiguous()
    full_w = torch.where(mine, w_all, 0.0).contiguous()
    base = A.full_neighborhood_mean(hist, g, v.field_out, mesh=mesh)
    grad = torch.from_numpy(rng.standard_normal((f, d), dtype=np.float32)
                            ).to(tr.device)
    kernel, ref, replaced = _cv_calls(r)
    out = {}
    out["cv_fanout_aggregate"] = (
        f"{tag}dp buffer: {str(hbar.dtype)[6:]} history rows [{r}, {d}] "
        f"C={r} F={f} K={k}",
        _compare("dp cv fanout", kernel, ref, hbar,
                 [(v.pos, v.w, x, v.iota, base)], timing, kind="cv", rows=r,
                 sentinel=r, library=NO_LIBRARY_CV, replaced=replaced))
    out["fanout_aggregate"] = (
        f"{tag}dp buffer: f32 C={r} F={f} K={k}",
        _compare("dp fanout", K.fanout_aggregate, K.fanout_aggregate_ref, x,
                 [(v.pos, v.w)], timing, library=_library_gather))
    out["fanout_aggregate_backward"] = (
        f"{tag}dp buffer: C={r} F={f} K={k} d={d}",
        _compare("dp backward",
                 lambda g_, p, w: K.fanout_aggregate_backward(g_, p, w, r),
                 lambda g_, p, w: K.fanout_aggregate_backward_ref(g_, p, w,
                                                                  r),
                 grad, [(v.pos, v.w)], timing, kind="backward", rows=r,
                 library=_library_backward(r)))
    out["hbm_gather_aggregate"] = (
        f"{tag}dp owner side: {str(hist.dtype)[6:]} history block "
        f"{list(hist.shape)} F={full_idx.shape[0]} K={full_idx.shape[1]}",
        _compare("dp full term", K.hbm_gather_aggregate,
                 K.hbm_gather_aggregate_ref, hist, [(full_idx, full_w)],
                 timing, library=_library_gather))
    return out


def _epoch_losses(tr: Trainer, steps: int = 0) -> list:
    """One epoch of ``tr``'s own shuffled batches (its first ``steps``
    when ``steps > 0``), as ``train_epoch`` runs it, returning every
    step's loss (``train_epoch`` keeps the last)."""
    tr.train_iter.shuffle()
    bm = torch.from_numpy(tr._epoch_matrix(
        tr.train_iter.data, tr.cfg.batch_size)).to(tr.device)
    step = St.build_train_step(tr.cfg, tr.train_spec, tr.train_degrees,
                               tr.ds.num_data, tr.mesh)
    losses = []
    for ids in bm[:steps or bm.shape[0]]:
        tr.state, m = step(tr.state, tr.graph_train, tr.train_features,
                           tr.labels, ids, tr.gen,
                           importance=tr.importance_train)
        losses.append(float(m["loss"]))
    return losses


def _dp_first_epoch(ds, device: str, cfg_kw: dict) -> None:
    """The first epoch of CV+PP on ``ds`` with dedup-compacted fields, no
    dropout and a scatter capacity that drops nothing (``NO_DROP``),
    data-parallel, against two one-process runs of the same seed on rank
    0's card, step by step.  The fanout backward's atomics add
    repeated positions in an order that depends on the layout (the dp path
    runs it on a gathered buffer), so the runs part at the float32 rounding
    of a sum after a few steps, and the bf16 history makes that grow to
    ~1e-2 by the end of the epoch; the losses are held to
    ``DP_FIRST_EPOCH_RTOL`` over the first ``DP_HELD_STEPS`` steps, and the
    whole epoch's largest differences are printed, the one-process runs'
    own beside them."""
    cfg = Config(**{**cfg_kw, "field_dedup": True, "dropout": 0.0,
                    "dp": torch.distributed.get_world_size(), **NO_DROP})
    tr = Trainer(cfg, ds, device=device)
    got = np.array(_epoch_losses(tr))
    f1 = tr.evaluate(ds.val_d)[2]
    del tr
    if torch.distributed.get_rank() == 0:
        one, ones = [], []
        for _ in range(2):
            t = Trainer(cfg.replace(dp=1), ds, device=device,
                        distributed=False)
            one.append(np.array(_epoch_losses(t)))
            ones.append(t.evaluate(ds.val_d)[2])
            del t
        spread = np.abs(one[1] - one[0]) / np.abs(one[0])
        dev = np.abs(got - one[0]) / np.abs(one[0])
        held = min(DP_HELD_STEPS, len(got))
        parted = [int(np.argmax(x > 0)) if (x > 0).any() else None
                  for x in (dev, spread)]
        growth = {s: float(f"{dev[:s].max():.3e}")
                  for s in (1, 2, 4, 8, 16, 32, 64) if s <= len(dev)}
        _dp_log(f"dp: first epoch, dp against one process, largest relative "
                f"difference over the first n steps: {growth}")
        _dp_log(f"dp: first epoch (dedup fields, no dropout), {len(got)} "
                f"steps: dp against one process at most {dev[:held].max():.3e}"
                f" over the first {held} steps (rtol {DP_FIRST_EPOCH_RTOL}), "
                f"{dev.max():.3e} over the epoch (first differing step "
                f"{parted[0]}); one process against itself "
                f"{spread.max():.3e} (first differing step {parted[1]}); "
                f"last loss {got[-1]:.6f} against {one[0][-1]:.6f} and "
                f"{one[1][-1]:.6f}, val micro-F1 {f1:.4f} against "
                f"{ones[0]:.4f} and {ones[1]:.4f}")
        if not dev[:held].max() <= DP_FIRST_EPOCH_RTOL:
            fail(f"dp first epoch {got[:held]} differs from one process "
                 f"{one[0][:held]}")
    torch.distributed.barrier()


def _dp_converge(ds, out_dir: str, device: str, cfg_kw: dict,
                 target: float) -> list:
    """CV+PP at the recipe on ``ds`` until the val micro-F1 reaches the
    band, at most ``CONVERGE_EPOCHS`` epochs; then the checkpoint: saved by
    the data-parallel Trainer, loaded by one process on rank 0's card,
    whose predictions must equal the data-parallel ones."""
    world = torch.distributed.get_world_size()
    ckpt = os.path.join(out_dir, "ckpt")
    cfg = Config(**{**cfg_kw, "dp": world, "ckpt_dir": ckpt})
    tr = Trainer(cfg, ds, device=device)
    curve, t0 = [], time.perf_counter()
    for _ in range(CONVERGE_EPOCHS):
        tr.train_epoch()
        curve.append(tr.evaluate(ds.val_d)[2])
        if curve[-1] >= target:
            break
    secs = time.perf_counter() - t0
    _dp_log(f"dp: converge, val micro-F1 by epoch "
            f"{', '.join(f'{f:.4f}' for f in curve)} ({secs:.2f} s with "
            f"evaluation)")
    if max(curve) < target:
        fail(f"dp CV+PP val micro-F1 {max(curve):.4f} < {target} in "
             f"{CONVERGE_EPOCHS} epochs")
    ids = ds.test_d[:DP_PREDICT_IDS]
    got = tr.predict(ids)
    tr.save()
    del tr
    if torch.distributed.get_rank() == 0:
        one = Trainer(cfg.replace(dp=1), ds, device=device, distributed=False)
        one.load(load_history=True)
        want = one.predict(ids)
        err = float(np.abs(got - want).max())
        _dp_log(f"dp: checkpoint of the dp={world} run served by one "
                f"process: {len(ids)} test ids, max abs err {err:.3e}")
        if not err <= DP_PREDICT_ATOL:
            fail(f"a dp checkpoint served by one process differs by {err}")
    torch.distributed.barrier()
    return curve


def _wire_per_step(res: dict) -> str:
    steps = res["steps"]
    per = {k: round(v / steps) for k, v in res["wire"].items()}
    cross = sum(res["wire_cross"].values())
    total = sum(res["wire"].values())
    return (f"collective bytes per step {total / steps:.0f} {per}, of "
            f"which {(total - cross) / steps:.0f} stay on the host and "
            f"{cross / steps:.0f} cross hosts")


def _timed_turns(world: int) -> tuple:
    return DP_TIMED_TURNS if world > 1 else DP_TIMED_TURNS_WORLD1


def _turns(arm: str, world: int) -> str:
    pair = next(p for p in DP_PAIRS if arm in p)
    return "/".join(pair[i] for i in _timed_turns(world))


def _transport(arm: str) -> str:
    return ("exact splits, --halo_exchange false" if "exact" in arm
            else "static-capacity scatter")


def _syncs(res: dict) -> str:
    return "rank 0 only" if res["syncs"] is None else f"{res['syncs']:.1f}"


def _shares(routed: dict) -> dict:
    """The share of each kind of routed rows that the rank owns itself."""
    return {k: round(mine / live, 4) if live else None
            for k, (mine, live) in routed.items()}


def _aligned_step(tr: Trainer, blocks: int) -> dict:
    """One train step (no dropout) from a copy of ``tr``'s state on the
    owner-aligned pack of ``blocks`` blocks of its first owner-grouped
    batch, and one on the classic pack of the same generator: the same
    edges, rows in another order, so the losses and the updated params
    must agree within ``STEP_ATOL``.  At world 1 the Trainer's own layout
    is the classic one (``owner_blocks = dp``), so this is where one card
    runs the aligned layout; the aligned step's launches are checked
    exactly."""
    import math
    from stochastic_gcn_tpu_torch.parallel.mesh import (
        owner_grouped_batch_matrix)
    n, bs, dev = tr.ds.num_data, tr.cfg.batch_size, tr.device
    world = tr.mesh.size
    ids = torch.from_numpy(owner_grouped_batch_matrix(
        tr.train_iter.data[:bs], bs, n, blocks)[0]).to(dev)
    step = St.build_train_step(tr.cfg.replace(dropout=0.0), tr.train_spec,
                               tr.train_degrees, n, tr.mesh)
    out = {}
    for label, b in (("classic", 0), ("aligned", blocks)):
        pack = schedule(torch.Generator(device=dev).manual_seed(11),
                        tr.graph_train, ids, tr.train_degrees, True,
                        dedup=True, round_multiple=math.lcm(blocks, world),
                        owner_blocks=b)
        st = copy.deepcopy(tr.state)
        K.reset_launches()
        st, m = step(st, tr.graph_train, tr.train_features, tr.labels, ids,
                     torch.Generator(device=dev).manual_seed(12), pack=pack)
        _sync(dev)
        out[label] = (float(m["loss"]), st.params, dict(K.LAUNCHES))
    (lc, pc, _), (la, pa, launches) = out["classic"], out["aligned"]
    check_launches(f"an owner-aligned ({blocks} blocks) train step on rank "
                   f"{tr.mesh.rank}", launches, STEP_LAUNCHES["CV+PP"])
    dparams = max((pa[l][k] - pc[l][k]).abs().max().item()
                  for l in pa for k in pa[l])
    res = {"blocks": blocks, "loss_diff": abs(la - lc), "param_diff": dparams}
    if not (res["loss_diff"] <= STEP_ATOL * max(1.0, abs(lc))
            and dparams <= STEP_ATOL):
        fail(f"an owner-aligned train step differs from the classic one: "
             f"{res}")
    return res


def _timed_epoch(label: str, tr: Trainer) -> dict:
    """One epoch of ``tr`` with the launch, wire and routed-row counters
    reset just before it; launches checked exactly per rank.  Also the
    epoch's ``hist_dropped`` (``Trainer.epoch_stats``)."""
    from stochastic_gcn_tpu_torch.parallel import mesh as PM
    device = tr.device
    _sync(device)
    K.reset_launches()
    PM.reset_wire()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    amt0 = tr.amt_data
    t0 = time.perf_counter()
    loss, _, _, steps = tr.train_epoch()
    _sync(device)
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check_launches(f"a dp={tr.mesh.size} {label} train epoch on rank "
                   f"{tr.mesh.rank}", launches,
                   {name: per * steps for name, per in
                    STEP_LAUNCHES["CV+PP"].items()})
    if not np.isfinite(loss):
        fail(f"dp {label}: non-finite training loss {loss}")
    return dict(steps=steps, secs=secs, loss=loss, edges=tr.amt_data - amt0,
                launches=launches, wire=dict(PM.WIRE),
                wire_cross=dict(PM.WIRE_CROSS_HOST),
                routed=PM.routed_counts(),
                hist_dropped=tr.epoch_stats["hist_dropped"],
                peak_gib=_peak_gib(device))


def _dp_profile(label: str, tr: Trainer, steps: int = PROFILE_STEPS,
                detail: bool = True):
    """``steps`` train steps of ``tr`` on every rank, timed on the host
    clock, then ``steps`` more with rank 0 under ``torch.profiler``: rank
    0 prints the device's busy share of the unprofiled steps, with
    ``detail`` the device kernels and the host operators of most time
    (the host's profiled, so inflated; a collective's kernel counts its
    wait for the other ranks), and the CUDA runtime calls that wait for
    the device.  Returns rank 0's stream syncs a step
    (``cudaStreamSynchronize`` and ``cudaDeviceSynchronize`` calls), None
    on the other ranks and off the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bs = tr.cfg.batch_size
    bm = torch.from_numpy(tr._epoch_matrix(tr.train_iter.data,
                                           bs)[:2 * steps]).to(tr.device)
    step = St.build_train_step(tr.cfg, tr.train_spec, tr.train_degrees,
                               tr.ds.num_data, tr.mesh)

    def run(rows):
        for ids in rows:
            tr.state, _ = step(tr.state, tr.graph_train, tr.train_features,
                               tr.labels, ids, tr.gen)
        _sync(tr.device)

    _sync(tr.device)
    t0 = time.perf_counter()
    run(bm[:steps])
    wall_ms = 1e3 * (time.perf_counter() - t0)
    if torch.distributed.get_rank() != 0 or tr.device.type != "cuda":
        run(bm[steps:])
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(bm[steps:])

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3 / steps
    print(f"dp profile: {label}, rank 0 of {tr.mesh.size}: "
          f"{wall_ms / steps:.3f} ms/step unprofiled; device busy "
          f"{busy:.3f} ms/step ({100 * busy * steps / wall_ms:.1f}% of the "
          f"wall time); {sum(e.count for e in kernels) / steps:.1f} device "
          f"kernels per step", flush=True)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    if detail:
        for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
            print(f"dp profile:   device {dev_us(e) / steps:9.1f} us/step "
                  f"{e.count / steps:6.1f}x  {e.key[:80]}", flush=True)
        for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:8]:
            print(f"dp profile:   host {e.self_cpu_time_total / steps:9.1f} "
                  f"us/step {e.count / steps:6.1f}x  {e.key[:80]}",
                  flush=True)
    waits = {e.key: e.count / steps for e in host
             if "Synchronize" in e.key or "Memcpy" in e.key}
    print(f"dp profile:   runtime calls that wait, per step: {waits}",
          flush=True)
    return sum(n for k, n in waits.items() if "Synchronize" in k)


def _dp_arms(ds, cfg, device: str) -> dict:
    """The Reddit-shaped recipe four times (``DP_ARMS``): as it is
    (``plain``) and owner-batched with ``--partition_nodes rcm``
    (``owner``), each with the default halo (the history scatter at its
    static capacity) and with ``--halo_exchange false`` (exact splits), a
    pair at a time
    (``DP_PAIRS``): each Trainer warmed up (a whole epoch; the owner arms
    ``DP_WARMUP_STEPS`` steps), then timed epochs in turns
    (``DP_TIMED_TURNS``, each arm twice, so the host's drift falls on
    both; once at world 1, where both run the same code); each arm's
    results are its first timed epoch's, with every
    epoch's seconds beside them, and the stream syncs a step of a 10-step
    profile; then the four kernels on the default arm's inputs, and
    :func:`_aligned_step` from the owner arm's state."""
    world = torch.distributed.get_world_size()
    labels = {"plain": "CV+PP", "owner": "owner-batched CV+PP"}
    res = {}
    for pair in DP_PAIRS:
        trs = {}
        for arm in pair:
            t0 = time.perf_counter()
            trs[arm] = tr = Trainer(cfg.replace(**DP_ARMS[arm]), ds,
                                    device=device)
            res[arm] = {"setup_s": time.perf_counter() - t0,
                        "batch": cfg.batch_size,
                        "hist_bytes": sum(h.numel() * h.element_size()
                                          for hl in (*tr.state.histories,
                                                     *tr.eval_histories)
                                          for h in hl)}
            if arm.startswith("owner"):
                _epoch_losses(tr, DP_WARMUP_STEPS)
            else:
                tr.train_epoch()
        for i in _timed_turns(world):
            arm = pair[i]
            got = _timed_epoch(arm, trs[arm])
            if "secs_turns" not in res[arm]:
                res[arm].update(got, secs_turns=[])
            res[arm]["secs_turns"].append(got["secs"])
        for arm in pair:
            res[arm]["syncs"] = _dp_profile(arm, trs[arm],
                                            detail=arm in labels)
        main = pair[0]
        res[main]["kernels"] = _dp_kernels(trs[main], f"{labels[main]}, ")
        if main == "owner":
            res[main]["aligned_step"] = _aligned_step(
                trs[main], max(world, DP_ALIGNED_BLOCKS))
        del trs, tr
        if device == "cuda":
            torch.cuda.empty_cache()
    return res


def _timed_steps(tr: Trainer, steps: int) -> dict:
    """``steps`` train steps of ``tr``'s shuffled batches with the wire
    counters reset just before them and no host read between them:
    ms/step, collective bytes a step (all and all-to-all) and
    ``hist_dropped`` over the steps."""
    from stochastic_gcn_tpu_torch.parallel import mesh as PM
    tr.train_iter.shuffle()
    bm = torch.from_numpy(tr._epoch_matrix(
        tr.train_iter.data, tr.cfg.batch_size)[:steps]).to(tr.device)
    step = St.build_train_step(tr.cfg, tr.train_spec, tr.train_degrees,
                               tr.ds.num_data, tr.mesh)
    _sync(tr.device)
    PM.reset_wire()
    drops = []
    t0 = time.perf_counter()
    for ids in bm:
        tr.state, m = step(tr.state, tr.graph_train, tr.train_features,
                           tr.labels, ids, tr.gen)
        drops.append(m["hist_dropped"])
    _sync(tr.device)
    n = len(drops)
    return {"steps": n, "ms": 1e3 * (time.perf_counter() - t0) / n,
            "wire": sum(PM.WIRE.values()) / n,
            "all_to_all": PM.WIRE["all_to_all"] / n,
            "hist_dropped": int(torch.stack(drops).sum())}


def _dp_sbm_owner(ds, device: str, cfg_kw: dict, hosts: int) -> dict:
    """World > 1: CV+PP on the community SBM (a graph with locality) as it
    is and owner-batched with ``--partition_nodes rcm``, a warm-up epoch
    each, then timed epochs in turns (``DP_SBM_TURNS``): ms/step, the
    routed rows' rank-local shares, ``hist_dropped`` per epoch, collective
    bytes, and the stream syncs a step of a 10-step profile."""
    world = torch.distributed.get_world_size()
    cfg = Config(**{**cfg_kw, "dp": world, "dp_hosts": hosts})
    trs = {"plain": Trainer(cfg, ds, device=device),
           "owner": Trainer(cfg.replace(**OWNER_OVER), ds, device=device)}
    res = {}
    for tr in trs.values():
        tr.train_epoch()
    for arm in DP_SBM_TURNS:
        got = _timed_epoch(f"SBM {arm}", trs[arm])
        if arm not in res:
            res[arm] = dict(got, secs_turns=[])
        res[arm]["secs_turns"].append(got["secs"])
    for arm, tr in trs.items():
        res[arm]["syncs"] = _dp_profile(f"SBM {arm}", tr, detail=False)
    return res


def _dp_shares(ds, cfg, device: str, steps: int) -> dict:
    """The routed-row shares a rank owns, and the collective bytes per
    step, over ``steps`` train steps of a Trainer of ``cfg``."""
    from stochastic_gcn_tpu_torch.parallel import mesh as PM
    tr = Trainer(cfg, ds, device=device)
    PM.reset_wire()
    _epoch_losses(tr, steps)
    _sync(device)
    return {"shares": _shares(PM.routed_counts()),
            "wire_per_step": sum(PM.WIRE.values()) / steps}


def _dp_edgelist(device: str, sbm_kw: dict, cfg_kw: dict,
                 hosts: int) -> dict:
    """The uncapped SBM data-parallel twice (dedup fields, no dropout): on
    the row-sharded padded graph and as a node-sharded edge list whose
    budget covers every edge.  Graph bytes per rank; the first
    ``DP_HELD_STEPS`` steps of the two, from the same seed, within
    ``DP_FIRST_EPOCH_RTOL`` (every rank holds them); the
    edge list's steps counted (launches exactly CV+PP's); the four kernels
    on the edge list's inputs (the full term on windows of routed
    blocks)."""
    from stochastic_gcn_tpu_torch.data.graph import flat_csr
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    t0 = time.perf_counter()
    ds = community_sbm_dataset(**sbm_kw)
    built = time.perf_counter() - t0
    # dedup fields and no dropout, as the first dp epoch against one
    # process: a no-dedup field's duplicate history writes race on CUDA
    cfg = Config(**{**cfg_kw, "dp": world, "dp_hosts": hosts,
                    "field_dedup": True, "dropout": 0.0})
    padded = Trainer(cfg, ds, device=device)
    edge = Trainer(cfg.replace(graph_format="edgelist",
                               fadj_edge_mult=COVER_EDGE_MULT), ds,
                   device=device)
    whole = flat_csr(ds.train_adj, COVER_EDGE_MULT)
    res = {"built_s": built, "graph_bytes": {
        "padded, this rank": _graph_bytes(padded.graph_train),
        "edge list, this rank": _graph_bytes(edge.graph_train),
        "edge list, whole": _graph_bytes(whole)},
        "tile_rows": edge.graph_train.idx.shape[0],
        "parts": edge.graph_train.parts}
    del whole
    want = np.array(_epoch_losses(padded, DP_HELD_STEPS))
    K.reset_launches()
    got = np.array(_epoch_losses(edge, DP_HELD_STEPS))
    _sync(device)
    res["launches"] = dict(K.LAUNCHES)
    res["steps"] = len(got)
    check_launches(f"dp={world} edge-list steps on rank {rank}",
                   res["launches"], {name: per * len(got) for name, per in
                                     STEP_LAUNCHES["CV+PP"].items()})
    res["rel_diff"] = float((np.abs(got - want) / np.abs(want)).max())
    if not res["rel_diff"] <= DP_FIRST_EPOCH_RTOL:
        fail(f"dp edge list's first steps {got} differ from the padded "
             f"graph's {want}")
    del padded
    exact = Trainer(cfg.replace(graph_format="edgelist",
                                fadj_edge_mult=COVER_EDGE_MULT, **EXACT_OVER),
                    ds, device=device)
    trs = {"default": edge, "exact": exact}
    res["halo"] = {}
    for arm in DP_EDGE_TURNS:
        got = _timed_steps(trs[arm], DP_EDGE_STEPS)
        if arm not in res["halo"]:
            res["halo"][arm] = dict(got, ms_turns=[])
        res["halo"][arm]["ms_turns"].append(got["ms"])
    for arm, tr in trs.items():
        res["halo"][arm]["syncs"] = _dp_profile(f"edge list, {arm} halo",
                                                tr, detail=False)
    del exact
    res["kernels"] = _dp_kernels(edge, "edge list, ")
    return res


def _dp_rank(out_dir: str, device: str, sbm_kw: dict, reddit_kw: dict,
             slice_cfg: dict, converge_cfg: dict, target: float,
             uncapped_kw: dict, fullterm_cfg: dict, hosts: int) -> None:
    """One rank of the dp phase (``phase_dp``), on ``cuda:rank``."""
    from stochastic_gcn_tpu_torch.parallel import checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    res = {"halo": checks.halo_primitives(**DP_HALO)}
    _dp_log(f"dp: halo primitives against whole-table gathers and scatters "
            f"on the card (f32 and bf16, duplicate, sentinel and parked ids, "
            f"the gather's gradient, the owner-routed full term; the "
            f"scatter's static capacity: scatters that drop, held bitwise "
            f"with the count reckoned from the ids, that drop nothing, and "
            f"the skewed ones under exact splits; the capacity scatters and "
            f"world-1 gathers with any synchronising call an error): max "
            f"abs err or dropped count {res['halo']}")

    sbm = community_sbm_dataset(**sbm_kw)
    _dp_first_epoch(sbm, device, converge_cfg)
    res["curve"] = _dp_converge(sbm, out_dir, device, converge_cfg, target)
    if world > 1:
        res["sbm_owner"] = _dp_sbm_owner(sbm, device, converge_cfg, hosts)
    del sbm

    ds = reddit_like(**reddit_kw)
    cfg = Config(**{**slice_cfg, "dp": world, "dp_hosts": hosts})
    res.update(_dp_arms(ds, cfg, device))
    if world > 1:
        res["alone"] = {
            f"--{flag} alone": _dp_shares(ds, cfg.replace(**{flag: value}),
                                          device, DP_SHARE_STEPS)
            for flag, value in OWNER_OVER.items()}
    del ds
    res["edgelist"] = _dp_edgelist(device, uncapped_kw, fullterm_cfg, hosts)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _dp_coordinator(tmp: str, device: str, world: int, hosts: int,
                    flags: list) -> None:
    """The coordinator arm: ``hosts`` host processes of this machine, each
    given its ``world / hosts`` cards, start their ranks through the
    multi-host launch (``--coordinator 127.0.0.1:<free port>
    --num_processes H --process_id i``: a TCP store held by host 0's first
    rank) and run ``parallel/checks.py::host_run`` (train, evaluate,
    predict, save, load, predict).  Fails unless every host exits 0, the
    hosts' results agree exactly and the checkpoint round trip predicts
    within ``DP_PREDICT_ATOL``."""
    import socket
    import sys
    per = world // hosts
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else \
        [str(i) for i in range(world)]
    out = os.path.join(tmp, "coordinator")
    os.makedirs(out)
    args = [*flags, "--dp", str(world), "--dp_hosts", str(hosts),
            "--coordinator", f"127.0.0.1:{port}", "--num_processes",
            str(hosts), "--ckpt_dir", os.path.join(out, "ckpt")]
    t0 = time.perf_counter()
    procs = []
    try:
        for i in range(hosts):
            env = dict(os.environ)
            if device == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    cards[i * per:(i + 1) * per])
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "stochastic_gcn_tpu_torch.parallel.checks", out, device,
                 *args, "--process_id", str(i)], cwd=ROOT, env=env))
        rcs = [p.wait(timeout=COORD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    if rcs != [0] * hosts:
        fail(f"dp coordinator arm: host exit codes {rcs}")
    got = [dict(np.load(os.path.join(out, f"host{i}.npz")))
           for i in range(hosts)]
    for i, h in enumerate(got[1:], 1):
        for key in ("losses", "eval", "pred", "pred_loaded"):
            if not np.array_equal(h[key], got[0][key]):
                fail(f"dp coordinator arm: host {i}'s {key} differs from "
                     f"host 0's")
    err = float(np.abs(got[0]["pred_loaded"] - got[0]["pred"]).max())
    if not (np.isfinite(got[0]["losses"]).all() and err <= DP_PREDICT_ATOL):
        fail(f"dp coordinator arm: losses {got[0]['losses']}, checkpoint "
             f"round trip max abs err {err}")
    total, cross = got[0]["wire"]
    print(f"dp: coordinator arm, {hosts} host(s) of {per} rank(s) through a "
          f"TCP store at 127.0.0.1:{port}, {' '.join(flags[:2])} CV+PP "
          f"{len(got[0]['losses'])} epochs in {secs:.1f} s (start-up "
          f"included): the hosts agree exactly (losses "
          f"{got[0]['losses'].round(6).tolist()}, val micro-F1 "
          f"{got[0]['eval'][2]:.4f}); checkpoint saved by rank 0, loaded by "
          f"every rank, predictions within {err:.3e}; rank 0's collective "
          f"bytes {total:.0f}, {cross:.0f} of them across hosts",
          flush=True)


def _tp_steps(label: str, tr: Trainer, steps: int) -> dict:
    """``steps`` train steps of ``tr``'s shuffled batches, timed on the
    host clock with one wait for the device at the end, the launch and
    wire counters reset just before them; launches checked exactly per
    rank (a tp rank runs each kernel once a step, on its columns)."""
    from stochastic_gcn_tpu_torch.parallel import mesh as PM
    dev = tr.device
    tr.train_iter.shuffle()
    bm = torch.from_numpy(tr._epoch_matrix(
        tr.train_iter.data, tr.cfg.batch_size)[:steps]).to(dev)
    step = St.build_train_step(tr.cfg, tr.train_spec, tr.train_degrees,
                               tr.ds.num_data, tr.mesh)
    _sync(dev)
    K.reset_launches()
    PM.reset_wire()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    amts = []
    t0 = time.perf_counter()
    for ids in bm:
        tr.state, m = step(tr.state, tr.graph_train, tr.train_features,
                           tr.labels, ids, tr.gen,
                           importance=tr.importance_train)
        amts.append(m["amt_data"])
    loss = float(m["loss"])
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    where = "one process" if tr.mesh is None else \
        f"rank {torch.distributed.get_rank()}"
    check_launches(f"{label} train steps on {where}", launches,
                   {name: per * len(bm) for name, per in
                    STEP_LAUNCHES["CV+PP"].items()})
    if not np.isfinite(loss):
        fail(f"tp {label}: non-finite training loss {loss}")
    return dict(steps=len(bm), secs=secs, loss=loss,
                edges=int(torch.stack(amts).sum()), launches=launches,
                wire=dict(PM.WIRE), peak_gib=_peak_gib(dev))


def _hist_bytes(tr: Trainer) -> int:
    return sum(h.numel() * h.element_size()
               for hl in (*tr.state.histories, *tr.eval_histories)
               for h in hl)


def _tp_save(tr: Trainer, out_dir: str) -> list:
    """``TP_SAVE_REPEATS`` timed ``Trainer.save()`` calls of ``tr`` with
    ``--ckpt_async``, which a mesh answers with the sync save (every rank
    gathers, global rank 0 writes; host clock, to the barrier after the
    write): fails if a background writer was built or rank 0's file was
    not on disk when save() returned."""
    cfg = tr.cfg
    tr.cfg = cfg.replace(ckpt_dir=os.path.join(out_dir, "tp_save"),
                         ckpt_async=True)
    secs = []
    try:
        for _ in range(TP_SAVE_REPEATS):
            t0 = time.perf_counter()
            path = tr.save()
            secs.append(time.perf_counter() - t0)
            if tr._async_ckpt is not None or (
                    path is not None and not os.path.exists(path)):
                fail("a tp Trainer's --ckpt_async save did not take the "
                     "sync gathered path")
    finally:
        tr.cfg = cfg
    return secs


def _tp_polyak(ds, cfg, out_dir: str, device: str) -> dict:
    """The Polyak arm: ``cfg`` (a tp layout) with ``polyak_decay=0.99`` and
    dedup fields trains ``TP_POLYAK_STEPS`` steps, evaluates (from
    ``avg_params``) and predicts ``DP_PREDICT_IDS`` test ids, saves; a
    fresh tp Trainer loads the checkpoint and predicts them again, and
    global rank 0 serves it from one process: both within
    ``DP_PREDICT_ATOL`` of the first prediction."""
    cfg = cfg.replace(polyak_decay=0.99, field_dedup=True,
                      ckpt_dir=os.path.join(out_dir, "tp_polyak"))
    tr = Trainer(cfg, ds, device=device)
    losses = _epoch_losses(tr, TP_POLYAK_STEPS)
    ev = tr.evaluate(ds.val_d)
    avg_gap = max((a - p).abs().max().item() for l in tr.state.params
                  for a, p in zip(tr.state.avg_params[l].values(),
                                  tr.state.params[l].values()))
    ids = ds.test_d[:DP_PREDICT_IDS]
    pred = tr.predict(ids)
    tr.save()
    del tr
    again = Trainer(cfg, ds, device=device)
    again.load(load_history=True)
    err_tp = float(np.abs(again.predict(ids) - pred).max())
    del again
    res = {"losses": losses, "val": list(ev[:4]), "avg_gap": avg_gap,
           "err_tp": err_tp, "err_one": None}
    if torch.distributed.get_rank() == 0:
        one = Trainer(cfg.replace(dp=1, tp=1), ds, device=device,
                      distributed=False)
        one.load(load_history=True)
        res["err_one"] = float(np.abs(one.predict(ids) - pred).max())
        del one
    torch.distributed.barrier()
    if not err_tp <= DP_PREDICT_ATOL or not (
            res["err_one"] is None or res["err_one"] <= DP_PREDICT_ATOL):
        fail(f"tp Polyak arm: the checkpoint round trip predicts within "
             f"{err_tp} (tp) and {res['err_one']} (one process)")
    return res


def _tp_rank(out_dir: str, tag: str, device: str, reddit_kw: dict,
             slice_cfg: dict, arms: dict, extras: bool) -> None:
    """One rank of a tp-phase group (``phase_tp``): every arm of ``arms``
    (label: its ``dp`` / ``tp``, whose product is the group's size) on the
    Reddit-shaped recipe: its first ``DP_HELD_STEPS`` steps with float32
    histories and dedup fields (the held losses), then at each hidden
    width of ``TP_HIDDENS`` a warm-up and ``TP_TIMED_STEPS`` timed steps
    in turns (``TP_TIMED_TURNS`` over the arms), a 10-step profile of each
    (rank 0 prints it).  With ``extras``: at world 2 the same for one
    process on rank 0 (``one``), the timing of ``Trainer.save()`` of the
    first arm at hidden 128, and the Polyak arm (``_tp_polyak``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    ds = reddit_like(**reddit_kw)
    base = Config(**slice_cfg)
    res = {"held": {}, "timed": {},
           "epoch_steps": -(-len(ds.train_d) // base.batch_size)}
    one = extras and world == 2 and rank == 0
    for arm, over in arms.items():
        tr = Trainer(base.replace(**over, **TP_HELD), ds, device=device)
        res["held"][arm] = _epoch_losses(tr, DP_HELD_STEPS)
        del tr
    if one:
        tr = Trainer(base.replace(**TP_HELD), ds, device=device,
                     distributed=False)
        res["held"]["one"] = _epoch_losses(tr, DP_HELD_STEPS)
        del tr
    torch.distributed.barrier()
    first = next(iter(arms))
    for hidden in TP_HIDDENS:
        cfg = base.replace(hidden1=hidden)
        trs = {arm: Trainer(cfg.replace(**over), ds, device=device)
               for arm, over in arms.items()}
        got = {arm: {"hist_bytes": _hist_bytes(tr), "secs_turns": []}
               for arm, tr in trs.items()}
        for tr in trs.values():
            _epoch_losses(tr, TP_WARMUP_STEPS)
        turns = TP_TIMED_TURNS if len(arms) > 1 else (0, 0)
        for i in turns:
            arm = list(arms)[i]
            r = _tp_steps(f"{arm} at hidden {hidden}", trs[arm],
                          TP_TIMED_STEPS)
            if "steps" not in got[arm]:
                got[arm].update(r)
            got[arm]["secs_turns"].append(r["secs"])
        for arm, tr in trs.items():
            _dp_profile(f"{tag} {arm} ({arms[arm]}) at hidden {hidden}", tr)
        if extras and hidden == TP_HIDDENS[0]:
            res["save_s"] = _tp_save(trs[first], out_dir)
        del trs
        if one:
            tr = Trainer(cfg, ds, device=device, distributed=False)
            _epoch_losses(tr, TP_WARMUP_STEPS)
            got["one"] = {"hist_bytes": _hist_bytes(tr), "secs_turns": []}
            for _ in range(2):
                r = _tp_steps(f"one process at hidden {hidden}", tr,
                              TP_TIMED_STEPS)
                if "steps" not in got["one"]:
                    got["one"].update(r)
                got["one"]["secs_turns"].append(r["secs"])
            del tr
        torch.distributed.barrier()
        res["timed"][str(hidden)] = got
    if extras:
        res["polyak"] = _tp_polyak(ds, base.replace(**arms[first]), out_dir,
                                   device)
    with open(os.path.join(out_dir, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _tp_results(out_dir: str, tag: str, world: int) -> list:
    got = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{tag}_rank{r}.json")) as f:
            got.append(json.load(f))
    return got


def phase_tp(device: str = "cuda", world: int = 0, reddit_kw=None,
             slice_cfg=SLICE_CFG) -> dict:
    """Tensor parallelism, one NCCL rank per card (NCCL takes one rank per
    card, so the arm needs two cards at least; at world 1 it says so and
    nothing runs in its place: the one-card run holds the kernels at the
    tp widths in ``phase_tp_kernels``).  At world 2: dp 1 x tp 2 and dp 2
    in one group, against one process on rank 0's card.  At world 4: dp 2
    x tp 2 and dp 4 in one group (``_tp_rank`` with ``extras``: the save
    timing and the Polyak arm), then dp 2 on cards 0 and 1 in a group of
    its own.  Fails unless the tp arm's first ``DP_HELD_STEPS`` losses
    (float32 histories, dedup fields) agree with each other arm's within
    ``DP_FIRST_EPOCH_RTOL`` on every rank.  Prints per rank and arm: ms per
    step in turns, sampled edges/s, collective bytes per step with the
    model group's apart, history bytes, peak memory and launches per step.
    Returns rank 0's launches of the tp arm's first timed steps."""
    from stochastic_gcn_tpu_torch.parallel import launch
    world = world or torch.cuda.device_count()
    if world < 2:
        print(f"tp: the tp arm needs two cards (one NCCL rank per card); "
              f"this machine has {world}, so no tp arm runs (the kernels "
              f"at the tp widths are held in the kernels phase)",
              flush=True)
        return {}
    if world % 2:
        world -= 1
    reddit_kw = reddit_kw or {}
    t0 = time.perf_counter()
    groups = [("tp", world, {"tp": dict(dp=world // 2, tp=2),
                             "dp": dict(dp=world)}, True)]
    if world == 4:
        groups.append(("dp2", 2, {"dp2": dict(dp=2)}, False))
    ranks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        for tag, size, arms, extras in groups:
            launch.spawn(_tp_rank, size, (tmp, tag, device, reddit_kw,
                                          slice_cfg, arms, extras),
                         device, store_dir=tmp)
            ranks[tag] = _tp_results(tmp, tag, size)
    tp_arm = f"dp {world // 2} x tp 2"
    labels = {"tp": tp_arm, "dp": f"dp {world}", "dp2": "dp 2 (its own group)",
              "one": "one process"}
    for tag, rks in ranks.items():
        for r, rk in enumerate(rks):
            held = ranks["tp"][r % world]["held"]
            for arm, losses in rk["held"].items():
                if arm == "tp":
                    continue
                d = np.abs(np.array(held["tp"]) - np.array(losses)) \
                    / np.abs(np.array(losses))
                print(f"tp: held, {tp_arm} against {labels[arm]} on rank "
                      f"{r}: first {len(losses)} steps (float32 histories, "
                      f"dedup fields) within {d.max():.3e} (rtol "
                      f"{DP_FIRST_EPOCH_RTOL})", flush=True)
                if not d.max() <= DP_FIRST_EPOCH_RTOL:
                    fail(f"tp: {tp_arm} losses {held['tp']} differ from "
                         f"{labels[arm]}'s {losses}")
    for tag, rks in ranks.items():
        for r, rk in enumerate(rks):
            for hidden, arms in rk["timed"].items():
                for arm, a in arms.items():
                    steps = a["steps"]
                    turns = ", ".join(f"{1e3 * x / steps:.3f}"
                                      for x in a["secs_turns"])
                    wire = {k: round(v / steps) for k, v in a["wire"].items()}
                    model = wire.pop("model", 0)
                    launches = a["launches"]
                    print(f"tp: {labels[arm]}, rank {r} of {len(rks)}, "
                          f"Reddit-shaped CV+PP at hidden {hidden}, global "
                          f"batch {slice_cfg['batch_size']}: {turns} ms/step "
                          f"over {steps} steps (in turns); "
                          f"{a['edges'] / a['secs']:.0f} sampled edges/s "
                          f"(global, the first turn); collective bytes per "
                          f"step: data group {sum(wire.values())} {wire}, "
                          f"model group {model}; history bytes "
                          f"{a['hist_bytes']}; peak device memory "
                          f"{a['peak_gib']:.3f} GiB; launches per step "
                          f"{ {k: v / steps for k, v in launches.items()} }",
                          flush=True)
    main = ranks["tp"][0]
    secs = main["save_s"]
    a = main["timed"][str(TP_HIDDENS[0])]["tp"]
    epoch_s = main["epoch_steps"] * min(a["secs_turns"]) / a["steps"]
    print(f"tp: Trainer.save() of the {tp_arm} Trainer at hidden "
          f"{TP_HIDDENS[0]} with --ckpt_async (the sync fallback of a mesh: "
          f"the column blocks gathered, rank 0 writing the compressed npz "
          f"before save() returns): {', '.join(f'{x:.3f}' for x in secs)} "
          f"s; an "
          f"epoch of {main['epoch_steps']} steps at its fastest turn takes "
          f"{epoch_s:.3f} s, so the fastest save is "
          f"{_cycle_shares(min(secs), epoch_s)}", flush=True)
    pk = main["polyak"]
    print(f"tp: Polyak arm ({tp_arm}, polyak_decay 0.99, dedup fields): "
          f"{len(pk['losses'])} steps, last loss {pk['losses'][-1]:.5f}; "
          f"validation from avg_params {pk['val']} (avg_params differ from "
          f"the params by up to {pk['avg_gap']:.3e}); checkpoint round trip "
          f"predicts {DP_PREDICT_IDS} test ids within {pk['err_tp']:.3e} "
          f"(tp) and {pk['err_one']:.3e} (served by one process; atol "
          f"{DP_PREDICT_ATOL})", flush=True)
    print(f"tp: phase {time.perf_counter() - t0:.1f} s", flush=True)
    first = main["timed"][str(TP_HIDDENS[0])]["tp"]
    return {f"{tp_arm} train steps (rank 0)": first["launches"]}


def phase_dp(results: dict, device: str = "cuda", world: int = 0,
             sbm_kw=SBM_KW, reddit_kw=None, slice_cfg=SLICE_CFG,
             converge_cfg=CONVERGE_CFG, target: float = CONVERGE_F1,
             uncapped_kw=UNCAPPED_SBM_KW, fullterm_cfg=FULLTERM_CFG,
             coord_flags=COORD_FLAGS) -> dict:
    """Data parallelism: one NCCL rank per card of this machine (rank r on
    ``cuda:r``; at an even world declared as two hosts of consecutive
    ranks), each running ``_dp_rank``: (a) the halo primitives against
    whole-table gathers and scatters on the card; (b) on the SBM, one
    epoch of CV+PP with dedup-compacted fields and no dropout against one
    process of the same seed (``DP_FIRST_EPOCH_RTOL``), then CV+PP at the
    recipe to the 0.90 band within ``CONVERGE_EPOCHS`` epochs, and (d) its
    checkpoint served by one process (``DP_PREDICT_ATOL``); (c) the
    Reddit-shaped recipe at global batch 512: a warm-up epoch, then a
    timed epoch with the counters reset just before it (ms/step, sampled
    edges/s, peak memory, history bytes and collective bytes per step per
    rank by transport and by host, the routed rows' rank-local shares,
    launches checked exactly per rank), and the four kernels on the
    inputs this path gives them, against their plain versions and timed
    on rank 0; (e) the owner arm, (c) with ``--owner_batching
    --partition_nodes rcm`` (and at world > 1 each flag alone, shares
    only); each arm against ``--halo_exchange false`` in turns, a pair
    at a time, and at world > 1 the SBM with and without owner batching
    (``_dp_sbm_owner``); (f) the edge-list arm (``_dp_edgelist``), against
    its exact transport in turns.  Any rank's failure fails the run.
    Then (g) the coordinator arm (``_dp_coordinator``).
    Folds the kernels' cases into ``results`` (``dp_case``,
    ``dp_owner_case``, ``dp_edgelist_case``) and returns rank 0's launch
    counts of each counted path."""
    from stochastic_gcn_tpu_torch.parallel import launch
    world = world or torch.cuda.device_count()
    hosts = 2 if world > 1 and world % 2 == 0 else 1
    print(f"dp: world {world}, declared as {hosts} host(s)", flush=True)
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        launch.spawn(_dp_rank, world,
                     (tmp, device, sbm_kw, reddit_kw or {}, slice_cfg,
                      converge_cfg, target, uncapped_kw, fullterm_cfg,
                      hosts), device, store_dir=tmp, hosts=hosts)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        t_ranks = time.perf_counter() - t0
        _dp_coordinator(tmp, device, world, hosts, coord_flags)
    for r, res in enumerate(ranks):
        for arm in DP_ARMS:
            a = res[arm]
            steps = a["steps"]
            turns = ", ".join(f"{1e3 * x / steps:.3f}"
                              for x in a["secs_turns"])
            print(f"dp: rank {r} of {world}, Reddit-shaped "
                  f"{'owner-batched (rcm) ' if 'owner' in arm else ''}CV+PP "
                  f"({_transport(arm)}) at global batch {a['batch']}: "
                  f"Trainer set-up {a['setup_s']:.2f} s; timed epochs (in "
                  f"turns {_turns(arm, world)}) {turns} ms/step over "
                  f"{steps} steps; the first: "
                  f"{a['edges'] / a['secs']:.0f} sampled edges/s "
                  f"(global); last loss {a['loss']:.5f}; peak device memory "
                  f"{a['peak_gib']:.3f} GiB; history bytes {a['hist_bytes']}"
                  f" (train and eval blocks); {_wire_per_step(a)}; routed "
                  f"rows the rank owns {_shares(a['routed'])}; launches per "
                  f"step { {k: v / steps for k, v in a['launches'].items()} }")
            print(f"dp halo: world {world}, rank {r}, {arm} "
                  f"({_transport(arm)}): ms/step {turns}; stream syncs a "
                  f"step {_syncs(a)}; collective bytes a step "
                  f"{sum(a['wire'].values()) / steps:.0f} (all-to-all "
                  f"{a['wire']['all_to_all'] / steps:.0f}); per epoch "
                  f"hist_dropped {a['hist_dropped']}")
        if world == 1:
            a2a = sum(res[arm]["wire"]["all_to_all"] for arm in DP_ARMS)
            every = sum(sum(res[a]["wire"].values()) for a in DP_ARMS)
            print(f"dp halo: world 1: the halo's all-to-all bytes over the "
                  f"{len(DP_ARMS)} arms' first timed epochs {a2a} (all "
                  f"collective bytes {every}); "
                  f"its gathers and scatters ran with any synchronising "
                  f"call an error (checks.halo_capacity): no host read")
            if a2a:
                fail(f"dp world 1: the halo put {a2a} bytes on the wire")
        if "sbm_owner" in res:
            for arm in DP_SBM_TURNS[:2]:
                a = res["sbm_owner"][arm]
                steps = a["steps"]
                turns = ", ".join(f"{1e3 * x / steps:.3f}"
                                  for x in a["secs_turns"])
                flags = (" (--owner_batching --partition_nodes rcm)"
                         if arm == "owner" else "")
                print(f"dp halo: world {world}, rank {r}, community SBM "
                      f"CV+PP {arm}{flags}: "
                      f"ms/step {turns} over {steps} steps (in turns "
                      f"{'/'.join(DP_SBM_TURNS)}); stream syncs a step "
                      f"{_syncs(a)}; routed rows the rank owns "
                      f"{_shares(a['routed'])}; per epoch hist_dropped "
                      f"{a['hist_dropped']}; {_wire_per_step(a)}")
        al = res["owner"]["aligned_step"]
        print(f"dp: rank {r} of {world}, an owner-aligned train step "
              f"({al['blocks']} blocks, no dropout) against the classic one "
              f"of the same generator: loss within {al['loss_diff']:.3e}, "
              f"params within {al['param_diff']:.3e} (atol {STEP_ATOL})")
        for label, alone in res.get("alone", {}).items():
            print(f"dp: rank {r} of {world}, {label}, {DP_SHARE_STEPS} "
                  f"steps: routed rows the rank owns {alone['shares']}; "
                  f"collective bytes per step {alone['wire_per_step']:.0f}")
        e = res["edgelist"]
        print(f"dp: rank {r} of {world}, uncapped SBM (built in "
              f"{e['built_s']:.1f} s) as a node-sharded edge list "
              f"({e['parts']} parts, {e['tile_rows']} block rows on this "
              f"rank): graph bytes {e['graph_bytes']}; first "
              f"{e['steps']} steps against the row-sharded padded graph "
              f"within {e['rel_diff']:.3e} (rtol {DP_FIRST_EPOCH_RTOL}); "
              f"launches {e['launches']}")
        for arm in DP_EDGE_TURNS[:2]:
            h = e["halo"][arm]
            print(f"dp halo: world {world}, rank {r}, edge list "
                  f"({_transport(arm)}): ms/step "
                  f"{', '.join(f'{x:.3f}' for x in h['ms_turns'])} over "
                  f"{h['steps']} steps a turn (in turns "
                  f"{'/'.join(DP_EDGE_TURNS)}); stream syncs a step "
                  f"{_syncs(h)}; collective bytes a step {h['wire']:.0f} "
                  f"(all-to-all {h['all_to_all']:.0f}); over the first turn "
                  f"hist_dropped {h['hist_dropped']}")
    rank0 = ranks[0]
    for key, arm in (("dp_case", ("plain",)), ("dp_owner_case", ("owner",)),
                     ("dp_edgelist_case", ("edgelist",))):
        for name, (case, res) in rank0[arm[0]]["kernels"].items():
            res["max_abs_err"] = max(rk[arm[0]]["kernels"][name][1][
                "max_abs_err"] for rk in ranks)
            _report(results, name, case, res)
            results[name][key] = {
                "case": case, **{k: res.get(k) for k in
                                 ("max_abs_err", *MAIN_KEYS, "library")}}
    for name in results:
        results[name]["dp_launches_per_step_per_rank"] = {
            arm: rank0[arm]["launches"][name] / rank0[arm]["steps"]
            for arm in ("plain", "owner", "edgelist")}
    print(f"dp: phase {time.perf_counter() - t0:.1f} s (ranks "
          f"{t_ranks:.1f} s)", flush=True)
    tp_paths = phase_tp(device, world, reddit_kw, slice_cfg)
    return {**tp_paths,
            f"dp={world} train epoch (rank 0)": rank0["plain"]["launches"],
            f"dp={world} owner-batched train epoch (rank 0)":
                rank0["owner"]["launches"],
            f"dp={world} edge-list steps (rank 0)":
                rank0["edgelist"]["launches"]}


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phase", choices=("all", "dp", "kernels"),
                   default="all",
                   help="dp: the card, build and dp phases alone (one rank "
                        "per card of the machine); kernels: the card, build "
                        "and kernels phases alone, with their sweeps, and "
                        "the kernels on the real batches")
    p.add_argument("--parent", action="append", default=[], metavar="DIR",
                   help="another tree of the port (a commit unpacked with "
                        "git archive); its kernels, built from its sources, "
                        "are timed in turns with this tree's (theirs, ours, "
                        "ours, theirs) on the main path's shapes, the "
                        "redesigned cases and the real batches")
    a = p.parse_args(argv)
    only = a.phase
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing run")
    TREES.extend((Path(tree).resolve().name, _load_tree(tree, i))
                 for i, tree in enumerate(a.parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    phase_build()
    if only == "dp":
        kernels = {name: {} for name in REPLACES}
        phase_dp(kernels)
        print(json.dumps({"dp_kernels": {
            name: {key: res[key] for key in
                   ("dp_case", "dp_owner_case", "dp_edgelist_case",
                    "dp_launches_per_step_per_rank")}
            for name, res in kernels.items()}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    kernels = phase_kernels(sweeps=only == "kernels")
    if only == "kernels":
        phase_real_batches(kernels)
        print(json.dumps({"kernel_cases": {
            **{name: {key: res[key] for key in ("redesigned_cases",
                                                "sparse_layer_batches")
                      if key in res}
               for name, res in kernels.items()},
            ENDS_KERNEL: ENDS_RESULT}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    t0 = time.perf_counter()
    ds = reddit_like()
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    cap_adj_degree(ds.full_adj, SLICE_CFG["pad_degree"], SLICE_CFG["seed"])
    t_cap = time.perf_counter() - t0
    above = int((np.diff(ds.full_adj.indptr) > SLICE_CFG["pad_degree"]).sum())
    print(f"graph: Reddit-shaped, {ds.num_data} nodes, built in "
          f"{t_graph:.2f} s (host); cap_adj_degree at pad degree "
          f"{SLICE_CFG['pad_degree']}: {t_cap:.2f} s for {above} rows above "
          f"the cap (host loop, the JAX package's draws; each Trainer caps "
          f"both of its graphs)")
    tr, launches, steps = phase_train(ds)
    phase_train_kernels(tr, kernels)
    phase_tp_kernels(tr, kernels)
    phase_save(tr)
    phase_profile(tr)
    phase_activation_stats(tr)
    served, per_request, art, art_per_request = phase_slice(tr)
    del tr
    lazy_paths, lazy_steps = phase_lazy(ds, kernels)
    is_paths = phase_importance(ds, kernels)
    del ds
    exact, sbm, cv_tr, cv_curve = phase_converge(kernels)
    estimator_paths, per_step = phase_estimators(sbm, cv_tr, cv_curve,
                                                 results=kernels)
    phase_mlp(sbm)
    ema = phase_ema(cv_tr)
    converge_paths, converge_steps = phase_lazy_converge(sbm)
    del sbm, cv_tr
    uncapped, edge_paths, edge_steps, edge_request = phase_edgelist(kernels)
    tier_paths, tier_steps = phase_tier(uncapped, kernels)
    del uncapped
    fullterm_paths = {**lazy_paths, **converge_paths, **edge_paths,
                      **tier_paths, "ema_aggregate (SBM batch)": ema}
    per_step.update({**lazy_steps, **converge_steps, **edge_steps,
                     **tier_steps})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        pubmed_paths, pubmed_steps, pubmed_request = phase_pubmed(
            os.path.join(tmp, "pubmed"), kernels)
        ppi_paths, ppi_step, ppi_request = phase_ppi(
            os.path.join(tmp, "ppi"), results=kernels)
    dp_paths = phase_dp(kernels)
    per_step["CV+PP"] = {name: count / steps
                         for name, count in launches.items()}
    per_step.update(pubmed_steps)
    per_step["PPI CV+PP"] = ppi_step
    # the counted paths: each had the counters at 0 just before it and was
    # read just after
    paths = {"train epoch": launches, "served requests": served,
             "served requests (artifact)": art,
             "Exact evaluation": exact, **is_paths, **estimator_paths,
             **pubmed_paths, **ppi_paths, **fullterm_paths,
             **dp_paths}
    total = {name: sum(p[name] for p in paths.values()) for name in kernels}
    idle = [name for name, count in total.items() if count == 0]
    if idle:
        fail(f"no counted path launched {idle}: {paths}")
    requests = {"Reddit-shaped": per_request,
                "Reddit-shaped, artifact": art_per_request,
                "PubMed CV+PP, artifact": pubmed_request,
                "PPI CV+PP, artifact": ppi_request, **edge_request}
    if not sum(ENDS_PATHS.values()) or "ms" not in ENDS_RESULT:
        fail(f"no counted path launched {ENDS_KERNEL} ({ENDS_PATHS}) or it "
             f"was not timed")
    entries = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": res["max_abs_err"],
         **{key: res[key] for key in MAIN_KEYS},
         "library": res["library"], "replaced_ms": res["replaced_ms"],
         "launches_by_path": {path: p[name] for path, p in paths.items()},
         "launches_per_step": launches[name] / steps,
         "launches_per_step_by_estimator": {
             est: counts.get(name, 0) for est, counts in per_step.items()},
         "launches_per_request": per_request[name],
         "launches_per_request_by_path": {
             path: counts.get(name, 0) for path, counts in requests.items()},
         "is_batches": res.get("is_batches", {}),
         "sparse_layer_batches": res.get("sparse_layer_batches", {}),
         **{key: res[key] for key in ("fullterm_cases", "tier_wall_ms",
                                      "tier_sweep", "lazy_anchor_ms",
                                      "tp_cases", "redesigned_cases",
                                      "ppi_cases", "dp_case", "dp_owner_case",
                                      "dp_edgelist_case",
                                      "dp_launches_per_step_per_rank")
            if key in res}}
        for name, res in kernels.items()]
    entries.append({
        "name": ENDS_KERNEL, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["fanout_aggregate"],
        "launches": sum(ENDS_PATHS.values()),
        **{key: ENDS_RESULT.get(key) for key in (
            "max_abs_err", *MAIN_KEYS, "library", "without_ends_ms",
            "sparse_mm_ms", "served_field")},
        "launches_by_path": ENDS_PATHS})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
