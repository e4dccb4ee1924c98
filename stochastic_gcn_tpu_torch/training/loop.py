"""Trainer: training, evaluation, serving and checkpoints.

Port of stochastic_gcn_tpu/training/loop.py, on the padded or the
edge-list graph (``--graph_format edgelist``): the constructor puts the
train and eval graphs, features, labels, the importance tables, the train
state (params, Adam state, bf16 train histories) and the eval histories
on an explicit device.  ``train_epoch`` / ``sgd_train`` / ``evaluate`` /
``predict`` / ``test`` / ``run_tests`` / ``activation_stats`` /
``gradient_variance`` / ``save`` / ``load`` follow the JAX Trainer, for
every estimator the flags select (NS, CV, CVD, det-dropout, Exact,
importance sampling with or without ``--is_row_table``; with or without
preprocessing; Polyak-averaged evaluation weights; the two-tier and the
epoch-frozen (``--lazy_fullterm``) full term); checkpoints use the JAX file
layout, so either package resumes the other's.

``--dp P > 1`` runs data-parallel over a process group of ``P`` ranks, one
device each (parallel/): every rank builds this Trainer from the same data
and flags, holds its row block of the histories (and, under
``--shard_graph``, of the graph, features and labels), and runs the same
global schedule on its rows of every field.  Every public method returns
the same values on every rank; logging and checkpoint files are rank 0's,
and checkpoints hold the whole tables in the single-device layout, so a
run of any width loads one of any other.  ``--partition_nodes rcm``
relabels the nodes internally (every id a caller passes or gets stays in
the caller's id space).

``--tp T > 1`` adds tensor parallelism: ``dp x T`` ranks, each holding
its column blocks of the wide params, their Adam state and Polyak
average, and of the histories (models/gcn.py::column_layout).  Every
public method still returns the values of the ``--dp`` run of the same
seed (up to reduction order) on every rank; logging and files are global
rank 0's, and ``save`` gathers the column blocks, so a tp checkpoint holds
the one-device layout and loads at any ``dp``, any ``tp`` and in JAX.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..data.graph import (Dataset, FlatGraph, dense_rows, flat_csr, pad_csr,
                          pad_sparse_features, shard_flat_graph,
                          shard_graph_rows, shard_table_rows)
from ..data.preprocess import (cap_adj_degree, locality_permutation,
                               relabel_dataset)
from ..models import gcn as M
from ..parallel import distributed as D
from ..parallel.mesh import (Mesh, make_mesh, owner_grouped_batch_matrix,
                             row_multiple, shard_rows)
from ..sampler.scheduler import MinibatchIterator, compute_importance
from ..utils.metrics import Stat, f1_from_counts
from . import step as S
from .checkpoint import (AsyncCheckpointer, checkpoint_path, load_checkpoint,
                         load_loop_extras, save_checkpoint)


def assemble_input_features(cfg, feats, nbr_feats, preprocess: bool):
    """Under PP the model consumes [X_self ‖ ÂX] (graphsage) or ÂX alone
    (gcn, self_dim=0)."""
    sparse_input = sp.issparse(feats)
    if preprocess and cfg.pp_nbr:
        self_dim = 0 if cfg.normalization == "gcn" else feats.shape[1]
        if sparse_input:
            out = sp.hstack((feats[:, :self_dim], nbr_feats)).tocsr()
        else:
            out = np.hstack((feats[:, :self_dim], np.asarray(nbr_feats)))
    else:
        out = feats
    return out, sparse_input


def to_device_features(cfg, feats, num_nodes: int, device):
    """The ``[N+1, ...]`` feature table on ``device`` in
    ``cfg.features_dtype``: sparse features padded to ``cfg.feat_nnz_cap``
    slots a row (:func:`pad_sparse_features`, values cast), unless
    ``--dense_input`` densifies them as it does dense ones."""
    dtype = S.DTYPES[cfg.features_dtype]
    if sp.issparse(feats) and not cfg.dense_input:
        pf = pad_sparse_features(feats, cfg.feat_nnz_cap, num_nodes, device)
        return pf.replace(val=pf.val.to(dtype))
    return dense_rows(feats, num_nodes, dtype=dtype, device=device)


def _check_flags(cfg) -> None:
    """Refuse flag combinations the JAX Trainer refuses, and multi-device
    flags that do not tile."""
    if cfg.det_dropout and (cfg.importance or cfg.test_importance):
        # as the JAX Trainer: importance sampling produces no cross-term
        # (slot_aw) weights
        raise ValueError("--det_dropout is incompatible with --importance")
    if cfg.use_pallas and (cfg.dp > 1 or cfg.tp > 1):
        raise ValueError("--use_pallas is single-chip only (--dp 1)")
    if cfg.dp > 1 and (cfg.batch_size % cfg.dp
                       or cfg.test_batch_size % cfg.dp):
        raise ValueError("batch sizes must divide --dp")
    if cfg.dp % max(cfg.dp_hosts, 1):
        raise ValueError(f"--dp {cfg.dp} does not tile over --dp_hosts "
                         f"{cfg.dp_hosts} hosts")
    if cfg.num_processes > 1 and not cfg.coordinator:
        raise ValueError(f"--num_processes {cfg.num_processes} hosts need "
                         "--coordinator host:port")


def _hosts(cfg) -> int:
    """The hosts the ranks span: ``--dp_hosts``, or the hosts of a
    ``--coordinator`` launch (parallel/distributed.py::host_ranks)."""
    if cfg.coordinator:
        return D.host_ranks(cfg)[1]
    return cfg.dp_hosts


def _mesh_for(cfg, distributed: Optional[bool]) -> Optional[Mesh]:
    """The Trainer's mesh: the default process group's when there is one
    (``distributed=None``) or when asked for (``True``); its size must be
    ``cfg.dp * cfg.tp``, and its data axis host-major over the hosts of
    ``cfg``.  None runs on one device, which ``cfg.dp * cfg.tp > 1`` or a
    multi-host launch never does."""
    if distributed is None:
        distributed = torch.distributed.is_initialized()
    hosts = _hosts(cfg)
    world = D.world_size(cfg)
    if not distributed:
        if world > 1 or hosts > 1 or cfg.coordinator:
            raise ValueError(f"--dp {cfg.dp} --tp {cfg.tp} over {hosts} "
                             f"host(s) needs a process group of {world} "
                             "ranks (parallel/launch.py, or torchrun)")
        return None
    if D.process_count() != world:
        raise ValueError(f"--dp {cfg.dp} --tp {cfg.tp} but the process "
                         f"group has {D.process_count()} ranks")
    return make_mesh(cfg.shard_graph, hosts, cfg.tp)


class Trainer:
    """Holds the train and eval state on ``device``; trains, evaluates and
    serves predictions.

    ``device="cuda"`` on a machine without CUDA raises; nothing falls back
    to the CPU.  ``distributed``: run on the default process group's mesh
    (None: whenever a group is initialised); under a mesh a CUDA device
    is this process's current one."""

    def __init__(self, cfg, ds: Dataset, device="cuda",
                 distributed: Optional[bool] = None):
        _check_flags(cfg)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') but CUDA is not "
                               "available")
        self.mesh = mesh = _mesh_for(cfg, distributed)
        if mesh is not None and device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.node_perm = self._id_to_internal = None
        if cfg.partition_nodes != "none":
            # a locality relabelling of the nodes, internal to the Trainer:
            # the splits and every id a caller passes stay in the caller's
            # id space (_to_internal maps them at entry)
            self.node_perm = locality_permutation(ds.full_adj,
                                                  cfg.partition_nodes)
            self._id_to_internal = np.empty(ds.num_data, np.int32)
            self._id_to_internal[self.node_perm] = np.arange(
                ds.num_data, dtype=np.int32)
            ds = dataclasses.replace(
                relabel_dataset(ds, self.node_perm), train_d=ds.train_d,
                val_d=ds.val_d, test_d=ds.test_d)
        self.cfg, self.ds, self.device = cfg, ds, device
        n = ds.num_data

        train_adj, full_adj = ds.train_adj, ds.full_adj
        test_feats_pp = ds.test_feats
        if cfg.gradvar:
            # the gradient-variance analysis evaluates on the train graph:
            # the eval graph and PP features alias the train side's
            full_adj = train_adj.copy()
            test_feats_pp = ds.train_feats.copy()
        if cfg.pad_degree != -1:
            train_adj = cap_adj_degree(train_adj, cfg.pad_degree, cfg.seed)
            full_adj = cap_adj_degree(full_adj, cfg.pad_degree, cfg.seed)
        if cfg.graph_format == "edgelist":
            # flat CSR: O(E) storage, row windows per field (power-law
            # graphs)
            if cfg.use_pallas:
                raise ValueError("--use_pallas requires the padded graph "
                                 "format")
            # laid out for node-sharding over the ranks under a sharded
            # mesh (the tables' tiles are kept in _shard_tables)
            parts = cfg.dp if (mesh is not None and mesh.shard_graph) else 1
            self.graph_train, self.graph_full = (
                flat_csr(adj, cfg.fadj_edge_mult, parts=parts,
                         tier=cfg.fadj_tier, tier_w=cfg.fadj_tier_w,
                         device=device)
                for adj in (train_adj, full_adj))
        else:
            # each graph padded to its own true (post-cap) max degree
            self.graph_train, self.graph_full = (
                pad_csr(adj, -1, tier=cfg.fadj_tier, tier_w=cfg.fadj_tier_w,
                        device=device) for adj in (train_adj, full_adj))

        # params are shaped by the TRAIN model (shared weights)
        in_dim, out_dim = ds.feature_dim, ds.num_classes
        tr_feats, tr_sparse = assemble_input_features(
            cfg, ds.feats, ds.train_feats, cfg.preprocess)
        te_feats, te_sparse = assemble_input_features(
            cfg, ds.feats, test_feats_pp, cfg.test_preprocess)
        self.train_spec = M.build_model_spec(
            cfg, in_dim, out_dim, cfg.preprocess, cfg.cv, cfg.cvd, tr_sparse)
        self.test_spec = M.build_model_spec(
            cfg.replace(importance=cfg.test_importance), in_dim, out_dim,
            cfg.test_preprocess, cfg.test_cv, cfg.test_cvd, te_sparse)
        self.train_features = to_device_features(cfg, tr_feats, n, device)
        self.test_features = to_device_features(cfg, te_feats, n, device)
        self.labels = dense_rows(ds.labels, n, device=device)
        self.train_degrees = tuple([cfg.degree]
                                   * self.train_spec.num_agg_layers)
        self.test_degrees = tuple([cfg.test_degree]
                                  * self.test_spec.num_agg_layers)
        # the [N+1] tables importance sampling draws by (zeros when off)
        self.importance_train = compute_importance(self.graph_train) \
            if cfg.importance else torch.zeros(n + 1, device=device)
        self.importance_test = compute_importance(self.graph_full) \
            if cfg.test_importance else torch.zeros(n + 1, device=device)

        # the reference's one runtime data guard (scheduler.cpp:114-115):
        # corrupt edge weights fail loudly at build, not sample garbage
        for nm, g in (("train", self.graph_train),
                      ("test/full", self.graph_full)):
            if not bool(torch.isfinite(g.w).all()):
                raise ValueError(
                    f"non-finite edge weights in the {nm} graph "
                    "(reference scheduler.cpp:114-115 guard)")

        if mesh is not None and mesh.shard_graph:
            self._shard_tables(mesh)

        # weights from a CPU generator, so every device starts from the
        # same values; sampling and dropout draw from a generator on the
        # device (under a mesh every rank draws the same stream)
        self.state = S.init_train_state(torch.Generator().manual_seed(
            cfg.seed), cfg, self.train_spec, n, device, mesh)
        self.gen = torch.Generator(device=device).manual_seed(cfg.seed)
        # incremental-refresh bookkeeping for predict(): bumped on every
        # weight change; eval histories are converged for exactly one value
        self._params_version = 0
        self._hist_fresh_version = -1
        # eval-side history is separate from the train side, as in the
        # reference (train.py:174)
        self.eval_histories = M.init_histories(
            self.test_spec, n, row_multiple(cfg.dp),
            S.DTYPES[cfg.test_history_dtype], device, mesh)
        self._train_epoch = S.build_train_epoch(cfg, self.train_spec,
                                                self.train_degrees, n, mesh)
        self._eval_epoch = S.build_eval_epoch(cfg, self.test_spec,
                                              self.test_degrees, n,
                                              mesh=mesh)
        self._predict_epoch = S.build_eval_epoch(
            cfg, self.test_spec, self.test_degrees, n, with_preds=True,
            mesh=mesh)
        self.train_iter = MinibatchIterator(self._to_internal(ds.train_d),
                                            cfg.seed)
        self.cost_val: list[float] = []
        self.amt_data = 0
        self.completed_epochs = 0     # checkpointed for --resume
        self.stop_requested = False   # preemption: finish epoch, save, exit
        self.epoch_stats: dict = {}
        self._prev_sig_handlers: list = []
        self._async_ckpt: Optional[AsyncCheckpointer] = None   # built lazily

    def _shard_tables(self, mesh: Mesh) -> None:
        """Keep this rank's row block of the padded graphs (of an edge
        list, its tile of the block tables), the feature tables and the
        labels (``--shard_graph``); the whole tables go.  Importance is
        computed from the whole graphs first."""
        rows = shard_rows(self.ds.num_data, mesh.size)
        self.graph_train, self.graph_full = (
            shard_flat_graph(g, mesh) if isinstance(g, FlatGraph)
            else shard_graph_rows(g, mesh, rows)
            for g in (self.graph_train, self.graph_full))
        self.train_features, self.test_features, self.labels = (
            shard_table_rows(t, mesh, rows) for t in (
                self.train_features, self.test_features, self.labels))

    @property
    def _main(self) -> bool:
        """Global rank 0 (of every rank of the group, not of a data or a
        model group): the one that logs and writes files."""
        return self.mesh is None or self.mesh.global_rank == 0

    def _log(self, log):
        """``log`` on rank 0, nothing on the others."""
        return log if self._main else D.quiet

    def _to_internal(self, ids):
        """Caller-space node ids in the internal (relabelled) id space;
        the ids themselves without ``--partition_nodes``."""
        if self._id_to_internal is None:
            return ids
        return self._id_to_internal[np.asarray(ids, np.int64)]

    @property
    def params(self) -> dict:
        return self.state.params

    @property
    def truncated_edges_frac(self) -> float:
        """The share of full-neighbourhood edges the edge-list budget drops
        (the larger of the train and eval graphs'; 0.0 on padded graphs,
        which are lossless)."""
        return max(getattr(self.graph_train, "truncated_frac", 0.0),
                   getattr(self.graph_full, "truncated_frac", 0.0))

    def _eval_params(self) -> dict:
        """The weights evaluation and serving use: the Polyak / EMA average
        when ``polyak_decay > 0``, the raw weights otherwise."""
        if self.cfg.polyak_decay > 0 and self.state.avg_params is not None:
            return self.state.avg_params
        return self.state.params

    @staticmethod
    def _batch_matrix(ids, batch_size: int, num_nodes: int) -> np.ndarray:
        """[S, B] sentinel-padded batch-id matrix."""
        ids = np.asarray(ids, np.int32)
        s = max(1, -(-len(ids) // batch_size))
        out = np.full((s * batch_size,), num_nodes, np.int32)
        out[:len(ids)] = ids
        return out.reshape(s, batch_size)

    def _epoch_matrix(self, ids, batch_size: int) -> np.ndarray:
        """The batch matrix of a train or evaluation epoch: owner-grouped
        under ``--owner_batching`` on a mesh
        (parallel/mesh.py::owner_grouped_batch_matrix), in order
        otherwise."""
        if self.cfg.owner_batching and self.mesh is not None:
            return owner_grouped_batch_matrix(ids, batch_size,
                                              self.ds.num_data, self.cfg.dp)
        return self._batch_matrix(ids, batch_size, self.ds.num_data)

    def train_epoch(self):
        """One epoch over the shuffled train ids (train.py:181-209).  The
        loss and accuracy are the LAST minibatch's, as in the reference's
        window-1 Averager; the device is waited for once, at the end."""
        cfg = self.cfg
        self.train_iter.shuffle()
        t0 = time.time()
        bm = self._epoch_matrix(self.train_iter.data, cfg.batch_size)
        self.state, metrics = self._train_epoch(
            self.state, self.graph_train, self.train_features, self.labels,
            torch.from_numpy(bm).to(self.device), self.gen,
            self.importance_train)
        self._params_version += 1
        loss = float(metrics["loss"])
        acc = float(metrics["accuracy"])
        # cumulative over the run, summed on the host in int64 (the
        # reference sums Python ints, vrgcn.py:62): the --data budget and
        # the `data =` log column never wrap
        self.amt_data += int(metrics["amt_steps"].cpu().numpy()
                             .astype(np.int64).sum())
        self._record_epoch_stats(metrics, time.time() - t0)
        return loss, acc, time.time() - t0, bm.shape[0]

    def _record_epoch_stats(self, metrics, run_t: float):
        """FLOP/size accounting per epoch (gcn/vrgcn.py:50-69): sparse ops
        g_ops = (adj + fadj nnz) * dim * 4, dense ops nn_ops =
        sum(layer_comp * field size) * 4, each doubled under cvd.  Also
        keeps ``is_dropped``, the selected IS slots the slot cap dropped
        over the epoch."""
        spec = self.train_spec
        field_sizes, adj_sizes, fadj_sizes, is_dropped = (
            metrics[k].cpu().numpy()
            for k in ("field_sizes", "adj_sizes", "fadj_sizes",
                      "is_dropped"))
        mult = 2 if spec.cvd else 1      # CVD runs two streams
        g_ops = 0.0
        for l in range(spec.num_agg_layers):
            dim = spec.agg0_dim if l == 0 else self.cfg.hidden1
            g_ops += float(adj_sizes[l] + fadj_sizes[l]) * dim * 4 * mult
        nn_ops = sum(comp * float(field_sizes[idx]) * 4 * mult
                     for comp, idx in spec.layer_comp)
        self.epoch_stats = dict(run_t=run_t, g_t=0.0, g_ops=g_ops,
                                nn_ops=nn_ops, field_sizes=field_sizes,
                                adj_sizes=adj_sizes, fadj_sizes=fadj_sizes,
                                is_dropped=int(is_dropped))

    def _run(self, epoch, data_ids, owner_grouped: bool = False):
        bm = self._epoch_matrix(data_ids, self.cfg.test_batch_size) \
            if owner_grouped else self._batch_matrix(
                data_ids, self.cfg.test_batch_size, self.ds.num_data)
        with torch.no_grad():
            self.eval_histories, out = epoch(
                self._eval_params(), self.eval_histories, self.graph_full,
                self.test_features, self.labels,
                torch.from_numpy(bm).to(self.device), self.gen,
                self.importance_test)
        return out

    def evaluate(self, data_ids):
        """Batched evaluation; with test_cv every pass refreshes the eval
        histories.  Returns (loss, accuracy, micro F1, macro F1, seconds)."""
        t0 = time.time()
        data_ids = np.asarray(self._to_internal(data_ids), np.int32)
        out = self._run(self._eval_epoch, data_ids, owner_grouped=True)
        nvalid = out["nvalid"].cpu().numpy()
        total_loss = float((out["losses"].cpu().numpy() * nvalid).sum()
                           / len(data_ids))
        total_acc = float((out["accs"].cpu().numpy() * nvalid).sum()
                          / len(data_ids))
        micro, macro = f1_from_counts(out["tp"].cpu().numpy(),
                                      out["fp"].cpu().numpy(),
                                      out["fn"].cpu().numpy(),
                                      self.cfg.multitask)
        return total_loss, total_acc, micro, macro, time.time() - t0

    def predict(self, data_ids, refresh=True) -> np.ndarray:
        """Per-node class probabilities [len(ids), C] float32 in the
        caller's id order.

        With ``refresh`` and a CV eval model, first runs ``num_layers``
        passes over every node so the eval histories converge and the
        result equals exact inference.  The refresh is incremental: it
        runs once per weight change (``refresh="force"`` overrides)."""
        cfg = self.cfg
        n = self.ds.num_data
        stale = (refresh == "force"
                 or self._hist_fresh_version != self._params_version)
        if refresh and cfg.test_cv and stale:
            all_ids = np.arange(n, dtype=np.int32)
            for _ in range(cfg.num_layers):
                self.evaluate(all_ids)
            self._hist_fresh_version = self._params_version
        ids = np.asarray(self._to_internal(data_ids), np.int32)
        out = self._run(self._predict_epoch, ids)
        # the batch field of each step is that step's row of the batch
        # matrix, so the flattened predictions are in caller order
        preds = out["preds"].reshape(-1, out["preds"].shape[-1])
        return preds[:len(ids)].cpu().numpy()

    def test(self, log=print):
        """One Test pass over the test split; with test_cv the other nodes
        are evaluated too, so the histories keep converging."""
        res = self.evaluate(self.ds.test_d)
        test_cost, test_acc, micro, macro, dur = res
        self._log(log)(f"Test set results: cost= {test_cost:.5f} "
            f"accuracy= {test_acc:.5f} mi F1={micro:.5f} ma F1={macro:.5f}  "
            f"time= {dur:.5f}")
        if self.cfg.test_cv:
            remaining = np.setdiff1d(np.arange(self.ds.num_data),
                                     self.ds.test_d).astype(np.int32)
            if len(remaining):
                self.evaluate(remaining)
        return test_acc, micro, macro

    def run_tests(self, log=print):
        """num_layers + 1 Test passes under test_cv (CV inference converges
        to exact), one otherwise."""
        num_runs = self.cfg.num_layers + 1 if self.cfg.test_cv else 1
        out = None
        for _ in range(num_runs):
            out = self.test(log)
        return out

    def activation_stats(self, data_ids=None, train: bool = True) -> dict:
        """Per-layer activation moments of one batch: the training model,
        histories and sampling (with dropout) with ``train``, the
        evaluation model's otherwise.  ``data_ids`` defaults to the first
        train (validation) batch.  Returns ``{label: {"mean", "std",
        "absmax"}}`` as Python floats, the labels of
        :func:`models.gcn.forward`'s taps."""
        cfg, n = self.cfg, self.ds.num_data
        if data_ids is None:
            data_ids = self.ds.train_d[:cfg.batch_size] if train \
                else self.ds.val_d[:cfg.test_batch_size]
        bsz = cfg.batch_size if train else cfg.test_batch_size
        batch = torch.from_numpy(self._batch_matrix(
            self._to_internal(np.asarray(data_ids)[:bsz]), bsz,
            n)[0]).to(self.device)
        if train:
            fn = S.make_activation_taps(cfg, self.train_spec,
                                        self.train_degrees, n, True,
                                        self.mesh)
            out = fn(self.state.params, self.state.histories,
                     self.graph_train, self.train_features, self.labels,
                     batch, self.gen, self.importance_train)
        else:
            fn = S.make_activation_taps(cfg, self.test_spec,
                                        self.test_degrees, n, False,
                                        self.mesh)
            out = fn(self._eval_params(), self.eval_histories,
                     self.graph_full, self.test_features, self.labels,
                     batch, self.gen, self.importance_test)
        return {k: {"mean": float(m), "std": float(s), "absmax": float(a)}
                for k, (m, s, a) in out.items()}

    def gradient_variance(self, times: int = 1000, log=print) -> dict:
        """Bias and standard deviation of the predictions and of the
        first-layer weight gradient of the train model (sampled, with
        dropout) against the eval model (``full``), over ``times`` fresh
        schedules and dropout masks of the first train batch.  Every figure
        is the mean absolute value over elements, relative to the mean
        absolute full prediction or gradient.  Returns ``pred_bias``,
        ``grad_bias``, ``pred_stdev``, ``grad_stdev``, ``full_pred_stdev``
        and ``full_grad_stdev``."""
        cfg, n = self.cfg, self.ds.num_data
        log = self._log(log)
        # under --owner_batching the train step sees owner-grouped batches:
        # the instrument measures through the same layout
        batch = torch.from_numpy(self._epoch_matrix(
            self._to_internal(self.ds.train_d[:cfg.batch_size]),
            cfg.batch_size)[0]).to(self.device)
        full_fn = S.build_pred_and_grad(cfg, self.test_spec,
                                        self.test_degrees, n, False,
                                        self.mesh)
        part_fn = S.build_pred_and_grad(cfg, self.train_spec,
                                        self.train_degrees, n, True,
                                        self.mesh)

        def sample(fn, histories, graph, features, importance):
            preds, grads = Stat(), Stat()
            for _ in range(times):
                p, g = fn(self.state.params, histories, graph, features,
                          self.labels, batch, self.gen, importance)
                preds.add(p)
                grads.add(g)
            return preds, grads

        full_preds, full_grads = sample(full_fn, self.eval_histories,
                                        self.graph_full, self.test_features,
                                        self.importance_test)
        fp_m = np.mean(np.abs(full_preds.mean()))
        fg_m = np.mean(np.abs(full_grads.mean()))
        log(f"Full pred stdev = {np.mean(full_preds.std()) / fp_m}")
        log(f"Full grad stdev = {np.mean(full_grads.std()) / fg_m}")
        part_preds, part_grads = sample(part_fn, self.state.histories,
                                        self.graph_train,
                                        self.train_features,
                                        self.importance_train)
        out = dict(
            pred_bias=np.mean(np.abs(part_preds.mean()
                                     - full_preds.mean())) / fp_m,
            grad_bias=np.mean(np.abs(full_grads.mean()
                                     - part_grads.mean())) / fg_m,
            pred_stdev=np.mean(part_preds.std()) / fp_m,
            grad_stdev=np.mean(part_grads.std()) / fg_m,
            full_pred_stdev=np.mean(full_preds.std()) / fp_m,
            full_grad_stdev=np.mean(full_grads.std()) / fg_m)
        log(f"Part pred bias = {out['pred_bias']}")
        log(f"Part pred stdev = {out['pred_stdev']}")
        log(f"Part grad bias = {out['grad_bias']}")
        log(f"Part grad stdev = {out['grad_stdev']}")
        return out

    # ------------------------------------------------------------------
    def _profile_this(self, epoch_1based: int) -> bool:
        """--profile_dir: trace the epochs listed in --profile_epochs
        (1-based, comma-separated) with torch.profiler."""
        cfg = self.cfg
        if not cfg.profile_dir:
            return False
        try:
            wanted = {int(e) for e in str(cfg.profile_epochs).split(",")
                      if str(e).strip()}
        except ValueError:
            return False
        return epoch_1based in wanted

    def _profiled_train_epoch(self, epoch_1based: int, log):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            out = self.train_epoch()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"epoch{epoch_1based}.trace.json")
        prof.export_chrome_trace(path)
        log(f"profiler trace of epoch {epoch_1based} written to {path}")
        return out

    def sgd_train(self, log=print, max_epochs: Optional[int] = None):
        """SGDTrain (train.py:170-238): epoch loop, validation, early
        stopping on the trailing-window validation loss, then the final
        save, durable before this returns.  The preemption handlers are
        restored only after that save is on disk, so a SIGTERM during it
        (or during its background write) still just sets the stop flag.
        If training raises, a write in flight is still joined (and its own
        error logged) before the exception propagates."""
        cfg = self.cfg
        log = self._log(log)
        try:
            if cfg.load and not cfg.resume:
                self.load()
                return
            start_epoch = self._try_resume(log) if cfg.resume else 0
            self._sgd_epoch_loop(cfg, start_epoch, max_epochs, log)
            log("Optimization Finished!")
            self.save()
            self.finish_checkpoints()
        except BaseException:
            try:
                self.finish_checkpoints()
            except Exception as e:
                log(f"checkpoint write failed while training failed: {e!r}")
            raise
        finally:
            self._restore_preemption_handlers()

    def _sgd_epoch_loop(self, cfg, start_epoch, max_epochs, log):
        for epoch in range(start_epoch,
                           max_epochs if max_epochs is not None
                           else 100000000):
            if self._profile_this(epoch + 1):
                train_loss, train_acc, ttime, _ = \
                    self._profiled_train_epoch(epoch + 1, log)
            else:
                train_loss, train_acc, ttime, _ = self.train_epoch()
            cost, acc, micro, macro, duration = self.evaluate(self.ds.val_d)
            self.cost_val.append(cost)
            self.completed_epochs = epoch + 1
            log(f"Epoch: {epoch + 1:04d} "
                f"train_loss= {train_loss:.5f} train_acc= {train_acc:.5f} "
                f"val_loss= {cost:.5f} val_acc= {acc:.5f} "
                f"mi F1={micro:.5f} ma F1={macro:.5f}  "
                f"time= {ttime:.5f} ttime= {duration:.5f} "
                f"data = {self.amt_data}")
            if self.epoch_stats:
                es = self.epoch_stats
                g = float(2 ** 30)
                log(f"TF time = {es['run_t']}, g time = {es['g_t']}, "
                    f"G GFLOPS = {es['g_ops'] / g}, "
                    f"NN GFLOPS = {es['nn_ops'] / g}, "
                    f"field sizes = {es['field_sizes']}, "
                    f"adj sizes = {es['adj_sizes']}, "
                    f"fadj sizes = {es['fadj_sizes']}")
            if cfg.ckpt_every and (epoch + 1) % cfg.ckpt_every == 0:
                self.save()
            # preemption notice (install_preemption_handler): leave the
            # loop at the epoch boundary; sgd_train saves for --resume.
            # Under a mesh every rank takes the branch any rank takes.
            if D.allreduce_flag(self.stop_requested, self.device):
                self.stop_requested = True
                log(f"Preemption stop after epoch {epoch + 1}; "
                    "checkpointing for --resume...")
                break
            if (epoch > cfg.early_stopping and
                    self.cost_val[-1] > np.mean(
                        self.cost_val[-(cfg.early_stopping + 1):-1])):
                log("Early stopping...")
                break
            # reference stop: 0-based epoch > FLAGS.epochs (train.py:234)
            if self.amt_data >= cfg.data and epoch > cfg.epochs:
                break

    # ------------------------------------------------------------------
    def _whole_state(self):
        """``(train state, eval histories)`` in the one-device layout: the
        history blocks gathered into whole tables and, under tensor
        parallelism, the column blocks of the params, the Adam moments and
        the Polyak average gathered too (every rank takes part)."""
        mesh, spec = self.mesh, self.train_spec
        st = self.state

        def tree(t):
            return None if t is None else M.gather_param_tree(t, spec, mesh)
        state = dataclasses.replace(
            st, params=tree(st.params),
            opt_state=dataclasses.replace(st.opt_state,
                                          mu=tree(st.opt_state.mu),
                                          nu=tree(st.opt_state.nu)),
            avg_params=tree(st.avg_params),
            histories=M.whole_histories(st.histories, spec, mesh))
        return state, M.whole_histories(self.eval_histories, self.test_spec,
                                        mesh)

    def save(self):
        """Write the full state in the JAX layout to
        ``<ckpt_dir>/model.ckpt.npz``, with the --resume loop counters;
        returns the path.  With ``--ckpt_async`` in one process the state
        is snapshotted and written in the background
        (:class:`AsyncCheckpointer`): the file is there once
        :meth:`finish_checkpoints` returns.  Under a mesh the blocks are
        gathered into whole tables (every rank takes part;
        :meth:`_whole_state`) and global rank 0 writes them, whatever
        ``--ckpt_async`` says, as in the JAX package."""
        extra = {"completed_epochs": np.int64(self.completed_epochs),
                 "amt_data": np.int64(self.amt_data),
                 "cost_val": np.asarray(self.cost_val, np.float64)}
        if self.cfg.ckpt_async and self.mesh is None:
            if self._async_ckpt is None:
                self._async_ckpt = AsyncCheckpointer(self.device)
            return self._async_ckpt.save(
                self.cfg.ckpt_dir, self.state, self.eval_histories,
                self.cfg.seed, extra=extra, compress=self.cfg.ckpt_compress)
        state, eval_h = self._whole_state()
        path = None
        if self._main:
            path = save_checkpoint(self.cfg.ckpt_dir, state, eval_h,
                                   self.cfg.seed, extra=extra,
                                   compress=self.cfg.ckpt_compress)
        if self.mesh is not None:
            torch.distributed.barrier()
        return path

    def finish_checkpoints(self) -> None:
        """Wait for an async checkpoint write in flight, re-raising its
        error.  :meth:`load`, :meth:`_try_resume` and the end of
        :meth:`sgd_train` call it; so must anything else that reads the
        file back or exits the process."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    def _load_sharded(self, load_history: bool) -> None:
        """:meth:`load` under a mesh: every leaf read whole into a
        one-device-layout copy of the state, then each rank keeps its
        blocks (its rows of the histories; under tensor parallelism its
        columns of the params, the Adam moments, the Polyak average and
        the histories)."""
        mesh, p = self.mesh, self.mesh.size
        lay_tr = M.column_layout(self.train_spec, mesh.model_size)
        lay_te = M.column_layout(self.test_spec, mesh.model_size)

        def blank_tree(tree):
            if tree is None:
                return None
            return {l: {n: t if lay_tr.params[l] is None else t.new_zeros(
                (t.shape[0], lay_tr.params[l].width)) for n, t in q.items()}
                for l, q in tree.items()}

        def blank(histories, lay):
            if not load_history:
                return histories
            return tuple(tuple(h.new_zeros((
                h.shape[0] * p, h.shape[1] if c is None else c.width))
                for h in hl) for hl, c in zip(histories, lay.histories))
        st = self.state
        state = dataclasses.replace(
            st, params=blank_tree(st.params),
            opt_state=dataclasses.replace(
                st.opt_state, mu=blank_tree(st.opt_state.mu),
                nu=blank_tree(st.opt_state.nu)),
            avg_params=blank_tree(st.avg_params),
            histories=blank(st.histories, lay_tr))
        eval_h = blank(self.eval_histories, lay_te)
        load_checkpoint(self.cfg.ckpt_dir, state, eval_h,
                        load_history=load_history)
        with torch.no_grad():
            for mine, got in ((st.params, state.params),
                              (st.opt_state.mu, state.opt_state.mu),
                              (st.opt_state.nu, state.opt_state.nu),
                              (st.avg_params, state.avg_params)):
                if mine is None:
                    continue
                blocks = M.shard_param_tree(got, self.train_spec, mesh)
                for l, q in mine.items():
                    for n, t in q.items():
                        t.copy_(blocks[l][n])
            if load_history:
                for mine, got, spec in (
                        (st.histories, state.histories, self.train_spec),
                        (self.eval_histories, eval_h, self.test_spec)):
                    for l, (hl, gl) in enumerate(zip(mine, got)):
                        for h, g in zip(hl, gl):
                            h.copy_(M.history_block(g, spec, l, mesh))

    def install_preemption_handler(self, signals=None):
        """Route SIGTERM (the eviction notice cluster managers send before
        reclaiming a worker) to a graceful stop: the epoch in flight
        finishes, the loop exits at the boundary, and sgd_train's final
        save writes the --resume counters.  Chains to any previously
        installed handler; SIGINT is left alone.  sgd_train restores the
        previous handlers once its final save is on disk."""
        for sig in (signals or (signal.SIGTERM,)):
            prev = signal.getsignal(sig)
            self._prev_sig_handlers.append((sig, prev))

            def _handler(signum, frame, _prev=prev):
                self.stop_requested = True
                if callable(_prev):
                    _prev(signum, frame)

            signal.signal(sig, _handler)

    def _restore_preemption_handlers(self):
        for sig, prev in reversed(self._prev_sig_handlers):
            signal.signal(sig, prev)
        self._prev_sig_handlers = []

    def _try_resume(self, log=print) -> int:
        """--resume: restore the full state and loop counters from
        ckpt_dir if a checkpoint exists (else start fresh, so one command
        line serves first launch and relaunch).  Returns the 0-based epoch
        to continue from.  The host-side shuffle order restarts from the
        iterator's seed, and the torch generators restart from cfg.seed:
        neither is checkpointed (a JAX checkpoint's key cannot seed them)."""
        self.finish_checkpoints()
        path = checkpoint_path(self.cfg.ckpt_dir)
        if not os.path.exists(path):
            log(f"resume: no checkpoint at {path}, starting fresh")
            return 0
        self.load(load_history=True)
        ex = load_loop_extras(self.cfg.ckpt_dir)
        self.completed_epochs = int(ex.get("completed_epochs", 0))
        self.amt_data = int(ex.get("amt_data", 0))
        self.cost_val = [float(c) for c in ex.get("cost_val", [])]
        log(f"resume: continuing from epoch {self.completed_epochs + 1} "
            f"(data = {self.amt_data})")
        return self.completed_epochs

    def load(self, load_history: Optional[bool] = None):
        """Restore ``<ckpt_dir>/model.ckpt.npz``, written by either package:
        params, Adam state, step and the Polyak average (reconciled with
        this run's ``polyak_decay``), plus (``load_history``; by default
        only under ``--gradvar``) the train and eval histories.  Then, as in the JAX Trainer (train.py:174), the
        eval histories take a copy of the CURRENT train histories cast to
        the eval dtype when the two models' history shapes match.  The
        checkpoint's JAX RNG key is not carried over: the frameworks draw
        different streams."""
        self.finish_checkpoints()      # read after write
        if load_history is None:
            load_history = self.cfg.gradvar
        if self.mesh is None:
            load_checkpoint(self.cfg.ckpt_dir, self.state,
                            self.eval_histories, load_history=load_history)
        else:
            self._load_sharded(load_history)
        self._params_version += 1      # new weights: predict must refresh
        train_h = [h for hl in self.state.histories for h in hl]
        eval_h = [h for hl in self.eval_histories for h in hl]
        if train_h and eval_h and \
                [h.shape for h in train_h] == [h.shape for h in eval_h]:
            with torch.no_grad():
                for t, e in zip(train_h, eval_h):
                    e.copy_(t)
