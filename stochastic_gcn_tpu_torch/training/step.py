"""Train and eval steps, epochs and the history scatter.

Port of stochastic_gcn_tpu/training/step.py.  An epoch is a Python loop
over the rows of a device-resident ``[S, B]`` batch-id matrix (the JAX
package's ``lax.scan``); every per-step result stays on the device until
the loop ends, so an epoch waits for the device once, at its end.

Ordering contract (as in the JAX step, gcn/models.py:186-191): the history
is updated with the activations that produced this step's gradient, after
the Adam update.

The JAX epoch's ``sched_prepass`` and ``scan_unroll`` are TPU dispatch
knobs with no effect on the trajectory (the JAX test suite checks that it
is bit-identical); the port's loop has no counterpart and ignores them.

Data parallelism (``mesh``, parallel/mesh.py): every rank runs the same
global schedule (``round_multiple=cfg.dp``) and computes its row block of
every field; the loss is the local sum over the rank's valid batch rows
divided by the whole batch's count (the weight decay on rank 0 only), so
the gradients ``all_reduce``d (summed) over the ranks are those of the
global loss, and every rank applies the same Adam update to its copy of
the params.  Histories are row-sharded and written through the
owner-routed scatter; the metrics every step returns are the global ones.
With ``cfg.owner_batching`` the schedules of the train step, the eval
epoch, pred-and-grad and the activation taps take the owner-aligned field
layout (``owner_blocks = cfg.dp``, sampler/scheduler.py), so a rank's
block of every field, and the history rows it writes, are mostly its own.

Tensor parallelism (``--tp T``, a mesh of ``dp x T`` ranks): the params a
rank holds are its column blocks (models/gcn.py::column_layout), the
gradients are all-reduced over its data group only (the ranks of its
model index, which hold the same blocks), Adam and the Polyak EMA work on
the blocks element by element, and the histories are written as column
blocks.  The weight decay is added on data index 0 of every model index,
so each block's L2 is counted once; the loss the step reports adds the
other blocks' L2 (a sum over the model group), so it is the whole
model's on every rank.  The logits come from a head every model rank
computes whole, so the loss, accuracy and F1 reductions run over the data
group as under dp alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..data.graph import FlatGraph
from ..models import aggregators as A
from ..models import gcn as M
from ..ops.gather import row_gather
from ..parallel import halo
from ..parallel.mesh import (all_gather_rows, all_reduce_sum, gather_cols,
                             model_sum, row_multiple, tensor_parallel)
from ..sampler.scheduler import BatchFields, importance_row_table, schedule
from ..utils.metrics import device_f1_counts

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count (int32 scalar) and
    the first and second moments, ``{layer: {name: Tensor}}`` like the
    params, so the state carries across to and from JAX leaf by leaf."""
    count: torch.Tensor
    mu: dict
    nu: dict


@dataclass
class TrainState:
    params: dict              # {layer: {name: Tensor}}, JAX names and layout
    opt_state: AdamState
    histories: tuple          # per agg layer: tuple of [N+1, d] tensors
    step: torch.Tensor        # int32 scalar
    # Polyak / EMA average of the params after each update; None unless
    # polyak_decay > 0
    avg_params: Optional[dict] = None


def param_keys(params: dict) -> list:
    """(layer, name) of every param in a fixed order."""
    return [(layer, name) for layer in sorted(params)
            for name in sorted(params[layer])]


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` over ``{layer: {name: Tensor}}``
    dicts, with optax's arithmetic: ``mu = (1-b1) g + b1 mu``,
    ``nu = (1-b2) g^2 + b2 nu``, ``count += 1``,
    ``p += -lr * (mu / (1-b1^count)) / (sqrt(nu / (1-b2^count)) + eps)``.
    :meth:`update` works in place on the params and the state (one
    ``torch._foreach_*`` launch per operation) and keeps ``count`` on the
    device, so a step never waits for the host."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: dict) -> AdamState:
        def zeros():
            return {l: {n: torch.zeros_like(t) for n, t in p.items()}
                    for l, p in params.items()}
        device = next(t for p in params.values() for t in p.values()).device
        return AdamState(count=torch.zeros((), dtype=torch.int32,
                                           device=device),
                         mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict) -> None:
        keys = param_keys(params)
        g = [grads[l][n] for l, n in keys]
        mu = [state.mu[l][n] for l, n in keys]
        nu = [state.nu[l][n] for l, n in keys]
        p = [params[l][n] for l, n in keys]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - self.b2))
        state.count += 1
        t = state.count.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, t)
        bc2 = 1 - torch.pow(self.b2, t)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(p, upd)


def make_optimizer(cfg) -> Adam:
    """Adam with the reference's hyperparameters (eps 1e-8 outside the
    sqrt, as tf.train.AdamOptimizer and the JAX package's optax.adam)."""
    return Adam(cfg.learning_rate, cfg.beta1, cfg.beta2, eps=1e-8)


def init_train_state(gen: torch.Generator, cfg, spec: M.ModelSpec,
                     num_nodes: int, device="cpu", mesh=None) -> TrainState:
    """Glorot params from ``gen`` (a CPU generator, so every device starts
    from the same values), zero Adam moments and zero histories of
    ``cfg.history_dtype`` (rows padded to ``row_multiple(dp)``, 8 at dp 1;
    this rank's block of them with a ``mesh``), all on ``device``.  Under
    tensor parallelism every rank draws the whole glorot matrices and
    keeps its columns, so the run starts from the weights of one
    device."""
    params = M.shard_param_tree(
        {l: {n: t.to(device) for n, t in p.items()}
         for l, p in M.init_params(gen, spec).items()}, spec, mesh)
    avg = {l: {n: t.clone() for n, t in p.items()}
           for l, p in params.items()} if cfg.polyak_decay > 0 else None
    return TrainState(
        params=params, opt_state=make_optimizer(cfg).init(params),
        histories=M.init_histories(spec, num_nodes, row_multiple(cfg.dp),
                                   DTYPES[cfg.history_dtype], device, mesh),
        step=torch.zeros((), dtype=torch.int32, device=device),
        avg_params=avg)


def scatter_histories(histories, new_histories, fields, num_nodes: int,
                      mesh=None):
    """history[field_l] <- new rows, for the input-side fields
    ``fields[:-1]``; updates the history tensors IN PLACE and returns them.
    With a ``mesh`` the new rows are this rank's block of each field and
    the histories its blocks: the rows go to their owners
    (parallel/halo.py::row_scatter), sentinel writes skipped.

    Sentinel-padded field entries write into row N, which is safe: every
    read of row N is masked by a zero edge weight or a sentinel gather.
    Dedup-compacted fields hold each real id once.  Under the no-dedup
    layout a field may repeat an id; each duplicate carries an equally
    valid sample of the same activation, and which write wins is
    unspecified (on CUDA it varies from run to run).  ``index_copy_``
    serves both, so the JAX function's ``unique`` hint has no counterpart
    here."""
    for hist_l, new_l, field_l in zip(histories, new_histories, fields[:-1]):
        if new_l is None:
            continue
        if mesh is not None:
            ids = mesh.local(field_l)
            for h, nh in zip(hist_l, new_l):
                halo.row_scatter(h, ids, nh, mesh, sentinel=num_nodes,
                                 count="history writes")
            continue
        ids = field_l.to(torch.int64)
        for h, nh in zip(hist_l, new_l):
            h.index_copy_(0, ids, nh.to(h.dtype))
    return histories


def _labels_gather(labels: torch.Tensor, batch_field: torch.Tensor,
                   num_nodes: int, mesh=None) -> torch.Tensor:
    """labels[batch_field]; sentinel-padded slots read zero rows (their
    loss/accuracy contributions are masked by ``valid``).  Row-sharded
    labels (``mesh.shard_graph``) are read from their owners."""
    if mesh is not None and mesh.shard_graph:
        return halo.row_gather(labels, batch_field, mesh, num_nodes)
    return row_gather(labels, batch_field, sentinel=num_nodes)


class _Batch:
    """The batch rows a step computes: every row on one device, this
    rank's block under a mesh.  ``valid`` masks them; ``nvalid`` counts
    the valid rows of the whole batch (the loss's divisor); ``y`` are
    their labels."""

    def __init__(self, pack: BatchFields, labels, num_nodes: int, mesh):
        field = pack.fields[-1]
        self.rows = field if mesh is None else mesh.local(field)
        self.valid = (self.rows < num_nodes).float()
        self.nvalid = None if mesh is None else (field < num_nodes).sum(
        ).float()
        self.y = _labels_gather(labels, self.rows, num_nodes, mesh)


def _global(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the ranks of a per-rank partial (itself without a
    mesh)."""
    return t if mesh is None else all_reduce_sum(t.clone(), mesh)


def _rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch's rows of a per-rank row block (itself without a
    mesh)."""
    return t if mesh is None else all_gather_rows(t, mesh)


def _weight_decay(cfg, mesh) -> float:
    """The weight decay a rank adds to its loss: all of it on one device
    and on data index 0 (of every model index), none on the other ranks,
    so the gradients summed over a data group count it once."""
    return cfg.weight_decay if mesh is None or mesh.rank == 0 else 0.0


def _reported_loss(loss: torch.Tensor, params: dict, spec: M.ModelSpec,
                   cfg, mesh) -> torch.Tensor:
    """The loss a step reports: ``loss`` summed over the data ranks and,
    when the first layer's weights are column-sharded (tensor
    parallelism), the weight decay of the other model ranks' columns
    added, so it is the whole model's penalty on every rank."""
    loss = _global(loss.detach(), mesh)
    if not tensor_parallel(mesh) or not cfg.weight_decay:
        return loss
    first, names = M.weight_decay_param_names(spec)
    if M.column_layout(spec, mesh.model_size).params[first] is None:
        return loss
    own = cfg.weight_decay * sum(params[first][n].detach().square().sum()
                                 / 2.0 for n in names)
    return loss + (model_sum(own, mesh) - own)


def _allreduce_grads(grads: list, mesh) -> list:
    """Sum the gradients over the ranks in one collective."""
    if mesh is None:
        return grads
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    return [c.view_as(g) for c, g in zip(
        flat.split([g.numel() for g in grads]), grads)]


def _batch_stats(pack: BatchFields, graph, num_nodes: int, cv: bool):
    """amt_data / field / adjacency-size accounting (gcn/vrgcn.py:50-69):
    ``adj_sizes[l]`` = sampled edges of layer l, ``fadj_sizes[l]`` =
    full-neighbourhood edges (CV only), ``field_sizes[l]`` = real nodes in
    field l.  int64 device scalars and vectors."""
    dev = pack.fields[-1].device
    if not pack.layers:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return torch.zeros((), dtype=torch.int64, device=dev), z, z, z
    adj_sizes = torch.stack([(ls.slot_w != 0).sum() for ls in pack.layers])
    field_sizes = torch.stack([(f < num_nodes).sum() for f in pack.fields])
    if cv:
        deg = graph.deg
        if isinstance(graph, FlatGraph):
            # the edge-list full term reads at most edge_cap_per_row edges
            # a row: count what is gathered
            deg = torch.clamp(deg, max=graph.edge_cap_per_row)
        fadj_sizes = torch.stack(
            [deg.index_select(0, f.to(torch.int64)).sum()
             for f in pack.fields[1:]])
    else:
        fadj_sizes = torch.zeros((len(pack.layers),), dtype=torch.int64,
                                 device=dev)
    return adj_sizes.sum(), field_sizes, adj_sizes, fadj_sizes


def _schedule(cfg, spec: M.ModelSpec, degrees: Tuple[int, ...], graph,
              batch_ids: torch.Tensor, gen: torch.Generator, importance,
              train_mode: bool, importance_rows=None,
              mesh=None) -> BatchFields:
    """The schedule of every step: one place for the sampling semantics of
    training (``cfg.importance`` with ``cfg.is_slot_cap``) and of
    evaluation, prediction and the eval side of pred-and-grad
    (``cfg.test_importance``; the auto slot cap, -1, resolves to 0 there,
    so inference keeps every edge into a selected node).  ``importance``
    is the ``[N+1]`` table, needed only when the mode samples by it;
    ``importance_rows`` the ``--is_row_table`` table of it.  Fields are
    rounded to a multiple of ``cfg.dp``, and owner-aligned under a
    ``mesh`` with ``cfg.owner_batching``."""
    use_is = cfg.importance if train_mode else cfg.test_importance
    if use_is and importance is None:
        raise ValueError("importance sampling needs the importance table")
    return schedule(gen, graph, batch_ids, degrees, spec.cv,
                    need_aw=spec.det_dropout,
                    importance=importance if use_is else None,
                    dedup=cfg.field_dedup,
                    is_approx_topk=cfg.is_approx_topk,
                    is_recall_target=cfg.is_recall_target,
                    is_slot_cap=(cfg.is_slot_cap if train_mode
                                 else max(cfg.is_slot_cap, 0)),
                    round_multiple=cfg.dp,
                    importance_rows=importance_rows if use_is else None,
                    owner_blocks=cfg.dp if (cfg.owner_batching
                                            and mesh is not None) else 0)


def _row_table(cfg, graph, importance, use_is: bool):
    """The epoch's ``--is_row_table`` table, or None."""
    if use_is and cfg.is_row_table:
        return importance_row_table(graph, importance)
    return None


def build_train_step(cfg, spec: M.ModelSpec, degrees: Tuple[int, ...],
                     num_nodes: int, mesh=None):
    """``step(state, graph, features, labels, batch_ids, gen, pack=None,
    importance=None, lazy=None) -> (state, metrics)``: schedule (unless a
    prebuilt ``pack`` is given; ``importance`` is the ``[N+1]`` table that
    ``cfg.importance`` samples by), forward (``lazy``: the epoch's frozen
    CV anchor, :func:`lazy_anchor`), loss, backward, Adam, then the
    history scatter of the detached new rows.  ``state`` is updated in
    place and returned; the metrics (loss, accuracy, amt_data,
    field/adj/fadj sizes, ``is_dropped``) stay on the device.

    The params enter the forward as fresh ``requires_grad`` aliases and the
    gradients come from ``torch.autograd.grad``, so no ``.grad`` buffers
    accumulate and the history never enters the autograd graph.

    ``mesh``: the data-parallel step (module docstring); ``importance_rows``
    is the epoch's ``--is_row_table`` table."""
    tx = make_optimizer(cfg)
    wd = _weight_decay(cfg, mesh)

    def _step(state: TrainState, graph, features, labels, batch_ids, gen,
              pack: Optional[BatchFields] = None, importance=None,
              lazy=None, importance_rows=None):
        if pack is None:
            pack = _schedule(cfg, spec, degrees, graph, batch_ids, gen,
                             importance, train_mode=True,
                             importance_rows=importance_rows, mesh=mesh)
        b = _Batch(pack, labels, num_nodes, mesh)

        keys = param_keys(state.params)
        params = {l: {n: t.detach().requires_grad_()
                      for n, t in p.items()}
                  for l, p in state.params.items()}
        logits, new_h = M.forward(params, spec, pack, graph, state.histories,
                                  features, gen, cfg.keep_prob, train=True,
                                  lazy=lazy, mesh=mesh)
        loss, acc = M.loss_and_metrics(params, spec, logits, b.y, b.valid,
                                       wd, b.nvalid)
        # before the update, which the params' aliases see
        reported = _reported_loss(loss, params, spec, cfg, mesh)
        flat = _allreduce_grads(list(torch.autograd.grad(
            loss, [params[l][n] for l, n in keys])), mesh)
        grads: dict = {}
        for (l, n), g in zip(keys, flat):
            grads.setdefault(l, {})[n] = g
        tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            if cfg.polyak_decay > 0:
                # EMA over the weights after the update: a*d + p*(1-d)
                d = cfg.polyak_decay
                avg = [state.avg_params[l][n] for l, n in keys]
                torch._foreach_mul_(avg, d)
                torch._foreach_add_(avg, [state.params[l][n]
                                          for l, n in keys], alpha=1 - d)
            new_h = tuple(None if hl is None else
                          tuple(h.detach() for h in hl) for hl in new_h)
            scatter_histories(state.histories, new_h, pack.fields,
                              num_nodes, mesh)
            state.step += 1
        amt, field_sizes, adj_sizes, fadj_sizes = _batch_stats(
            pack, graph, num_nodes, spec.cv)
        is_dropped = pack.is_dropped if pack.is_dropped is not None \
            else torch.zeros((), dtype=torch.int32, device=amt.device)
        acc = _global(acc.detach(), mesh)
        return state, {"loss": reported, "accuracy": acc,
                       "amt_data": amt, "field_sizes": field_sizes,
                       "adj_sizes": adj_sizes, "fadj_sizes": fadj_sizes,
                       "is_dropped": is_dropped}

    return _step


@torch.no_grad()
def lazy_anchor(spec: M.ModelSpec, histories, graph, num_nodes: int):
    """The epoch-frozen CV anchor of ``--lazy_fullterm``: ``(snapshot,
    a-bar tables)``, a copy of every history table (the train step
    scatters into the live tables in place, which the snapshot must not
    see) and ``A_full . snapshot`` over all nodes (``full_abar``; the
    squared weights for det-dropout's variance table, j = 1)."""
    snap = tuple(tuple(h.clone() for h in hl) for hl in histories)
    abar = tuple(tuple(A.full_abar(h, graph, num_nodes,
                                   square=spec.det_dropout and j == 1)
                       for j, h in enumerate(hl)) for hl in snap)
    return snap, abar


def build_train_epoch(cfg, spec: M.ModelSpec, degrees: Tuple[int, ...],
                      num_nodes: int, mesh=None):
    """Whole-epoch runner: ``epoch(state, graph, features, labels,
    batch_matrix, gen, importance=None) -> (state, metrics)`` runs the
    train step over the rows of an ``[S, B]`` batch-id matrix.  Returns the
    LAST step's loss and accuracy (the reference's window-1 Averager), the
    per-step ``amt_steps`` (the Trainer sums them on the host in int64),
    and the summed ``amt_data``, field/adj/fadj sizes and ``is_dropped``;
    all on the device.

    With ``cfg.lazy_fullterm`` and a CV model the epoch first takes the
    frozen anchor (:func:`lazy_anchor`), inside the epoch as in the JAX
    package, so the epoch's time includes the a-bar build; every step
    reads it, and the scatters keep updating the live histories that the
    next epoch's snapshot takes.  Under a ``mesh`` the full term stays the
    per-step owner-routed one (as in the JAX package).  With importance
    sampling and ``cfg.is_row_table`` the epoch first builds the row
    table (:func:`~..sampler.scheduler.importance_row_table`)."""
    _step = build_train_step(cfg, spec, degrees, num_nodes, mesh)

    def _epoch(state: TrainState, graph, features, labels, batch_matrix,
               gen, importance=None):
        lazy = lazy_anchor(spec, state.histories, graph, num_nodes) \
            if cfg.lazy_fullterm and spec.cv and mesh is None else None
        rows = _row_table(cfg, graph, importance, cfg.importance)
        ms = []
        for batch_ids in batch_matrix:
            state, m = _step(state, graph, features, labels, batch_ids, gen,
                             importance=importance, lazy=lazy,
                             importance_rows=rows)
            ms.append(m)
        amts = torch.stack([m["amt_data"] for m in ms])
        return state, {
            "loss": ms[-1]["loss"], "accuracy": ms[-1]["accuracy"],
            "amt_steps": amts, "amt_data": amts.sum(),
            **{k: torch.stack([m[k] for m in ms]).sum(dim=0)
               for k in ("field_sizes", "adj_sizes", "fadj_sizes",
                         "is_dropped")}}

    return _epoch


def build_eval_epoch(cfg, spec: M.ModelSpec, degrees: Tuple[int, ...],
                     num_nodes: int, with_preds: bool = False, mesh=None):
    """Whole-evaluation runner over an [S, B] batch-id matrix:
    ``epoch(params, histories, graph, features, labels, batch_matrix, gen,
    importance=None) -> (histories, out)`` with per-batch
    losses/accuracies, summed per-class F1 counters and, ``with_preds``,
    the [S, B, C] class probabilities and their [S, B] batch fields.
    Histories are refreshed in place.  Under a ``mesh`` every output is
    the whole batch's, the same on every rank."""
    wd = _weight_decay(cfg, mesh)

    def _eval_one(params, histories, graph, features, labels, batch_ids,
                  gen, importance, rows):
        pack = _schedule(cfg, spec, degrees, graph, batch_ids, gen,
                         importance, train_mode=False,
                         importance_rows=rows, mesh=mesh)
        b = _Batch(pack, labels, num_nodes, mesh)
        logits, new_h = M.forward(params, spec, pack, graph, histories,
                                  features, gen, cfg.keep_prob, train=False,
                                  mesh=mesh)
        loss, acc = M.loss_and_metrics(params, spec, logits, b.y, b.valid,
                                       wd, b.nvalid)
        tp, fp, fn = device_f1_counts(logits, b.y, b.valid, spec.multitask,
                                      mesh)
        scatter_histories(histories, new_h, pack.fields, num_nodes, mesh)
        out = (_reported_loss(loss, params, spec, cfg, mesh),
               _global(acc, mesh), tp, fp, fn,
               (pack.fields[-1] < num_nodes).sum().float())
        if with_preds:
            out = out + (_rows(M.predict(spec, logits), mesh),
                         pack.fields[-1])
        return out

    def _epoch(params, histories, graph, features, labels, batch_matrix,
               gen, importance=None):
        rows = _row_table(cfg, graph, importance, cfg.test_importance)
        ys = [_eval_one(params, histories, graph, features, labels, b, gen,
                        importance, rows)
              for b in batch_matrix]
        cols = [torch.stack(c) for c in zip(*ys)]
        losses, accs, tps, fps, fns, nvalid = cols[:6]
        out = {"losses": losses, "accs": accs,
               "tp": tps.sum(dim=0), "fp": fps.sum(dim=0),
               "fn": fns.sum(dim=0), "nvalid": nvalid}
        if with_preds:
            out["preds"], out["fields"] = cols[6], cols[7]
        return histories, out

    return _epoch


def build_pred_and_grad(cfg, spec: M.ModelSpec, degrees: Tuple[int, ...],
                        num_nodes: int, train_mode: bool = False, mesh=None):
    """``run(params, histories, graph, features, labels, batch_ids, gen,
    importance=None) -> (predictions [B, C], d loss / d first-layer
    weights)``: the probe of the gradient-variance harness.  A fresh
    schedule (training's sampling semantics with ``train_mode``,
    evaluation's otherwise), dropout applied, no weight update and no
    history scatter.  Under a ``mesh`` both are the whole batch's, and the
    gradient the whole matrix's (its column blocks gathered)."""
    wd = _weight_decay(cfg, mesh)

    def _run(params, histories, graph, features, labels, batch_ids, gen,
             importance=None):
        pack = _schedule(cfg, spec, degrees, graph, batch_ids, gen,
                         importance, train_mode, mesh=mesh)
        b = _Batch(pack, labels, num_nodes, mesh)
        first = M.first_param_layer(spec)
        params = {l: {n: t.detach() for n, t in p.items()}
                  for l, p in params.items()}
        weights = params[first]["weights"].requires_grad_()
        logits, _ = M.forward(params, spec, pack, graph, histories, features,
                              gen, cfg.keep_prob, train=True, mesh=mesh)
        loss, _ = M.loss_and_metrics(params, spec, logits, b.y, b.valid,
                                     wd, b.nvalid)
        grad, = _allreduce_grads(list(torch.autograd.grad(loss, [weights])),
                                 mesh)
        if tensor_parallel(mesh):
            cols = M.column_layout(spec, mesh.model_size).params[first]
            if cols is not None:
                grad = gather_cols(grad, cols, mesh)
        return _rows(M.predict(spec, logits.detach()), mesh), grad

    return _run


def make_activation_taps(cfg, spec: M.ModelSpec, degrees: Tuple[int, ...],
                         num_nodes: int, train_mode: bool, mesh=None):
    """``run(params, histories, graph, features, labels, batch_ids, gen,
    importance=None) -> {label: (mean, std, absmax)}``: the per-layer
    activation moments of one batch (the reference's layer activation
    logging, as a standalone probe).  The schedule and dropout of training
    with ``train_mode``, of evaluation otherwise; no history scatter.  The
    moments stay on the device."""

    @torch.no_grad()
    def _run(params, histories, graph, features, labels, batch_ids, gen,
             importance=None):
        pack = _schedule(cfg, spec, degrees, graph, batch_ids, gen,
                         importance, train_mode, mesh=mesh)
        taps: list = []
        M.forward(params, spec, pack, graph, histories, features, gen,
                  cfg.keep_prob, train=train_mode, taps=taps, mesh=mesh)
        return {label: stats for label, *stats in taps}

    return _run
