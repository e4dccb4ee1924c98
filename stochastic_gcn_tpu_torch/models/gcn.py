"""GCN model family: spec construction, parameter init, forward.

Port of stochastic_gcn_tpu/models/gcn.py.  The ``*Spec`` dataclasses and
:func:`build_model_spec` are the same pure-Python description of the layer
stack; parameters are ``{layer: {name: Tensor}}`` dicts with the JAX names
(``dense0`` ... ``weights`` / ``offset`` / ``scale``) and layout.

The train/eval model distinction is: same params, different ModelSpec
(cv/cvd/preprocess flags) plus different graph and history.

Tensor parallelism (``--tp T``, a mesh with ``model_size`` T): GSPMD lays
out the JAX package's tensors; here :func:`column_layout` does, by the
JAX package's ``param_sharding_rule``: every param layer whose output
width tiles over T keeps a column block of its weights, offset and scale
(and of the Adam moments and Polyak average), and its output is that
column block of the activations; a layer whose output does not tile (the
head of 41 classes, every layer when ``hidden1 % T``) is whole on every
model rank.  A dense layer needs its input whole: a column-sharded input
is all-gathered over the model group first (the gradient reduce-scattered
back when the layer is sharded, sliced when it is whole), which is what
GSPMD inserts.  Aggregators work column by column on the blocks, and a
history takes the layout of its aggregator's input: ``[rows / dp, d /
T]`` blocks.  The one difference from the JAX layout: a history whose
input is whole (the raw features of the first aggregator without
preprocessing) stays whole over the model group, where JAX shards its
columns too when they tile; a checkpoint holds whole tables either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple, Union

import torch

from ..data.graph import PaddedSparseFeatures
from ..ops import layers as L
from ..ops.gather import row_gather
from ..parallel.halo import row_gather as halo_row_gather
from ..parallel.halo import row_gather2
from ..parallel.mesh import (Cols, all_gather_rows, all_reduce_max,
                             all_reduce_sum, gather_cols, model_copy,
                             tensor_parallel)
from ..sampler.scheduler import BatchFields
from . import aggregators as agg


# ----------------------------- layer specs --------------------------------

@dataclass(frozen=True)
class DropoutSpec:
    pass


@dataclass(frozen=True)
class DenseSpec:
    name: str
    input_dim: int
    output_dim: int
    relu: bool
    norm: bool
    sparse_inputs: bool = False


@dataclass(frozen=True)
class AugDenseSpec:
    name: str
    input_dim: int
    output_dim: int
    norm: bool
    sparse_inputs: bool = False


@dataclass(frozen=True)
class DetFCSpec:
    name: str
    input_dim: int
    output_dim: int
    norm: bool
    sparse_inputs: bool = False


@dataclass(frozen=True)
class AggSpec:
    index: int


LayerSpec = Union[DropoutSpec, DenseSpec, AugDenseSpec, DetFCSpec, AggSpec]


@dataclass(frozen=True)
class ModelSpec:
    """Static model description."""
    reverse_input_dropout: bool
    specs: Tuple[LayerSpec, ...]
    num_agg_layers: int          # L after the PP adjustment
    agg0_dim: int
    input_dim: int               # dim of the assembled input features
    output_dim: int
    cv: bool
    cvd: bool
    det_dropout: bool
    normalization: str
    multitask: bool
    history_dims: Tuple[int, ...]
    n_history_per_layer: int
    # (input_dim*output_dim, field index) per FC block — FLOP bookkeeping
    layer_comp: Tuple[Tuple[int, int], ...] = ()


def build_model_spec(cfg, input_dim: int, output_dim: int, preprocess: bool,
                     cv: bool, cvd: bool,
                     sparse_input: bool = False) -> ModelSpec:
    """The layer stack for ``cfg``: PP FC blocks, then L x (aggregator + FC
    blocks), with Dense / AugmentedDropoutDense / DetDropoutFC selection
    and the --reverse dropout placement.

    ``input_dim`` is the raw feature dimension; under PP the assembled
    input is [X_self ‖ ÂX] for graphsage norm (2x dim) or ÂX for gcn norm.
    """
    n_agg = cfg.num_layers - 1 if preprocess else cfg.num_layers
    agg0_dim = cfg.hidden1 if preprocess else input_dim
    dim_s = 1 if cfg.normalization == "gcn" else 2

    specs: list[LayerSpec] = []
    layer_comp: list[tuple[int, int]] = []
    cnt = 0

    if preprocess:
        for l in range(cfg.num_fc_layers):
            in_dim = input_dim * dim_s if l == 0 else cfg.hidden1
            sp = sparse_input if l == 0 else False
            last = (n_agg == 0 and l + 1 == cfg.num_fc_layers)
            out_dim = output_dim if last else cfg.hidden1
            layer_comp.append((in_dim * cfg.hidden1, 0))
            if cfg.det_dropout:
                # the reference hardwires output_dim=hidden1 and
                # norm=layer_norm here
                specs.append(DetFCSpec(f"dense{cnt}", in_dim, cfg.hidden1,
                                       cfg.layer_norm, sp))
            elif cvd:
                specs.append(AugDenseSpec(f"dense{cnt}", in_dim, cfg.hidden1,
                                          cfg.layer_norm, sp))
            else:
                specs.append(DropoutSpec())
                specs.append(DenseSpec(f"dense{cnt}", in_dim, out_dim,
                                       relu=not last,
                                       norm=(False if last
                                             else cfg.layer_norm),
                                       sparse_inputs=sp))
            cnt += 1

    for l in range(n_agg):
        specs.append(AggSpec(l))
        for l2 in range(cfg.num_fc_layers):
            dim = agg0_dim if l == 0 else cfg.hidden1
            in_dim = dim * dim_s if l2 == 0 else cfg.hidden1
            last = (l2 + 1 == cfg.num_fc_layers and l + 1 == n_agg)
            out_dim = output_dim if last else cfg.hidden1
            norm = False if last else cfg.layer_norm
            layer_comp.append((in_dim * out_dim, l + 1))
            if cfg.det_dropout and l + 1 != n_agg:
                specs.append(DetFCSpec(f"dense{cnt}", in_dim, out_dim, norm))
            elif cvd and l + 1 != n_agg:
                specs.append(AugDenseSpec(f"dense{cnt}", in_dim, out_dim,
                                          norm))
            else:
                if not cfg.reverse:
                    specs.append(DropoutSpec())
                specs.append(DenseSpec(f"dense{cnt}", in_dim, out_dim,
                                       relu=not last, norm=norm))
                if cfg.reverse and not last:
                    specs.append(DropoutSpec())
            cnt += 1

    hist_dims = tuple(agg0_dim if i == 0 else cfg.hidden1
                      for i in range(n_agg))
    return ModelSpec(
        # host-side input dropout under --reverse exists only in the
        # reference's PlainGCN
        reverse_input_dropout=cfg.reverse and not cv,
        specs=tuple(specs), num_agg_layers=n_agg, agg0_dim=agg0_dim,
        input_dim=input_dim * dim_s if preprocess and cfg.pp_nbr
        else input_dim,
        output_dim=output_dim, cv=cv, cvd=cvd,
        det_dropout=cfg.det_dropout, normalization=cfg.normalization,
        multitask=cfg.multitask, history_dims=hist_dims,
        n_history_per_layer=2 if cfg.det_dropout else 1,
        layer_comp=tuple(layer_comp))


# ----------------------------- parameters ---------------------------------

_PARAM_SPECS = (DenseSpec, AugDenseSpec, DetFCSpec)


def init_params(gen: torch.Generator, spec: ModelSpec) -> dict:
    """Glorot weights (zero offset, unit scale) on ``gen``'s device."""
    return {s.name: L.init_dense(gen, s.input_dim, s.output_dim, s.norm)
            for s in spec.specs if isinstance(s, _PARAM_SPECS)}


@dataclass(frozen=True)
class ColumnLayout:
    """Where the columns of each tensor of a model lie under tensor
    parallelism of ``tp`` model ranks: ``after[i]`` is the layout of the
    activations after ``spec.specs[i]`` (None: whole on every model rank),
    ``params`` that of each param layer's output columns (its weights,
    offset and scale), ``histories`` that of each aggregator's input, which
    its history tables share."""
    tp: int
    after: tuple
    params: dict
    histories: tuple


@lru_cache(maxsize=None)
def column_layout(spec: ModelSpec, tp: int) -> ColumnLayout:
    """The JAX package's ``param_sharding_rule`` applied to ``spec``: a
    param layer whose output width tiles over ``tp`` is column-sharded in
    contiguous blocks, and the columns flow on through dropout and the
    aggregators (the graphsage concat ``[self ‖ agg]`` holds two disjoint
    ranges a rank)."""
    after, params, hist = [], {}, []
    cols = None
    for s in spec.specs:
        if isinstance(s, _PARAM_SPECS):
            cols = Cols.block(s.output_dim, tp) \
                if tp > 1 and s.output_dim % tp == 0 else None
            params[s.name] = cols
        elif isinstance(s, AggSpec):
            hist.append(cols)
            if cols is not None and spec.normalization != "gcn":
                cols = cols.concat()
        after.append(cols)
    return ColumnLayout(tp, tuple(after), params, tuple(hist))


def shard_param_tree(tree: dict, spec: ModelSpec, mesh) -> dict:
    """This rank's columns of a whole ``{layer: {name: [r, out]}}`` tree
    (params, an Adam moment, the Polyak average); the tree itself without
    tensor parallelism."""
    if not tensor_parallel(mesh):
        return tree
    lay = column_layout(spec, mesh.model_size)
    return {l: {n: t if lay.params[l] is None
                else lay.params[l].take(t, mesh).contiguous()
                for n, t in p.items()} for l, p in tree.items()}


def gather_param_tree(tree: dict, spec: ModelSpec, mesh) -> dict:
    """The whole tree of this rank's column blocks (every model rank takes
    part); the tree itself without tensor parallelism."""
    if not tensor_parallel(mesh):
        return tree
    lay = column_layout(spec, mesh.model_size)
    return {l: {n: t if lay.params[l] is None
                else gather_cols(t.detach(), lay.params[l], mesh)
                for n, t in p.items()} for l, p in tree.items()}


def whole_histories(histories, spec: ModelSpec, mesh):
    """The whole ``[R, d]`` tables of this rank's history blocks (rows over
    the data ranks, columns over the model ranks; every rank takes part);
    the tables themselves without a mesh."""
    if mesh is None:
        return histories
    lay = column_layout(spec, mesh.model_size) \
        if tensor_parallel(mesh) else None
    out = []
    for l, hl in enumerate(histories):
        rows = [all_gather_rows(h, mesh) for h in hl]
        if lay is not None and lay.histories[l] is not None:
            rows = [gather_cols(h, lay.histories[l], mesh) for h in rows]
        out.append(tuple(rows))
    return tuple(out)


def history_block(table: torch.Tensor, spec: ModelSpec, l: int, mesh):
    """This rank's block of a whole history table of aggregator ``l``."""
    if mesh is None:
        return table
    block = mesh.local(table)
    if tensor_parallel(mesh):
        cols = column_layout(spec, mesh.model_size).histories[l]
        if cols is not None:
            block = cols.take(block, mesh)
    return block


def first_param_layer(spec: ModelSpec) -> str:
    """Name of the first layer carrying variables (the weight-decay
    target)."""
    for s in spec.specs:
        if isinstance(s, _PARAM_SPECS):
            return s.name
    raise ValueError("model has no parametric layers")


def weight_decay_param_names(spec: ModelSpec) -> Tuple[str, Tuple[str, ...]]:
    """(layer name, param names) the weight decay covers: the reference's
    ``Dense`` registers only its weights, AugmentedDropoutDense /
    DetDropoutFC also their layer-norm offset/scale."""
    for s in spec.specs:
        if isinstance(s, DenseSpec):
            return s.name, ("weights",)
        if isinstance(s, (AugDenseSpec, DetFCSpec)):
            names = ("weights", "offset", "scale") if s.norm \
                else ("weights",)
            return s.name, names
    raise ValueError("model has no parametric layers")


def init_histories(spec: ModelSpec, num_nodes: int, row_multiple: int = 8,
                   dtype=torch.float32, device="cpu", mesh=None):
    """Zero history buffers: per agg layer, 1 (2 for det_dropout) arrays of
    shape [R, d], R = N+1 rounded up to ``row_multiple``; rows past the
    sentinel are never addressed.  With a ``mesh`` (``row_multiple`` a
    multiple of its size) this rank's ``[R / P, d]`` block of each, and
    under tensor parallelism its columns of a history whose aggregator
    input is column-sharded (:func:`column_layout`): ``[R / P, d / T]``."""
    if not spec.cv:
        return tuple()
    rows = -(-(num_nodes + 1) // row_multiple) * row_multiple
    widths = list(spec.history_dims)
    if mesh is not None:
        rows = mesh.block(rows)[1]
        if tensor_parallel(mesh):
            lay = column_layout(spec, mesh.model_size)
            widths = [d if c is None else d // mesh.model_size
                      for d, c in zip(widths, lay.histories)]
    return tuple(
        tuple(torch.zeros((rows, d), dtype=dtype, device=device)
              for _ in range(spec.n_history_per_layer))
        for d in widths)


# ----------------------------- forward ------------------------------------

def _slice_inputs(features, field0: torch.Tensor, num_nodes: int = -1,
                  mesh=None):
    """The layer-0 field's feature rows; sentinel ids read zero rows.  Of
    padded-sparse features the ``(idx, val)`` rows and their ``ends``: an
    id at or above the sentinel reads row N, whose slots are ``(dim, 0)``
    and whose end is 0.  Row-sharded features (``mesh.shard_graph``) are
    read from their owners, row N of padded-sparse ones included, their
    ends in the same exchange as their rows."""
    if mesh is not None and mesh.shard_graph:
        if isinstance(features, PaddedSparseFeatures):
            idx, val, *ends = row_gather2(features.idx, features.val,
                                          field0, mesh,
                                          local_e=features.ends)
            return features.replace(idx=idx, val=val,
                                    ends=ends[0] if ends else None)
        return halo_row_gather(features, field0, mesh, num_nodes)
    if isinstance(features, PaddedSparseFeatures):
        ids = field0.to(torch.int64).clamp(max=features.idx.shape[0] - 1)
        ends = features.ends
        return features.replace(idx=features.idx.index_select(0, ids),
                                val=features.val.index_select(0, ids),
                                ends=None if ends is None
                                else ends.index_select(0, ids))
    return row_gather(features, field0, sentinel=num_nodes)


def _densify(h: PaddedSparseFeatures) -> torch.Tensor:
    """``[R, dim]`` float32 rows of padded-sparse ``h`` (the reference's
    sparse_to_dense, gcn/models.py:128-133): each value added at its
    column, the sentinel slots' zeros at column ``dim - 1``."""
    rows = h.idx.shape[0]
    dense = torch.zeros((rows, h.dim), dtype=torch.float32,
                        device=h.val.device)
    r = torch.arange(rows, device=h.val.device)[:, None].expand_as(h.idx)
    safe = torch.clamp(h.idx, max=h.dim - 1).to(torch.int64)
    return dense.index_put_((r, safe), h.val.float(), accumulate=True)


def _tap(taps, label: str, h, mesh=None, cols=None) -> None:
    """Append ``(label, mean, population std, absmax)`` of ``h`` in float32
    (of the mean stream of a CVD ``(mu, var)`` pair, of the stored values
    of padded-sparse features) to ``taps``, a list the caller owns; None
    taps nothing.  With a ``mesh`` ``h`` is a row block and the moments
    are those of the whole tensor (sums over the ranks); ``cols``: it is
    also a column block of that layout, gathered first."""
    if taps is None:
        return
    if isinstance(h, PaddedSparseFeatures):
        h = h.val
    x = (h[0] if isinstance(h, tuple) else h).detach().float()
    if cols is not None:
        x = gather_cols(x, cols, mesh)
    if mesh is None:
        taps.append((label, x.mean(), torch.std(x, correction=0),
                     x.abs().max()))
        return
    tot = all_reduce_sum(torch.stack([x.sum(), x.new_tensor(x.numel())]),
                         mesh)
    mean = tot[0] / tot[1]
    var = all_reduce_sum((x - mean).square().sum(), mesh) / tot[1]
    top = all_reduce_max(x.abs().max(), mesh)
    taps.append((label, mean, torch.sqrt(var), top))


def forward(params: dict, spec: ModelSpec, pack: BatchFields, graph,
            histories, features, gen: torch.Generator,
            keep_prob: float, train: bool, taps=None, lazy=None, mesh=None):
    """Run the layer stack.

    Returns (logits [B, output_dim], new_histories) where new_histories[l]
    is a tuple of arrays on the rows of pack.fields[l], to be scattered
    into the history buffers at those node ids.  ``taps``: a list that
    takes the moments (:func:`_tap`) of the input, labelled ``"input"``,
    and of every layer's output, labelled ``"<i>:<spec class>"`` as in the
    JAX package.  ``features`` is a dense ``[N+1, d]`` table or
    :class:`PaddedSparseFeatures`; when no layer takes sparse input (no
    preprocessing: an aggregator comes first) the sliced rows are
    densified.  ``lazy``: the epoch-frozen CV anchor of ``--lazy_fullterm``,
    ``(snapshot histories, a-bar tables)`` with the per-layer structure of
    ``histories``; None runs the per-step full term.

    ``mesh``: data parallelism.  The pack is the global schedule; this rank
    computes its row block of every field (parallel/mesh.py), with its
    history blocks, and returns its block of the logits and of each new
    history.  Dropout takes this rank's rows of the global draw.  Under
    tensor parallelism (``mesh.model_size > 1``) every tensor has the
    columns :func:`column_layout` gives it, and the logits are whole on
    every model rank (module docstring)."""
    kp = keep_prob if train else 1.0
    lay = column_layout(spec, mesh.model_size) \
        if tensor_parallel(mesh) else None

    def rows_of(field):
        # this rank's ids of a field, and its (rows, lo) dropout block
        if mesh is None:
            return field, None
        lo, m = mesh.block(field.shape[0])
        return field.narrow(0, lo, m), (field.shape[0], lo)

    def draw_block(block, cols, like):
        # the dropout block of a tensor of layout ``cols``
        if cols is None or block is None:
            return block
        return (*block, cols.width, cols.own(mesh, like.device))

    field0, block = rows_of(pack.fields[0])
    h = _slice_inputs(features, field0, graph.num_nodes, mesh)
    if spec.reverse_input_dropout and train:
        h = L._dropout(gen, h, kp, block)
    if isinstance(h, PaddedSparseFeatures) and not any(
            isinstance(s, _PARAM_SPECS) and s.sparse_inputs
            for s in spec.specs):
        h = _densify(h)
    _tap(taps, "input", h, mesh)
    new_histories = [None] * spec.num_agg_layers
    cols = None                         # the columns h holds (None: whole)
    for i, s in enumerate(spec.specs):
        if isinstance(s, DropoutSpec):
            first = h[0] if isinstance(h, tuple) else h
            h = L.dropout_layer(gen, h, kp, spec.cvd,
                                draw_block(block, cols, first))
        elif isinstance(s, _PARAM_SPECS):
            tp_mesh = None
            if lay is not None:
                tp_mesh = mesh if lay.params[s.name] is not None else None
                h = _whole_over_model(h, cols, tp_mesh is not None, mesh)
            if isinstance(s, DenseSpec):
                h = L.dense(params[s.name], h,
                            L.relu if s.relu else L.identity, s.norm,
                            tp_mesh)
            elif isinstance(s, AugDenseSpec):
                h = L.aug_dropout_dense(params[s.name], gen, h, kp, L.relu,
                                        s.norm, block, tp_mesh)
            else:
                h = L.det_dropout_fc(params[s.name], h, kp, s.norm, tp_mesh)
        elif isinstance(s, AggSpec):
            l = s.index
            ls = pack.layers[l]
            if spec.cv:
                h, new_histories[l] = agg.vr_aggregate(
                    h, ls, pack.fields[l], pack.fields[l + 1], graph,
                    histories[l], spec.cvd, spec.normalization,
                    lazy_l=None if lazy is None
                    else (lazy[0][l], lazy[1][l]), mesh=mesh)
            else:
                h = agg.plain_aggregate(h, ls, spec.normalization, mesh)
            block = rows_of(pack.fields[l + 1])[1]
        if lay is not None:
            cols = lay.after[i]
        _tap(taps, f"{i}:{type(s).__name__}", h, mesh, cols)
    if cols is not None:
        # a column-sharded head: the loss is computed whole on every rank
        h = gather_cols(h, cols, mesh, scatter=False)
    return h, tuple(new_histories)


def _whole_over_model(h, cols: Optional[Cols], sharded: bool, mesh):
    """The input of a param layer, whole on every model rank: a column
    block of layout ``cols`` all-gathered (the gradient reduce-scattered
    when the layer is ``sharded``, each rank's product using its own
    columns only; sliced when the layer is whole, its gradient the same on
    every rank); a whole input of a sharded layer passes through
    :func:`~..parallel.mesh.model_copy` (the gradient summed)."""
    if isinstance(h, tuple):
        return tuple(_whole_over_model(t, cols, sharded, mesh) for t in h)
    if isinstance(h, PaddedSparseFeatures):
        return h
    if cols is None:
        return model_copy(h, mesh) if sharded else h
    return gather_cols(h, cols, mesh, scatter=sharded)


# ------------------------- loss / metrics ---------------------------------

def loss_and_metrics(params: dict, spec: ModelSpec, logits: torch.Tensor,
                     labels: torch.Tensor, valid_mask: torch.Tensor,
                     weight_decay: float, nvalid=None):
    """Masked loss and accuracy over real (non-sentinel) batch rows, plus
    L2 weight decay (sum(w^2)/2) over the first parametric layer's
    registered vars.  ``nvalid``: the divisor (the valid rows of the
    whole batch when the rows here are one rank's block of it)."""
    first, names = weight_decay_param_names(spec)
    wd = sum(params[first][n].square().sum() / 2.0 for n in names)
    return masked_loss_and_accuracy(weight_decay * wd, logits, labels,
                                    valid_mask, spec.multitask, nvalid)


def masked_loss_and_accuracy(penalty, logits: torch.Tensor,
                             labels: torch.Tensor, valid_mask: torch.Tensor,
                             multitask: bool, nvalid=None):
    """``penalty`` plus the mean cross-entropy over the valid rows (sigmoid
    per class when ``multitask``, softmax otherwise), and the accuracy
    over them; ``nvalid`` overrides the count of valid rows."""
    nvalid = torch.clamp(valid_mask.sum() if nvalid is None else nvalid,
                         min=1.0)
    if multitask:
        ce = (torch.relu(logits) - logits * labels
              + torch.log1p(torch.exp(-logits.abs()))).mean(dim=1)
        preds_ok = (logits > 0) == (labels > 0.5)
        acc_row = preds_ok.float().mean(dim=1)
    else:
        ce = -(labels * torch.log_softmax(logits, dim=1)).sum(dim=1)
        acc_row = (logits.argmax(dim=1) == labels.argmax(dim=1)).float()
    loss = penalty + (ce * valid_mask).sum() / nvalid
    accuracy = (acc_row * valid_mask).sum() / nvalid
    return loss, accuracy


def predict(spec: ModelSpec, logits: torch.Tensor) -> torch.Tensor:
    if spec.multitask:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=1)
