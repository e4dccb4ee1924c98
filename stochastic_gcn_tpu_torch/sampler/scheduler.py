"""On-device receptive-field scheduler (uniform sampling).

Port of stochastic_gcn_tpu/sampler/scheduler.py.  The layer-by-layer
expansion runs on the device over either graph layout (``graph_rows``;
the edge-list layout draws what the padded one draws from the same
adjacency):

* uniform fanout sampling without replacement — one uniform per row at
  degree 1, top-k of iid uniforms over the padded row otherwise; edge
  weights are rescaled by ``deg/|sampled|`` so the estimator is unbiased;
* dedup-compacted fields (:func:`compact_field`, the default): the input
  field is ``field_out ++ the new unique ids`` in node-id order, capacity
  ``F + min(F*k, N)``, and a slot's position comes from a ``[N+1]``
  position table; weight-masked slots are parked at :data:`PARKED_POS`;
* the append-only field layout (:func:`append_field`, ``dedup=False``
  unless something forces dedup): the input field is ``field_out ++
  sampled ids`` and ``slot_pos[f, j] = F + f*k + j``;
* importance sampling (``importance=``, :func:`is_select`,
  :func:`is_slots`, :func:`is_slot_compact`): ``n = min(|field|*degree,
  |union|)`` members of the neighbour union drawn without replacement with
  probability proportional to importance (Gumbel top-k); every edge into a
  selected node is kept, reweighted, in ``[F, Dcap]`` slots (or the
  ``is_slot_cap`` heaviest per row); fields are dedup-compacted;
* either way the output field is a prefix of the input field;
* sentinel padding: absent slots/nodes use id ``N`` with weight 0.

Every shape is static and nothing waits for the device, so a schedule can
be captured with the step around it.  Owner-aligned layouts are not ported
yet: the scheduler raises where the JAX one would take them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import FlatGraph, graph_rows, graph_slots

_NOT_PORTED = "not ported yet: see ROADMAP.md, queue 1"

# Position of a weight-masked slot (a sentinel-neighbour pad) under dedup:
# any value at or above the field capacity.  The gather kernels read such a
# slot as a zero row and the backward skips it; without parking, every
# masked slot would point at pos_table[N], which is garbage by contract.
PARKED_POS = 1 << 30


@dataclass(frozen=True)
class LayerSample:
    """Sampled adjacency from field l (input) to field l+1 (output).

      slot_pos: [F_out, k] int32 — position of each sampled neighbor in the
                input field.
      slot_w:   [F_out, k] f32   — rescaled edge weight (0 = masked slot).
      slot_aw:  [F_out, k] f32   — a_uv * w_uv cross-term weights, or None.
      scales:   [F_out] f32      — 1/sqrt(deg/k_eff).
    """
    slot_pos: torch.Tensor
    slot_w: torch.Tensor
    slot_aw: Optional[torch.Tensor]
    scales: torch.Tensor


@dataclass(frozen=True)
class BatchFields:
    """Per-minibatch sampling artifacts: fields[0] is the input side,
    fields[-1] the batch; layers[l] maps fields[l] -> fields[l+1].
    ``is_dropped`` (int32 scalar) counts the selected IS slots that
    ``is_slot_cap`` dropped; :func:`schedule` sets it (0 without IS), and a
    pack built by hand may leave it None, which reads as 0."""
    fields: Tuple[torch.Tensor, ...]
    layers: Tuple[LayerSample, ...]
    is_dropped: Optional[torch.Tensor] = None


def field_capacities(batch_size: int, degrees: Sequence[int], num_nodes: int,
                     pad_degree: int, importance: bool = False,
                     round_multiple: int = 1, dedup: bool = True) -> list[int]:
    """Static field capacities, input side first (index 0 = layer-0 field).

    ``dedup=False`` sizes the append-only layout, ``f + f*k`` without the
    ``num_nodes`` clamp; ``round_multiple`` rounds every capacity up."""
    m = max(1, int(round_multiple))
    caps = [batch_size]
    for degree in reversed(list(degrees)):
        k = degree if importance else min(degree, pad_degree)
        f = caps[-1]
        new = f * k if not dedup else min(f * k, num_nodes)
        caps.append(-(-(f + new) // m) * m)
    caps.reverse()
    return caps


def effective_dedup(dedup: bool, batch_size: int, degrees: Sequence[int],
                    num_nodes: int, pad_degree: int,
                    importance: bool = False, owner_blocks: int = 0) -> bool:
    """Whether fields are dedup-compacted: asked for, forced by importance
    sampling or owner-aligned blocks, or forced because some layer's
    candidate count ``f*k`` exceeds ``2*num_nodes``."""
    if dedup or importance or owner_blocks > 1:
        return True
    f = batch_size
    for degree in reversed(list(degrees)):
        k = min(degree, pad_degree)
        if f * k > 2 * num_nodes:
            return True
        f = f + f * k
    return False


def expand_uniform(gen: torch.Generator, graph, field_out: torch.Tensor,
                   degree: int, need_aw: bool):
    """Sample <= ``degree`` neighbors/node uniformly without replacement.

    Returns (nbr_id [F,k] int32, slot_w [F,k], slot_aw or None, scales [F]).
    At degree 1 only the drawn slot of each row is read, not the row."""
    dcap = graph.pad_degree
    f = field_out.shape[0]
    k = min(degree, dcap)
    dev = field_out.device

    if k == 1 and dcap > 1:
        # a single draw without replacement is a uniform pick over the
        # deg valid slots: one uniform per row
        deg = graph.deg.index_select(0, field_out.to(torch.int64))
        u = torch.rand(f, generator=gen, device=dev)
        sel = torch.minimum((u * deg.float()).to(torch.int32),
                            torch.clamp(deg - 1, min=0))
        nbr_id, base_w = (t[:, None] for t in graph_slots(graph, field_out,
                                                           sel))
    else:
        rows_nbr, rows_w, deg = graph_rows(graph, field_out)   # [F, Dcap]
        if k >= dcap:
            nbr_id, base_w = rows_nbr, rows_w
        else:
            u = torch.rand((f, dcap), generator=gen, device=dev)
            valid = (torch.arange(dcap, dtype=torch.int32,
                                  device=dev)[None, :] < deg[:, None])
            u = torch.where(valid, u, -1.0)
            sel = torch.topk(u, k, dim=1).indices   # [F, k] distinct slots
            nbr_id = torch.take_along_dim(rows_nbr, sel, dim=1)
            base_w = torch.take_along_dim(rows_w, sel, dim=1)

    adj_size = deg.clamp(min=1, max=k).float()
    scale = torch.where(deg == 0, 1.0, deg.float() / adj_size)
    slot_w = base_w * scale[:, None]
    slot_aw = base_w * slot_w if need_aw else None
    return nbr_id, slot_w, slot_aw, torch.rsqrt(scale)


def compute_importance(graph) -> torch.Tensor:
    """Per-node importance ``1e-6 + sum of squared in-edge weights``
    (``[N+1]`` float32; the sentinel row holds ``1e-6``), from either
    layout's slot tables (padding slots weigh 0)."""
    n1 = graph.num_nodes + 1
    ids = graph.idx if isinstance(graph, FlatGraph) else graph.nbr
    imp = torch.zeros(n1, dtype=torch.float32, device=graph.w.device)
    imp.index_add_(0, ids.reshape(-1).to(torch.int64),
                   graph.w.square().reshape(-1))
    imp = imp + 1e-6
    imp[n1 - 1] = 1e-6
    return imp


def _gumbel(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """``n`` standard Gumbel draws, ``-log(-log(U))`` with ``U`` clamped
    below at float32's smallest normal, as ``jax.random.gumbel`` draws
    them.  The one place the IS selection takes its noise."""
    u = torch.rand(n, generator=gen, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclass(frozen=True)
class ISSelection:
    """One IS expansion's gathered neighbour rows and the Gumbel top-k
    selection over their union (see :func:`is_select`)."""
    rows_nbr: torch.Tensor    # [F, Dcap] neighbour ids (sentinel-padded)
    rows_w: torch.Tensor      # [F, Dcap] edge weights
    valid: torch.Tensor       # [F, Dcap] bool in-degree mask
    sel_ids: torch.Tensor     # [n_cap] int32 selected members (sentinel-padded)
    selected: torch.Tensor    # [N+1] bool membership table
    total_imp: torch.Tensor   # f32 scalar, importance summed over the union
    n_samples: torch.Tensor   # f32 scalar, the number of members drawn


def is_select(gen: torch.Generator, graph,
              field_out: torch.Tensor, degree: int,
              importance: torch.Tensor, approx_topk: bool = True,
              recall_target: float = 0.95) -> ISSelection:
    """Selection half of importance sampling: gather the field's neighbour
    rows, form their union, and draw ``n = min(|field|*degree, |union|)``
    members without replacement, each with probability proportional to its
    importance (the top ``n`` of ``log(importance) + Gumbel noise``).

    ``n`` stays a device scalar; the top-k takes the static
    ``n_cap = min(F*degree, N)`` and ranks past ``n`` become sentinels, so
    nothing waits for the device.  ``approx_topk`` and ``recall_target``
    are accepted for the JAX signature: torch has no approximate top-k, so
    this is always the exact one (the recall-1.0 case of the JAX
    default)."""
    n = graph.num_nodes
    dcap = graph.pad_degree
    rows_nbr, rows_w, deg = graph_rows(graph, field_out)
    dev = rows_nbr.device
    valid = (torch.arange(dcap, dtype=torch.int32, device=dev)[None, :]
             < deg[:, None])

    union = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    union.index_fill_(0, torch.where(valid, rows_nbr, n).reshape(-1).to(
        torch.int64), True)
    union[n] = False
    total_imp = torch.where(union, importance, 0.0).sum()
    f_true = (field_out < n).sum()
    n_samples = torch.minimum(f_true * degree, union.sum()).to(torch.float32)
    n_cap = min(field_out.shape[0] * degree, n)

    score = torch.where(union, torch.log(importance)
                        + _gumbel(gen, n + 1, dev), -torch.inf)
    top_ids = torch.topk(score, n_cap).indices
    rank_ok = torch.arange(n_cap, device=dev) < n_samples
    sel_ids = torch.where(rank_ok & union.index_select(0, top_ids), top_ids,
                          n).to(torch.int32)
    selected = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    selected.index_fill_(0, sel_ids.to(torch.int64), True)
    selected[n] = False
    return ISSelection(rows_nbr, rows_w, valid, sel_ids, selected, total_imp,
                       n_samples)


def is_slots(sel: ISSelection, importance: torch.Tensor,
             pos_table: torch.Tensor):
    """``[F, Dcap]`` IS slots from a selection and the input field's
    position table: an edge into a selected node keeps its weight times
    ``total_imp / (importance * max(n, 1))``, every other slot weighs 0
    and is parked at :data:`PARKED_POS`.  The multiplier is computed per
    node (0 for unselected nodes, which doubles as the membership test),
    then the slots take it and their positions by two ``[N+1]`` gathers
    (the JAX package packs both into one ``[N+1, 2]`` table because TPU
    gathers cost per row, not per byte; on the H100 the two gathers are no
    slower).  Returns (slot_pos int32, slot_w float32)."""
    inv_col = torch.where(
        sel.selected,
        sel.total_imp / (importance * torch.clamp(sel.n_samples, min=1.0)),
        0.0)
    ids = sel.rows_nbr.reshape(-1).to(torch.int64)
    inv = inv_col.index_select(0, ids).reshape(sel.rows_nbr.shape)
    pos = pos_table.index_select(0, ids).reshape(sel.rows_nbr.shape)
    slot_w = torch.where((inv > 0.0) & sel.valid, sel.rows_w * inv, 0.0)
    slot_pos = torch.where(slot_w != 0.0, pos, PARKED_POS)
    return slot_pos, slot_w


def is_slot_compact(slot_pos: torch.Tensor, slot_w: torch.Tensor, cap: int):
    """``[F, Dcap]`` -> ``[F, cap]`` IS slots: each row keeps its ``cap``
    heaviest slots (weights are nonnegative, so selected slots come before
    the zero ones).  Returns (slot_pos, slot_w, the number of selected slots
    dropped as an int32 device scalar).  ``cap <= 0`` or ``cap >= Dcap``
    returns the slots unchanged and a zero count."""
    dcap = slot_w.shape[1]
    if cap <= 0 or cap >= dcap:
        return slot_pos, slot_w, torch.zeros((), dtype=torch.int32,
                                             device=slot_w.device)
    w_top, idx = torch.topk(slot_w, cap, dim=1)
    pos = torch.take_along_dim(slot_pos, idx, dim=1)
    n_sel = (slot_w > 0).sum(dtype=torch.int32)
    n_kept = (w_top > 0).sum(dtype=torch.int32)
    return pos, w_top, n_sel - n_kept


def append_field(field_out: torch.Tensor, new_ids: torch.Tensor,
                 num_nodes: int, capacity: int):
    """No-dedup field layout: the input field is ``field_out ++
    new_ids.ravel()`` (sentinel-padded to ``capacity``), every sampled slot
    owning its own position ``F + f*k + j``.  Duplicate ids occupy several
    positions, each expanding its own sample in the layers below.

    Returns (field_in [capacity] int32, slot_pos [F, k] int32)."""
    f, k = new_ids.shape
    flat = new_ids.reshape(-1).to(torch.int32)
    pad = capacity - field_out.shape[0] - flat.shape[0]
    parts = [field_out.to(torch.int32), flat]
    if pad:
        parts.append(torch.full((pad,), num_nodes, dtype=torch.int32,
                                device=flat.device))
    field_in = torch.cat(parts)
    slot_pos = (field_out.shape[0]
                + torch.arange(f * k, dtype=torch.int32,
                               device=flat.device).reshape(f, k))
    return field_in, slot_pos


def compact_field(field_out: torch.Tensor, new_ids: torch.Tensor,
                  num_nodes: int, capacity: int):
    """Dedup-compact ``field_out ++ new_ids`` into a static-capacity field.

    The output field occupies positions ``[0, F)`` (the prefix invariant);
    new unique ids get positions ``F + rank`` in node-id order, and the
    rest of the field is sentinel padding.  Returns (field_in [capacity]
    int32, pos_table [N+1] int32) where ``pos_table[id]`` is the position
    of ``id`` in field_in.  ``pos_table[N]`` and the entries of ids outside
    the field are unspecified: they are only ever dereferenced under
    weight-0 masks.  ``field_out``'s real ids must be unique and
    ``capacity - F`` at least the number of new unique ids, as
    :func:`field_capacities` guarantees.

    Static shapes and no host synchronisation: masks and a cumsum over the
    ``N + 1`` ids, then one candidate-sized scatter of each new id to its
    rank (duplicates carry the same id to the same slot, so which write
    wins does not matter; candidates that are not new go to one spare slot
    past the end, which is cut off)."""
    n, f = num_nodes, field_out.shape[0]
    dev = field_out.device
    cand = new_ids.reshape(-1).to(torch.int64)
    seen = field_out.to(torch.int64)
    new_mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    new_mask.index_fill_(0, cand, True).index_fill_(0, seen, False)
    new_mask[n] = False
    cum = torch.cumsum(new_mask, dim=0, dtype=torch.int32)
    pos_table = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    pos_table.index_copy_(0, seen, torch.arange(f, dtype=torch.int32,
                                                device=dev))
    pos_table = torch.where(new_mask, f + cum - 1, pos_table)

    is_new = new_mask.index_select(0, cand)
    rank = cum.index_select(0, cand).to(torch.int64) - 1
    spare = capacity - f
    new_by_rank = torch.full((spare + 1,), n, dtype=torch.int32, device=dev)
    new_by_rank.scatter_(0, torch.where(is_new, rank, spare),
                         cand.to(torch.int32))
    field_in = torch.cat([field_out.to(torch.int32), new_by_rank[:spare]])
    return field_in, pos_table


def schedule(gen: torch.Generator, graph,
             batch_ids: torch.Tensor, degrees: Sequence[int], cv: bool,
             need_aw: bool = False, importance=None, owner_blocks: int = 0,
             dedup: bool = True, is_approx_topk: bool = True,
             is_recall_target: float = 0.95,
             is_slot_cap: int = 0) -> BatchFields:
    """Build the receptive field of one minibatch: expand top-down with
    ``degrees[L-1], ..., degrees[0]`` and return everything input side
    first.  ``batch_ids`` is [batch_size] int32, sentinel (``N``)-padded,
    with unique real ids.

    ``dedup=False`` selects the append-only :func:`append_field` layout
    unless :func:`effective_dedup` forces compaction (importance sampling,
    or a layer that samples more than ``2N`` slots).  ``importance`` (the
    ``[N+1]`` table of :func:`compute_importance`) selects importance
    sampling; ``is_slot_cap`` caps its slots per row (-1: 8 at batch >=
    2048, else 0, no cap)."""
    n = graph.num_nodes
    degrees = list(degrees)
    num_layers = len(degrees)
    use_is = importance is not None
    if owner_blocks > 1:
        raise NotImplementedError(f"owner-aligned fields {_NOT_PORTED}")
    if is_slot_cap < 0:
        # auto: the cap only pays at large batches, where the [F, Dcap]
        # fanout gather dominates the IS step
        is_slot_cap = 8 if batch_ids.shape[0] >= 2048 else 0
    dedup = effective_dedup(dedup, batch_ids.shape[0], degrees, n,
                            graph.pad_degree, importance=use_is)
    caps = field_capacities(batch_ids.shape[0], degrees, n, graph.pad_degree,
                            importance=use_is, dedup=dedup)

    field = batch_ids.to(torch.int32)
    fields = [field]
    layer_samples = []
    is_dropped = torch.zeros((), dtype=torch.int32, device=field.device)
    for l in range(num_layers):
        degree = degrees[num_layers - l - 1]
        cap = caps[num_layers - l - 1]
        if use_is:
            sel = is_select(gen, graph, field, degree, importance,
                            approx_topk=is_approx_topk,
                            recall_target=is_recall_target)
            scales = torch.ones(field.shape[0], dtype=torch.float32,
                                device=field.device)
            field, pos_table = compact_field(field, sel.sel_ids, n, cap)
            slot_pos, slot_w = is_slots(sel, importance, pos_table)
            if is_slot_cap:
                slot_pos, slot_w, drop = is_slot_compact(slot_pos, slot_w,
                                                         is_slot_cap)
                is_dropped = is_dropped + drop
            slot_aw = None
        else:
            nbr_id, slot_w, slot_aw, scales = expand_uniform(
                gen, graph, field, degree, need_aw)
            if dedup:
                field, pos_table = compact_field(field, nbr_id, n, cap)
                # weight-masked slots park instead of all pointing at
                # pos_table[N]
                slot_pos = torch.where(
                    slot_w != 0.0,
                    pos_table.index_select(0, nbr_id.reshape(-1).to(
                        torch.int64)).reshape(nbr_id.shape), PARKED_POS)
            else:
                field, slot_pos = append_field(field, nbr_id, n, cap)
        layer_samples.append(LayerSample(slot_pos=slot_pos, slot_w=slot_w,
                                         slot_aw=slot_aw, scales=scales))
        fields.append(field)
    fields.reverse()
    layer_samples.reverse()
    return BatchFields(fields=tuple(fields), layers=tuple(layer_samples),
                       is_dropped=is_dropped)


class MinibatchIterator:
    """Host-side epoch order of the training ids: ``shuffle()`` permutes
    ``data`` in place with the same numpy ``default_rng(seed)`` stream as
    the JAX package's iterator, so both packages see the same batch order
    (the Trainer cuts ``data`` into its ``[S, B]`` batch matrix)."""

    def __init__(self, data_ids, seed: int):
        self.data = np.asarray(data_ids, np.int32).copy()
        self.rng = np.random.default_rng(seed)

    def shuffle(self) -> None:
        self.rng.shuffle(self.data)
