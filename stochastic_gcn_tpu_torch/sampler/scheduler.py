"""On-device receptive-field scheduler (uniform sampling, no-dedup layout).

Port of stochastic_gcn_tpu/sampler/scheduler.py.  The layer-by-layer
expansion runs on the device over the :class:`PaddedGraph`:

* uniform fanout sampling without replacement — one uniform per row at
  degree 1, top-k of iid uniforms over the padded row otherwise; edge
  weights are rescaled by ``deg/|sampled|`` so the estimator is unbiased;
* the append-only field layout: the input field is ``field_out ++
  sampled ids`` and ``slot_pos[f, j] = F + f*k + j``, so the output field is
  a prefix of the input field;
* sentinel padding: absent slots/nodes use id ``N`` with weight 0.

Dedup compaction, importance sampling and owner-aligned layouts are not
ported yet: the scheduler raises where the JAX one would take them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import PaddedGraph, graph_rows

_NOT_PORTED = ("not ported yet: see ROADMAP.md, queue 1, "
               "'compact_field and dedup' / 'IS'")


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
    fields[-1] the batch; layers[l] maps fields[l] -> fields[l+1]."""
    fields: Tuple[torch.Tensor, ...]
    layers: Tuple[LayerSample, ...]


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


def expand_uniform(gen: torch.Generator, graph: PaddedGraph,
                   field_out: torch.Tensor, degree: int, need_aw: bool):
    """Sample <= ``degree`` neighbors/node uniformly without replacement.

    Returns (nbr_id [F,k] int32, slot_w [F,k], slot_aw or None, scales [F]).
    """
    dcap = graph.pad_degree
    rows_nbr, rows_w, deg = graph_rows(graph, field_out)   # [F, Dcap]
    f = field_out.shape[0]
    k = min(degree, dcap)
    dev = rows_nbr.device

    if k >= dcap:
        nbr_id, base_w = rows_nbr, rows_w
    else:
        if k == 1:
            # a single draw without replacement is a uniform pick over the
            # deg valid slots: one uniform per row
            u = torch.rand(f, generator=gen, device=dev)
            sel = torch.minimum((u * deg.float()).to(torch.int32),
                                torch.clamp(deg - 1, min=0))[:, None]
        else:
            u = torch.rand((f, dcap), generator=gen, device=dev)
            valid = (torch.arange(dcap, dtype=torch.int32, device=dev)[None, :]
                     < deg[:, None])
            u = torch.where(valid, u, -1.0)
            sel = torch.topk(u, k, dim=1).indices   # [F, k] distinct slots
        sel = sel.to(torch.int64)
        nbr_id = torch.take_along_dim(rows_nbr, sel, dim=1)
        base_w = torch.take_along_dim(rows_w, sel, dim=1)

    adj_size = deg.clamp(min=1, max=k).float()
    scale = torch.where(deg == 0, 1.0, deg.float() / adj_size)
    slot_w = base_w * scale[:, None]
    slot_aw = base_w * slot_w if need_aw else None
    return nbr_id, slot_w, slot_aw, torch.rsqrt(scale)


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


def schedule(gen: torch.Generator, graph: PaddedGraph,
             batch_ids: torch.Tensor, degrees: Sequence[int], cv: bool,
             need_aw: bool = False, importance=None, owner_blocks: int = 0,
             dedup: bool = False) -> BatchFields:
    """Build the receptive field of one minibatch: expand top-down with
    ``degrees[L-1], ..., degrees[0]`` and return everything input side
    first.  ``batch_ids`` is [batch_size] int32, sentinel (``N``)-padded.
    """
    n = graph.num_nodes
    degrees = list(degrees)
    num_layers = len(degrees)
    if importance is not None or owner_blocks > 1:
        raise NotImplementedError(
            f"importance sampling / owner-aligned fields {_NOT_PORTED}")
    if effective_dedup(dedup, batch_ids.shape[0], degrees, n,
                       graph.pad_degree):
        why = "asked for" if dedup else (
            f"forced: some layer samples more than 2N = {2 * n} slots at "
            f"batch {batch_ids.shape[0]}; a smaller batch avoids it")
        raise NotImplementedError(
            f"dedup-compacted fields ({why}) {_NOT_PORTED}")
    caps = field_capacities(batch_ids.shape[0], degrees, n, graph.pad_degree,
                            dedup=False)

    field = batch_ids.to(torch.int32)
    fields = [field]
    layer_samples = []
    for l in range(num_layers):
        degree = degrees[num_layers - l - 1]
        nbr_id, slot_w, slot_aw, scales = expand_uniform(
            gen, graph, field, degree, need_aw)
        field, slot_pos = append_field(field, nbr_id, n,
                                       caps[num_layers - l - 1])
        layer_samples.append(LayerSample(slot_pos=slot_pos, slot_w=slot_w,
                                         slot_aw=slot_aw, scales=scales))
        fields.append(field)
    fields.reverse()
    layer_samples.reverse()
    return BatchFields(fields=tuple(fields), layers=tuple(layer_samples))


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
