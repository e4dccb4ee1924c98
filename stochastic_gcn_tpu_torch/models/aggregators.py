"""Aggregation ops: the plain and control-variate (CV) estimators.

Port of stochastic_gcn_tpu/models/aggregators.py for the padded graph and
the prefix field layout:

* sampled SpMM ``A_samp . X`` -> :func:`fanout_gather`, the fanout kernel
  (the estimators without a control variate);
* the CV estimator's sampled term on top of the full term,
  ``A_samp . (H - h_bar[field_in]) + base`` -> ``cv_fanout_aggregate``, one
  kernel for the whole delta;
* full-neighbourhood SpMM ``A_full . h_bar`` -> :func:`full_neighborhood_mean`,
  the full-term kernel over the device-resident ``[N+1, d]`` history.

CVD, det-dropout, the lazy full term and the edge-list layout are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from ..data.graph import PaddedGraph, graph_rows
from ..ops.cuda_spmm import (FanoutAggregate, cv_fanout_aggregate,
                             hbm_gather_aggregate)
from ..ops.gather import row_gather
from ..sampler.scheduler import LayerSample


def fanout_gather(x: torch.Tensor, slot_pos: torch.Tensor,
                  slot_w: torch.Tensor) -> torch.Tensor:
    """[C_in, d], [F, k], [F, k] -> [F, d]: out[f] = sum_s w[f,s]*x[pos[f,s]];
    positions >= C_in (parked slots) read as zero rows.  Differentiable in
    ``x``; the scheduler's slots are contiguous int32 / float32 already, and
    anything else raises rather than being copied on every call."""
    return FanoutAggregate.apply(x, slot_pos, slot_w)


def history_gather(hist: torch.Tensor, ids: torch.Tensor,
                   sentinel: int) -> torch.Tensor:
    """``h_bar[ids]``; ``sentinel`` is the node count, so sentinel field ids
    read zero rows instead of row N's garbage.  The history carries no
    gradient, so nothing in an autograd graph refers to it when the train
    step scatters new rows into it in place."""
    if hist.requires_grad:
        raise ValueError("the CV history must not require grad")
    return row_gather(hist, ids, sentinel=sentinel)


def full_neighborhood_mean(hist: torch.Tensor, graph: PaddedGraph,
                           field_out: torch.Tensor) -> torch.Tensor:
    """``(A_full . h_bar)[field_out]``: padded full-row contraction, float32.

    The JAX package splits wide fields into a two-tier main + tail
    contraction (``tiered_full_contract``) as a TPU perf gate; that split
    is exact, so the full-width kernel gives the same value.  Whether
    tiering pays on the H100 is open (ROADMAP.md)."""
    if not isinstance(graph, PaddedGraph):
        raise NotImplementedError(
            "edge-list graphs are not ported yet (ROADMAP.md, queue 1)")
    fnbr, fw, _ = graph_rows(graph, field_out)
    return hbm_gather_aggregate(hist, fnbr, fw)


def _self_rows(x: torch.Tensor, ls: LayerSample) -> torch.Tensor:
    """The output field's rows of an input-field tensor: the ``[:F_out]``
    prefix of the append-only layout."""
    return x[:ls.slot_pos.shape[0]]


def _self_concat(normalization: str, self_part: torch.Tensor,
                 nbr_part: torch.Tensor) -> torch.Tensor:
    if normalization == "gcn":
        return nbr_part
    return torch.cat((self_part, nbr_part), dim=1)


def plain_aggregate(inputs, ls: LayerSample, normalization: str):
    """PlainAggregator: Z = A_samp . H, with the self concat under graphsage
    normalization."""
    if isinstance(inputs, tuple):
        raise NotImplementedError(
            "det-dropout moments are not ported yet (ROADMAP.md, queue 1)")
    nbr = fanout_gather(inputs, ls.slot_pos, ls.slot_w)
    return _self_concat(normalization, _self_rows(inputs, ls), nbr)


def vr_aggregate(inputs, ls: LayerSample, field_in: torch.Tensor,
                 field_out: torch.Tensor, graph: PaddedGraph, history,
                 cvd: bool, normalization: str, lazy_l=None):
    """VRAggregator, plain CV branch:
    ``Z = A_samp . (H - h_bar[field_in]) + A_full . h_bar``.

    Returns (outputs, new_history) where new_history holds the rows to
    scatter back at ``field_in``."""
    if cvd or isinstance(inputs, tuple) or lazy_l is not None:
        raise NotImplementedError(
            "CVD, det-dropout and the lazy full term are not ported yet "
            "(ROADMAP.md, queue 1)")
    base = full_neighborhood_mean(history[0], graph, field_out)
    a_neighbour = cv_fanout_aggregate(inputs, history[0], field_in,
                                      graph.num_nodes, ls.slot_pos, ls.slot_w,
                                      base)
    return (_self_concat(normalization, _self_rows(inputs, ls), a_neighbour),
            (inputs,))
