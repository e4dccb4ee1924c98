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

All three branches of the control-variate aggregator run on these kernels:
plain CV, CVD (a noisy stream ``h`` and a clean stream ``mu``) and the
det-dropout moments ``(mu, var)``, whose variance takes the squared and the
cross edge weights.  The lazy full term and the edge-list layout are not
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
                           field_out: torch.Tensor,
                           square: bool = False) -> torch.Tensor:
    """``(A_full . h_bar)[field_out]``: padded full-row contraction, float32.
    ``square=True`` uses squared edge weights (the det-dropout variance
    term).

    The JAX package splits wide fields into a two-tier main + tail
    contraction (``tiered_full_contract``) as a TPU perf gate; that split
    is exact, so the full-width kernel gives the same value.  Whether
    tiering pays on the H100 is open (ROADMAP.md)."""
    if not isinstance(graph, PaddedGraph):
        raise NotImplementedError(
            "edge-list graphs are not ported yet (ROADMAP.md, queue 1)")
    fnbr, fw, _ = graph_rows(graph, field_out)
    if square:
        fw = fw.square()
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


def _concat_pair(normalization: str, a, b, ls: LayerSample, a_nbr, b_nbr):
    """The self concat of :func:`_self_concat` for both tensors of a pair."""
    return (_self_concat(normalization, _self_rows(a, ls), a_nbr),
            _self_concat(normalization, _self_rows(b, ls), b_nbr))


def plain_aggregate(inputs, ls: LayerSample, normalization: str):
    """PlainAggregator: Z = A_samp . H, with the self concat under graphsage
    normalization; a ``(mu, var)`` pair takes the squared weights for the
    variance."""
    if isinstance(inputs, tuple):
        mu, var = inputs
        mu_n = fanout_gather(mu, ls.slot_pos, ls.slot_w)
        var_n = fanout_gather(var, ls.slot_pos, ls.slot_w.square())
        return _concat_pair(normalization, mu, var, ls, mu_n, var_n)
    nbr = fanout_gather(inputs, ls.slot_pos, ls.slot_w)
    return _self_concat(normalization, _self_rows(inputs, ls), nbr)


def vr_aggregate(inputs, ls: LayerSample, field_in: torch.Tensor,
                 field_out: torch.Tensor, graph: PaddedGraph, history,
                 cvd: bool, normalization: str, lazy_l=None):
    """VRAggregator.  Returns (outputs, new_history) where new_history
    holds the rows to scatter back at ``field_in``.  Three branches, as in
    the JAX package:

    * ``cvd`` — ``inputs = (h, mu)``: the clean stream takes the CV
      estimator, ``mu_n = A_samp . (mu - h_bar[field_in]) + A_full . h_bar``
      (``mu`` is detached by the layer that made it, so this kernel runs
      outside autograd), and the noisy stream the sampled term of its
      deviation, scaled per node: ``h_n = A_samp . (h - mu) * scales + mu_n``;
    * a ``(mu, var)`` pair — det-dropout: ``mu`` as above, and with
      ``sigma = sqrt(var)``, ``sigma_bar = sqrt(var_bar[field_in])``, the
      variance ``A_samp^2 . (sigma - sigma_bar)^2 + A_full^2 . var_bar
      + 2 (a * A_samp) . ((sigma - sigma_bar) sigma_bar)``, rectified,
      plus 1e-10;
    * a tensor — plain CV:
      ``Z = A_samp . (H - h_bar[field_in]) + A_full . h_bar``.

    Every sum is one of the hand-written kernels; every ``A_samp . (X -
    h_bar[field_in]) + base`` is one launch of ``cv_fanout_aggregate``."""
    if lazy_l is not None:
        raise NotImplementedError(
            "the lazy full term is not ported yet (ROADMAP.md, queue 1)")
    n = graph.num_nodes

    def cv_term(x):
        base = full_neighborhood_mean(history[0], graph, field_out)
        return cv_fanout_aggregate(x, history[0], field_in, n, ls.slot_pos,
                                   ls.slot_w, base)

    if cvd:
        h, mu = inputs
        mu_n = cv_term(mu)
        h_n = fanout_gather(h - mu, ls.slot_pos, ls.slot_w) \
            * ls.scales[:, None] + mu_n
        return _concat_pair(normalization, h, mu, ls, h_n, mu_n), (mu,)

    if isinstance(inputs, tuple):
        mu, var = inputs
        # the root in the history's own type, widened by the subtraction:
        # where the JAX model takes it
        sigma_bar = torch.sqrt(history_gather(history[1], field_in, n))
        delta_sigma = torch.sqrt(var) - sigma_bar
        mu_n = cv_term(mu)
        var_n = (fanout_gather(delta_sigma.square(), ls.slot_pos,
                               ls.slot_w.square())
                 + full_neighborhood_mean(history[1], graph, field_out,
                                          square=True)
                 + 2.0 * fanout_gather(delta_sigma * sigma_bar, ls.slot_pos,
                                       ls.slot_aw))
        var_n = torch.relu(var_n) + 1e-10
        return _concat_pair(normalization, mu, var, ls, mu_n, var_n), \
            (mu, var)

    a_neighbour = cv_term(inputs)
    return (_self_concat(normalization, _self_rows(inputs, ls), a_neighbour),
            (inputs,))
