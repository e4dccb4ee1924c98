"""Aggregation ops: the plain, control-variate (CV) and EMA estimators.

Port of stochastic_gcn_tpu/models/aggregators.py:

* sampled SpMM ``A_samp . X`` -> :func:`fanout_gather`, the fanout kernel
  (the estimators without a control variate, and :func:`ema_aggregate`);
* the CV estimator's sampled term on top of the full term,
  ``A_samp . (H - h_bar[field_in]) + base`` -> ``cv_fanout_aggregate``, one
  kernel for the whole delta;
* full-neighbourhood SpMM ``A_full . h_bar`` -> :func:`full_neighborhood_mean`,
  the full-term kernel over the device-resident ``[N+1, d]`` history, in
  every form the JAX package has: padded rows, edge-list windows
  (:func:`full_neighborhood_mean_edgelist`), the two-tier split of either
  (:func:`tiered_full_contract`, :func:`_tiered_full_edgelist`), and the
  epoch-frozen a-bar table of ``--lazy_fullterm`` (:func:`full_abar`),
  which turns the per-step term into a row gather.

All three branches of the control-variate aggregator run on these kernels:
plain CV, CVD (a noisy stream ``h`` and a clean stream ``mu``) and the
det-dropout moments ``(mu, var)``, whose variance takes the squared and the
cross edge weights.

Under data parallelism (``mesh``, parallel/mesh.py) a rank holds a row
block of every field's activations and of the history, and computes its
block of the output field.  A :class:`_HaloReader` gathers the input rows
its slots and its self rows name into a local buffer (owner-routed and
differentiable, parallel/halo.py), with the history rows of their node ids
beside them, and remaps the slot positions into that buffer; the same
kernels then run on the buffer.  The full term contracts each rank's own
history rows (:func:`full_neighborhood_mean_halo`).  Under a mesh the full
term is always the per-step, untiered one (the JAX package's choice).

The output rows of a layer are the ``[:F_out]`` prefix of its input field,
or, under the owner-aligned layout (``--owner_batching``), the input rows
at ``LayerSample.self_pos`` (sentinel rows parked there read zero rows);
on a mesh a rank's buffer then holds mostly its own rows.
"""

from __future__ import annotations

import torch

from ..data.graph import FlatGraph, flat_row_windows, graph_rows
from ..ops.cuda_spmm import (FanoutAggregate, cv_fanout_aggregate,
                             hbm_gather_aggregate)
from ..ops.gather import row_gather
from ..parallel import halo
from ..sampler.scheduler import LayerSample

# The two-tier full term engages only at fields of at least this many rows
# (a perf gate, never a semantics switch: the value is exact either way).
# The JAX package's gate is 4096, a TPU measurement.  On an NVIDIA H100
# 80GB HBM3 at 700 W (chip_smoke.py's gate sweep over fields of the
# uncapped SBM's full graph, host clock with synchronise; the numbers are
# in PERF.md) the tier loses on both layouts at 4,096 and 16,384 rows,
# where its host work (the big-row count read back, a dozen more
# launches) outweighs the device time it saves; at 65,536 it wins on
# padded rows but not on the edge list; at 131,072 it wins on both (about
# 1.1 against 2.1 ms a call padded, 1.5-1.9 against 2.4 on the edge
# list).  So the gate is the smallest swept size at which it pays on
# both layouts: full-graph passes and exhaustive fields of graphs past
# 100k nodes.  Tests and chip_smoke.py lower it.
TIER_MIN_ROWS = 131072
# Node rows per launch of the edge-list a-bar table (full_abar): bounds its
# [chunk, edge_cap_per_row] window arrays (60 MB of int64 positions and
# 30 MB each of ids and weights at 16384 rows and a budget of 456) while
# keeping the chunks few: the 5 chunks of a 65,536-node graph take about
# 1.3-1.5 ms of device time on the same card, most of it in the window
# gathers and the kernel, not in launches (chip_smoke.py; PERF.md).
ABAR_CHUNK = 16384


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


def _tiers(tier_w: int, width: int, rows: int) -> bool:
    """The JAX package's dispatch condition of the two-tier term."""
    return 0 < tier_w <= width - 8 and rows >= TIER_MIN_ROWS


def full_neighborhood_mean_halo(hist: torch.Tensor, fnbr: torch.Tensor,
                                fw: torch.Tensor, mesh) -> torch.Tensor:
    """``A_full . h_bar`` over a row-sharded history (``hist``: this rank's
    block) for this rank's ``[F/P, Dcap]`` neighbour rows: the ranks
    all-gather the rows, each contracts the slots whose history rows it
    owns with ``hbm_gather_aggregate`` over its own block (the other slots
    point past the block, which the kernel reads as dead), and a
    reduce-scatter sums the ``[F, d]`` float32 partials into each rank's
    block (parallel/halo.py::owner_routed)."""
    def contract(local, loc, mine, w_all):
        idx = torch.where(mine, loc, local.shape[0]).to(torch.int32)
        return hbm_gather_aggregate(local, idx,
                                    torch.where(mine, w_all, 0.0))
    return halo.owner_routed(hist, fnbr, (fw,), contract, mesh)


def full_neighborhood_mean(hist: torch.Tensor, graph,
                           field_out: torch.Tensor,
                           square: bool = False, mesh=None) -> torch.Tensor:
    """``(A_full . h_bar)[field_out]``, float32: padded full-row contraction,
    or on a :class:`FlatGraph` the edge-list windows.  ``square=True`` uses
    squared edge weights (the det-dropout variance term).  A graph with a
    tier split (``--fadj_tier``) runs it on fields of ``TIER_MIN_ROWS`` rows
    or more: the same value, two narrower kernel calls.  With a ``mesh``,
    ``hist`` is this rank's history block and ``field_out`` its block of
    the field: the owner-routed contraction of the same rows."""
    if mesh is not None:
        if isinstance(graph, FlatGraph):
            width = min(graph.edge_cap_per_row, graph.max_degree)
            fnbr, fw, _ = flat_row_windows(graph, field_out, width)
            fw = _apply_renorm(fw, graph, field_out)
        else:
            fnbr, fw, _ = graph_rows(graph, field_out)
        return full_neighborhood_mean_halo(
            hist, fnbr, fw.square() if square else fw, mesh)
    if isinstance(graph, FlatGraph):
        return full_neighborhood_mean_edgelist(hist, graph, field_out,
                                               square=square)
    if _tiers(graph.tier_w, graph.pad_degree, field_out.shape[0]):
        ids = field_out.to(torch.int64)
        n = graph.num_nodes

        def take(lo, hi, rows):
            # the [len(rows), hi - lo] slots of field positions ``rows``
            # (position F: the sentinel row), gathered from the column
            # range of the graph's tables (index_select of a column slice
            # is a contiguous gather, no copy of the whole rows)
            at = torch.cat([ids, ids.new_full((1,), n)]).index_select(0,
                                                                      rows)
            fw = graph.w[:, lo:hi].index_select(0, at)
            return (graph.nbr[:, lo:hi].index_select(0, at),
                    fw.square() if square else fw)

        return _tiered(hist, take, graph.deg.index_select(0, ids),
                       graph.tier_w, graph.pad_degree, graph.tier_frac)
    fnbr, fw, _ = graph_rows(graph, field_out)
    if square:
        fw = fw.square()
    return hbm_gather_aggregate(hist, fnbr, fw)


def _tiered(hist: torch.Tensor, take, fdeg: torch.Tensor, w1: int,
            width: int, frac: float) -> torch.Tensor:
    """Two-tier exact contraction over ``width`` slots a row: the first
    ``w1`` slots of every row in one kernel call, and the remaining
    ``width - w1`` slots of the rows longer than ``w1`` (``fdeg > w1``)
    compacted into a ``big_cap``-row call whose rows are added back at
    their positions.  ``take(lo, hi, positions)`` gives the contiguous
    ``[P, hi - lo]`` (neighbour, weight) slots of slot range ``[lo, hi)`` of
    the field rows at ``positions`` (position F reads an empty row).

    The JAX package picks between the compacted tail and a full-width tail
    with ``lax.cond(n_big <= big_cap)`` on the device; eager PyTorch has no
    such branch, so the big-row count is read on the host, the one host
    synchronisation of a step that tiers.  More big rows than ``big_cap``
    take the full-width tail: the value is exact for any field."""
    f = fdeg.shape[0]
    dev = fdeg.device
    everything = torch.arange(f, device=dev)
    main = hbm_gather_aggregate(hist, *take(0, w1, everything))
    big_cap = _tier_cap(f, frac)
    pos, n_big = _big_row_positions(fdeg > w1, big_cap)
    if int(n_big) > big_cap:
        return main + hbm_gather_aggregate(hist, *take(w1, width,
                                                       everything))
    tail = hbm_gather_aggregate(hist, *take(w1, width, pos.to(torch.int64)))
    scattered = torch.zeros((f + 1, main.shape[1]), dtype=main.dtype,
                            device=dev)
    scattered.index_add_(0, pos.to(torch.int64), tail)
    return main + scattered[:f]


def tiered_full_contract(hist: torch.Tensor, fnbr: torch.Tensor,
                         fw: torch.Tensor, fdeg: torch.Tensor, w1: int,
                         frac: float) -> torch.Tensor:
    """Two-tier exact contraction ``out[f] = sum_k fw[f,k] * hist[fnbr[f,k]]``
    of gathered ``[F, Dcap]`` rows (the JAX function's signature): main
    ``[F, w1]`` and compacted tail ``[big_cap, Dcap - w1]`` kernel calls
    (:func:`_tiered`), with the exact full-width fallback on overflow.
    :func:`full_neighborhood_mean` gathers the two column ranges from the
    graph's tables instead of slicing gathered rows."""
    f, dcap = fnbr.shape
    fnbr_p = torch.cat([fnbr, fnbr.new_full((1, dcap), hist.shape[0] - 1)])
    fw_p = torch.cat([fw, fw.new_zeros((1, dcap))])

    def take(lo, hi, rows):
        return (fnbr_p[:, lo:hi].index_select(0, rows),
                fw_p[:, lo:hi].index_select(0, rows))

    return _tiered(hist, take, fdeg, w1, dcap, frac)


def full_neighborhood_mean_edgelist(hist: torch.Tensor, graph: FlatGraph,
                                    field_out: torch.Tensor,
                                    square: bool = False) -> torch.Tensor:
    """``(A_full . h_bar)[field_out]`` over a flat-CSR graph: the same
    kernel over ``[F, min(edge_cap_per_row, max_degree)]`` row windows
    (:func:`flat_row_windows`) instead of max-degree rows.  Rows above the
    budget keep their first ``edge_cap_per_row`` edges, renormalised
    (``FlatGraph.renorm``); ``square`` squares the weights after that."""
    width = min(graph.edge_cap_per_row, graph.max_degree)
    if _tiers(graph.tier_w, width, field_out.shape[0]):
        return _tiered_full_edgelist(hist, graph, field_out, width, square)
    fnbr, fw, _ = flat_row_windows(graph, field_out, width)
    fw = _apply_renorm(fw, graph, field_out)
    if square:
        fw = fw.square()
    return hbm_gather_aggregate(hist, fnbr, fw)


def _apply_renorm(fw: torch.Tensor, graph: FlatGraph,
                  field: torch.Tensor) -> torch.Tensor:
    """Scale window weights of budget-truncated rows so row mass is kept
    (1.0 for the other rows); applied before any squaring."""
    if graph.renorm is None:
        return fw
    return fw * graph.renorm.index_select(0, field.to(torch.int64))[:, None]


def _big_row_positions(is_big: torch.Tensor, big_cap: int):
    """The field positions of the first ``big_cap`` flagged rows in
    ascending order, then the sentinel F, as ``[big_cap]`` int32; and the
    number of flagged rows (an int32 device scalar): a cumsum ranks the
    flagged rows and one scatter places them (the JAX package's cumsum
    lowering; its top_k lowering gives the same positions).  Rows past the
    capacity are dropped: the caller falls back to the full-width tail
    when the count exceeds it."""
    f = is_big.shape[0]
    dev = is_big.device
    n_big = is_big.sum(dtype=torch.int32)
    rank = torch.cumsum(is_big.to(torch.int32), dim=0) - 1
    slot = torch.where(is_big, torch.clamp(rank, max=big_cap), big_cap)
    pos = torch.full((big_cap + 1,), f, dtype=torch.int32, device=dev)
    pos.scatter_(0, slot.to(torch.int64),
                 torch.arange(f, dtype=torch.int32, device=dev))
    return pos[:big_cap], n_big


def _tier_cap(f: int, frac: float) -> int:
    # the smallest multiple of 8 covering f*frac rows (frac carries
    # choose_tier's safety margin), clamped to [8, f]
    return max(8, min(f, (int(f * frac) + 7) // 8 * 8))


def _tiered_full_edgelist(hist: torch.Tensor, graph: FlatGraph,
                          field_out: torch.Tensor, width: int,
                          square: bool) -> torch.Tensor:
    """Two-tier exact window contraction over a FlatGraph: ``[F, tier_w]``
    main windows and ``[big_cap, width - tier_w]`` tail windows from offset
    ``tier_w`` for the rows longer than ``tier_w``, renormalised (then
    squared) per row as the untiered windows are."""
    n = graph.num_nodes
    field_p = torch.cat([field_out.to(torch.int32),
                         field_out.new_full((1,), n).to(torch.int32)])

    def take(lo, hi, rows):
        ids = field_p.index_select(0, rows)
        nbr, w, _ = flat_row_windows(graph, ids, hi - lo, start=lo)
        w = _apply_renorm(w, graph, ids)
        return nbr, w.square() if square else w

    fdeg = graph.deg.index_select(0, field_out.to(torch.int64))
    return _tiered(hist, take, torch.clamp(fdeg, max=width), graph.tier_w,
                   width, graph.tier_frac)


def full_abar(hist: torch.Tensor, graph, num_nodes: int,
              square: bool = False, chunk: int = 0) -> torch.Tensor:
    """``A_full . h_bar`` for every node: the epoch-frozen a-bar table of
    ``--lazy_fullterm``, ``[R, d]`` float32 (R = the history's rows; rows
    N and up are zero).  ``square=True`` takes the squared weights (the
    det-dropout variance table).

    On a padded graph one kernel call over the graph's own ``[N+1, Dcap]``
    rows: the kernel never materialises the ``[rows, Dcap, d]`` gather
    that the JAX package bounds by chunking.  On a :class:`FlatGraph` the
    windows of every row do not fit at once, so they are built and
    contracted ``chunk`` rows (default ``ABAR_CHUNK``) at a time, one call
    each.  Every row equals the untiered per-step term of that row."""
    r = hist.shape[0]
    if isinstance(graph, FlatGraph):
        chunk = chunk or ABAR_CHUNK
        width = min(graph.edge_cap_per_row, graph.max_degree)
        parts = []
        for lo in range(0, num_nodes + 1, chunk):
            ids = torch.arange(lo, min(lo + chunk, num_nodes + 1),
                               dtype=torch.int32, device=hist.device)
            fnbr, fw, _ = flat_row_windows(graph, ids, width)
            fw = _apply_renorm(fw, graph, ids)
            parts.append(hbm_gather_aggregate(
                hist, fnbr, fw.square() if square else fw))
        out = torch.cat(parts)
    else:
        out = hbm_gather_aggregate(
            hist, graph.nbr, graph.w.square() if square else graph.w)
    return torch.cat([out, out.new_zeros((r - out.shape[0], out.shape[1]))])


def _anchor(history, lazy_l, j: int) -> torch.Tensor:
    """The CV anchor table of history ``j``: the live table, or the
    epoch-start snapshot under ``--lazy_fullterm`` (both CV terms read the
    same h_bar)."""
    return history[j] if lazy_l is None else lazy_l[0][j]


def _full_term(history, lazy_l, j: int, graph, field_out: torch.Tensor,
               square: bool = False, mesh=None) -> torch.Tensor:
    """``(A_full . h_bar)[field_out]``: the per-step contraction, or a row
    gather of the a-bar table under ``--lazy_fullterm``."""
    if lazy_l is None:
        return full_neighborhood_mean(history[j], graph, field_out,
                                      square=square, mesh=mesh)
    return lazy_l[1][j].index_select(0, field_out.to(torch.int64))


class _LocalReader:
    """How an aggregator reads its input field on one device: the whole
    field is here, the slots are the schedule's, the output rows are the
    input rows :func:`_self_rows` names and the history rows are those of
    the field's node ids."""

    def __init__(self, ls: LayerSample, field_in, field_out, n: int):
        self.pos, self.w, self.aw = ls.slot_pos, ls.slot_w, ls.slot_aw
        self.scales, self.field_in, self.field_out = ls.scales, field_in, \
            field_out
        self.n, self.ls = n, ls

    def rows(self, x):
        return x

    def self_rows(self, x):
        return _self_rows(x, self.ls)

    def hist_rows(self, table):
        return history_gather(table, self.field_in, self.n)

    def cv(self, x, table, base):
        return cv_fanout_aggregate(x, table, self.field_in, self.n, self.pos,
                                   self.w, base)


class _HaloReader:
    """How an aggregator reads its input field on one rank of a mesh: the
    rank holds a row block of the input field's activations and computes
    its block of the output field.  The input rows its slots and self rows
    name (each once: the live slots' positions and the output rows' input
    positions, the prefix's or ``self_pos``'s, sorted) are gathered into
    an ``[R, d]`` buffer through one :class:`~..parallel.halo.Route`, and
    the slot positions are remapped into it (dead slots park at ``R``), so
    the hand-written kernels run on the buffer unchanged.  The history
    rows of the buffer's node ids come from their owners into a buffer of
    the same rows, read by the CV kernel through an identity field of
    sentinel ``R``.  Under the owner-aligned layout the buffer's rows are
    mostly the rank's own block, so the route moves little."""

    def __init__(self, ls: LayerSample, f_in: int, mesh, field_in=None,
                 field_out=None, n: int = -1):
        lo, m = mesh.block(ls.slot_pos.shape[0])
        dev = ls.slot_pos.device
        pos = ls.slot_pos.narrow(0, lo, m)
        w = ls.slot_w.narrow(0, lo, m)
        live = (w != 0) & (pos >= 0) & (pos < f_in)
        if ls.self_pos is None:
            own = torch.arange(lo, lo + m, device=dev)
            own_live = own
        else:
            # parked (sentinel) output rows read zero rows; they stand for
            # the rank's first own input row, which keeps the buffer from
            # being empty on a rank whose rows are all sentinels
            own = ls.self_pos.narrow(0, lo, m).to(torch.int64)
            own_live = torch.where(own < f_in, own,
                                   mesh.rank * (f_in // mesh.size))
        need = torch.unique(torch.cat([pos[live].to(torch.int64),
                                       own_live]))
        r = need.shape[0]
        self.pos = torch.where(
            live, torch.searchsorted(need, pos.to(torch.int64)),
            r).to(torch.int32)
        # a parked output row's index is R (past every buffer row)
        self.self_idx = torch.searchsorted(need, own)
        self.aligned = ls.self_pos is not None
        self.w = w
        self.aw = None if ls.slot_aw is None else ls.slot_aw.narrow(0, lo, m)
        self.scales = ls.scales.narrow(0, lo, m)
        self.field_in = field_in
        self.route = halo.Route(need, f_in, mesh, count="field rows")
        self.n, self.mesh, self.need = n, mesh, need
        if field_in is not None:
            self.field_out = field_out.narrow(0, lo, m)
            self.iota = torch.arange(r, dtype=torch.int32, device=dev)
            self._hist_route = None

    def rows(self, x):
        return halo.fetch(x, self.route)

    def self_rows(self, x):
        if self.aligned:
            return row_gather(x, self.self_idx, x.shape[0])
        return x.index_select(0, self.self_idx)

    def hist_rows(self, table):
        # the buffer rows' history rows, from their owners: one route for
        # every history table of the layer (they share the row layout)
        if self._hist_route is None:
            self._hist_route = halo.Route(
                self.field_in.index_select(0, self.need),
                table.shape[0] * self.mesh.size, self.mesh, self.n,
                count="history reads")
        return halo.fetch(table, self._hist_route)

    def cv(self, x, table, base):
        return cv_fanout_aggregate(x, self.hist_rows(table), self.iota,
                                   self.iota.shape[0], self.pos, self.w,
                                   base)


def _reader(ls, field_in, field_out, n, mesh):
    if mesh is None:
        return _LocalReader(ls, field_in, field_out, n)
    return _HaloReader(ls, field_in.shape[0], mesh, field_in, field_out, n)


def ema_aggregate(inputs: torch.Tensor, ls: LayerSample,
                  field_in: torch.Tensor, history, alpha: float,
                  normalization: str):
    """EMAAggregator (gcn/layers.py:260-279), which no training script of
    the reference uses: ``Z = alpha * A_samp . H + (1 - alpha) *
    h_bar[field_out]``, and the new history is Z.  Returns (outputs,
    new_history) where new_history follows the scatter contract of
    ``scatter_histories``: rows on the input field, the output field's
    output rows (the prefix, or ``self_pos``) taking Z and the rest
    rewriting their current history rows."""
    n_out = ls.slot_pos.shape[0]
    a_hat = fanout_gather(inputs, ls.slot_pos, ls.slot_w)
    hist_rows = history[0].index_select(
        0, _self_rows(field_in, ls).to(torch.int64))
    a_nbr = a_hat * alpha + hist_rows * (1.0 - alpha)
    base = history[0].index_select(0, field_in.to(torch.int64)).to(
        a_nbr.dtype)
    if ls.self_pos is None:
        new_hist = torch.cat([a_nbr, base[n_out:]])
    else:
        # parked output rows write a spare row past the end, cut off
        c = base.shape[0]
        new_hist = torch.cat([base, base[:1]]).index_copy_(
            0, torch.clamp(ls.self_pos, max=c).to(torch.int64), a_nbr)[:c]
    return (_self_concat(normalization, _self_rows(inputs, ls), a_nbr),
            (new_hist,))


def _self_rows(x: torch.Tensor, ls: LayerSample) -> torch.Tensor:
    """The output field's rows of an input-field tensor: the ``[:F_out]``
    prefix, or under the owner-aligned layout the rows at ``self_pos``
    (parked sentinel rows read zero rows)."""
    if ls.self_pos is None:
        return x[:ls.slot_pos.shape[0]]
    return row_gather(x, ls.self_pos, x.shape[0])


def _self_concat(normalization: str, self_part: torch.Tensor,
                 nbr_part: torch.Tensor) -> torch.Tensor:
    if normalization == "gcn":
        return nbr_part
    return torch.cat((self_part, nbr_part), dim=1)


def plain_aggregate(inputs, ls: LayerSample, normalization: str,
                    mesh=None):
    """PlainAggregator: Z = A_samp . H, with the self concat under graphsage
    normalization; a ``(mu, var)`` pair takes the squared weights for the
    variance.  With a ``mesh`` the inputs are this rank's row block of the
    input field and the result its block of the output field."""
    if mesh is None:
        v = _LocalReader(ls, None, None, -1)
    else:
        first = inputs[0] if isinstance(inputs, tuple) else inputs
        v = _HaloReader(ls, first.shape[0] * mesh.size, mesh)
    if isinstance(inputs, tuple):
        mu, var = (v.rows(t) for t in inputs)
        mu_n = fanout_gather(mu, v.pos, v.w)
        var_n = fanout_gather(var, v.pos, v.w.square())
        return (_self_concat(normalization, v.self_rows(mu), mu_n),
                _self_concat(normalization, v.self_rows(var), var_n))
    x = v.rows(inputs)
    nbr = fanout_gather(x, v.pos, v.w)
    return _self_concat(normalization, v.self_rows(x), nbr)


def vr_aggregate(inputs, ls: LayerSample, field_in: torch.Tensor,
                 field_out: torch.Tensor, graph, history, cvd: bool,
                 normalization: str, lazy_l=None, mesh=None):
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
    h_bar[field_in]) + base`` is one launch of ``cv_fanout_aggregate``.

    ``lazy_l``: the epoch-frozen anchor of ``--lazy_fullterm``, ``(snapshot
    history tuple, a-bar table tuple)``: every h_bar is the snapshot's and
    every full term a row gather of a-bar (:func:`full_abar`).  ``mesh``:
    the inputs and the history are this rank's row blocks (the module
    docstring); the new history rows are the input block."""
    v = _reader(ls, field_in, field_out, graph.num_nodes, mesh)

    def full(j, square=False):
        return _full_term(history, lazy_l, j, graph, v.field_out, square,
                          mesh)

    def cv_term(x):
        return v.cv(x, _anchor(history, lazy_l, 0), full(0))

    if cvd:
        h, mu = inputs
        h_b, mu_b = v.rows(h), v.rows(mu)
        mu_n = cv_term(mu_b)
        h_n = fanout_gather(h_b - mu_b, v.pos, v.w) \
            * v.scales[:, None] + mu_n
        return (_self_concat(normalization, v.self_rows(h_b), h_n),
                _self_concat(normalization, v.self_rows(mu_b), mu_n)), (mu,)

    if isinstance(inputs, tuple):
        mu, var = inputs
        mu_b, var_b = v.rows(mu), v.rows(var)
        # the root in the history's own type, widened by the subtraction:
        # where the JAX model takes it
        sigma_bar = torch.sqrt(v.hist_rows(_anchor(history, lazy_l, 1)))
        delta_sigma = torch.sqrt(var_b) - sigma_bar
        mu_n = cv_term(mu_b)
        var_n = (fanout_gather(delta_sigma.square(), v.pos, v.w.square())
                 + full(1, square=True)
                 + 2.0 * fanout_gather(delta_sigma * sigma_bar, v.pos,
                                       v.aw))
        var_n = torch.relu(var_n) + 1e-10
        return (_self_concat(normalization, v.self_rows(mu_b), mu_n),
                _self_concat(normalization, v.self_rows(var_b), var_n)), \
            (mu, var)

    x = v.rows(inputs)
    a_neighbour = cv_term(x)
    return _self_concat(normalization, v.self_rows(x), a_neighbour), \
        (inputs,)
