"""Owner-routed access to row-sharded tables.

Port of stochastic_gcn_tpu/parallel/halo.py.  Under data parallelism every
O(N)-row table (the histories always; the graph rows, features and labels
under ``--shard_graph``) and every field's activations are row-sharded
(parallel/mesh.py).  A rank that needs rows another rank owns gets them
routed from that owner, so the bytes on the wire scale with the rows
requested, never with N.

* **world 1** (a data group of one rank, JAX ``halo_tiles``): the rank
  holds the whole table, so a gather is a local ``index_select`` with the
  sentinel rows zeroed and a scatter a local ``index_copy_``.  No
  collective, no host read.
* **gathers** (:func:`route`, for one table or several read at one set of
  ids; :func:`row_gather`, :func:`row_gather2`): the live requests go to
  their owners grouped by owner, with one ``all_to_all`` of the split
  sizes read on the host before the rows move, and come back in the
  table's own dtype.  A route moves any number of tables of the same row
  ownership (:meth:`~ExactRoute.fetch`, and its transpose
  :meth:`~ExactRoute.send_back` for the gradient; :meth:`~ExactRoute.push`
  sends rows the other way).  Ids at or above ``sentinel`` read zero rows
  without leaving the rank.  JAX sizes its gathers statically
  (``gather_cap_mult``) and falls back to an exact form on overflow, so
  its rows are exact either way, as these are: the flag is accepted and
  has no effect.  (Static gather buckets, with that fallback decided by a
  host read of the all-reduced overflow, cut the host syncs but were
  slower on every data-parallel arm on four H100s; PERF.md.)
* **scatters** (:func:`row_scatter`; the mesh's ``halo_exchange`` and
  ``scatter_cap_mult``, from :func:`halo_spec`): JAX's static capacity.
  A rank writes the rows it owns itself locally, outside any capacity,
  and ids at or above the sentinel take no slot.  The remote writes are
  ordered by owner with a stable sort (JAX's ``argsort``, so the same rank
  slice keeps the same rows) and packed into ``[P, cap]`` buckets, ``cap
  = scatter_capacity(P * c, P, scatter_cap_mult)`` for ``c`` writes a
  rank, which move in equal-split ``all_to_all``s: no split sizes, so
  nothing is read on the host.  What the buckets cannot hold is dropped:
  those history rows stay one step staler, which the CV estimator
  tolerates by construction.  The count, all-reduced over the data group,
  stays on the device (the step's ``hist_dropped``).  With
  ``halo_exchange`` off (``--halo_exchange false``, JAX's exact GSPMD
  lowering) the writes take exact splits and nothing is dropped.

:func:`owner_routed` is the reducing form for the CV full-neighbourhood
contraction: the ranks all-gather their blocks of request ids (and
weights), each contracts the rows it owns, and a reduce-scatter sums the
float32 partials and hands each rank its block.

Node tables are padded to :func:`~.mesh.shard_rows` rows and fields to a
multiple of the ranks, so every table and field tiles over the mesh (a
shape that does not raises): JAX's other ``halo_tiles`` fallback, a plain
GSPMD gather of a table that does not tile, has no counterpart.
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import (Mesh, all_gather_rows, all_reduce_sum, all_to_all,
                   all_to_all_equal, count_routed, reduce_scatter_rows)


def scatter_capacity(c: int, p: int, cap_mult: float) -> int:
    """The static per-destination row budget of an exchange of ``c``
    requests over ``p`` ranks (``c / p`` a rank): JAX's integer arithmetic,
    ``min(c/p, max(8, ceil(int(cap_mult * c/p) / p)))``.  Shuffled
    requests expect ``c / p^2`` a destination; ``cap_mult >= p`` (or the
    ``c/p`` clamp) can drop nothing."""
    c_loc = c // p
    return int(min(c_loc, max(8, -(-int(cap_mult * c_loc) // p))))


def halo_spec(cfg, mesh):
    """``mesh`` with the halo transport of ``cfg`` (``--halo_exchange``,
    ``--scatter_cap_mult``); None stays None."""
    if mesh is None:
        return None
    return dataclasses.replace(mesh, halo_exchange=cfg.halo_exchange,
                               scatter_cap_mult=cfg.scatter_cap_mult)


def _write_rows(t: torch.Tensor, at: torch.Tensor, src: torch.Tensor,
                keep: torch.Tensor) -> None:
    """``t[at[i]] = src[i]`` for every ``i`` with ``keep[i]``, in place and
    with no host read (a boolean selection would read its count): the
    entries not kept write what the first kept entry writes, where it
    writes it, and with none kept, row 0's own value back to row 0."""
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    some = keep.any()
    at0 = torch.where(some, at.index_select(0, first), 0)
    src0 = torch.where(some, src.index_select(0, first), t[:1])
    t.index_copy_(0, torch.where(keep, at, at0),
                  torch.where(keep[:, None], src, src0))


def _flat(ids: torch.Tensor, sentinel: int):
    """``(ids as int64 [n], live mask or None)``: ids at or above
    ``sentinel`` are dead (every id is live when ``sentinel < 0``)."""
    flat = ids.reshape(-1).to(torch.int64)
    return flat, (flat < sentinel if sentinel >= 0 else None)


def _tiles(rows: int, mesh: Mesh) -> int:
    if rows % mesh.size:
        raise ValueError(f"{rows} rows do not tile over {mesh.size} ranks")
    return rows // mesh.size


class LocalRoute:
    """World 1: the requests of the whole table this rank holds (module
    docstring)."""

    def __init__(self, ids: torch.Tensor, rows: int, mesh: Mesh,
                 sentinel: int = -1, count: str = None):
        flat, self.live = _flat(ids, sentinel)
        self.n_req, self.n_loc = flat.shape[0], _tiles(rows, mesh)
        self.at = flat if self.live is None else torch.where(self.live,
                                                             flat, 0)
        self.back = flat if self.live is None else torch.where(
            self.live, flat, self.n_loc)
        if count:
            live = flat.shape[0] if self.live is None else self.live.sum()
            count_routed(count, live, live, flat.device)

    def fetch(self, local: torch.Tensor) -> torch.Tensor:
        rows = local.index_select(0, self.at)
        return rows if self.live is None else rows.masked_fill(
            ~self.live[:, None], 0)

    def send_back(self, g: torch.Tensor) -> torch.Tensor:
        out = g.new_zeros((self.n_loc + 1, g.shape[1]))
        return out.index_add_(0, self.back, g)[:self.n_loc]


class _Buckets:
    """One rank's live writes to a row-sharded table of ``n_loc`` rows a
    rank grouped into static ``[P, cap]`` buckets by owner (JAX
    ``row_scatter``'s bucketing): the rows it owns itself (``mine``, at
    local row ``self_loc``) and dead ids are parked past every destination
    and take no slot; the rest, in a stable owner order, fill their
    owner's bucket.  ``pos`` is each slot's write (``n`` for an empty
    slot), ``send_loc`` its local row at the owner (``n_loc`` for an empty
    slot), ``overflow`` the writes no bucket holds (a device scalar)."""

    def __init__(self, flat: torch.Tensor, live, n_loc: int, mesh: Mesh,
                 cap: int):
        p, me, n = mesh.size, mesh.rank, flat.shape[0]
        dev = flat.device
        owner = torch.div(flat, n_loc, rounding_mode="floor")
        self.mine = owner == me if live is None else live & (owner == me)
        parked = self.mine if live is None else self.mine | ~live
        owner_r = torch.where(parked, p, owner)
        order = torch.argsort(owner_r, stable=True)
        so = owner_r.index_select(0, order)
        dests = torch.arange(p, dtype=so.dtype, device=dev)
        starts = torch.searchsorted(so, dests)
        ends = torch.searchsorted(so, dests, right=True)
        slot = starts[:, None] + torch.arange(cap, device=dev)[None, :]
        valid = (slot < ends[:, None]).reshape(-1)
        self.pos = torch.cat([order, order.new_full((1,), n)]).index_select(
            0, torch.where(valid, slot.reshape(-1), n))
        dest = torch.arange(p, device=dev).repeat_interleave(cap)
        req = torch.cat([flat, flat.new_zeros(1)]).index_select(0, self.pos)
        self.send_loc = torch.where(valid, req - dest * n_loc, n_loc).to(
            torch.int32).reshape(p, cap)
        self.self_loc = torch.where(self.mine, flat - me * n_loc, n_loc)
        self.overflow = (ends - starts - cap).clamp(min=0).sum()
        self.live_rows = n if live is None else live.sum()


class ExactRoute:
    """One rank's requests of rows of a row-sharded table of ``rows`` rows
    in exact splits: the live requests (ids below ``sentinel``; every id
    when ``sentinel < 0``) grouped by owner rank, the split sizes of both
    directions (read on the host) and the local rows this rank serves to
    the others.  Building it is collective (every rank of the mesh builds
    its own at the same point).  ``count`` names the rows in
    ``mesh.ROUTED`` (the live requests this rank owns itself, and all of
    them)."""

    def __init__(self, ids: torch.Tensor, rows: int, mesh: Mesh,
                 sentinel: int = -1, count: str = None):
        p = mesh.size
        n_loc = _tiles(rows, mesh)
        flat, live = _flat(ids, sentinel)
        owner = torch.div(flat, n_loc, rounding_mode="floor")
        if live is not None:
            owner = torch.where(live, owner, p)
        order = torch.argsort(owner, stable=True)
        counts = torch.bincount(owner, minlength=p + 1)[:p]
        ones = [1] * p
        recv = all_to_all(counts, ones, ones, mesh)
        both = torch.cat([counts, recv]).tolist()      # the host sync
        self.send, self.recv = both[:p], both[p:]
        if count:
            count_routed(count, self.send[mesh.rank], sum(self.send),
                         flat.device)
        self.order = order[:sum(self.send)]
        owned = owner.index_select(0, self.order)
        loc = (flat.index_select(0, self.order) - owned * n_loc).to(
            torch.int32)
        self.served = all_to_all(loc, self.send, self.recv,
                                 mesh).to(torch.int64)
        self.mesh, self.n_req, self.n_loc = mesh, flat.shape[0], n_loc

    def fetch(self, local: torch.Tensor) -> torch.Tensor:
        """``[n_req, d]`` rows of the table whose block ``local`` ([n_loc,
        d]) this rank holds; dead requests read zero rows."""
        rows = local.index_select(0, self.served)
        back = all_to_all(rows, self.recv, self.send, self.mesh)
        out = local.new_zeros((self.n_req, local.shape[1]))
        return out.index_copy_(0, self.order, back)

    def send_back(self, g: torch.Tensor) -> torch.Tensor:
        """The transpose of :meth:`fetch`: request rows ``g`` ([n_req, d])
        summed into the ``[n_loc, d]`` rows of their owners."""
        got = all_to_all(g.index_select(0, self.order), self.send,
                         self.recv, self.mesh)
        out = g.new_zeros((self.n_loc, g.shape[1]))
        return out.index_add_(0, self.served, got)

    def push(self, rows: torch.Tensor):
        """Send request rows ``rows`` ([n_req, d]) to their owners:
        ``(local row, row)`` pairs of what this rank received."""
        return self.served, all_to_all(rows.index_select(0, self.order),
                                       self.send, self.recv, self.mesh)


def route(ids: torch.Tensor, rows: int, mesh: Mesh, sentinel: int = -1,
          count: str = None):
    """The route of this rank's requests ``ids`` (any shape, read flat) of
    a row-sharded table of ``rows`` rows; ids at or above ``sentinel``
    (when it is >= 0) read zero rows.  Collective: every rank of the data
    group calls it at the same point.  A local one at world 1, exact
    splits otherwise (module docstring)."""
    if mesh.size == 1:
        return LocalRoute(ids, rows, mesh, sentinel, count)
    return ExactRoute(ids, rows, mesh, sentinel, count)


class _Fetch(torch.autograd.Function):
    """A route's ``fetch``, differentiable in the local block: the
    backward is the transpose of the transport that ran."""

    @staticmethod
    def forward(ctx, local, route):
        ctx.route, ctx.shape = route, local.shape
        return route.fetch(local.reshape(local.shape[0], -1))

    @staticmethod
    def backward(ctx, g):
        grad = ctx.route.send_back(g.contiguous())
        return grad.reshape(ctx.shape), None


def fetch(local: torch.Tensor, route) -> torch.Tensor:
    """The route's rows of the table whose block ``local`` is (``[n_req,
    ...]``), differentiable in ``local``."""
    if torch.is_grad_enabled() and local.requires_grad:
        out = _Fetch.apply(local, route)
    else:
        out = route.fetch(local.reshape(local.shape[0], -1))
    return out.reshape(route.n_req, *local.shape[1:])


def row_gather(local: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
               sentinel: int = -1) -> torch.Tensor:
    """``table[ids]`` of the row-sharded table whose block ``local`` this
    rank holds, dtype kept; ids at or above ``sentinel`` (when it is >= 0)
    read zero rows.  Every rank requests as many ids.  Differentiable in
    ``local``."""
    r = route(ids, local.shape[0] * mesh.size, mesh, sentinel)
    return fetch(local, r).reshape(*ids.shape, *local.shape[1:])


def row_gather2(local_i: torch.Tensor, local_f: torch.Tensor,
                ids: torch.Tensor, mesh: Mesh, sentinel: int = -1,
                local_e: torch.Tensor = None):
    """The same rows of an int32 and a float table of one row shape (a
    padded graph's ``nbr`` / ``w``, padded-sparse features' ``idx`` /
    ``val``) in one exchange; with ``local_e``, an int32 ``[rows]`` column
    of the same table (padded-sparse features' ``ends``) rides in the same
    rows, one more 4-byte column, and its entries come back third.  The
    int32 rows ride as float32 bit patterns: the transport only moves rows
    and adds nothing, so they arrive exact.  (JAX value-casts them because
    its gather's fallback sums, and a flush-to-zero sum would lose the
    denormals small ids bit-cast to.)  Not differentiable."""
    k = local_i.shape[1]
    cols = [local_i.view(torch.float32), local_f.float()]
    if local_e is not None:
        cols.append(local_e.view(torch.float32).reshape(-1, 1))
    both = torch.cat(cols, dim=1)
    r = route(ids, local_i.shape[0] * mesh.size, mesh, sentinel)
    got = r.fetch(both)
    rows_i = got[:, :k].contiguous().view(torch.int32)
    rows_f = got[:, k:2 * k].to(local_f.dtype).contiguous()
    out = (rows_i.reshape(*ids.shape, k), rows_f.reshape(*ids.shape, k))
    if local_e is None:
        return out
    rows_e = got[:, 2 * k].contiguous().view(torch.int32)
    return (*out, rows_e.reshape(ids.shape))


@torch.no_grad()
def row_scatter(local: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                mesh: Mesh, sentinel: int = -1, count: str = None):
    """``table[ids] = rows`` on the row-sharded table whose block ``local``
    this rank holds, in place; ids at or above ``sentinel`` are skipped.
    Every rank writes as many ids.  Returns ``(local, dropped)``:
    ``dropped`` (an int32 device scalar, the same on every rank) counts
    the remote writes the ``[P, cap]`` buckets could not hold, ``cap =
    scatter_capacity(P * n, P, mesh.scatter_cap_mult)``; those rows keep
    their value.
    The rows this rank owns are written first, locally and outside the
    capacity, then the rows the others sent.  At world 1, or with
    ``mesh.halo_exchange`` off (exact splits), nothing is dropped.  No
    host read, except the exact splits' split sizes.  Of repeated ids one
    write wins, which one unspecified (the no-dedup field layout's
    documented scatter semantics, training/step.py)."""
    flat_t = local.view(local.shape[0], -1)
    src = rows.reshape(ids.numel(), -1).to(local.dtype)
    dropped = torch.zeros((), dtype=torch.int32, device=local.device)
    if ids.numel() == 0:
        return local, dropped
    if mesh.size == 1:
        flat, live = _flat(ids, sentinel)
        if live is None:
            flat_t.index_copy_(0, flat, src)
        else:
            _write_rows(flat_t, flat, src, live)
        if count:
            n_live = flat.shape[0] if live is None else live.sum()
            count_routed(count, n_live, n_live, flat.device)
        return local, dropped
    n_loc = _tiles(local.shape[0] * mesh.size, mesh)
    if not mesh.halo_exchange:
        at, got = ExactRoute(ids, local.shape[0] * mesh.size, mesh,
                             sentinel, count).push(src)
        flat_t.index_copy_(0, at, got)
        return local, dropped
    flat, live = _flat(ids, sentinel)
    p = mesh.size
    cap = scatter_capacity(flat.shape[0] * p, p, mesh.scatter_cap_mult)
    b = _Buckets(flat, live, n_loc, mesh, cap)
    _write_rows(flat_t, b.self_loc, src, b.mine)
    d = src.shape[1]
    send = torch.cat([src, src.new_zeros((1, d))]).index_select(0, b.pos)
    got = all_to_all_equal(send.reshape(p, cap, d), mesh).reshape(-1, d)
    at = all_to_all_equal(b.send_loc, mesh).reshape(-1).to(torch.int64)
    _write_rows(flat_t, at, got, at < n_loc)
    if count:
        count_routed(count, b.mine.sum(), b.live_rows, flat.device)
    return local, all_reduce_sum(b.overflow.to(torch.int32), mesh)


def owner_routed(local: torch.Tensor, ids: torch.Tensor, extras,
                 partial_fn, mesh: Mesh) -> torch.Tensor:
    """The reducing owner-routed skeleton over the row-sharded table whose
    block ``local`` is: the ranks all-gather their request blocks ``ids``
    ([F/P, ...]) and ``extras``, each computes ``partial_fn(local, loc,
    mine, *extras_all) -> [F, d]`` float32 over the rows it owns (``loc``:
    the requests as local rows, ``mine``: which it owns; the others must
    contribute nothing), and one reduce-scatter sums the partials and hands
    every rank its ``[F/P, d]`` block.  At world 1 the rank's own requests
    are the whole and its partial the sum: no collective."""
    if mesh.size == 1:
        ids_all, ex_all = ids.to(torch.int64), list(extras)
    else:
        ids_all = all_gather_rows(ids, mesh).to(torch.int64)
        ex_all = [all_gather_rows(e, mesh) for e in extras]
    n_loc = local.shape[0]
    loc = ids_all - mesh.rank * n_loc
    mine = (loc >= 0) & (loc < n_loc)
    part = partial_fn(local, loc, mine, *ex_all)
    return part if mesh.size == 1 else reduce_scatter_rows(part, mesh)
