"""Owner-routed access to row-sharded tables.

Port of stochastic_gcn_tpu/parallel/halo.py.  Under data parallelism every
O(N)-row table (the histories always; the graph rows, features and labels
under ``--shard_graph``) and every field's activations are row-sharded
(parallel/mesh.py).  A rank that needs rows another rank owns gets them
routed from that owner, so the bytes on the wire scale with the rows
requested, never with N:

* :func:`row_gather` / :func:`row_gather2` (and :class:`Route` for several
  tables read at one set of ids): the requests go to their owners grouped
  by owner (one ``all_to_all`` of the split sizes, one of the ids), each
  owner reads its rows locally and sends them back in the table's own
  dtype.  Ids at or above ``sentinel`` are served as zero rows without
  leaving the rank.  The gather is differentiable: the backward sends the
  gradient rows back to their owners, which sum them with ``index_add_``;
* :func:`row_scatter`: update rows go to their owners, which write them;
  sentinel ids are skipped;
* :func:`owner_routed`: the reducing form for the CV full-neighbourhood
  contraction.  The ranks all-gather their blocks of request ids (and
  weights), each contracts the rows it owns, and a reduce-scatter sums the
  float32 partials and hands each rank its block.

The JAX package sizes its exchanges statically (``scatter_cap_mult``,
``gather_cap_mult``) and falls back to the reducing form when a gather's
spill overflows; a scatter's overflow is dropped and counted.
``all_to_all_single`` takes each rank's exact split sizes, so here nothing
overflows and nothing is dropped: the capacity flags are accepted and have
no effect.  The exact splits cost one host synchronisation per exchange (the split sizes are read before the rows
move).  Nor is there the JAX package's other fallback (``halo_tiles``: a
plain GSPMD gather where a table or a field does not tile over the mesh):
node tables are padded to :func:`~.mesh.shard_rows` rows and fields to a
multiple of the ranks, and a shape that does not tile raises.
"""

from __future__ import annotations

import torch

from .mesh import (ROUTED, Mesh, all_gather_rows, all_to_all,
                   reduce_scatter_rows)


class Route:
    """One rank's requests of rows of a row-sharded table of ``rows`` rows:
    the live requests (ids below ``sentinel``; every id when ``sentinel <
    0``) grouped by owner rank, the split sizes of both directions and the
    local rows this rank serves to the others.  Building it is collective
    (every rank of the mesh builds its own at the same point); it can then
    move any number of tables with the same row ownership.  ``count``
    names the rows in ``mesh.ROUTED``, which adds the live requests this
    rank owns itself and all of them."""

    def __init__(self, ids: torch.Tensor, rows: int, mesh: Mesh,
                 sentinel: int = -1, count: str = None):
        p = mesh.size
        if rows % p:
            raise ValueError(f"{rows} rows do not tile over {p} ranks")
        flat = ids.reshape(-1).to(torch.int64)
        n_loc = rows // p
        owner = torch.div(flat, n_loc, rounding_mode="floor")
        if sentinel >= 0:
            owner = torch.where(flat < sentinel, owner, p)
        order = torch.argsort(owner, stable=True)
        counts = torch.bincount(owner, minlength=p + 1)[:p]
        ones = [1] * p
        recv = all_to_all(counts, ones, ones, mesh)
        both = torch.cat([counts, recv]).tolist()      # the host sync
        self.send, self.recv = both[:p], both[p:]
        if count:
            got = ROUTED.setdefault(count, [0, 0])
            got[0] += self.send[mesh.rank]
            got[1] += sum(self.send)
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


class _Fetch(torch.autograd.Function):
    """:meth:`Route.fetch`, differentiable in the local block."""

    @staticmethod
    def forward(ctx, local, route):
        ctx.route, ctx.shape = route, local.shape
        return route.fetch(local.reshape(local.shape[0], -1))

    @staticmethod
    def backward(ctx, g):
        grad = ctx.route.send_back(g.contiguous())
        return grad.reshape(ctx.shape), None


def fetch(local: torch.Tensor, route: Route) -> torch.Tensor:
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
    read zero rows.  Differentiable in ``local``."""
    route = Route(ids, local.shape[0] * mesh.size, mesh, sentinel)
    return fetch(local, route).reshape(*ids.shape, *local.shape[1:])


def row_gather2(local_i: torch.Tensor, local_f: torch.Tensor,
                ids: torch.Tensor, mesh: Mesh, sentinel: int = -1):
    """The same rows of an int32 and a float table of one row shape (a
    padded graph's ``nbr`` / ``w``, padded-sparse features' ``idx`` /
    ``val``) in one exchange: the int32 rows ride as float32 bit patterns
    (the transport does no arithmetic, so they arrive exact).  Not
    differentiable."""
    k = local_i.shape[1]
    both = torch.cat([local_i.view(torch.float32), local_f.float()], dim=1)
    route = Route(ids, local_i.shape[0] * mesh.size, mesh, sentinel)
    got = route.fetch(both)
    rows_i = got[:, :k].contiguous().view(torch.int32)
    rows_f = got[:, k:].to(local_f.dtype).contiguous()
    return (rows_i.reshape(*ids.shape, k),
            rows_f.reshape(*ids.shape, k))


@torch.no_grad()
def row_scatter(local: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                mesh: Mesh, sentinel: int = -1,
                count: str = None) -> torch.Tensor:
    """``table[ids] = rows`` on the row-sharded table whose block ``local``
    this rank holds, in place; ids at or above ``sentinel`` are skipped.
    Of repeated ids one write wins, which one unspecified (the no-dedup
    field layout's documented scatter semantics, training/step.py)."""
    route = Route(ids, local.shape[0] * mesh.size, mesh, sentinel, count)
    at, got = route.push(rows.reshape(route.n_req, -1))
    flat = local.view(local.shape[0], -1)
    flat.index_copy_(0, at, got.to(local.dtype))
    return local


def owner_routed(local: torch.Tensor, ids: torch.Tensor, extras,
                 partial_fn, mesh: Mesh) -> torch.Tensor:
    """The reducing owner-routed skeleton over the row-sharded table whose
    block ``local`` is: the ranks all-gather their request blocks ``ids``
    ([F/P, ...]) and ``extras``, each computes ``partial_fn(local, loc,
    mine, *extras_all) -> [F, d]`` float32 over the rows it owns (``loc``:
    the requests as local rows, ``mine``: which it owns; the others must
    contribute nothing), and one reduce-scatter sums the partials and hands
    every rank its ``[F/P, d]`` block."""
    ids_all = all_gather_rows(ids, mesh).to(torch.int64)
    ex_all = [all_gather_rows(e, mesh) for e in extras]
    n_loc = local.shape[0]
    loc = ids_all - mesh.rank * n_loc
    mine = (loc >= 0) & (loc < n_loc)
    part = partial_fn(local, loc, mine, *ex_all)
    return reduce_scatter_rows(part, mesh)
