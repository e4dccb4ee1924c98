"""The data-parallel mesh: which tensors a rank holds whole, which a row
block of, and the collectives over them.

Port of stochastic_gcn_tpu/parallel/mesh.py for a 1-D ``('data',)`` mesh of
processes, one per device (:mod:`.distributed`).  The JAX package states
its layout as shardings (``state_shardings``, ``data_shardings``,
``history_shardings``); here it is what each rank keeps:

* whole, the same on every rank: the params, the Adam state, the step
  counter, the Polyak average, the ``[N+1]`` degree and importance
  vectors, the epoch's batch-id matrix and every schedule (each rank draws
  the same global schedule from the same seeded generator);
* a row block: every history table (train and eval), always; and with
  ``shard_graph`` (the default, ``--shard_graph``) the padded graph's
  neighbour and weight rows (of an edge list, its tile of the block
  tables, laid out by ``flat_csr(parts=P)``), the feature table (dense or
  padded-sparse) and the labels.  Node tables are padded to
  :func:`shard_rows` rows, so rank ``q`` owns rows ``[q * n_loc, (q + 1)
  * n_loc)``, ``n_loc = shard_rows(N, P) // P``; with ``--noshard_graph``
  the graph, features and labels are whole;
* the activations of a field of ``F`` rows (a multiple of ``P``, from the
  scheduler's ``round_multiple``): rank ``q`` computes rows
  ``[q * F / P, (q + 1) * F / P)`` of every field, GSPMD's ``P('data')``.

Rows held elsewhere come through the owner-routed transports of
:mod:`.halo`.  Every collective goes through the wrappers here, which add
the bytes this rank puts on the wire to :data:`WIRE` (the collective bytes
per step that chip_smoke.py reports): an all-to-all counts the rows it
sends to other ranks, an all-gather ``(P - 1)`` copies of the local block,
a reduce-scatter and an all-reduce the ring algorithm's ``(P - 1) / P``
and ``2 (P - 1) / P`` of the tensor.

Ranks may span hosts (``--dp_hosts H``, :mod:`.distributed`): the ranks
are host-major, ``H`` hosts of ``P / H`` consecutive ranks each
(:func:`make_mesh` checks it), so each host owns a contiguous node block
of every row-sharded table.  :data:`WIRE_CROSS_HOST` holds the part of
each :data:`WIRE` count addressed to ranks on other hosts: an all-to-all's
rows sent there, and of the other collectives the share ``(P - P/H) / (P
- 1)`` that a direct exchange with every other rank would send off the
host (a count from split sizes, not a trace of the algorithm NCCL
chose).

:func:`owner_grouped_batch_matrix` lays out an epoch's batches for
``--owner_batching``: rank ``q``'s columns of every step hold ids whose
rows it owns.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# bytes this rank sent to other ranks since the last reset_wire(), by
# collective
WIRE = {"all_to_all": 0, "all_gather": 0, "reduce_scatter": 0,
        "all_reduce": 0}
# the part of each WIRE count addressed to ranks on other hosts
WIRE_CROSS_HOST = dict.fromkeys(WIRE, 0)
# rows this rank requested through owner-routed exchanges since the last
# reset_wire(), by what they read or wrote (parallel/halo.py::Route's
# ``count``): [rows it owns itself, all live rows]
ROUTED: dict = {}


def reset_wire() -> None:
    for k in WIRE:
        WIRE[k] = WIRE_CROSS_HOST[k] = 0
    ROUTED.clear()


_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``size`` ranks of the default process
    group, this process being ``rank``.  ``shard_graph``: the graph,
    features and labels are row-sharded (the histories always are).
    ``hosts``: the ranks form that many host-major groups of ``size /
    hosts``."""
    rank: int
    size: int
    shard_graph: bool = True
    hosts: int = 1

    def host(self, rank: int) -> int:
        """The host of ``rank``."""
        return rank // (self.size // self.hosts)

    def block(self, rows: int) -> tuple:
        """``(lo, n)``: this rank's rows of a ``rows``-row table or field
        (``rows`` a multiple of ``size``)."""
        if rows % self.size:
            raise ValueError(f"{rows} rows do not tile over {self.size} "
                             "ranks")
        n = rows // self.size
        return self.rank * n, n

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's row block of a whole tensor (a view)."""
        lo, n = self.block(t.shape[0])
        return t.narrow(0, lo, n)


def make_mesh(shard_graph: bool = True, hosts: int = 1) -> Mesh:
    """The mesh of the default process group (see :mod:`.distributed`).
    With ``hosts > 1`` the ranks must be host-major over a ``(hosts, size
    / hosts)`` grid: the group's size a multiple of ``hosts`` and rank
    ``r`` on host ``r // (size / hosts)``, each rank's host being the one
    its launcher gave it (:func:`.distributed.host_index`).  The check is
    collective; a rank elsewhere raises on every rank."""
    from .distributed import host_index
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    mesh = Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
                shard_graph=shard_graph, hosts=hosts)
    if hosts > 1:
        if mesh.size % hosts:
            raise ValueError(f"{mesh.size} ranks do not tile over {hosts} "
                             "hosts")
        got = [None] * mesh.size
        dist.all_gather_object(got, host_index())
        want = [mesh.host(r) for r in range(mesh.size)]
        if got != want:
            raise ValueError(f"the ranks are not host-major over {hosts} "
                             f"hosts: rank r runs on host {got}, the mesh "
                             f"needs {want}")
    return mesh


def mesh_host_shape(mesh: Mesh, hosts: int) -> tuple:
    """``(hosts, ranks per host)`` view of a host-major mesh."""
    return (hosts, mesh.size // hosts)


def row_multiple(dp: int) -> int:
    """The row multiple of node tables at data-parallel width ``dp``: the
    least common multiple of 8 and ``dp``, which is the JAX package's
    ``max(8, dp)`` for every power of two, and keeps the blocks equal at
    any other width."""
    return 8 * dp // math.gcd(8, dp)


def shard_rows(num_nodes: int, dp: int) -> int:
    """Rows of the row-sharded node tables: ``[N+1]`` padded to a multiple
    of :func:`row_multiple` (models/gcn.py::init_histories), the layout
    that defines ownership: node v is owned by rank ``v // (rows / dp)``."""
    m = row_multiple(dp)
    return -(-(num_nodes + 1) // m) * m


def owner_grouped_batch_matrix(ids, batch_size: int, num_nodes: int,
                               dp: int) -> np.ndarray:
    """``[S, B]`` epoch batch matrix for ``--owner_batching``: rank ``q``
    computes columns ``[q B/P, (q+1) B/P)`` of every step, and those
    columns take, in order, the ids whose rows rank ``q`` owns
    (:func:`shard_rows`), so the batch field's history reads and writes
    stay on the rank.  The ids an owner's columns cannot hold spill into
    the other ranks' free slots in order, so each id appears exactly once
    per epoch; the slots left over hold the sentinel ``num_nodes``.
    ``ids`` come epoch-shuffled; the grouping makes a batch an
    owner-stratified sample rather than a uniform one (the JAX package's
    documented deviation)."""
    ids = np.asarray(ids, np.int32)
    n_loc = shard_rows(num_nodes, dp) // dp
    b_loc = batch_size // dp
    s = max(1, -(-len(ids) // batch_size))
    out = np.full((s, dp, b_loc), num_nodes, np.int32)
    owner = np.minimum(ids // n_loc, dp - 1)
    spill = []
    for q in range(dp):
        mine = ids[owner == q]
        take = mine[:s * b_loc]
        spill.append(mine[s * b_loc:])
        out[:, q, :].flat[:len(take)] = take
    spill = np.concatenate(spill)
    flat = out.reshape(s * batch_size)
    free = np.flatnonzero(flat == num_nodes)
    flat[free[:len(spill)]] = spill
    return out.reshape(s, batch_size)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(kind: str, nbytes: int, mesh: Mesh) -> None:
    """Add a collective's bytes to WIRE, and their share addressed to
    other hosts to WIRE_CROSS_HOST (module docstring)."""
    WIRE[kind] += nbytes
    if mesh.hosts > 1:
        off = mesh.size - mesh.size // mesh.hosts
        WIRE_CROSS_HOST[kind] += nbytes * off // (mesh.size - 1)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    dist.all_reduce(t)
    _count("all_reduce", 2 * _nbytes(t) * (mesh.size - 1) // mesh.size, mesh)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' blocks ``t`` ([n, ...] each, one shape) stacked in rank
    order: ``[size * n, ...]``."""
    t = t.contiguous()
    out = t.new_empty((mesh.size * t.shape[0], *t.shape[1:]))
    _all_gather(out, t)
    _count("all_gather", _nbytes(t) * (mesh.size - 1), mesh)
    return out


def reduce_scatter_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` ([size * n, ...], the same shape on every rank) over the
    ranks and keep this rank's block of ``n`` rows."""
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // mesh.size, *t.shape[1:]))
    _reduce_scatter(out, t)
    _count("reduce_scatter", _nbytes(t) * (mesh.size - 1) // mesh.size,
           mesh)
    return out


def all_to_all(t: torch.Tensor, send: list, recv: list,
               mesh: Mesh) -> torch.Tensor:
    """Send rows ``t`` ([sum(send), ...], grouped by destination rank) with
    ``send[r]`` rows to rank ``r``; returns the ``sum(recv)`` rows received,
    grouped by source rank."""
    t = t.contiguous()
    out = t.new_empty((sum(recv), *t.shape[1:]))
    dist.all_to_all_single(out, t, recv, send)
    row = _nbytes(t[:1]) if t.shape[0] else 0
    WIRE["all_to_all"] += row * (sum(send) - send[mesh.rank])
    me = mesh.host(mesh.rank)
    WIRE_CROSS_HOST["all_to_all"] += row * sum(
        n for r, n in enumerate(send) if mesh.host(r) != me)
    return out


def whole(local: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole table of a row-sharded one (every rank gets it); the
    tensor itself without a mesh."""
    return local if mesh is None else all_gather_rows(local, mesh)
