"""The mesh: which tensors a rank holds whole, which a row block or a
column block of, and the collectives over them.

Port of stochastic_gcn_tpu/parallel/mesh.py for a ``('data',)`` mesh of
processes, one per device (:mod:`.distributed`), or with ``--tp T > 1``
the 2-D ``('data', 'model')`` mesh of ``dp x T`` processes: global rank
``r`` is data index ``r // T`` and model index ``r % T`` (the model axis
innermost, as the JAX package's grid).  :class:`Mesh`'s ``rank`` and
``size`` are the data axis's, so every row block below is one of the data
axis and every collective wrapper runs over the rank's data group (the
ranks of its model index); the model group (the ranks of its data index)
holds the column blocks of tensor parallelism (:func:`model_sum`,
:func:`gather_cols`, :func:`model_copy`).  The JAX package states
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
  ``[q * F / P, (q + 1) * F / P)`` of every field, GSPMD's ``P('data')``;
* under ``--tp T`` a column block: of every weight, layer-norm offset and
  scale (and their Adam moments and Polyak average) whose output columns
  tile over ``T``, the JAX package's ``param_sharding_rule``; of the
  activations those layers make and of the histories they feed
  (models/gcn.py::column_layout).  What does not tile stays whole on
  every model rank.

Rows held elsewhere come through the owner-routed transports of
:mod:`.halo`, whose knobs the mesh carries (``halo_exchange``,
``scatter_cap_mult``: :func:`.halo.halo_spec`).  Every collective goes
through the wrappers here, which add the bytes this rank puts on the wire
to :data:`WIRE` (the collective bytes per step that chip_smoke.py
reports): an all-to-all counts the rows it sends to other ranks (of the
equal-split one, :func:`all_to_all_equal`, its whole static buckets, live
or not), an all-gather ``(P - 1)`` copies of the local block, a
reduce-scatter and an all-reduce the ring algorithm's ``(P - 1) / P`` and
``2 (P - 1) / P`` of the tensor.  Every count is host arithmetic on
shapes or split sizes the host already holds: no counter reads the
device.

Ranks may span hosts (``--dp_hosts H``, :mod:`.distributed`): the ranks
are host-major, ``H`` hosts of ``P / H`` consecutive ranks each
(:func:`make_mesh` checks it), so each host owns a contiguous node block
of every row-sharded table.  :data:`WIRE_CROSS_HOST` holds the part of
each :data:`WIRE` count addressed to ranks on other hosts: an all-to-all's
rows sent there, and of the other collectives the share ``(P - P/H) / (P
- 1)`` that a direct exchange with every other rank would send off the
host (a count from split sizes, not a trace of the algorithm NCCL
chose).  The data axis is host-major (``dp`` a multiple of ``H``), so a
model group never spans hosts; its bytes are counted apart, under
``WIRE["model"]``, by the same rules.

:func:`owner_grouped_batch_matrix` lays out an epoch's batches for
``--owner_batching``: rank ``q``'s columns of every step hold ids whose
rows it owns.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

# bytes this rank sent to other ranks since the last reset_wire(), by
# collective over the data group; "model": every collective over the
# model group (tensor parallelism), all kinds together
WIRE = {"all_to_all": 0, "all_gather": 0, "reduce_scatter": 0,
        "all_reduce": 0, "model": 0}
# the part of each WIRE count addressed to ranks on other hosts
WIRE_CROSS_HOST = dict.fromkeys(WIRE, 0)
# rows this rank requested through owner-routed exchanges since the last
# reset_wire(), by what they read or wrote (parallel/halo.py's ``count``):
# an int64 device tensor [rows it owns itself, all live rows], added to on
# the device and read only by routed_counts()
ROUTED: dict = {}


def reset_wire() -> None:
    for k in WIRE:
        WIRE[k] = WIRE_CROSS_HOST[k] = 0
    ROUTED.clear()


def count_routed(name: str, own, live, device) -> None:
    """Add ``own`` of ``live`` routed rows (scalars on ``device``, or ints,
    which a fill kernel puts there: no copy) to ``ROUTED[name]``."""
    def scalar(x):
        return x.to(torch.int64) if torch.is_tensor(x) else torch.full(
            (), x, dtype=torch.int64, device=device)
    got = torch.stack([scalar(own), scalar(live)])
    ROUTED[name] = got if name not in ROUTED else ROUTED[name] + got


def routed_counts() -> dict:
    """``ROUTED`` read to the host: ``{name: [own, live]}`` (one device
    read for each name; call it where the counts are reported)."""
    return {k: [int(x) for x in v.tolist()] for k, v in ROUTED.items()}


_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclass(frozen=True)
class Mesh:
    """The mesh of this process: data index ``rank`` of ``size`` (the data
    axis, over which every row block is taken) and model index
    ``model_rank`` of ``model_size`` (``--tp``; 1 without tensor
    parallelism).  ``data_group`` / ``model_group``: the process groups of
    the ranks that share this rank's model index / data index (None: the
    default group, and no model group at ``model_size`` 1).
    ``shard_graph``: the graph, features and labels are row-sharded (the
    histories always are).  ``hosts``: the data axis forms that many
    host-major groups of ``size / hosts``."""
    rank: int
    size: int
    shard_graph: bool = True
    hosts: int = 1
    model_rank: int = 0
    model_size: int = 1
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)
    # the history scatter's transport (parallel/halo.py::halo_spec): static
    # capacity (True) or exact splits (False, --halo_exchange false), and
    # the capacity multiplier (the JAX package's default, 2.0)
    halo_exchange: bool = True
    scatter_cap_mult: float = 2.0

    @property
    def global_rank(self) -> int:
        """This rank in the default group: ``rank * model_size +
        model_rank``."""
        return self.rank * self.model_size + self.model_rank

    def host(self, rank: int) -> int:
        """The host of data index ``rank``."""
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


def tensor_parallel(mesh: Optional[Mesh]) -> bool:
    """A mesh with a model axis (``--tp > 1``)."""
    return mesh is not None and mesh.model_size > 1


# the data and model groups of a (default group, tp): built once, since
# every rank must create every group, in the same order, at the same point
_GROUPS: dict = {}


def _groups(tp: int) -> tuple:
    """``(data groups, model groups)`` of the default group at model width
    ``tp``: data group ``m`` holds the global ranks ``d * tp + m``, model
    group ``d`` the ranks ``d * tp + m`` (every rank creates all of them,
    in this order)."""
    key = (id(dist.group.WORLD), tp)
    if key not in _GROUPS:
        world = dist.get_world_size()
        dp = world // tp
        data = [dist.new_group([d * tp + m for d in range(dp)])
                for m in range(tp)]
        model = [dist.new_group([d * tp + m for m in range(tp)])
                 for d in range(dp)]
        _GROUPS[key] = (data, model)
    return _GROUPS[key]


def make_mesh(shard_graph: bool = True, hosts: int = 1,
              tp: int = 1) -> Mesh:
    """The mesh of the default process group (see :mod:`.distributed`):
    ``size = world / tp`` data indices of ``tp`` model ranks each, global
    rank ``r`` at data index ``r // tp``, model index ``r % tp``.  With
    ``hosts > 1`` the data axis must be host-major over a ``(hosts, size /
    hosts, tp)`` grid: ``size`` a multiple of ``hosts`` and global rank
    ``r`` on host ``(r // tp) // (size / hosts)``, each rank's host being
    the one its launcher gave it (:func:`.distributed.host_index`), so a
    model group never spans hosts.  The check is collective; a rank
    elsewhere raises on every rank."""
    from .distributed import host_index
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    world, me = dist.get_world_size(), dist.get_rank()
    if tp < 1 or world % tp:
        raise ValueError(f"{world} ranks do not tile over --tp {tp}")
    kw = {}
    if tp > 1:
        data, model = _groups(tp)
        kw = dict(model_rank=me % tp, model_size=tp,
                  data_group=data[me % tp], model_group=model[me // tp])
    mesh = Mesh(rank=me // tp, size=world // tp, shard_graph=shard_graph,
                hosts=hosts, **kw)
    if hosts > 1:
        if mesh.size % hosts:
            raise ValueError(f"{mesh.size} data ranks do not tile over "
                             f"{hosts} hosts")
        got = [None] * world
        dist.all_gather_object(got, host_index())
        want = [mesh.host(r // tp) for r in range(world)]
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
    """Add a data-group collective's bytes to WIRE, and their share
    addressed to other hosts to WIRE_CROSS_HOST (module docstring)."""
    WIRE[kind] += nbytes
    if mesh.hosts > 1:
        off = mesh.size - mesh.size // mesh.hosts
        WIRE_CROSS_HOST[kind] += nbytes * off // (mesh.size - 1)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the data ranks, in place; returns it."""
    dist.all_reduce(t, group=mesh.data_group)
    _count("all_reduce", 2 * _nbytes(t) * (mesh.size - 1) // mesh.size, mesh)
    return t


def all_reduce_max(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The largest ``t`` over the data ranks, in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.data_group)
    _count("all_reduce", 2 * _nbytes(t) * (mesh.size - 1) // mesh.size, mesh)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data ranks' blocks ``t`` ([n, ...] each, one shape) stacked in
    rank order: ``[size * n, ...]``."""
    t = t.contiguous()
    out = t.new_empty((mesh.size * t.shape[0], *t.shape[1:]))
    _all_gather(out, t, group=mesh.data_group)
    _count("all_gather", _nbytes(t) * (mesh.size - 1), mesh)
    return out


def reduce_scatter_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` ([size * n, ...], the same shape on every data rank) over
    the data ranks and keep this rank's block of ``n`` rows."""
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // mesh.size, *t.shape[1:]))
    _reduce_scatter(out, t, group=mesh.data_group)
    _count("reduce_scatter", _nbytes(t) * (mesh.size - 1) // mesh.size,
           mesh)
    return out


def all_to_all(t: torch.Tensor, send: list, recv: list,
               mesh: Mesh) -> torch.Tensor:
    """Send rows ``t`` ([sum(send), ...], grouped by destination data rank)
    with ``send[r]`` rows to data rank ``r``; returns the ``sum(recv)`` rows
    received, grouped by source rank."""
    t = t.contiguous()
    out = t.new_empty((sum(recv), *t.shape[1:]))
    dist.all_to_all_single(out, t, recv, send, group=mesh.data_group)
    row = _nbytes(t[:1]) if t.shape[0] else 0
    WIRE["all_to_all"] += row * (sum(send) - send[mesh.rank])
    me = mesh.host(mesh.rank)
    WIRE_CROSS_HOST["all_to_all"] += row * sum(
        n for r, n in enumerate(send) if mesh.host(r) != me)
    return out


def all_to_all_equal(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Send block ``r`` of ``t`` ([size, cap, ...], a static bucket for each
    data rank) to data rank ``r``; returns the ``[size, cap, ...]`` blocks
    received, by source rank.  Equal splits: no split sizes, so nothing is
    read on the host.  Counts every bucket sent to another rank, live rows
    or not."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.data_group)
    per = _nbytes(t) // mesh.size
    WIRE["all_to_all"] += per * (mesh.size - 1)
    me = mesh.host(mesh.rank)
    WIRE_CROSS_HOST["all_to_all"] += per * sum(
        1 for r in range(mesh.size) if mesh.host(r) != me)
    return out


# ----------------------- the model group (--tp) ----------------------------

class Cols:
    """The columns each model rank holds of a column-sharded tensor of
    ``width`` columns: ``index[m]`` are model rank ``m``'s, in its local
    order (``[T, width / T]``).  A dense layer's output is a contiguous
    block a rank (:meth:`block`); the graphsage concat ``[self ‖ agg]`` of
    two tensors of one layout holds two disjoint ranges a rank
    (:meth:`concat`)."""

    def __init__(self, index: np.ndarray):
        self.index = np.asarray(index, np.int64)
        self.width = self.index.size
        self._cache: dict = {}

    @staticmethod
    def block(width: int, tp: int) -> "Cols":
        return Cols(np.arange(width).reshape(tp, width // tp))

    def concat(self) -> "Cols":
        """The layout of ``[x ‖ y]`` for ``x`` and ``y`` of this one."""
        return Cols(np.concatenate([self.index, self.index + self.width],
                                   axis=1))

    def contiguous(self) -> bool:
        """Rank ``m`` holds the ``m``-th block of columns."""
        return bool((self.index.reshape(-1) == np.arange(self.width)).all())

    def _tensor(self, key, device, make) -> torch.Tensor:
        # an index array as a tensor on ``device``, made once
        key = (key, str(device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(make(), device=device)
        return self._cache[key]

    def own(self, mesh: Mesh, device) -> torch.Tensor:
        """This rank's columns, as an index tensor on ``device``."""
        return self._tensor(mesh.model_rank, device,
                            lambda: self.index[mesh.model_rank])

    def order(self, device) -> torch.Tensor:
        """The global column of each column of the ranks' blocks side by
        side."""
        return self._tensor("order", device, lambda: self.index.reshape(-1))

    def inverse(self, device) -> torch.Tensor:
        """The inverse permutation of :meth:`order`."""
        return self._tensor("inverse", device,
                            lambda: np.argsort(self.index.reshape(-1)))

    def take(self, whole_t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """This rank's columns of a whole ``[rows, width]`` tensor."""
        if self.contiguous():
            w = self.width // mesh.model_size
            return whole_t.narrow(1, mesh.model_rank * w, w)
        return whole_t.index_select(1, self.own(mesh, whole_t.device))


def _model_all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=mesh.model_group)
    tp = mesh.model_size
    WIRE["model"] += 2 * _nbytes(t) * (tp - 1) // tp
    return t


def _gather_cols(t: torch.Tensor, cols: Cols, mesh: Mesh) -> torch.Tensor:
    """The whole ``[rows, width]`` tensor of the model ranks' column blocks
    ``t`` ([rows, width / T] each), columns in global order."""
    t = t.contiguous()
    tp, rows, w = mesh.model_size, t.shape[0], t.shape[1]
    buf = t.new_empty((tp * rows, w))
    _all_gather(buf, t, group=mesh.model_group)
    WIRE["model"] += _nbytes(t) * (tp - 1)
    out = buf.view(tp, rows, w).permute(1, 0, 2).reshape(rows, tp * w)
    if cols.contiguous():
        return out
    return out.index_select(1, cols.inverse(t.device))


def _scatter_cols(g: torch.Tensor, cols: Cols, mesh: Mesh) -> torch.Tensor:
    """The transpose of :func:`_gather_cols` summed over the model ranks:
    each rank's partial ``[rows, width]`` gradients reduced, and this
    rank's columns kept."""
    tp, rows = mesh.model_size, g.shape[0]
    if not cols.contiguous():
        g = g.index_select(1, cols.order(g.device))
    w = g.shape[1] // tp
    parts = g.reshape(rows, tp, w).permute(1, 0, 2).contiguous()
    out = g.new_empty((rows, w))
    _reduce_scatter(out, parts.view(tp * rows, w), group=mesh.model_group)
    WIRE["model"] += _nbytes(parts) * (tp - 1) // tp
    return out


class _ModelSum(torch.autograd.Function):
    """A sum over the model group whose every rank then uses the sum: the
    gradient of each rank's addend is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _model_all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g, ctx.mesh), None


class _ModelCopy(torch.autograd.Function):
    """A whole tensor feeding a column-sharded layer: the identity, and its
    gradient (each rank's partial, through its columns only) summed over
    the model group."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g, ctx.mesh), None


class _GatherCols(torch.autograd.Function):
    """:func:`_gather_cols`; the backward reduce-scatters (``scatter``:
    the whole tensor feeds a column-sharded layer, so each rank holds a
    partial gradient) or takes this rank's columns (the whole tensor feeds
    a replicated layer, whose gradient every rank computes whole)."""

    @staticmethod
    def forward(ctx, t, cols, mesh, scatter):
        ctx.cols, ctx.mesh, ctx.scatter = cols, mesh, scatter
        return _gather_cols(t, cols, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            return _scatter_cols(g, ctx.cols, ctx.mesh), None, None, None
        return ctx.cols.take(g, ctx.mesh).contiguous(), None, None, None


def _tracked(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def model_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the model group (a new tensor); differentiable:
    the backward is the same sum."""
    if _tracked(t):
        return _ModelSum.apply(t, mesh)
    return _model_all_reduce(t, mesh)


def model_copy(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` (whole on every model rank) as the input of a column-sharded
    layer: the identity forward, the gradient summed over the model
    group."""
    return _ModelCopy.apply(t, mesh) if _tracked(t) else t


def gather_cols(t: torch.Tensor, cols: Cols, mesh: Mesh,
                scatter: bool = True) -> torch.Tensor:
    """The whole tensor of column blocks ``t`` of layout ``cols``.
    Differentiable: with ``scatter`` (the whole tensor feeds a
    column-sharded dense) the backward is a reduce-scatter over the model
    group; without (it feeds a layer every model rank computes whole) the
    backward keeps this rank's columns and sends nothing."""
    if _tracked(t):
        return _GatherCols.apply(t, cols, mesh, scatter)
    return _gather_cols(t, cols, mesh)


def whole(local: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole table of a row-sharded one (every rank gets it); the
    tensor itself without a mesh."""
    return local if mesh is None else all_gather_rows(local, mesh)
