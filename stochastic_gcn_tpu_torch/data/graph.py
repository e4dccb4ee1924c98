"""Device-resident graph containers.

Port of stochastic_gcn_tpu/data/graph.py.  The graph lives on the device
in one of two layouts, filled on the host with numpy:
static-shape ``[N+1, Dcap]`` rows (:class:`PaddedGraph`; row ``N`` is an
empty sentinel row), or block-aligned flat CSR (:class:`FlatGraph`, the
edge-list layout for power-law graphs, O(E) storage).  :func:`graph_rows`
gives either one's ``[F, Dcap]`` rows of a field.  Sparse features live on
the device the same way, as ``[N+1, nnz_cap]`` (column, value) slots
(:class:`PaddedSparseFeatures`).  Under data parallelism either layout may
be node-sharded, a rank holding a block of the padded rows
(:func:`shard_graph_rows`) or a tile of the edge list's blocks
(:func:`shard_flat_graph`); the rows it reads come from their owners.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import ClassVar, Optional

import numpy as np
import scipy.sparse as sp
import torch


@dataclass(frozen=True)
class PaddedGraph:
    """Static-shape padded adjacency.

    Attributes:
      nbr:  [N+1, Dcap] int32 neighbor ids; empty slots hold N (sentinel).
      w:    [N+1, Dcap] float32 normalized edge weights; empty slots hold 0.
      deg:  [N+1] int32 true (possibly capped) degree per row; deg[N] = 0.
      tier_w, tier_frac: the two-tier split :func:`choose_tier` picked
        (-1 = off) for the CV full-neighbourhood term
        (models/aggregators.py::tiered_full_contract).
      mesh: the data-parallel mesh of a row-sharded graph
        (:func:`shard_graph_rows`), whose ``nbr`` and ``w`` hold this rank's
        block of the row-padded tables (``deg`` stays whole); None for a
        whole graph.
    """
    nbr: torch.Tensor
    w: torch.Tensor
    deg: torch.Tensor
    tier_w: int = -1
    tier_frac: float = 0.0
    mesh: Optional[object] = None

    @property
    def num_nodes(self) -> int:
        return self.deg.shape[0] - 1

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def pad_degree(self) -> int:
        return self.nbr.shape[1]


def choose_tier(deg: np.ndarray, dcap: int, safety: float = 4.0,
                force_w: int = 0):
    """Pick the two-tier split (tier_w, tier_frac) for a degree sequence:
    minimizes ``w1 + safety * p_big(w1) * (dcap - w1)`` over w1 in
    multiples of 8; (-1, 0.0) when the predicted saving is below 10%.
    ``force_w > 0`` only sizes the tail capacity for that width."""
    deg = np.asarray(deg, np.int64)
    total_e = float(deg.sum())
    if deg.size == 0 or total_e == 0 or (not force_w and dcap <= 16):
        return -1, 0.0

    def p_big(w1):
        big = deg > w1
        return max(float(big.mean()), float(deg[big].sum()) / total_e)

    if force_w > 0:
        return int(force_w), min(1.0, safety * p_big(force_w))
    best = (float(dcap), -1, 0.0)
    for w1 in range(8, dcap, 8):
        p = p_big(w1)
        cost = w1 + safety * p * (dcap - w1)
        if cost < best[0]:
            best = (cost, w1, p)
    cost, w1, p = best
    if w1 <= 0 or cost > 0.9 * dcap:
        return -1, 0.0
    return w1, min(1.0, safety * p)


def pad_csr(adj: sp.csr_matrix, pad_degree: int = -1, tier: bool = False,
            tier_w: int = 0, device="cpu") -> PaddedGraph:
    """Convert a scipy CSR adjacency to a PaddedGraph on ``device``.

    ``pad_degree = -1`` pads to the true maximum degree; a smaller cap
    keeps the first ``pad_degree`` CSR entries per row."""
    adj = adj.tocsr()
    n = adj.shape[0]
    deg = np.diff(adj.indptr).astype(np.int32)
    dcap = int(deg.max()) if n and deg.size else 1
    if pad_degree != -1:
        dcap = int(pad_degree)
    dcap = max(dcap, 1)

    capped = np.minimum(deg, dcap)
    # entry (r, s) takes CSR slot indptr[r]+s when s < deg[r]
    slot = np.arange(dcap, dtype=np.int64)[None, :]
    src = adj.indptr[:-1, None] + slot                 # [n, dcap]
    valid = slot < capped[:, None]
    src = np.where(valid, src, 0)
    nbr = np.full((n + 1, dcap), n, dtype=np.int32)
    w = np.zeros((n + 1, dcap), dtype=np.float32)
    if adj.indices.size:
        nbr[:n] = np.where(valid, adj.indices[src], n)
        w[:n] = np.where(valid, adj.data[src], 0.0)
    deg_out = np.zeros(n + 1, dtype=np.int32)
    deg_out[:n] = capped
    tw, tf = choose_tier(capped, dcap, force_w=tier_w) if tier else (-1, 0.0)
    return PaddedGraph(nbr=torch.from_numpy(nbr).to(device),
                       w=torch.from_numpy(w).to(device),
                       deg=torch.from_numpy(deg_out).to(device),
                       tier_w=tw, tier_frac=tf)


@dataclass(frozen=True)
class FlatGraph:
    """Block-aligned flat-CSR adjacency, the edge-list layout: O(E) storage
    where the padded layout pays O(N * max_degree), so hub-heavy graphs keep
    exact neighbourhoods without padding every row to the hub's degree.

    Every CSR row starts on a ``BLOCK``-slot boundary of the flat arrays,
    which are kept as ``[NB, BLOCK]`` tables, so a row window is whole-block
    row gathers plus a slice (:func:`flat_row_windows`).

    Attributes:
      bstart: [N+2] int32 block index of each row's start; row N, the
              sentinel, is empty and followed by ``ceil(max_degree/BLOCK)``
              blocks of padding, so no window reads past the tables.
      idx:    [NB, BLOCK] int32 neighbour ids; gaps and the tail hold N.
      w:      [NB, BLOCK] float32 edge weights; gaps and the tail hold 0.
      deg:    [N+1] int32 row lengths; deg[N] = 0.
      max_degree: the longest row (the sampler's row window).
      edge_cap_per_row: the CV full-neighbourhood term's budget: each
        output row reads its first ``edge_cap_per_row`` CSR entries.
      parts: the node-sharding partitions the block tables are laid out
        for: partition ``p`` holds the blocks of nodes ``[p ceil(N/parts),
        (p+1) ceil(N/parts))``, every partition is padded to one block
        count ``NB / parts`` (block owner ``bid // (NB / parts)``), and
        each has its own ``ceil(max_degree/BLOCK)``-block sentinel tail, so
        no window crosses into the next partition's tile.  ``parts = 1``
        is the whole-table layout.  Note the node partition is not the
        histories' ``shard_rows(N, P) / P`` rows a rank.
      tier_w, tier_frac: the two-tier split of the full term (-1 = off).
      renorm: [N+1] float32 full-row mass over the budget's mass for rows
        the budget truncates, 1 elsewhere (the reference's --max_degree
        semantics: kept edges are renormalised).
      truncated_frac: the share of edges the budget drops from the full
        term (0.0 = lossless), rounded to 6 digits.
      mesh: the data-parallel mesh of a node-sharded graph
        (:func:`shard_flat_graph`), whose ``idx`` and ``w`` hold this
        rank's tile (``bstart``, ``deg`` and ``renorm`` stay whole); None
        for a whole graph.
    """
    bstart: torch.Tensor
    idx: torch.Tensor
    w: torch.Tensor
    deg: torch.Tensor
    max_degree: int
    edge_cap_per_row: int
    parts: int = 1
    tier_w: int = -1
    tier_frac: float = 0.0
    renorm: Optional[torch.Tensor] = None
    truncated_frac: float = 0.0
    mesh: Optional[object] = None

    BLOCK: ClassVar[int] = 8

    @property
    def num_nodes(self) -> int:
        return self.bstart.shape[0] - 2

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def pad_degree(self) -> int:
        # row-window width: a field row materialises at most this many slots
        return self.max_degree


AUTO_EDGE_COVERAGE = 0.999   # auto edge budget covers >= this edge fraction


def flat_csr(adj: sp.csr_matrix, edge_mult: float = 0.0, parts: int = 1,
             tier: bool = False, tier_w: int = 0,
             device="cpu") -> FlatGraph:
    """Convert a scipy CSR adjacency to a :class:`FlatGraph` on ``device``,
    array for array and static for static the JAX package's.

    ``edge_mult > 0`` sets ``edge_cap_per_row = ceil(edge_mult *
    mean_degree)`` (at least 1, at most the max degree); ``edge_mult <= 0``
    sizes it automatically: the smallest ``BLOCK`` multiple whose windows
    cover ``AUTO_EDGE_COVERAGE`` of all edges.  Rows longer than the budget
    keep their first ``edge_cap_per_row`` entries in the full term,
    renormalised (``renorm``); a budget that drops more than 1% of the
    edges warns.  ``parts > 1`` lays the block tables out for node-sharding
    over that many ranks (``FlatGraph.parts``, :func:`shard_flat_graph`);
    a window's blocks then come from their owners
    (:func:`flat_row_windows`)."""
    if parts < 1:
        raise ValueError(f"flat_csr: parts={parts} is not a partition "
                         "count")
    adj = adj.tocsr()
    n = adj.shape[0]
    deg = np.diff(adj.indptr).astype(np.int32)
    max_deg = max(int(deg.max()) if deg.size else 1, 1)
    mean_deg = float(deg.mean()) if deg.size else 1.0
    B = FlatGraph.BLOCK
    if edge_mult > 0:
        cap_row = int(min(max_deg,
                          max(1, int(np.ceil(edge_mult * mean_deg)))))
    else:
        # auto: the smallest BLOCK multiple c with
        # sum(min(deg, c)) >= coverage * sum(deg)
        total_e = int(deg.sum())
        if total_e == 0:
            cap_row = 1
        else:
            ds_sorted = np.sort(deg.astype(np.int64))
            csum = np.concatenate([[0], np.cumsum(ds_sorted)])
            cands = np.arange(B, max_deg + B, B, dtype=np.int64)
            pos = np.searchsorted(ds_sorted, cands, side="right")
            kept = csum[pos] + cands * (n - pos)
            ok = kept >= AUTO_EDGE_COVERAGE * total_e
            cap_row = int(min(max_deg, cands[np.argmax(ok)] if ok.any()
                              else max_deg))

    over = deg > cap_row
    trunc_frac = 0.0
    if over.any():
        lost = int((deg[over] - cap_row).sum())
        total = int(deg.sum())
        trunc_frac = round(lost / max(total, 1), 6)
        if lost > 0.01 * total:
            warnings.warn(
                f"flat_csr: edge_cap_per_row={cap_row} truncates "
                f"{int(over.sum())} rows (degree > cap), dropping "
                f"{lost}/{total} edges ({100.0 * lost / max(total, 1):.2f}%)"
                " from the CV full-neighborhood term (kept edges are "
                "renormalized to preserve row mass); raise "
                "--fadj_edge_mult (or 0 = auto) for exact neighborhoods.",
                stacklevel=2)

    # row i owns blocks [bstart[i], bstart[i+1]); each partition ends in a
    # ceil(max_degree / B)-block sentinel tail, so a window from any of
    # its rows (the sentinel row N's included, placed at the last
    # partition's used end) stays inside the partition's tile
    nb_row = -(-deg // B)
    wpad = max(-(-max_deg // B), 1)
    cum = np.zeros(n + 1, np.int64)
    cum[1:] = np.cumsum(nb_row, dtype=np.int64)
    nl = -(-n // parts)                         # nodes per partition
    owner = np.arange(n, dtype=np.int64) // nl
    part_lo = np.minimum(np.arange(parts, dtype=np.int64) * nl, n)
    part_hi = np.minimum(part_lo + nl, n)
    used = cum[part_hi] - cum[part_lo]          # blocks used per partition
    nb_part = int(used.max()) + wpad if n else wpad
    bstart = np.zeros(n + 2, np.int64)
    bstart[:n] = owner * nb_part + (cum[:n] - cum[part_lo[owner]])
    bstart[n] = (parts - 1) * nb_part + int(used[-1]) if n else 0
    bstart[n + 1] = bstart[n]
    total_blocks = parts * nb_part
    deg_out = np.zeros(n + 1, np.int32)
    deg_out[:n] = deg
    idx = np.full(total_blocks * B, n, np.int32)
    w = np.zeros(total_blocks * B, np.float32)
    # each entry's position within its CSR row (reused by the renorm)
    off = (np.arange(len(adj.indices), dtype=np.int64)
           - np.repeat(adj.indptr[:n].astype(np.int64), deg))
    dst = np.repeat(bstart[:n] * B, deg) + off
    idx[dst] = adj.indices.astype(np.int32)
    w[dst] = adj.data.astype(np.float32)
    renorm = np.ones(n + 1, np.float32)
    if over.any():
        row_ids = np.repeat(np.arange(n, dtype=np.int64), deg)
        wdat = adj.data.astype(np.float64)
        full_mass = np.bincount(row_ids, weights=wdat, minlength=n)
        keep = off < cap_row
        kept_mass = np.bincount(row_ids[keep], weights=wdat[keep],
                                minlength=n)
        tr_rows = over & (kept_mass[:n] > 0)
        renorm[:n][tr_rows] = (full_mass[tr_rows]
                               / kept_mass[tr_rows]).astype(np.float32)
    tw, tf = (-1, 0.0)
    if tier:
        width = min(cap_row, max_deg)
        tw, tf = choose_tier(np.minimum(deg, width), width, force_w=tier_w)
        # tier boundaries are block-aligned and leave a real tail window
        if tw > 0 and (tw % B != 0 or tw > width - B):
            tw, tf = -1, 0.0

    def dev(a):
        return torch.from_numpy(a).to(device)
    return FlatGraph(bstart=dev(bstart.astype(np.int32)),
                     idx=dev(idx.reshape(-1, B)), w=dev(w.reshape(-1, B)),
                     deg=dev(deg_out), max_degree=max_deg,
                     edge_cap_per_row=cap_row, parts=parts, tier_w=tw,
                     tier_frac=tf, renorm=dev(renorm),
                     truncated_frac=trunc_frac)


def flat_row_windows(graph: FlatGraph, field: torch.Tensor, width: int,
                     start: int = 0):
    """``[F, width]`` neighbour / weight windows of a field's rows: slots
    ``[start, start + width)`` of each row's CSR range (``start`` a
    ``BLOCK`` multiple, as the two-tier term's tail passes it), and the
    rows' ``[F]`` degrees.  A row's blocks are contiguous, so its window
    is one run of the flat arrays from ``bstart * BLOCK + start``, taken
    element by element (``index_select`` of whole 32-byte blocks took
    ~14x as long: 0.45 against 0.033 ms an array for a 16,384-row chunk
    of the a-bar build on an NVIDIA H100 80GB HBM3 at 700 W,
    chip_smoke.py); a window may run into the next row's blocks, and
    slots at or past the row's degree are masked to the sentinel id N and
    weight 0, as the padded layout holds them.

    Of a node-sharded graph (:func:`shard_flat_graph`) the windows' whole
    blocks, ``[F * ceil(width / BLOCK)]`` block ids, come from their
    owners in one exchange of the ``idx`` and ``w`` rows
    (``parallel/halo.py::row_gather2``); a partition's sentinel tail keeps
    every window inside its owner's tile."""
    n = graph.num_nodes
    B = graph.idx.shape[1]
    if start % B:
        raise ValueError(f"window start {start} is not a multiple of {B}")
    ids = field.to(torch.int64)
    dev = graph.idx.device
    deg = graph.deg.index_select(0, ids)
    valid = (start + torch.arange(width, dtype=torch.int32, device=dev)
             )[None, :] < deg[:, None]
    if graph.sharded:
        from ..parallel.halo import row_gather2
        nb = -(-width // B)
        b0 = graph.bstart.index_select(0, ids).to(torch.int64) + start // B
        bids = b0[:, None] + torch.arange(nb, device=dev)[None, :]
        blk_i, blk_w = row_gather2(graph.idx, graph.w, bids, graph.mesh)
        nbr = blk_i.reshape(-1, nb * B)[:, :width]
        w = blk_w.reshape(-1, nb * B)[:, :width]
    else:
        first = graph.bstart.index_select(0, ids).to(torch.int64) * B \
            + start
        at = first[:, None] + torch.arange(width, device=dev)[None, :]
        nbr, w = torch.take(graph.idx, at), torch.take(graph.w, at)
    return torch.where(valid, nbr, n), torch.where(valid, w, 0.0), deg


def graph_rows(graph, field: torch.Tensor):
    """The ``[F, Dcap]`` neighbour / weight rows and ``[F]`` degrees of a
    field (ids <= N; sentinel rows are empty), from either layout: the one
    dispatch point between them.  Of a row-sharded graph the rows come
    from their owner ranks (parallel/halo.py), row N included, so
    sentinel ids read the same empty row as on one device."""
    if isinstance(graph, FlatGraph):
        return flat_row_windows(graph, field, graph.pad_degree)
    ids = field.to(torch.int64)
    deg = graph.deg.index_select(0, ids)
    if graph.sharded:
        from ..parallel.halo import row_gather2
        return (*row_gather2(graph.nbr, graph.w, field, graph.mesh), deg)
    return graph.nbr.index_select(0, ids), graph.w.index_select(0, ids), deg


def graph_slots(graph, field: torch.Tensor, sel: torch.Tensor):
    """The neighbour and weight at slot ``sel[f]`` of each field row (``[F]``
    each), without the rows: what the degree-1 sampler draws.  ``sel`` is
    below the row's degree, or 0 for an empty row, which reads the sentinel
    id N and weight 0 in either layout.  Of a row-sharded graph each slot
    comes from its row's owner, as one element of the tables viewed as
    ``[rows * Dcap, 1]`` (of a node-sharded edge list ``[NB * BLOCK,
    1]``)."""
    ids = field.to(torch.int64)
    sel = sel.to(torch.int64)
    if isinstance(graph, PaddedGraph) and graph.sharded:
        from ..parallel.halo import row_gather2
        k = graph.pad_degree
        nbr, w = row_gather2(graph.nbr.reshape(-1, 1),
                             graph.w.reshape(-1, 1), ids * k + sel,
                             graph.mesh)
        return nbr.reshape(-1), w.reshape(-1)
    if isinstance(graph, FlatGraph):
        at = graph.bstart.index_select(0, ids).to(torch.int64) \
            * graph.idx.shape[1] + sel
        live = graph.deg.index_select(0, ids) > 0
        if graph.sharded:
            from ..parallel.halo import row_gather2
            nbr, w = row_gather2(graph.idx.reshape(-1, 1),
                                 graph.w.reshape(-1, 1), at, graph.mesh)
            nbr, w = nbr.reshape(-1), w.reshape(-1)
        else:
            nbr = graph.idx.reshape(-1).index_select(0, at)
            w = graph.w.reshape(-1).index_select(0, at)
        return (torch.where(live, nbr, graph.num_nodes),
                torch.where(live, w, 0.0))
    return graph.nbr[ids, sel], graph.w[ids, sel]


def pad_table_rows(x: torch.Tensor, multiple: int, fill=0) -> torch.Tensor:
    """``x`` ([R, ...]) with rows holding ``fill`` appended so R divides
    ``multiple``: a node table that tiles over a mesh.  The padding rows
    are never addressed (node ids <= N < R)."""
    r = x.shape[0]
    extra = -(-r // multiple) * multiple - r
    if extra == 0:
        return x
    return torch.cat([x, x.new_full((extra, *x.shape[1:]), fill)])


def pad_features_rows(features, multiple: int):
    """Row-pad a feature table (dense, or padded-sparse with sentinel
    column ids ``dim`` and zero values in the new rows) for a mesh."""
    if isinstance(features, PaddedSparseFeatures):
        return features.replace(
            idx=pad_table_rows(features.idx, multiple, features.dim),
            val=pad_table_rows(features.val, multiple))
    return pad_table_rows(features, multiple)


def pad_graph_rows(graph: PaddedGraph, multiple: int) -> PaddedGraph:
    """Row-pad a whole PaddedGraph's ``nbr`` / ``w`` for a mesh (the new
    rows are empty: sentinel ids, zero weights); ``deg`` stays ``[N+1]``,
    and with it the node count."""
    n = graph.num_nodes
    return dataclasses.replace(
        graph, nbr=pad_table_rows(graph.nbr, multiple, n),
        w=pad_table_rows(graph.w, multiple))


def shard_graph_rows(graph: PaddedGraph, mesh, rows: int) -> PaddedGraph:
    """This rank's block of a whole PaddedGraph padded to ``rows`` rows
    (``parallel.mesh.shard_rows``): ``nbr`` and ``w`` row-sharded over
    ``mesh``, ``deg`` whole."""
    padded = pad_graph_rows(graph, rows)
    return dataclasses.replace(padded, nbr=mesh.local(padded.nbr).clone(),
                               w=mesh.local(padded.w).clone(), mesh=mesh)


def shard_flat_graph(graph: FlatGraph, mesh) -> FlatGraph:
    """This rank's tile, tensors of its own, of a whole FlatGraph built for
    ``mesh.size`` partitions (``flat_csr(..., parts=P)``): the ``[NB / P,
    BLOCK]`` block rows of ``idx`` and ``w``; ``bstart``, ``deg`` and
    ``renorm`` stay whole."""
    if graph.parts != mesh.size:
        raise ValueError(f"a FlatGraph of {graph.parts} partitions does not "
                         f"shard over {mesh.size} ranks")
    return dataclasses.replace(graph, idx=mesh.local(graph.idx).clone(),
                               w=mesh.local(graph.w).clone(), mesh=mesh)


def shard_table_rows(features, mesh, rows: int):
    """This rank's block, a tensor of its own, of a whole node table (dense,
    or padded-sparse features) padded to ``rows`` rows."""
    padded = pad_features_rows(features, rows)
    if isinstance(padded, PaddedSparseFeatures):
        return padded.replace(idx=mesh.local(padded.idx).clone(),
                              val=mesh.local(padded.val).clone())
    return mesh.local(padded).clone()


def dense_rows(x, num_nodes: Optional[int] = None, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Densify node-indexed data to [N+1, d] with a zero sentinel row."""
    if sp.issparse(x):
        x = np.asarray(x.todense())
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0] if num_nodes is None else num_nodes
    out = torch.zeros((n + 1, x.shape[1]), dtype=dtype, device=device)
    out[:x.shape[0]] = torch.from_numpy(x).to(device=device, dtype=dtype)
    return out


@dataclass(frozen=True)
class PaddedSparseFeatures:
    """Row-padded sparse features: ``X[i] = sum_j val[i,j] * e_{idx[i,j]}``.

    idx: [N+1, nnz_cap] int32 column ids; an empty slot holds ``dim``.
    val: [N+1, nnz_cap] values (float32, or the features dtype); an empty
      slot holds 0.  Row N, the sentinel node's, is empty.
    ``X @ W`` is then ``out[i] = sum_j val[i,j] * W[idx[i,j]]``, a gather
    of ``W``'s rows in which the sentinel column ``dim`` reads zero
    (``ops/layers.py::matmul``)."""
    idx: torch.Tensor
    val: torch.Tensor
    dim: int

    def replace(self, **kw) -> "PaddedSparseFeatures":
        return dataclasses.replace(self, **kw)


def pad_sparse_features(x: sp.spmatrix, nnz_cap: int = 1024,
                        num_nodes: Optional[int] = None,
                        device="cpu") -> PaddedSparseFeatures:
    """Pad a sparse feature matrix row-wise to ``cap = min(nnz_cap, max row
    nnz)`` slots in CSR order.  A row with more than ``cap`` entries keeps
    its ``cap`` largest-|value| entries, in the order of
    ``np.argsort(-np.abs(vals))[:cap]``, the JAX package's call, so ties
    break the same way (a documented deviation from the reference, which
    keeps whole rows on the host).  Rows within the cap are copied all at
    once; only the rows above it are visited one by one."""
    x = x.tocsr()
    n = x.shape[0] if num_nodes is None else num_nodes
    dim = x.shape[1]
    indptr, indices, data = x.indptr, x.indices, x.data
    nnz = np.diff(indptr)
    cap = int(min(nnz_cap, max(1, nnz.max() if len(nnz) else 1)))

    idx = np.full((n + 1, cap), dim, dtype=np.int32)
    val = np.zeros((n + 1, cap), dtype=np.float32)
    row = np.repeat(np.arange(x.shape[0]), nnz)
    short = nnz[row] <= cap
    at = np.flatnonzero(short)
    r, c = row[at], at - indptr[row[at]]
    idx[r, c] = indices[at]
    val[r, c] = data[at]
    for r in np.flatnonzero(nnz > cap):
        lo, hi = indptr[r], indptr[r + 1]
        keep = np.argsort(-np.abs(data[lo:hi]))[:cap]
        idx[r] = indices[lo:hi][keep]
        val[r] = data[lo:hi][keep]
    return PaddedSparseFeatures(idx=torch.from_numpy(idx).to(device),
                                val=torch.from_numpy(val).to(device),
                                dim=dim)


@dataclass
class Dataset:
    """Host-side dataset bundle (the reference ``load_data`` 10-tuple)."""
    num_data: int
    train_adj: sp.csr_matrix
    full_adj: sp.csr_matrix
    feats: object            # np.ndarray or scipy sparse
    train_feats: object      # PP features over train_adj (Â_train · X)
    test_feats: object       # PP features over full_adj  (Â_full · X)
    labels: np.ndarray
    train_d: np.ndarray
    val_d: np.ndarray
    test_d: np.ndarray

    @property
    def num_classes(self) -> int:
        return self.labels.shape[1]

    @property
    def feature_dim(self) -> int:
        return self.feats.shape[1]
