"""Device-resident graph containers.

Port of stochastic_gcn_tpu/data/graph.py for the padded layout: the whole
graph lives on the device as static-shape ``[N+1, Dcap]`` rows (row ``N`` is
an empty sentinel row), filled on the host with numpy.  Sparse features
live there the same way, as ``[N+1, nnz_cap]`` (column, value) slots
(:class:`PaddedSparseFeatures`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

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
        (-1 = off).  Kept for the record: the port runs the full-width
        kernel, which gives the same (exact) value.
    """
    nbr: torch.Tensor
    w: torch.Tensor
    deg: torch.Tensor
    tier_w: int = -1
    tier_frac: float = 0.0

    @property
    def num_nodes(self) -> int:
        return self.nbr.shape[0] - 1

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


def graph_rows(graph: PaddedGraph, field: torch.Tensor):
    """The [F, Dcap] neighbor/weight rows and [F] degrees of a field (ids
    <= N; sentinel rows are empty)."""
    ids = field.to(torch.int64)
    return (graph.nbr.index_select(0, ids), graph.w.index_select(0, ids),
            graph.deg.index_select(0, ids))


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
