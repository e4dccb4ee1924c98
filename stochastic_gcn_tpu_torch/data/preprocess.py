"""Host-side graph/feature preprocessing (pure numpy/scipy).

The slice of stochastic_gcn_tpu/data/preprocess.py the port needs, copied
because that package's ``data`` modules import JAX.  ``cap_adj_degree``
makes the JAX copy's draws, so both packages keep the same edges.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def gcn_normalize_adj(adj: sp.spmatrix) -> sp.csr_matrix:
    """Symmetric GCN normalization: D^-1/2 (A + I) D^-1/2."""
    adj = adj + sp.eye(adj.shape[0])
    rowsum = np.asarray(adj.sum(1)).flatten() + 1e-20
    d_inv_sqrt = np.power(rowsum, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt, 0)
    out = adj.dot(d).transpose().dot(d).tocsr()
    out.data = out.data.astype(np.float32)
    return out


def graphsage_normalize_adj(adj: sp.spmatrix) -> sp.csr_matrix:
    """Row normalization without self loops: D^-1 A."""
    rowsum = np.asarray(adj.sum(1)).flatten()
    d_inv = 1.0 / (rowsum + 1e-20)
    out = sp.diags(d_inv, 0).dot(adj).tocsr()
    out.data = out.data.astype(np.float32)
    return out


def normalize_adj(adj: sp.spmatrix, normalization: str) -> sp.csr_matrix:
    if normalization == "gcn":
        return gcn_normalize_adj(adj)
    elif normalization == "graphsage":
        return graphsage_normalize_adj(adj)
    raise ValueError(f"unknown normalization {normalization!r}")


def adj_from_edges(edges: np.ndarray, num_data: int,
                   symmetrize: bool = True) -> sp.csr_matrix:
    """Build a 0/1 adjacency from an [E, 2] edge array."""
    adj = sp.csr_matrix(
        (np.ones(edges.shape[0], dtype=np.float32),
         (edges[:, 0], edges[:, 1])),
        shape=(num_data, num_data))
    if symmetrize:
        adj = adj + adj.transpose()
    return adj.tocsr()


def subsample_edges(edges: np.ndarray, num_data: int, max_degree: int,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Greedy degree-capped edge subsample: edges are shuffled and kept only
    while both endpoints are below ``max_degree``."""
    rng = rng or np.random.default_rng(0)
    edges = np.asarray(edges, dtype=np.int32).copy()
    rng.shuffle(edges)
    degree = np.zeros(num_data, dtype=np.int32)
    keep = np.zeros(edges.shape[0], dtype=bool)
    for i, (a, b) in enumerate(edges):
        if degree[a] < max_degree and degree[b] < max_degree:
            keep[i] = True
            degree[a] += 1
            degree[b] += 1
    return edges[keep]


def cap_adj_degree(adj: sp.csr_matrix, max_degree: int, seed: int = 0,
                   rescale: bool = True) -> sp.csr_matrix:
    """Cap each row of a CSR adjacency to at most ``max_degree`` entries.

    The JAX package's draws exactly: one ``default_rng(seed)``, and for
    each row above the cap, in row order, ``rng.choice(deg, max_degree,
    replace=False)``; the picked entries are kept in the drawn order,
    rescaled by ``deg/max_degree`` so the row mass is preserved
    (``rescale=False`` keeps raw weights).  Rows within the cap make no
    draws and are copied unchanged, all at once."""
    adj = adj.tocsr()
    indptr, indices, data = adj.indptr, adj.indices, adj.data
    n = adj.shape[0]
    deg = np.diff(indptr)
    new_deg = np.minimum(deg, max_degree)
    new_indptr = np.zeros(n + 1, dtype=indptr.dtype)
    np.cumsum(new_deg, out=new_indptr[1:])
    row = np.repeat(np.arange(n), deg)
    short = deg[row] <= max_degree
    dest = np.flatnonzero(short)
    dest = new_indptr[row[dest]] + (dest - indptr[row[dest]])
    rng = np.random.default_rng(seed)
    capped = []
    for r in np.flatnonzero(deg > max_degree):
        lo, hi = indptr[r], indptr[r + 1]
        d = hi - lo
        pick = lo + rng.choice(d, size=max_degree, replace=False)
        w = data[pick] * (d / float(max_degree)) if rescale else data[pick]
        capped.append((new_indptr[r], indices[pick], w))
    # the dtype the JAX copy's concatenation of its rows takes
    out_dtype = np.result_type(data.dtype, *(w.dtype for *_, w in capped))
    out_i = np.empty(new_indptr[-1], dtype=indices.dtype)
    out_d = np.empty(new_indptr[-1], dtype=out_dtype)
    out_i[dest], out_d[dest] = indices[short], data[short]
    for at, idx, w in capped:
        out_i[at:at + max_degree], out_d[at:at + max_degree] = idx, w
    return sp.csr_matrix((out_d, out_i, new_indptr), shape=adj.shape)


def compute_pp_features(adj: sp.csr_matrix, feats):
    """PP features: one application of the normalized adjacency, Â·X."""
    return adj.dot(feats)
