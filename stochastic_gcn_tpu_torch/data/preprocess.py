"""Host-side graph/feature preprocessing (pure numpy/scipy).

The slice of stochastic_gcn_tpu/data/preprocess.py the port needs, copied
because that package's ``data`` modules import JAX.  ``cap_adj_degree``
makes the JAX copy's draws, so both packages keep the same edges.
:func:`standard_scale` stands in for scikit-learn's ``StandardScaler``,
which the JAX loader uses and the port does not import.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def row_normalize_features(features: sp.spmatrix) -> sp.spmatrix:
    """Row-normalize a feature matrix: X <- D^-1 X (rowsum + 1e-9, inf ->
    0), as gcn/utils.py:138-143."""
    rowsum = np.asarray(features.sum(1)).flatten() + 1e-9
    r_inv = np.power(rowsum, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    return sp.diags(r_inv, 0).dot(features)


def standard_scale(feats: np.ndarray, fit_rows: np.ndarray) -> np.ndarray:
    """``StandardScaler().fit(feats[fit_rows]).transform(feats)`` in numpy:
    every row standardised by the per-column mean and population standard
    deviation of the rows ``fit_rows``, a near-constant column's deviation
    read as 1.  As scikit-learn does it: float64 moments by the corrected
    two-pass algorithm (Chan, Golub and LeVeque), the constant-column test
    on the variance, then the mean and scale cast to the input's dtype and
    applied to a copy, subtraction then division."""
    fit = np.asarray(feats[fit_rows])
    n = fit.shape[0]
    mean = fit.sum(axis=0, dtype=np.float64) / n
    temp = fit - mean
    correction = temp.sum(axis=0)
    var = (np.square(temp).sum(axis=0) - correction ** 2 / n) / n
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    out = np.array(feats, copy=True)
    out -= mean.astype(out.dtype)
    out /= scale.astype(out.dtype)
    return out


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


def data_augmentation(num_data, train_adj, full_adj, feats, labels,
                      train_data, val_data, test_data, n_rep: int = 1):
    """Block-diagonal graph replication (gcn/utils.py:416-449): ``n_rep``
    copies of the training graph followed by one copy of the full graph;
    train ids index the train copies, val/test ids the full copy.  Returns
    ``(N', adj, feats, adj . feats, labels, train, val, test)``."""
    if isinstance(feats, np.ndarray):
        feats = np.tile(feats, [n_rep + 1, 1])
    else:
        feats = sp.vstack([feats] * (n_rep + 1)).tocsr()
    labels = np.tile(labels, [n_rep + 1, 1])

    train_coo = train_adj.tocoo()
    full_coo = full_adj.tocoo()
    rows, cols, vals = [], [], []
    for t in range(n_rep):
        rows.append(train_coo.row + t * num_data)
        cols.append(train_coo.col + t * num_data)
        vals.append(train_coo.data)
    rows.append(full_coo.row + n_rep * num_data)
    cols.append(full_coo.col + n_rep * num_data)
    vals.append(full_coo.data)

    big_n = num_data * (n_rep + 1)
    adj = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(big_n, big_n), dtype=train_adj.dtype)

    train_data = np.concatenate(
        [train_data + t * num_data for t in range(n_rep)])
    val_data = val_data + n_rep * num_data
    test_data = test_data + n_rep * num_data
    return (big_n, adj, feats, adj.dot(feats), labels,
            train_data, val_data, test_data)


def locality_permutation(adj: sp.spmatrix, method: str = "rcm") -> np.ndarray:
    """A node permutation that improves edge locality for contiguous-block
    row-sharding (``--partition_nodes``): position i holds the OLD id
    placed at NEW id i.  ``'rcm'``: reverse Cuthill-McKee over the
    symmetrised structure of ``adj``, so a node's neighbours get nearby
    ids and most edges stay inside one rank's block.  A pure relabelling:
    training and evaluation do not depend on it beyond the order of
    floating-point sums."""
    if method != "rcm":
        raise ValueError(f"unknown partition_nodes method: {method!r}")
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    sym = (adj + adj.T).astype(bool).astype(np.int8).tocsr()
    return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True),
                      dtype=np.int64)


def relabel_dataset(ds, perm: np.ndarray):
    """Every per-node table of a Dataset (adjacency rows and columns,
    features, PP features, labels, id splits) under the permutation
    ``perm`` of :func:`locality_permutation`."""
    from .graph import Dataset

    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))

    def remap_adj(a):
        return a.tocsr()[perm][:, perm].tocsr()

    def remap_rows(x):
        return x.tocsr()[perm] if sp.issparse(x) else np.asarray(x)[perm]

    return Dataset(
        num_data=ds.num_data,
        train_adj=remap_adj(ds.train_adj),
        full_adj=remap_adj(ds.full_adj),
        feats=remap_rows(ds.feats),
        train_feats=remap_rows(ds.train_feats),
        test_feats=remap_rows(ds.test_feats),
        labels=np.asarray(ds.labels)[perm],
        train_d=inv[np.asarray(ds.train_d)].astype(np.int32),
        val_d=inv[np.asarray(ds.val_d)].astype(np.int32),
        test_d=inv[np.asarray(ds.test_d)].astype(np.int32),
    )
