"""The benchmark's inputs: a Reddit-shaped graph drawn from the seed.

A frozen copy of the recipe of the JAX package's benchmark
(``bench.py::build_reddit_like``, which the port's
``data/loaders.py::reddit_like`` repeats): uniform random node pairs, half
the mean degree times the node count of them, self pairs dropped, the
pairs symmetrised and merged into a 0/1 adjacency; Gaussian features;
uniform random one-hot labels; a 66/10/24 train/val/test split by a random
permutation; the train graph keeps the edges between train nodes.  The
configurations draw at Reddit's published mean degree, so most rows are
longer than ``pad_degree`` and the port's padded graphs cap them.  Here
every draw is one call on ``device`` from a generator seeded with the
run's seed, so a seed gives the same inputs on every card and set-up
stays short.

The port receives what its loaders give it (:func:`to_dataset`): the
row-normalised adjacencies, the features, the labels, the splits and,
with preprocessing, the preprocessed features ``A X`` (which its loaders
read from their cache, made here on the card by :func:`propagate`); it
derives the rest itself (padded and capped graphs, fields, histories).
The reference derives everything again from the :class:`Graph`
(``reference.py``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch


@dataclass
class Graph:
    """One draw, every tensor on one device.  ``indptr`` / ``indices``: the
    0/1 adjacency in CSR (rows sorted, no self loops, symmetric);
    ``train_indptr`` / ``train_indices``: its edges between train nodes;
    ``labels``: class ids; the splits: sorted node ids."""
    num_nodes: int
    num_classes: int
    indptr: torch.Tensor
    indices: torch.Tensor
    train_indptr: torch.Tensor
    train_indices: torch.Tensor
    feats: torch.Tensor
    labels: torch.Tensor
    train_ids: torch.Tensor
    val_ids: torch.Tensor
    test_ids: torch.Tensor

    def to(self, device) -> "Graph":
        return Graph(self.num_nodes, self.num_classes,
                     *(getattr(self, f).to(device) for f in (
                         "indptr", "indices", "train_indptr",
                         "train_indices", "feats", "labels", "train_ids",
                         "val_ids", "test_ids")))


def _csr(rows: torch.Tensor, cols: torch.Tensor, n: int):
    deg = torch.bincount(rows, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(deg, 0)
    return indptr, cols


def draw(data: dict, seed: int, device) -> Graph:
    """The graph of the configuration ``data`` (its keys ``num_nodes``,
    ``avg_degree``, ``feature_dim``, ``num_classes``, ``train_share``,
    ``val_share``) drawn from ``seed`` on ``device``."""
    n = int(data["num_nodes"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pairs = torch.randint(0, n, (n * int(data["avg_degree"]) // 2, 2),
                          generator=gen, device=device)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    u = torch.cat([pairs[:, 0], pairs[:, 1]])
    v = torch.cat([pairs[:, 1], pairs[:, 0]])
    key = torch.unique(u * n + v)               # sorted: rows, then columns
    rows, cols = key // n, key % n
    feats = torch.randn((n, int(data["feature_dim"])), generator=gen,
                        device=device)
    labels = torch.randint(0, int(data["num_classes"]), (n,), generator=gen,
                           device=device)
    perm = torch.randperm(n, generator=gen, device=device)
    n_train = int(n * float(data["train_share"]))
    n_val = int(n * float(data["val_share"]))
    train_ids = torch.sort(perm[:n_train]).values
    val_ids = torch.sort(perm[n_train:n_train + n_val]).values
    test_ids = torch.sort(perm[n_train + n_val:]).values
    is_train = torch.zeros(n, dtype=torch.bool, device=device)
    is_train[train_ids] = True
    keep = is_train[rows] & is_train[cols]
    indptr, indices = _csr(rows, cols, n)
    train_indptr, train_indices = _csr(rows[keep], cols[keep], n)
    return Graph(n, int(data["num_classes"]), indptr, indices, train_indptr,
                 train_indices, feats, labels, train_ids, val_ids, test_ids)


def propagate(indptr: torch.Tensor, indices: torch.Tensor,
              feats: torch.Tensor) -> torch.Tensor:
    """``A X`` for the 0/1 adjacency ``indptr`` / ``indices`` normalised to
    ``1/deg`` a row (``graphsage_normalize_adj``), every edge of a row: the
    preprocessed features, one sparse product on ``feats``' device."""
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]
    vals = torch.repeat_interleave(1.0 / deg.clamp(min=1).float(), deg)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        warnings.filterwarnings("ignore", "Sparse invariant checks")
        a = torch.sparse_csr_tensor(indptr, indices, vals, (n, n),
                                    check_invariants=False)
        return a @ feats


def normalised_adjacency(indptr: torch.Tensor, indices: torch.Tensor,
                         n: int) -> sp.csr_matrix:
    """The 0/1 adjacency normalised to ``1/deg`` a row (float32, as
    ``graphsage_normalize_adj`` makes it), columns sorted within a row."""
    deg = indptr[1:] - indptr[:-1]
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1).float(), 0.0)
    return sp.csr_matrix(
        (torch.repeat_interleave(inv, deg).cpu().numpy(),
         indices.cpu().numpy().astype(np.int32),
         indptr.cpu().numpy().astype(np.int64)), shape=(n, n))


def to_dataset(g: Graph, preprocess: bool):
    """The port's ``Dataset`` of the draw, as the port's loaders give one:
    the row-normalised adjacencies (:func:`normalised_adjacency`, columns
    sorted, so that the port's cap at ``pad_degree`` draws from rows in a
    known order) and, with ``preprocess``, the preprocessed features of
    the train and the full graph, which the loaders read from their cache
    (here :func:`propagate` on the draw's device).  Host arrays."""
    from stochastic_gcn_tpu_torch.data.graph import Dataset
    n = g.num_nodes
    full_adj = normalised_adjacency(g.indptr, g.indices, n)
    train_adj = normalised_adjacency(g.train_indptr, g.train_indices, n)
    feats = g.feats.cpu().numpy()
    labels = np.zeros((n, g.num_classes), np.float32)
    labels[np.arange(n), g.labels.cpu().numpy()] = 1.0
    pp = (lambda indptr, indices: propagate(indptr, indices, g.feats)
          .cpu().numpy()) if preprocess else (lambda *_: None)
    return Dataset(num_data=n, train_adj=train_adj, full_adj=full_adj,
                   feats=feats,
                   train_feats=pp(g.train_indptr, g.train_indices),
                   test_feats=pp(g.indptr, g.indices), labels=labels,
                   train_d=g.train_ids.cpu().numpy().astype(np.int32),
                   val_d=g.val_ids.cpu().numpy().astype(np.int32),
                   test_d=g.test_ids.cpu().numpy().astype(np.int32))
