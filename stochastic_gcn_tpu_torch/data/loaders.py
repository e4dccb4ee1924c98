"""Dataset loaders.

Port of the synthetic generators of stochastic_gcn_tpu/data/loaders.py
(same numpy draws, so the same seed gives the same dataset in both
packages): :func:`synthetic_dataset` and :func:`community_sbm_dataset`
(the convergence benchmark's graph), plus :func:`reddit_like`, the
Reddit-shaped graph of the JAX benchmark's headline recipe.  The
reference file formats (Planetoid, GraphSAGE JSON, YouTube) are not ported
yet.
"""

from __future__ import annotations

import numpy as np

from .graph import Dataset
from .preprocess import (adj_from_edges, compute_pp_features,
                         graphsage_normalize_adj, normalize_adj,
                         subsample_edges)


def synthetic_dataset(num_nodes: int = 512, feature_dim: int = 64,
                      num_classes: int = 7, avg_degree: int = 8,
                      normalization: str = "gcn", multitask: bool = False,
                      seed: int = 0, max_degree: int = -1) -> Dataset:
    """Random graph + planted-signal labels, shaped like a citation dataset
    (labels from a smoothed random feature projection, so a GCN can learn
    them)."""
    rng = np.random.default_rng(seed)
    n_edges = num_nodes * avg_degree // 2
    edges = rng.integers(0, num_nodes, size=(n_edges, 2)).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if max_degree != -1:
        edges = subsample_edges(edges, num_nodes, max_degree, rng)

    adj01 = (adj_from_edges(edges, num_nodes) > 0).astype(np.float32)
    full_adj = normalize_adj(adj01, normalization)

    feats = rng.normal(size=(num_nodes, feature_dim)).astype(np.float32)
    proj = rng.normal(size=(feature_dim, num_classes)).astype(np.float32)
    smooth = full_adj.dot(full_adj.dot(feats)) if normalization == "gcn" \
        else full_adj.dot(feats)
    logits = smooth.dot(proj)
    if multitask:
        labels = (logits > np.median(logits, axis=0)).astype(np.float32)
    else:
        labels = np.zeros((num_nodes, num_classes), dtype=np.float32)
        labels[np.arange(num_nodes), logits.argmax(1)] = 1

    perm = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * 0.5)
    n_val = int(num_nodes * 0.25)
    train_d = np.sort(perm[:n_train])
    val_d = np.sort(perm[n_train:n_train + n_val])
    test_d = np.sort(perm[n_train + n_val:])

    # graphsage-style splits train on edges among train nodes only;
    # gcn-style (citation) splits train on the full graph
    if normalization == "graphsage":
        is_train = np.zeros(num_nodes, dtype=bool)
        is_train[train_d] = True
        tr_edges = edges[is_train[edges[:, 0]] & is_train[edges[:, 1]]]
        train_adj = graphsage_normalize_adj(
            adj_from_edges(tr_edges, num_nodes))
    else:
        train_adj = full_adj

    train_feats = compute_pp_features(train_adj, feats)
    test_feats = compute_pp_features(full_adj, feats)
    return Dataset(num_data=num_nodes, train_adj=train_adj,
                   full_adj=full_adj, feats=feats,
                   train_feats=np.asarray(train_feats, np.float32),
                   test_feats=np.asarray(test_feats, np.float32),
                   labels=labels, train_d=train_d, val_d=val_d, test_d=test_d)


def community_sbm_dataset(num_nodes: int = 65536, num_classes: int = 41,
                          feature_dim: int = 602, mean_degree: int = 25,
                          p_in: float = 0.85, snr: float = 0.18,
                          pareto_a: float = 2.5, max_degree: int = -1,
                          train_frac: float = 0.66, val_frac: float = 0.10,
                          seed: int = 0) -> Dataset:
    """Degree-corrected stochastic block model with power-law degrees: the
    community-structured Reddit stand-in of the JAX benchmark's convergence
    check (bench.py::build_community_reddit).

    Labels are the planted communities.  Per-node features are a weak
    class signal (``snr`` standard deviations of class-mean separation
    under unit noise), so the graph carries the signal: one neighbourhood
    aggregation over mostly same-community neighbours (``p_in``) denoises
    it.  Degrees follow Pareto(``pareto_a``) propensities and are capped
    at ``max_degree`` by the greedy edge subsample."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    theta = rng.pareto(pareto_a, num_nodes) + 1.0
    p_global = theta / theta.sum()

    m = num_nodes * mean_degree // 2
    src = rng.choice(num_nodes, size=m, p=p_global).astype(np.int32)
    inside = rng.random(m) < p_in
    dst = rng.choice(num_nodes, size=m, p=p_global).astype(np.int32)
    # in-community targets are redrawn per community, ∝ theta in the block
    for c in range(num_classes):
        members = np.nonzero(comm == c)[0]
        need = np.nonzero(inside & (comm[src] == c))[0]
        if len(need) and len(members):
            pc = theta[members] / theta[members].sum()
            dst[need] = rng.choice(members, size=len(need), p=pc)
    edges = np.stack([src, dst], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if max_degree != -1:
        edges = subsample_edges(edges, num_nodes, max_degree, rng)

    adj01 = (adj_from_edges(edges, num_nodes) > 0).astype(np.float32)
    full_adj = graphsage_normalize_adj(adj01)

    mu = rng.normal(size=(num_classes, feature_dim)).astype(np.float32)
    feats = (snr * mu[comm]
             + rng.normal(size=(num_nodes, feature_dim))).astype(np.float32)
    labels = np.zeros((num_nodes, num_classes), dtype=np.float32)
    labels[np.arange(num_nodes), comm] = 1

    perm = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * train_frac)
    n_val = int(num_nodes * val_frac)
    train_d = np.sort(perm[:n_train])
    val_d = np.sort(perm[n_train:n_train + n_val])
    test_d = np.sort(perm[n_train + n_val:])

    is_train = np.zeros(num_nodes, dtype=bool)
    is_train[train_d] = True
    tr_edges = edges[is_train[edges[:, 0]] & is_train[edges[:, 1]]]
    train_adj = graphsage_normalize_adj(
        (adj_from_edges(tr_edges, num_nodes) > 0).astype(np.float32))
    return Dataset(num_data=num_nodes, train_adj=train_adj,
                   full_adj=full_adj, feats=feats,
                   train_feats=np.asarray(
                       compute_pp_features(train_adj, feats), np.float32),
                   test_feats=np.asarray(
                       compute_pp_features(full_adj, feats), np.float32),
                   labels=labels, train_d=train_d, val_d=val_d,
                   test_d=test_d)


# Reddit's shape (GraphSAGE's Reddit graph): 233k nodes, 602 features, 41
# classes; mean degree 64 for the near-binomial synthetic edge set
REDDIT_NODES = 233_000
REDDIT_AVG_DEG = 64
REDDIT_FEAT_DIM = 602
REDDIT_CLASSES = 41


def reddit_like(num_nodes: int = REDDIT_NODES,
                avg_degree: int = REDDIT_AVG_DEG,
                feature_dim: int = REDDIT_FEAT_DIM,
                num_classes: int = REDDIT_CLASSES,
                seed: int = 0) -> Dataset:
    """The Reddit-shaped synthetic graph of the JAX benchmark
    (bench.py::build_reddit_like, same draws), built in memory with no
    cache: graphsage-normalized uniform random edges, Gaussian features,
    uniform random labels, a 66/10/24 train/val/test split, and the train
    graph restricted to edges among train nodes."""
    rng = np.random.default_rng(seed)
    n_edges = num_nodes * avg_degree // 2
    edges = rng.integers(0, num_nodes, size=(n_edges, 2), dtype=np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    adj01 = (adj_from_edges(edges, num_nodes) > 0).astype(np.float32)
    full_adj = graphsage_normalize_adj(adj01)

    feats = rng.normal(size=(num_nodes, feature_dim)).astype(np.float32)
    labels = np.zeros((num_nodes, num_classes), dtype=np.float32)
    labels[np.arange(num_nodes), rng.integers(0, num_classes, num_nodes)] = 1

    perm = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * 0.66)
    n_val = int(num_nodes * 0.10)
    train_d = np.sort(perm[:n_train])
    val_d = np.sort(perm[n_train:n_train + n_val])
    test_d = np.sort(perm[n_train + n_val:])

    is_train = np.zeros(num_nodes, bool)
    is_train[train_d] = True
    tr_mask = is_train[edges[:, 0]] & is_train[edges[:, 1]]
    train_adj = graphsage_normalize_adj(
        (adj_from_edges(edges[tr_mask], num_nodes) > 0).astype(np.float32))
    return Dataset(num_data=num_nodes, train_adj=train_adj,
                   full_adj=full_adj, feats=feats,
                   train_feats=compute_pp_features(train_adj, feats),
                   test_feats=compute_pp_features(full_adj, feats),
                   labels=labels, train_d=train_d, val_d=val_d,
                   test_d=test_d)


def load_data(cfg) -> Dataset:
    """``--dataset synthetic[:nodes[:dim[:classes]]]`` or ``reddit_like``;
    the reference file formats come in a later port."""
    name = cfg.dataset
    if name == "reddit_like":
        return reddit_like(seed=0)
    if name.startswith("synthetic"):
        parts = name.split(":")[1:]
        kw = {}
        for key, p in zip(("num_nodes", "feature_dim", "num_classes"), parts):
            kw[key] = int(p)
        return synthetic_dataset(normalization=cfg.normalization,
                                 seed=cfg.seed, max_degree=cfg.max_degree,
                                 **kw)
    raise NotImplementedError(
        f"dataset {name!r}: the port loads only synthetic[:N[:D[:C]]] and "
        "reddit_like so far (ROADMAP.md, queue 1: reference data formats)")
