"""Writers of dataset files in the reference's on-disk formats.

The port's own copy of stochastic_gcn_tpu/data/fixtures.py (numpy, scipy,
json and pickle only): the same spec gives the same files, byte for byte.
The real Planetoid and GraphSAGE datasets do not ship with the repository,
so the loaders are exercised on files these functions write:

* Planetoid pickles ``ind.<name>.{x,y,tx,ty,allx,ally,graph,test.index}``
  (reference reader: gcn/utils.py:52-118), with the citeseer
  isolated-test-node quirk on demand (gcn/utils.py:67-76) and the NELL
  layout;
* GraphSAGE JSON ``<prefix>-{G.json,id_map.json,class_map.json,feats.npy}``
  (reference reader: gcn/utils.py:186-298), with broken nodes and
  multi-label class maps.

The graphs carry a planted class signal (homophilous edges and
class-biased sparse features), so a model trained on them learns the
classes, while the files exercise every structural quirk of the formats.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class PlanetoidSpec:
    name: str = "cora"
    num_train: int = 60          # rows of x / y
    num_extra: int = 560         # extra allx rows beyond train; must cover
                                 # the val range (reference HARDCODES val =
                                 # 500 rows after train, 969 for nell —
                                 # gcn/utils.py:87,106)
    num_val: int = 500
    num_test: int = 90
    num_isolated: int = 0        # citeseer-style gaps in the test range
    nell_style: bool = False     # test ids drawn from INSIDE allx (the real
                                 # NELL layout: features = allx only,
                                 # gcn/utils.py:99-115); num_isolated ignored
    feature_dim: int = 128
    num_classes: int = 6
    avg_degree: int = 4
    homophily: float = 0.85
    words_per_node: int = 12
    seed: int = 0


def _planted_features(rng, labels, dim, words_per_node):
    """Sparse binary bag-of-words with class-biased word buckets."""
    n = len(labels)
    c = labels.max() + 1
    bucket = dim // c
    rows, cols = [], []
    for i in range(n):
        lo = labels[i] * bucket
        for _ in range(words_per_node):
            if rng.random() < 0.7:
                w = lo + rng.integers(0, bucket)
            else:
                w = rng.integers(0, dim)
            rows.append(i)
            cols.append(int(w))
    m = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(n, dim))
    m.data[:] = 1.0  # collapse duplicates to binary
    m.sum_duplicates()
    m.data[:] = 1.0
    return m


def _planted_graph(rng, labels, avg_degree, homophily):
    """dict-of-lists symmetric graph with homophilous planted edges."""
    n = len(labels)
    by_class = {}
    for i, c in enumerate(labels):
        by_class.setdefault(int(c), []).append(i)
    graph = {i: [] for i in range(n)}
    edges = set()
    target = n * avg_degree // 2
    while len(edges) < target:
        u = int(rng.integers(0, n))
        if rng.random() < homophily:
            pool = by_class[int(labels[u])]
            v = int(pool[rng.integers(0, len(pool))])
        else:
            v = int(rng.integers(0, n))
        if u == v:
            continue
        e = (min(u, v), max(u, v))
        if e in edges:
            continue
        edges.add(e)
        graph[u].append(v)
        graph[v].append(u)
    return graph


def write_planetoid_fixture(data_dir: str, spec: PlanetoidSpec) -> int:
    """Write ``ind.<name>.*`` files into ``data_dir``; returns num_nodes.

    Layout mirrors the real data exactly (gcn/utils.py:52-66): x/y are the
    train rows, allx/ally the first ``num_train+num_extra`` rows, tx/ty the
    test rows, the graph covers every node, and test.index is a SHUFFLED
    list of test positions.  With ``num_isolated > 0`` the test range has
    that many missing indices (nodes present in the graph but absent from
    tx — the citeseer quirk, gcn/utils.py:67-76).
    """
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(spec.seed)
    n_all = spec.num_train + spec.num_extra
    range_len = 0 if spec.nell_style else spec.num_test + spec.num_isolated
    n = n_all + range_len
    if spec.nell_style:
        assert spec.num_train + spec.num_val + spec.num_test <= n_all
    else:
        assert spec.num_train + spec.num_val <= n_all

    labels = rng.integers(0, spec.num_classes, n).astype(np.int64)
    feats = _planted_features(rng, labels, spec.feature_dim,
                              spec.words_per_node)
    graph = _planted_graph(rng, labels, spec.avg_degree, spec.homophily)

    onehot = np.zeros((n, spec.num_classes), np.int32)
    onehot[np.arange(n), labels] = 1

    # test positions: a shuffled subset of [n_all, n) with the first and
    # last of the range always present (the citeseer fix relies on
    # min/max of the reorder list spanning the range)
    if spec.nell_style:
        # NELL: features == allx; test ids live INSIDE allx, after the val
        # range (gcn/utils.py:99-115 consumes test.index directly as row
        # indices into allx)
        all_range = np.arange(n_all - spec.num_test, n_all)
    else:
        all_range = np.arange(n_all, n)
    if spec.num_isolated and not spec.nell_style:
        middle = all_range[1:-1]
        rng.shuffle(middle)
        chosen = np.concatenate([all_range[:1], all_range[-1:],
                                 middle[:spec.num_test - 2]])
    else:
        chosen = all_range
    test_idx = chosen.copy()
    rng.shuffle(test_idx)

    # tx/ty rows follow test.index FILE order: tx[i] holds the features of
    # node test_idx[i].  (The reference's reorder fix — utils.py:78-83 —
    # permutes vstack(allx, tx) so node test_idx_reorder[i] receives row
    # tx[i]; sorted-order rows would scramble test nodes' features/labels
    # relative to the graph.)
    tx = feats[test_idx]
    ty = onehot[test_idx]
    x = feats[:spec.num_train]
    y = onehot[:spec.num_train]
    allx = feats[:n_all]
    ally = onehot[:n_all]

    def dump(obj, part):
        with open(os.path.join(data_dir, f"ind.{spec.name}.{part}"),
                  "wb") as f:
            pickle.dump(obj, f, protocol=2)

    dump(sp.csr_matrix(x), "x")
    dump(y, "y")
    dump(sp.csr_matrix(tx), "tx")
    dump(ty, "ty")
    dump(sp.csr_matrix(allx), "allx")
    dump(ally, "ally")
    dump(graph, "graph")
    with open(os.path.join(data_dir, f"ind.{spec.name}.test.index"),
              "w") as f:
        f.write("\n".join(str(i) for i in test_idx) + "\n")
    return n


def write_graphsage_fixture(prefix: str, num_nodes: int = 300,
                            feature_dim: int = 32, num_classes: int = 5,
                            avg_degree: int = 5, multilabel: bool = False,
                            num_broken: int = 3, seed: int = 0) -> None:
    """Write ``<prefix>-{G.json,id_map.json,class_map.json,feats.npy}``.

    Format per gcn/utils.py:217-248: node-link JSON with ``val``/``test``
    flags, id/class maps keyed by stringified ids, dense float features.
    ``num_broken`` nodes appear in G.json but not in id_map (the Reddit
    "broken node" removal path, utils.py:237-248).
    """
    rng = np.random.default_rng(seed)
    n = num_nodes
    labels = rng.integers(0, num_classes, n)
    feats = (rng.normal(size=(n, feature_dim))
             + labels[:, None] * 0.5).astype(np.float64)

    graph = _planted_graph(rng, labels, avg_degree, 0.8)
    perm = rng.permutation(n)
    val_ids = set(perm[: n // 6].tolist())
    test_ids = set(perm[n // 6: n // 3].tolist())

    nodes = [{"id": int(i), "val": bool(i in val_ids),
              "test": bool(i in test_ids)} for i in range(n)]
    # broken nodes: in the graph json but absent from id_map/class_map
    for b in range(num_broken):
        nodes.append({"id": int(n + b), "val": False, "test": False})
    links = []
    for u in range(n):
        for v in graph[u]:
            if u < v:
                links.append({"source": int(u), "target": int(v)})
    # a few edges touching broken nodes (must be dropped by both loaders)
    for b in range(num_broken):
        links.append({"source": int(n + b),
                      "target": int(rng.integers(0, n))})

    G = {"directed": False, "multigraph": False, "graph": {},
         "nodes": nodes, "links": links}
    with open(prefix + "-G.json", "w") as f:
        json.dump(G, f)
    with open(prefix + "-id_map.json", "w") as f:
        json.dump({str(i): int(i) for i in range(n)}, f)
    if multilabel:
        lab = {str(i): [int(x) for x in
                        (rng.random(num_classes) < 0.3).astype(int)]
               for i in range(n)}
        for i in range(n):   # keep the planted class always on
            lab[str(i)][int(labels[i])] = 1
    else:
        lab = {str(i): int(labels[i]) for i in range(n)}
    with open(prefix + "-class_map.json", "w") as f:
        json.dump(lab, f)
    np.save(prefix + "-feats.npy", feats)
