"""The reference data formats and padded-sparse features in the port, on
the CPU, against the JAX package.

The same files go through both packages' loaders: each package's fixture
writer writes them (and the two writers' files must be byte-equal), the JAX
loader reads one copy and the port's loader another, so neither reads the
other's cache unless a test says so.  Tolerances:

* fixture files, loaded arrays, caches, ``pad_sparse_features``: exact;
* the GraphSAGE standardiser against scikit-learn's ``StandardScaler``
  through the JAX loader: atol 1e-6;
* the sparse layers and their gradients: rtol = atol = 1e-5 (float32 sums
  in another order);
* a train step, an evaluation, an epoch of each estimator: atol 1e-4;
* sampled CV+PP on a Planetoid fixture: val micro-F1 within 0.03 of JAX's,
  mean of 3 seeds.
"""

import dataclasses
import filecmp
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data import fixtures as JF
from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.data import loaders as JLd
from stochastic_gcn_tpu.models import gcn as JM
from stochastic_gcn_tpu.ops import layers as JL
from stochastic_gcn_tpu.sampler import scheduler as JS
from stochastic_gcn_tpu.training import step as JStep
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer
from stochastic_gcn_tpu.utils import metrics as JMet

from stochastic_gcn_tpu_torch.config import from_fields
from stochastic_gcn_tpu_torch.data import fixtures as F
from stochastic_gcn_tpu_torch.data import graph as G
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.data import preprocess as P
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.ops import layers as L
from stochastic_gcn_tpu_torch.sampler import scheduler as S
from stochastic_gcn_tpu_torch.training import checkpoint as C
from stochastic_gcn_tpu_torch.training import step as St
from stochastic_gcn_tpu_torch.training.loop import Trainer
from stochastic_gcn_tpu_torch.utils import metrics as Met

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_cfg(cfg):
    """The port's own ``Config`` with the fields of the JAX package's."""
    return from_fields(dataclasses.asdict(cfg))


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().cpu().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_matrix(got, want):
    """Exact equality of two feature or adjacency matrices, sparse (CSR
    arrays, dtype) or dense."""
    assert sp.issparse(got) == sp.issparse(want)
    if sp.issparse(want):
        got, want = got.tocsr(), want.tocsr()
        assert got.shape == want.shape and got.dtype == want.dtype
        for part in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, part),
                                          getattr(want, part))
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _same_dataset(got, want):
    assert got.num_data == want.num_data
    for name in ("train_adj", "full_adj", "feats", "train_feats",
                 "test_feats"):
        _same_matrix(getattr(got, name), getattr(want, name))
    for name in ("labels", "train_d", "val_d", "test_d"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


# ------------------------------ the loaders -------------------------------

PLANETOID = {
    "cora": dict(name="cora"),
    "citeseer, isolated test nodes": dict(name="citeseer", num_isolated=7),
    "nell layout": dict(name="nell", nell_style=True, num_extra=1100,
                        num_test=40),
}


@pytest.mark.parametrize("normalization", ["gcn", "graphsage"])
@pytest.mark.parametrize("case", sorted(PLANETOID))
def test_planetoid_loader_matches_jax(tmp_path, case, normalization):
    """Both fixture writers give the same files, and both loaders the same
    arrays; the second load of each reads its cache and gives them again."""
    spec = PLANETOID[case]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    n = JF.write_planetoid_fixture(jdir, JF.PlanetoidSpec(**spec))
    assert F.write_planetoid_fixture(tdir, F.PlanetoidSpec(**spec)) == n
    _same_files(jdir, tdir)
    want = JLd.load_data(Config(dataset=spec["name"], data_dir=jdir,
                                normalization=normalization))
    cfg = port_cfg(Config(dataset=spec["name"], data_dir=tdir,
                          normalization=normalization))
    got = Ld.load_data(cfg)
    assert sp.issparse(got.feats) and got.num_data == n
    _same_dataset(got, want)
    assert os.path.exists(os.path.join(
        tdir, f"{spec['name']}_{normalization}.npz"))
    _same_dataset(Ld.load_data(cfg), want)


GRAPHSAGE = {
    "single-label": ({}, -1),
    "multilabel": ({"multilabel": True}, -1),
    "max_degree": ({"avg_degree": 9}, 3),
}


@pytest.mark.parametrize("case", sorted(GRAPHSAGE))
def test_graphsage_loader_matches_jax(tmp_path, case, capsys):
    """Broken nodes dropped, labels, splits, the train graph, the
    ``--max_degree`` subsample and the standardised features (here equal
    to scikit-learn's, which the JAX loader calls, bit for bit); the two
    lines the JAX loader prints."""
    kw, max_degree = GRAPHSAGE[case]
    jprefix, tprefix = str(tmp_path / "j" / "ppi"), str(tmp_path / "t" / "ppi")
    for prefix, write in ((jprefix, JF.write_graphsage_fixture),
                          (tprefix, F.write_graphsage_fixture)):
        os.makedirs(os.path.dirname(prefix))
        write(prefix, num_nodes=240, feature_dim=12, num_classes=5, **kw)
    _same_files(os.path.dirname(jprefix), os.path.dirname(tprefix))
    over = dict(dataset="ppi", normalization="graphsage",
                max_degree=max_degree)
    want = JLd.load_data(Config(data_dir=os.path.dirname(jprefix), **over))
    want_out = capsys.readouterr().out
    cfg = port_cfg(Config(data_dir=os.path.dirname(tprefix), **over))
    got = Ld.load_data(cfg)
    assert capsys.readouterr().out == want_out
    assert "Removed 3 nodes that lacked proper annotations" in want_out
    assert not sp.issparse(got.feats) and got.num_data == 240
    np.testing.assert_allclose(got.feats, want.feats, rtol=0, atol=1e-6)
    _same_dataset(got, want)
    if max_degree != -1:
        assert "Subsampling edges..." in want_out
        assert np.diff(got.full_adj.indptr).max() <= max_degree
    cache = tprefix + (".npz" if max_degree == -1
                       else f"_deg{max_degree}.npz")
    assert os.path.exists(cache)
    _same_dataset(Ld.load_data(cfg), want)


def _write_youtube(d, n, seed):
    os.makedirs(os.path.join(d, "youtube"))
    rng = np.random.default_rng(seed)
    edges = [(int(a) + 1, int(b) + 1)
             for a, b in rng.integers(0, n, (4 * n, 2)) if a != b]
    with open(os.path.join(d, "youtube", "edges.csv"), "w") as f:
        f.writelines(f"{a},{b}\n" for a, b in edges)
    with open(os.path.join(d, "youtube", "group-edges.csv"), "w") as f:
        for i in range(1, n + 1):
            for g in rng.choice(47, size=int(rng.integers(0, 3)),
                                replace=False):
                f.write(f"{i},{g + 1}\n")


def test_youtube_loader_matches_jax(tmp_path):
    """Edge and group CSVs written here; ``load_data`` dispatches youtube
    to ``load_youtube_data(.., 0.9, ..)``: identity features, the
    seed-shuffled split, the block-diagonal replication."""
    for sub in ("j", "t"):
        _write_youtube(str(tmp_path / sub), 60, seed=5)
    want = JLd.load_data(Config(dataset="youtube", seed=3,
                                data_dir=str(tmp_path / "j")))
    got = Ld.load_data(port_cfg(Config(dataset="youtube", seed=3,
                                       data_dir=str(tmp_path / "t"))))
    assert got.num_data == 120 and sp.issparse(got.feats)
    _same_dataset(got, want)


def _planetoid_both(tmp_path, **spec):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JF.write_planetoid_fixture(jdir, JF.PlanetoidSpec(**spec))
    F.write_planetoid_fixture(tdir, F.PlanetoidSpec(**spec))
    return jdir, tdir


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_caches_cross_packages(tmp_path, writer):
    """A cache the one package writes, the other loads to the same arrays,
    for sparse (Planetoid) and dense (GraphSAGE) features."""
    jdir, tdir = _planetoid_both(tmp_path, name="cora", num_extra=500,
                                 num_test=40, feature_dim=40)
    src = jdir if writer == "jax" else tdir
    cfg = Config(dataset="cora", data_dir=src)
    first = (JLd if writer == "jax" else Ld).load_data(
        cfg if writer == "jax" else port_cfg(cfg))
    npz = os.path.join(src, "cora_gcn.npz")
    other = Ld if writer == "jax" else JLd
    _same_dataset(other._load_cached(npz), first)

    prefix = str(tmp_path / "sage" / "reddit")
    os.makedirs(os.path.dirname(prefix))
    JF.write_graphsage_fixture(prefix, num_nodes=150, feature_dim=7)
    cfg = Config(dataset="reddit", normalization="graphsage",
                 data_dir=os.path.dirname(prefix))
    first = (JLd if writer == "jax" else Ld).load_data(
        cfg if writer == "jax" else port_cfg(cfg))
    _same_dataset(other._load_cached(prefix + ".npz"), first)


@pytest.mark.parametrize("dense", [False, True])
def test_reference_caches_without_the_flag_load_alike(tmp_path, dense):
    """The reference's own caches have no ``sparse_feats`` key: the layout
    is read from the keys (dense GraphSAGE features, sparse Planetoid)."""
    rng = np.random.default_rng(3)
    n = 25
    adj = sp.csr_matrix(rng.random((n, n)).astype(np.float32)
                        * (rng.random((n, n)) < 0.3))
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    if not dense:
        feats = sp.csr_matrix(feats * (rng.random((n, 6)) < 0.3))
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    keys = dict(num_data=n, labels=labels,
                train_data=np.arange(5, dtype=np.int32),
                val_data=np.arange(5, 15, dtype=np.int32),
                test_data=np.arange(15, 25, dtype=np.int32))
    mats = [("train_adj", adj), ("full_adj", adj)]
    if dense:
        keys.update(feats=feats, train_feats=adj.dot(feats),
                    test_feats=adj.dot(feats))
    else:
        mats += [("feats", feats), ("train_feats", adj.dot(feats)),
                 ("test_feats", adj.dot(feats))]
    for nm, m in mats:
        keys.update({f"{nm}_data": m.data, f"{nm}_indices": m.indices,
                     f"{nm}_indptr": m.indptr,
                     f"{nm}_shape": np.asarray(m.shape)})
    path = str(tmp_path / "ref.npz")
    with open(path, "wb") as f:
        np.savez(f, **keys)
    got, want = Ld._load_cached(path), JLd._load_cached(path)
    assert sp.issparse(got.feats) == (not dense)
    _same_dataset(got, want)


def test_standard_scale_matches_scikit_learn():
    from sklearn.preprocessing import StandardScaler
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(300, 9)) * rng.uniform(0.1, 50, 9)
         + rng.uniform(-20, 20, 9)).astype(np.float32)
    x[:, 4] = 3.25                               # a constant column
    rows = np.sort(rng.choice(300, 200, replace=False))
    want = StandardScaler().fit(x[rows]).transform(x)
    got = P.standard_scale(x, rows)
    assert got.dtype == np.float32 and not np.shares_memory(got, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 4], 0.0)


def test_row_normalize_and_data_augmentation_match_jax():
    rng = np.random.default_rng(7)
    x = sp.csr_matrix(rng.random((20, 8)) * (rng.random((20, 8)) < 0.4))
    _same_matrix(P.row_normalize_features(x),
                 JLd.row_normalize_features(x))
    adj = sp.csr_matrix(rng.random((20, 20)).astype(np.float32)
                        * (rng.random((20, 20)) < 0.2))
    for feats in (x.astype(np.float32), rng.normal(size=(20, 3))):
        ids = (np.arange(0, 10), np.arange(10, 15), np.arange(15, 20))
        for n_rep in (1, 2):
            got = P.data_augmentation(20, adj, adj * 2, feats, np.eye(20),
                                      *ids, n_rep=n_rep)
            want = JLd.data_augmentation(20, adj, adj * 2, feats, np.eye(20),
                                         *ids, n_rep=n_rep)
            assert got[0] == want[0]
            for a, b in zip(got[1:], want[1:]):
                _same_matrix(a, b)


def test_averager_matches_jax():
    got, want = Met.Averager(3), JMet.Averager(3)
    assert np.isnan(got.mean()) and np.isnan(want.mean())
    for v in (1.0, 4, 2.5, np.float32(7), 0.5):
        got.add(v)
        want.add(v)
        assert got.mean() == want.mean() and got.window == want.window


def test_load_data_dispatch(tmp_path, monkeypatch):
    """Every name reaches the loader the JAX dispatch gives it; an unknown
    name is a GraphSAGE prefix under ``data_dir``."""
    calls = []
    for name in ("load_gcn_data", "load_youtube_data",
                 "load_graphsage_data"):
        monkeypatch.setattr(Ld, name, lambda *a, name=name: calls.append(
            (name, a[:-1])))
    for ds in ("cora", "citeseer", "pubmed", "nell", "youtube", "ppi"):
        Ld.load_data(port_cfg(Config(dataset=ds, data_dir=str(tmp_path))))
    assert calls == [("load_gcn_data", (n,)) for n in
                     ("cora", "citeseer", "pubmed", "nell")] + [
        ("load_youtube_data", ("youtube", 0.9)),
        ("load_graphsage_data", (os.path.join(str(tmp_path), "ppi"),))]
    assert Ld.load_data(port_cfg(Config(
        dataset="synthetic:50:4:3"))).num_data == 50


# --------------------------- padded-sparse rows ---------------------------

def _tied_rows(rng, n, dim, long_rows):
    """A CSR matrix whose first rows are longer than the others and hold
    values of equal magnitude, both signs, and duplicates."""
    rows, cols, vals = [], [], []
    for r in range(n):
        k = int(rng.integers(12, dim)) if r in long_rows \
            else int(rng.integers(0, 6))
        c = rng.choice(dim, size=k, replace=False)
        v = rng.choice([-2.0, -1.0, 0.5, 1.0, 2.0], size=k)
        rows += [r] * k
        cols += list(c)
        vals += list(v)
    return sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)),
                         shape=(n, dim))


@pytest.mark.parametrize("nnz_cap, num_nodes", [(8, None), (1024, None),
                                               (3, 45), (1, None)])
def test_pad_sparse_features_matches_jax(nnz_cap, num_nodes):
    """Rows below and above the cap, ties in |value| broken as
    ``np.argsort`` breaks them, a float64 input, sentinel rows past the
    matrix's own."""
    x = _tied_rows(np.random.default_rng(8), 40, 30, {0, 3, 17, 39})
    want = JG.pad_sparse_features(x, nnz_cap, num_nodes)
    got = G.pad_sparse_features(x, nnz_cap, num_nodes)
    assert got.dim == want.dim == 30
    assert got.idx.shape == want.idx.shape
    assert got.idx.dtype == torch.int32 and got.val.dtype == torch.float32
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))
    n = num_nodes or 40
    assert (got.idx.numpy()[40:] == 30).all() and got.idx.shape[0] == n + 1


def test_pad_sparse_features_of_an_empty_matrix():
    x = sp.csr_matrix((4, 5), dtype=np.float32)
    got = G.pad_sparse_features(x)
    want = JG.pad_sparse_features(x)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert tuple(got.idx.shape) == (5, 1)


# ------------------------------ the layers --------------------------------

def _sparse_inputs(seed, rows, dim, cap, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = sp.random(rows, dim, density=0.25, random_state=seed,
                  format="csr", dtype=np.float64)
    x.data = rng.normal(size=x.nnz)
    jx = JG.pad_sparse_features(x, cap)
    tx = G.pad_sparse_features(x, cap)
    if dtype != np.float32:
        jx = dataclasses.replace(jx, val=jx.val.astype(jnp.bfloat16))
        tx = tx.replace(val=tx.val.to(torch.bfloat16))
    return x, jx, tx


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_sparse_matmul_matches_jax_with_gradient(dtype):
    x, jx, tx = _sparse_inputs(9, 23, 17, 5, dtype)
    rng = np.random.default_rng(10)
    w = rng.normal(size=(17, 6)).astype(np.float32)
    g = rng.normal(size=(24, 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda w_: JL.matmul(jx, w_), jnp.asarray(w))
    tw = T(w).requires_grad_()
    got = L.matmul(tx, tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(want), **TOL)
    (got * T(g)).sum().backward()
    np.testing.assert_allclose(N(tw.grad), np.asarray(vjp(jnp.asarray(g))[0]),
                               **TOL)


def test_sparse_matmul_equals_the_dense_product():
    """Rows truncated by nothing: the padded product is ``X @ W`` and the
    sentinel row is zero."""
    x, _, tx = _sparse_inputs(11, 30, 12, 1024)
    w = np.random.default_rng(12).normal(size=(12, 4)).astype(np.float32)
    got = N(L.matmul(tx, T(w)))
    np.testing.assert_allclose(got[:30], x.toarray().astype(np.float32) @ w,
                               **TOL)
    np.testing.assert_array_equal(got[30], 0.0)


def test_sparse_dropout():
    """At keep 1 the identity; below it the columns stay, each stored value
    is kept with probability p and scaled by 1/p (the share kept within 5
    standard errors over 40,000 values), as the JAX layer does."""
    _, jx, tx = _sparse_inputs(13, 9, 20, 8)
    assert L.dropout(torch.Generator(), tx, 1.0) is tx
    assert JL.dropout(jax.random.PRNGKey(0), jx, 1.0) is jx
    ones = G.PaddedSparseFeatures(
        idx=torch.zeros((400, 100), dtype=torch.int32),
        val=torch.ones((400, 100)), dim=7)
    p = 0.7
    out = L.dropout(torch.Generator().manual_seed(1), ones, p)
    assert isinstance(out, G.PaddedSparseFeatures) and out.dim == 7
    assert out.idx is ones.idx
    v = out.val.numpy()
    assert set(np.unique(v)) <= {0.0, np.float32(1.0 / p)}
    kept = (v != 0).mean()
    assert abs(kept - p) < 5 * np.sqrt(p * (1 - p) / v.size)
    jout = JL.dropout(jax.random.PRNGKey(1), G_to_jax(ones), p)
    assert abs((np.asarray(jout.val) != 0).mean() - kept) < 0.02


def G_to_jax(x):
    return JG.PaddedSparseFeatures(idx=jnp.asarray(x.idx.numpy()),
                                   val=jnp.asarray(N(x.val)), dim=x.dim)


@pytest.mark.parametrize("norm", [True, False])
def test_sparse_aug_dropout_dense_matches_jax(norm):
    _, jx, tx = _sparse_inputs(14, 19, 13, 6)
    rng = np.random.default_rng(15)
    p = {"weights": rng.normal(size=(13, 5)).astype(np.float32)}
    if norm:
        p["offset"] = rng.normal(size=(1, 5)).astype(np.float32) * 0.1
        p["scale"] = 1 + rng.normal(size=(1, 5)).astype(np.float32) * 0.1
    want = JL.aug_dropout_dense({k: jnp.asarray(v) for k, v in p.items()},
                                jax.random.PRNGKey(0), jx, 1.0, JL.relu, norm)
    got = L.aug_dropout_dense({k: T(v) for k, v in p.items()},
                              torch.Generator(), tx, 1.0, L.relu, norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(N(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("norm", [True, False])
def test_sparse_det_dropout_fc_matches_jax_with_gradients(norm):
    """The variance stays padded-sparse with squared values; its linear
    step gathers ``W^2``, so the gradient reaches ``W`` through both."""
    _, jx, tx = _sparse_inputs(16, 21, 15, 7)
    rng = np.random.default_rng(17)
    p = {"weights": rng.normal(size=(15, 6)).astype(np.float32) * 0.4}
    if norm:
        p["offset"] = rng.normal(size=(1, 6)).astype(np.float32) * 0.1
        p["scale"] = 1 + rng.normal(size=(1, 6)).astype(np.float32) * 0.1
    g = rng.normal(size=(2, 22, 6)).astype(np.float32)

    def jloss(params):
        out = JL.det_dropout_fc(params, jx, 0.8, norm)
        return sum(jnp.sum(o * gi) for o, gi in zip(out, g)), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: T(v).requires_grad_() for k, v in p.items()}
    got = L.det_dropout_fc(tp, tx, 0.8, norm)
    for o, w in zip(got, want):
        assert np.isfinite(N(o)).all()
        np.testing.assert_allclose(N(o), np.asarray(w), **TOL)
    sum((o * T(gi)).sum() for o, gi in zip(got, g)).backward()
    for k in p:
        np.testing.assert_allclose(N(tp[k].grad), np.asarray(jgrad[k]),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------ the model ---------------------------------

def test_slice_inputs_and_densify_match_jax():
    """Rows of the field, a sentinel id reading ``(dim, 0)``; the densified
    rows of the ``--nopreprocess`` fallback."""
    x, jx, tx = _sparse_inputs(18, 30, 11, 4)
    field = np.array([3, 0, 30, 29, 3, 30], np.int32)
    want = JM._slice_inputs(jx, jnp.asarray(field), num_nodes=30)
    got = M._slice_inputs(tx, T(field), 30)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))
    assert (got.idx.numpy()[2] == 11).all() and (got.val.numpy()[2] == 0).all()
    dense = N(M._densify(got))
    full = np.vstack([x.toarray(), np.zeros((1, 11))])[field]
    np.testing.assert_allclose(dense, full, **TOL)
    taps = []
    M._tap(taps, "input", got)
    np.testing.assert_allclose(float(taps[0][1]), float(np.mean(np.asarray(
        want.val))), **TOL)


def _planetoid(tmp_path, **spec):
    """The cora-layout fixture, loaded by the JAX loader."""
    d = str(tmp_path / "planetoid")
    JF.write_planetoid_fixture(d, JF.PlanetoidSpec(**spec))
    return d, JLd.load_data(Config(dataset=spec.get("name", "cora"),
                                   data_dir=d))


@pytest.fixture(scope="module")
def cora(tmp_path_factory):
    return _planetoid(tmp_path_factory.mktemp("cora"), num_extra=520,
                      num_test=60, feature_dim=48, num_classes=5,
                      words_per_node=8)


@pytest.mark.parametrize("preprocess", [True, False])
def test_sparse_train_step_and_evaluation_match_jax(cora, preprocess):
    """One train step on a JAX-produced pack and an evaluation epoch, both
    packages on the padded-sparse features of a Planetoid fixture: with PP
    the first dense layer takes them, without it they are densified ahead
    of the aggregator."""
    d, ds = cora
    n = ds.num_data
    cfg = Config(dataset="cora", data_dir=d, batch_size=32, degree=2,
                 test_degree=2, cv=True, test_cv=True, hidden1=16,
                 weight_decay=5e-4, dropout=0.0, seed=1,
                 preprocess=preprocess, test_preprocess=preprocess,
                 history_dtype="float32")
    feats = ds.train_feats if preprocess else ds.feats
    jspec = JM.build_model_spec(cfg, ds.feature_dim, ds.num_classes,
                                preprocess, True, False, True)
    spec = M.build_model_spec(port_cfg(cfg), ds.feature_dim, ds.num_classes,
                              preprocess, True, False, True)
    assert repr(spec.specs) == repr(jspec.specs)
    jf, tf = JG.pad_sparse_features(feats, 1024, n), \
        G.pad_sparse_features(feats, 1024, n)
    jg, tg = JG.pad_csr(ds.train_adj), G.pad_csr(ds.train_adj)
    rng = np.random.default_rng(19)
    hist = [rng.normal(size=(-(-(n + 1) // 8) * 8, dh)).astype(np.float32)
            for dh in jspec.history_dims]
    batch = np.r_[rng.choice(ds.train_d, 28, replace=False),
                  [n] * 4].astype(np.int32)
    jpack = JS.schedule(jax.random.PRNGKey(3), jg, jnp.asarray(batch),
                        (2,) * jspec.num_agg_layers, cv=True, dedup=False)
    jparams = JM.init_params(jax.random.PRNGKey(4), jspec)
    jstate = JStep.TrainState(
        params=jparams, opt_state=JStep.make_optimizer(cfg).init(jparams),
        histories=tuple((jnp.asarray(h),) for h in hist),
        step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(JStep.build_train_step(cfg, jspec,
                                           (2,) * jspec.num_agg_layers, n))
    jstate, jm = jstep(jstate, jg, jf, JG.dense_rows(ds.labels, n),
                       jnp.zeros((n + 1,)), jnp.asarray(batch),
                       jax.random.PRNGKey(0), pack=jpack)

    params = C.params_from_jax(_np_tree(jparams))
    state = St.TrainState(
        params=params, opt_state=St.make_optimizer(port_cfg(cfg)).init(params),
        histories=tuple((T(h),) for h in hist),
        step=torch.zeros((), dtype=torch.int32))
    pack = S.BatchFields(
        fields=tuple(T(f) for f in jpack.fields),
        layers=tuple(S.LayerSample(slot_pos=T(ls.slot_pos),
                                   slot_w=T(ls.slot_w), slot_aw=None,
                                   scales=T(ls.scales))
                     for ls in jpack.layers))
    step = St.build_train_step(port_cfg(cfg), spec,
                               (2,) * spec.num_agg_layers, n)
    state, m = step(state, tg, tf, G.dense_rows(ds.labels, n), T(batch),
                    torch.Generator(), pack=pack)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **STEP_TOL)
    for l, k in St.param_keys(params):
        np.testing.assert_allclose(N(state.params[l][k]),
                                   np.asarray(jstate.params[l][k]),
                                   **STEP_TOL)
    for hl, jhl in zip(state.histories, jstate.histories):
        np.testing.assert_allclose(N(hl[0]), np.asarray(jhl[0]), **STEP_TOL)

    # an evaluation epoch over the validation ids, exhaustive degree
    ecfg = cfg.replace(test_degree=10000)
    bm = np.full((3 * 48,), n, np.int32)
    bm[:len(ds.val_d[:130])] = ds.val_d[:130]
    bm = bm.reshape(3, 48)
    jeval = JStep.make_eval_epoch(ecfg, jspec, (10000,) * jspec.num_agg_layers,
                                  n, with_preds=True)
    jg_full = JG.pad_csr(ds.full_adj)
    _, jout = jeval(jstate.params, jstate.histories, jg_full, jf,
                    JG.dense_rows(ds.labels, n), jnp.zeros((n + 1,)),
                    jnp.asarray(bm), jax.random.PRNGKey(1))
    teval = St.build_eval_epoch(port_cfg(ecfg), spec,
                                (10000,) * spec.num_agg_layers, n,
                                with_preds=True)
    with torch.no_grad():
        _, out = teval(state.params, state.histories, G.pad_csr(ds.full_adj),
                       tf, G.dense_rows(ds.labels, n), T(bm),
                       torch.Generator())
    np.testing.assert_allclose(N(out["losses"]), np.asarray(jout["losses"]),
                               **STEP_TOL)
    np.testing.assert_allclose(N(out["preds"]), np.asarray(jout["preds"]),
                               **STEP_TOL)


# --------------------- the Trainer, every estimator -----------------------

ESTIMATORS = {
    "NS+PP": dict(cv=False, test_cv=False),
    "CV+PP": dict(cv=True, test_cv=True),
    "CVD+PP": dict(cv=True, test_cv=True, cvd=True, test_cvd=True),
    "det-dropout+PP": dict(cv=True, test_cv=True, det_dropout=True),
    "IS+PP": dict(cv=False, test_cv=False, importance=True,
                  test_importance=True, is_approx_topk=False),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_trainer_on_sparse_features_matches_jax(cora, tmp_path, name):
    """Exhaustive degree and no dropout, so both Trainers run the same
    computation from the same weights: a train epoch, an evaluation, the
    activation moments, predictions and the gradient-variance harness, on
    padded-sparse features."""
    d, ds = cora
    cfg = Config(dataset="cora", data_dir=d, batch_size=64,
                 test_batch_size=128, degree=10000, test_degree=10000,
                 hidden1=16, dropout=0.0, layer_norm=True, seed=2,
                 history_dtype="float32", ckpt_dir=str(tmp_path),
                 **ESTIMATORS[name])
    jt = JaxTrainer(cfg, ds)
    tt = Trainer(port_cfg(cfg), ds, device="cpu")
    assert isinstance(tt.train_features, G.PaddedSparseFeatures)
    np.testing.assert_array_equal(tt.train_features.idx.numpy(),
                                  np.asarray(jt.train_features.idx))
    init = _np_tree(jt.state.params)
    for l, k in St.param_keys(tt.params):
        tt.params[l][k].copy_(T(init[l][k]))
    tt.state.opt_state = C.opt_state_from_jax(_np_tree(jt.state.opt_state))
    jloss = jt.train_epoch()[0]
    loss = tt.train_epoch()[0]
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-4)
    final = _np_tree(jt.state.params)
    for l, k in St.param_keys(tt.params):
        np.testing.assert_allclose(N(tt.params[l][k]), final[l][k], rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(tt.evaluate(ds.val_d)[:4],
                               jt.evaluate(ds.val_d)[:4], rtol=0, atol=1e-4)
    for train in (True, False):
        want, got = jt.activation_stats(train=train), \
            tt.activation_stats(train=train)
        assert sorted(got) == sorted(want)
        for label, stats in want.items():
            for k, v in stats.items():
                np.testing.assert_allclose(got[label][k], v, rtol=1e-4,
                                           atol=1e-4)
    ids = np.asarray(ds.test_d)
    np.testing.assert_allclose(tt.predict(ids), jt.predict(ids), rtol=0,
                               atol=1e-4)
    want = jt.gradient_variance(times=2, log=lambda s: None)
    got = tt.gradient_variance(times=2, log=lambda s: None)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4)


def test_dense_input_still_densifies(cora):
    d, ds = cora
    cfg = Config(dataset="cora", data_dir=d, dense_input=True, cv=True,
                 test_cv=True)
    tt = Trainer(port_cfg(cfg), ds, device="cpu")
    jt = JaxTrainer(cfg, ds)
    assert isinstance(tt.train_features, torch.Tensor)
    np.testing.assert_array_equal(N(tt.train_features),
                                  np.asarray(jt.train_features))
    bf = Trainer(port_cfg(cfg.replace(dense_input=False,
                                      features_dtype="bfloat16")), ds,
                 device="cpu")
    assert bf.test_features.val.dtype == torch.bfloat16
    jbf = JaxTrainer(cfg.replace(dense_input=False,
                                 features_dtype="bfloat16"), ds)
    np.testing.assert_array_equal(N(bf.test_features.val),
                                  np.asarray(jbf.test_features.val,
                                             np.float32))


def test_gradvar_copies_the_sparse_pp_features(cora):
    """``--gradvar`` evaluates on the train graph with the train side's PP
    features, copied."""
    d, ds = cora
    cfg = port_cfg(Config(dataset="cora", data_dir=d, gradvar=True))
    tt = Trainer(cfg, ds, device="cpu")
    want = G.pad_sparse_features(ds.train_feats, cfg.feat_nnz_cap,
                                 ds.num_data)
    np.testing.assert_array_equal(tt.test_features.idx.numpy(),
                                  want.idx.numpy())
    np.testing.assert_array_equal(tt.test_features.val.numpy(),
                                  want.val.numpy())


def test_sampled_cvpp_on_a_planetoid_fixture_matches_jax(tmp_path):
    """The package defaults (gcn normalization, sparse PP features) with
    CV+PP at degree 1: the sampling streams differ, so the runs are held
    by their outcome, val micro-F1 averaged over 3 seeds."""
    d, ds = _planetoid(tmp_path, num_train=300, num_extra=700, num_test=200,
                       feature_dim=60, num_classes=4, words_per_node=6)
    f1 = {"jax": [], "port": []}
    for seed in (1, 2, 3):
        cfg = Config(dataset="cora", data_dir=d, batch_size=64, degree=1,
                     test_degree=1, cv=True, test_cv=True, hidden1=16,
                     test_batch_size=256, seed=seed, ckpt_dir=str(tmp_path))
        for name, tr in (("jax", JaxTrainer(cfg, ds)),
                         ("port", Trainer(port_cfg(cfg), ds, device="cpu"))):
            for _ in range(8):
                tr.train_epoch()
            tr.predict(ds.val_d)                 # converge CV inference
            f1[name].append(tr.evaluate(ds.val_d)[2])
    mean = {k: float(np.mean(v)) for k, v in f1.items()}
    assert mean["jax"] > 0.6, f1           # the task was learnt
    assert abs(mean["port"] - mean["jax"]) <= 0.03, f1


def test_cli_train_on_a_planetoid_fixture(tmp_path, capsys):
    """``--dataset cora`` with no other flag but the data directory: the
    package default trains end to end from the files."""
    from stochastic_gcn_tpu_torch.cli import train as train_cli
    d = str(tmp_path / "data")
    F.write_planetoid_fixture(d, F.PlanetoidSpec(name="cora", num_extra=520,
                                                 num_test=40,
                                                 feature_dim=32))
    tr = train_cli.main(["--dataset", "cora", "--data_dir", d, "--epochs",
                         "1", "--ckpt_dir", str(tmp_path / "ckpt"),
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert isinstance(tr.train_features, G.PaddedSparseFeatures)
    assert "Optimization Finished!" in out
    assert out.count("Test set results: cost= ") == 1


def test_pickles_hold_what_the_reference_reads(tmp_path):
    """The fixture's pickles load as the reference loads them (latin1):
    sparse x/tx/allx, dense one-hot y/ty/ally, a dict-of-lists graph."""
    d = str(tmp_path)
    F.write_planetoid_fixture(d, F.PlanetoidSpec(name="pubmed"))
    with open(os.path.join(d, "ind.pubmed.allx"), "rb") as f:
        allx = pickle.load(f, encoding="latin1")
    with open(os.path.join(d, "ind.pubmed.graph"), "rb") as f:
        graph = pickle.load(f, encoding="latin1")
    assert sp.issparse(allx) and allx.shape == (620, 128)
    assert isinstance(graph, dict) and len(graph) == 710
