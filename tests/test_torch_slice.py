"""The ported serving slice end to end, on the CPU, against the JAX package.

A JAX ``Trainer`` with the benchmark recipe's flags at small width trains
two epochs and saves a checkpoint; the port's ``Trainer`` loads it and
must serve the same predictions as JAX ``Trainer.predict`` (atol 1e-5:
both converge the CV histories, after which CV inference is exact
inference, so only float32 rounding differs).  Also: the port's predict
equals an exact forward, refreshes incrementally, and round-trips through
``cli/infer.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stochastic_gcn_tpu.config import Config
from stochastic_gcn_tpu.data.loaders import load_data as jax_load_data
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer

from stochastic_gcn_tpu_torch.config import from_fields
from stochastic_gcn_tpu_torch.cli import infer
from stochastic_gcn_tpu_torch.models import gcn as M
from stochastic_gcn_tpu_torch.ops import cuda_spmm as K
from stochastic_gcn_tpu_torch.ops import layers as L
from stochastic_gcn_tpu_torch.training.loop import Trainer


def port_cfg(cfg):
    """The port's own ``Config`` with the fields of the JAX package's."""
    return from_fields(dataclasses.asdict(cfg))

DATASET = "synthetic:240:16:5"
# the eval half of bench.py's recipe at small width and batch
FLAGS = ["--dataset", DATASET, "--batch_size", "32", "--degree", "1",
         "--test_degree", "1", "--cv", "--test_cv", "--hidden1", "16",
         "--normalization", "graphsage", "--layer_norm",
         "--num_fc_layers", "2", "--weight_decay", "0", "--dropout", "0.2",
         "--pad_degree", "64", "--seed", "1", "--test_batch_size", "48"]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(cfg, ds, JAX predictions on the test split, ckpt dir)."""
    from stochastic_gcn_tpu.config import parse_flags
    ckpt = tmp_path_factory.mktemp("ckpt")
    cfg = parse_flags(FLAGS + ["--ckpt_dir", str(ckpt)])
    ds = jax_load_data(cfg)
    tr = JaxTrainer(cfg, ds)
    for _ in range(2):
        tr.train_epoch()
    tr.save()
    return cfg, ds, tr.predict(np.asarray(ds.test_d)), str(ckpt)


def _port(cfg, ds):
    tr = Trainer(port_cfg(cfg), ds, device="cpu")
    tr.load(load_history=True)
    return tr


def test_predict_matches_jax_checkpoint(trained):
    cfg, ds, want, _ = trained
    tr = _port(cfg, ds)
    got = tr.predict(np.asarray(ds.test_d))
    assert got.shape == want.shape == (len(ds.test_d), ds.num_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_predict_equals_exact_inference(trained):
    """After the refresh, CV predictions equal the exact forward: the dense
    chain on every node, then the full ``A_full . H`` aggregation."""
    cfg, ds, _, _ = trained
    tr = _port(cfg, ds)
    ids = np.asarray(ds.test_d)[::-1].copy()
    got = tr.predict(ids)
    g = tr.graph_full
    h = tr.test_features
    for s in tr.test_spec.specs:
        if isinstance(s, M.DenseSpec):
            h = L.dense(tr.params[s.name], h,
                        L.relu if s.relu else L.identity, s.norm)
        elif isinstance(s, M.AggSpec):
            h = torch.cat([h, K.hbm_gather_aggregate_ref(h, g.nbr, g.w)], 1)
    exact = M.predict(tr.test_spec, h[torch.from_numpy(ids).long()])
    np.testing.assert_allclose(got, exact.numpy(), rtol=0, atol=ATOL)


def test_predict_refresh_is_incremental(trained):
    """The num_layers refresh passes run once per weight change; load()
    re-arms them and refresh="force" overrides."""
    cfg, ds, _, _ = trained
    tr = _port(cfg, ds)
    ids = np.asarray(ds.test_d[:10])
    calls = []
    orig = tr.evaluate
    tr.evaluate = lambda d: calls.append(len(d)) or orig(d)
    p1 = tr.predict(ids)
    assert calls == [ds.num_data] * cfg.num_layers
    p2 = tr.predict(ids)
    assert len(calls) == cfg.num_layers
    np.testing.assert_allclose(p2, p1, rtol=0, atol=1e-7)
    tr.predict(ids, refresh="force")
    assert len(calls) == 2 * cfg.num_layers
    tr.load()
    tr.predict(ids)
    assert len(calls) == 3 * cfg.num_layers


def test_run_tests_converges(trained, capsys):
    """num_layers + 1 Test passes: the last two agree (CV converged)."""
    cfg, ds, _, _ = trained
    tr = _port(cfg, ds)
    tr.run_tests()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Test set results")]
    assert len(lines) == cfg.num_layers + 1
    assert lines[-1].split("time=")[0] == lines[-2].split("time=")[0]


def test_cli_infer_roundtrip(trained, tmp_path):
    cfg, ds, want, ckpt = trained
    out = str(tmp_path / "preds.npz")
    flags = FLAGS + ["--ckpt_dir", ckpt, "--device", "cpu"]
    infer.main(["--nodes", "test", "--out", out] + flags)
    z = np.load(out)
    np.testing.assert_array_equal(z["ids"], ds.test_d)
    np.testing.assert_allclose(z["probs"], want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(z["pred"], z["probs"].argmax(1))
    some = ",".join(str(i) for i in ds.test_d[:5])
    probs = infer.main(["--nodes", some] + flags)
    np.testing.assert_allclose(probs, want[:5], rtol=0, atol=ATOL)


def test_cuda_trainer_without_cuda_raises(trained):
    cfg, ds, _, _ = trained
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(port_cfg(cfg), ds, device="cuda")


def test_unported_options_raise(trained):
    """Nothing is refused as unported: a ``--ckpt_async`` Trainer loads the
    JAX checkpoint and serves JAX's predictions.  ``--dp 2`` and ``--tp
    2`` need a process group of two ranks, so without one they raise
    rather than train on one device; ``--dp_hosts 2`` does not tile
    ``--dp 1``."""
    cfg, ds, want, _ = trained
    tr = _port(cfg.replace(ckpt_async=True), ds)
    np.testing.assert_allclose(tr.predict(np.asarray(ds.test_d)), want,
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        Trainer(port_cfg(cfg.replace(tp=2)), ds, device="cpu")
    with pytest.raises(ValueError, match="hosts"):
        Trainer(port_cfg(cfg.replace(dp_hosts=2)), ds, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        Trainer(port_cfg(cfg.replace(dp=2, batch_size=cfg.batch_size * 2,
                                     test_batch_size=cfg.test_batch_size
                                     * 2)), ds, device="cpu")


def test_predict_matches_jax_on_a_capped_graph(tmp_path):
    """``--pad_degree 8`` on a graph with rows of up to 16 neighbours: both
    Trainers cap their graphs with ``cap_adj_degree`` and must keep the same
    edges, so a JAX checkpoint served by the port gives JAX's predictions."""
    from stochastic_gcn_tpu.config import parse_flags
    cfg = parse_flags(FLAGS + ["--ckpt_dir", str(tmp_path)]).replace(
        pad_degree=8)
    ds = jax_load_data(cfg)
    deg = np.diff(ds.full_adj.indptr)
    assert (deg > 8).sum() >= 20 and deg.max() >= 14
    jt = JaxTrainer(cfg, ds)
    for _ in range(2):
        jt.train_epoch()
    jt.save()
    want = jt.predict(np.asarray(ds.test_d))
    tr = _port(cfg, ds)
    assert tr.graph_full.pad_degree == jt.graph_full.pad_degree == 8
    np.testing.assert_array_equal(tr.graph_full.nbr.numpy(),
                                  np.asarray(jt.graph_full.nbr))
    got = tr.predict(np.asarray(ds.test_d))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
