"""The port's serving artifacts (stochastic_gcn_tpu_torch/serving.py) on
the CPU, against the port's own ``Trainer.predict`` and the JAX package's
exported predictor.

A JAX ``Trainer`` trains two epochs on a Planetoid fixture (padded-sparse
features, the package defaults but for CV) and saves; the JAX package
exports it and serves from its artifact; the port's ``Trainer`` loads the
same checkpoint, exports and serves from its own artifact.  Tolerances:

* the port's artifact against the port's ``Trainer.predict``, against
  itself across ``scan_batches``, repeated and reordered requests: bitwise;
* against the JAX package's artifact: atol 1e-5 (both converge the CV
  histories, after which CV inference is exact, so only float32 rounding
  differs).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from stochastic_gcn_tpu.config import parse_flags as jax_parse_flags
from stochastic_gcn_tpu.data import fixtures as JF
from stochastic_gcn_tpu.data.loaders import load_data as jax_load_data
from stochastic_gcn_tpu.serving import export_predictor as jax_export
from stochastic_gcn_tpu.serving import load_predictor as jax_load_predictor
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer

from stochastic_gcn_tpu_torch import serving
from stochastic_gcn_tpu_torch.cli import export as export_cli
from stochastic_gcn_tpu_torch.config import from_fields
from stochastic_gcn_tpu_torch.data.graph import PaddedSparseFeatures
from stochastic_gcn_tpu_torch.training.loop import Trainer

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_cfg(cfg):
    return from_fields(dataclasses.asdict(cfg))


def _flags(data_dir, ckpt_dir):
    return ["--dataset", "cora", "--data_dir", data_dir, "--cv", "--test_cv",
            "--degree", "1", "--test_degree", "1", "--batch_size", "64",
            "--test_batch_size", "50", "--hidden1", "16", "--seed", "3",
            "--ckpt_dir", ckpt_dir]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(flags, dataset, JAX artifact predictions on the test split)."""
    root = tmp_path_factory.mktemp("serving")
    data, ckpt = str(root / "data"), str(root / "ckpt")
    JF.write_planetoid_fixture(data, JF.PlanetoidSpec(
        name="cora", num_extra=520, num_test=80, feature_dim=40,
        num_classes=5))
    flags = _flags(data, ckpt)
    cfg = jax_parse_flags(flags)
    ds = jax_load_data(cfg)
    jt = JaxTrainer(cfg, ds)
    for _ in range(2):
        jt.train_epoch()
    jt.save()
    art = jax_export(jt, str(root / "jax_art"))
    want = jax_load_predictor(art).predict(np.asarray(ds.test_d))
    return flags, ds, want


def _port(flags, ds, **over):
    from stochastic_gcn_tpu_torch.config import parse_flags
    tr = Trainer(parse_flags(flags).replace(**over), ds, device="cpu")
    tr.load(load_history=True)
    return tr


def test_artifact_equals_trainer_predict_and_jax(trained, tmp_path):
    flags, ds, want = trained
    tr = _port(flags, ds)
    assert isinstance(tr.test_features, PaddedSparseFeatures)
    path = serving.export_predictor(tr, str(tmp_path / "art"))
    ids = np.asarray(ds.test_d)
    live = tr.predict(ids)
    got = serving.load_predictor(path, device="cpu").predict(ids)
    assert got.dtype == np.float32 and got.shape == (len(ids),
                                                     ds.num_classes)
    np.testing.assert_array_equal(got, live)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_artifact_layout(trained, tmp_path):
    """``state.npz`` and ``manifest.json`` in the JAX layout, no
    ``module.shlo``; bfloat16 arrays as uint16 bit views under "bf16:"."""
    flags, ds, _ = trained
    tr = _port(flags, ds, features_dtype="bfloat16")
    path = serving.export_predictor(tr, str(tmp_path / "art"),
                                    platforms=("cuda", "cpu"))
    assert sorted(os.listdir(path)) == ["manifest.json", "state.npz"]
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    for key in ("num_nodes", "num_classes", "batch_size", "scan_batches",
                "multitask", "names", "torch_version", "seed"):
        assert key in m
    assert m["num_nodes"] == ds.num_data and m["batch_size"] == 50
    assert m["platforms"] == ["cuda", "cpu"] and m["sparse_input"]
    assert from_fields(m["config"]) == tr.cfg
    with np.load(os.path.join(path, "state.npz")) as z:
        keys = set(z.files)
        val = z["bf16:features/val"]
    assert val.dtype == np.uint16
    np.testing.assert_array_equal(
        torch.from_numpy(val.view(np.int16)).view(torch.bfloat16).float(),
        tr.test_features.val.float())
    assert {k.removeprefix("bf16:") for k in keys} == set(m["names"])
    assert "features/idx" in keys and "histories/0/0" in keys
    ids = np.asarray(ds.test_d[:30])
    np.testing.assert_array_equal(
        serving.Predictor(path, device="cpu").predict(ids), tr.predict(ids))


def test_scan_batches_and_request_order(trained, tmp_path):
    """``scan_batches=3`` serves what 1 serves; a request never changes the
    artifact, so repeated and reordered requests are bitwise equal."""
    flags, ds, _ = trained
    tr = _port(flags, ds)
    ids = np.asarray(ds.test_d)
    one = serving.load_predictor(serving.export_predictor(
        tr, str(tmp_path / "a1")), device="cpu")
    three = serving.load_predictor(serving.export_predictor(
        tr, str(tmp_path / "a3"), scan_batches=3), device="cpu")
    assert three.scan_batches == 3
    first = one.predict(ids)
    np.testing.assert_array_equal(three.predict(ids), first)
    np.testing.assert_array_equal(one.predict(ids), first)
    perm = np.random.default_rng(0).permutation(len(ids))
    np.testing.assert_array_equal(one.predict(ids[perm]), first[perm])
    np.testing.assert_array_equal(one.predict(ids[:7]), first[:7])
    np.testing.assert_array_equal(one.predict(ids), first)


def test_export_serves_the_polyak_average(trained, tmp_path):
    flags, ds, _ = trained
    tr = _port(flags, ds, polyak_decay=0.9)
    tr.train_epoch()
    path = serving.export_predictor(tr, str(tmp_path / "art"))
    with np.load(os.path.join(path, "state.npz")) as z:
        w = z["params/dense0/weights"]
    avg = tr.state.avg_params["dense0"]["weights"].numpy()
    np.testing.assert_array_equal(w, avg)
    assert not np.array_equal(w, tr.params["dense0"]["weights"].numpy())
    ids = np.asarray(ds.test_d)
    np.testing.assert_array_equal(
        serving.load_predictor(path, device="cpu").predict(ids),
        tr.predict(ids))


def test_export_warns_on_a_sampled_eval_config(trained, tmp_path):
    flags, ds, _ = trained
    tr = _port(flags, ds, test_cv=False)
    with pytest.warns(UserWarning, match="SAMPLED eval config"):
        serving.export_predictor(tr, str(tmp_path / "art"))
    covering = _port(flags, ds, test_cv=False, test_degree=10000)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        serving.export_predictor(covering, str(tmp_path / "art2"))


def test_export_refreshes_first(trained, tmp_path):
    """The export converges the CV histories under the current weights:
    a trainer that just trained serves exact inference from its artifact."""
    flags, ds, _ = trained
    tr = _port(flags, ds)
    tr.train_epoch()
    calls = []
    orig = tr.evaluate
    tr.evaluate = lambda d: calls.append(len(d)) or orig(d)
    path = serving.export_predictor(tr, str(tmp_path / "art"))
    assert calls == [ds.num_data] * tr.cfg.num_layers
    ids = np.asarray(ds.test_d)
    np.testing.assert_array_equal(
        serving.load_predictor(path, device="cpu").predict(ids),
        tr.predict(ids))


def test_cli_export_end_to_end(trained, tmp_path, capsys):
    flags, ds, want = trained
    out = str(tmp_path / "cli_art")
    path = export_cli.main(["--out", out, "--scan_batches", "2",
                            "--platforms", "cuda", "--device", "cpu"]
                           + flags)
    assert path == out
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"Serving artifact written to: {out}  time= ")
    pred = serving.load_predictor(out, device="cpu")
    assert pred.scan_batches == 2 and pred.manifest["platforms"] == ["cuda"]
    np.testing.assert_allclose(pred.predict(np.asarray(ds.test_d)), want,
                               rtol=0, atol=ATOL)


def test_cuda_predictor_without_cuda_raises(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    flags, ds, _ = trained
    path = serving.export_predictor(_port(flags, ds), str(tmp_path / "art"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.load_predictor(path)


def test_dense_features_serve_too(tmp_path):
    """A dense-feature dataset (graphsage normalization, layer norm, two FC
    layers: the Reddit-shaped recipe at small width) exports and serves
    Trainer.predict's answers."""
    from stochastic_gcn_tpu_torch.config import parse_flags
    cfg = parse_flags(["--dataset", "synthetic:200:12:4", "--cv",
                       "--test_cv", "--degree", "1", "--test_degree", "1",
                       "--normalization", "graphsage", "--layer_norm",
                       "--num_fc_layers", "2", "--hidden1", "16",
                       "--batch_size", "32", "--test_batch_size", "48",
                       "--pad_degree", "8", "--ckpt_dir", str(tmp_path)])
    from stochastic_gcn_tpu_torch.data.loaders import load_data
    ds = load_data(cfg)
    tr = Trainer(cfg, ds, device="cpu")
    tr.train_epoch()
    path = serving.export_predictor(tr, str(tmp_path / "art"))
    ids = np.asarray(ds.test_d)
    pred = serving.load_predictor(path, device="cpu")
    assert pred._graph.pad_degree == tr.graph_full.pad_degree == 8
    np.testing.assert_array_equal(pred.predict(ids), tr.predict(ids))
