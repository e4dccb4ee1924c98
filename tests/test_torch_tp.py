"""Tensor parallelism of the port (``--tp``) on the CPU: gloo groups of
``dp x tp`` ranks against the ``--dp`` run of the same seed.

One 4-rank group runs every case at dp 2 x tp 2, then draws the train
schedules on every rank and runs ``cli/train.py`` as one rank of the group;
one 2-rank group runs every case at dp 2 and at dp 1 x tp 2 and loads the
dp 2 x tp 2 checkpoint at dp 1 x tp 2; the one-process runs happen here.
The rank functions are the port's own (stochastic_gcn_tpu_torch/
parallel/checks.py), in fresh processes that import nothing of this file
(it imports JAX).  Every case keeps float32 histories and dedup-compacted
fields (duplicate history writes are unordered) and a Polyak average.

* dp 2 x tp 2 against dp 2, and dp 1 x tp 2 against one process, rtol
  1e-4 / atol 1e-6: the loss and accuracy of every step of 2 epochs; the
  params, Adam moments, Polyak average, train and eval histories,
  gathered whole; the validation evaluation and ``predict``.  Cases:
  CV+PP, CVD+PP, Exact, det-dropout+PP, IS+PP, CV+PP on the edge list,
  CV+PP with ``--owner_batching``, CV+PP at ``hidden1`` 15 (no weight
  tiles over 2 ranks: all replicated), the same with 4 classes (only the
  head tiles) and a padded-sparse first layer (a Planetoid fixture);
* the dp 2 x tp 2 checkpoint loaded at dp 1 x tp 1, at dp 1 x tp 2 and in
  the JAX package: ``predict`` within atol 1e-5 of the tp run's;
* its ``export_predictor`` artifact: the tp run's gathered eval weights
  and histories, bitwise, answering within atol 1e-5 of its ``predict``;
* the schedules of every rank identical; the CLI's epoch lines printed
  once by the group;
* ``--model mlp`` runs in one process whatever ``--dp`` says.
"""

import os

import numpy as np
import pytest

from stochastic_gcn_tpu.config import parse_flags as jax_flags
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer

from stochastic_gcn_tpu_torch import serving
from stochastic_gcn_tpu_torch.cli import train as train_cli
from stochastic_gcn_tpu_torch.config import parse_flags
from stochastic_gcn_tpu_torch.data import fixtures as F
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.parallel import checks, launch
from stochastic_gcn_tpu_torch.training.loop import Trainer

SYN = ["--dataset", "synthetic:240:30:5", "--hidden1", "16",
       "--batch_size", "32", "--test_batch_size", "64", "--degree", "2",
       "--test_degree", "2"]
# the recipe's chain: dense, dense, aggregator, dense, head (the second
# and third dense layers take gathered column blocks)
FIXED = ["--num_fc_layers", "2", "--weight_decay", "5e-4",
         "--normalization", "graphsage", "--layer_norm", "--seed", "3",
         "--history_dtype", "float32", "--field_dedup", "--polyak_decay",
         "0.99", "--dropout", "0.2"]
CV = ["--cv", "--test_cv"]
CASES = {
    "cv_pp": SYN + CV,
    "cvd_pp": SYN + CV + ["--cvd", "--test_cvd"],
    "exact": SYN + ["--degree", "10000", "--test_degree", "10000",
                    "--nopreprocess", "--notest_preprocess"],
    "det_dropout_pp": SYN + CV + ["--det_dropout"],
    "is_pp": SYN + ["--importance", "--test_importance"],
    "cv_pp_edgelist": SYN + CV + ["--graph_format", "edgelist"],
    "cv_pp_owner": SYN + CV + ["--owner_batching"],
    "cv_pp_hidden15": SYN + CV + ["--hidden1", "15"],
    # only the 4-class head tiles: its whole input is copied in, its
    # logits gathered
    "cv_pp_sharded_head": SYN + CV + ["--hidden1", "15", "--dataset",
                                      "synthetic:240:30:4"],
    "sparse_cv_pp": ["--dataset", "cora", "--hidden1", "16",
                     "--batch_size", "32", "--test_batch_size", "64",
                     "--degree", "1", "--test_degree", "1"] + CV,
}
# cora's layout (the reference reads 500 validation rows after the train
# rows), narrower features
PLANETOID = dict(name="cora", feature_dim=48)
EPOCHS = 2
TOL = dict(rtol=1e-4, atol=1e-6)
PREDICT_ATOL = 1e-5


def _flags(name, dp, tp, data_dir, ckpt=None):
    out = CASES[name] + FIXED + ["--data_dir", data_dir, "--dp", str(dp),
                                 "--tp", str(tp)]
    return out + (["--ckpt_dir", ckpt] if ckpt else [])


def _spawn(root, world, jobs):
    launch.spawn(checks.run_jobs, world, (jobs,), "cpu", store_dir=str(root))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at dp 2 x tp 2 (one 4-rank group, which also saves and
    exports ``cv_pp``, draws schedules and runs the CLI), at dp 2 and at
    dp 1 x tp 2 (one 2-rank group, which also loads the dp 2 x tp 2
    checkpoint) and in one process (here)."""
    root = tmp_path_factory.mktemp("tp")
    data = str(root / "data")
    F.write_planetoid_fixture(data, F.PlanetoidSpec(**PLANETOID))
    ckpt, art = str(root / "ckpt"), str(root / "art")
    tp4 = {name: (_flags(name, 2, 2, data), EPOCHS) for name in CASES}
    tp4["cv_pp"] = (_flags("cv_pp", 2, 2, data, ckpt), EPOCHS, art)
    cli_argv = _flags("cv_pp", 2, 2, data) + ["--epochs", "1", "--device",
                                              "cpu"]
    _spawn(root, 4, [
        ("trainer_steps", (tp4, str(root / "dp2tp2.npz"))),
        ("schedules", (_flags("cv_pp", 2, 2, data), str(root))),
        ("cli_in_group", (cli_argv, str(root)))])
    _spawn(root, 2, [
        ("trainer_steps", ({name: (_flags(name, 2, 1, data), EPOCHS)
                            for name in CASES}, str(root / "dp2.npz"))),
        ("trainer_steps", ({name: (_flags(name, 1, 2, data), EPOCHS)
                            for name in CASES}, str(root / "dp1tp2.npz"))),
        ("load_run", (_flags("cv_pp", 1, 2, data, ckpt),
                      str(root / "loaded_tp2.npz")))])
    one = {}
    for name in CASES:
        cfg = parse_flags(_flags(name, 1, 1, data))
        ds = Ld.load_data(cfg)
        tr = Trainer(cfg, ds, device="cpu")
        one[f"{name}:steps"] = checks.epoch_steps(tr, EPOCHS)
        one[f"{name}:eval"] = np.array(tr.evaluate(ds.val_d)[:4])
        one[f"{name}:pred"] = tr.predict(ds.test_d[:16])
        one.update(checks.state_arrays(tr, name))
    got = {k: dict(np.load(root / f"{k}.npz"))
           for k in ("dp2tp2", "dp2", "dp1tp2", "loaded_tp2")}
    return root, data, got, one


def _keys(arrays, name):
    # every result of a case but the shape of a rank's block
    return sorted(k for k in arrays if k.startswith(f"{name}:")
                  and k not in (f"{name}:local", f"{name}:head"))


def _same(got, want, name):
    keys = _keys(want, name)
    assert keys and _keys(got, name) == keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_dp2_tp2_matches_dp2(runs, name):
    _, _, got, _ = runs
    _same(got["dp2tp2"], got["dp2"], name)


@pytest.mark.parametrize("name", list(CASES))
def test_dp1_tp2_matches_one_process(runs, name):
    _, _, got, one = runs
    _same(got["dp1tp2"], one, name)


def test_tp_shards_the_hidden_columns(runs):
    """The comparisons above are of a real column layout: at hidden 16 the
    tp ranks' first-layer blocks are 8 wide (``:local``); at hidden 15
    nothing tiles and every rank holds the whole matrix, but for a 4-class
    head, of which a rank holds 2 columns (``:head``)."""
    _, _, got, _ = runs
    assert got["dp2tp2"]["cv_pp:local"].tolist() == [2 * 30, 8]
    assert got["dp2tp2"]["cv_pp_hidden15:local"].tolist() == [2 * 30, 15]
    assert got["dp2tp2"]["cv_pp_sharded_head:head"].tolist() == [15, 2]
    assert got["dp2"]["cv_pp:local"].tolist() == [2 * 30, 16]


def test_tp_checkpoint_loads_at_any_width_and_in_jax(runs):
    root, data, got, _ = runs
    ckpt = str(root / "ckpt")
    want = got["dp2tp2"]["cv_pp:pred"]
    np.testing.assert_allclose(got["loaded_tp2"]["pred"], want, rtol=0,
                               atol=PREDICT_ATOL)
    flags = _flags("cv_pp", 1, 1, data, ckpt)
    cfg = parse_flags(flags)
    ds = Ld.load_data(cfg)
    tr = Trainer(cfg, ds, device="cpu")
    tr.load(load_history=True)
    ids = ds.test_d[:16]
    np.testing.assert_allclose(tr.predict(ids), want, rtol=0,
                               atol=PREDICT_ATOL)
    jt = JaxTrainer(jax_flags(flags), ds)
    jt.load(load_history=True)
    np.testing.assert_allclose(jt.predict(ids), want, rtol=0,
                               atol=PREDICT_ATOL)


def test_tp_artifact_is_the_gathered_state(runs):
    root, data, got, _ = runs
    tp = got["dp2tp2"]
    with np.load(root / "art" / "state.npz") as z:
        art = {k: z[k] for k in z.files}
    for key in [k for k in art if k.startswith("params/")]:
        _, layer, name = key.split("/")
        np.testing.assert_array_equal(art[key],
                                      tp[f"cv_pp:avg:{layer}/{name}"])
    hist = [k for k in art if k.startswith("histories/")]
    assert hist
    for key in hist:
        _, l, j = key.split("/")
        want = tp[f"cv_pp:eval_hist:{l}/{j}"]          # the node rows
        np.testing.assert_array_equal(art[key][:want.shape[0]], want)
    cfg = parse_flags(_flags("cv_pp", 1, 1, data))
    ids = Ld.load_data(cfg).test_d[:16]
    served = serving.load_predictor(str(root / "art"),
                                    device="cpu").predict(ids)
    np.testing.assert_allclose(served, tp["cv_pp:pred"], rtol=0,
                               atol=PREDICT_ATOL)


def test_every_rank_draws_the_same_schedules(runs):
    root = runs[0]
    scheds = [dict(np.load(root / f"sched{r}.npz")) for r in range(4)]
    assert scheds[0]
    for other in scheds[1:]:
        assert sorted(other) == sorted(scheds[0])
        for k, v in scheds[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_cli_train_dp2_tp2_prints_its_lines_once(runs):
    root = runs[0]
    out = [line for r in range(4)
           for line in (root / f"cli{r}.txt").read_text().splitlines()]
    assert sum(s.startswith("Epoch: 0001") for s in out) == 1
    assert "Optimization Finished!" in out
    assert sum(s.startswith("Test set results:") for s in out) == 3
    assert (root / f"cli0.txt").read_text().count("Epoch: 0001") == 1


def test_cli_tp_spawns_dp_times_tp_workers(tmp_path, capfd):
    """``--dp 1 --tp 2`` is two ranks: the CLI spawns them itself."""
    got = train_cli.main(["--dataset", "synthetic:300:32:5", "--cv",
                          "--test_cv", "--degree", "1", "--test_degree", "1",
                          "--hidden1", "16", "--batch_size", "50",
                          "--test_batch_size", "100", "--epochs", "1",
                          "--ckpt_dir", str(tmp_path / "ckpt"), "--device",
                          "cpu", "--dp", "1", "--tp", "2"])
    assert got is None                    # the two workers did the work
    out = capfd.readouterr().out.splitlines()
    assert sum(s.startswith("Epoch: 0001") for s in out) == 1
    assert os.path.exists(tmp_path / "ckpt" / "model.ckpt.npz")


def test_cli_mlp_runs_in_one_process_whatever_dp_says(capfd):
    """``--model mlp --dp 2`` trains the NeighbourMLP in this process, as
    the JAX package does, and prints the ``--dp 1`` lines."""
    lines = {}
    for dp in (1, 2):
        got = train_cli.main(["--dataset", "synthetic:300:32:5", "--model",
                              "mlp", "--hidden1", "16", "--batch_size", "50",
                              "--test_batch_size", "100", "--epochs", "2",
                              "--seed", "3", "--device", "cpu", "--dp",
                              str(dp)])
        assert got is not None                # it ran here
        lines[dp] = [s for s in capfd.readouterr().out.splitlines()
                     if s.startswith(("Epoch:", "Test set results:"))]
    assert len(lines[1]) == 3
    assert lines[2] == lines[1]
