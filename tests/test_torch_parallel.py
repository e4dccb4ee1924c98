"""Data parallelism of the port (``--dp``) on the CPU: gloo process groups
of 2 and 3 ranks, against plain whole-table operations, the port on one
process and the JAX package.

The ranks run the port's own rank functions
(stochastic_gcn_tpu_torch/parallel/checks.py) in fresh processes, which
import nothing of this file (it imports JAX); their results come back in
``.npz`` files.  Tolerances:

* the halo transports (row gathers, the pair gather, the scatter):
  exact; their gradient and the owner-routed contraction: 1e-5 (float32
  sums in another order), checked on the ranks;
* the owner-routed full term against JAX's ``full_neighborhood_mean``:
  atol 1e-6;
* a dp=2 run against the dp=1 run of the same seed: rtol 1e-4 on the
  epochs' losses, the evaluation and the predictions, for CV+PP on
  dedup-compacted fields, IS+PP with and without ``--is_row_table``, the
  edge list (``--noshard_graph``) and ``--partition_nodes rcm``; on the
  no-dedup layout with dropout, where which of two duplicate rows a
  history keeps is not fixed, the first step's loss and params to rtol
  1e-4 and the validation micro-F1 after the epochs within 0.1;
* a dp=2 checkpoint loaded at dp=1 and in the JAX package: predictions
  within atol 1e-5.
"""

import os
import time

import numpy as np
import pytest

import jax.numpy as jnp

from stochastic_gcn_tpu.config import parse_flags as jax_flags
from stochastic_gcn_tpu.data import graph as JG
from stochastic_gcn_tpu.models import aggregators as JA
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer

from stochastic_gcn_tpu_torch.cli import train as train_cli
from stochastic_gcn_tpu_torch.config import parse_flags
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.parallel import checks, launch
from stochastic_gcn_tpu_torch.parallel.mesh import row_multiple, shard_rows
from stochastic_gcn_tpu_torch.training.loop import Trainer

DATASET = "synthetic:300:32:5"
BASE = ["--dataset", DATASET, "--degree", "2", "--test_degree", "2",
        "--hidden1", "16", "--batch_size", "48", "--test_batch_size", "96",
        "--normalization", "graphsage", "--layer_norm", "--seed", "3"]
CASES = {
    "cv_pp_dedup": ["--cv", "--test_cv", "--field_dedup", "--dropout",
                    "0.2"],
    "is_pp": ["--importance", "--test_importance", "--dropout", "0"],
    "is_pp_row_table": ["--importance", "--test_importance", "--dropout",
                        "0", "--is_row_table"],
    "edgelist": ["--cv", "--test_cv", "--field_dedup", "--graph_format",
                 "edgelist", "--noshard_graph", "--dropout", "0.2"],
    "rcm_exact": ["--degree", "100", "--test_degree", "100", "--dropout",
                  "0", "--partition_nodes", "rcm"],
    "cv_pp_nodedup": ["--cv", "--test_cv", "--dropout", "0.2"],
}
EXACT_CASES = [c for c in CASES if c != "cv_pp_nodedup"]
EPOCHS = 2
TOL = dict(rtol=1e-4, atol=1e-6)


def _spawn(tmp_path, fn, world, *args):
    launch.spawn(fn, world, args, "cpu", store_dir=str(tmp_path))


def _flags(name, dp, ckpt):
    return BASE + CASES[name] + ["--dp", str(dp), "--ckpt_dir", ckpt]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at dp=2 (one spawned group) and at dp=1 (here)."""
    root = tmp_path_factory.mktemp("dp")
    cases = {name: (_flags(name, 2, str(root / f"{name}_dp2")), EPOCHS)
             for name in CASES}
    _spawn(root, checks.trainer_runs, 2, cases, str(root / "dp2.npz"))
    got = dict(np.load(root / "dp2.npz"))
    want = {}
    for name in CASES:
        cfg = parse_flags(_flags(name, 1, str(root / f"{name}_dp1")))
        ds = Ld.load_data(cfg)
        want[f"{name}:step0"] = checks._first_step(
            Trainer(cfg, ds, device="cpu"))
        tr = Trainer(cfg, ds, device="cpu")
        want[f"{name}:losses"] = [tr.train_epoch()[0]
                                  for _ in range(EPOCHS)]
        want[f"{name}:eval"] = tr.evaluate(ds.val_d)[:4]
        want[f"{name}:pred"] = tr.predict(ds.test_d[:16])
        want[f"{name}:probes"] = checks.probes(tr)
    return root, got, want


@pytest.mark.parametrize("world", [2, 3])
def test_halo_primitives_match_whole_tables(tmp_path, world):
    """Gathers (float32, bfloat16, with duplicates, sentinel and parked
    ids, and the gradient), the pair gather, the scatter and the
    owner-routed contraction; world 3 gives blocks of a width no power of
    two divides."""
    _spawn(tmp_path, checks.halo_primitives, world)


def test_owner_routed_full_term_matches_jax(tmp_path):
    ds = Ld.load_data(parse_flags(BASE))
    jg = JG.pad_csr(ds.full_adj)
    n = ds.num_data
    rng = np.random.default_rng(5)
    hist = rng.normal(size=(shard_rows(n, 2), 16)).astype(np.float32)
    field = np.r_[rng.choice(n, 60, replace=False), [n] * 4].astype(np.int32)
    np.savez(tmp_path / "in.npz", hist=hist, field=field,
             nbr=np.asarray(jg.nbr), w=np.asarray(jg.w),
             deg=np.asarray(jg.deg))
    _spawn(tmp_path, checks.full_term, 2, str(tmp_path / "in.npz"),
           str(tmp_path / "out.npz"))
    got = np.load(tmp_path / "out.npz")
    for square in (False, True):
        want = JA.full_neighborhood_mean(jnp.asarray(hist), jg,
                                         jnp.asarray(field), square=square)
        np.testing.assert_allclose(got[f"square{int(square)}"],
                                   np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", EXACT_CASES)
def test_dp2_trajectory_matches_dp1(runs, name):
    _, got, want = runs
    for key in ("losses", "eval", "pred", "step0"):
        np.testing.assert_allclose(got[f"{name}:{key}"],
                                   want[f"{name}:{key}"], **TOL)


@pytest.mark.parametrize("name", EXACT_CASES)
def test_dp2_activation_stats_and_gradient_variance_match_dp1(runs, name):
    """``activation_stats`` and ``gradient_variance`` under dp: the moments
    and the bias / stdev table of the whole batch, as at dp=1."""
    _, got, want = runs
    np.testing.assert_allclose(got[f"{name}:probes"], want[f"{name}:probes"],
                               **TOL)


def test_dp2_nodedup_with_dropout_step_and_f1_band(runs):
    _, got, want = runs
    np.testing.assert_allclose(got["cv_pp_nodedup:step0"],
                               want["cv_pp_nodedup:step0"], **TOL)
    assert abs(got["cv_pp_nodedup:eval"][2]
               - want["cv_pp_nodedup:eval"][2]) <= 0.1


def test_partition_nodes_preserves_evaluation():
    """``--partition_nodes rcm`` relabels the nodes: with exhaustive
    sampling and no dropout the evaluation of the caller's ids is the
    unrelabelled one (at dp=2 too: ``test_dp2_trajectory_matches_dp1``
    holds the rcm run against this one)."""
    cfg = parse_flags(BASE + ["--degree", "100", "--test_degree", "100",
                              "--dropout", "0"])
    ds = Ld.load_data(cfg)
    plain = Trainer(cfg, ds, device="cpu")
    rcm = Trainer(cfg.replace(partition_nodes="rcm"), ds, device="cpu")
    assert not np.array_equal(rcm.node_perm, np.arange(ds.num_data))
    np.testing.assert_allclose(rcm.evaluate(ds.val_d)[:4],
                               plain.evaluate(ds.val_d)[:4], **TOL)
    ids = ds.test_d[:19]
    np.testing.assert_allclose(rcm.predict(ids), plain.predict(ids),
                               rtol=0, atol=1e-6)


def test_dp2_checkpoint_loads_at_dp1_and_in_jax(runs):
    root, got, _ = runs
    ckpt = str(root / "cv_pp_dedup_dp2")
    want = got["cv_pp_dedup:pred"]
    cfg = parse_flags(_flags("cv_pp_dedup", 1, ckpt))
    ds = Ld.load_data(cfg)
    tr = Trainer(cfg, ds, device="cpu")
    tr.load(load_history=True)
    ids = ds.test_d[:16]
    np.testing.assert_allclose(tr.predict(ids), want, rtol=0, atol=1e-5)
    jt = JaxTrainer(jax_flags(_flags("cv_pp_dedup", 1, ckpt)), ds)
    jt.load(load_history=True)
    np.testing.assert_allclose(jt.predict(ids), want, rtol=0, atol=1e-5)


def test_cli_train_dp2_on_cpu(tmp_path, capfd):
    ckpt = str(tmp_path / "ckpt")
    got = train_cli.main(["--dataset", DATASET, "--cv", "--test_cv",
                          "--degree", "1", "--test_degree", "1",
                          "--hidden1", "16", "--batch_size", "50",
                          "--test_batch_size", "100", "--epochs", "1",
                          "--ckpt_dir", ckpt, "--device", "cpu",
                          "--dp", "2"])
    assert got is None                    # the two workers did the work
    out = capfd.readouterr().out.splitlines()
    assert sum(s.startswith("Epoch: 0001") for s in out) == 1   # rank 0
    assert "Optimization Finished!" in out
    assert sum(s.startswith("Test set results:") for s in out) == 3
    assert os.path.exists(os.path.join(ckpt, "model.ckpt.npz"))


def test_a_failing_rank_fails_the_spawn_at_once(tmp_path):
    """A rank that raises while the others wait in a collective ends the
    whole group at once (the parent stops the others), not after the
    group's timeout."""
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="terminated"):
        _spawn(tmp_path, checks.fail_on_rank_zero, 2)
    assert time.perf_counter() - t0 < 60


def test_dp_needs_a_group_of_its_width(tmp_path):
    cfg = parse_flags(BASE + ["--dp", "2", "--ckpt_dir", str(tmp_path)])
    ds = Ld.load_data(cfg)
    with pytest.raises(ValueError, match="process group"):
        Trainer(cfg, ds, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        Trainer(cfg.replace(dp=5), ds, device="cpu")
    with pytest.raises(ValueError, match="single-chip"):
        Trainer(cfg.replace(use_pallas=True), ds, device="cpu")


def test_row_multiple_is_the_jax_packages_at_powers_of_two():
    for dp in (1, 2, 4, 8, 16):
        assert row_multiple(dp) == max(8, dp)
    assert row_multiple(3) == 24 and shard_rows(300, 3) % 3 == 0
