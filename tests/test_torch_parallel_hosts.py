"""The port's multi-host launch on the CPU: the JAX package's flags
``--coordinator host:port --num_processes H --process_id i``, where a
"process" is a host that starts its ``dp / H`` local ranks.  Two host
processes on localhost, each spawning 2 gloo ranks of one ``--dp 4
--dp_hosts 2`` group through a TCP store at a free port, run
``parallel/checks.py::host_run`` (train, evaluate, predict, save, load and
predict again); a one-host ``--dp 4`` run of the same flags is the
reference.  Gloo sums over the same 4 ranks in the same order either way,
so the two hosts agree exactly and with the one-host run within rtol 1e-5;
the collective bytes split into those that stay on a host and those that
cross hosts.  The launch's mismatches raise, ``--tp 2`` outside a process
group of ``dp * tp`` ranks raises the group-size error, and
``--ckpt_async`` builds in one process."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from stochastic_gcn_tpu_torch.config import parse_flags
from stochastic_gcn_tpu_torch.data import loaders as Ld
from stochastic_gcn_tpu_torch.parallel import checks, distributed, launch
from stochastic_gcn_tpu_torch.parallel import mesh as PM
from stochastic_gcn_tpu_torch.training.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--dataset", "synthetic:300:32:5", "--cv", "--test_cv",
         "--field_dedup", "--degree", "2", "--test_degree", "2",
         "--hidden1", "16", "--batch_size", "48", "--test_batch_size", "96",
         "--dropout", "0.2", "--epochs", "2", "--seed", "3", "--dp", "4"]
TOL = dict(rtol=1e-5, atol=1e-7)
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _checks(out, flags):
    return subprocess.Popen(
        [sys.executable, "-m", "stochastic_gcn_tpu_torch.parallel.checks",
         str(out), "cpu", *flags], cwd=ROOT)


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    root = tmp_path_factory.mktemp("hosts")
    two, one = root / "two", root / "one"
    two.mkdir()
    one.mkdir()
    port = _free_port()
    procs = [_checks(two, FLAGS + [
        "--ckpt_dir", str(two / "ckpt"), "--dp_hosts", "2",
        "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
        "--process_id", str(i)]) for i in range(2)]
    rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    assert rcs == [0, 0]
    assert _checks(one, FLAGS + ["--ckpt_dir", str(one / "ckpt")]).wait(
        timeout=TIMEOUT) == 0
    return ([dict(np.load(two / f"host{i}.npz")) for i in range(2)],
            dict(np.load(one / "host0.npz")))


def test_two_hosts_agree_with_each_other_and_one_host(hosts):
    (h0, h1), one = hosts
    assert h0["ranks"].tolist() == [4, 0] and h1["ranks"].tolist() == [4, 2]
    for key in ("losses", "eval", "pred", "pred_loaded"):
        np.testing.assert_array_equal(h0[key], h1[key])
        np.testing.assert_allclose(h0[key], one[key], **TOL)
    # the checkpoint round trip: a fresh group loads what it saved
    np.testing.assert_allclose(h0["pred_loaded"], h0["pred"], **TOL)


def test_collective_bytes_split_by_host(hosts):
    (h0, h1), one = hosts
    for h in (h0, h1):
        total, cross = h["wire"]
        assert 0 < cross < total
    assert one["wire"][1] == 0 and one["wire"][0] > 0


@pytest.mark.parametrize("over, match", [
    ({"dp": 3, "num_processes": 2}, "tile"),
    ({"dp": 4, "num_processes": 2, "process_id": 2}, "process_id"),
    ({"dp": 4, "num_processes": 2, "dp_hosts": 4}, "dp_hosts")])
def test_host_launch_mismatches_raise(over, match):
    cfg = parse_flags(["--coordinator", "127.0.0.1:1"]).replace(**over)
    with pytest.raises(ValueError, match=match):
        distributed.host_ranks(cfg)


def test_mesh_host_layout():
    """Rank r of a host-major mesh of 2 hosts is on host r // 2; the
    JAX package's ``mesh_host_shape`` view."""
    mesh = PM.Mesh(rank=3, size=4, hosts=2)
    assert [mesh.host(r) for r in range(4)] == [0, 0, 1, 1]
    assert PM.mesh_host_shape(mesh, 2) == (2, 2)


def test_ranks_not_host_major_raise(tmp_path):
    """Two local ranks on one host cannot form a mesh of 2 hosts."""
    out = tmp_path / "mesh.npz"
    launch.spawn(checks.mesh_hosts, 2, (2, str(out)), "cpu",
                 store_dir=str(tmp_path))
    assert "not host-major" in str(np.load(out)["error"])


@pytest.mark.parametrize("over, error, match", [
    ({"tp": 2}, ValueError, "process group of 2 ranks"),
    ({"ckpt_async": True}, None, None)])
def test_tp_needs_its_group_and_ckpt_async_builds(tmp_path, over, error,
                                                  match):
    """``--tp 2`` outside a group of 2 ranks raises; ``--ckpt_async`` is
    ported: without ``--dp`` the Trainer builds in one process and its
    save writes in the background (a group keeps the sync save:
    tests/test_torch_ckpt_async.py)."""
    cfg = parse_flags(FLAGS[:-2] + ["--ckpt_dir", str(tmp_path)]).replace(
        **over)
    if error is not None:
        with pytest.raises(error, match=match):
            Trainer(cfg, Ld.load_data(cfg), device="cpu")
        return
    tr = Trainer(cfg, Ld.load_data(cfg), device="cpu")
    assert tr.mesh is None
    path = tr.save()
    assert tr._async_ckpt is not None
    tr.finish_checkpoints()
    assert os.path.exists(path)
