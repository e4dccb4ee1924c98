"""``--ckpt_async`` in the port, on the CPU: ``Trainer.save()`` snapshots
the state and writes it from a background thread
(training/checkpoint.py::AsyncCheckpointer).  The cases of the JAX
package's tests/test_async_ckpt.py, and the port's own: the writer is
joined when training raises, the SIGTERM handler outlives the final write,
an async file holds the arrays of a sync save bit for bit, the files
cross-load with the JAX package in both directions, and a ``--dp 2`` run
keeps the sync gathered save.

Tolerances: checkpoints round-trip bit for bit (``array_equal``); a JAX
Trainer serving the port's checkpoint agrees to atol 1e-5, as in
tests/test_torch_train.py.  Overlap is asserted on a writer slowed to 2 s
against a return in under 1 s, and on ``pending``."""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest
import torch

from stochastic_gcn_tpu.config import Config as JaxConfig
from stochastic_gcn_tpu.data.loaders import synthetic_dataset
from stochastic_gcn_tpu.training.loop import Trainer as JaxTrainer

from stochastic_gcn_tpu_torch.config import from_fields, parse_flags
from stochastic_gcn_tpu_torch.parallel import checks, launch
from stochastic_gcn_tpu_torch.training import checkpoint as C
from stochastic_gcn_tpu_torch.training.loop import Trainer

SLOW_S = 2.0          # a slowed write
RETURN_S = 1.0        # save() returns well inside it
DP_FLAGS = ["--dataset", "synthetic:300:32:5", "--cv", "--test_cv",
            "--field_dedup", "--degree", "2", "--test_degree", "2",
            "--hidden1", "16", "--batch_size", "48", "--test_batch_size",
            "96", "--dropout", "0.2", "--seed", "3", "--dp", "2"]


def quiet(*args, **kw):
    pass


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=200, feature_dim=16, num_classes=4,
                             avg_degree=6, seed=0)


def _jax_cfg(tmp_path, **kw):
    base = dict(dataset="synthetic", batch_size=64, degree=1, test_degree=1,
                cv=True, test_cv=True, hidden1=16, seed=1,
                early_stopping=100, ckpt_dir=str(tmp_path), ckpt_async=True)
    base.update(kw)
    return JaxConfig(**base)


def _cfg(tmp_path, **kw):
    """The port's Config of :func:`_jax_cfg`."""
    return from_fields(dataclasses.asdict(_jax_cfg(tmp_path, **kw)))


def _path(d) -> str:
    return C.checkpoint_path(str(d))


def _epochs_in(d) -> int:
    return int(C.load_loop_extras(str(d))["completed_epochs"])


def _slowed(monkeypatch, secs: float = SLOW_S, before=None):
    """Slow the compressed npz writer by ``secs``; ``before()`` runs first
    inside the writer thread."""
    orig = np.savez_compressed

    def slow(f, **arrays):
        if before is not None:
            before()
        time.sleep(secs)
        return orig(f, **arrays)

    monkeypatch.setattr(C.np, "savez_compressed", slow)


def _die(f, **arrays):
    f.write(b"partial garbage")           # a kill mid-write
    raise RuntimeError("writer died")


def _state_arrays(tr) -> list:
    """The train state's leaves (not the eval histories, which load()
    re-derives from the train ones)."""
    return [(k, t) for k, t in C._state_leaves(tr.state, tr.eval_histories)
            if k.startswith("['state']")]


def test_async_save_roundtrips_like_sync(tmp_path, ds):
    """A resume from an async checkpoint restores bit-identical params,
    Adam state, step, histories and counters.  On the CPU the snapshot is
    a clone: no side stream, no pinned buffers."""
    tr = Trainer(_cfg(tmp_path), ds, device="cpu")
    tr.sgd_train(log=quiet, max_epochs=2)
    ck = tr._async_ckpt
    assert ck is not None and not ck.pending
    assert (ck._stream, ck._host) == (None, None)
    assert os.path.exists(_path(tmp_path))
    assert not os.path.exists(_path(tmp_path) + ".tmp")

    tr2 = Trainer(_cfg(tmp_path, resume=True), ds, device="cpu")
    assert tr2._try_resume(log=quiet) == 2
    assert (tr2.amt_data, tr2.cost_val) == (tr.amt_data, tr.cost_val)
    for (k, a), (_, b) in zip(_state_arrays(tr), _state_arrays(tr2)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert _epochs_in(tmp_path) == 2


def test_async_save_overlaps_and_finish_waits(tmp_path, ds, monkeypatch):
    """save() returns while the write is pending (the previous snapshot
    still the file); finish_checkpoints joins the writer and publishes the
    new one."""
    tr = Trainer(_cfg(tmp_path), ds, device="cpu")
    tr.sgd_train(log=quiet, max_epochs=1)
    _slowed(monkeypatch)
    tr.completed_epochs = 7
    t0 = time.perf_counter()
    path = tr.save()
    returned_in = time.perf_counter() - t0
    ck = tr._async_ckpt
    assert ck.pending
    assert returned_in < RETURN_S
    assert _epochs_in(tmp_path) == 1
    tr.finish_checkpoints()
    assert not ck.pending
    assert path == _path(tmp_path) and _epochs_in(tmp_path) == 7
    assert not os.path.exists(path + ".tmp")


def test_crashed_write_keeps_previous_snapshot(tmp_path, ds, monkeypatch):
    """A writer that dies mid-write leaves the previous complete checkpoint
    loadable (tmp + rename); its error surfaces at finish_checkpoints, and
    the next save writes again."""
    tr = Trainer(_cfg(tmp_path), ds, device="cpu")
    tr.sgd_train(log=quiet, max_epochs=1)
    good = open(_path(tmp_path), "rb").read()
    monkeypatch.setattr(C.np, "savez_compressed", _die)
    tr.save()
    with pytest.raises(RuntimeError, match="writer died"):
        tr.finish_checkpoints()
    assert open(_path(tmp_path), "rb").read() == good
    tr2 = Trainer(_cfg(tmp_path, resume=True), ds, device="cpu")
    assert tr2._try_resume(log=quiet) == 1
    monkeypatch.undo()
    tr.completed_epochs = 5
    tr.save()
    tr.finish_checkpoints()
    assert _epochs_in(tmp_path) == 5


def test_nockpt_async_uses_sync_path(tmp_path, ds):
    """ckpt_async off (the default) keeps the blocking save: no writer."""
    tr = Trainer(_cfg(tmp_path, ckpt_async=False), ds, device="cpu")
    tr.sgd_train(log=quiet, max_epochs=1)
    assert tr._async_ckpt is None
    assert os.path.exists(_path(tmp_path))


def test_back_to_back_saves_serialize(tmp_path, ds, monkeypatch):
    """A save while a write is pending joins that write first: snapshots
    are published in order."""
    tr = Trainer(_cfg(tmp_path), ds, device="cpu")
    tr.sgd_train(log=quiet, max_epochs=1)
    written = []
    write = C._write_npz

    def recording(path, arrays, compress):
        time.sleep(0.2)
        write(path, arrays, compress)
        written.append(int(arrays["extra:completed_epochs"]))

    monkeypatch.setattr(C, "_write_npz", recording)
    for _ in range(3):
        tr.completed_epochs += 1
        tr.save()
    tr.finish_checkpoints()
    assert written == [2, 3, 4]
    assert _epochs_in(tmp_path) == 4


@pytest.mark.parametrize("writer", ["slow", "dies"])
def test_training_error_joins_the_pending_write(tmp_path, ds, monkeypatch,
                                                writer):
    """An exception escaping the epoch loop after a periodic async save:
    sgd_train joins the write before the exception propagates, so the
    snapshot is published; a writer that fails too is logged, and the
    training error is the one raised."""
    tr = Trainer(_cfg(tmp_path, ckpt_every=1), ds, device="cpu")
    if writer == "slow":
        _slowed(monkeypatch, secs=0.5)
    else:
        monkeypatch.setattr(C.np, "savez_compressed", _die)
    train_epoch = tr.train_epoch

    def failing_second_epoch():
        if tr.completed_epochs == 1:
            raise RuntimeError("epoch failed")
        return train_epoch()

    tr.train_epoch = failing_second_epoch
    lines = []
    with pytest.raises(RuntimeError, match="epoch failed"):
        tr.sgd_train(log=lines.append, max_epochs=5)
    assert not tr._async_ckpt.pending
    failed = [s for s in lines if "writer died" in s]
    if writer == "slow":
        assert _epochs_in(tmp_path) == 1 and not failed
    else:
        assert not os.path.exists(_path(tmp_path)) and len(failed) == 1


def test_sigterm_handler_outlives_the_final_async_write(tmp_path, ds,
                                                       monkeypatch):
    """The preemption flag-setter stays installed while the final snapshot
    is written in the background, and is restored once it is on disk."""
    tr = Trainer(_cfg(tmp_path), ds, device="cpu")
    original = signal.getsignal(signal.SIGTERM)
    seen = []
    try:
        tr.install_preemption_handler()
        ours = signal.getsignal(signal.SIGTERM)
        assert ours is not original
        _slowed(monkeypatch, secs=0.5, before=lambda: seen.append(
            signal.getsignal(signal.SIGTERM) is ours))
        tr.sgd_train(log=quiet, max_epochs=1)
        assert seen == [True]
        assert _epochs_in(tmp_path) == 1
        assert signal.getsignal(signal.SIGTERM) is original
    finally:
        signal.signal(signal.SIGTERM, original)


@pytest.mark.parametrize("compress", [True, False])
def test_async_file_holds_the_sync_arrays(tmp_path, ds, compress):
    """An async save and a sync save of the same state (Polyak average and
    det-dropout's second history included) hold the same entries in the
    same order, bit for bit.  The files' bytes differ: zip entries carry
    the wall clock."""
    cfg = _cfg(tmp_path, polyak_decay=0.99, det_dropout=True,
               ckpt_compress=compress)
    tr = Trainer(cfg, ds, device="cpu")
    tr.train_epoch()
    tr.completed_epochs, tr.cost_val = 1, [0.5]
    paths = {}
    for mode in (False, True):
        tr.cfg = cfg.replace(ckpt_async=mode,
                             ckpt_dir=str(tmp_path / str(mode)))
        paths[mode] = tr.save()
    tr.finish_checkpoints()
    with np.load(paths[False]) as want, np.load(paths[True]) as got:
        assert got.files == want.files
        assert any(k.startswith("bf16leaf:") for k in got.files)
        assert any("avg_params" in k for k in got.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_async_checkpoint_loads_in_jax(tmp_path, ds):
    """The port's async checkpoint loads in JAX's Trainer (every leaf of
    its template), which then serves what the port serves."""
    jcfg = _jax_cfg(tmp_path)
    tr = Trainer(_cfg(tmp_path), ds, device="cpu")
    tr.train_epoch()
    tr.save()
    tr.finish_checkpoints()
    jt = JaxTrainer(jcfg, ds)
    jt.load()
    ids = np.asarray(ds.test_d)
    np.testing.assert_allclose(tr.predict(ids), jt.predict(ids), rtol=0,
                               atol=1e-5)
    assert int(jt.state.opt_state[0].count) == int(tr.state.opt_state.count)


def test_jax_async_checkpoint_resumes_in_port(tmp_path, ds):
    """A JAX ``--ckpt_async`` run's checkpoint resumes in the port with
    JAX's params, Adam state, histories and counters, bit for bit."""
    jt = JaxTrainer(_jax_cfg(tmp_path), ds)
    jt.sgd_train(log=quiet, max_epochs=1)
    tr = Trainer(_cfg(tmp_path, resume=True), ds, device="cpu")
    assert tr._try_resume(log=quiet) == 1
    assert (tr.amt_data, tr.cost_val) == (jt.amt_data, jt.cost_val)
    want = np.load(_path(tmp_path))
    for k, t in _state_arrays(tr):
        if "histories" in k:
            arr = C._bf16_to_f32(want["bf16leaf:" + k])
        else:
            arr = want["leaf:" + k]
        np.testing.assert_array_equal(t.float().numpy(), arr, err_msg=k)


def test_dp2_async_falls_back_to_the_sync_gathered_save(tmp_path):
    """Under ``--dp 2`` (gloo) ``--ckpt_async`` keeps the sync gathered
    save: no writer, the file on disk when save() returns, and the same
    arrays as a ``--dp 2`` sync run's file."""
    dirs = {mode: tmp_path / mode for mode in ("sync", "async")}
    cases = {"sync": DP_FLAGS + ["--ckpt_dir", str(dirs["sync"])],
             "async": DP_FLAGS + ["--ckpt_dir", str(dirs["async"]),
                                  "--ckpt_async"]}
    assert parse_flags(cases["async"]).ckpt_async
    out = tmp_path / "saves.npz"
    launch.spawn(checks.save_runs, 2, (cases, str(out)), "cpu",
                 store_dir=str(tmp_path))
    res = np.load(out)
    for mode in cases:
        assert res[mode].tolist() == [False, True], mode
    with np.load(_path(dirs["sync"])) as want, \
            np.load(_path(dirs["async"])) as got:
        assert got.files == want.files
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
