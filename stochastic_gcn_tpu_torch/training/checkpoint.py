"""Checkpoints in the JAX package's format, read and written (numpy only).

The format (stochastic_gcn_tpu/training/checkpoint.py) is one npz entry
per pytree leaf, keyed by the leaf's ``jax.tree_util.keystr`` path:
``leaf:['state'].params['dense0']['weights']``,
``leaf:['state'].opt_state[0].mu['dense0']['weights']`` (optax's
``ScaleByAdamState``; ``count`` is an int32 scalar), ``bf16leaf:['state']
.histories[0][0]``, ``leaf:['state'].step``,
``leaf:['eval_histories'][0][0]`` and ``leaf:['key']``; with Polyak
averaging also ``leaf:['state'].avg_params['dense0']['weights']``, and under
det-dropout a second history per layer, ``histories[0][1]``.  bfloat16 leaves
are stored as uint16 bit views under ``bf16leaf:``.  Loop counters for
``--resume`` ride along as ``extra:<name>``.  The port writes exactly the
leaves a JAX ``Trainer`` with the same flags expects, and reads the full
train state from files either package wrote.

The ``key`` leaf is the JAX PRNG key of ``cfg.seed`` (``PRNGKey(seed)``'s
raw ``[0, seed]``).  The two frameworks draw different random streams, so
no generator state is carried across in either direction.

:class:`AsyncCheckpointer` (``--ckpt_async``) writes the same entries from
a background thread.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from .step import AdamState, TrainState, param_keys

_LEAF, _BF16, _EXTRA = "leaf:", "bf16leaf:", "extra:"
_AVG = "['state'].avg_params"


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def params_from_jax(np_params: dict, device="cpu") -> dict:
    """``{layer: {name: array}}`` -> ``{layer: {name: float32 Tensor}}``;
    the layouts match (``weights`` is [in, out])."""
    return {layer: {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                    device=device)
                    for k, v in p.items()}
            for layer, p in np_params.items()}


def opt_state_from_jax(np_opt, device="cpu") -> AdamState:
    """optax's Adam state with numpy leaves (``(ScaleByAdamState,
    EmptyState)``) -> :class:`AdamState`."""
    s = np_opt[0]
    return AdamState(
        count=torch.tensor(np.asarray(s.count), dtype=torch.int32,
                           device=device),
        mu=params_from_jax(s.mu, device), nu=params_from_jax(s.nu, device))


def opt_state_to_jax(opt: AdamState) -> dict:
    """The inverse of :func:`opt_state_from_jax`: ``{"count", "mu", "nu"}``
    as numpy arrays (``optax.ScaleByAdamState(**d)`` rebuilds the JAX
    state's first element)."""
    def tree(d):
        return {l: {n: t.detach().cpu().numpy() for n, t in p.items()}
                for l, p in d.items()}
    return {"count": np.asarray(opt.count.cpu().numpy(), np.int32),
            "mu": tree(opt.mu), "nu": tree(opt.nu)}


def jax_key(seed: int) -> np.ndarray:
    """The raw uint32[2] of ``jax.random.PRNGKey(seed)``."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _state_leaves(state: TrainState, eval_histories) -> list:
    """[(keystr path, tensor)] of every leaf of the JAX checkpoint payload
    ``{"state": TrainState, "eval_histories": ...}`` except ``key``."""
    keys = param_keys(state.params)
    out = [(f"['state'].params['{l}']['{n}']", state.params[l][n])
           for l, n in keys]
    out.append(("['state'].opt_state[0].count", state.opt_state.count))
    for moment in ("mu", "nu"):
        tree = getattr(state.opt_state, moment)
        out += [(f"['state'].opt_state[0].{moment}['{l}']['{n}']",
                 tree[l][n]) for l, n in keys]
    out += [(f"['state'].histories[{i}][{j}]", h)
            for i, hl in enumerate(state.histories) for j, h in enumerate(hl)]
    out.append(("['state'].step", state.step))
    if state.avg_params is not None:
        out += [(f"{_AVG}['{l}']['{n}']", state.avg_params[l][n])
                for l, n in keys]
    out += [(f"['eval_histories'][{i}][{j}]", h)
            for i, hl in enumerate(eval_histories) for j, h in enumerate(hl)]
    return out


def checkpoint_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "model.ckpt.npz")


def _npz_arrays(leaves, seed: int, extra: dict) -> dict:
    """The npz entries of a checkpoint: ``leaves`` ([(keystr path, CPU
    tensor)], :func:`_state_leaves`' order) as ``leaf:`` arrays, bfloat16
    ones as ``bf16leaf:`` uint16 bit views, then the ``key`` leaf and the
    ``extra:`` counters."""
    arrays = {}
    for k, t in leaves:
        if t.dtype == torch.bfloat16:
            arrays[_BF16 + k] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[_LEAF + k] = t.numpy()
    arrays[_LEAF + "['key']"] = jax_key(seed)
    for k, v in (extra or {}).items():
        arrays[_EXTRA + k] = np.asarray(v)
    return arrays


def _write_npz(path: str, arrays: dict, compress: bool) -> None:
    """Write ``arrays`` to ``path`` atomically: into ``<path>.tmp``, then
    renamed over ``path``, so a crash mid-write leaves the previous
    snapshot intact."""
    writer = np.savez_compressed if compress else np.savez
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        writer(f, **arrays)
    os.replace(tmp, path)
    print(f"Model saved in file: {path}")


def save_checkpoint(ckpt_dir: str, state: TrainState, eval_histories,
                    seed: int, extra: dict = None,
                    compress: bool = True) -> str:
    """Write the full train state in the JAX layout (atomically: a crash
    mid-write leaves the previous snapshot intact).  ``extra``: loop
    counters for --resume, stored as ``extra:`` entries."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir)
    leaves = [(k, t.detach().cpu())
              for k, t in _state_leaves(state, eval_histories)]
    _write_npz(path, _npz_arrays(leaves, seed, extra), compress)
    return path


class AsyncCheckpointer:
    """:func:`save_checkpoint` off the caller's critical path (the JAX
    package's ``AsyncCheckpointer``, ``--ckpt_async``).

    ``save()`` waits for the previous write, snapshots every leaf into
    fresh tensors on ``device`` and hands the npz write to a background
    thread.  On a CUDA device the snapshot is taken on the current stream,
    so the next step's in-place history scatters and Adam updates, queued
    behind it, cannot reach it; a side stream then copies it into
    page-locked host buffers (allocated at the first save, reused after:
    the wait makes reuse safe) and records an event the writer thread
    waits on.  On the CPU the snapshot is a ``clone()`` the thread writes
    from.  Nothing falls back: a failure to pin or to copy raises in
    ``save()``.

    The thread writes the file as :func:`save_checkpoint` does (the same
    entries, tmp then rename), so a crash mid-write leaves the previous
    snapshot loadable.  A writer error is re-raised by the next
    ``wait()``; callers wait before reading the file back and before the
    process exits.  One process only: a mesh's save gathers its blocks in
    collectives that cannot overlap the next epoch's (``Trainer.save``
    keeps the sync path there)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._thread = None
        self._error = None
        self._stream = None
        self._host = None         # pinned buffers of the last snapshot

    @property
    def pending(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Join the write in flight, if any; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _to_host(self, snap: list):
        """Copy the device snapshot into the pinned buffers on the side
        stream; returns the buffers and the event that marks the copy."""
        dev = self.device
        if self._host is None or [(h.shape, h.dtype) for h in self._host] \
                != [(s.shape, s.dtype) for s in snap]:
            self._host = [torch.empty(s.shape, dtype=s.dtype,
                                      pin_memory=True) for s in snap]
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            for h, s in zip(self._host, snap):
                h.copy_(s, non_blocking=True)
                # the allocator may hand s's memory out again only after
                # the side stream's copy
                s.record_stream(self._stream)
            done = torch.cuda.Event()
            done.record(self._stream)
        return self._host, done

    def save(self, ckpt_dir: str, state: TrainState, eval_histories,
             seed: int, extra: dict = None, compress: bool = True) -> str:
        """Snapshot ``state`` and ``eval_histories`` and start writing them
        to ``<ckpt_dir>/model.ckpt.npz`` in the background; returns the
        path, which holds the snapshot once :meth:`wait` returns."""
        self.wait()
        os.makedirs(ckpt_dir, exist_ok=True)
        path = checkpoint_path(ckpt_dir)
        keys, live = zip(*_state_leaves(state, eval_histories))
        with torch.no_grad():
            snap = [t.detach().clone() for t in live]
        done = None
        if self.device.type == "cuda":
            snap, done = self._to_host(snap)
        extra = {k: np.array(v) for k, v in (extra or {}).items()}

        def write():
            try:
                if done is not None:
                    done.synchronize()
                _write_npz(path, _npz_arrays(zip(keys, snap), seed, extra),
                           compress)
            except Exception as e:       # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()
        return path


def load_checkpoint(ckpt_dir: str, state: TrainState, eval_histories,
                    load_history: bool = True):
    """Restore params, Adam state, step and (``load_history``) the train
    and eval histories from a checkpoint either package wrote, IN PLACE
    into ``state`` / ``eval_histories`` (which fix the expected leaves,
    shapes, dtypes and device).  Every leaf is checked before any is
    copied: a missing leaf raises KeyError, a wrong shape ValueError.

    The Polyak average follows this run's ``polyak_decay``, as in the JAX
    package: a run that keeps an average and loads a checkpoint without one
    seeds the average from the restored weights; a run without one ignores
    a saved average."""
    path = checkpoint_path(ckpt_dir)
    wanted = [(k, t) for k, t in _state_leaves(state, eval_histories)
              if load_history or "histories" not in k]
    with np.load(path, allow_pickle=False) as z:
        files = set(z.files)
        seed_avg = state.avg_params is not None and not any(
            f.startswith(_LEAF + _AVG) for f in files)
        if seed_avg:
            wanted = [(k, t) for k, t in wanted if not k.startswith(_AVG)]
        arrays = []
        for k, t in wanted:
            if _LEAF + k in files:
                arr = z[_LEAF + k]
            elif _BF16 + k in files:
                arr = _bf16_to_f32(z[_BF16 + k])
            else:
                raise KeyError(f"checkpoint {path} is missing leaf {k!r} "
                               "(saved under different model settings?)")
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint leaf {k!r} has shape "
                                 f"{tuple(arr.shape)}, expected "
                                 f"{tuple(t.shape)}")
            arrays.append(arr)
    with torch.no_grad():
        for (_, t), arr in zip(wanted, arrays):
            t.copy_(torch.as_tensor(arr))
        if seed_avg:
            for l, n in param_keys(state.params):
                state.avg_params[l][n].copy_(state.params[l][n])
    print(f"Model restored from file: {path}")
    return state, eval_histories


def load_loop_extras(ckpt_dir: str) -> dict:
    """The --resume loop counters stored beside the state (empty for a
    checkpoint written without them)."""
    with np.load(checkpoint_path(ckpt_dir), allow_pickle=False) as z:
        return {k[len(_EXTRA):]: z[k] for k in z.files
                if k.startswith(_EXTRA)}
