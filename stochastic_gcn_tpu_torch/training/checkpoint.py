"""Checkpoints in the JAX package's format, read and written (numpy only).

The format (stochastic_gcn_tpu/training/checkpoint.py) is one npz entry
per pytree leaf, keyed by the leaf's ``jax.tree_util.keystr`` path:
``leaf:['state'].params['dense0']['weights']``,
``leaf:['state'].opt_state[0].mu['dense0']['weights']`` (optax's
``ScaleByAdamState``; ``count`` is an int32 scalar), ``bf16leaf:['state']
.histories[0][0]``, ``leaf:['state'].step``,
``leaf:['eval_histories'][0][0]`` and ``leaf:['key']``.  bfloat16 leaves
are stored as uint16 bit views under ``bf16leaf:``.  Loop counters for
``--resume`` ride along as ``extra:<name>``.  The port writes exactly the
leaves a JAX ``Trainer`` with the same flags expects, and reads the full
train state from files either package wrote.

The ``key`` leaf is the JAX PRNG key of ``cfg.seed`` (``PRNGKey(seed)``'s
raw ``[0, seed]``).  The two frameworks draw different random streams, so
no generator state is carried across in either direction.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .step import AdamState, TrainState, param_keys

_LEAF, _BF16, _EXTRA = "leaf:", "bf16leaf:", "extra:"


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
    out += [(f"['eval_histories'][{i}][{j}]", h)
            for i, hl in enumerate(eval_histories) for j, h in enumerate(hl)]
    return out


def checkpoint_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "model.ckpt.npz")


def save_checkpoint(ckpt_dir: str, state: TrainState, eval_histories,
                    seed: int, extra: dict = None,
                    compress: bool = True) -> str:
    """Write the full train state in the JAX layout (atomically: a crash
    mid-write leaves the previous snapshot intact).  ``extra``: loop
    counters for --resume, stored as ``extra:`` entries."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir)
    arrays = {}
    for k, t in _state_leaves(state, eval_histories):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[_BF16 + k] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[_LEAF + k] = t.numpy()
    arrays[_LEAF + "['key']"] = jax_key(seed)
    for k, v in (extra or {}).items():
        arrays[_EXTRA + k] = np.asarray(v)
    writer = np.savez_compressed if compress else np.savez
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        writer(f, **arrays)
    os.replace(tmp, path)
    print(f"Model saved in file: {path}")
    return path


def load_checkpoint(ckpt_dir: str, state: TrainState, eval_histories,
                    load_history: bool = True):
    """Restore params, Adam state, step and (``load_history``) the train
    and eval histories from a checkpoint either package wrote, IN PLACE
    into ``state`` / ``eval_histories`` (which fix the expected leaves,
    shapes, dtypes and device).  Every leaf is checked before any is
    copied: a missing leaf raises KeyError, a wrong shape ValueError."""
    path = checkpoint_path(ckpt_dir)
    wanted = [(k, t) for k, t in _state_leaves(state, eval_histories)
              if load_history or "histories" not in k]
    with np.load(path, allow_pickle=False) as z:
        files = set(z.files)
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
    print(f"Model restored from file: {path}")
    return state, eval_histories


def load_loop_extras(ckpt_dir: str) -> dict:
    """The --resume loop counters stored beside the state (empty for a
    checkpoint written without them)."""
    with np.load(checkpoint_path(ckpt_dir), allow_pickle=False) as z:
        return {k[len(_EXTRA):]: z[k] for k in z.files
                if k.startswith(_EXTRA)}
