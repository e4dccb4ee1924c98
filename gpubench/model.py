"""The model of a configuration, as the benchmark and its reference see it.

``layers(cfg)`` lists the steps of the forward pass of the reference's
GCN (``gcn/models.py``, the GraphSAGE-normalised variant with layer norm):
under preprocessing (PP) the first aggregation is done at load and its
fully connected blocks come first; then each aggregation is followed by
``num_fc_layers`` blocks, each a dropout and a dense layer; the input of
the first block after an aggregation is ``[self || aggregate]``; every
block but the last has layer norm (``layer_norm``) and a ReLU.  The dense
layers are named ``dense0``, ``dense1``, ... as the port and the JAX
package name them, which is how :func:`load_weights` finds them.

:func:`make_weights` draws the weights from the seed on the device
(Glorot uniform, zero offsets, unit scales), one generator and one draw for
all of them; the port and the reference get the same tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Dense:
    name: str
    fan_in: int
    fan_out: int
    norm: bool
    relu: bool
    rows: int        # index of the field whose rows the layer computes


@dataclass(frozen=True)
class Aggregate:
    index: int       # aggregation l maps field l to field l + 1


def layers(model: dict, feature_dim: int, num_classes: int,
           preprocess: bool) -> list:
    """The forward pass: a list of :class:`Dense` (each with its dropout
    before it) and :class:`Aggregate` steps."""
    hidden, fc = int(model["hidden1"]), int(model["num_fc_layers"])
    if model["normalization"] != "graphsage":
        raise ValueError("the reference implements graphsage normalization")
    n_agg = int(model["num_layers"]) - (1 if preprocess else 0)
    out, count = [], 0

    def dense(fan_in, fan_out, last, rows):
        nonlocal count
        out.append(Dense(f"dense{count}", fan_in, fan_out,
                         bool(model["layer_norm"]) and not last, not last,
                         rows))
        count += 1

    if preprocess:
        for j in range(fc):
            last = n_agg == 0 and j == fc - 1
            dense(2 * feature_dim if j == 0 else hidden,
                  num_classes if last else hidden, last, 0)
    for l in range(n_agg):
        out.append(Aggregate(l))
        width = (hidden if preprocess else feature_dim) if l == 0 else hidden
        for j in range(fc):
            last = l == n_agg - 1 and j == fc - 1
            dense(2 * width if j == 0 else hidden,
                  num_classes if last else hidden, last, l + 1)
    return out


def make_weights(steps: list, seed: int, device) -> dict:
    """``{name: {"weights", "offset"?, "scale"?}}`` for the dense layers of
    ``steps``: Glorot uniform weights from one draw of a generator seeded
    with ``seed`` on ``device``."""
    dense = [s for s in steps if isinstance(s, Dense)]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(s.fan_in * s.fan_out for s in dense), generator=gen,
                   device=device)
    params, at = {}, 0
    for s in dense:
        limit = math.sqrt(6.0 / (s.fan_in + s.fan_out))
        n = s.fan_in * s.fan_out
        p = {"weights": ((2.0 * u[at:at + n] - 1.0) * limit).reshape(
            s.fan_in, s.fan_out)}
        at += n
        if s.norm:
            p["offset"] = torch.zeros((1, s.fan_out), device=device)
            p["scale"] = torch.ones((1, s.fan_out), device=device)
        params[s.name] = p
    return params


def load_weights(params: dict, into: dict) -> None:
    """Copy ``params`` into the port's parameter tree ``into`` (same names
    and shapes, which is checked)."""
    if {l: sorted(p) for l, p in params.items()} != \
            {l: sorted(p) for l, p in into.items()}:
        raise ValueError("the port's parameters are not the model's: "
                         f"{sorted(into)}")
    with torch.no_grad():
        for l, p in params.items():
            for n, t in p.items():
                if into[l][n].shape != t.shape:
                    raise ValueError(f"{l}/{n}: {tuple(into[l][n].shape)} "
                                     f"!= {tuple(t.shape)}")
                into[l][n].copy_(t)


def clone(params: dict, device=None) -> dict:
    return {l: {n: t.detach().to(device or t.device, copy=True)
                for n, t in p.items()} for l, p in params.items()}
