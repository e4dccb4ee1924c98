"""Functional layer library.

Port of stochastic_gcn_tpu/ops/layers.py (dense inputs only).  Parameters
are plain ``{name: Tensor}`` dicts with the JAX names and layout
(``weights`` is ``[in, out]``, applied as ``x @ W``), so weights carry
across with no transpose.  Every random draw takes an explicit
``torch.Generator``.

* glorot init — uniform(+-sqrt(6/(fan_in+fan_out)))
* layer norm  — per-row moments, eps 1e-9
* dropout     — inverted scaling with keep_prob
* aug_dropout_dense — CVD's dual-stream FC: a noisy stream ``x`` with
  dropout and a clean stream ``mu`` share weights, norm and activation;
  ``mu`` is detached
* det_dropout_fc — analytic ``(mu, var)`` propagation through dropout,
  linear, layer norm and a rectified-Gaussian ReLU
* dropout_layer — dropout over the estimator's input type

Padded-sparse inputs are not ported yet: the dual-stream and moment layers
raise on anything but a tensor or a pair of tensors.
"""

from __future__ import annotations

import math

import torch


def glorot(gen: torch.Generator, shape) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    out = torch.empty(shape, device=gen.device)
    return out.uniform_(-limit, limit, generator=gen)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense ``x @ w``; a narrower input dtype (bfloat16 features) is
    promoted to the weights' dtype, as JAX's mixed-precision dot does."""
    return x.to(w.dtype) @ w


def layer_norm(x: torch.Tensor, offset: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-9) -> torch.Tensor:
    """x_hat = (x - mean) * rsqrt(var + eps) * scale + offset, per row."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + offset


def dropout(gen: torch.Generator, x: torch.Tensor,
            keep_prob: float) -> torch.Tensor:
    """Inverted dropout; the identity at ``keep_prob >= 1``."""
    if keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x, 0.0) * (1.0 / keep_prob)


def init_dense(gen: torch.Generator, input_dim: int, output_dim: int,
               norm: bool) -> dict:
    p = {"weights": glorot(gen, (input_dim, output_dim))}
    if norm:
        p["offset"] = torch.zeros((1, output_dim), device=gen.device)
        p["scale"] = torch.ones((1, output_dim), device=gen.device)
    return p


def dense(params: dict, x: torch.Tensor, act, norm: bool) -> torch.Tensor:
    out = matmul(x, params["weights"])
    if norm:
        out = layer_norm(out, params["offset"], params["scale"], eps=1e-9)
    return act(out)


def _dense_only(*xs) -> None:
    for x in xs:
        if not isinstance(x, torch.Tensor):
            raise NotImplementedError(
                f"{type(x).__name__} inputs (padded-sparse features) are not "
                "ported yet (ROADMAP.md, queue 1); pass --dense_input")


def init_aug_dense(gen: torch.Generator, input_dim: int, output_dim: int,
                   norm: bool) -> dict:
    return init_dense(gen, input_dim, output_dim, norm)


def aug_dropout_dense(params: dict, gen: torch.Generator, inputs,
                      keep_prob: float, act, norm: bool):
    """``(act(norm(dropout(x) @ W)), act(norm(mu @ W)).detach())`` for
    ``inputs = (x, mu)``, or ``x = mu = inputs`` for a single tensor."""
    x, mu = inputs if isinstance(inputs, tuple) else (inputs, inputs)
    _dense_only(x, mu)
    x = matmul(dropout(gen, x, keep_prob), params["weights"])
    mu = matmul(mu, params["weights"])
    if norm:
        x = layer_norm(x, params["offset"], params["scale"], eps=1e-9)
        mu = layer_norm(mu, params["offset"], params["scale"], eps=1e-9)
    return act(x), act(mu).detach()


def init_det_dropout_fc(gen: torch.Generator, input_dim: int,
                        output_dim: int, norm: bool) -> dict:
    return init_dense(gen, input_dim, output_dim, norm)


_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def det_dropout_fc(params: dict, inputs, keep_prob: float, norm: bool):
    """Moments ``(mu, var)`` of ``relu(norm(dropout(h) @ W))`` for an input
    with moments ``inputs = (mu, var)``, or a deterministic input tensor
    (variance ``(1-p)/p * h^2`` from the dropout alone).

    The 1.2 variance factor, the 1e-10 epsilons (layer norm, shared by the
    variance path so all-zero sentinel rows stay finite) and the 1e-20
    floor under the square root sit where the JAX layer has them."""
    p = keep_prob
    if isinstance(inputs, tuple):
        mu, var = inputs
        _dense_only(mu, var)
        mu2 = mu.square()
        var = (var + mu2) / p - mu2
    else:
        _dense_only(inputs)
        mu = inputs
        var = (1.0 - p) / p * inputs.square()

    w = params["weights"]
    mu = matmul(mu, w)
    var = matmul(var, w.square()) * 1.2

    if norm:
        mean = mu.mean(dim=1, keepdim=True)
        variance = (mu - mean).square().mean(dim=1, keepdim=True)
        mu = ((mu - mean) * torch.rsqrt(variance + 1e-10)
              * params["scale"] + params["offset"])
        var = var * (params["scale"].square() / (variance + 1e-10))

    # rectified-Gaussian ReLU moments
    sigma = torch.sqrt(var + 1e-20)
    alpha = -mu / sigma
    phi = torch.exp(-0.5 * alpha.square()) * _INV_SQRT_2PI
    big_phi = torch.special.ndtr(alpha)
    z = torch.special.ndtr(-alpha) + 1e-10
    phi_z = phi / z

    m = mu + sigma * phi_z
    mu_out = z * m
    var_out = torch.relu(var * (1.0 + alpha * phi_z - phi_z.square())) \
        + 1e-10
    var_out = z * var_out + z * big_phi * mu_out.square()
    return mu_out, var_out


def dropout_layer(gen: torch.Generator, inputs, keep_prob: float, cvd: bool):
    """Dropout over the estimator's input: the noisy stream of a CVD pair
    ``(h, mu)``; a Gaussian sample ``mu + eps * sqrt(var + 1e-10)`` of a
    moment pair ``(mu, var)``; or a plain tensor."""
    if cvd and isinstance(inputs, tuple):
        return dropout(gen, inputs[0], keep_prob)
    if isinstance(inputs, tuple):
        mu, var = inputs
        eps = torch.randn(var.shape, generator=gen, device=var.device,
                          dtype=var.dtype)
        return dropout(gen, mu + eps * torch.sqrt(var + 1e-10), keep_prob)
    return dropout(gen, inputs, keep_prob)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x
