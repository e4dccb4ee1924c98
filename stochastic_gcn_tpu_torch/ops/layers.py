"""Functional layer library.

Port of stochastic_gcn_tpu/ops/layers.py.  Parameters
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

Under tensor parallelism (``--tp``) a layer whose weights are
column-sharded takes ``mesh`` (parallel/mesh.py): its input is whole, its
product is this rank's column block, and the layer norm's row moments
are sums over the model group.  A dropout draw on a column block draws
the whole tensor and keeps this rank's rows and columns
(:func:`rows_draw`), so the masks are those of one device.

Every layer that takes the input features also takes them padded-sparse
(:class:`~..data.graph.PaddedSparseFeatures`): ``matmul`` gathers the
weights' rows by column id (the hand-written ``fanout_aggregate`` kernel on
the card, its plain version on the CPU), ``dropout`` masks the stored
values, and det-dropout's variance stays padded-sparse with squared values.
"""

from __future__ import annotations

import math

import torch

from ..data.graph import PaddedSparseFeatures
from ..parallel.mesh import model_sum
from .cuda_spmm import fanout_aggregate


def glorot(gen: torch.Generator, shape) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    out = torch.empty(shape, device=gen.device)
    return out.uniform_(-limit, limit, generator=gen)


def matmul(x, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; a narrower input dtype (bfloat16 features) is promoted to
    the weights' dtype, as JAX's mixed-precision dot does.

    For padded-sparse ``x`` the product is ``out[r] = sum_c val[r,c] *
    w[idx[r,c]]``, the sentinel column ``dim`` reading zero: the JAX
    package's ``take`` + ``einsum``, here :func:`fanout_aggregate` with
    ``w`` as the table (``[dim, out]``; a position ``>= dim`` reads as a
    zero row), ``idx`` as the positions and the values in float32 as the
    slot weights.  It is differentiable in ``w``; the gradient reads no
    slot past the rows' ``ends`` where the table has them."""
    if isinstance(x, PaddedSparseFeatures):
        return fanout_aggregate(w, x.idx, x.val.float(), x.ends)
    return x.to(w.dtype) @ w


def row_moments(x: torch.Tensor, mesh=None) -> tuple:
    """``(mean, var)`` of every row of ``x``, two passes as the JAX layer
    (the mean, then the mean of the squared deviation).  With a ``mesh``
    ``x`` holds this rank's columns of a row whose other columns the
    model group holds: each pass is one sum over the group of the ranks'
    ``[rows, 1]`` partial sums, divided by the whole width (the same two
    passes, the row's sums split by column block)."""
    if mesh is None:
        mean = x.mean(dim=1, keepdim=True)
        return mean, (x - mean).square().mean(dim=1, keepdim=True)
    width = x.shape[1] * mesh.model_size
    mean = model_sum(x.sum(dim=1, keepdim=True), mesh) / width
    var = model_sum((x - mean).square().sum(dim=1, keepdim=True),
                    mesh) / width
    return mean, var


def layer_norm(x: torch.Tensor, offset: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-9, mesh=None) -> torch.Tensor:
    """x_hat = (x - mean) * rsqrt(var + eps) * scale + offset, per row;
    ``mesh``: ``x``, ``offset`` and ``scale`` are this rank's columns
    (:func:`row_moments`)."""
    mean, var = row_moments(x, mesh)
    return (x - mean) * torch.rsqrt(var + eps) * scale + offset


def rows_draw(draw, shape, block=None) -> torch.Tensor:
    """``draw(shape)``, or for a row block ``block = (rows, lo)`` of a
    ``rows``-row tensor (a rank's rows under data parallelism) the draw of
    the whole ``(rows, *shape[1:])`` tensor narrowed to rows ``[lo, lo +
    shape[0])``: every rank takes its rows of the one global draw, so the
    random stream stays in step across ranks and equals one device's.
    ``block = (rows, lo, width, cols)``: the tensor is also a column block
    (tensor parallelism), ``cols`` the index of its columns among the
    whole ``width``; the draw is of the whole ``(rows, width)``."""
    if block is None:
        return draw(shape)
    rows, lo = block[:2]
    if len(block) == 2:
        return draw((rows, *shape[1:])).narrow(0, lo, shape[0])
    width, cols = block[2:]
    return draw((rows, width)).narrow(0, lo, shape[0]).index_select(1, cols)


def dropout(gen: torch.Generator, x, keep_prob: float, block=None):
    """Inverted dropout; the identity at ``keep_prob >= 1``.  Padded-sparse
    ``x`` keeps its columns and drops stored values, as the reference's
    sparse_dropout over the nonzeros (gcn/layers.py:23-28).  ``block``:
    ``x`` is a row block of a larger tensor (:func:`rows_draw`)."""
    if keep_prob >= 1.0:
        return x
    if isinstance(x, PaddedSparseFeatures):
        return x.replace(val=dropout(gen, x.val, keep_prob, block))
    keep = rows_draw(lambda s: torch.rand(s, generator=gen, device=x.device),
                     x.shape, block) < keep_prob
    return torch.where(keep, x, 0.0) * (1.0 / keep_prob)


def _dropout(gen, x, keep_prob: float, block):
    # the module's dropout as it is bound at call time, given a block only
    # when there is one
    if block is None:
        return dropout(gen, x, keep_prob)
    return dropout(gen, x, keep_prob, block)


def init_dense(gen: torch.Generator, input_dim: int, output_dim: int,
               norm: bool) -> dict:
    p = {"weights": glorot(gen, (input_dim, output_dim))}
    if norm:
        p["offset"] = torch.zeros((1, output_dim), device=gen.device)
        p["scale"] = torch.ones((1, output_dim), device=gen.device)
    return p


def dense(params: dict, x: torch.Tensor, act, norm: bool,
          mesh=None) -> torch.Tensor:
    """``act(norm(x @ W))``; ``mesh``: ``W`` is this rank's column block
    (module docstring)."""
    out = matmul(x, params["weights"])
    if norm:
        out = layer_norm(out, params["offset"], params["scale"], eps=1e-9,
                         mesh=mesh)
    return act(out)


def init_aug_dense(gen: torch.Generator, input_dim: int, output_dim: int,
                   norm: bool) -> dict:
    return init_dense(gen, input_dim, output_dim, norm)


def aug_dropout_dense(params: dict, gen: torch.Generator, inputs,
                      keep_prob: float, act, norm: bool, block=None,
                      mesh=None):
    """``(act(norm(dropout(x) @ W)), act(norm(mu @ W)).detach())`` for
    ``inputs = (x, mu)``, or ``x = mu = inputs`` for a single tensor;
    ``mesh``: ``W`` is this rank's column block (module docstring)."""
    x, mu = inputs if isinstance(inputs, tuple) else (inputs, inputs)
    x = matmul(_dropout(gen, x, keep_prob, block), params["weights"])
    mu = matmul(mu, params["weights"])
    if norm:
        x = layer_norm(x, params["offset"], params["scale"], eps=1e-9,
                       mesh=mesh)
        mu = layer_norm(mu, params["offset"], params["scale"], eps=1e-9,
                        mesh=mesh)
    return act(x), act(mu).detach()


def init_det_dropout_fc(gen: torch.Generator, input_dim: int,
                        output_dim: int, norm: bool) -> dict:
    return init_dense(gen, input_dim, output_dim, norm)


_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def det_dropout_fc(params: dict, inputs, keep_prob: float, norm: bool,
                   mesh=None):
    """Moments ``(mu, var)`` of ``relu(norm(dropout(h) @ W))`` for an input
    with moments ``inputs = (mu, var)``, or a deterministic input tensor
    (variance ``(1-p)/p * h^2`` from the dropout alone; for padded-sparse
    ``h`` the variance is padded-sparse too, with squared values, and its
    linear step gathers the rows of ``W^2``).

    The 1.2 variance factor, the 1e-10 epsilons (layer norm, shared by the
    variance path so all-zero sentinel rows stay finite) and the 1e-20
    floor under the square root sit where the JAX layer has them.
    ``mesh``: ``W`` is this rank's column block, and the layer norm's row
    moments of ``mu`` are model-group sums (:func:`row_moments`)."""
    p = keep_prob
    if isinstance(inputs, tuple):
        mu, var = inputs
        mu2 = mu.square()
        var = (var + mu2) / p - mu2
    elif isinstance(inputs, PaddedSparseFeatures):
        mu = inputs
        var = inputs.replace(val=(1.0 - p) / p * inputs.val.square())
    else:
        mu = inputs
        var = (1.0 - p) / p * inputs.square()

    w = params["weights"]
    mu = matmul(mu, w)
    var = matmul(var, w.square()) * 1.2

    if norm:
        mean, variance = row_moments(mu, mesh)
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


def dropout_layer(gen: torch.Generator, inputs, keep_prob: float, cvd: bool,
                  block=None):
    """Dropout over the estimator's input: the noisy stream of a CVD pair
    ``(h, mu)``; a Gaussian sample ``mu + eps * sqrt(var + 1e-10)`` of a
    moment pair ``(mu, var)``; or a plain tensor.  ``block``: the inputs
    are a row block of larger tensors (:func:`rows_draw`)."""
    if cvd and isinstance(inputs, tuple):
        return _dropout(gen, inputs[0], keep_prob, block)
    if isinstance(inputs, tuple):
        mu, var = inputs
        eps = rows_draw(lambda s: torch.randn(s, generator=gen,
                                              device=var.device,
                                              dtype=var.dtype),
                        var.shape, block)
        return _dropout(gen, mu + eps * torch.sqrt(var + 1e-10), keep_prob,
                        block)
    return _dropout(gen, inputs, keep_prob, block)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x
