"""Gather-aggregate kernels: hand-written CUDA for Hopper, plain PyTorch beside.

Port of stochastic_gcn_tpu/ops/pallas_spmm.py.  Both functions compute

    out[f] = sum_s w[f, s] * table[idx[f, s]]      (float32 sums)

where a slot with ``w == 0`` or an index outside ``[0, rows)`` contributes
nothing and is never read:

* :func:`hbm_gather_aggregate` — the CV full-neighbourhood term
  ``A_full . h_bar`` over the ``[N+1, d]`` history (Pallas ``_hbm_kernel``).
  The history carries no gradient: a table or weights that require one
  raise, so no gradient can be dropped silently;
* :func:`fanout_aggregate` — the sampled SpMM ``A_samp . X`` over the
  ``[C, d]`` in-field activations (Pallas ``_fanout_kernel``).  Positions
  ``>= C`` (parked slots, sampler/scheduler.py) read as zero rows, matching
  ``ops/gather.py::row_gather``; the Pallas kernel required ``pos < C``.
  It is differentiable in ``X`` through :class:`FanoutAggregate`, whose
  backward :func:`fanout_aggregate_backward` is the transpose, a
  scatter-add ``grad_x[pos[f,s]] += w[f,s] * g[f]``.  It serves the
  estimators without a control variate (NS training, Exact evaluation);
* :func:`cv_fanout_aggregate` — the sampled term of the CV estimator on top
  of the full term, the whole control-variate delta in one launch:
  ``out[f] = base[f] + sum_s w[f,s] * (x[pos[f,s]] - h_bar(field_in[pos[f,s]]))``
  with ``h_bar(n) = hist[n]`` for ``0 <= n < sentinel`` and zero otherwise
  (the JAX model's ``fanout_gather(inputs - history_gather(...)) +
  _full_term(...)``, models/aggregators.py).  Differentiable in ``x``
  through :class:`CVFanoutAggregate`, whose backward is the same
  :func:`fanout_aggregate_backward`: the history and ``base`` are constants.

All run ``csrc/spmm.cu`` on CUDA tensors (see the design notes there) and
the ``*_ref`` plain versions on CPU tensors.  A CUDA tensor never takes the
plain path: the wrapper launches the kernel or raises.  Each wrapper counts
its launches in ``LAUNCHES`` so a run can show that its main path went
through the kernels.  The wrappers neither synchronise nor allocate
outside PyTorch's allocator, so they can be captured in a CUDA graph.

The C entries pick the kernel for a shape themselves (several warps per
output row for the full term, one warp per row at K = 1, for rows above
512 bytes and for the CV delta; a cooperative zero-fill-and-scatter for the
backward).  ``gather_aggregate_split`` runs the gather with a named split
instead, for measurement.
"""

from __future__ import annotations

import torch

from . import _build
from .gather import row_gather

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHUNKS = 128        # 16-byte chunks per row the kernel takes (4 per lane)

# launches per wrapper since the last reset_launches().  A launch recorded
# into a CUDA graph counts once, at capture; replays of the graph do not
# pass through the wrapper and are not counted.
LAUNCHES = {"cv_fanout_aggregate": 0, "fanout_aggregate": 0,
            "fanout_aggregate_backward": 0, "hbm_gather_aggregate": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 sums, or float64 for a float64 input (gradcheck's dtype)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _gather_aggregate_ref(table: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Masked ``index_select`` then ``einsum('fk,fkd->fd')`` in float32."""
    acc = _acc_dtype(table)
    live = (w != 0) & (idx >= 0) & (idx < table.shape[0])
    safe = torch.where(live, idx, 0).to(torch.int64)
    rows = table.index_select(0, safe.reshape(-1)).reshape(
        *idx.shape, table.shape[1]).to(acc)
    rows = torch.where(live.unsqueeze(-1), rows, 0.0)
    return torch.einsum("fk,fkd->fd", torch.where(live, w.to(acc), 0.0), rows)


def fanout_aggregate_ref(x: torch.Tensor, pos: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fanout_aggregate` (differentiable in
    ``x`` through ordinary autograd)."""
    return _gather_aggregate_ref(x, pos, w)


def fanout_aggregate_backward_ref(g: torch.Tensor, pos: torch.Tensor,
                                  w: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fanout_aggregate_backward`: a masked
    ``index_add_`` of ``w[f,s] * g[f]`` at ``pos[f,s]``."""
    live = (w != 0) & (pos >= 0) & (pos < rows)
    contrib = torch.where(live.unsqueeze(-1),
                          w.to(g.dtype).unsqueeze(-1) * g.unsqueeze(1), 0.0)
    safe = torch.where(live, pos, 0).to(torch.int64).reshape(-1)
    out = torch.zeros((rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, safe, contrib.reshape(-1, g.shape[1]))


def hbm_gather_aggregate_ref(table: torch.Tensor, idx: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`hbm_gather_aggregate`."""
    return _gather_aggregate_ref(table, idx, w)


def cv_fanout_aggregate_ref(x: torch.Tensor, hist: torch.Tensor,
                            field_in: torch.Tensor, sentinel: int,
                            pos: torch.Tensor, w: torch.Tensor,
                            base: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cv_fanout_aggregate`, step by step
    as the JAX model composes it: the history rows of the input field
    (sentinel ids read as zero), the subtraction in float32, the sampled
    sum, then ``base`` (differentiable in ``x`` through ordinary
    autograd)."""
    acc = _acc_dtype(x)
    delta = x.to(acc) - row_gather(hist, field_in, sentinel).to(acc)
    return _gather_aggregate_ref(delta, pos, w) + base.to(acc)


def _check_slots(idx: torch.Tensor, w: torch.Tensor) -> None:
    """The slot tensors every wrapper takes, on any device: int32 indices
    and float32 weights of one 2-D shape, contiguous (the scheduler emits
    them so; nothing is copied here)."""
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"index must be int32 and weights float32, got "
                        f"{idx.dtype} and {w.dtype}")
    if idx.dim() != 2 or w.shape != idx.shape:
        raise ValueError(f"index {tuple(idx.shape)} must be 2-D and equal "
                         f"to weights {tuple(w.shape)}")
    if not (idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("index and weights must be contiguous")


def _check(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {table.device}")
    if idx.device != table.device or w.device != table.device:
        raise ValueError("table, index and weight tensors must share a "
                         f"device: {table.device}, {idx.device}, {w.device}")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype {table.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    _check_slots(idx, w)
    if table.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)} must be 2-D")
    if not table.is_contiguous():
        raise ValueError("table, index and weights must be contiguous")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or row_bytes // 16 > _MAX_CHUNKS:
        raise ValueError(f"row width {table.shape[1]} x {table.dtype} must "
                         f"be a multiple of 16 bytes and at most "
                         f"{16 * _MAX_CHUNKS} bytes")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    if idx.numel() >= 2 ** 31:
        raise ValueError("more than 2^31 slots")


def _check_cv(x, hist, field_in, pos, w, base) -> None:
    """What :func:`cv_fanout_aggregate` takes, on any device."""
    if hist.requires_grad or base.requires_grad or w.requires_grad:
        raise ValueError("cv_fanout_aggregate is differentiable in x only: "
                         "the CV history, base and the slot weights must "
                         "not require grad")
    _check_slots(pos, w)
    if x.dim() != 2 or hist.dim() != 2 or hist.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and the history "
                         f"{tuple(hist.shape)} must be 2-D of one width")
    if field_in.dtype != torch.int32 or field_in.shape != (x.shape[0],) \
            or not field_in.is_contiguous():
        raise ValueError(f"field_in must be contiguous int32 with one id per "
                         f"row of x {tuple(x.shape)}, got {field_in.dtype} "
                         f"{tuple(field_in.shape)}")
    if base.shape != (pos.shape[0], x.shape[1]):
        raise ValueError(f"base {tuple(base.shape)} must be "
                         f"{(pos.shape[0], x.shape[1])}")


def _call(device: torch.device, name: str, args: tuple,
          after: tuple = ()) -> None:
    """Call the C entry ``name`` as ``(*args, stream, *after)`` on the
    current stream of ``device``; raise on a cudaError."""
    fn = _build.entry(name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == current:
        err = fn(*args, stream, *after)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream, *after)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _gather(entry: str, counter, table, idx, w, after=()) -> torch.Tensor:
    _check(table, idx, w)
    f, k = idx.shape
    out = torch.empty((f, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if f == 0:
        return out
    _call(table.device, entry,
          (table.data_ptr(), _DTYPE_CODE[table.dtype], table.shape[0],
           table.shape[1], idx.data_ptr(), w.data_ptr(), f, k,
           out.data_ptr()), after)
    if counter is not None:
        LAUNCHES[counter] += 1
    return out


def _fanout_forward(x, pos, w) -> torch.Tensor:
    if x.device.type == "cpu":
        _check_slots(pos, w)
        return fanout_aggregate_ref(x, pos, w)
    return _gather("sgt_fanout_aggregate", "fanout_aggregate", x, pos, w)


def fanout_aggregate_backward(g: torch.Tensor, pos: torch.Tensor,
                              w: torch.Tensor, rows: int) -> torch.Tensor:
    """``grad_x [rows, d]`` of :func:`fanout_aggregate` for the output
    gradient ``g [F, d]``: ``grad_x[pos[f,s]] += w[f,s] * g[f]``, float32;
    positions outside ``[0, rows)`` and zero weights contribute nothing.
    Repeated positions sum."""
    if g.dim() != 2 or pos.dim() != 2 or g.shape[0] != pos.shape[0]:
        raise ValueError(f"output gradient {tuple(g.shape)} must be 2-D with "
                         f"one row per row of pos {tuple(pos.shape)}")
    if rows < 0:
        raise ValueError(f"rows must be >= 0, got {rows}")
    if g.device.type == "cpu":
        _check_slots(pos, w)
        return fanout_aggregate_backward_ref(g, pos, w, rows)
    _check(g, pos, w)
    if g.dtype != torch.float32:
        raise TypeError(f"output gradient must be float32, got {g.dtype}")
    f, k = pos.shape
    if f == 0 or rows == 0:
        return torch.zeros((rows, g.shape[1]), dtype=torch.float32,
                           device=g.device)
    # the kernel's entry zero-fills grad itself (rows of whole 16-byte
    # chunks, and the allocator aligns to more than 16 bytes)
    grad = torch.empty((rows, g.shape[1]), dtype=torch.float32,
                       device=g.device)
    _call(g.device, "sgt_fanout_aggregate_backward",
          (g.data_ptr(), pos.data_ptr(), w.data_ptr(), f, k, rows,
           g.shape[1], grad.data_ptr()))
    LAUNCHES["fanout_aggregate_backward"] += 1
    return grad


class FanoutAggregate(torch.autograd.Function):
    """``fanout_aggregate(x, pos, w)``, differentiable in ``x``: the forward
    and the backward are the two fanout kernels on CUDA tensors and their
    plain versions on CPU tensors.  ``pos`` and ``w`` get no gradient; a
    ``w`` that requires one raises."""

    @staticmethod
    def forward(ctx, x, pos, w):
        if w.requires_grad:
            raise ValueError("fanout weights that require grad are not "
                             "supported: the slot weights get no gradient")
        ctx.save_for_backward(pos, w)
        ctx.rows, ctx.x_dtype = x.shape[0], x.dtype
        return _fanout_forward(x, pos, w)

    @staticmethod
    def backward(ctx, g):
        pos, w = ctx.saved_tensors
        grad = fanout_aggregate_backward(g.contiguous(), pos, w, ctx.rows)
        return grad.to(ctx.x_dtype), None, None


def fanout_aggregate(x: torch.Tensor, pos: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """``out[f] = sum_s w[f,s] * x[pos[f,s]]``: x [C, d] float32 or bfloat16,
    pos [F, K] int32, w [F, K] float32 -> [F, d] float32; differentiable in
    ``x`` (:class:`FanoutAggregate`)."""
    if w.requires_grad or (torch.is_grad_enabled() and x.requires_grad):
        return FanoutAggregate.apply(x, pos, w)
    return _fanout_forward(x, pos, w)         # nothing to record


def _cv_fanout_forward(x, hist, field_in, sentinel, pos, w, base):
    _check_cv(x, hist, field_in, pos, w, base)
    if x.device.type == "cpu":
        return cv_fanout_aggregate_ref(x, hist, field_in, sentinel, pos, w,
                                       base)
    _check(x, pos, w)
    if x.dtype != torch.float32 or base.dtype != torch.float32:
        raise TypeError(f"x and base must be float32, got {x.dtype} and "
                        f"{base.dtype}")
    if hist.dtype not in _DTYPE_CODE:
        raise TypeError(f"history dtype {hist.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    others = {"history": hist, "field_in": field_in, "base": base}
    for name, t in others.items():
        if t.device != x.device:
            raise ValueError(f"x and {name} must share a device: "
                             f"{x.device}, {t.device}")
    if not (hist.is_contiguous() and base.is_contiguous()):
        raise ValueError("the history and base must be contiguous")
    if hist.data_ptr() % 16 or base.data_ptr() % 16:
        raise ValueError("the history and base must be 16-byte aligned")
    f, k = pos.shape
    out = torch.empty_like(base)
    if f == 0:
        return out
    _call(x.device, "sgt_cv_fanout_aggregate",
          (x.data_ptr(), x.shape[0], x.shape[1], hist.data_ptr(),
           _DTYPE_CODE[hist.dtype], hist.shape[0], field_in.data_ptr(),
           int(sentinel), pos.data_ptr(), w.data_ptr(), f, k,
           base.data_ptr(), out.data_ptr()))
    LAUNCHES["cv_fanout_aggregate"] += 1
    return out


class CVFanoutAggregate(torch.autograd.Function):
    """``cv_fanout_aggregate``, differentiable in ``x`` only.  The history
    and ``base`` are constants of the estimator, so the gradient is the
    fanout term's, :func:`fanout_aggregate_backward`.  Only ``pos`` and
    ``w`` are saved: the train step scatters new rows into the history in
    place after the backward, and a saved history would trip autograd's
    version check."""

    @staticmethod
    def forward(ctx, x, hist, field_in, sentinel, pos, w, base):
        ctx.save_for_backward(pos, w)
        ctx.rows, ctx.x_dtype = x.shape[0], x.dtype
        return _cv_fanout_forward(x, hist, field_in, sentinel, pos, w, base)

    @staticmethod
    def backward(ctx, g):
        pos, w = ctx.saved_tensors
        grad = fanout_aggregate_backward(g.contiguous(), pos, w, ctx.rows)
        return grad.to(ctx.x_dtype), None, None, None, None, None, None


def cv_fanout_aggregate(x: torch.Tensor, hist: torch.Tensor,
                        field_in: torch.Tensor, sentinel: int,
                        pos: torch.Tensor, w: torch.Tensor,
                        base: torch.Tensor) -> torch.Tensor:
    """``out[f] = base[f] + sum_s w[f,s] * (x[pos[f,s]] -
    h_bar(field_in[pos[f,s]]))``: x [C, d] float32, hist [R, d] float32 or
    bfloat16, field_in [C] int32, pos [F, K] int32, w [F, K] float32, base
    [F, d] float32 -> a new [F, d] float32.  ``sentinel`` is the node count:
    a field id at or above it reads a zero history row, and a slot with
    ``w == 0`` or ``pos`` outside ``[0, C)`` contributes nothing and reads
    nothing.  Differentiable in ``x`` (:class:`CVFanoutAggregate`); a
    history, ``base`` or ``w`` that requires grad raises."""
    if torch.is_grad_enabled() and x.requires_grad:
        return CVFanoutAggregate.apply(x, hist, field_in, sentinel, pos, w,
                                       base)
    return _cv_fanout_forward(x, hist, field_in, sentinel, pos, w, base)


def hbm_gather_aggregate(table: torch.Tensor, idx: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """``out[f] = sum_s w[f,s] * table[idx[f,s]]``: table [N, d] float32 or
    bfloat16, idx [F, K] int32, w [F, K] float32 -> [F, d] float32.  Forward
    only: a table or weights that require grad raise."""
    if table.requires_grad or w.requires_grad:
        raise ValueError("hbm_gather_aggregate has no backward: its table "
                         "(the CV history) and weights must not require grad")
    if table.device.type == "cpu":
        _check_slots(idx, w)
        return hbm_gather_aggregate_ref(table, idx, w)
    return _gather("sgt_hbm_gather_aggregate", "hbm_gather_aggregate",
                   table, idx, w)


# ---- measurement, on CUDA tensors only ----

def gather_aggregate_split(table: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor, split: int) -> torch.Tensor:
    """The gather-aggregate with a named ``split``: 0 for one warp per
    output row, or 1, 2, 4, 8 warps per row (rows of at most 512 bytes).
    The public functions choose the split themselves; this one is for
    holding every split against the plain version and timing it (the
    kernel's plan is chosen from these times), and does not count in
    ``LAUNCHES``."""
    return _gather("sgt_gather_aggregate_split", None, table, idx, w,
                   (split,))


def gather_plan(table: torch.Tensor, f: int, k: int) -> int:
    """Warps per output row that :func:`hbm_gather_aggregate` and
    :func:`fanout_aggregate` give a ``[f, k]`` slot array over ``table``;
    0 where they run the one-warp-per-row kernel."""
    return _build.entry("sgt_gather_plan")(
        _DTYPE_CODE[table.dtype], table.shape[1], f, k)


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel on ``device``'s current stream: the floor
    under the time of any single launch."""
    _call(torch.device(device), "sgt_empty", ())
