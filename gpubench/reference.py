"""The plain reference that decides ``correct``.

Plain PyTorch in float32 with TF32 off (on the card a float32 product may
run in TF32 unless told not to), on the graph of ``data.py``: it imports
nothing of the port, takes none of the port's tensors but its outputs and
the random draws its timed path made, and works out again everything the
port derives from the inputs: the normalised adjacency (``1/deg`` a row,
as ``graphsage_normalize_adj``), its cap at ``pad_degree`` (the port's
``cap_adj_degree`` draws, repeated by :func:`capped`; the preprocessed
features use every edge), the preprocessed features, the fields of a
batch and the aggregations.

Training (``train_steps``) follows the port's first steps: the same
weights and, with a control variate, the same history table to start
from, the batches the port trained on, the neighbours it sampled (checked
one by one against the capped graph, ``bad_draws``, and their spread over
each row's slots, ``draw_z``) and the dropout masks it drew (read off its
dropout inputs and outputs: where the port's input is zero the mask
cannot be read and does not matter; each mask's kept share of the
readable entries against ``keep_prob``, ``keep_z``).  The fields of an exact step are derived here and
compared with the port's (``fields``).  Each step: forward, loss, autograd,
Adam (the port's hyperparameters, optax's arithmetic), and, with a control
variate, the history rows written after the update, rounded to the
configuration's storage dtype.  A field may repeat an id (the port's
append-only layout); every duplicate carries its own dropout sample, and
which write lands is unspecified on CUDA, element by element
(``index_copy_`` with repeated indices), so each written element is
compared with that column of every candidate and the reference then keeps
the candidate's value that matched, rounded as the port stores it.

Serving (``predict``): exact inference over the whole graph, then the
requested rows.

Everything runs in ``float32``; ``precision="tf32"`` runs the dense
products in TF32 (the control of ``check.py``: on the card the cuBLAS
TF32 path, on the CPU the operands rounded to TF32's 10-bit mantissa).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .model import Aggregate, Dense

EDGE_BLOCK = 1 << 20       # edges a block of the aggregation gathers
DRAW_BINS = 8              # bins of a sampled slot's place in its row
MASK_ZERO, MASK_DROPPED, MASK_KEPT = 0, 1, 2   # a recorded mask's entries


# ----------------------------- precision ---------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (8-bit exponent, 10-bit mantissa), to nearest
    even, as the tensor cores read their operands."""
    i = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision_of(precision: str, device):
    """Products in ``precision``: float32 with TF32 off, or TF32."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _matmul(x, w, precision: str):
    if precision == "tf32" and x.device.type != "cuda":
        # the operands rounded, the gradient passed through unrounded
        x = x + (tf32_round(x.detach()) - x).detach()
        w = w + (tf32_round(w.detach()) - w).detach()
    return x @ w


# ------------------------------- graph -----------------------------------

def row_weights(indptr: torch.Tensor) -> torch.Tensor:
    """``[N]`` float32 ``1/deg`` of each row (0 where a row is empty): the
    graphsage row normalisation."""
    deg = (indptr[1:] - indptr[:-1]).float()
    return torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)


def edges(indptr: torch.Tensor, rows: torch.Tensor):
    """Every edge of the rows ``rows`` (node ids, ``N`` for none): (index
    into ``rows``, position in the CSR arrays), in CSR order."""
    n = indptr.shape[0] - 1
    live = rows < n
    r = torch.where(live, rows, 0)
    deg = torch.where(live, indptr[r + 1] - indptr[r], 0)
    at = torch.repeat_interleave(torch.arange(rows.shape[0],
                                              device=rows.device), deg)
    first = torch.cumsum(deg, 0) - deg
    pos = torch.arange(at.shape[0], device=rows.device) - first[at] \
        + indptr[r][at]
    return at, pos


def neighbours(indptr: torch.Tensor, indices: torch.Tensor,
               rows: torch.Tensor):
    """Every edge of the rows ``rows``: (index into ``rows``, neighbour
    id), in CSR order."""
    at, pos = edges(indptr, rows)
    return at, indices[pos]


@dataclass
class Rows:
    """A graph as an aggregation reads it: CSR ``indptr`` / ``indices`` and
    each edge's weight ``w``."""
    indptr: torch.Tensor
    indices: torch.Tensor
    w: torch.Tensor

    def of(self, rows: torch.Tensor):
        """(index into ``rows``, neighbour id, weight) of every edge of the
        rows ``rows``."""
        at, pos = edges(self.indptr, rows)
        return at, self.indices[pos], self.w[pos]


def normalised(indptr: torch.Tensor, indices: torch.Tensor) -> Rows:
    """Every edge of the 0/1 adjacency at ``1/deg`` of its row."""
    deg = indptr[1:] - indptr[:-1]
    return Rows(indptr, indices,
                torch.repeat_interleave(row_weights(indptr), deg))


def capped(indptr: torch.Tensor, indices: torch.Tensor, cap: int,
           seed: int) -> Rows:
    """The normalised adjacency with each row longer than ``cap`` cut to
    ``cap`` edges, as the port's padded graphs hold it: a frozen copy of
    the draws of ``data/preprocess.py::cap_adj_degree`` (one
    ``numpy.random.default_rng(seed)``; for each long row, in row order,
    ``choice(deg, cap, replace=False)``, the picks kept in the drawn order
    at ``1/deg`` rescaled by ``deg / cap`` in float32, as numpy computes
    it), over columns in sorted order."""
    full = normalised(indptr, indices)
    ip = indptr.cpu().numpy()
    deg = np.diff(ip)
    new_deg = np.minimum(deg, cap)
    new_ip = np.zeros_like(ip)
    np.cumsum(new_deg, out=new_ip[1:])
    w = full.w.cpu().numpy()
    # each edge's source position: short rows copied, long rows drawn
    src = np.arange(new_ip[-1], dtype=np.int64) - np.repeat(
        new_ip[:-1], new_deg) + np.repeat(ip[:-1], new_deg)
    new_w = w[src]
    rng = np.random.default_rng(seed)
    for r in np.flatnonzero(deg > cap):
        lo, d = ip[r], ip[r + 1] - ip[r]
        pick = lo + rng.choice(d, size=cap, replace=False)
        at = slice(new_ip[r], new_ip[r] + cap)
        src[at] = pick
        new_w[at] = w[pick] * (d / float(cap))
    dev = indices.device
    return Rows(torch.from_numpy(new_ip).to(dev),
                indices[torch.from_numpy(src).to(dev)],
                torch.from_numpy(new_w).to(dev))


def graph_rows(indptr: torch.Tensor, indices: torch.Tensor,
               cap: Optional[int], seed: int) -> Rows:
    """The rows the port's padded graph holds: capped at ``cap`` (None:
    every edge)."""
    return normalised(indptr, indices) if cap is None else \
        capped(indptr, indices, cap, seed)


def aggregate(n_out: int, at: torch.Tensor, src: torch.Tensor,
              w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``out[at[e]] += w[e] * h[src[e]]`` over the edges, in blocks."""
    out = h.new_zeros((n_out, h.shape[1]))
    for lo in range(0, at.shape[0], EDGE_BLOCK):
        hi = lo + EDGE_BLOCK
        part = h.index_select(0, src[lo:hi]) * w[lo:hi, None]
        out = out.index_add(0, at[lo:hi], part) if h.requires_grad \
            else out.index_add_(0, at[lo:hi], part)
    return out


# ------------------------------- layers ----------------------------------

def dense(p: dict, x: torch.Tensor, s: Dense, precision: str):
    out = _matmul(x, p["weights"], precision)
    if s.norm:
        mean = out.mean(dim=1, keepdim=True)
        var = (out - mean).square().mean(dim=1, keepdim=True)
        out = (out - mean) * torch.rsqrt(var + 1e-9) * p["scale"] \
            + p["offset"]
    return torch.relu(out) if s.relu else out


def loss_of(logits: torch.Tensor, labels: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the valid rows (class ids)."""
    ce = -torch.log_softmax(logits, dim=1).gather(1, labels[:, None])[:, 0]
    return (ce * valid).sum() / valid.sum().clamp(min=1.0)


def bf16_half_ulp(x: torch.Tensor) -> torch.Tensor:
    """Half the spacing of bfloat16 values at ``|x|`` (0 at 0): the most
    round-to-nearest storage moves a value."""
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 9))


# ------------------------------- training --------------------------------

@dataclass
class Draw:
    """What one train step of the port drew and computed, as recorded by
    ``run.py``: the fields (input side first, node ids, ``N`` for padding),
    for a sampled layer the sampled slots (``slot_pos`` into its input
    field and ``slot_w``), the dropout masks in order (``MASK_*`` codes
    over the field's capacity rows), the loss it
    reported, and the history rows of the distinct ids of the first field
    after the step (``hist_ids``, ``hist_rows``)."""
    fields: list
    masks: list
    loss: float
    slot_pos: Optional[torch.Tensor] = None
    slot_w: Optional[torch.Tensor] = None
    hist_ids: Optional[torch.Tensor] = None
    hist_rows: Optional[torch.Tensor] = None


@dataclass
class Outcome:
    """The reference's side of a train check."""
    losses: list = field(default_factory=list)
    grad1: dict = field(default_factory=dict)      # first gradient, by leaf
    grads: list = field(default_factory=list)      # every step's, by leaf
    params: dict = field(default_factory=dict)     # after the last step
    bad_draws: int = 0
    draw_bins: list = field(default_factory=list)  # [observed, expected]
    field_errors: int = 0
    history_gap: float = 0.0
    history_detail: dict = field(default_factory=dict)
    keep_share: list = field(default_factory=list)  # (kept, read), by step


class Trainer:
    """The reference's training state: ``graph`` (``data.Graph`` on the
    reference's device), the model's ``steps`` (``model.layers``),
    ``params`` (copied), the estimator ``est`` (``cv``, ``preprocess``,
    ``keep_prob``, ``learning_rate``, ``beta1``, ``beta2``,
    ``weight_decay``, ``history_dtype``), the train graph's rows as the
    port's padded graph holds them (``rows``, :func:`graph_rows`), and with
    a control variate the history table to start from (``hist0``, ``[N,
    hidden]``, as stored)."""

    def __init__(self, graph, steps, params, est: dict, rows: Rows,
                 precision: str = "float32", half_batch: bool = False,
                 hist0: Optional[torch.Tensor] = None):
        self.g, self.steps, self.est = graph, steps, est
        self.precision, self.half_batch = precision, half_batch
        dev = graph.feats.device
        self.n = graph.num_nodes
        self.params = {l: {k: t.detach().clone().to(dev)
                           for k, t in p.items()} for l, p in params.items()}
        self.mu = {l: {k: torch.zeros_like(t) for k, t in p.items()}
                   for l, p in self.params.items()}
        self.nu = {l: {k: torch.zeros_like(t) for k, t in p.items()}
                   for l, p in self.params.items()}
        self.count = 0
        self.rows = rows
        self.pp_rows = normalised(graph.train_indptr, graph.train_indices)
        # the capped train graph's edges as sorted keys ``row * (N + 1) +
        # column``, and each key's position in the CSR arrays
        keys = torch.repeat_interleave(
            torch.arange(self.n, device=dev),
            rows.indptr[1:] - rows.indptr[:-1]) * (self.n + 1) + rows.indices
        self.keys, self.key_pos = torch.sort(keys)
        hidden = [s for s in steps if isinstance(s, Dense)][0].fan_out
        self.hist = torch.zeros((self.n + 1, hidden), device=dev) \
            if est["cv"] else None
        if hist0 is not None:
            self.hist[:self.n] = hist0.to(dev).float()
        self.out = Outcome()
        self.out.draw_bins = [torch.zeros(DRAW_BINS, dtype=torch.float64),
                              torch.zeros(DRAW_BINS, dtype=torch.float64)]

    # -- inputs ---------------------------------------------------------
    def _inputs(self, ids: torch.Tensor) -> torch.Tensor:
        """The model's input rows of node ids ``ids``: the features, or
        under PP ``[X || A_train X]`` worked out here."""
        g = self.g
        x = g.feats.index_select(0, ids)
        if not self.est["preprocess"]:
            return x
        at, nbr, w = self.pp_rows.of(ids)
        ax = aggregate(ids.shape[0], at, nbr, w, g.feats)
        return torch.cat([x, ax], dim=1)

    # -- fields ---------------------------------------------------------
    def _exact_live(self, batch_live: torch.Tensor, n_agg: int) -> list:
        """The live ids of each field of an exact step, input side first:
        the output field, then its new neighbours in id order (the port's
        dedup layout, sampler/scheduler.py::compact_field)."""
        out = [batch_live]
        for _ in range(n_agg):
            f = out[-1]
            _, nbr, _ = self.rows.of(f)
            seen = torch.zeros(self.n + 1, dtype=torch.bool,
                               device=f.device)
            seen[f] = True
            new = torch.unique(nbr)
            out.append(torch.cat([f, new[~seen[new]]]))
        return out[::-1]

    def _check_draws(self, field_out: torch.Tensor, nbr: torch.Tensor,
                     w: torch.Tensor) -> int:
        """Sampled slots that are no draw of the capped graph: a neighbour
        id that is not an edge of its capped row (or not the sentinel for
        an empty row), or a weight other than the edge's times the capped
        degree (a degree-1 sample of the capped row).  The places of the
        sound draws in their rows are binned into ``out.draw_bins``:
        observed, and expected of a uniform pick."""
        rows, n = self.rows, self.n
        live = field_out < n
        r = torch.where(live, field_out, 0)
        dcap = torch.where(live, rows.indptr[r + 1] - rows.indptr[r], 0)
        q = r * (n + 1) + torch.where(nbr < n, nbr, 0)
        keys = self.keys
        if keys.shape[0]:
            at = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
            pos = self.key_pos[at]
            place = pos - rows.indptr[r]
            is_edge = keys[at] == q
            want_w = rows.w[pos] * dcap.float()
        else:
            place = torch.zeros_like(r)
            is_edge = torch.zeros_like(live)
            want_w = torch.zeros_like(w)
        ok_live = live & (dcap > 0) & is_edge & (
            (w - want_w).abs() <= 1e-6 * want_w.abs())
        ok_empty = live & (dcap == 0) & (nbr == n) & (w == 0)
        ok_pad = ~live & (w == 0)
        # rank r of d falls in bin floor(r * B / d): ceil((b + 1) d / B) -
        # ceil(b d / B) of the d ranks fall in bin b
        d = dcap[ok_live].double()
        b = torch.arange(DRAW_BINS, dtype=torch.float64, device=d.device)
        share = (torch.ceil((b[None, :] + 1) * d[:, None] / DRAW_BINS)
                 - torch.ceil(b[None, :] * d[:, None] / DRAW_BINS)) \
            / d[:, None]
        got = torch.bincount(place[ok_live] * DRAW_BINS // dcap[ok_live],
                             minlength=DRAW_BINS)
        self.out.draw_bins[0] += got.double().cpu()
        self.out.draw_bins[1] += share.sum(dim=0).cpu()
        return int((~(ok_live | ok_empty | ok_pad)).sum())

    # -- one step -------------------------------------------------------
    def step(self, d: Draw) -> None:
        """One train step on the port's batch and draws."""
        n, est, dev = self.n, self.est, self.g.feats.device
        fields = [f.to(dev).long() for f in d.fields]
        live_pos = [torch.nonzero(f < n)[:, 0] for f in fields]
        ids = [f[p] for f, p in zip(fields, live_pos)]
        aggs = [s for s in self.steps if isinstance(s, Aggregate)]
        for l in range(len(fields) - 1):
            m = ids[l + 1].shape[0]
            if not torch.equal(ids[l][:m], ids[l + 1]):
                raise ValueError(f"field {l + 1} is not a prefix of "
                                 f"field {l}")
        if est["cv"]:
            slot_pos = d.slot_pos.to(dev).long()
            slot_w = d.slot_w.to(dev).float()
            if slot_pos.shape[1] != 1 or len(aggs) != 1:
                raise ValueError("the CV reference is for one aggregation "
                                 "of degree 1")
            nbr_id = torch.where(slot_pos[:, 0] < fields[0].shape[0],
                                 fields[0][slot_pos[:, 0].clamp(
                                     max=fields[0].shape[0] - 1)], n)
            self.out.bad_draws += self._check_draws(fields[1], nbr_id,
                                                    slot_w[:, 0])
        else:
            want = self._exact_live(ids[-1], len(aggs))
            self.out.field_errors += sum(
                int(a.shape[0] != b.shape[0]) or int((a != b).sum())
                for a, b in zip(want, ids))
        # compact row of each capacity position of each field (-1: padding)
        cidx = []
        for f, p in zip(fields, live_pos):
            c = torch.full((f.shape[0],), -1, dtype=torch.int64, device=dev)
            c[p] = torch.arange(p.shape[0], device=dev)
            cidx.append(c)

        params = {l: {k: t.detach().requires_grad_()
                      for k, t in p.items()} for l, p in self.params.items()}
        h = self._inputs(ids[0])
        masks = iter(d.masks)
        new_rows = None
        shares = []
        for s in self.steps:
            if isinstance(s, Dense):
                code = next(masks).to(dev)[live_pos[s.rows]]
                m = code == MASK_KEPT
                # kept entries where the mask can be read (the port's
                # input is nonzero), and how many those are
                shares.append((int(m.sum()),
                               int((code != MASK_ZERO).sum())))
                h = torch.where(m, h, 0.0) * (1.0 / est["keep_prob"])
                h = dense(params[s.name], h, s, self.precision)
                continue
            l = s.index
            n_out = ids[l + 1].shape[0]
            if est["cv"]:
                new_rows = h.detach()
                agg = self._cv_aggregate(h, ids, cidx, live_pos[1],
                                         slot_pos, slot_w)
            else:
                at, nbr, w = self.rows.of(ids[l + 1])
                pos_of = torch.full((n + 1,), -1, dtype=torch.int64,
                                    device=dev)
                pos_of[ids[l]] = torch.arange(ids[l].shape[0], device=dev)
                agg = aggregate(n_out, at, pos_of[nbr], w, h)
            h = torch.cat([h[:n_out], agg], dim=1)
        self.out.keep_share.append(shares)
        labels = self.g.labels.index_select(0, ids[-1])
        valid = torch.ones(ids[-1].shape[0], device=dev)
        if self.half_batch:
            valid[(valid.shape[0] + 1) // 2:] = 0.0
        loss = loss_of(h, labels, valid)
        first = next(s.name for s in self.steps if isinstance(s, Dense))
        if est["weight_decay"]:
            loss = loss + est["weight_decay"] * params[first][
                "weights"].square().sum() / 2.0
        keys = [(l, k) for l in sorted(params) for k in sorted(params[l])]
        grads = torch.autograd.grad(loss, [params[l][k] for l, k in keys])
        self.out.losses.append(float(loss.detach()))
        self._adam(dict(zip(keys, grads)))
        self.out.grads.append({f"{l}/{k}": g.detach().clone()
                               for (l, k), g in zip(keys, grads)})
        if self.count == 1:
            self.out.grad1 = self.out.grads[0]
        if new_rows is not None:
            self._write_history(new_rows, ids[0], d)

    def _cv_aggregate(self, h, ids, cidx, live_out, slot_pos, slot_w):
        """``A_samp (H - h_bar[field]) + A_full h_bar`` over the capped
        train graph for the output field's live rows (capacity rows
        ``live_out``): the sampled slot of each row, and each of its capped
        edges against the history table."""
        n_out = live_out.shape[0]
        cap = cidx[0].shape[0]
        p = slot_pos[live_out, 0]
        w = slot_w[live_out, 0]
        src = torch.where(p < cap, cidx[0][p.clamp(max=cap - 1)], -1)
        keep = (src >= 0) & (w != 0)
        src = src[keep]
        rows = torch.arange(n_out, device=h.device)[keep]
        delta = h.index_select(0, src) - self.hist.index_select(
            0, ids[0][src])
        samp = h.new_zeros((n_out, h.shape[1])).index_add(
            0, rows, delta * w[keep][:, None])
        at, nbr, w = self.rows.of(ids[1])
        full = aggregate(n_out, at, nbr, w, self.hist)
        return samp + full

    def _write_history(self, rows, ids0, d: Draw) -> None:
        """Compare the port's stored rows with the candidates of each id
        (every position of the id in the field), in the configuration's
        storage dtype; then store the matching candidate, rounded."""
        dev = rows.device
        got_ids = d.hist_ids.to(dev).long()
        got = d.hist_rows.to(dev).float()
        order = torch.argsort(ids0, stable=True)
        sorted_ids = ids0[order]
        first = torch.searchsorted(sorted_ids, got_ids)
        last = torch.searchsorted(sorted_ids, got_ids, right=True)
        if bool((last - first < 1).any()) or \
                got_ids.shape[0] != torch.unique(ids0).shape[0]:
            raise ValueError("the port's written ids are not the field's")
        storage = self.est["history_dtype"]
        row_best = torch.full((got_ids.shape[0],), float("inf"), device=dev)
        elem = torch.full_like(got, float("inf"))
        chosen = torch.zeros_like(got)
        scale = torch.zeros_like(row_best)
        for j in range(int((last - first).max())):
            has = first + j < last
            cand = rows.index_select(0, order[(first + j).clamp(
                max=order.shape[0] - 1)])
            slack = bf16_half_ulp(cand) if storage == "bfloat16" else 0.0
            scale = torch.where(has, torch.maximum(
                scale, cand.abs().amax(dim=1)), scale)
            excess = ((got - cand).abs() - slack).clamp(min=0.0)
            better = has[:, None] & (excess < elem)
            elem = torch.where(better, excess, elem)
            chosen = torch.where(better, cand, chosen)
            row_best = torch.where(has, torch.minimum(
                row_best, excess.amax(dim=1)), row_best)
        scale = scale.clamp(min=1e-6)
        gap = elem.amax(dim=1) / scale
        if self.count == 1:
            self.out.history_gap = float(gap.max())
        mult = last - first
        det = self.out.history_detail
        det.setdefault("element_gap", []).append(float(gap.max()))
        det.setdefault("row_gap", []).append(float((row_best / scale).max()))
        det.setdefault("repeated_ids", []).append(int((mult > 1).sum()))
        det.setdefault("mixed_rows", []).append(
            int(((row_best / scale > 1e-3) & (gap <= 1e-3)).sum()))
        if storage == "bfloat16":
            chosen = chosen.to(torch.bfloat16).float()
        self.hist[got_ids] = chosen

    def _adam(self, grads: dict) -> None:
        est = self.est
        b1, b2, lr = est["beta1"], est["beta2"], est["learning_rate"]
        self.count += 1
        t = self.count
        with torch.no_grad():
            for (l, k), g in grads.items():
                mu = self.mu[l][k].mul_(b1).add_(g, alpha=1 - b1)
                nu = self.nu[l][k].mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t))
                                              + 1e-8)
                self.params[l][k].add_(upd, alpha=-lr)


def train_steps(graph, steps, params, est: dict, rows: Rows, draws: list,
                precision: str = "float32", half_batch: bool = False,
                hist0: Optional[torch.Tensor] = None) -> Outcome:
    """The reference over the port's recorded steps ``draws``."""
    ref = Trainer(graph, steps, params, est, rows, precision, half_batch,
                  hist0)
    with precision_of(precision, graph.feats.device):
        for d in draws:
            ref.step(d)
    ref.out.params = ref.params
    return ref.out


# ------------------------------- serving ---------------------------------

@torch.no_grad()
def predict(graph, steps, params, requests: list, rows: Rows,
            precision: str = "float32") -> list:
    """Exact class probabilities of each request of node ids (no
    preprocessing, the whole graph as the port's padded graph holds it:
    ``rows``, :func:`graph_rows`): every aggregation but the last over
    every node, once, then the last and what follows over each request."""
    g = graph
    dev = g.feats.device
    last = [i for i, s in enumerate(steps) if isinstance(s, Aggregate)][-1]
    everyone = torch.arange(g.num_nodes, device=dev)

    def run(h, part, rows_of_last):
        for s in part:
            if isinstance(s, Dense):
                h = dense(params[s.name], h, s, precision)
                continue
            ids = rows_of_last if s is steps[last] else everyone
            at, nbr, w = rows.of(ids)
            agg = aggregate(ids.shape[0], at, nbr, w, h)
            h = torch.cat([h.index_select(0, ids), agg], dim=1)
        return h

    with precision_of(precision, dev):
        hidden = run(g.feats, steps[:last], None)
        return [torch.softmax(run(hidden, steps[last:], ids), dim=1)
                for ids in requests]
