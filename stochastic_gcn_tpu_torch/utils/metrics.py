"""F1 metrics from per-class counters, the trailing-window averager, and
the gradient-variance accumulator.

Port of stochastic_gcn_tpu/utils/metrics.py without scikit-learn: the
counters are taken on the device and the F1 scores follow sklearn's
micro/macro conventions.
"""

from __future__ import annotations

import numpy as np
import torch


def device_f1_counts(logits: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, multitask: bool, mesh=None):
    """Per-class (TP, FP, FN) int32 counters over the valid rows.
    Multitask thresholds sigmoid at 0.5 (== logits > 0); single-label
    argmaxes.  With a ``mesh`` the rows are this rank's block of the batch
    and the counters are summed over the ranks (one collective)."""
    m = (valid > 0)[:, None]
    if multitask:
        p = logits > 0
        t = labels > 0.5
    else:
        cls = torch.arange(logits.shape[1], device=logits.device)
        p = logits.argmax(dim=1)[:, None] == cls[None, :]
        t = labels.argmax(dim=1)[:, None] == cls[None, :]
    tp = (p & t & m).sum(dim=0)
    fp = (p & ~t & m).sum(dim=0)
    fn = (~p & t & m).sum(dim=0)
    if mesh is not None:
        from ..parallel.mesh import all_reduce_sum
        tp, fp, fn = all_reduce_sum(torch.stack([tp, fp, fn]), mesh)
    return tp.to(torch.int32), fp.to(torch.int32), fn.to(torch.int32)


def f1_from_counts(tp, fp, fn, multitask: bool) -> tuple[float, float]:
    """micro/macro F1 from summed per-class counters; matches sklearn's
    conventions (multilabel macro averages ALL columns; multiclass macro
    averages classes present in y_true or y_pred)."""
    tp = np.asarray(tp, np.float64)
    fp = np.asarray(fp, np.float64)
    fn = np.asarray(fn, np.float64)
    denom = 2 * tp.sum() + fp.sum() + fn.sum()
    micro = 2 * tp.sum() / denom if denom else 0.0
    per_denom = 2 * tp + fp + fn
    per_f1 = np.divide(2 * tp, per_denom,
                       out=np.zeros_like(tp), where=per_denom > 0)
    if multitask:
        macro = per_f1.mean() if len(per_f1) else 0.0
    else:
        present = per_denom > 0
        macro = per_f1[present].mean() if present.any() else 0.0
    return float(micro), float(macro)


def calc_f1(y_pred, y_true, multitask: bool) -> tuple[float, float]:
    """Micro/macro F1 of host predictions, as
    ``sklearn.metrics.f1_score(average="micro"/"macro")`` gives them.
    Multitask thresholds the probabilities at 0.5 and macro averages every
    column; single-label argmaxes both sides and macro averages the classes
    present in ``y_true`` or ``y_pred``.  One multitask column is binary to
    scikit-learn: both of its labels, 0 and 1, are classes."""
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    if multitask:
        p, t = y_pred > 0.5, y_true > 0.5
        if p.shape[1] == 1:
            p, t = np.hstack([~p, p]), np.hstack([~t, t])
            multitask = False
    else:
        cls = np.arange(max(y_pred.shape[1], y_true.shape[1]))
        p = y_pred.argmax(axis=1)[:, None] == cls[None, :]
        t = y_true.argmax(axis=1)[:, None] == cls[None, :]
    return f1_from_counts((p & t).sum(0), (p & ~t).sum(0), (~p & t).sum(0),
                          multitask)


class Averager:
    """Trailing-window mean of the last ``window_size`` values
    (gcn/utils.py:507-518); NaN before the first."""

    def __init__(self, window_size: int):
        self.window_size = window_size
        self.window: list[float] = []

    def add(self, n) -> None:
        self.window.append(float(n))
        if len(self.window) > self.window_size:
            self.window = self.window[1:]

    def mean(self) -> float:
        return float(np.mean(self.window)) if self.window else float("nan")


class Stat:
    """Accumulates arrays across runs; elementwise mean and standard
    deviation (population, as ``np.std``).  Tensors are moved to the host
    as they are added."""

    def __init__(self):
        self.vals: list[np.ndarray] = []

    def add(self, v) -> None:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        self.vals.append(np.asarray(v))

    def mean(self) -> np.ndarray:
        return np.mean(np.stack(self.vals), axis=0)

    def std(self) -> np.ndarray:
        return np.std(np.stack(self.vals), axis=0)
