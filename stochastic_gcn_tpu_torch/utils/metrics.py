"""F1 metrics from per-class counters, and the gradient-variance
accumulator.

Port of stochastic_gcn_tpu/utils/metrics.py without scikit-learn: the
counters are taken on the device and the F1 scores follow sklearn's
micro/macro conventions.
"""

from __future__ import annotations

import numpy as np
import torch


def device_f1_counts(logits: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, multitask: bool):
    """Per-class (TP, FP, FN) int32 counters over the valid rows.
    Multitask thresholds sigmoid at 0.5 (== logits > 0); single-label
    argmaxes."""
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
