"""What a step needs: bytes of its aggregations and floating-point
operations, counted from the graph and the batch ids alone.

Counted from the algorithm, not from what the port's kernels read: each
aggregation call reads each distinct live input row once (a row that
several edges name is read once), its edges once (an int32 id and a
float32 weight each) and writes its float32 output rows once; its
gradient reads the output gradient once, the edges once and writes the
input rows' gradient once.  This is the distinct-live-row arithmetic of
``chip_smoke.py::kernel_bytes`` (kinds "gather" and "backward"), with the
slot arrays counted at the live edges.  The fields are the exact
estimator's, which are deterministic: the batch, then each layer's field
and its neighbours in the graph as the port's padded graph holds it
(capped at ``pad_degree``: ``reference.graph_rows``).  Operations count the dense products (forward, the
weights' gradient, and the inputs' gradient where the input carries one)
and the aggregations (two per edge and column, forward and backward),
over live rows only: padding and recomputation are not work the step
needs.
"""

from __future__ import annotations

import torch

from .model import Aggregate, Dense
from .reference import neighbours


def exact_step(indptr: torch.Tensor, indices: torch.Tensor,
               batch: torch.Tensor, steps: list, feature_dim: int,
               train: bool) -> dict:
    """``{"fanout_bytes", "flops"}`` of one exact step (no preprocessing)
    over the graph ``indptr`` / ``indices`` for the node ids ``batch``
    (ids at or above the node count are padding)."""
    n = indptr.shape[0] - 1
    aggs = [s for s in steps if isinstance(s, Aggregate)]
    fields = [batch[batch < n]]
    per_layer = []
    for _ in aggs:
        f = fields[-1]
        _, nbr = neighbours(indptr, indices, f)
        distinct = torch.unique(nbr)
        seen = torch.zeros(n, dtype=torch.bool, device=f.device)
        seen[f] = True
        per_layer.append((int(f.shape[0]), int(nbr.shape[0]),
                          int(distinct.shape[0])))
        fields.append(torch.cat([f, distinct[~seen[distinct]]]))
    fields.reverse()
    per_layer.reverse()          # aggregation l: field l -> field l + 1
    rows = [int(f.shape[0]) for f in fields]
    nbytes = flops = 0.0
    width, grad = feature_dim, False
    for s in steps:
        if isinstance(s, Dense):
            r = rows[s.rows]
            mm = 2.0 * r * s.fan_in * s.fan_out
            flops += mm + (mm + (mm if grad else 0.0) if train else 0.0)
            width, grad = s.fan_out, True
            continue
        n_out, edges, distinct = per_layer[s.index]
        nbytes += 4.0 * distinct * width + 8.0 * edges + 4.0 * n_out * width
        flops += 2.0 * edges * width
        if train and grad:
            nbytes += 4.0 * n_out * width + 8.0 * edges \
                + 4.0 * distinct * width
            flops += 2.0 * edges * width
        width *= 2               # [self || aggregate]
    return {"fanout_bytes": nbytes, "flops": flops}


def full_term_step(indptr: torch.Tensor, indices: torch.Tensor,
                   batch: torch.Tensor, width: int,
                   hist_bytes: int) -> float:
    """Bytes the control variate's full term ``A . h_bar`` needs for the
    rows ``batch``: each distinct neighbour's history row once
    (``hist_bytes`` an element), the edges once, the float32 output
    once."""
    n = indptr.shape[0] - 1
    rows = batch[batch < n]
    _, nbr = neighbours(indptr, indices, rows)
    distinct = int(torch.unique(nbr).shape[0])
    return (float(distinct) * width * hist_bytes + 8.0 * nbr.shape[0]
            + 4.0 * rows.shape[0] * width)
