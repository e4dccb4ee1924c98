"""The numbers that decide ``correct``, each against its limit.

A train cell compares the port's first steps with the reference
(``reference.train_steps``):

* ``loss_first``: the gap of the first step's loss, relative to the
  reference's (the later steps' gaps are in the information lines: Adam
  moves every element of a weight by about the learning rate whatever the
  size of its gradient, so an element whose gradient is near zero turns
  rounding into a visible step, and the later losses inherit it);
* ``grad``: the first gradient as Adam got it (its first moment after one
  step over ``1 - beta1``), by the worst leaf: the gap between the port's
  norm and the reference's, over the reference's norm of that leaf or of
  the median leaf, whichever is larger;
* ``update``: the parameters' change over the steps, the gap of the norm
  of the whole change (every moving leaf together) relative to the
  reference's.  Leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone under Adam and are left out,
  and so, within a leaf, are the elements whose reference gradient is
  under a thousandth of the leaf's root mean square at some step
  (:func:`settled`);
* ``update_leaf``: the same change by the worst leaf (settled elements),
  the gap of its norms over the larger of the reference's norm of that
  leaf and of the median leaf.  It reads up to ~1e-3 on sound runs, where
  a relu that flips or a first moment that nearly cancels at a later step
  turns rounding into a visible step in a small leaf, so its limit is
  wider than the whole change's;
* ``keep_z``: the worst dropout mask's kept share against ``keep_prob``,
  in binomial standard deviations of the entries read (each mask element
  is its own draw);
* ``fields`` (exact steps): field entries that differ from the
  reference's derivation; ``bad_draws`` (sampled steps): sampled slots that
  are no draw of the capped graph; ``draw_z``: the sampled slots' places
  in their rows, in ``reference.DRAW_BINS`` bins against a uniform pick,
  as a chi-square in standard deviations of its degrees of freedom;
* ``history_first`` (a control variate): after the first step, the
  largest excess of a written history element over the nearest of its
  candidates (the element of that column of each duplicate of the id),
  beyond the storage dtype's rounding, relative to the largest value of
  the id's candidates (the later steps' rows come from weights that
  already carry the gaps above: they are in the information lines).

A serving cell compares the probabilities of a sample of the answered
requests with the reference's (``probs``, the largest absolute gap).

The limits of a cell are ``gpubench/limits/<workload>.json``; PERF.md
gives the readings each was set from.
"""

from __future__ import annotations

import math
import statistics

import torch


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in
            tree.items()}


def norm_gap(prog: dict, ref: dict, leaves) -> float:
    """The worst leaf's gap of norms, over the larger of the reference's
    norm of that leaf and of the median leaf."""
    p, r = _norms({k: prog[k] for k in leaves}), _norms(
        {k: ref[k] for k in leaves})
    med = statistics.median(r.values())
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in leaves)


def flat(params: dict) -> dict:
    return {f"{l}/{n}": t for l, p in params.items() for n, t in p.items()}


ROUNDING = 1e-3     # a gradient under this share of its leaf's RMS is noise


def settled(grads: list) -> dict:
    """By leaf, the elements whose reference gradient is, at every step,
    at least ``ROUNDING`` of the leaf's root mean square: Adam moves an
    element by about the learning rate whatever its gradient's size, so
    an element whose gradient is near zero turns rounding into a step of
    either sign; such elements are left out of the change."""
    out = {}
    for k in grads[0]:
        ok = torch.ones_like(grads[0][k], dtype=torch.bool).cpu()
        for g in grads:
            t = g[k].detach().cpu().double()
            rms = float(t.square().mean().sqrt())
            ok &= t.abs() >= ROUNDING * rms
        out[k] = ok
    return out


def keep_z(shares: list, keep_prob: float) -> float:
    """The largest gap of a mask's kept share from ``keep_prob``, in
    binomial standard deviations; ``shares``: ``(kept, read)`` of each
    mask, by step."""
    sd = math.sqrt(keep_prob * (1.0 - keep_prob))
    return max((abs(k / n - keep_prob) * math.sqrt(n) / sd
                for step in shares for k, n in step if n), default=0.0)


def draw_z(bins: list) -> float:
    """``(chi2 - dof) / sqrt(2 dof)`` of observed against expected bin
    counts (``bins``: the two tensors), over the bins expected to fill."""
    got, want = (t.double() for t in bins)
    used = want > 0
    dof = int(used.sum()) - 1
    if dof < 1:
        return 0.0
    chi2 = float(((got[used] - want[used]) ** 2 / want[used]).sum())
    return (chi2 - dof) / math.sqrt(2.0 * dof)


def train_numbers(prog: dict, ref, params0: dict, est: dict) -> dict:
    """``prog``: the port's ``losses``, ``grad1`` (flat) and ``params``
    after the steps; ``ref``: the reference's ``Outcome``; ``params0``: the
    weights both started from; ``est``: the estimator
    (``cells._estimator``)."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref.losses)]
    if len(losses) != len(prog["losses"]) or not losses:
        raise ValueError("the port and the reference ran different steps")
    g_ref = {k: t.cpu() for k, t in ref.grad1.items()}
    leaves = sorted(g_ref)
    gn = _norms(g_ref)
    med = statistics.median(gn.values())
    moving = [k for k in leaves if gn[k] >= 1e-3 * med]
    p0 = {k: t.cpu() for k, t in flat(params0).items()}
    keep = settled(ref.grads)
    d_prog = {k: (t.cpu() - p0[k])[keep[k]]
              for k, t in flat(prog["params"]).items()}
    d_ref = {k: (t.cpu() - p0[k])[keep[k]]
             for k, t in flat(ref.params).items()}
    out = {"loss_first": losses[0],
           "grad": norm_gap({k: prog["grad1"][k].cpu() for k in leaves},
                            g_ref, leaves),
           "update": norm_gap({"all": torch.cat([d_prog[k] for k in moving])},
                              {"all": torch.cat([d_ref[k] for k in moving])},
                              ["all"]),
           "update_leaf": norm_gap(d_prog, d_ref, moving),
           "keep_z": keep_z(ref.keep_share, est["keep_prob"])}
    if est["cv"]:
        out["history_first"] = ref.history_gap
        out["bad_draws"] = float(ref.bad_draws)
        out["draw_z"] = draw_z(ref.draw_bins)
    else:
        out["fields"] = float(ref.field_errors)
    return out


def train_details(prog: dict, ref, params0: dict) -> dict:
    """Each step's loss gap and each leaf's gaps of the first gradient's and
    of the change's norms, for the run's information lines."""
    p0 = flat(params0)
    d_prog = {k: t.cpu() - p0[k].cpu() for k, t in flat(prog["params"]).items()}
    d_ref = {k: t.cpu() - p0[k].cpu() for k, t in flat(ref.params).items()}
    g_ref = {k: t.cpu() for k, t in ref.grad1.items()}
    gn, dn = _norms(g_ref), _norms(d_ref)
    gmed, dmed = statistics.median(gn.values()), statistics.median(
        dn.values())
    pg, pd = _norms({k: prog["grad1"][k].cpu() for k in g_ref}), _norms(
        d_prog)
    keep = settled(ref.grads)
    ks = {k: _norms({k: d_ref[k][keep[k]]})[k] for k in dn}
    kp = {k: _norms({k: d_prog[k][keep[k]]})[k] for k in dn}
    return {"loss_gaps": [abs(p - r) / max(abs(r), 1e-30)
                          for p, r in zip(prog["losses"], ref.losses)],
            "grad_gaps": {k: abs(pg[k] - gn[k]) / max(gn[k], gmed, 1e-30)
                          for k in gn},
            "update_gaps": {k: abs(pd[k] - dn[k]) / max(dn[k], dmed, 1e-30)
                            for k in dn},
            "update_gaps_settled": {k: abs(kp[k] - ks[k]) / max(ks[k], 1e-30)
                                    for k in dn},
            "left_out": {k: int((~v).sum()) for k, v in keep.items()},
            "grad_norms": gn}


def predict_numbers(prog: list, ref: list) -> dict:
    """``prog`` / ``ref``: the probabilities of the sampled requests."""
    return {"probs": max(float((p.cpu() - r.cpu()).abs().max())
                         for p, r in zip(prog, ref))}


def compare(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number at or under its limit, and
    ``{name: {"value", "limit"}}`` in the limits' order."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"numbers not computed: {missing}")
    checks = {k: {"value": numbers[k], "limit": float(limits[k])}
              for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
