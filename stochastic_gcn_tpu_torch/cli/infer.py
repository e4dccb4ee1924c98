"""Inference/serving entry point — batched prediction from a JAX checkpoint.

Port of stochastic_gcn_tpu/cli/infer.py: loads the weights a JAX run saved
(``<ckpt_dir>/model.ckpt.npz``) and emits per-node class probabilities,
with the CV history refresh applied automatically.

Usage::

    python -m stochastic_gcn_tpu_torch.cli.infer --dataset synthetic:300:32:5 \
        --cv --test_cv --nodes test --out preds.npz --device cuda \
        [any training flags]

``--nodes`` selects the id set: ``test`` / ``val`` / ``train`` / ``all``,
or an explicit comma-separated id list.  ``--out`` writes an npz with
``ids``, ``probs`` ([n, C] float32) and ``pred`` (argmax class, or the
0.5-thresholded multi-label matrix for multitask datasets).  Model and
dataset flags are the training CLI's and must match the checkpointed run.
``--device`` (default ``cuda``) names the torch device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _select_ids(spec: str, ds):
    named = {"test": ds.test_d, "val": ds.val_d, "train": ds.train_d,
             "all": np.arange(ds.num_data, dtype=np.int32)}
    if spec in named:
        return np.asarray(named[spec], np.int64)
    return np.asarray([int(s) for s in spec.split(",") if s], np.int64)


def _f1(probs, labels, multitask: bool):
    """Micro/macro F1 of predictions against labels (sklearn conventions)."""
    from ..utils.metrics import f1_from_counts
    if multitask:
        p, t = probs > 0.5, labels > 0.5
    else:
        c = labels.shape[1]
        p = np.eye(c, dtype=bool)[probs.argmax(1)]
        t = np.eye(c, dtype=bool)[labels.argmax(1)]
    return f1_from_counts((p & t).sum(0), (p & ~t).sum(0), (~p & t).sum(0),
                          multitask)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--nodes", default="test",
                   help="test|val|train|all or comma-separated node ids")
    p.add_argument("--out", default="",
                   help="npz output path (ids, probs, pred)")
    p.add_argument("--norefresh", action="store_true",
                   help="skip the CV history-convergence passes")
    p.add_argument("--device", default="cuda", help="torch device")
    own, rest = p.parse_known_args(argv)

    from ..config import parse_flags
    cfg = parse_flags(rest)
    from ..parallel import distributed, launch
    if launch.dispatch(cfg, own.device, "stochastic_gcn_tpu_torch.cli.infer",
                       argv):
        return None
    log = distributed.main_log()

    from ..data.loaders import load_data
    from ..training.loop import Trainer
    ds = load_data(cfg)
    trainer = Trainer(cfg, ds, device=own.device)
    trainer.load(load_history=True)

    ids = _select_ids(own.nodes, ds)
    t0 = time.time()
    probs = trainer.predict(ids, refresh=not own.norefresh)
    dur = time.time() - t0
    if cfg.multitask:
        pred = (probs > 0.5).astype(np.int32)
    else:
        pred = np.argmax(probs, axis=1).astype(np.int32)

    # summary in the reference's Test-line shape, where labels exist
    labels = np.asarray(ds.labels)[ids]
    if labels.size and labels.sum() > 0:
        micro, macro = _f1(probs, labels, cfg.multitask)
        if cfg.multitask:
            acc = float((pred == labels).mean())
        else:
            acc = float((pred == np.argmax(labels, axis=1)).mean())
        log(f"Inference results: nodes= {len(ids)} accuracy= {acc:.5f} "
            f"mi F1={micro:.5f} ma F1={macro:.5f}  time= {dur:.5f}")
    else:
        log(f"Inference results: nodes= {len(ids)}  time= {dur:.5f}")

    if own.out and distributed.is_main():
        np.savez(own.out, ids=ids.astype(np.int64), probs=probs, pred=pred)
        log(f"Predictions saved in file: {own.out}")
    return probs


if __name__ == "__main__":
    main(sys.argv[1:])
