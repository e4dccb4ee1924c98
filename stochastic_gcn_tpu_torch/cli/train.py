"""Training entry point — the gcn/train.py equivalent on a torch device.

Port of stochastic_gcn_tpu/cli/train.py::

    python -m stochastic_gcn_tpu_torch.cli.train --dataset synthetic:300:32:5 \
        --cv --test_cv --degree 1 --test_degree 1 --device cuda [flags]

Flag names and semantics are the reference's (train.py:25-67), parsed by
``config.parse_flags``; ``--device`` (default ``cuda``) names
the torch device.  Trains with ``sgd_train`` (epoch lines, checkpoint in
``--ckpt_dir``, ``--resume``, SIGTERM -> checkpoint and exit), then runs
the Test passes; ``--gradvar`` runs the gradient-variance analysis between
the two.  ``--model mlp`` is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda", help="torch device")
    own, rest = p.parse_known_args(argv)

    from ..config import parse_flags
    cfg = parse_flags(rest)
    np.random.seed(cfg.seed)

    from ..data.loaders import load_data
    from ..training.loop import Trainer
    ds = load_data(cfg)
    print("Features shape = {}, training edges = {}, testing edges = {}"
          .format(ds.feats.shape, ds.train_adj.nnz, ds.full_adj.nnz))
    print("{} training data, {} validation data, {} testing data.".format(
        len(ds.train_d), len(ds.val_d), len(ds.test_d)))

    trainer = Trainer(cfg, ds, device=own.device)   # raises on mlp
    # preemption (SIGTERM) -> finish the epoch, checkpoint, exit cleanly;
    # relaunching the same command with --resume continues from there
    trainer.install_preemption_handler()
    trainer.sgd_train()
    if trainer.stop_requested:
        return trainer
    if cfg.gradvar:
        trainer.gradient_variance()
    trainer.run_tests()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
