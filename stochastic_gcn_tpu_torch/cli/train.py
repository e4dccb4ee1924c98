"""Training entry point — the gcn/train.py equivalent on a torch device.

Port of stochastic_gcn_tpu/cli/train.py::

    python -m stochastic_gcn_tpu_torch.cli.train --dataset synthetic:300:32:5 \
        --cv --test_cv --degree 1 --test_degree 1 --device cuda [flags]

Flag names and semantics are the reference's (train.py:25-67), parsed by
``config.parse_flags``; ``--device`` (default ``cuda``) names
the torch device.  Trains with ``sgd_train`` (epoch lines, checkpoint in
``--ckpt_dir``, ``--resume``, SIGTERM -> checkpoint and exit), then runs
the Test passes; ``--gradvar`` runs the gradient-variance analysis between
the two.  ``--model mlp`` trains the NeighbourMLP baseline for ``--epochs``
epochs instead, with the JAX package's lines.
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
    from ..parallel import distributed, launch
    if launch.dispatch(cfg, own.device, "stochastic_gcn_tpu_torch.cli.train",
                       argv):
        return None
    log = distributed.main_log()
    np.random.seed(cfg.seed)

    from ..data.loaders import load_data
    from ..training.loop import Trainer
    ds = load_data(cfg)
    log("Features shape = {}, training edges = {}, testing edges = {}"
        .format(ds.feats.shape, ds.train_adj.nnz, ds.full_adj.nnz))
    log("{} training data, {} validation data, {} testing data.".format(
        len(ds.train_d), len(ds.val_d), len(ds.test_d)))

    if cfg.model == "mlp":
        from ..models.mlp import MLPTrainer
        trainer = MLPTrainer(cfg, ds, device=own.device)
        for epoch in range(cfg.epochs):
            loss, acc = trainer.train_epoch()
            vloss, vacc, micro, macro = trainer.evaluate(ds.val_d)
            log(f"Epoch: {epoch + 1:04d} train_loss= {loss:.5f} "
                f"train_acc= {acc:.5f} val_loss= {vloss:.5f} "
                f"val_acc= {vacc:.5f} mi F1={micro:.5f} ma F1={macro:.5f}")
        tloss, tacc, micro, macro = trainer.evaluate(ds.test_d)
        log(f"Test set results: cost= {tloss:.5f} accuracy= {tacc:.5f} "
            f"mi F1={micro:.5f} ma F1={macro:.5f}  time= 0.00000")
        return trainer

    trainer = Trainer(cfg, ds, device=own.device)
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
