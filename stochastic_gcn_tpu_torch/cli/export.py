"""Export a trained model as a serving artifact.

Port of stochastic_gcn_tpu/cli/export.py: loads a checkpoint (the
training flags, as cli/train.py takes them), converges the CV eval
histories under the final weights and writes the artifact directory
(serving.py: ``state.npz`` + ``manifest.json``)::

    python -m stochastic_gcn_tpu_torch.cli.export --dataset cora --cv \\
        --test_cv --out model.export --device cuda [any training flags]

Serving side (needs this package; see serving.py)::

    from stochastic_gcn_tpu_torch.serving import load_predictor
    probs = load_predictor("model.export", device="cuda").predict([3, 17])

``--platforms`` is recorded in the manifest and has no effect (the device
is chosen at load); ``--device`` (default ``cuda``) is where the trainer
runs the refresh.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--out", default="model.export",
                   help="artifact directory (state.npz + manifest.json)")
    p.add_argument("--platforms", default="",
                   help="comma-separated platform names, recorded in the "
                        "manifest (the device is chosen at load)")
    p.add_argument("--scan_batches", type=int, default=1,
                   help="batches per device call of the Predictor")
    p.add_argument("--device", default="cuda", help="torch device")
    own, rest = p.parse_known_args(argv)

    from ..config import parse_flags
    cfg = parse_flags(rest)
    from ..parallel import distributed, launch
    if launch.dispatch(cfg, own.device, "stochastic_gcn_tpu_torch.cli.export",
                       argv):
        return None
    log = distributed.main_log()

    from ..data.loaders import load_data
    from ..serving import export_predictor
    from ..training.loop import Trainer
    ds = load_data(cfg)
    trainer = Trainer(cfg, ds, device=own.device)
    trainer.load(load_history=True)

    plats = tuple(s.strip() for s in own.platforms.split(",") if s.strip())
    t0 = time.time()
    path = export_predictor(trainer, own.out, platforms=plats,
                            scan_batches=own.scan_batches)
    log(f"Serving artifact written to: {path}  "
        f"time= {time.time() - t0:.5f}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
