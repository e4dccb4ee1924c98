"""Reference validation micro-F1 of lazy CV+PP (``--lazy_fullterm``) on the
convergence check's community SBM, from the JAX package on the CPU.

``chip_smoke.py``'s full-term phase trains the port's lazy CV+PP arm on the
65,536-node community SBM at the convergence recipe (bench.py:134-158:
batch 512, degree 1, hidden 128, CV+PP, exhaustive test degree) for at most
15 epochs and holds it to the 0.90 band.  This script builds the same
graph with the JAX package's ``community_sbm_dataset``, trains the JAX
package's ``Trainer`` with the same flags and ``lazy_fullterm=True`` (and,
with ``--eager``, without it), and prints the validation micro-F1 after
every epoch, the first epoch at or above 0.90 and the best.

    JAX_PLATFORMS=cpu python scripts/lazy_reference_f1.py --epochs 15
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stochastic_gcn_tpu.config import Config  # noqa: E402
from stochastic_gcn_tpu.data.loaders import community_sbm_dataset  # noqa
from stochastic_gcn_tpu.training.loop import Trainer  # noqa: E402

# chip_smoke.py's SBM_KW and CONVERGE_CFG (bench.py:134-158,344-348)
SBM_KW = dict(num_nodes=65536, num_classes=41, feature_dim=602,
              mean_degree=25, p_in=0.7, snr=0.04, seed=0, max_degree=64)
CONVERGE_CFG = dict(dataset="sbm_reddit", batch_size=512, degree=1,
                    test_degree=10000, cv=True, test_cv=True, hidden1=128,
                    normalization="graphsage", layer_norm=True,
                    num_fc_layers=2, weight_decay=0.0, dropout=0.2,
                    test_batch_size=2048, pad_degree=64, seed=1)
TARGET = 0.90


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--eager", action="store_true",
                   help="also train the per-step (eager) arm")
    args = p.parse_args()
    ds = community_sbm_dataset(**SBM_KW)
    arms = {"lazy CV+PP": True, **({"CV+PP": False} if args.eager else {})}
    out = {}
    for arm, lazy in arms.items():
        tr = Trainer(Config(**CONVERGE_CFG, lazy_fullterm=lazy), ds)
        curve, t0 = [], time.perf_counter()
        for _ in range(args.epochs):
            tr.train_epoch()
            curve.append(round(tr.evaluate(ds.val_d)[2], 4))
            print(json.dumps({"arm": arm, "epoch": len(curve),
                              "val_micro_f1": curve[-1],
                              "host_s": round(time.perf_counter() - t0, 1)}),
                  flush=True)
        hit = next((i + 1 for i, f in enumerate(curve) if f >= TARGET), None)
        out[arm] = {"val_micro_f1": curve, "best": max(curve),
                    f"first_epoch_at_{TARGET}": hit}
    print(json.dumps({"epochs": args.epochs, **out}))


if __name__ == "__main__":
    main()
