"""Reference validation micro-F1 of the PubMed-sized Planetoid arms, from
the JAX package on the CPU.

``chip_smoke.py``'s formats phase trains the port on a PubMed-sized
Planetoid fixture (19,717 nodes, 500 features, 3 classes, the 60/500/1000
split) in two arms: ``configs/pubmed.sh``'s command line (the package
defaults: NS+PP, degree 20) and the paper's CV recipe (``--cv --test_cv
--degree 1 --test_degree 1``).  This script writes the same fixture with
the JAX package's writer, trains the JAX package's ``Trainer`` with the
same flags for the same epochs, and prints, per arm and seed, the
validation micro-F1 after every epoch and the best; ``chip_smoke.py``
holds the card's best against the mean of the best here
(``PUBMED_REFERENCE_F1``).

    JAX_PLATFORMS=cpu python scripts/formats_reference_f1.py \\
        --epochs 30 --seeds 1,2,3
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from stochastic_gcn_tpu.config import Config  # noqa: E402
from stochastic_gcn_tpu.data.fixtures import (PlanetoidSpec,  # noqa: E402
                                              write_planetoid_fixture)
from stochastic_gcn_tpu.data.loaders import load_data  # noqa: E402
from stochastic_gcn_tpu.training.loop import Trainer  # noqa: E402

# PubMed's published shape: 19,717 nodes, 500 features, 3 classes, a
# 60/500/1000 train/val/test split; chip_smoke.py writes the same spec
PUBMED_SPEC = dict(name="pubmed", num_train=60, num_extra=18657,
                   num_val=500, num_test=1000, feature_dim=500,
                   num_classes=3, avg_degree=4, words_per_node=50)
ARMS = {"NS+PP (configs/pubmed.sh)": {},
        "CV+PP (--cv --test_cv --degree 1 --test_degree 1)":
            dict(cv=True, test_cv=True, degree=1, test_degree=1)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--seeds", default="1,2,3")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        write_planetoid_fixture(d, PlanetoidSpec(**PUBMED_SPEC))
        ds = load_data(Config(dataset="pubmed", data_dir=d))
        for arm, over in ARMS.items():
            best = []
            for seed in seeds:
                cfg = Config(dataset="pubmed", data_dir=d, seed=seed,
                             ckpt_dir=d, **over)
                tr = Trainer(cfg, ds)
                curve = []
                for _ in range(args.epochs):
                    tr.train_epoch()
                    curve.append(round(tr.evaluate(ds.val_d)[2], 4))
                best.append(max(curve))
                print(json.dumps({"arm": arm, "seed": seed,
                                  "val_micro_f1": curve}), flush=True)
            out[arm] = {"best": best, "mean_best": float(np.mean(best))}
    print(json.dumps({"epochs": args.epochs, "seeds": seeds, **out}))


if __name__ == "__main__":
    main()
