"""Where a request from an exported artifact spends its time, against
``Trainer.predict``'s, on the card.

Builds the Reddit-shaped graph at the JAX benchmark's serving recipe
(``chip_smoke.SLICE_CFG``, untrained weights), refreshes the CV histories,
exports the trainer and loads the artifact, then times on the host clock
(synchronised, median of 5 after 2 warm-up calls) one 2048-id request of
each, the Predictor's device call and its parts (the copy of the stored
histories, the seeded generator, the eval epoch alone):

    python scripts/profile_predictor.py      # from the repository root
"""

import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stochastic_gcn_tpu_torch import serving  # noqa: E402
from stochastic_gcn_tpu_torch.config import Config  # noqa: E402
from stochastic_gcn_tpu_torch.data.loaders import reddit_like  # noqa: E402
from stochastic_gcn_tpu_torch.training.loop import Trainer  # noqa: E402


def host_ms(fn, reps: int = 7) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[2:])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_predictor: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = reddit_like()
    tr = Trainer(Config(**chip_smoke.SLICE_CFG), ds, device="cuda")
    ids = ds.test_d[:chip_smoke.REQUEST_IDS]
    tr.predict(ids)
    with tempfile.TemporaryDirectory() as d:
        serving.export_predictor(tr, os.path.join(d, "artifact"))
        pred = serving.load_predictor(os.path.join(d, "artifact"))
    bm = np.asarray(ids, np.int32).reshape(1, -1)
    bm_dev = torch.from_numpy(bm).cuda()
    hist = tuple(tuple(h.clone() for h in hl) for hl in pred._histories)

    @torch.no_grad()
    def epoch_alone():               # on a copy: the epoch scatters into it
        pred._epoch(pred._params, hist, pred._graph,
                    pred._features, pred._labels, bm_dev, tr.gen,
                    pred._importance)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    for label, fn in (
            ("Trainer.predict", lambda: tr.predict(ids)),
            ("Predictor.predict", lambda: pred.predict(ids)),
            ("Predictor device call", lambda: pred._call(bm)),
            ("  copy of the stored histories", lambda: tuple(
                tuple(h.clone() for h in hl) for hl in pred._histories)),
            ("  seeded generator", lambda: torch.Generator(
                device="cuda").manual_seed(1)),
            ("  eval epoch alone", epoch_alone)):
        print(f"{label}: {host_ms(fn):.3f} ms")


if __name__ == "__main__":
    main()
