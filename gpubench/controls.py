"""The readings that the limits of ``limits/`` are set from.

For a cell and a seed: the port's numbers against the reference (a sound
run), the control's (the reference in the port's place, its dense
products in TF32: the nearest precision below the float32 the
configurations state, with TF32 off), and, for a train cell, the reference
with half the batch left out and the mean taken over the rest (one of the
faults a step can have; a state left unchanged reads 1 on ``update`` by
construction).  No window is run.

    python3 -m gpubench.controls WORKLOAD SEED [SEED ...]

prints one JSON line a seed.  ``test_controls.py`` runs the same at a
small size on the CPU.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from . import cells, check, model, reference
from .manifest import Bench


def readings(bench, workload: str, seed: int, device,
             overrides=None) -> dict:
    """``{"sound", "control", ...}``: each a dict of the cell's numbers."""
    cell = bench.cell(workload)
    overrides = overrides or {}
    config = {**bench.config(cell.config), **overrides.get("config", {})}
    traffic = {**bench.traffic(cell.traffic), **overrides.get("traffic", {})}
    dev = torch.device(device)
    r = cells.Run(bench, cell, config, traffic, seed, 0.0, False, dev,
                  time.perf_counter())
    if traffic["kind"] == "train":
        return _train(r, dev)
    return _predict(r, dev)


def _train(r, dev) -> dict:
    tr, g, steps, params0, hist0, prog, draws = cells.train_setup(r)
    cfg = tr.cfg
    est = cells._estimator(cfg)
    del tr
    cells._free(dev)
    g = g.to(dev)
    rows = cells.graph_rows(g, cfg, True)
    ref = cells.train_reference(g, rows, steps, params0, hist0, cfg, draws)
    out = {"sound": check.train_numbers(prog, ref, params0, est)}
    for name, kw in (("control", dict(precision="tf32")),
                     ("half_batch", dict(half_batch=True))):
        other = cells.train_reference(g, rows, steps, params0, hist0, cfg,
                                      draws, **kw)
        # the variant in the port's place: its losses, first gradient and
        # weights against the sound reference's
        as_prog = {"losses": other.losses, "grad1": other.grad1,
                   "params": other.params}
        nums = check.train_numbers(as_prog, ref, params0, est)
        # the draws and the history rows are the port's, read by the sound
        # comparison alone
        for key in ("history_first", "bad_draws", "draw_z", "keep_z",
                    "fields"):
            nums.pop(key, None)
        out[name] = nums
    return out


def _predict(r, dev) -> dict:
    g = cells.data.draw(r.config, cells.stream(r.seed, 0), dev)
    steps = cells._steps(r.config, False)
    params = model.make_weights(steps, cells.stream(r.seed, 1), dev)
    k = int(r.traffic["request_ids"])
    n = cells.CHECKED_REQUESTS
    pool = cells.request_pool(g.num_nodes, k, n, cells.stream(r.seed, 2),
                              dev)
    ids = [torch.from_numpy(row).long().to(dev) for row in pool]
    rows = cells.graph_rows(g, cells.port_config(r.config, r.traffic,
                                                 r.seed), False)
    want = reference.predict(g, steps, params, ids, rows)
    got = reference.predict(g, steps, params, ids, rows, precision="tf32")
    return {"control": check.predict_numbers(got, want)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    bench = Bench(Path(__file__).resolve().parent.parent)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in argv[1:]:
        t = time.perf_counter()
        out = readings(bench, argv[0], int(seed), dev)
        print(json.dumps({"workload": argv[0], "seed": int(seed),
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
