"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks
for: set-up (the first run in a checkout also builds the port's kernels
into ``stochastic_gcn_tpu_torch/_build/``), warm-up, the measured window,
the check against the reference; then the last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit, which also end standard error).
With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled window.

Exits non-zero and prints no result without CUDA or with fewer cards than
the cell asks for, and if JAX, flax or the JAX package is loaded once the
window has closed.
"""

import time

T0 = time.perf_counter()      # set-up counts from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root in place of this script's directory, whose module
# names (trace, data, ...) would shadow the standard library's
sys.path[0] = str(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "stochastic_gcn_tpu")


def jax_modules(names) -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's (``stochastic_gcn_tpu_torch`` is
    none of them)."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the port's nvcc build stays inside the checkout (ops/_build.py); no
    # library that loads JAX by itself is used
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from gpubench import cells
    from gpubench.manifest import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cells.run(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", T0)
    found = jax_modules(sys.modules)
    if found:
        print(f"gpubench: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
