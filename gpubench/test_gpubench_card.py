"""The cells and their controls on the card at a small size: the port's
kernels built and run, the check passing, and the control (real TF32)
failing.  Skips without a card (``python -m pytest gpubench`` on the GPU
machine runs them)."""

import time
from pathlib import Path

import pytest

from gpubench import cells, controls
from gpubench.manifest import Bench
from gpubench.test_gpubench_cells import SMALL, WORKLOADS

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_cell_on_the_card(cuda_device, workload):
    res = cells.run(Bench(ROOT), workload, 3, 0.5, True, cuda_device,
                    time.perf_counter(), SMALL)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_on_the_card(cuda_device, workload):
    limits = Bench(ROOT).limits(workload)
    got = controls.readings(Bench(ROOT), workload, 4, cuda_device, SMALL)
    for name, nums in got.items():
        over = [k for k, v in nums.items() if k in limits and v > limits[k]]
        assert bool(over) == (name != "sound"), (name, nums)
