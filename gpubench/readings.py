"""What a run hands the per-layer metrics' readers (``metrics/<name>/
reader.py``: ``read(r) -> float or None``).  A reader that finds nothing to
read returns None and the metric is left out of the line."""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from . import peaks
from .trace import Summary


@dataclass
class Readings:
    trace: Optional[Summary] = None
    counts: dict = field(default_factory=dict)   # "fanout_bytes", "flops"
    memory: dict = field(default_factory=dict)   # "resident_bytes", ...
    peaks: object = peaks


def kernel_names(metric_dir: Path) -> list:
    """The kernel-name patterns of a metric: one pattern a line in each
    ``kernels/*.txt`` file of its directory (a kernel added later is a file
    added, no file edited)."""
    out = []
    for f in sorted((Path(metric_dir) / "kernels").glob("*.txt")):
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.startswith("#")]
    return out


def roofline(r: Readings, metric_dir: Path, key: str) -> Optional[float]:
    """The share (%) of the memory bound that the kernels named in
    ``metric_dir`` reach: ``r.counts[key]`` bytes over the card's memory
    rate, over those kernels' device seconds in the traced window."""
    if r.trace is None or key not in r.counts:
        return None
    seconds = r.trace.seconds_of(kernel_names(metric_dir))
    if seconds <= 0:
        return None
    return 100.0 * r.counts[key] / r.peaks.HBM_BYTES_PER_S / seconds


def idle_pct(r: Readings) -> Optional[float]:
    """The device's idle share (%) of the traced window."""
    if r.trace is None or r.trace.busy_s <= 0 or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def load_reader(metric_dir: Path):
    """The ``read`` function of ``metric_dir/reader.py``."""
    path = Path(metric_dir) / "reader.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + Path(metric_dir).name.replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
