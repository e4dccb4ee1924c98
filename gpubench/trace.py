"""The device trace of a ``--trace 1`` run, reduced to what the metrics read.

``torch.profiler`` (CPU and CUDA activities) records the traced window;
:func:`summarize` reads its events once: the device's busy seconds (the
union of the intervals in which a kernel, a copy or a memset ran, so
overlapping work counts once), each kernel name's device seconds, the
operations that took most device time, and the idle gaps between device
work, each put down to the innermost host operation that was running at
the gap's middle.  Nothing here runs outside the traced run.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

TOP = 10


@dataclass
class Summary:
    window_s: float
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)   # name -> device seconds
    kernels: int = 0                               # kernel launches
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def seconds_of(self, patterns) -> float:
        """Device seconds of the kernels whose names contain one of
        ``patterns``."""
        return sum(s for name, s in self.kernel_s.items()
                   if any(p in name for p in patterns))


@contextlib.contextmanager
def profiled(enabled: bool):
    """A profiler over the block when ``enabled`` (CUDA activity only where
    there is a card), else nothing; yields it or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _union(intervals) -> tuple:
    """(total length, merged intervals) of ``(start, end)`` pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _events(prof):
    """``(on_device, start_ns, end_ns, name)`` of every profiler event, by
    the kineto event's device."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        yield e.device_type() == cuda, t0, t0 + e.duration_ns(), e.name()


def summarize(prof, window_s: float) -> Summary:
    """Reduce the profiler ``prof`` of a window of ``window_s`` host
    seconds."""
    out = Summary(window_s=window_s)
    device, host = [], []
    for on_device, t0, t1, name in _events(prof):
        (device if on_device else host).append((t0, t1, name))
    if not device:
        return out
    busy_ns, merged = _union([(a, b) for a, b, _ in device])
    out.busy_s = busy_ns * 1e-9
    for a, b, name in device:
        out.kernel_s[name] = out.kernel_s.get(name, 0.0) + (b - a) * 1e-9
    out.kernels = sum(1 for a, b, name in device
                      if not name.startswith("Memcpy")
                      and not name.startswith("Memset"))
    out.device_ops = sorted(([n, s] for n, s in out.kernel_s.items()),
                            key=lambda x: -x[1])[:TOP]
    # the gaps between merged device intervals, by the innermost host
    # operation at each gap's middle
    host.sort()
    starts = [a for a, _, _ in host]
    by_label: dict = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        mid = (end + nxt) // 2
        label, width = "host idle", None
        i = bisect.bisect_right(starts, mid)
        for a, b, name in reversed(host[max(0, i - 64):i]):
            if a <= mid < b and (width is None or b - a < width):
                label, width = name, b - a
        by_label[label] = by_label.get(label, 0.0) + (nxt - end) * 1e-9
    out.idle_gaps = sorted(([n, s] for n, s in by_label.items()),
                           key=lambda x: -x[1])[:TOP]
    return out
