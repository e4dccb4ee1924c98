"""The device's idle share (%) of the traced window: one less the union
of its busy intervals (profiler) over the window's host seconds."""

from gpubench.readings import idle_pct


def read(r):
    return idle_pct(r)
