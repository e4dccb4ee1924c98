"""Share (%) of the memory bound reached by the fanout kernels
(``ops/cuda_spmm.py``: ``fanout_aggregate`` and its backward): the bytes
the traced window's aggregations need (``counts.py``) over 3.35 TB/s,
over the device seconds of the kernels named in ``kernels/``."""

from pathlib import Path

from gpubench.readings import roofline


def read(r):
    return roofline(r, Path(__file__).parent, "fanout_bytes")
