"""The whole served request's share (%) of the card's float32 peak (67
TFLOP/s; the port's products run in float32, TF32 off): the operations
the traced window's requests need (``counts.py``: dense products and
aggregations, forward only, live rows only) over the window's seconds."""


def read(r):
    if r.trace is None or "flops" not in r.counts or r.trace.busy_s <= 0:
        return None
    return 100.0 * r.counts["flops"] / r.trace.window_s \
        / r.peaks.FLOAT32_FLOP_PER_S
