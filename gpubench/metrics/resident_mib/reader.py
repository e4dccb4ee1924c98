"""Device memory (MiB) allocated once set-up is done, before the window:
inputs, graphs, weights, optimizer state, histories, or the served
artifact (``torch.cuda.memory_allocated``)."""


def read(r):
    b = r.memory.get("resident_bytes")
    return None if b is None else b / 2.0 ** 20
