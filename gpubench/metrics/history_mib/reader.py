"""Bytes (MiB) of the control variate's history tables, train and eval
(``training/step.py``: the train tables in ``history_dtype``, the eval
tables in ``test_history_dtype``); nothing without a control variate."""


def read(r):
    b = r.memory.get("history_bytes")
    return b / 2.0 ** 20 if b else None
