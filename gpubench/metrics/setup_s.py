"""Seconds from the process's start (the first line of ``run.py``) to the
window's start: graph generation, the order, building or loading the
kernels, and warm-up."""


def read(rec):
    return rec["setup_s"]
