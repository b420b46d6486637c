"""Kernel launches in the traced window per request answered in it (every
kernel: the port's hand-written ones and torch's)."""

from portbench import trace


def read(w):
    if w.trace is None or not w.answered:
        return None
    n = trace.kernel_launches(w.trace)
    return n / w.answered if n else None
