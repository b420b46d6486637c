"""K2's share of its roofline in the window (``portbench/roofline/k2.py``)."""

from portbench.roofline import k2


def install(w):
    k2.install(w)


def read(w):
    return k2.share(w)
