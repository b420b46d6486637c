"""K1's share of its roofline in the window (``portbench/roofline/k1.py``)."""

from portbench.roofline import k1


def install(w):
    k1.install(w)


def read(w):
    return k1.share(w)
