"""Requests per ``search_batch`` call of the micro-batcher, in the window.

The run wraps the reader's ``search_batch`` in the traced run and counts
the requests each call carries (``server/batcher.py`` forms the
batches)."""


def read(w):
    sizes = [len(clients) for t, _e, clients in w.batches if w.t0 <= t < w.t1]
    return sum(sizes) / len(sizes) if sizes else None
