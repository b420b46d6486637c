"""Median of the program's ``batcher.queued`` spans in the window, in ms:
a request's wait in the micro-batcher, from ``MicroBatcher.submit``'s
enqueue to the start of the batch that carries it (the program's own
stamps, so the client's work before ``submit`` is not in it)."""

import numpy as np

from portbench import spans


def install(w):
    spans.install()


def read(w):
    q = spans.named(w, "batcher.queued")
    return float(np.percentile([spans.ms(s) for s in q], 50)) if q else None
