"""Median time a request waits in the micro-batcher.

From a client's call to the start of the ``search_batch`` call that
carries its request: a client has one request in flight, so the batch
that carries it is the first to start after its call that lists the
client. Over the requests issued in the window, in ms."""

import bisect

import numpy as np


def read(w):
    starts = {}
    for t, _e, clients in w.batches:
        for c in clients:
            starts.setdefault(c, []).append(t)
    waits = []
    for c, t_call, _t_ret, ok in w.requests:
        ts = starts.get(c)
        if not ok or not ts:
            continue
        i = bisect.bisect_left(ts, t_call)
        if i < len(ts):
            waits.append((ts[i] - t_call) * 1e3)
    return float(np.percentile(waits, 50)) if waits else None
