"""95th percentile of the latency of the requests issued in the window.

From a client's call to its return, in ms; a failed request counts as
slower than any answered one. In a closed loop the tail is where a
request that misses a batch, or a batch that splits, shows."""

import math

import numpy as np


def read(w):
    lat = [(t_ret - t_call) * 1e3 if ok else math.inf
           for _c, t_call, t_ret, ok in w.requests]
    return float(np.percentile(lat, 95)) if lat else None
