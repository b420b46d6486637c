"""K2 (``csrc/knn_subblock_max.cu``): per-sub-block max and positive count.

Its least work per launch (``chip_smoke.k2_work``): the live corpus rows
and the queries read once (bf16), both outputs of every 32-row sub-block
written once (f32 + int32 per query), a multiply-add per live element and
query. The corpus counts as read once per launch, whatever passes the
kernel makes over it. The time is ``subblock_max_kernel``'s, from the
device trace.

``install`` records the shape of every call (it wraps
``ops.knn.subblock_max``); ``share`` takes the mean bound of the calls
made in the window times the launches in the trace, over the launches'
time, in percent.
"""

from __future__ import annotations

import re
import time

import numpy as np

from . import peaks

KERNEL = re.compile(r"\bsubblock_max_kernel\b")


def work(n: int, n_valid: int, d: int, q: int, sub: int = 32):
    return n_valid * d * 2 + q * d * 2 + (n // sub) * q * 8, 2 * n_valid * d * q


def install(w) -> None:
    from orama_core_tpu_torch.ops import knn

    calls = w.records.setdefault("k2", [])
    inner = knn.subblock_max

    def recorded(vecs, queries, sub, n_valid):
        n, d = vecs.shape
        calls.append((time.perf_counter(),
                      *work(int(n), int(n_valid), int(d), int(queries.shape[0]),
                            int(sub))))
        return inner(vecs, queries, sub, n_valid)

    knn.subblock_max = recorded


def share(w):
    calls = [c for c in w.records.get("k2", ()) if w.t0 <= c[0] < w.t1]
    tr = w.trace
    if not calls or tr is None:
        return None
    hits = [(s, e) for name, s, e in tr.device if KERNEL.search(name)]
    secs = sum(e - s for s, e in hits) / 1e9
    if not hits or secs <= 0:
        return None
    bound = np.mean([peaks.bound_s(b, o, peaks.BF16_FLOPS)[0] for _t, b, o in calls])
    return 100.0 * bound * len(hits) / secs
