"""K1 (``csrc/bm25_scan.cu``) over a micro-batch's combined posting plan.

A call of ``ops.bm25.bm25_scores_blocked_aligned_batch`` is one fill of
its ``b x n_docs`` f32 scores and one launch of ``bm25_scan_kernel``
right behind it (``ops/bm25._k1_launch``). Its least work: each planned
posting's doc, tf, df and length (16 bytes) and each real plan block's
four int32 read once, the ``b x n_docs`` scores written once, and 20 f32
operations a posting (``chip_smoke.k1_batch``'s count). The time is the
kernel's and the fill's right before it, from the device trace.

``install`` records the plan of every batch the program builds (it wraps
``ops.bm25.build_batch_plan_aligned``, a host function that runs once per
K1 launch of the batched path); ``share`` takes the mean bound of the
plans built in the window times the launches in the trace, over the
launches' time, in percent.
"""

from __future__ import annotations

import re
import time

import numpy as np

from . import peaks

KERNEL = re.compile(r"\bbm25_scan_kernel\b")
FILL = re.compile(r"[Ff]ill|^Memset")


def work(n_postings: int, n_blocks: int, rows: int, n_docs: int):
    return n_postings * 16 + n_blocks * 16 + rows * n_docs * 4, n_postings * 20


def install(w) -> None:
    from orama_core_tpu_torch.ops import bm25

    plans = w.records.setdefault("k1", [])
    build = bm25.build_batch_plan_aligned

    def recorded(row_plans):
        plan = build(row_plans)
        posts = sum(int(sum(p_len)) for _lo, p_len in row_plans)
        plans.append((time.perf_counter(),
                      *work(posts, int(np.count_nonzero(plan[2])), len(row_plans),
                            w.capacity)))
        return plan

    bm25.build_batch_plan_aligned = recorded


def share(w):
    plans = [p for p in w.records.get("k1", ()) if w.t0 <= p[0] < w.t1]
    tr = w.trace
    if not plans or tr is None:
        return None
    launches, secs = 0, 0.0
    prev = None
    for name, s, e in tr.device:
        if KERNEL.search(name):
            launches += 1
            secs += (e - s) / 1e9
            if prev is not None and FILL.search(prev[0]):
                secs += (prev[2] - prev[1]) / 1e9
        prev = (name, s, e)
    if not launches or secs <= 0:
        return None
    bound = np.mean([peaks.bound_s(b, o, peaks.F32_FLOPS)[0] for _t, b, o in plans])
    return 100.0 * bound * launches / secs
