"""The comparison that decides ``correct``: served replies against the reference.

Each compared request's reply (its hits' ids and scores in order, and
its match count) is held to the plain reference's scores of the same
request (``portbench/reference/<reference>.py``), on a sample of the
requests answered in the window. A mix's request kind names its
comparison, a module of ``portbench/comparisons/`` with
``numbers(ref, raw, cfg, body, texts, replies, device)``; each returns
the worst of its numbers over its requests, and a number of the run is
the worst over the kinds. ``portbench/limits/<workload>.json`` holds the
limit of each and PERF.md the readings the limits were set from.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

Reply = Tuple[List[int], List[float], int]  # hit ids, hit scores, count


def replies_tensors(replies: Sequence[Reply], limit: int, device):
    """(ids i64[b, limit] with -1 past the hits, scores f64[b, limit],
    counts f64[b]) of ``replies``."""
    b = len(replies)
    ids = torch.full((b, limit), -1, dtype=torch.int64)
    scores = torch.zeros((b, limit), dtype=torch.float64)
    for r, (hid, hs, _c) in enumerate(replies):
        k = min(len(hid), limit)
        ids[r, :k] = torch.as_tensor(hid[:k], dtype=torch.int64)
        scores[r, :k] = torch.as_tensor(hs[:k], dtype=torch.float64)
    counts = torch.as_tensor([c for _i, _s, c in replies], dtype=torch.float64)
    return ids.to(device), scores.to(device), counts.to(device)


def numbers(ref, raw: Dict[str, Any], cfg: Dict[str, Any], mix: Dict[str, Any],
            kinds: List[int], texts: List[str], replies: List[Reply],
            device) -> Dict[str, float]:
    """The compared numbers of a sample of requests (their ``kinds`` and
    ``texts``) and the program's ``replies`` to them."""
    from . import spec

    out: Dict[str, float] = {}
    for k, kind in enumerate(mix["kinds"]):
        rows = [i for i, kk in enumerate(kinds) if kk == k]
        if not rows:
            continue
        got = spec.comparison(kind["comparison"]).numbers(
            ref, raw, cfg, kind["body"], [texts[i] for i in rows],
            [replies[i] for i in rows], device)
        for name, v in got.items():
            out[name] = max(out.get(name, -math.inf), v)
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(values.get(k, math.nan)) and values[k] <= limits[k]
               for k in limits)
