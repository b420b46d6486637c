"""Hybrid mode with RRF fusion: a reply's scores are fused ranks.

A rank is an integer, so a rounding-sized difference in a score can move
a rank by one and a fused score by a whole step. The reference therefore
bounds each doc's fused score by an interval: a doc's rank lies between
the number of docs whose score is above its own by more than a tolerance
and the number whose score is at least its own less that tolerance (ties
inside). The tolerances are ``EPS_COS`` on a cosine and ``EPS_BM25`` of a
BM25 score: far above float32's rounding of a sum of 384 products, far
below what a coarser precision moves.

- score deviation: the distance of a served score outside its doc's
  interval;
- rank deviation: the amount by which the i-th largest lower end over all
  docs exceeds the upper end of the i-th hit's interval;
- ``hit_dev``: the larger of the two; ``count_dev``: the distance of a
  served count outside [docs surely matched, docs possibly matched].

Both ends carry a relative slack of ``SLACK`` for the program's float32
arithmetic of 1 / (61 + rank).
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.compare import replies_tensors

EPS_COS = 1e-5
EPS_BM25 = 1e-5
SLACK = 1e-6
RRF_K1 = 61.0  # RRF's k (60) plus one: rank 0 scores 1 / 61


def rank_bounds(s: torch.Tensor, eps: torch.Tensor):
    """For rows of scores ``s`` [b, n] with tolerances ``eps``: (least rank,
    greatest rank, surely positive, possibly positive) of every doc."""
    n = s.shape[1]
    asc = torch.sort(s, dim=1).values
    n_gt = n - torch.searchsorted(asc, (s + eps).contiguous(), right=True)
    n_ge = n - torch.searchsorted(asc, (s - eps).contiguous(), right=False)
    return n_gt, n_ge - 1, s - eps > 0, s + eps > 0


def _rrf(rank: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    return torch.where(on, 1.0 / (RRF_K1 + rank.to(torch.float64)),
                       torch.zeros((), dtype=torch.float64, device=rank.device))


def numbers(ref, raw, cfg, body, texts, replies, device,
            chunk: int = 16) -> Dict[str, float]:
    limit = int(body["limit"])
    bm25 = ref.Bm25(raw, int(cfg["text"]["n_terms"]), device)
    cos = ref.Cosine(raw["vecs"], device)
    q = ref.query_vectors(texts, int(cfg["vector"]["dim"]))
    out = {"hit_dev": 0.0, "count_dev": 0.0}
    for c0 in range(0, len(texts), chunk):
        c1 = min(c0 + chunk, len(texts))
        ids, scores, counts = replies_tensors(replies[c0:c1], limit, device)
        ft = bm25.rows(texts[c0:c1])
        v = cos.rows(q[c0:c1])
        f_lo, f_hi, f_sure, f_maybe = rank_bounds(ft, EPS_BM25 * ft)
        del ft
        v_lo, v_hi, v_sure, v_maybe = rank_bounds(v, torch.full_like(v, EPS_COS))
        del v
        fused_lo = _rrf(f_hi, f_sure) + _rrf(v_hi, v_sure)
        fused_hi = _rrf(f_lo, f_maybe) + _rrf(v_lo, v_maybe)
        sure = (f_sure | v_sure).sum(dim=1).to(torch.float64)
        maybe = (f_maybe | v_maybe).sum(dim=1).to(torch.float64)
        del f_lo, f_hi, v_lo, v_hi
        best_lo = torch.topk(fused_lo, limit, dim=1).values * (1.0 - SLACK)
        has = ids >= 0
        safe = torch.where(has, ids, torch.zeros_like(ids))
        lo_hit = torch.gather(fused_lo, 1, safe) * (1.0 - SLACK)
        hi_hit = torch.where(has, torch.gather(fused_hi, 1, safe) * (1.0 + SLACK),
                             torch.zeros_like(scores))
        outside = torch.maximum(lo_hit - scores, scores - hi_hit).clamp(min=0.0)
        score_dev = torch.where(has, outside, torch.zeros_like(outside))
        rank_dev = (best_lo - hi_hit).clamp(min=0.0)
        count_dev = torch.maximum(sure - counts, counts - maybe).clamp(min=0.0)
        out["hit_dev"] = max(out["hit_dev"], float(score_dev.max()),
                             float(rank_dev.max()))
        out["count_dev"] = max(out["count_dev"], float(count_dev.max()))
        del fused_lo, fused_hi
    return out
