"""Fulltext mode: a reply's scores are BM25 scores.

Relative to the request's best reference score (1 where it has none):

- score deviation: |served score - reference BM25 of that doc|;
- rank deviation: the amount by which the reference's i-th best score
  exceeds the reference score of the i-th hit (a missing hit counts 0),
  over the positions the reference has matches for;
- ``hit_dev``: the larger of the two; ``count_dev``: |served count -
  reference count of docs with a positive score|.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.compare import replies_tensors


def numbers(ref, raw, cfg, body, texts, replies, device,
            chunk: int = 16) -> Dict[str, float]:
    limit = int(body["limit"])
    bm25 = ref.Bm25(raw, int(cfg["text"]["n_terms"]), device)
    out = {"hit_dev": 0.0, "count_dev": 0.0}
    for c0 in range(0, len(texts), chunk):
        c1 = min(c0 + chunk, len(texts))
        ids, scores, counts = replies_tensors(replies[c0:c1], limit, device)
        s = bm25.rows(texts[c0:c1])
        top = torch.topk(s, limit, dim=1).values
        pos = (s > 0).sum(dim=1).to(torch.float64)
        scale = top[:, :1].clamp(min=0.0)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        has = ids >= 0
        at_hit = torch.where(has, torch.gather(s, 1, torch.where(
            has, ids, torch.zeros_like(ids))), torch.zeros_like(scores))
        del s
        score_dev = torch.where(has, (scores - at_hit).abs(), torch.zeros_like(scores))
        due = torch.arange(limit, device=device)[None, :] < pos[:, None]
        rank_dev = torch.where(due, top - at_hit, torch.zeros_like(top)).clamp(min=0.0)
        out["hit_dev"] = max(out["hit_dev"], float((score_dev / scale).max()),
                             float((rank_dev / scale).max()))
        out["count_dev"] = max(out["count_dev"], float((counts - pos).abs().max()))
    return out
