"""Vector mode: a reply's scores are cosines.

- score deviation: |served score - reference cosine of that doc|;
- rank deviation: the amount by which the reference's i-th best cosine
  exceeds the reference cosine of the i-th hit (a missing hit counts 0),
  over the positions the reference has matches for;
- ``hit_dev``: the larger of the two; ``count_dev``: |served count -
  reference count of cos > 0|.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.compare import replies_tensors


def numbers(ref, raw, cfg, body, texts, replies, device) -> Dict[str, float]:
    limit = int(body["limit"])
    q = ref.query_vectors(texts, int(cfg["vector"]["dim"]))
    ids, scores, counts = replies_tensors(replies, limit, device)
    b = len(texts)
    top = torch.full((b, limit), float("-inf"), dtype=torch.float64, device=device)
    pos = torch.zeros(b, dtype=torch.float64, device=device)
    at_hit = torch.zeros((b, limit), dtype=torch.float64, device=device)
    for lo, s in ref.Cosine(raw["vecs"], device).blocks(q):
        top = torch.topk(torch.cat([top, s], dim=1), limit, dim=1).values
        pos += (s > 0).sum(dim=1)
        inside = (ids >= lo) & (ids < lo + s.shape[1])
        local = torch.where(inside, ids - lo, torch.zeros_like(ids))
        at_hit = torch.where(inside, torch.gather(s, 1, local), at_hit)
        del s
    has = ids >= 0
    score_dev = torch.where(has, (scores - at_hit).abs(), torch.zeros_like(scores))
    due = torch.arange(limit, device=device)[None, :] < pos[:, None]
    rank_dev = torch.where(due, top - torch.where(has, at_hit, torch.zeros_like(at_hit)),
                           torch.zeros_like(top)).clamp(min=0.0)
    return {
        "hit_dev": max(float(score_dev.max()), float(rank_dev.max())),
        "count_dev": float((counts - pos).abs().max()),
    }
