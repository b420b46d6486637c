"""Hybrid score fusion on dense per-doc score arrays.

Port of ``orama_core_tpu/ops/fusion.py`` (the reference's min-max join,
`collection.rs:750-772`, plus RRF). Min-max on dense arrays (scores >= 0,
unmatched == 0) divides by the global max. RRF ranks follow a stable
descending order (lower index wins ties), as the reference's argsort does.

The reference proposes its RRF candidates with a block-max tiered top-k
that is not tie-stable (``_tiered_topk``); the port proposes them with
``topk_stable``, so on tie-free inputs both give the same candidates and
the same result."""

from __future__ import annotations

import torch

from .topk import topk_stable

RRF_K = 60.0


def minmax_fuse(ft_scores: torch.Tensor, vec_scores: torch.Tensor):
    m = torch.maximum(ft_scores.max(), vec_scores.max())
    m = torch.clamp(m, min=1e-9)
    return (ft_scores + vec_scores) / m


def _ranks(scores: torch.Tensor) -> torch.Tensor:
    """rank[d] = #{s' > s_d} + #{s' == s_d, d' < d} (0 = best)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(
        -1, order,
        torch.arange(scores.shape[-1], device=scores.device).expand_as(order),
    )
    return ranks


def _rrf_of(scores: torch.Tensor) -> torch.Tensor:
    ranks = _ranks(scores).to(torch.float32)
    return torch.where(
        scores > 0, 1.0 / (RRF_K + ranks + 1.0), torch.zeros_like(scores)
    )


def rrf_fuse(ft_scores: torch.Tensor, vec_scores: torch.Tensor):
    return _rrf_of(ft_scores) + _rrf_of(vec_scores)


def rrf_candidate_count(k: int) -> int:
    """Smallest provably-exact per-modality candidate budget for
    rrf_fuse_topk, bucket-padded (a doc outside both top-``cand`` lists has
    fused <= 2/(61+cand), and at least k docs with a modality rank
    < (cand-61)/2 >= k beat that)."""
    need = 2 * k + 64
    for b in (128, 256, 512, 1024):
        if need <= b:
            return b
    return need


def dense_topk(scores: torch.Tensor, k: int):
    """(vals, idx) top-k over dense scores — the final selector of the
    fused serving program (tie-stable; see module docstring)."""
    return topk_stable(scores, k)


def rrf_fuse_topk(ft_scores: torch.Tensor, vec_scores: torch.Tensor, k: int,
                  cand: int):
    """Exact RRF top-k: propose the top-``cand`` docs per modality, take
    their exact global ranks (stable order), fuse, dedup, top-k. Returns
    (values f32[k], ids int64[k], count = #docs matched by either
    modality)."""
    n = ft_scores.shape[0]
    c = min(cand, n)
    fi = topk_stable(ft_scores, c)[1]
    vi = topk_stable(vec_scores, c)[1]
    g = torch.cat([fi, vi])                              # [2c]
    ft_g = ft_scores[g]
    vec_g = vec_scores[g]
    r_ft = _ranks(ft_scores)[g].to(torch.float32)
    r_vec = _ranks(vec_scores)[g].to(torch.float32)
    zero = torch.zeros_like(ft_g)
    fused = torch.where(ft_g > 0, 1.0 / (RRF_K + r_ft + 1.0), zero) + \
        torch.where(vec_g > 0, 1.0 / (RRF_K + r_vec + 1.0), zero)
    # dedup docs proposed by both modalities (identical fused values)
    g_s, order = torch.sort(g, stable=True)
    f_s = fused[order]
    dup = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=g.device), g_s[1:] == g_s[:-1]
    ])
    f_s = torch.where(dup, torch.full_like(f_s, float("-inf")), f_s)
    v, ix = topk_stable(f_s, k)
    count = torch.sum((ft_scores > 0) | (vec_scores > 0)).to(torch.int32)
    return torch.clamp(v, min=0.0), g_s[ix], count
