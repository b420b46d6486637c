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


# Candidate ranks are counted in this many interleaved histograms per row
# (doc id mod _SPREAD): most docs beat no candidate, and one shared count
# would serialize their adds
_SPREAD = 64

# Up to this many rows, sorting each row (one radix sort per row) costs
# the device no more than the histogram's passes over B x n int64 keys
# (at 4 rows the two are even); from 8 rows on the histogram wins.
# chip_smoke.py's rrf_ranks line times both on an H100 at n ~ 1M: the
# sort ~0.25 ms per row, the histogram ~0.9 ms plus ~0.13 ms per row.
_SORT_MAX_ROWS = 4


def _candidate_ranks(scores: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """int64[B, m]: the exact rank of each candidate ``g`` [B, m] in its
    row of ``scores`` [B, n] (rank = #{s' > s} + #{s' == s, d' < d}, the
    stable descending order of ``_ranks``): the rows' stable sort for a
    few rows, ``_histogram_ranks`` for more."""
    if scores.shape[0] <= _SORT_MAX_ROWS:
        return torch.gather(_ranks(scores), 1, g)
    return _histogram_ranks(scores, g)


def _histogram_ranks(scores: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``_candidate_ranks`` without sorting the rows. Every doc gets one
    int64 key that orders (score desc, id asc): the score's f32 bits made
    monotone in the high half, n - 1 - id in the low half. A candidate's
    rank is then the number of keys above its own: each doc finds, by one
    binary search into its row's sorted candidate keys, how many
    candidates it beats, and a histogram of those counts summed from the
    top gives every candidate's rank."""
    b, n = scores.shape
    m = g.shape[1]
    dev = scores.device
    bits = (scores + 0.0).contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # negatives flip
    keys = (bits.to(torch.int64) << 32) | (n - 1 - torch.arange(n, device=dev))
    ck, order = torch.sort(torch.gather(keys, 1, g), dim=1)
    beats = torch.searchsorted(ck, keys, out_int32=True)   # [B, n] in [0, m]
    del keys
    bins = (m + 1) * _SPREAD
    spread = (torch.arange(n, device=dev, dtype=torch.int32) % _SPREAD)
    at = beats * _SPREAD + spread + (
        torch.arange(b, device=dev, dtype=torch.int32)[:, None] * bins)
    hist = torch.bincount(at.reshape(-1), minlength=b * bins)
    hist = hist.reshape(b, m + 1, _SPREAD).sum(dim=2)
    above = hist.flip(1).cumsum(1).flip(1)                 # #{beats >= j}
    ranks = torch.empty_like(order)
    return ranks.scatter_(1, order, above[:, 1:])


def rrf_fuse_topk_batch(ft_scores: torch.Tensor, vec_scores: torch.Tensor,
                        k: int, cand: int):
    """Row-wise exact RRF top-k over [B, n] score batches, the batched
    serving program's fusion stage (the reference's
    ``rrf_fuse_topk_batch``): per row, the top-``cand`` docs of each
    modality, their exact global ranks (stable order, integers), fused,
    deduplicated, top-k. Returns (values f32[B, k], ids int64[B, k],
    counts int32[B] = #docs matched by either modality)."""
    n = ft_scores.shape[1]
    c = min(cand, n)
    fi = topk_stable(ft_scores, c)[1]
    vi = topk_stable(vec_scores, c)[1]
    g = torch.cat([fi, vi], dim=1)                       # [B, 2c]
    ft_g = torch.gather(ft_scores, 1, g)
    vec_g = torch.gather(vec_scores, 1, g)
    r_ft = _candidate_ranks(ft_scores, g).to(torch.float32)
    r_vec = _candidate_ranks(vec_scores, g).to(torch.float32)
    zero = torch.zeros_like(ft_g)
    fused = torch.where(ft_g > 0, 1.0 / (RRF_K + r_ft + 1.0), zero) + \
        torch.where(vec_g > 0, 1.0 / (RRF_K + r_vec + 1.0), zero)
    # dedup docs proposed by both modalities (identical fused values)
    g_s, order = torch.sort(g, dim=1, stable=True)
    f_s = torch.gather(fused, 1, order)
    dup = torch.cat([
        torch.zeros(g.shape[0], 1, dtype=torch.bool, device=g.device),
        g_s[:, 1:] == g_s[:, :-1],
    ], dim=1)
    f_s = torch.where(dup, torch.full_like(f_s, float("-inf")), f_s)
    v, ix = topk_stable(f_s, k)
    counts = torch.sum((ft_scores > 0) | (vec_scores > 0), dim=1)
    return (torch.clamp(v, min=0.0), torch.gather(g_s, 1, ix),
            counts.to(torch.int32))


def rrf_fuse_topk(ft_scores: torch.Tensor, vec_scores: torch.Tensor, k: int,
                  cand: int):
    """Exact RRF top-k: propose the top-``cand`` docs per modality, take
    their exact global ranks (stable order), fuse, dedup, top-k. Returns
    (values f32[k], ids int64[k], count = #docs matched by either
    modality). One row of ``rrf_fuse_topk_batch``."""
    v, i, count = rrf_fuse_topk_batch(ft_scores[None], vec_scores[None], k,
                                      cand)
    return v[0], i[0], count[0]
