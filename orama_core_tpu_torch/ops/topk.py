"""Top-k selection over dense score arrays.

Port of ``orama_core_tpu/ops/topk.py`` (the reference's bounded min-heap,
`capped_heap.rs`, as a device top-k). ``lax.top_k`` breaks ties toward the
lower index; ``torch.topk`` promises no order among ties, so every final
top-k of the port goes through ``topk_stable``, which keeps the
``lax.top_k`` rule."""

from __future__ import annotations

import torch


def topk_stable(scores: torch.Tensor, k: int):
    """(values, indices int64) of the k largest entries along the last dim,
    sorted descending, ties toward the lower index (``lax.top_k``'s rule).

    One ``torch.topk`` finds the k-th value t; the winners are every entry
    above t plus the lowest-indexed entries equal to t (picked by a second
    topk on an integer key), then one stable sort of those k orders them.
    Linear in n, like ``torch.topk``, and free of host syncs."""
    n = scores.shape[-1]
    k = min(k, n)
    if k <= 0:
        empty = scores[..., :0]
        return empty, torch.zeros(empty.shape, dtype=torch.int64,
                                  device=scores.device)
    if k == n:
        vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        return vals, idx
    kth = torch.topk(scores, k, dim=-1, sorted=True).values[..., -1:]
    above = scores > kth
    tied = scores == kth
    room = k - above.sum(dim=-1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied.to(torch.int32), dim=-1) <= room))
    # exactly k winners per row: a key that is positive only for winners
    # and larger for lower indices picks them without a host sync
    rank = n - torch.arange(n, device=scores.device)
    idx = torch.topk(take.to(torch.int64) * rank, k, dim=-1).indices
    vals = torch.gather(scores, -1, idx)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, torch.gather(idx, -1, order)


def topk(scores: torch.Tensor, k: int):
    """(values f32[k], indices int32[k]) sorted descending.

    Entries with score <= 0 are unmatched; callers trim them host-side."""
    vals, idx = topk_stable(scores, k)
    return vals, idx.to(torch.int32)


def topk_with_count(scores: torch.Tensor, k: int):
    vals, idx = topk_stable(scores, k)
    count = torch.sum(scores > 0).to(torch.int32)
    return vals, idx.to(torch.int32), count
