"""Facet counting as masked reductions.

Port of ``orama_core_tpu/ops/facets.py`` (the reference's per-bucket facet
filters, `collection.rs:1004-1126`): each bucket count is
``sum(bucket_mask * matched_mask)``. Counts are summed as integers, which
equals the reference's f32 sum of 0/1 values below 2^24 docs."""

from __future__ import annotations

import torch


def matched_mask(scores: torch.Tensor) -> torch.Tensor:
    return (scores > 0).to(torch.float32)


def number_facet_counts(num_vals, num_docs, num_valid, lows, highs, matched,
                        n_docs: int) -> torch.Tensor:
    """int32[R]: docs matched per [low, high] bucket (inclusive bounds)."""
    in_range = (
        (num_vals[None, :] >= lows[:, None])
        & (num_vals[None, :] <= highs[:, None])
        & num_valid[None, :]
    ).to(torch.float32)                                   # [R, V]
    r = in_range.shape[0]
    mask = torch.zeros(r, n_docs, dtype=torch.float32, device=in_range.device)
    mask.scatter_reduce_(
        1, num_docs.long()[None, :].expand(r, -1), in_range, "amax",
        include_self=True,
    )
    return ((mask > 0) & (matched[None, :] > 0)).sum(dim=1).to(torch.int32)


def number_facet_counts_dense(vals_by_doc, lows, highs, matched):
    """int32[R]: number_facet_counts for a single-valued column, read from
    its doc-major plane (NaN = no value, every compare False) — the
    elementwise form of the same count, with no [R, V] -> [R, n_docs]
    scatter."""
    in_range = (
        (vals_by_doc[None, :] >= lows[:, None])
        & (vals_by_doc[None, :] <= highs[:, None])
        & (matched[None, :] > 0)
    )
    return in_range.sum(dim=1).to(torch.int32)


def keyword_facet_counts(ids, docs, valid, matched, n_values: int):
    """int32[n_values]: matched docs per distinct keyword value."""
    contrib = matched[docs.long()] * valid.to(torch.float32)
    # padding entries (id -1, valid False) carry zero: park them on 0
    seg = torch.where(valid, ids.long(), torch.zeros_like(ids, dtype=torch.long))
    out = torch.zeros(n_values, dtype=torch.float32, device=ids.device)
    return out.index_add_(0, seg, contrib).to(torch.int32)


def bool_facet_counts(true_mask, has_mask, matched) -> torch.Tensor:
    """int32[2]: (count_true, count_false) among matched docs."""
    t = torch.sum(true_mask * matched)
    f = torch.sum((has_mask - true_mask) * matched)
    return torch.stack([t, f]).to(torch.int32)
