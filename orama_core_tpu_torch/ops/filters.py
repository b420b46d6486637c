"""Metadata filters as dense device masks.

Port of ``orama_core_tpu/ops/filters.py`` (the reference's filter sets,
`collection.rs:797-869`): a filter is a dense f32 mask over the padded doc
space; masks compose by elementwise multiply. The segment_max scatters of
the reference are ``scatter_reduce(amax)`` onto a zero base, which is the
reference's ``maximum(segment_max(...), 0)``."""

from __future__ import annotations

import torch


def _scatter_max(vals: torch.Tensor, docs: torch.Tensor, n_docs: int):
    out = torch.zeros(n_docs, dtype=torch.float32, device=vals.device)
    return out.scatter_reduce_(0, docs.long(), vals, "amax", include_self=True)


def _pick(cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(cond, a, b)`` for a device bool or a host bool."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def number_range_mask(num_vals, num_docs, num_valid, low, high, low_excl,
                      high_excl, n_docs: int) -> torch.Tensor:
    ge = _pick(low_excl, num_vals > low, num_vals >= low)
    le = _pick(high_excl, num_vals < high, num_vals <= high)
    in_range = (ge & le & num_valid).to(torch.float32)
    return _scatter_max(in_range, num_docs, n_docs)


def number_range_mask_dense(vals_by_doc, low, high, low_excl, high_excl):
    """Doc-major range mask (single value per doc; NaN = no value, every
    compare False)."""
    ge = _pick(low_excl, vals_by_doc > low, vals_by_doc >= low)
    le = _pick(high_excl, vals_by_doc < high, vals_by_doc <= high)
    return (ge & le).to(torch.float32)


def number_eq_mask_dense(vals_by_doc, value) -> torch.Tensor:
    return (vals_by_doc == value).to(torch.float32)


def number_eq_mask(num_vals, num_docs, num_valid, value, n_docs: int):
    eq = ((num_vals == value) & num_valid).to(torch.float32)
    return _scatter_max(eq, num_docs, n_docs)


def value_set_mask(vals, docs, valid, wanted, n_docs: int) -> torch.Tensor:
    """Keyword eq/in filter: docs whose value id is in ``wanted`` (pad -1)."""
    hit = torch.any(vals[None, :] == wanted[:, None], dim=0) & valid
    return _scatter_max(hit.to(torch.float32), docs, n_docs)


def value_set_mask_dense(plane, wanted) -> torch.Tensor:
    """Doc-major keyword eq/in filter; -2 marks valueless docs."""
    return torch.any(plane[:, None] == wanted[None, :], dim=1).to(torch.float32)


def combine_masks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Filter intersection == elementwise multiply of {0,1} masks."""
    return a * b
