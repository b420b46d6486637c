"""Numeric field index: sorted value/doc arrays + device range masks.

Replaces the reference's paged ``OrderedKeyIndex`` B-tree-ish range scans
(`indexes/ordered_key.rs`, `committed/number.rs:39-71`): on TPU a range
filter is a vectorized compare over the whole value column (bandwidth-bound,
static shape) scattered into a dense doc mask — no pages, no binary search
on device (ops/filters.py).

Port of ``orama_core_tpu/index/number_index.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..types import NumberFilter


class UncommittedNumberIndex:
    def __init__(self) -> None:
        self.pairs: List[Tuple[float, int]] = []  # (value, doc)

    @property
    def is_empty(self) -> bool:
        return not self.pairs

    def insert(self, doc_id: int, value: float) -> None:
        self.pairs.append((float(value), doc_id))

    def filter_docs(self, f: NumberFilter) -> Set[int]:
        out: Set[int] = set()
        for v, d in self.pairs:
            if _match(f, v):
                out.add(d)
        return out


def _match(f: NumberFilter, v: float) -> bool:
    if f.op == "eq":
        return v == f.value
    if f.op == "gt":
        return v > f.value
    if f.op == "gte":
        return v >= f.value
    if f.op == "lt":
        return v < f.value
    if f.op == "lte":
        return v <= f.value
    lo, hi = f.value  # between (inclusive, reference NumberFilter::Between)
    return lo <= v <= hi


@dataclasses.dataclass
class CommittedNumberIndex:
    vals: np.ndarray  # float32[V] sorted ascending
    docs: np.ndarray  # int32[V]

    @staticmethod
    def empty() -> "CommittedNumberIndex":
        return CommittedNumberIndex(
            vals=np.zeros(0, dtype=np.float32), docs=np.zeros(0, dtype=np.int32)
        )

    @property
    def is_empty(self) -> bool:
        return len(self.vals) == 0

    def merge(
        self, uncommitted: UncommittedNumberIndex, deleted: Optional[Set[int]] = None
    ) -> "CommittedNumberIndex":
        deleted = deleted or set()
        # committed pairs stay as arrays (per-pair Python boxing here made
        # every commit pay O(total pairs)); only the window runs in Python
        if deleted and len(self.docs):
            keep = ~np.isin(
                self.docs, np.fromiter(deleted, np.int32, len(deleted))
            )
            c_vals, c_docs = self.vals[keep], self.docs[keep]
        else:
            c_vals, c_docs = self.vals, self.docs
        u_vals: List[float] = []
        u_docs: List[int] = []
        for v, d in uncommitted.pairs:
            if d not in deleted:
                u_vals.append(v)
                u_docs.append(d)
        v_arr = np.concatenate([c_vals, np.asarray(u_vals, np.float32)])
        d_arr = np.concatenate([c_docs, np.asarray(u_docs, np.int32)])
        # stable sort keeps committed-before-window order within a value
        order = np.argsort(v_arr, kind="stable")
        return CommittedNumberIndex(vals=v_arr[order], docs=d_arr[order])

    def filter_bounds(self, f: NumberFilter) -> Tuple[float, float, bool, bool]:
        """Normalize a filter into [low, high] with exclusivity flags for
        the device range-mask kernel."""
        inf = float("inf")
        if f.op == "eq":
            return float(f.value), float(f.value), False, False
        if f.op == "gt":
            return float(f.value), inf, True, False
        if f.op == "gte":
            return float(f.value), inf, False, False
        if f.op == "lt":
            return -inf, float(f.value), False, True
        if f.op == "lte":
            return -inf, float(f.value), False, False
        lo, hi = f.value
        return float(lo), float(hi), False, False

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"vals": self.vals, "docs": self.docs}

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray]) -> "CommittedNumberIndex":
        return CommittedNumberIndex(
            vals=arrays["vals"].astype(np.float32), docs=arrays["docs"].astype(np.int32)
        )
