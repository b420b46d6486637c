"""Boolean field index: dense membership bitmaps.

Replaces the reference's true/false doc-id lists
(`committed/bool.rs:55-68`): the committed form IS the mask the scoring
kernels consume — a float {0,1} vector over the padded doc space.

Port of ``orama_core_tpu/index/bool_index.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Set, Tuple

import numpy as np


class UncommittedBoolIndex:
    def __init__(self) -> None:
        self.true_docs: Set[int] = set()
        self.false_docs: Set[int] = set()
        # sets raise on mutation during iteration, and searches read the
        # window lock-free — serialize insert vs the read accessors
        # (lists in the other windows are append-safe under the GIL)
        self._lk = threading.Lock()

    @property
    def is_empty(self) -> bool:
        return not self.true_docs and not self.false_docs

    def insert(self, doc_id: int, value: bool) -> None:
        with self._lk:
            (self.true_docs if value else self.false_docs).add(doc_id)

    def filter_docs(self, value: bool) -> Set[int]:
        with self._lk:
            return set(self.true_docs if value else self.false_docs)

    def true_false_counts(self, matched_host) -> Tuple[int, int]:
        """Matched-doc counts per polarity (bool facets), read atomically."""
        with self._lk:
            t = sum(
                1 for d in self.true_docs
                if d < len(matched_host) and matched_host[d] > 0
            )
            f = sum(
                1 for d in self.false_docs
                if d < len(matched_host) and matched_host[d] > 0
            )
        return t, f


@dataclasses.dataclass
class CommittedBoolIndex:
    true_mask: np.ndarray  # float32[cap] 1.0 where field == true
    has_mask: np.ndarray   # float32[cap] 1.0 where doc has the field

    @staticmethod
    def empty(capacity: int = 0) -> "CommittedBoolIndex":
        return CommittedBoolIndex(
            true_mask=np.zeros(capacity, dtype=np.float32),
            has_mask=np.zeros(capacity, dtype=np.float32),
        )

    @property
    def is_empty(self) -> bool:
        return not self.has_mask.any()

    def merge(
        self,
        uncommitted: UncommittedBoolIndex,
        capacity: int,
        deleted: Optional[Set[int]] = None,
    ) -> "CommittedBoolIndex":
        deleted = deleted or set()
        true_mask = np.zeros(capacity, dtype=np.float32)
        has_mask = np.zeros(capacity, dtype=np.float32)
        ncap = min(len(self.true_mask), capacity)
        true_mask[:ncap] = self.true_mask[:ncap]
        has_mask[:ncap] = self.has_mask[:ncap]
        for d in uncommitted.true_docs:
            true_mask[d] = 1.0
            has_mask[d] = 1.0
        for d in uncommitted.false_docs:
            true_mask[d] = 0.0
            has_mask[d] = 1.0
        if deleted:
            idx = list(deleted)
            true_mask[idx] = 0.0
            has_mask[idx] = 0.0
        return CommittedBoolIndex(true_mask=true_mask, has_mask=has_mask)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"true_mask": self.true_mask, "has_mask": self.has_mask}

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray]) -> "CommittedBoolIndex":
        return CommittedBoolIndex(
            true_mask=arrays["true_mask"].astype(np.float32),
            has_mask=arrays["has_mask"].astype(np.float32),
        )
