"""Sorted term dictionary with prefix-range lookup.

Replaces the reference's FST map (`indexes/fst.rs:24-126`): terms are kept
lexicographically sorted, so

- a term's id is its sorted position (binary search), and
- a *prefix* search (the reference's ``starts_with`` automaton,
  fst.rs:63-74) resolves to a *contiguous id range* ``[lo, hi)``.

Contiguity is the point: postings of all prefix-matched terms form one
contiguous CSR span on device, so query resolution is O(log T) host work and
the device scores a single flat gather span (SURVEY.md §7 translation table).

Port of ``orama_core_tpu/index/term_dict.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence, Tuple


class TermDict:
    __slots__ = ("terms",)

    def __init__(self, sorted_terms: Optional[Sequence[str]] = None) -> None:
        self.terms: List[str] = list(sorted_terms or [])
        if self.terms != sorted(self.terms):
            raise ValueError("TermDict requires sorted terms")

    def __len__(self) -> int:
        return len(self.terms)

    def term_id(self, term: str) -> Optional[int]:
        i = bisect.bisect_left(self.terms, term)
        if i < len(self.terms) and self.terms[i] == term:
            return i
        return None

    def prefix_range(self, prefix: str) -> Tuple[int, int]:
        """[lo, hi) of term ids whose term starts with ``prefix``."""
        lo = bisect.bisect_left(self.terms, prefix)
        # the smallest string that is > every string with this prefix
        hi = bisect.bisect_left(self.terms, prefix + "\U0010ffff")
        return lo, hi

    @staticmethod
    def merge(a: "TermDict", b_terms: Iterable[str]) -> Tuple["TermDict", List[int], List[int]]:
        """Merge sorted ``a`` with arbitrary ``b_terms``.

        Returns (merged, remap_a, remap_b_sorted_terms) where ``remap_a[i]``
        is the new id of ``a``'s term i, and the third element maps each of
        sorted(set(b_terms)) to its new id. (Two-way sorted merge — the
        reference's MergedIterator, merger.rs:3-89.)
        """
        b_sorted = sorted(set(b_terms))
        merged: List[str] = []
        remap_a: List[int] = []
        remap_b: List[int] = []
        i = j = 0
        ta, tb = a.terms, b_sorted
        while i < len(ta) or j < len(tb):
            if j >= len(tb) or (i < len(ta) and ta[i] < tb[j]):
                remap_a.append(len(merged))
                merged.append(ta[i])
                i += 1
            elif i >= len(ta) or tb[j] < ta[i]:
                remap_b.append(len(merged))
                merged.append(tb[j])
                j += 1
            else:  # equal
                remap_a.append(len(merged))
                remap_b.append(len(merged))
                merged.append(ta[i])
                i += 1
                j += 1
        out = TermDict.__new__(TermDict)
        out.terms = merged
        return out, remap_a, remap_b
