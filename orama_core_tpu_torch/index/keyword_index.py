"""Keyword (exact string) field index: interned value ids over the
number-index machinery.

String-equality filters and term facets are on the reference's roadmap
but unimplemented there (dto.rs filters are number/bool only); here they
are first-class. TPU-native design: exact values are interned to dense
int ids (stable across commits), and the committed structure is the same
sorted (value_id, doc) column pair the number index uses — so the device
kernels (eq-mask segment-max, facet segment-sum) are shared, static-shape,
and bandwidth-bound. ES-style `ignore_above` guards the intern table from
unbounded free-text values.

Port of ``orama_core_tpu/index/keyword_index.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..types import StringFilter

IGNORE_ABOVE = 256  # values longer than this are not keyword-indexed

# Value ids ride float32 device columns (eq/in masks, facet segment-sums);
# ids past 2^24 are no longer exactly representable and would silently
# collide adjacent values — reject at intern time instead.
MAX_INTERNED = 1 << 24


class UncommittedKeywordIndex:
    def __init__(self) -> None:
        self.pairs: List[Tuple[str, int]] = []  # (value, doc)

    @property
    def is_empty(self) -> bool:
        return not self.pairs

    def insert(self, doc_id: int, values: Sequence[str]) -> None:
        seen = set()
        for v in values:
            v = str(v)
            if not v or len(v) > IGNORE_ABOVE or v in seen:
                continue
            seen.add(v)
            self.pairs.append((v, doc_id))

    def filter_docs(self, f: StringFilter) -> Set[int]:
        wanted = {f.value} if f.op == "eq" else set(f.value)
        return {d for v, d in self.pairs if v in wanted}

    def facet_counts(self, matched_host: np.ndarray) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v, d in self.pairs:
            if d < len(matched_host) and matched_host[d] > 0:
                out[v] = out.get(v, 0) + 1
        return out


@dataclasses.dataclass
class CommittedKeywordIndex:
    values: List[str]          # id -> value; ids are stable across commits
    ids: np.ndarray            # float32[V] value ids, sorted ascending
    docs: np.ndarray           # int32[V] owning docs, aligned with ids

    def __post_init__(self) -> None:
        self.value_ids: Dict[str, int] = {v: i for i, v in enumerate(self.values)}

    @staticmethod
    def empty() -> "CommittedKeywordIndex":
        return CommittedKeywordIndex(
            values=[], ids=np.zeros(0, np.float32), docs=np.zeros(0, np.int32)
        )

    @property
    def is_empty(self) -> bool:
        return len(self.ids) == 0

    @property
    def n_values(self) -> int:
        return len(self.values)

    def id_of(self, value: str) -> Optional[int]:
        return self.value_ids.get(value)

    def merge(
        self, uncommitted: UncommittedKeywordIndex, deleted: Optional[Set[int]] = None
    ) -> "CommittedKeywordIndex":
        deleted = deleted or set()
        values = list(self.values)
        value_ids = dict(self.value_ids)
        keep = ~np.isin(self.docs, np.fromiter(deleted, np.int32, len(deleted))) \
            if deleted and len(self.docs) else np.ones(len(self.docs), bool)
        # committed pairs stay as arrays (a list round trip here made every
        # commit pay O(total pairs) of Python boxing); only the window's
        # pairs run through Python, for interning
        u_ids: List[int] = []
        u_docs: List[int] = []
        for v, d in uncommitted.pairs:
            if d in deleted:
                continue
            vid = value_ids.get(v)
            if vid is None:
                vid = len(values)
                if vid >= MAX_INTERNED:
                    raise ValueError(
                        f"keyword field exceeds {MAX_INTERNED} distinct values; "
                        "ids would lose float32 exactness on device — use a "
                        "number field or raise IGNORE_ABOVE-style bounds"
                    )
                value_ids[v] = vid
                values.append(v)
            u_ids.append(vid)
            u_docs.append(d)
        i_arr = np.concatenate([self.ids[keep], np.asarray(u_ids, np.float32)])
        d_arr = np.concatenate([self.docs[keep], np.asarray(u_docs, np.int32)])
        # stable sort keeps committed-before-window order within a value id
        order = np.argsort(i_arr, kind="stable")
        return CommittedKeywordIndex(values=values, ids=i_arr[order], docs=d_arr[order])

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "ids": self.ids,
            "docs": self.docs,
            "values": np.asarray(self.values, dtype=np.str_),
        }

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray]) -> "CommittedKeywordIndex":
        return CommittedKeywordIndex(
            values=[str(v) for v in arrays["values"]],
            ids=arrays["ids"].astype(np.float32),
            docs=arrays["docs"].astype(np.int32),
        )
