"""Full-text (BM25) field index: uncommitted host buffers + committed CSR.

Mirrors the committed/uncommitted split of the reference
(`uncommitted/string.rs`, `committed/string.rs`) with a TPU-native layout:

- **Uncommitted**: plain host dicts (term -> doc -> positions) — the
  freshness window between commits (the reference's radix trie). Searched on
  host (windows are small by construction); folded into CSR at commit.
- **Committed**: immutable CSR arrays over a sorted term dictionary —
  term id ranges from prefix search are contiguous, so each query token maps
  to ONE flat posting span scored by the device kernel (ops/bm25.py).

Both segments share GlobalInfo (total docs-with-field, total length) so BM25
accumulates identically to the reference (`collection.rs:930-951`).

Deviations from the reference (deliberate, documented):
- doc "field length" is the token count and total length accumulates once
  per document (the reference stores max position as the length,
  uncommitted/string.rs:87-93, and adds the length once per *term*,
  :103 — both upstream quirks).
- committed phrase adjacency counts `second - first == 1` (the reference's
  `< 1` window can never fire on deduped sorted positions).

Port of ``orama_core_tpu/index/string_index.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils import bucket_pad, flatten_ranges
from .term_dict import TermDict


@dataclasses.dataclass
class GlobalInfo:
    total_documents: int = 0
    total_document_length: int = 0

    def __add__(self, other: "GlobalInfo") -> "GlobalInfo":
        return GlobalInfo(
            self.total_documents + other.total_documents,
            self.total_document_length + other.total_document_length,
        )

    @property
    def avgdl(self) -> float:
        if self.total_documents == 0:
            return 1.0
        return self.total_document_length / self.total_documents


K1 = 1.2
B = 0.75


class UncommittedStringIndex:
    """Host-side freshness window for one text field."""

    def __init__(self) -> None:
        # term -> doc_id -> positions (list, append order)
        self.terms: Dict[str, Dict[int, List[int]]] = {}
        self.doc_lens: Dict[int, int] = {}
        self.total_len = 0
        self._sorted_terms: Optional[List[str]] = None
        # searches are lock-free at the engine level, so the WINDOW (the
        # only mutable structure they touch) serializes its own readers
        # vs insert — iterating self.terms while insert() adds keys
        # raises RuntimeError mid-query otherwise (reproduced)
        self._lk = threading.Lock()

    def __len__(self) -> int:
        return len(self.doc_lens)

    @property
    def is_empty(self) -> bool:
        return not self.doc_lens

    def global_info(self) -> GlobalInfo:
        return GlobalInfo(len(self.doc_lens), self.total_len)

    def insert(self, doc_id: int, field_length: int, terms: Dict[str, Sequence[int]]) -> None:
        with self._lk:
            if doc_id not in self.doc_lens:
                self.doc_lens[doc_id] = field_length
                self.total_len += field_length
            new_term = False
            for term, positions in terms.items():
                bucket = self.terms.get(term)
                if bucket is None:
                    bucket = self.terms[term] = {}
                    new_term = True
                bucket.setdefault(doc_id, []).extend(positions)
            if new_term:
                self._sorted_terms = None

    def _sorted(self) -> List[str]:
        if self._sorted_terms is None:
            self._sorted_terms = sorted(self.terms)
        return self._sorted_terms

    def prefix_terms(self, prefix: str) -> List[str]:
        import bisect

        st = self._sorted()
        lo = bisect.bisect_left(st, prefix)
        hi = bisect.bisect_left(st, prefix + "\U0010ffff")
        return st[lo:hi]

    def search(
        self,
        tokens: Sequence[str],
        boost: float,
        global_info: GlobalInfo,
        filter_mask: Optional[np.ndarray],
        deleted: Optional[Set[int]],
        out: Dict[int, float],
        exact_tokens: Sequence[str] = (),
    ) -> None:
        """BM25 host scoring, accumulated into ``out`` (doc -> score).

        Matches uncommitted/string.rs:124-193: prefix-expanded term match,
        ni from this segment only, avgdl/N from the shared global info, no
        phrase boost in the uncommitted window. ``exact_tokens`` are the
        query's STEMS, matched exactly (not prefix-expanded) against the
        stem entries the write side indexed — the query-side stem
        expansion the engine adds over the reference (see
        collection_read.query_expansion)."""
        if not self.terms:
            return
        with self._lk:
            self._search_locked(
                tokens, boost, global_info, filter_mask, deleted, out,
                exact_tokens,
            )

    def _search_locked(
        self, tokens, boost, global_info, filter_mask, deleted, out,
        exact_tokens,
    ) -> None:
        avgdl = max(global_info.avgdl, 1e-9)
        n = float(global_info.total_documents)

        def score_term(term: str) -> None:
            postings = self.terms[term]
            ni = len(postings)
            idf = float(np.log1p((n - ni + 0.5) / (ni + 0.5)))
            for doc_id, positions in postings.items():
                if deleted and doc_id in deleted:
                    continue
                if filter_mask is not None and filter_mask[doc_id] == 0:
                    continue
                dl = self.doc_lens.get(doc_id)
                if dl is None:
                    continue
                tf = float(len(positions))
                denom = tf + K1 * (1.0 - B + B * dl / avgdl)
                out[doc_id] = out.get(doc_id, 0.0) + boost * idf * tf * (K1 + 1.0) / denom

        for token in tokens:
            for term in self.prefix_terms(token):
                score_term(term)
        for token in exact_tokens:
            # skip stems a surface prefix already expanded to (a stem is
            # never longer than its token, so coverage means equality)
            if token in self.terms and not any(
                token.startswith(t) for t in tokens
            ):
                score_term(token)

    def iter_sorted(self) -> Iterable[Tuple[str, Dict[int, List[int]]]]:
        for term in self._sorted():
            yield term, self.terms[term]


@dataclasses.dataclass
class CommittedStringIndex:
    """Immutable CSR generation for one text field (host-authoritative copy;
    device arrays are created/cached by the engine's DeviceIndexCache).

    Layout (SURVEY.md §7): postings of term ``t`` occupy
    ``[term_starts[t], term_starts[t+1])`` in the flat posting arrays; the
    positions of posting ``p`` occupy ``[pos_starts[p], pos_starts[p+1])``.
    Terms are sorted, so a prefix's postings form one contiguous span.
    """

    term_dict: TermDict
    term_starts: np.ndarray   # int64[T+1]
    post_docs: np.ndarray     # int32[P]
    post_tf: np.ndarray       # float32[P]
    pos_starts: np.ndarray    # int64[P+1]
    positions: np.ndarray     # int32[PP]
    doc_lens_dense: np.ndarray  # float32[cap] (0 => doc lacks field)
    n_docs_with_field: int
    total_len: int
    # Cross-slice global-statistics override (multi-slice DFS mode,
    # parallel/multislice.sync_global_stats): per-term GLOBAL doc
    # frequency aligned with term_dict, plus global (n_docs, total_len).
    # None => slice-local stats (ES-style query-then-fetch). Set via
    # set_stats_override; not persisted — re-synced after commits.
    df_override: Optional[np.ndarray] = None
    n_override: Optional[Tuple[int, int]] = None

    @staticmethod
    def empty(capacity: int = 0) -> "CommittedStringIndex":
        return CommittedStringIndex(
            term_dict=TermDict([]),
            term_starts=np.zeros(1, dtype=np.int64),
            post_docs=np.zeros(0, dtype=np.int32),
            post_tf=np.zeros(0, dtype=np.float32),
            pos_starts=np.zeros(1, dtype=np.int64),
            positions=np.zeros(0, dtype=np.int32),
            doc_lens_dense=np.zeros(capacity, dtype=np.float32),
            n_docs_with_field=0,
            total_len=0,
        )

    @property
    def n_terms(self) -> int:
        return len(self.term_dict)

    @property
    def n_postings(self) -> int:
        return len(self.post_docs)

    def global_info(self) -> GlobalInfo:
        if self.n_override is not None:
            return GlobalInfo(*self.n_override)
        return GlobalInfo(self.n_docs_with_field, self.total_len)

    def term_df(self) -> np.ndarray:
        """Per-term doc frequency used for idf: the global override when
        synced, else the slice-local CSR span widths."""
        if self.df_override is not None:
            return self.df_override
        return np.diff(self.term_starts).astype(np.float32)

    def set_stats_override(
        self,
        df_by_term: Dict[str, float],
        n_docs: int,
        total_len: int,
    ) -> None:
        """Install merged cross-slice statistics (terms absent from the
        mapping keep their local df)."""
        df = np.diff(self.term_starts).astype(np.float32)
        for i, t in enumerate(self.term_dict.terms):
            g = df_by_term.get(t)
            if g is not None:
                df[i] = g
        self.df_override = df
        self.n_override = (int(n_docs), int(total_len))

    # -- merge (commit path) --------------------------------------------------

    def merge(
        self,
        uncommitted: UncommittedStringIndex,
        capacity: int,
        deleted: Optional[Set[int]] = None,
    ) -> "CommittedStringIndex":
        """Fold the uncommitted window (minus deletions) into a new immutable
        generation — the reference's MergedIterator commit
        (committed/string.rs:91-189) as a sorted-dict merge + array repack."""
        deleted = deleted or set()

        # (A native C++ bulk-load path existed here; it was measured SLOWER
        # than this merge's flat array pass — 1.7M per-posting ctypes calls
        # at ~30us each vs one batched Python pass — and was removed. The
        # builder bindings remain for the parity test.)

        # 1. merged term dictionary
        new_dict, remap_a_l, remap_b_l = TermDict.merge(
            self.term_dict, uncommitted.terms.keys()
        )
        t_new = len(new_dict)
        remap_a = np.asarray(remap_a_l, dtype=np.int64)
        remap_b = np.asarray(remap_b_l, dtype=np.int64)

        # 2. committed source. With deletions, compact once (boolean-mask
        # copies + one ragged position gather); otherwise the committed
        # arrays are used as-is. Either way the committed stream KEEPS ITS
        # ORDER in the merged output, so the merge is a BLOCK INSERT of the
        # window into the committed stream — a handful of O(P) mask-copy
        # passes, no per-posting index arrays, no per-term Python. (The array
        # analog of the reference's streaming MergedIterator merge,
        # committed/string.rs:91-189.)
        p_old = len(self.post_docs)
        t_old = len(self.term_starts) - 1
        c_docs, c_tf = self.post_docs, self.post_tf
        c_plen = np.diff(self.pos_starts)
        c_positions = self.positions
        c_term_counts = np.diff(self.term_starts)
        if deleted and p_old:
            del_arr = np.zeros(capacity, dtype=bool)
            del_arr[list(deleted)] = True
            keep = ~del_arr[self.post_docs]
            if not keep.all():
                c_docs = self.post_docs[keep]
                c_tf = self.post_tf[keep]
                kept_plen = c_plen[keep]
                c_positions = self.positions[
                    flatten_ranges(self.pos_starts[:-1][keep], kept_plen)
                ]
                c_plen = kept_plen
                kept_cum = np.zeros(p_old + 1, dtype=np.int64)
                np.cumsum(keep, out=kept_cum[1:])
                c_term_counts = (
                    kept_cum[self.term_starts[1:]]
                    - kept_cum[self.term_starts[:-1]]
                )
        p_c = len(c_docs)

        # 3. uncommitted source, term-sorted — one flat pass over the
        # window's (term, doc) pairs (window-sized Python only)
        unc_terms_sorted = sorted(uncommitted.terms)
        u_nid_l: List[int] = []
        u_tcount_l: List[int] = []
        # per-term output chunks, in term order. Small buckets accumulate in
        # flat Python lists (numpy per-call overhead would dominate a
        # long-tail vocabulary); buckets >= _VEC_BUCKET go through a fully
        # vectorized lexsort path (a 250k-doc window put 8M+ per-posting
        # sorted()/append calls on the commit path).
        _VEC_BUCKET = 512
        docs_chunks: List[np.ndarray] = []
        plen_chunks: List[np.ndarray] = []
        pos_chunks: List[np.ndarray] = []
        sm_docs: List[int] = []
        sm_plen: List[int] = []
        sm_pos: List[int] = []
        deleted_arr = (
            np.fromiter(deleted, np.int64, len(deleted)) if deleted else None
        )

        def _flush_small() -> None:
            if sm_docs:
                docs_chunks.append(np.asarray(sm_docs, dtype=np.int32))
                plen_chunks.append(np.asarray(sm_plen, dtype=np.int64))
                pos_chunks.append(np.asarray(sm_pos, dtype=np.int32))
                sm_docs.clear(); sm_plen.clear(); sm_pos.clear()

        for term, nid in zip(unc_terms_sorted, remap_b_l):
            bucket = uncommitted.terms[term]
            n = len(bucket)
            if n >= _VEC_BUCKET:
                keys = np.fromiter(bucket.keys(), np.int64, n)
                lens = np.fromiter(map(len, bucket.values()), np.int64, n)
                pos = np.fromiter(
                    itertools.chain.from_iterable(bucket.values()),
                    np.int32, int(lens.sum()),
                )
                # global order contract: docs ascending within the term,
                # positions ascending within the doc
                order = np.argsort(keys, kind="stable")
                keys_s, lens_s = keys[order], lens[order]
                doc_rep = np.repeat(keys, lens)
                pos = pos[np.lexsort((pos, doc_rep))]
                if deleted_arr is not None:
                    keep = ~np.isin(keys_s, deleted_arr)
                    if not keep.all():
                        pos = pos[np.repeat(keep, lens_s)]
                        keys_s, lens_s = keys_s[keep], lens_s[keep]
                if not len(keys_s):
                    continue
                _flush_small()
                docs_chunks.append(keys_s.astype(np.int32))
                plen_chunks.append(lens_s)
                pos_chunks.append(pos)
                u_nid_l.append(nid)
                u_tcount_l.append(len(keys_s))
            else:
                # C-level sorted/extend/map per term; position lists are
                # appended in scan order so the per-doc sort is a Timsort
                # near-no-op
                ds = sorted(bucket)
                if deleted:
                    ds = [d for d in ds if d not in deleted]
                if not ds:
                    continue
                plists = [sorted(bucket[d]) for d in ds]
                sm_docs.extend(ds)
                sm_plen.extend(map(len, plists))
                sm_pos.extend(itertools.chain.from_iterable(plists))
                u_nid_l.append(nid)
                u_tcount_l.append(len(ds))
        _flush_small()
        u_docs = (
            np.concatenate(docs_chunks) if docs_chunks
            else np.zeros(0, dtype=np.int32)
        )
        u_plen = (
            np.concatenate(plen_chunks) if plen_chunks
            else np.zeros(0, dtype=np.int64)
        )
        u_tf = u_plen.astype(np.float32)  # tf == positions per (term, doc)
        u_positions = (
            np.concatenate(pos_chunks) if pos_chunks
            else np.zeros(0, dtype=np.int32)
        )
        u_nid = np.asarray(u_nid_l, dtype=np.int64)
        u_tcounts = np.asarray(u_tcount_l, dtype=np.int64)
        p_u = len(u_docs)

        # 4. block insert: per new term, committed block then window block
        counts_c_new = np.zeros(t_new, dtype=np.int64)
        if t_old:
            counts_c_new[remap_a] = c_term_counts
        counts_u_new = np.zeros(t_new, dtype=np.int64)
        if len(u_nid):
            counts_u_new[u_nid] = u_tcounts
        term_counts = counts_c_new + counts_u_new
        term_starts = np.zeros(t_new + 1, dtype=np.int64)
        np.cumsum(term_counts, out=term_starts[1:])
        p_new = p_c + p_u

        # destination slots of the window postings (O(window) ints): term n's
        # window block starts after its committed block
        if p_u:
            u_rank = np.arange(p_u, dtype=np.int64) - np.repeat(
                np.cumsum(u_tcounts) - u_tcounts, u_tcounts
            )
            u_term = np.repeat(u_nid, u_tcounts)
            dest_u = term_starts[u_term] + counts_c_new[u_term] + u_rank
        else:
            dest_u = np.zeros(0, dtype=np.int64)

        c_mask = np.ones(p_new, dtype=bool)
        c_mask[dest_u] = False

        def insert_blocks(c_arr, u_arr, dtype):
            out = np.empty(p_new, dtype=dtype)
            out[c_mask] = c_arr
            out[dest_u] = u_arr
            return out

        post_docs = insert_blocks(c_docs, u_docs, np.int32)
        post_tf = insert_blocks(c_tf, u_tf, np.float32)
        pos_lens = insert_blocks(c_plen, u_plen, np.int64)

        pos_starts = np.zeros(p_new + 1, dtype=np.int64)
        np.cumsum(pos_lens, out=pos_starts[1:])
        # positions stream: committed runs keep their relative order, so the
        # complement of the window runs' destination slots (from the NEW
        # pos_starts) enumerates them in order — two mask copies, no gathers
        pp_new = len(c_positions) + len(u_positions)
        if pp_new:
            positions = np.empty(pp_new, dtype=np.int32)
            if p_u:
                u_pos_dest = flatten_ranges(pos_starts[dest_u], u_plen)
                p_mask = np.ones(pp_new, dtype=bool)
                p_mask[u_pos_dest] = False
                positions[p_mask] = c_positions
                positions[u_pos_dest] = u_positions
            else:
                positions[:] = c_positions
        else:
            positions = np.zeros(0, dtype=np.int32)

        # dense doc lens over the (possibly grown) capacity
        doc_lens = np.zeros(capacity, dtype=np.float32)
        ncap = min(len(self.doc_lens_dense), capacity)
        doc_lens[:ncap] = self.doc_lens_dense[:ncap]
        for doc_id, dl in uncommitted.doc_lens.items():
            doc_lens[doc_id] = dl
        if deleted:
            doc_lens[list(deleted)] = 0.0

        n_docs = int(np.count_nonzero(doc_lens))
        total_len = int(doc_lens.sum())

        # prune empty terms to keep the dictionary tight
        keep_terms = term_counts > 0
        if not keep_terms.all():
            kept_ids = np.nonzero(keep_terms)[0]
            new_terms = [new_dict.terms[i] for i in kept_ids]
            new_starts = np.zeros(len(kept_ids) + 1, dtype=np.int64)
            np.cumsum(term_counts[kept_ids], out=new_starts[1:])
            # postings are already laid out in term order; removing empty
            # terms does not move any posting data
            td = TermDict.__new__(TermDict)
            td.terms = new_terms
            new_dict = td
            term_starts = new_starts

        return CommittedStringIndex(
            term_dict=new_dict,
            term_starts=term_starts,
            post_docs=post_docs,
            post_tf=post_tf,
            pos_starts=pos_starts,
            positions=positions,
            doc_lens_dense=doc_lens,
            n_docs_with_field=n_docs,
            total_len=total_len,
        )

    # -- persistence ----------------------------------------------------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "terms": np.asarray(self.term_dict.terms, dtype=np.str_),
            "term_starts": self.term_starts,
            "post_docs": self.post_docs,
            "post_tf": self.post_tf,
            "pos_starts": self.pos_starts,
            "positions": self.positions,
            "doc_lens_dense": self.doc_lens_dense,
            "scalars": np.asarray([self.n_docs_with_field, self.total_len], dtype=np.int64),
        }

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray]) -> "CommittedStringIndex":
        td = TermDict.__new__(TermDict)
        td.terms = [str(t) for t in arrays["terms"]]
        return CommittedStringIndex(
            term_dict=td,
            term_starts=arrays["term_starts"].astype(np.int64),
            post_docs=arrays["post_docs"].astype(np.int32),
            post_tf=arrays["post_tf"].astype(np.float32),
            pos_starts=arrays["pos_starts"].astype(np.int64),
            positions=arrays["positions"].astype(np.int32),
            doc_lens_dense=arrays["doc_lens_dense"].astype(np.float32),
            n_docs_with_field=int(arrays["scalars"][0]),
            total_len=int(arrays["scalars"][1]),
        )
