"""Read-side collection: op application, search orchestration, commit.

Port of ``orama_core_tpu/engine/collection_read.py`` (the reference's
`CollectionReader`, `sides/read/collection.rs`), single device: per-field
committed/uncommitted indexes, a search pipeline (filters -> mode dispatch
-> facets -> top-k), and commit = merge uncommitted into new immutable
generations, in the reference's on-disk format.

Device tensors live on ``cfg.device`` ("cuda" unless the caller asks for
"cpu") and are cached per immutable committed generation. The reference
takes its kernel branches only on a TPU backend (or when
``_test_force_fast_path`` is set): the aligned BM25 block plan, the
windowed phrase stream and the fused kNN. The port takes them always,
on any device: ``use_pallas``, ``bm25_pallas`` and ``phrase_windowed``
stay in ``GpuConfig`` only so configs load, and gate nothing. Each kernel
wrapper launches its CUDA kernel for CUDA tensors and runs its plain torch
version for CPU tensors, so the CPU tests drive the same orchestration as
the card, and no CUDA tensor is sent around a kernel.

``GpuConfig.vector_index`` "exact" (bf16 rows), "int8" (the capacity
mode: int8 codes and per-row scales, K5) and the ANN indexes "ivf", "pq"
and "ivf_pq" (trained at commit on the reader's device once a field
holds ``ivf_threshold`` rows; ops/ivf.py, ops/pq.py) are served;
multi-vector (chunked) docs of an exact index take the segment-aware
fused kNN (K6).
``search_batch`` serves a micro-batch: unfiltered vector rows through the
fused kNN at the batch's size, other rows through the batched fused
program (one K1 launch over the batch's combined plan, one corpus
product), phrase rows one by one; vector and hybrid rows of an ANN
collection one by one.

``GpuConfig.mesh_shape`` (S, 1) with S >= 2 serves ``search`` through the
mesh branches (reference :2185-2816): per-shard layouts of every committed
structure, and ``parallel/sharded_engine.py``'s programs, which launch K1,
K4, K2 + K3 or K6 once per shard on that shard's device and merge on the
mesh's first device. Flat IVF and flat PQ vector modes, ``search_batch``
and the fused program run there too, with whole arrays, as the reference
runs them as ordinary programs over its data-sharded arrays: the same
results, nothing partitioned.

Searches run without the apply lock, beside writes and commits.
``search`` and ``search_batch`` each pin one view of the reader (``_View``:
the fields, their (uncommitted, committed) containers, the tombstones and
the capacity that covers those generations) and read only it, so every
buffer, mask and kernel row of a search is sized by a capacity its
generations fit in; a commit publishes its new containers in one step.
A window doc past the pinned capacity (it arrived after the search
began) raises ``_CapacityMoved`` and the search starts again on a new
view, as the mesh path does for a doc past its split.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..config import GpuConfig
from ..index import (
    CommittedBoolIndex,
    CommittedKeywordIndex,
    CommittedNumberIndex,
    CommittedStringIndex,
    CommittedVectorIndex,
    UncommittedBoolIndex,
    UncommittedKeywordIndex,
    UncommittedNumberIndex,
    UncommittedStringIndex,
    UncommittedVectorIndex,
)
from ..nlp import get_parser
from ..ops import bm25 as bm25_ops
from ..ops import facets as facet_ops
from ..ops import filters as filter_ops
from ..ops import fusion as fusion_ops
from ..ops import topk as topk_ops
from ..ops import vector as vector_ops
from ..oplog import (
    CreateFieldOp,
    DeleteDocumentsOp,
    IndexBoolOp,
    IndexEmbeddingOp,
    IndexKeywordOp,
    IndexNumberOp,
    IndexStringOp,
    InsertDocumentOp,
)
from ..types import (
    BoolFacetDefinition,
    BoolFilter,
    FacetResult,
    HybridFusion,
    NumberFacetDefinition,
    NumberFilter,
    SearchModeKind,
    SearchParams,
    StringFacetDefinition,
    StringFilter,
    TypedField,
    ValueType,
)
from ..utils import (
    atomic_write_json,
    atomic_write_npz,
    bucket_pad,
    ensure_dir,
    flatten_ranges,
    read_json,
    read_npz,
    tracing,
)


def query_expansion(parser, term: str) -> Tuple[List[str], List[str]]:
    """Query tokens for fulltext resolution: (surface_tokens, stems).
    Surface tokens resolve by prefix and drive phrase semantics; stems
    resolve as exact term matches and add recall only."""
    pairs = parser.tokenize_and_stem(term)
    tokens = [t for t, _ in pairs]
    stems = sorted({s for _, ss in pairs for s in ss}) if pairs else []
    return tokens, stems


def expanded_spans(term_dict, tokens: List[str], stems: List[str]):
    """Per-token prefix spans + exact stem spans (dedup'd against the
    prefix spans) over a committed TermDict. Returns (spans, n_surface):
    only ``spans[:n_surface]`` may drive phrase adjacency."""
    spans = [term_dict.prefix_range(t) for t in tokens]
    spans = [(lo, hi) for lo, hi in spans if hi > lo]
    n_surface = len(spans)
    for s in stems:
        tid = term_dict.term_id(s)
        if tid is not None and not any(lo <= tid < hi for lo, hi in spans):
            spans.append((tid, tid + 1))
    return spans, n_surface


_MULTIVEC_FAST_MAX_CHUNKS = 64
# the vector indexes served from trained candidate structures
ANN_VMODES = ("ivf", "pq", "ivf_pq")


def _multivec_fast_eligible(c) -> bool:
    """Fast-path gate for multi-vector committed layouts: chunk rows must
    be doc-ascending (contiguous per doc) and a doc's fan-out bounded (K6
    looks back at most m_max - 1 rows; the exact rescore gathers [k*over,
    m_max] rows per query). Probed once per committed generation and
    cached on the immutable index."""
    asc = getattr(c, "_docs_ascending", None)
    if asc is None:
        asc = bool(np.all(np.diff(c.vec_docs) >= 0))
        c._docs_ascending = asc
        c._max_chunks = int(np.bincount(c.vec_docs).max()) if asc else 0
    return asc and c._max_chunks <= _MULTIVEC_FAST_MAX_CHUNKS


def _vec_docs_identity(c) -> bool:
    """True when the committed vector rows ARE the docs (row i -> doc i);
    cached on the immutable committed index."""
    ident = getattr(c, "_docs_identity", None)
    if ident is None:
        d = c.vec_docs
        ident = bool(
            len(d) == 0
            or (
                int(d[-1]) == len(d) - 1
                and np.array_equal(d, np.arange(len(d), dtype=d.dtype))
            )
        )
        c._docs_identity = ident
    return ident


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# --- device cache ------------------------------------------------------------


class _CapacityMoved(RuntimeError):
    """A search met a doc id past the capacity it pinned (a window doc
    that arrived after the search began, or on the mesh path a doc past
    the split of the doc space it took): the search starts again with a
    new view."""


class _WindowMask:
    """A host mask of the pinned capacity as the uncommitted windows'
    searches read it, one doc at a time: a window doc past it raises
    ``_CapacityMoved``."""

    __slots__ = ("m",)

    def __init__(self, m: np.ndarray) -> None:
        self.m = m

    def __getitem__(self, i) -> float:
        if i >= len(self.m):
            raise _CapacityMoved(f"window doc {i} is past {len(self.m)}")
        return self.m[i]


class _View:
    """What a search reads of its reader: the fields, each field's
    (uncommitted, committed) container, the tombstones, and the capacity.
    The reader's own view is live; a search pins a copy
    (``CollectionReader._pinned``), so a commit that lands meanwhile
    swaps containers the search no longer reads. The copy takes the
    containers first and the capacity after them: a generation holds
    only docs below the capacity at its commit, which never shrinks, so
    the pinned capacity covers every generation the search reads."""

    __slots__ = ("fields", "field_by_name", "string", "number", "keyword",
                 "bool", "vector", "deleted", "cap")

    def __init__(self, fields, field_by_name, string, number, keyword, bool_,
                 vector, deleted, cap: Optional[int] = None) -> None:
        self.fields: Dict[int, TypedField] = fields
        self.field_by_name: Dict[str, int] = field_by_name
        self.string: Dict[int, _StringField] = string
        self.number: Dict[int, _NumberField] = number
        self.keyword: Dict[int, _KeywordField] = keyword
        self.bool: Dict[int, _BoolField] = bool_
        self.vector: Dict[int, _VectorField] = vector
        self.deleted: Set[int] = deleted
        self.cap = cap  # None: the reader's live capacity

    def pin(self, cap_now) -> "_View":
        view = _View(dict(self.fields), dict(self.field_by_name),
                     dict(self.string), dict(self.number),
                     dict(self.keyword), dict(self.bool), dict(self.vector),
                     self.deleted)
        view.cap = cap_now()
        return view


class _DeviceCache:
    """Device copies of immutable committed structures, keyed by object id.
    Entries die with their committed generation (commit replaces objects).

    With ``cfg.mesh_shape`` set, the mesh's serving path reads per-shard
    layouts (``sharded_*`` below, over ``parallel/mesh.py``'s mesh), and
    the single-device layouts, which the paths outside the mesh programs
    read (batches, the replicated IVF and PQ modes), live whole on the
    mesh's first device."""

    def __init__(self, cfg: GpuConfig) -> None:
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.mesh = None
        if cfg.mesh_shape:
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(cfg.mesh_shape, tuple(cfg.mesh_axis_names),
                                  device=cfg.device)
            self.device = self.mesh.root
        self._store: Dict[Tuple[int, Any], Any] = {}
        self._keepalive: Dict[int, Any] = {}
        # generations a commit replaced; searches that pinned one before
        # the commit still read it, uncached
        self._retired: "weakref.WeakValueDictionary[int, Any]" = (
            weakref.WeakValueDictionary())
        self._lock = threading.Lock()

    def put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _get(self, obj: Any, tag: Any, build) -> Any:
        key = (id(obj), tag)
        hit = self._store.get(key)
        if hit is None:
            hit = build()
            with self._lock:  # against a retire between the check and the store
                if self._retired.get(id(obj)) is obj:
                    return hit  # nothing pins a replaced generation
                self._store[key] = hit
                self._keepalive[id(obj)] = obj  # pin so id() stays unique
        return hit

    def retire(self, obj: Any) -> None:
        """``drop`` a generation a commit replaced, for good: searches
        that pinned it still read it, but what they build for it is not
        cached, so it lives no longer than they do."""
        with self._lock:
            self._retired[id(obj)] = obj
            self.drop(obj)

    def drop(self, obj: Any) -> None:
        oid = id(obj)
        self._keepalive.pop(oid, None)
        # a snapshot of the keys and pops: searches build and evict
        # entries from other threads
        for key in [k for k in list(self._store) if k[0] == oid]:
            self._store.pop(key, None)

    def _evict_variants(self, obj: Any, tag: str, key: Any) -> None:
        """Drop cached ``tag`` variants of ``obj`` other than ``key``."""
        oid = id(obj)
        stale = [
            k for k in list(self._store)
            if k[0] == oid and isinstance(k[1], tuple)
            and k[1][0] == tag and k[1] != key
        ]
        for k in stale:
            self._store.pop(k, None)

    # string -----------------------------------------------------------------

    def string_arrays(self, s: CommittedStringIndex):
        """(post_docs i32, post_tf f32, post_ni f32, post_lens f32), padded
        to a posting bucket + one BLOCK tail. ``ni`` (owning term's df) and
        ``lens`` (owning doc's field length) are commit-static columns."""

        def build():
            steps = self.cfg.posting_bucket_steps
            p = len(s.post_docs)
            p_pad = bucket_pad(max(p, 1), steps) + bm25_ops.BLOCK
            docs = np.zeros(p_pad, np.int32)
            docs[:p] = s.post_docs
            tf = np.zeros(p_pad, np.float32)
            tf[:p] = s.post_tf
            ni = np.zeros(p_pad, np.float32)
            plens = np.zeros(p_pad, np.float32)
            if p:
                # df may be the cross-slice global override (term_df)
                ni[:p] = np.repeat(s.term_df(), np.diff(s.term_starts))
                plens[:p] = s.doc_lens_dense[s.post_docs]
            return self.put(docs), self.put(tf), self.put(ni), self.put(plens)

        return self._get(s, "str", build)

    def dense_term_rows(self, s: CommittedStringIndex, cap: int, avgdl: float):
        """Dense g(tf, len) rows for Zipf-head terms (ops/bm25.py): (rows
        [H, cap] f32, {term_index: row}) or (None, None). Rows embed avgdl,
        so the key carries it; stale variants are evicted."""

        def build():
            built = bm25_ops.build_dense_term_rows(
                s.term_starts, s.post_docs, s.post_tf, s.doc_lens_dense,
                cap=cap, avgdl=avgdl,
                budget=int(self.cfg.bm25_dense_terms),
                df_ratio=int(self.cfg.bm25_dense_df_ratio),
            )
            if built is None:
                return (None, None)
            rows, row_by_term = built
            return (self.put(rows), row_by_term)

        key = ("dense_rows", cap, round(float(avgdl), 6))
        oid = id(s)
        # a snapshot of the keys and pops: searches build and evict
        # entries from other threads
        stale = [
            k for k in list(self._store)
            if k[0] == oid and isinstance(k[1], tuple)
            and k[1][:2] == ("dense_rows", cap) and k[1] != key
        ]
        for k in stale:
            self._store.pop(k, None)
        return self._get(s, key, build)

    def span_arrays(self, s: CommittedStringIndex, phrase: bool):
        """The span scorer's index arrays: (term_starts, pos_starts,
        positions) on the device; the positions only for ``phrase`` (None
        otherwise: a non-phrase query never reads them)."""
        ts = self._get(s, "term_starts", lambda: self.put(
            np.asarray(s.term_starts, np.int64)))
        if not phrase:
            return ts, None, None
        ps, pos = self._get(s, "positions", lambda: (
            self.put(np.asarray(s.pos_starts, np.int64)),
            self.put(np.asarray(s.positions, np.int32))))
        return ts, ps, pos

    def phrase_stream_arrays(self, s: CommittedStringIndex, cap: int):
        """K4's commit-static input: (terms, bits, bounds). ``terms`` and
        ``bits`` cover every position of the field, sorted once per
        generation by (doc, pos) — stable, as the reference's
        ``lax.sort`` — with the group bits of the sorted stream;
        ``bounds`` int32[cap + 1] is the stream's per-doc CSR, built on
        the device from the sorted doc column, which is then dropped:
        nothing else reads it. The reference's window meta (w_base, W,
        wsub) is not built: K4 counts per doc without windows."""

        def build():
            steps = self.cfg.posting_bucket_steps
            pp = len(s.positions)
            pp_pad = bucket_pad(max(pp, 1), steps)
            run_lens = np.diff(s.pos_starts)
            pos_doc = np.repeat(s.post_docs, run_lens)
            tcounts = np.diff(s.term_starts)
            pos_term = np.repeat(
                np.repeat(np.arange(len(tcounts), dtype=np.int32), tcounts),
                run_lens,
            )
            d_col = np.full(pp_pad, bm25_ops.PAD_DOC, np.int32)
            d_col[:pp] = pos_doc
            p_col = np.zeros(pp_pad, np.int32)
            p_col[:pp] = s.positions
            t_col = np.zeros(pp_pad, np.int32)
            t_col[:pp] = pos_term
            d_dev, p_dev, t_dev = bm25_ops.sort_phrase_stream(
                self.put(d_col), self.put(p_col), self.put(t_col)
            )
            # bounds over the docs the stream holds; a larger capacity
            # only appends empty docs (phrase_bounds below)
            n_held = int(pos_doc.max()) + 1 if pp else 0
            return (t_dev, bm25_ops.phrase_static_bits(d_dev, p_dev),
                    bm25_ops.stream_doc_bounds(d_dev, n_held))

        terms, bits, held = self._get(s, "phrase", build)
        key = ("phrase_bounds", cap)
        self._evict_variants(s, "phrase_bounds", key)

        def bounds():
            n_held = held.shape[0] - 1
            if cap <= n_held:
                return held[:cap + 1]
            return torch.cat([held, held[-1:].expand(cap - n_held)])

        return terms, bits, self._get(s, key, bounds)

    # vector -----------------------------------------------------------------

    def vector_arrays(self, v: CommittedVectorIndex):
        """(vecs [p_pad, D] bf16|f32, vec_docs i32, vec_valid f32). The pad
        rows are zeros, written on the device (no padded host copy)."""

        def build():
            steps = self.cfg.posting_bucket_steps
            p = v.n_vectors
            p_pad = bucket_pad(max(p, 1), steps)
            dtype = (torch.bfloat16 if self.cfg.vector_dtype == "bfloat16"
                     else torch.float32)
            vecs = torch.zeros(p_pad, v.dimension, dtype=dtype,
                               device=self.device)
            if p:
                vecs[:p] = self.put(np.asarray(v.vecs, np.float32)).to(dtype)
            docs = np.zeros(p_pad, np.int32)
            docs[:p] = v.vec_docs
            valid = np.zeros(p_pad, np.float32)
            valid[:p] = 1.0
            return vecs, self.put(docs), self.put(valid)

        return self._get(v, "vec", build)

    def vector_rows(self, v: CommittedVectorIndex):
        """``vector_arrays`` without the bucket padding (views of its
        prefix): the exact matmul reads only real rows. The padded tensors
        stay for the fused kNN, whose K2 tiles take whole blocks."""
        n = v.n_vectors
        return tuple(a[:n] for a in self.vector_arrays(v))

    def vector_rowstarts(self, v: CommittedVectorIndex, cap: int):
        """Doc -> row-range CSR (int32[cap+1]) for the multi-vector fused
        kNN's exact rescore; valid only for doc-ascending row layouts."""

        def build():
            counts = np.bincount(v.vec_docs, minlength=cap)
            starts = np.zeros(cap + 1, np.int64)
            np.cumsum(counts, out=starts[1:])
            return self.put(starts.astype(np.int32))

        return self._get(v, ("vec_rowstarts", cap), build)

    def vector_int8_arrays(self, v: CommittedVectorIndex):
        """(codes int8[p_pad, D], scales f32[p_pad], vec_docs i32, vec_valid
        f32): the int8 capacity layout. Only the real rows are quantized,
        on the device, a chunk at a time; the pad rows are written there as
        the reference's quantization of a zero row (codes 0, scale
        1e-9/127), so no padded f32 host copy is ever built."""

        def build():
            from ..ops.quant import quantize_int8

            steps = self.cfg.posting_bucket_steps
            p = v.n_vectors
            p_pad = bucket_pad(max(p, 1), steps)
            codes = torch.zeros(p_pad, v.dimension, dtype=torch.int8,
                                device=self.device)
            scales = torch.empty(p_pad, dtype=torch.float32,
                                 device=self.device)
            chunk = 1 << 18
            for lo in range(0, p, chunk):
                hi = min(lo + chunk, p)
                c8, sc = quantize_int8(self.put(
                    np.asarray(v.vecs[lo:hi], np.float32)))
                codes[lo:hi] = c8
                scales[lo:hi] = sc
            scales[p:] = quantize_int8(
                torch.zeros(1, v.dimension, device=self.device))[1]
            docs = np.zeros(p_pad, np.int32)
            docs[:p] = v.vec_docs
            valid = np.zeros(p_pad, np.float32)
            valid[:p] = 1.0
            return codes, scales, self.put(docs), self.put(valid)

        return self._get(v, "vec_int8", build)

    def _vector_rows_unpadded(self, v: CommittedVectorIndex) -> torch.Tensor:
        """[P, D] rows in the vector dtype, written a chunk at a time (the
        ANN indexes gather rows by id: no bucket padding)."""
        dtype = (torch.bfloat16 if self.cfg.vector_dtype == "bfloat16"
                 else torch.float32)
        out = torch.empty(v.n_vectors, v.dimension, dtype=dtype,
                          device=self.device)
        chunk = 1 << 18
        for lo in range(0, v.n_vectors, chunk):
            out[lo:lo + chunk] = self.put(
                np.asarray(v.vecs[lo:lo + chunk], np.float32)).to(dtype)
        return out

    def _pq_rotation(self, v: CommittedVectorIndex):
        if v.pq_rotation is None:
            return None
        return self.put(np.asarray(v.pq_rotation, np.float32))

    def vector_pq_arrays(self, v: CommittedVectorIndex):
        """(codes uint8[P, M], codebooks f32[M, C, D/M], rows [P, D] in the
        vector dtype, vec_docs i32, vec_valid f32, rotation f32[D, D] |
        None): the flat PQ layout."""

        def build():
            return (
                self.put(v.pq_codes),
                self.put(np.asarray(v.pq_codebooks, np.float32)),
                self._vector_rows_unpadded(v),
                self.put(v.vec_docs),
                self.put(np.ones(v.n_vectors, np.float32)),
                self._pq_rotation(v),
            )

        return self._get(v, "vec_pq", build)

    def vector_ivfpq_arrays(self, v: CommittedVectorIndex):
        """(codes, codebooks, rows, centroids f32[C, D], lists i32[C, cap],
        list lens i32[C], vec_docs, rotation | None): the IVF-PQ layout."""

        def build():
            return (
                self.put(v.pq_codes),
                self.put(np.asarray(v.pq_codebooks, np.float32)),
                self._vector_rows_unpadded(v),
                self.put(np.asarray(v.ivf_cents, np.float32)),
                self.put(v.ivf_lists),
                self.put(v.ivf_lens),
                self.put(v.vec_docs),
                self._pq_rotation(v),
            )

        return self._get(v, "vec_ivfpq", build)

    def vector_ivf_arrays(self, v: CommittedVectorIndex):
        """(rows, centroids, lists, list lens, vec_docs): the IVF layout."""

        def build():
            return (
                self._vector_rows_unpadded(v),
                self.put(np.asarray(v.ivf_cents, np.float32)),
                self.put(v.ivf_lists),
                self.put(v.ivf_lens),
                self.put(v.vec_docs),
            )

        return self._get(v, "vec_ivf", build)

    def vector_int8_rows(self, v: CommittedVectorIndex):
        """``vector_int8_arrays`` without the bucket padding: the dense
        int8 product reads only real rows."""
        n = v.n_vectors
        return tuple(a[:n] for a in self.vector_int8_arrays(v))

    # number -----------------------------------------------------------------

    def number_arrays(self, nidx: CommittedNumberIndex):
        def build():
            n = len(nidx.vals)
            n_pad = bucket_pad(max(n, 1), self.cfg.posting_bucket_steps)
            vals = np.full(n_pad, np.nan, np.float32)
            vals[:n] = nidx.vals
            docs = np.zeros(n_pad, np.int32)
            docs[:n] = nidx.docs
            valid = np.zeros(n_pad, bool)
            valid[:n] = True
            return self.put(vals), self.put(docs), self.put(valid)

        return self._get(nidx, "num", build)

    def _dense_value_plane(self, idx, tag: str, vals, fill, n_docs: int):
        """f32[n_docs] value per doc (``fill`` for valueless docs): range,
        eq and in filters become elementwise compares. Only valid when
        every doc holds at most one value; None otherwise."""
        key = (tag, n_docs)
        self._evict_variants(idx, tag, key)

        def build():
            docs = np.asarray(idx.docs)
            if len(docs) and np.bincount(docs).max() > 1:
                return (None,)
            plane = np.full(n_docs, fill, np.float32)
            plane[docs] = np.asarray(vals, np.float32)
            return (self.put(plane),)

        return self._get(idx, key, build)[0]

    def number_dense_plane(self, nidx: CommittedNumberIndex, n_docs: int):
        """f32[n_docs] number plane, NaN = no value."""
        return self._dense_value_plane(nidx, "numdense", nidx.vals, np.nan,
                                       n_docs)

    # keyword ------------------------------------------------------------------

    def keyword_arrays(self, kidx: CommittedKeywordIndex):
        def build():
            n = len(kidx.ids)
            n_pad = bucket_pad(max(n, 1), self.cfg.posting_bucket_steps)
            ids = np.full(n_pad, -1.0, np.float32)  # -1 never matches an id
            ids[:n] = kidx.ids
            docs = np.zeros(n_pad, np.int32)
            docs[:n] = kidx.docs
            valid = np.zeros(n_pad, bool)
            valid[:n] = True
            return self.put(ids), self.put(docs), self.put(valid)

        return self._get(kidx, "kw", build)

    def keyword_dense_plane(self, kidx: CommittedKeywordIndex, n_docs: int):
        """f32[n_docs] keyword value-id plane, -2.0 = no value."""
        return self._dense_value_plane(kidx, "kwdense", kidx.ids, -2.0, n_docs)

    # bool -------------------------------------------------------------------

    def bool_arrays(self, b: CommittedBoolIndex, cap: int):
        def build():
            true_mask = np.zeros(cap, np.float32)
            has_mask = np.zeros(cap, np.float32)
            n = min(len(b.true_mask), cap)
            true_mask[:n] = b.true_mask[:n]
            has_mask[:n] = b.has_mask[:n]
            return self.put(true_mask), self.put(has_mask)

        return self._get(b, ("bool", cap), build)

    # ---- sharded (shard-local doc-id space) layouts --------------------------
    #
    # With a data mesh, committed structures are repacked at cache-build time
    # into per-shard arrays (parallel/mesh.Sharded): doc d lives on shard
    # d // local_cap at local id d % local_cap. The mesh programs of
    # parallel/sharded_engine.py read these; dense arrays stay per shard.

    @property
    def n_shards(self) -> int:
        if self.mesh is None:
            return 1
        from ..parallel.mesh import DATA_AXIS

        return self.mesh.shape.get(DATA_AXIS, 1)

    def put_stacked(self, arr: np.ndarray, dtype=None):
        """Host ``[S, ...]`` onto the mesh, shard s's rows at ``arr[s]``."""
        from ..parallel.mesh import put_stacked

        return put_stacked(self.mesh, arr, dtype)

    def _alloc(self, shape, dtype, fill=0):
        from ..parallel.mesh import alloc

        return alloc(self.mesh, shape, dtype, fill)

    def _get_sharded(self, obj: Any, tag: str, size: int, build) -> Any:
        """``_get`` of a per-shard layout of ``obj`` for a shard size; a
        capacity that grew moves every doc's shard, so the layouts of the
        old size are evicted."""
        key = (tag, size)
        self._evict_variants(obj, tag, key)
        return self._get(obj, key, build)

    def zeros_sharded(self, cap_s: int):
        key = ("zeros_sh", cap_s)
        hit = self._store.get((0, key))
        if hit is None:
            hit = self._alloc((cap_s // self.n_shards,), torch.float32)
            self._store[(0, key)] = hit
        return hit

    @staticmethod
    def _shard_perm(global_docs: np.ndarray, local_cap: int, n_shards: int):
        """Stable partition of row-arrays by owning shard: returns (perm,
        shard offsets [S+1], local doc ids in perm order)."""
        owner = global_docs // local_cap
        perm = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=n_shards)
        if len(counts) > n_shards:
            raise _CapacityMoved(f"doc {int(global_docs.max())} is past "
                               f"{n_shards} shards of {local_cap}")
        offs = np.zeros(n_shards + 1, np.int64)
        offs[1:] = np.cumsum(counts)
        local = (global_docs[perm] % local_cap).astype(np.int32)
        return perm, offs, local

    def _rows_by_shard(self, vecs: np.ndarray, perm, offs, p_l: int, dtype):
        """Sharded [p_l, D] rows in ``dtype``: shard s's rows are
        ``vecs[perm[offs[s]:offs[s+1]]]``, then zero pad rows; written on
        the device a chunk at a time (no padded host copy)."""
        out = self._alloc((p_l, vecs.shape[1]), dtype)
        chunk = 1 << 17
        for si in range(self.n_shards):
            rows = perm[int(offs[si]):int(offs[si + 1])]
            part = out[si]
            for lo in range(0, len(rows), chunk):
                got = np.asarray(vecs[rows[lo:lo + chunk]], np.float32)
                part[lo:lo + len(got)] = torch.as_tensor(
                    got, device=part.device).to(dtype)
        return out

    def sharded_string_arrays(self, s: CommittedStringIndex, local_cap: int):
        """(post_docs, post_tf, post_ni, post_lens per shard, each padded to
        a bucket + one BLOCK as K1 takes them; per-shard CSR term offsets
        int64 [S, T + 1] on the host, for the query-time block plans)."""

        def build():
            BLOCK = bm25_ops.BLOCK
            S = self.n_shards
            steps = self.cfg.posting_bucket_steps
            p = len(s.post_docs)
            t_count = np.diff(s.term_starts).astype(np.int64)
            T = len(t_count)
            if p == 0:
                p_pad = bucket_pad(1, steps) + BLOCK
                z_i = np.zeros((S, p_pad), np.int32)
                z_f = np.zeros((S, p_pad), np.float32)
                return (self.put_stacked(z_i), self.put_stacked(z_f),
                        self.put_stacked(z_f), self.put_stacked(z_f),
                        np.zeros((S, T + 1), np.int64))
            post_docs = s.post_docs.astype(np.int64)
            perm, offs, local_docs = self._shard_perm(post_docs, local_cap, S)
            owner = post_docs // local_cap
            # per-shard CSR term offsets (host, for query-time block plans)
            term_of_post = np.repeat(np.arange(T, dtype=np.int64), t_count)
            key = term_of_post * S + owner
            ts_counts = np.bincount(key, minlength=T * S).reshape(T, S)
            ts_sh = np.zeros((S, T + 1), np.int64)
            ts_sh[:, 1:] = np.cumsum(ts_counts.T, axis=1)
            # permuted posting columns (stable sort keeps term-major order);
            # df may be the cross-slice global override (term_df)
            cols = (
                local_docs,
                s.post_tf[perm],
                np.repeat(s.term_df(), t_count)[perm],
                s.doc_lens_dense[s.post_docs[perm]],
            )
            p_pad = bucket_pad(max(int(np.diff(offs).max()), 1), steps) + BLOCK
            out = []
            for col, dt in zip(cols, (np.int32, np.float32, np.float32,
                                      np.float32)):
                st = np.zeros((S, p_pad), dt)
                for si in range(S):
                    a, b = int(offs[si]), int(offs[si + 1])
                    st[si, : b - a] = col[a:b]
                out.append(self.put_stacked(st))
            return (*out, ts_sh)

        return self._get_sharded(s, "str_sh", local_cap, build)

    def sharded_phrase_stream(self, s: CommittedStringIndex, local_cap: int):
        """K4's per-shard input: (terms, bits, bounds), each shard's slice
        of ``phrase_stream_arrays``' doc-sorted stream in local doc ids:
        its positions sorted by (doc, pos), stable, with their group bits,
        and its per-doc CSR bounds int32 [local_cap + 1]. The bits never
        look across a doc, so a shard's slice has the bits it has in the
        whole stream."""

        def build():
            S = self.n_shards
            steps = self.cfg.posting_bucket_steps
            run_lens = np.diff(s.pos_starts)
            pos_doc = np.repeat(s.post_docs.astype(np.int64), run_lens)
            tcounts = np.diff(s.term_starts)
            pos_term = np.repeat(
                np.repeat(np.arange(len(tcounts), dtype=np.int32), tcounts),
                run_lens,
            )
            perm, offs, local = self._shard_perm(pos_doc, local_cap, S)
            pp_pad = bucket_pad(max(int(np.diff(offs).max()), 1), steps)
            terms = self._alloc((pp_pad,), torch.int32)
            bits = self._alloc((pp_pad,), torch.uint8)
            bounds = self._alloc((local_cap + 1,), torch.int32)
            for si in range(S):
                a, b = int(offs[si]), int(offs[si + 1])
                dev = terms[si].device
                d_col = np.full(pp_pad, bm25_ops.PAD_DOC, np.int32)
                d_col[: b - a] = local[a:b]
                p_col = np.zeros(pp_pad, np.int32)
                p_col[: b - a] = s.positions[perm[a:b]]
                t_col = np.zeros(pp_pad, np.int32)
                t_col[: b - a] = pos_term[perm[a:b]]
                d_dev, p_dev, t_dev = bm25_ops.sort_phrase_stream(*(
                    torch.as_tensor(c, device=dev) for c in (d_col, p_col,
                                                             t_col)))
                terms[si].copy_(t_dev)
                bits[si].copy_(bm25_ops.phrase_static_bits(d_dev, p_dev))
                bounds[si].copy_(bm25_ops.stream_doc_bounds(d_dev, local_cap))
            return terms, bits, bounds

        return self._get_sharded(s, "phrase_sh", local_cap, build)

    def sharded_vector_arrays(self, v: CommittedVectorIndex, local_cap: int):
        """(vecs [p_l, D], local vec_docs, vec_valid) per shard, p_l the
        bucket of the largest shard's rows."""

        def build():
            S = self.n_shards
            perm, offs, local_docs = self._shard_perm(
                v.vec_docs.astype(np.int64), local_cap, S
            )
            p_l = bucket_pad(max(int(np.diff(offs).max()), 1),
                             self.cfg.posting_bucket_steps)
            dtype = (torch.bfloat16 if self.cfg.vector_dtype == "bfloat16"
                     else torch.float32)
            # pad rows point at the shard's LAST doc slot, not doc 0: the
            # dense scorer zeroes them via `valid` either way, and the fused
            # kNN (vector_topk_fast) needs row_docs ascending; zero-vector
            # pads at local_cap-1 add no score and no match count
            docs_st = np.full((S, p_l), local_cap - 1, np.int32)
            valid_st = np.zeros((S, p_l), np.float32)
            for si in range(S):
                a, b = int(offs[si]), int(offs[si + 1])
                docs_st[si, : b - a] = local_docs[a:b]
                valid_st[si, : b - a] = 1.0
            return (self._rows_by_shard(v.vecs, perm, offs, p_l, dtype),
                    self.put_stacked(docs_st), self.put_stacked(valid_st))

        return self._get_sharded(v, "vec_sh", local_cap, build)

    def sharded_vector_rowstarts(self, v: CommittedVectorIndex, local_cap: int):
        """Per-shard doc -> row-range CSR (int32 [S][local_cap + 1]) over
        the row partition of sharded_vector_arrays: the multi-vector fused
        kNN's exact-rescore input (real rows only; doc-ascending layouts)."""

        def build():
            S = self.n_shards
            _, offs, local_docs = self._shard_perm(
                v.vec_docs.astype(np.int64), local_cap, S
            )
            starts = np.zeros((S, local_cap + 1), np.int64)
            for si in range(S):
                a, b = int(offs[si]), int(offs[si + 1])
                counts = np.bincount(local_docs[a:b], minlength=local_cap)
                np.cumsum(counts, out=starts[si, 1:])
            return self.put_stacked(starts.astype(np.int32))

        return self._get_sharded(v, "vec_rowstarts_sh", local_cap, build)

    def sharded_vector_int8_arrays(self, v: CommittedVectorIndex,
                                   local_cap: int):
        """(codes int8, scales f32, local vec_docs, vec_valid) per shard:
        the reference's quantization of the rows, on the device a chunk at
        a time; pad rows are zeros (and invalid)."""

        def build():
            from ..ops.quant import quantize_int8

            S = self.n_shards
            perm, offs, local_docs = self._shard_perm(
                v.vec_docs.astype(np.int64), local_cap, S
            )
            p_l = bucket_pad(max(int(np.diff(offs).max()), 1),
                             self.cfg.posting_bucket_steps)
            codes = self._alloc((p_l, v.dimension), torch.int8)
            scales = self._alloc((p_l,), torch.float32)
            docs_st = np.zeros((S, p_l), np.int32)
            valid_st = np.zeros((S, p_l), np.float32)
            chunk = 1 << 17
            for si in range(S):
                a, b = int(offs[si]), int(offs[si + 1])
                rows = perm[a:b]
                dev = codes[si].device
                for lo in range(0, len(rows), chunk):
                    got = np.asarray(v.vecs[rows[lo:lo + chunk]], np.float32)
                    c8, sc = quantize_int8(torch.as_tensor(got, device=dev))
                    codes[si][lo:lo + len(got)] = c8
                    scales[si][lo:lo + len(got)] = sc
                docs_st[si, : b - a] = local_docs[a:b]
                valid_st[si, : b - a] = 1.0
            return (codes, scales, self.put_stacked(docs_st),
                    self.put_stacked(valid_st))

        return self._get_sharded(v, "vec_int8_sh", local_cap, build)

    def sharded_ivfpq_arrays(self, v: CommittedVectorIndex, local_cap: int):
        """Per-shard IVF-PQ layout for the mesh serving path: (codes, PQ
        codebooks, rows, centroids, lists, list lens, local vec_docs,
        rotation | None). Centroids, codebooks and the rotation are one
        copy on the mesh's first device (the programs replicate them);
        rows partition by owning doc shard and each shard re-derives its
        slice of every cluster's member list as LOCAL row ids. The union
        over shards of a cluster's members is the global list, so probing
        the same clusters scans the same candidate rows as the
        single-device path."""

        def build():
            S = self.n_shards
            P = v.n_vectors
            perm, offs, local_docs = self._shard_perm(
                v.vec_docs.astype(np.int64), local_cap, S
            )
            owner = v.vec_docs.astype(np.int64) // local_cap
            # global row -> position in the shard-packed row arrays
            inv = np.empty(P, np.int64)
            inv[perm] = np.arange(P, dtype=np.int64)
            local_row = inv - offs[owner]

            p_l = max(int(np.diff(offs).max()), 1)
            p_l = max(((p_l + 127) // 128) * 128, 128)
            m = v.pq_codes.shape[1]
            codes_st = np.zeros((S, p_l, m), np.uint8)
            docs_st = np.zeros((S, p_l), np.int32)
            cp = v.pq_codes[perm]
            for si in range(S):
                a, b = int(offs[si]), int(offs[si + 1])
                codes_st[si, : b - a] = cp[a:b]
                docs_st[si, : b - a] = local_docs[a:b]

            # per-(shard, cluster) member lists in local row ids; a row's
            # cluster is its argmax assignment (build_ivf_lists never
            # spills), matching the single-device scan
            cl = v.ivf_lists.shape[0]
            lens_g = v.ivf_lens.astype(np.int64)
            flat_rows = np.concatenate(
                [v.ivf_lists[c, : lens_g[c]] for c in range(cl)]
            ) if lens_g.sum() else np.zeros(0, np.int64)
            flat_rows = flat_rows.astype(np.int64)
            flat_cluster = np.repeat(np.arange(cl, dtype=np.int64), lens_g)
            s_of = owner[flat_rows]
            key = flat_cluster * S + s_of
            order2 = np.argsort(key, kind="stable")
            counts2 = np.bincount(key, minlength=cl * S).reshape(cl, S)
            cap_sh = int(counts2.max()) if counts2.size else 1
            cap_sh = max(((cap_sh + 127) // 128) * 128, 128)
            lists_st = np.zeros((S, cl, cap_sh), np.int32)
            lens_st = counts2.T.astype(np.int32).copy()  # [S, cl]
            if len(flat_rows):
                ksort = key[order2]
                group_starts = np.searchsorted(ksort, np.arange(cl * S))
                pos_in_group = np.arange(len(ksort), dtype=np.int64) - (
                    np.repeat(group_starts, counts2.reshape(-1))
                )
                lists_st[
                    s_of[order2], flat_cluster[order2], pos_in_group
                ] = local_row[flat_rows[order2]].astype(np.int32)
            dtype = (torch.bfloat16 if self.cfg.vector_dtype == "bfloat16"
                     else torch.float32)
            return (
                self.put_stacked(codes_st),
                self.put(np.asarray(v.pq_codebooks, np.float32)),
                self._rows_by_shard(v.vecs, perm, offs, p_l, dtype),
                self.put(np.asarray(v.ivf_cents, np.float32)),
                self.put_stacked(lists_st),
                self.put_stacked(lens_st),
                self.put_stacked(docs_st),
                self._pq_rotation(v),
            )

        return self._get_sharded(v, "vec_ivfpq_sh", local_cap, build)

    def _sharded_columns(self, idx, cols, fills, local_cap: int):
        """(value columns..., local docs, valid) per shard for a committed
        (value, doc) column index, padded to a bucket of the largest
        shard's entries."""
        S = self.n_shards
        steps = self.cfg.posting_bucket_steps
        n = len(idx.docs)
        perm, offs, local_docs = self._shard_perm(
            idx.docs.astype(np.int64), local_cap, S)
        n_pad = bucket_pad(max(int(np.diff(offs).max()) if n else 1, 1), steps)
        outs = [np.full((S, n_pad), f, np.asarray(c).dtype)
                for c, f in zip(cols, fills)]
        docs_st = np.zeros((S, n_pad), np.int32)
        valid_st = np.zeros((S, n_pad), bool)
        permuted = [np.asarray(c)[perm] for c in cols]
        for si in range(S):
            a, b = int(offs[si]), int(offs[si + 1])
            for o, c in zip(outs, permuted):
                o[si, : b - a] = c[a:b]
            docs_st[si, : b - a] = local_docs[a:b]
            valid_st[si, : b - a] = True
        return (*[self.put_stacked(o) for o in outs],
                self.put_stacked(docs_st), self.put_stacked(valid_st))

    def sharded_keyword_arrays(self, kidx: CommittedKeywordIndex,
                               local_cap: int):
        """(value ids f32 (-1 pad), local docs, valid) per shard."""
        return self._get_sharded(kidx, "kw_sh", local_cap, lambda: (
            self._sharded_columns(kidx, [np.asarray(kidx.ids, np.float32)],
                                  [-1.0], local_cap)))

    def sharded_number_arrays(self, nidx: CommittedNumberIndex,
                              local_cap: int):
        """(values f32 (NaN pad), local docs, valid) per shard."""
        return self._get_sharded(nidx, "num_sh", local_cap, lambda: (
            self._sharded_columns(nidx, [np.asarray(nidx.vals, np.float32)],
                                  [np.nan], local_cap)))

    def sharded_bool_arrays(self, b: CommittedBoolIndex, cap_s: int):
        """(true mask, has mask) per shard, f32 [S][cap_s / S]."""

        def build():
            S = self.n_shards
            true_mask = np.zeros(cap_s, np.float32)
            has_mask = np.zeros(cap_s, np.float32)
            n = min(len(b.true_mask), cap_s)
            true_mask[:n] = b.true_mask[:n]
            has_mask[:n] = b.has_mask[:n]
            return (self.put_stacked(true_mask.reshape(S, -1)),
                    self.put_stacked(has_mask.reshape(S, -1)))

        return self._get_sharded(b, "bool_sh", cap_s, build)


@dataclasses.dataclass
class _StringField:
    uncommitted: UncommittedStringIndex
    committed: CommittedStringIndex


@dataclasses.dataclass
class _NumberField:
    uncommitted: UncommittedNumberIndex
    committed: CommittedNumberIndex


@dataclasses.dataclass
class _KeywordField:
    uncommitted: UncommittedKeywordIndex
    committed: CommittedKeywordIndex


@dataclasses.dataclass
class _BoolField:
    uncommitted: UncommittedBoolIndex
    committed: CommittedBoolIndex


@dataclasses.dataclass
class _VectorField:
    uncommitted: UncommittedVectorIndex
    committed: CommittedVectorIndex


class CollectionReader:
    def __init__(
        self,
        collection_id: str,
        read_api_key: str,
        description: Optional[str],
        gpu_cfg: Optional[GpuConfig] = None,
        default_locale: str = "en",
    ) -> None:
        self.id = collection_id
        self.read_api_key = read_api_key
        self.description = description
        self.default_locale = default_locale
        self.cfg = gpu_cfg or GpuConfig()

        # fields, containers (keyword: exact-value columns) and the
        # cumulative tombstones; searches read them through their view
        self._live = _View({}, {}, {}, {}, {}, {}, {}, set())
        self._pins = threading.local()
        # held while a search pins its view, a commit publishes its
        # containers or a field is created: pins see none of these half done
        self._view_lock = threading.Lock()

        self._alive: np.ndarray = np.ones(0, dtype=np.float32)
        self._alive_version = 0
        self._alive_device: Optional[Tuple[int, int, torch.Tensor]] = None
        self.doc_count = 0
        self.max_doc_id = -1
        self.committed_offset = 0
        self.uncommitted_ops = 0

        self._device = _DeviceCache(self.cfg)
        self._lock = threading.RLock()
        # commit excludes op application but never search
        # (reference commit_insert_mutex, collection.rs:69)
        self._commit_insert_lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return self._device.device

    # -- the view a search reads ----------------------------------------------

    def _view(self) -> _View:
        """The view this thread's search pinned, else the live one."""
        return getattr(self._pins, "view", None) or self._live

    fields = property(lambda self: self._view().fields)
    field_by_name = property(lambda self: self._view().field_by_name)
    _string = property(lambda self: self._view().string)
    _number = property(lambda self: self._view().number)
    _keyword = property(lambda self: self._view().keyword)
    _bool = property(lambda self: self._view().bool)
    _vector = property(lambda self: self._view().vector)

    @property
    def deleted(self) -> Set[int]:
        return self._view().deleted

    @deleted.setter
    def deleted(self, value: Set[int]) -> None:
        self._live.deleted = value

    def _pinned(self, fn, *args):
        """``fn(*args)`` under one pinned view (nested calls share the
        outer one). A read the view cannot cover raises
        ``_CapacityMoved``, and the search starts again on a new view:
        up to 8 times, then once more with the error let through."""
        if getattr(self._pins, "view", None) is not None:
            return fn(*args)
        for attempt in range(9):
            with self._view_lock:
                self._pins.view = self._live.pin(self._live_capacity)
            try:
                return fn(*args)
            except _CapacityMoved:
                if attempt == 8:
                    raise
            finally:
                self._pins.view = None

    # -- capacity -------------------------------------------------------------

    def _live_capacity(self) -> int:
        return bucket_pad(max(self.max_doc_id + 1, 1), (self.cfg.doc_capacity_step,))

    @property
    def capacity(self) -> int:
        """The pinned view's capacity inside a search, else the live one:
        every buffer of a search is sized by it."""
        cap = self._view().cap
        return self._live_capacity() if cap is None else cap

    def _grow(self, doc_id: int) -> None:
        # grow the alive array BEFORE publishing the larger max_doc_id:
        # lock-free searches read capacity and _alive without the apply lock
        new_cap = bucket_pad(
            max(max(doc_id, self.max_doc_id) + 1, 1),
            (self.cfg.doc_capacity_step,),
        )
        if len(self._alive) < new_cap:
            # slots are dead until their InsertDocument op arrives
            grown = np.zeros(new_cap, dtype=np.float32)
            grown[: len(self._alive)] = self._alive
            self._alive = grown
            self._alive_version += 1
        if doc_id > self.max_doc_id:
            self.max_doc_id = doc_id

    def _alive_mask_device(self) -> torch.Tensor:
        cap = self.capacity
        # the version read before the copy: an op that lands meanwhile
        # leaves this entry stale, never a stale copy under its version
        version = self._alive_version
        cached = self._alive_device
        if cached and cached[0] == version and cached[1] == cap:
            return cached[2]
        m = self._device.put(self._alive[:cap])
        self._alive_device = (version, cap, m)
        return m

    def _alive_mask_sharded(self, cap_s: int):
        version = self._alive_version  # before the copy, as above
        cached = getattr(self, "_alive_device_sh", None)
        if cached and cached[0] == version and cached[1] == cap_s:
            return cached[2]
        m = np.zeros(cap_s, np.float32)
        n = min(len(self._alive), cap_s)
        m[:n] = self._alive[:n]
        dev = self._device.put_stacked(m.reshape(self._device.n_shards, -1))
        self._alive_device_sh = (version, cap_s, dev)
        return dev

    # -- op application (reference: collection.rs:608-681) --------------------

    def apply(self, op) -> None:
        with self._commit_insert_lock:
            self._apply_locked(op)
            self.uncommitted_ops += 1

    def _apply_locked(self, op) -> None:
        live = self._live  # writes never go to a search's pinned view
        # hot ops first: a bulk ingest is almost entirely Index*/Insert ops
        if isinstance(op, IndexStringOp):
            self._grow(op.doc_id)
            live.string[op.field_id].uncommitted.insert(
                op.doc_id, op.field_length, op.terms
            )
        elif isinstance(op, IndexKeywordOp):
            self._grow(op.doc_id)
            live.keyword[op.field_id].uncommitted.insert(op.doc_id, op.values)
        elif isinstance(op, InsertDocumentOp):
            self._grow(op.doc_id)
            self._alive[op.doc_id] = 1.0
            self._alive_version += 1
            if op.doc_id in live.deleted:
                # REBIND, never mutate: lock-free searches iterate this set
                live.deleted = live.deleted - {op.doc_id}
            self.doc_count += 1
        elif isinstance(op, IndexNumberOp):
            self._grow(op.doc_id)
            live.number[op.field_id].uncommitted.insert(op.doc_id, op.value)
        elif isinstance(op, IndexBoolOp):
            self._grow(op.doc_id)
            live.bool[op.field_id].uncommitted.insert(op.doc_id, op.value)
        elif isinstance(op, IndexEmbeddingOp):
            self._grow(op.doc_id)
            vf = live.vector[op.field_id]
            first = np.asarray(op.vectors, dtype=np.float32)
            got = int(first.shape[-1]) if first.ndim else 0
            if (
                got
                and got != vf.uncommitted.dimension
                and vf.uncommitted.is_empty
                and vf.committed.is_empty
                and live.fields[op.field_id].model
            ):
                # model-backed field whose registry dim is a static default:
                # the write side's actual embedder defines the space
                logging.getLogger("oramax").info(
                    "collection %s field %s: embedder dim %d overrides "
                    "registry dim %d",
                    self.id, live.fields[op.field_id].name, got,
                    vf.uncommitted.dimension,
                )
                vf = _VectorField(
                    UncommittedVectorIndex(got),
                    CommittedVectorIndex.empty(got),
                )
                live.vector[op.field_id] = vf
            vf.uncommitted.insert(op.doc_id, op.vectors)
        elif isinstance(op, CreateFieldOp):
            with self._view_lock:
                self._create_field(live, op.field)
        elif isinstance(op, DeleteDocumentsOp):
            ids = set(op.doc_ids)
            for d in ids:
                if 0 <= d < len(self._alive) and self._alive[d] == 1.0:
                    self._alive[d] = 0.0
                    self.doc_count -= 1
            # REBIND, never |=: lock-free searches iterate this set
            live.deleted = live.deleted | ids
            self._alive_version += 1
        else:
            raise TypeError(f"unknown op {type(op).__name__}")

    def _create_field(self, live: _View, f: TypedField) -> None:
        """A new field and its empty containers."""
        live.fields[f.field_id] = f
        live.field_by_name[f.name] = f.field_id
        if f.type == ValueType.STRING:
            live.string.setdefault(
                f.field_id,
                _StringField(UncommittedStringIndex(), CommittedStringIndex.empty()),
            )
            live.keyword.setdefault(
                f.field_id,
                _KeywordField(UncommittedKeywordIndex(), CommittedKeywordIndex.empty()),
            )
        elif f.type == ValueType.NUMBER:
            live.number.setdefault(
                f.field_id,
                _NumberField(UncommittedNumberIndex(), CommittedNumberIndex.empty()),
            )
        elif f.type == ValueType.BOOL:
            live.bool.setdefault(
                f.field_id, _BoolField(UncommittedBoolIndex(), CommittedBoolIndex.empty())
            )
        elif f.type == ValueType.EMBEDDING:
            from ..models.registry import model_dim

            dim = model_dim(f.model) if f.model else 0
            live.vector.setdefault(
                f.field_id,
                _VectorField(UncommittedVectorIndex(dim), CommittedVectorIndex.empty(dim)),
            )

    # -- filters (reference: collection.rs:797-869) ---------------------------

    def _filter_mask(self, where: Dict[str, Any]) -> torch.Tensor:
        cap = self.capacity
        mask = self._alive_mask_device()
        for field_name, filt in where.items():
            fid = self.field_by_name.get(field_name)
            if fid is None:
                raise ValueError(f'Cannot filter by "{field_name}": unknown field')
            f = self.fields[fid]
            if isinstance(filt, NumberFilter):
                if f.type != ValueType.NUMBER:
                    raise ValueError(f'"{field_name}" is not a number field')
                nf = self._number[fid]
                dense_plane = self._device.number_dense_plane(nf.committed, cap)
                if dense_plane is not None:
                    if filt.op == "eq":
                        m = filter_ops.number_eq_mask_dense(
                            dense_plane, float(np.float32(filt.value))
                        )
                    else:
                        lo, hi, lx, hx = nf.committed.filter_bounds(filt)
                        m = filter_ops.number_range_mask_dense(
                            dense_plane, float(np.float32(lo)),
                            float(np.float32(hi)), bool(lx), bool(hx),
                        )
                else:
                    vals, docs, valid = self._device.number_arrays(nf.committed)
                    if filt.op == "eq":
                        m = filter_ops.number_eq_mask(
                            vals, docs, valid, float(np.float32(filt.value)),
                            n_docs=cap,
                        )
                    else:
                        lo, hi, lx, hx = nf.committed.filter_bounds(filt)
                        m = filter_ops.number_range_mask(
                            vals, docs, valid, float(np.float32(lo)),
                            float(np.float32(hi)), bool(lx), bool(hx),
                            n_docs=cap,
                        )
                unc = nf.uncommitted.filter_docs(filt) if not nf.uncommitted.is_empty else set()
                m = self._with_uncommitted(m, unc)
            elif isinstance(filt, StringFilter):
                if f.type != ValueType.STRING:
                    raise ValueError(f'"{field_name}" is not a string field')
                kf = self._keyword[fid]
                wanted_vals = (filt.value,) if filt.op == "eq" else filt.value
                wanted_ids = [
                    kf.committed.id_of(v)
                    for v in wanted_vals
                    if kf.committed.id_of(v) is not None
                ]
                if wanted_ids and not kf.committed.is_empty:
                    wanted = np.full(max(len(wanted_vals), 1), -1.0, np.float32)
                    wanted[: len(wanted_ids)] = wanted_ids
                    kw_plane = self._device.keyword_dense_plane(kf.committed, cap)
                    if kw_plane is not None:
                        m = filter_ops.value_set_mask_dense(
                            kw_plane, self._device.put(wanted)
                        )
                    else:
                        ids, docs, valid = self._device.keyword_arrays(kf.committed)
                        m = filter_ops.value_set_mask(
                            ids, docs, valid, self._device.put(wanted),
                            n_docs=cap,
                        )
                else:
                    m = torch.zeros(cap, dtype=torch.float32, device=self.device)
                unc = (
                    kf.uncommitted.filter_docs(filt)
                    if not kf.uncommitted.is_empty else set()
                )
                m = self._with_uncommitted(m, unc)
            elif isinstance(filt, BoolFilter):
                if f.type != ValueType.BOOL:
                    raise ValueError(f'"{field_name}" is not a bool field')
                bf = self._bool[fid]
                true_mask, has_mask = self._device.bool_arrays(bf.committed, cap)
                m = (true_mask if filt.value
                     else has_mask * (1.0 - true_mask))
                unc = bf.uncommitted.filter_docs(filt.value) if not bf.uncommitted.is_empty else set()
                m = self._with_uncommitted(m, unc)
            else:
                raise TypeError(f"unknown filter {filt!r}")
            mask = filter_ops.combine_masks(mask, m)
        return mask

    def _filter_candidates(self, where: Dict[str, Any]) -> Optional[np.ndarray]:
        """Host-side candidate doc ids when every filter is selective
        enough (number/string filters list their matches from the sorted
        columns; bool filters then mask the list). None = dense path."""
        lim = self.cfg.selective_filter_max
        if not where or lim <= 0:
            return None
        listable: List[np.ndarray] = []
        bool_filters: List[Tuple[int, Any]] = []
        for field_name, filt in where.items():
            fid = self.field_by_name.get(field_name)
            if fid is None:
                return None  # dense path raises the user-facing error
            f = self.fields[fid]
            if isinstance(filt, NumberFilter) and f.type == ValueType.NUMBER:
                nf = self._number[fid]
                c = nf.committed
                if filt.op == "eq":
                    a = int(np.searchsorted(c.vals, np.float32(filt.value), "left"))
                    z = int(np.searchsorted(c.vals, np.float32(filt.value), "right"))
                else:
                    lo, hi, lx, hx = c.filter_bounds(filt)
                    a = int(np.searchsorted(
                        c.vals, np.float32(lo), "right" if lx else "left"
                    ))
                    z = int(np.searchsorted(
                        c.vals, np.float32(hi), "left" if hx else "right"
                    ))
                unc = (
                    nf.uncommitted.filter_docs(filt)
                    if not nf.uncommitted.is_empty else set()
                )
                if (z - a) + len(unc) > lim:
                    return None
                ids = c.docs[a:z].astype(np.int64)
                if unc:
                    ids = np.concatenate(
                        [ids, np.fromiter(unc, np.int64, len(unc))]
                    )
                listable.append(np.unique(ids))
            elif isinstance(filt, StringFilter) and f.type == ValueType.STRING:
                kf = self._keyword[fid]
                c = kf.committed
                wanted = (filt.value,) if filt.op == "eq" else tuple(filt.value)
                parts: List[np.ndarray] = []
                total = 0
                for v in wanted:
                    vid = c.id_of(v)
                    if vid is None:
                        continue
                    a = int(np.searchsorted(c.ids, np.float32(vid), "left"))
                    z = int(np.searchsorted(c.ids, np.float32(vid), "right"))
                    total += z - a
                    if total > lim:
                        return None
                    parts.append(c.docs[a:z].astype(np.int64))
                unc = (
                    kf.uncommitted.filter_docs(filt)
                    if not kf.uncommitted.is_empty else set()
                )
                if total + len(unc) > lim:
                    return None
                if unc:
                    parts.append(np.fromiter(unc, np.int64, len(unc)))
                ids = np.concatenate(parts) if parts else np.zeros(0, np.int64)
                listable.append(np.unique(ids))
            elif isinstance(filt, BoolFilter) and f.type == ValueType.BOOL:
                bool_filters.append((fid, filt))
            else:
                return None
        if not listable:
            return None  # a bool-only filter has no cheap candidate list
        cand = listable[0]
        for ids in listable[1:]:
            cand = np.intersect1d(cand, ids, assume_unique=True)
        for fid, filt in bool_filters:
            if len(cand) == 0:
                break
            c = self._bool[fid].committed
            want = bool(filt.value)
            keep = np.zeros(len(cand), bool)
            inb = cand < len(c.has_mask)
            ci = cand[inb].astype(np.int64)
            if want:
                keep[inb] = c.true_mask[ci] > 0
            else:
                keep[inb] = (c.has_mask[ci] > 0) & (c.true_mask[ci] == 0)
            bu = self._bool[fid].uncommitted
            unc = bu.filter_docs(want) if not bu.is_empty else set()
            if unc:  # dense path unions committed and uncommitted matches
                keep |= np.isin(cand, np.fromiter(unc, np.int64, len(unc)))
            cand = cand[keep]
        if self.deleted and len(cand):
            cand = cand[~np.isin(
                cand, np.fromiter(self.deleted, np.int64, len(self.deleted)),
            )]
        alive = self._alive
        cand = cand[cand < len(alive)]
        cand = cand[alive[cand] > 0]
        if len(cand) > lim:
            return None
        return cand.astype(np.int32)

    def _selective_vector_rows(self, committed, cand: np.ndarray):
        """(rows, row_docs) of the candidate docs' vector rows, via a
        doc-sorted permutation cached on the committed index."""
        order = getattr(committed, "_sel_order", None)
        if order is None:
            order = np.argsort(committed.vec_docs, kind="stable").astype(np.int64)
            committed._sel_order = order
            committed._sel_docs = committed.vec_docs[order]
        sdocs = committed._sel_docs
        lo = np.searchsorted(sdocs, cand, "left")
        hi = np.searchsorted(sdocs, cand, "right")
        rows = order[flatten_ranges(lo, hi - lo)]
        row_docs = np.repeat(cand.astype(np.int64), hi - lo)
        return rows, row_docs

    def _committed_vector_scores_selective(
        self, committed, q_dev: torch.Tensor, cand: np.ndarray, cap: int
    ) -> torch.Tensor:
        rows, row_docs = self._selective_vector_rows(committed, cand)
        n = len(rows)
        if n == 0:
            return torch.zeros(cap, dtype=torch.float32, device=self.device)
        n_pad = bucket_pad(n, (256, 2048, 16384))
        r = np.zeros(n_pad, np.int32); r[:n] = rows
        d = np.zeros(n_pad, np.int32); d[:n] = row_docs
        v = np.zeros(n_pad, np.float32); v[:n] = 1.0
        vecs_dev, _, _ = self._device.vector_arrays(committed)
        put = self._device.put
        return vector_ops.selective_scores(
            vecs_dev, put(r), put(d), put(v), q_dev, n_docs=cap,
        )

    def _with_uncommitted(self, mask: torch.Tensor, docs: Set[int]) -> torch.Tensor:
        if not docs:
            return mask
        idx, vals = self._padded_scatter(sorted(docs), [1.0] * len(docs))
        # out of place: ``mask`` may be a cached device array
        return mask.scatter_reduce(0, idx.long(), vals, "amax")

    def _padded_scatter_np(
        self, docs: Sequence[int], vals: Sequence[float]
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(docs)
        if n and max(docs) >= self.capacity:
            raise _CapacityMoved(f"window doc {max(docs)} is past "
                                 f"{self.capacity}")
        n_pad = bucket_pad(max(n, 1), self.cfg.posting_bucket_steps)
        idx = np.zeros(n_pad, np.int32)
        idx[:n] = docs
        v = np.zeros(n_pad, np.float32)
        v[:n] = vals
        return idx, v

    def _padded_scatter(
        self, docs: Sequence[int], vals: Sequence[float]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        idx, v = self._padded_scatter_np(docs, vals)
        return self._device.put(idx), self._device.put(v)

    def _scatter_add(self, scores: torch.Tensor, out: Dict[int, float]):
        idx, vals = self._padded_scatter(list(out.keys()), list(out.values()))
        return scores.index_add(0, idx.long(), vals)

    # -- full-text (reference: collection.rs:903-955) -------------------------

    def _string_properties(self, properties: Optional[List[str]]) -> List[int]:
        if properties is None:
            return [fid for fid, f in self.fields.items() if f.type == ValueType.STRING]
        out = []
        for name in properties:
            fid = self.field_by_name.get(name)
            if fid is None:
                raise ValueError(f"Unknown field name {name}")
            if self.fields[fid].type != ValueType.STRING:
                raise ValueError(f"Cannot search on non-string field {name}")
            out.append(fid)
        return out

    def _phrase_spans(self, token_spans, n_surf: int) -> np.ndarray:
        """Surface spans only (stems never drive phrase adjacency), at most
        32, padded to a bucket of (4, 16, 32) empty spans."""
        ph_only = token_spans[:n_surf]
        n_sp = bucket_pad(max(min(len(ph_only), 32), 1), (4, 16, 32))
        spans_a = np.zeros((n_sp, 2), np.int32)
        for si, (lo, hi) in enumerate(ph_only[:32]):
            spans_a[si] = (lo, hi)
        return spans_a

    def search_fulltext(
        self,
        term: str,
        properties: Optional[List[str]],
        boost: Dict[str, float],
        filter_mask: torch.Tensor,
        masked: bool = True,
    ) -> torch.Tensor:
        """Multi-dispatch fulltext scores f32[cap]: per committed field the
        posting scan (K1 over the aligned plan) and the phrase boost (K4),
        plus the host-scored uncommitted window."""
        cap = self.capacity
        if not term.strip():
            # empty term matches every alive, filter-passing doc
            return filter_mask.to(torch.float32)
        scores = torch.zeros(cap, dtype=torch.float32, device=self.device)
        put = self._device.put
        tokens_cache: Dict[str, Tuple[List[str], List[str]]] = {}
        for fid in self._string_properties(properties):
            f = self.fields[fid]
            locale = f.locale or self.default_locale
            cached = tokens_cache.get(locale)
            if cached is None:
                cached = query_expansion(get_parser(locale), term)
                tokens_cache[locale] = cached
            tokens, stems = cached
            if not tokens:
                continue
            field_boost = float(boost.get(f.name, 1.0))
            sf = self._string[fid]
            gi = sf.committed.global_info() + sf.uncommitted.global_info()
            phrase = len(tokens) > 1

            committed = sf.committed
            token_spans, n_surf = expanded_spans(committed.term_dict, tokens, stems)
            if token_spans:
                ts_host = committed.term_starts
                p_lo_list = [int(ts_host[lo]) for lo, hi in token_spans]
                p_len_list = [int(ts_host[hi] - ts_host[lo]) for lo, hi in token_spans]
                if sum(p_len_list) > 0:
                    d_docs, d_tf, d_ni, d_plens = self._device.string_arrays(committed)
                    # idf N is the COMBINED committed+uncommitted doc count
                    # (the reference's shared GlobalInfo, collection.rs:930-951)
                    scan_args = (
                        1.0 if phrase else field_boost,
                        float(np.float32(gi.avgdl)),
                        float(np.float32(gi.total_documents)),
                    )
                    # reference gate collection_read.py:1561-1565: the
                    # aligned plan (K1), always
                    need = bm25_ops.aligned_blocks_needed(p_len_list)
                    nb = bucket_pad(max(need, 1), bm25_ops.PLAN_BUCKETS)
                    sb_a, lo_a, hi_a = bm25_ops.build_block_plan_aligned(
                        p_lo_list, p_len_list, nb
                    )
                    raw = bm25_ops.bm25_scores_blocked_aligned(
                        d_docs, d_tf, d_ni, d_plens,
                        put(sb_a), put(lo_a), put(hi_a), *scan_args,
                        n_docs=cap, n_blocks=nb,
                    )
                    if phrase:
                        spans_a = put(self._phrase_spans(token_spans, n_surf))
                        # reference gate collection_read.py:1617-1619: the
                        # windowed contract (K4), always; K4 needs no
                        # doc ids, positions or windows once the bits and
                        # the per-doc bounds are built
                        tw, pbits, pbounds = (
                            self._device.phrase_stream_arrays(committed, cap)
                        )
                        boost_by_doc = bm25_ops.phrase_boost_docmajor_windowed(
                            None, None, tw, None, spans_a, field_boost,
                            n_docs=cap, W=0, wsub=0, bits=pbits,
                            bounds=pbounds,
                        )
                        raw = raw * boost_by_doc
                    if masked:
                        raw = raw * filter_mask
                    scores = scores + raw

            # uncommitted window on host
            if not sf.uncommitted.is_empty:
                host_out: Dict[int, float] = {}
                sf.uncommitted.search(
                    tokens, field_boost, gi, _WindowMask(_to_host(filter_mask)),
                    self.deleted, host_out, exact_tokens=stems,
                )
                if host_out:
                    scores = self._scatter_add(scores, host_out)
        return scores

    # -- vector (reference: collection.rs:957-1002) ---------------------------

    def _field_vec_dim(self, fid: int) -> int:
        vf = self._vector[fid]
        if not vf.committed.is_empty:
            return int(vf.committed.dimension)
        return int(vf.uncommitted.dimension)

    def _resolve_query_vec(self, model, term, ai_service, raw_vec):
        """L2-normalized query embedding: the raw client vector when given,
        the model forward otherwise."""
        q = (
            np.asarray(raw_vec, np.float32)
            if raw_vec is not None
            else ai_service.embed_query(model, [term])[0]
        )
        return q / max(float(np.linalg.norm(q)), 1e-12)

    def search_vector(
        self,
        term: str,
        ai_service,
        filter_mask: torch.Tensor,
        limit: int = 10,
        raw_vec=None,
        cand: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        cap = self.capacity
        scores = torch.zeros(cap, dtype=torch.float32, device=self.device)
        by_model: Dict[str, List[int]] = {}
        for fid, f in self.fields.items():
            if f.type == ValueType.EMBEDDING and f.model:
                by_model.setdefault(f.model, []).append(fid)
        matched_dim = False
        fm_host = None
        for model, fids in by_model.items():
            if raw_vec is not None:
                # score only the fields whose dimension fits the client vector
                fids = [f for f in fids if self._field_vec_dim(f) == len(raw_vec)]
                if not fids:
                    continue
                matched_dim = True
            qn = self._resolve_query_vec(model, term, ai_service, raw_vec)
            q_dev = self._device.put(np.asarray(qn, np.float32))
            for fid in fids:
                vf = self._vector[fid]
                if not vf.committed.is_empty:
                    # the selective gather scores bf16 rows: the int8 mode
                    # keeps only its codes on the card, so it stays dense
                    if cand is not None and self.cfg.vector_index == "exact":
                        from ..server import metrics as m

                        m.VECTOR_PATH.inc(path="selective")
                        scores = scores + self._committed_vector_scores_selective(
                            vf.committed, q_dev, cand, cap
                        )
                    else:
                        scores = scores + self._committed_vector_scores(
                            vf.committed, q_dev, filter_mask, cap, limit
                        )
                if not vf.uncommitted.is_empty:
                    if fm_host is None:
                        fm_host = _WindowMask(_to_host(filter_mask))
                    host_out: Dict[int, float] = {}
                    vf.uncommitted.search(qn, fm_host, self.deleted, host_out)
                    if host_out:
                        scores = self._scatter_add(scores, host_out)
        if raw_vec is not None and by_model and not matched_dim:
            dims = sorted(
                {self._field_vec_dim(f) for fids in by_model.values() for f in fids}
            )
            raise ValueError(
                f"query vector has dimension {len(raw_vec)}; collection "
                f"embedding fields have {dims}"
            )
        return scores

    def _committed_vector_scores(self, committed, q_dev: torch.Tensor,
                                 filter_mask: torch.Tensor, cap: int,
                                 limit: int) -> torch.Tensor:
        """Dense committed vector scores: IVF-PQ | IVF | PQ candidates
        scattered onto their docs | int8 product | exact bf16 product
        (reference ``_committed_vector_scores``). The ANN modes resolve
        their operands as the fused program does (``_fused_vector_args``);
        ``limit`` sizes their candidate count."""
        vmode, v_statics, v_ann, (vecs, docs, valid) = (
            self._fused_vector_args(committed, limit))
        if vmode in ANN_VMODES:
            from ..ops.hybrid import ann_vector_scores

            return ann_vector_scores(vmode, v_statics, v_ann, q_dev,
                                     n_docs=cap) * filter_mask
        if vmode == "int8":
            from ..ops.quant import int8_brute_force_scores

            codes, scales, docs, valid = v_ann
            return int8_brute_force_scores(
                codes, scales, docs, valid, q_dev, filter_mask, n_docs=cap
            )
        return vector_ops.brute_force_scores(
            vecs, docs, valid, q_dev, filter_mask, n_docs=cap,
            identity=v_statics[0],
        )

    # -- search entry (reference: collection.rs:684-781) ----------------------

    def search_scores(self, params: SearchParams, ai_service) -> torch.Tensor:
        filter_mask = self._filter_mask(params.where)
        # skip the mask multiply when nothing can be masked
        masked = bool(params.where) or bool(self.deleted)
        if params.mode == SearchModeKind.FULLTEXT:
            return self.search_fulltext(
                params.term, params.properties, params.boost, filter_mask,
                masked=masked,
            )
        cand = self._filter_candidates(params.where)
        if params.mode == SearchModeKind.VECTOR:
            return self.search_vector(
                params.term, ai_service, filter_mask, params.limit,
                raw_vec=params.vector, cand=cand,
            )
        ft = self.search_fulltext(
            params.term, params.properties, params.boost, filter_mask,
            masked=masked,
        )
        vec = self.search_vector(
            params.term, ai_service, filter_mask, params.limit, cand=cand
        )
        if params.fusion == HybridFusion.MINMAX:
            return fusion_ops.minmax_fuse(ft, vec)
        return fusion_ops.rrf_fuse(ft, vec)

    # -- sharded serving path (mesh mode; reference :2185-2816) ----------------
    #
    # With gpu.mesh_shape configured, queries run as the mesh programs of
    # parallel/sharded_engine.py over per-shard committed layouts: local
    # scoring on each shard's device (K1, K4, K2 + K3 or K6 once per shard),
    # per-shard top-k, one gathered merge on the mesh's first device. Flat
    # IVF and flat PQ stay on the single-device path (the reference keeps
    # them replicated); so do search_batch and the fused program, which run
    # with whole arrays on the mesh's first device.

    def _sharded_ctx(self):
        mesh = self._device.mesh
        S = self._device.n_shards
        local_cap = -(-self.capacity // S)
        return mesh, S, local_cap, local_cap * S

    def _use_sharded(self, params: SearchParams) -> bool:
        if self._device.mesh is None or self._device.n_shards < 2:
            return False
        if params.mode != SearchModeKind.FULLTEXT and self.cfg.vector_index in (
            "ivf", "pq",
        ):
            # flat PQ and plain IVF stay replicated; ivf_pq has its own
            # sharded layout (sharded_ivfpq_arrays)
            return False
        return True

    class _MaskAt:
        """Dict-backed stand-in for a dense host mask, valid only at the
        uncommitted window's doc ids (gathered from the sharded mask)."""

        __slots__ = ("m",)

        def __init__(self, mapping: Dict[int, float]) -> None:
            self.m = mapping

        def __getitem__(self, i) -> float:
            return self.m[int(i)]

    @staticmethod
    def _in_split(docs: List[int], ctx) -> None:
        """Raise _CapacityMoved for a window doc past the search's split."""
        if docs and max(docs) >= ctx[3]:
            raise _CapacityMoved(f"window doc {max(docs)} is past {ctx[3]}")

    def _host_mask_at(self, mask, docs, masked: bool, ctx):
        """A sharded mask's values at (few) global doc ids, without
        pulling [cap] to the host; None when nothing is masked."""
        from ..parallel import sharded_engine as se

        if not masked:
            return None
        doc_list = [int(d) for d in docs]
        if not doc_list:
            return self._MaskAt({})
        self._in_split(doc_list, ctx)
        vals = se.gather_values(ctx[0], mask, doc_list, ctx[2])
        return self._MaskAt({d: float(v) for d, v in zip(doc_list, vals)})

    def _scatter_window(self, scores, out: Dict[int, float], ctx):
        """Scatter a host-scored window {doc: value} onto the shards that
        own its docs (sharded_engine.scatter_add)."""
        from ..parallel import sharded_engine as se

        docs = list(out.keys())
        self._in_split(docs, ctx)
        return se.scatter_add(ctx[0], scores, docs, list(out.values()),
                              ctx[2])

    def _filter_mask_sharded(self, where: Dict[str, Any], ctx):
        from ..parallel import sharded_engine as se

        mesh, S, local_cap, cap_s = ctx
        mask = self._alive_mask_sharded(cap_s)
        for field_name, filt in where.items():
            fid = self.field_by_name.get(field_name)
            if fid is None:
                raise ValueError(f'Cannot filter by "{field_name}": unknown field')
            f = self.fields[fid]
            if isinstance(filt, NumberFilter):
                if f.type != ValueType.NUMBER:
                    raise ValueError(f'"{field_name}" is not a number field')
                nf = self._number[fid]
                vals, docs, valid = self._device.sharded_number_arrays(
                    nf.committed, local_cap
                )
                if filt.op == "eq":
                    m = se.number_eq_mask(mesh, vals, docs, valid,
                                          float(np.float32(filt.value)),
                                          local_cap)
                else:
                    lo, hi, lx, hx = nf.committed.filter_bounds(filt)
                    m = se.number_range_mask(
                        mesh, vals, docs, valid, float(np.float32(lo)),
                        float(np.float32(hi)), bool(lx), bool(hx), local_cap,
                    )
                unc = (
                    nf.uncommitted.filter_docs(filt)
                    if not nf.uncommitted.is_empty else set()
                )
            elif isinstance(filt, StringFilter):
                if f.type != ValueType.STRING:
                    raise ValueError(f'"{field_name}" is not a string field')
                kf = self._keyword[fid]
                wanted_vals = (filt.value,) if filt.op == "eq" else filt.value
                wanted_ids = [
                    kf.committed.id_of(v)
                    for v in wanted_vals
                    if kf.committed.id_of(v) is not None
                ]
                if wanted_ids and not kf.committed.is_empty:
                    ids, docs, valid = self._device.sharded_keyword_arrays(
                        kf.committed, local_cap
                    )
                    wanted = np.full(max(len(wanted_vals), 1), -1.0, np.float32)
                    wanted[: len(wanted_ids)] = wanted_ids
                    m = se.keyword_set_mask(mesh, ids, docs, valid, wanted,
                                            local_cap)
                else:
                    m = self._device.zeros_sharded(cap_s)
                unc = (
                    kf.uncommitted.filter_docs(filt)
                    if not kf.uncommitted.is_empty else set()
                )
            elif isinstance(filt, BoolFilter):
                if f.type != ValueType.BOOL:
                    raise ValueError(f'"{field_name}" is not a bool field')
                bf = self._bool[fid]
                true_mask, has_mask = self._device.sharded_bool_arrays(
                    bf.committed, cap_s
                )
                m = (true_mask if filt.value
                     else has_mask.map(lambda h, t: h * (1.0 - t), true_mask))
                unc = (
                    bf.uncommitted.filter_docs(filt.value)
                    if not bf.uncommitted.is_empty else set()
                )
            else:
                raise TypeError(f"unknown filter {filt!r}")
            if unc:
                m = self._scatter_window(m, dict.fromkeys(unc, 1.0),
                                         ctx).map(torch.clamp, None, 1.0)
            mask = mask.map(filter_ops.combine_masks, m)
        return mask

    def _fulltext_scores_sharded(
        self,
        term: str,
        properties: Optional[List[str]],
        boost: Dict[str, float],
        filter_mask,
        masked: bool,
        ctx,
    ):
        """Sharded fulltext scores [S][local_cap]: per committed field, K1
        once per shard over the shard's aligned block plan (from the
        per-shard CSR term offsets) and, for phrases, K4 once per shard
        over the shard's phrase stream; the host-scored uncommitted window
        scatters onto the shards that own its docs."""
        from ..parallel import sharded_engine as se

        mesh, S, local_cap, cap_s = ctx
        if not term.strip():
            return filter_mask.map(lambda m: m.to(torch.float32))
        scores = self._device.zeros_sharded(cap_s)
        tokens_cache: Dict[str, Tuple[List[str], List[str]]] = {}
        for fid in self._string_properties(properties):
            f = self.fields[fid]
            locale = f.locale or self.default_locale
            cached = tokens_cache.get(locale)
            if cached is None:
                cached = query_expansion(get_parser(locale), term)
                tokens_cache[locale] = cached
            tokens, stems = cached
            if not tokens:
                continue
            field_boost = float(boost.get(f.name, 1.0))
            sf = self._string[fid]
            gi = sf.committed.global_info() + sf.uncommitted.global_info()
            phrase = len(tokens) > 1

            committed = sf.committed
            token_spans, n_surf = expanded_spans(
                committed.term_dict, tokens, stems
            )
            if token_spans:
                ts_global = committed.term_starts
                g_total = int(
                    sum(ts_global[hi] - ts_global[lo] for lo, hi in token_spans)
                )
                if g_total > 0:
                    d_docs, d_tf, d_ni, d_plens, ts_sh = (
                        self._device.sharded_string_arrays(committed, local_cap)
                    )
                    # per-shard aligned block plans (host, O(tokens * shards))
                    lo_sh = [[int(ts_sh[si, lo]) for lo, hi in token_spans]
                             for si in range(S)]
                    len_sh = [[int(ts_sh[si, hi] - ts_sh[si, lo])
                               for lo, hi in token_spans] for si in range(S)]
                    need = max(bm25_ops.aligned_blocks_needed(lens)
                               for lens in len_sh)
                    nb = bucket_pad(max(need, 1), bm25_ops.PLAN_BUCKETS)
                    plans = np.zeros((S, 3, nb), np.int32)
                    for si in range(S):
                        plans[si] = bm25_ops.build_block_plan_aligned(
                            lo_sh[si], len_sh[si], nb)
                    raw = se.blocked_bm25(
                        mesh, d_docs, d_tf, d_ni, d_plens, plans,
                        1.0 if phrase else field_boost,
                        float(np.float32(gi.avgdl)),
                        float(np.float32(gi.total_documents)),
                        filter_mask, local_cap, nb, masked,
                    )
                    if phrase:
                        # surface spans only: stems never drive phrase
                        # adjacency (query_expansion contract)
                        terms, bits, bounds = self._device.sharded_phrase_stream(
                            committed, local_cap)
                        boost_by_doc = se.blocked_phrase_boost(
                            mesh, terms, bits, bounds,
                            self._phrase_spans(token_spans, n_surf),
                            field_boost, local_cap,
                        )
                        raw = raw.map(torch.mul, boost_by_doc)
                    scores = scores.map(torch.add, raw)

            if not sf.uncommitted.is_empty:
                host_out: Dict[int, float] = {}
                # list(): the live window's ids copied at once (iterating
                # its key view races with inserts)
                fm = self._host_mask_at(
                    filter_mask, list(sf.uncommitted.doc_lens), masked, ctx)
                sf.uncommitted.search(
                    tokens, field_boost, gi, fm, self.deleted, host_out,
                    exact_tokens=stems,
                )
                if host_out:
                    scores = self._scatter_window(scores, host_out, ctx)
        return scores

    def _vector_scores_sharded(
        self,
        term: str,
        ai_service,
        filter_mask,
        ctx,
        raw_vec=None,
        limit: int = 10,
    ):
        from ..parallel import sharded_engine as se

        mesh, S, local_cap, cap_s = ctx
        scores = self._device.zeros_sharded(cap_s)
        by_model: Dict[str, List[int]] = {}
        for fid, f in self.fields.items():
            if f.type == ValueType.EMBEDDING and f.model:
                by_model.setdefault(f.model, []).append(fid)
        matched_dim = False
        for model, fids in by_model.items():
            if raw_vec is not None:
                fids = [f for f in fids if self._field_vec_dim(f) == len(raw_vec)]
                if not fids:
                    continue
                matched_dim = True
            qn = np.asarray(
                self._resolve_query_vec(model, term, ai_service, raw_vec),
                np.float32)
            for fid in fids:
                vf = self._vector[fid]
                if not vf.committed.is_empty:
                    c = vf.committed
                    if (self.cfg.vector_index == "ivf_pq" and c.has_ivf
                            and c.has_pq):
                        (codes, books, vecs, cents, lists, lens, docs,
                         rot) = self._device.sharded_ivfpq_arrays(c, local_cap)
                        expand = c.tuned_expand or self.cfg.ivf_candidate_expand
                        cand_k = min(max(limit, 10) * expand, c.n_vectors)
                        nprobe = min(c.tuned_nprobe or self.cfg.ivf_nprobe,
                                     int(lists.shape[0]))
                        raw = se.ivfpq_scores(
                            mesh, codes, books, vecs, cents, lists, lens,
                            docs, rot, qn, filter_mask, local_cap, nprobe,
                            cand_k, expand, c.pq_residual,
                        )
                    elif self.cfg.vector_index == "int8":
                        codes, scales, docs, valid = (
                            self._device.sharded_vector_int8_arrays(
                                c, local_cap))
                        raw = se.vector_scores_int8(
                            mesh, codes, scales, docs, valid, qn,
                            filter_mask, local_cap)
                    else:
                        vecs, docs, valid = self._device.sharded_vector_arrays(
                            c, local_cap)
                        raw = se.vector_scores(mesh, vecs, docs, valid, qn,
                                               filter_mask, local_cap)
                    scores = scores.map(torch.add, raw)
                if not vf.uncommitted.is_empty:
                    host_out: Dict[int, float] = {}
                    fm = self._host_mask_at(
                        filter_mask, {d for d, _ in vf.uncommitted.entries},
                        True, ctx)
                    vf.uncommitted.search(qn, fm, self.deleted, host_out)
                    if host_out:
                        scores = self._scatter_window(scores, host_out, ctx)
        if raw_vec is not None and by_model and not matched_dim:
            # the single-device path's error: a silent empty result would
            # hide a malformed client vector
            dims = sorted(
                {self._field_vec_dim(f) for fids in by_model.values()
                 for f in fids}
            )
            raise ValueError(
                f"query vector has dimension {len(raw_vec)}; collection "
                f"embedding fields have {dims}"
            )
        return scores

    def _search_sharded(
        self, params: SearchParams, ai_service
    ) -> Tuple[List[Tuple[int, float]], int, Optional[Dict[str, FacetResult]]]:
        from ..parallel import sharded_engine as se

        # one split of the doc space for the whole search
        ctx = self._sharded_ctx()
        mesh, S, local_cap, cap_s = ctx
        filter_mask = self._filter_mask_sharded(params.where, ctx)
        masked = bool(params.where) or bool(self.deleted)
        k = min(params.limit, cap_s)
        matched_sh = None
        positive = lambda x: (x > 0).to(torch.float32)  # noqa: E731
        if params.mode == SearchModeKind.FULLTEXT:
            ft = self._fulltext_scores_sharded(
                params.term, params.properties, params.boost, filter_mask,
                masked, ctx,
            )
            out = se.topk_with_count(mesh, ft, k, local_cap)
            if params.facets:
                matched_sh = ft.map(positive)
        elif params.mode == SearchModeKind.VECTOR:
            fast = self._sharded_vector_fast(params, ai_service, ctx)
            if fast is not None:
                return fast
            vec = self._vector_scores_sharded(
                params.term, ai_service, filter_mask, ctx,
                raw_vec=params.vector, limit=params.limit,
            )
            out = se.topk_with_count(mesh, vec, k, local_cap)
            if params.facets:
                matched_sh = vec.map(positive)
        else:
            ft = self._fulltext_scores_sharded(
                params.term, params.properties, params.boost, filter_mask,
                masked, ctx,
            )
            vec = self._vector_scores_sharded(
                params.term, ai_service, filter_mask, ctx, limit=params.limit
            )
            if params.fusion == HybridFusion.MINMAX:
                out = se.minmax_topk(mesh, ft, vec, k, local_cap)
            else:
                out = se.rrf_topk(mesh, ft, vec, k, se.rrf_candidate_count(k),
                                  local_cap)
            if params.facets:
                # fused scores are > 0 exactly where either modality
                # matched (both fusions are over non-negative scores)
                matched_sh = ft.map(
                    lambda a, b: ((a > 0) | (b > 0)).to(torch.float32), vec)
        facets = (
            self.compute_facets_sharded(matched_sh, params.facets, ctx)
            if matched_sh is not None
            else None
        )
        vals, gids, count = (_to_host(t) for t in out)
        ranked = [(int(d), float(s)) for d, s in zip(gids, vals) if s > 0.0]
        return ranked, int(count), facets

    def _sharded_vector_fast(
        self, params: SearchParams, ai_service, ctx
    ) -> Optional[Tuple[List[Tuple[int, float]], int, None]]:
        """Mesh vector-mode fast path: the fused kNN on each shard (K2 +
        K3, or K6 for chunked docs) + the O(S*k) merge
        (``sharded_engine.vector_topk_fast``), never building the dense
        sharded [cap] score array. Taken when nothing downstream needs
        dense scores (no facets, filters or deletes) and the committed
        segment is the whole corpus (empty uncommitted window), on any
        device: the reference's backend and ``use_pallas`` gates are gone,
        as on the single-device path. Everything else keeps the dense
        sharded pipeline."""
        if (
            params.facets
            or params.where
            or self.deleted
            or self.cfg.vector_index != "exact"
            or params.limit > 128
        ):
            return None
        emb = [
            fid for fid, f in self.fields.items()
            if f.type == ValueType.EMBEDDING and f.model
        ]
        if len(emb) != 1:
            return None
        vf = self._vector[emb[0]]
        c = vf.committed
        if c.is_empty or not vf.uncommitted.is_empty:
            return None
        single = getattr(c, "_single_vec_per_doc", None)
        if single is None:
            single = len(np.unique(c.vec_docs)) == c.n_vectors
            c._single_vec_per_doc = single
        if not single and not _multivec_fast_eligible(c):
            return None
        from ..parallel import sharded_engine as se
        from ..server import metrics as m

        mesh, S, local_cap, cap_s = ctx
        qn = self._resolve_query_vec(
            self.fields[emb[0]].model, params.term, ai_service, params.vector
        )
        if params.vector is not None and len(qn) != c.dimension:
            raise ValueError(
                f"query vector has dimension {len(qn)}; collection "
                f"embedding fields have [{c.dimension}]"
            )
        vecs, rowdocs, _valid = self._device.sharded_vector_arrays(c, local_cap)
        p_l = int(vecs.shape[0])
        bn = 2048
        while p_l % bn:
            bn //= 2
        k = (params.limit if params.limit <= 16
             else bucket_pad(params.limit, (16, 128)))
        k = min(k, local_cap)
        if single:
            rowstarts, m_max = None, 1
        else:
            rowstarts = self._device.sharded_vector_rowstarts(c, local_cap)
            m_max = 1 << max(0, int(np.ceil(np.log2(c._max_chunks))))
        vals, gids, count = se.vector_topk_fast(
            mesh, vecs, rowdocs, rowstarts, np.asarray(qn, np.float32),
            local_cap, k, bn, m_max, p_l, not single,
        )
        m.VECTOR_PATH.inc(path="fast_sharded")
        ranked = [
            (int(d), float(s))
            for d, s in zip(_to_host(gids), _to_host(vals)) if s > 0.0
        ][: params.limit]
        return ranked, int(count), None

    def compute_facets_sharded(self, matched, facet_defs: Dict[str, Any],
                               ctx) -> Dict[str, FacetResult]:
        """Facets over the mesh: per-shard masked reductions summed on the
        mesh's first device (sharded_engine's facet programs), the dense
        compute_facets restated over shard-local layouts. Uncommitted
        windows overlay on the host, reading the matched mask only at
        their (few) doc ids."""
        from ..parallel import sharded_engine as se

        mesh, S, local_cap, cap_s = ctx
        out: Dict[str, FacetResult] = {}
        for field_name, fdef in facet_defs.items():
            fid = self.field_by_name.get(field_name)
            if fid is None:
                raise ValueError(f"unknown facet field {field_name}")
            ftype = self.fields[fid].type
            if isinstance(fdef, NumberFacetDefinition):
                if ftype != ValueType.NUMBER:
                    raise ValueError(
                        f'"{field_name}" is not a number field (facet shape'
                        " does not match the field type)"
                    )
                nf = self._number[fid]
                lows = np.asarray([float(r.low) for r in fdef.ranges],
                                  np.float32)
                highs = np.asarray([float(r.high) for r in fdef.ranges],
                                   np.float32)
                vals, docs, valid = self._device.sharded_number_arrays(
                    nf.committed, local_cap)
                counts = _to_host(se.number_facet_counts(
                    mesh, vals, docs, valid, lows, highs, matched, local_cap,
                )).copy()
                if not nf.uncommitted.is_empty:
                    pairs = list(nf.uncommitted.pairs)
                    mk = self._host_mask_at(
                        matched, {d for _, d in pairs}, True, ctx)
                    for i, r in enumerate(fdef.ranges):
                        for v, d in pairs:
                            if float(r.low) <= v <= float(r.high) and mk[d] > 0:
                                counts[i] += 1
                values = {r.key: int(c) for r, c in zip(fdef.ranges, counts)}
                out[field_name] = FacetResult(count=len(values), values=values)
            elif isinstance(fdef, StringFacetDefinition):
                if ftype != ValueType.STRING:
                    raise ValueError(
                        f'"{field_name}" is not a string field (facet shape'
                        " does not match the field type)"
                    )
                kf = self._keyword[fid]
                agg: Dict[str, int] = {}
                if not kf.committed.is_empty:
                    ids, docs, valid = self._device.sharded_keyword_arrays(
                        kf.committed, local_cap)
                    counts = _to_host(se.keyword_facet_counts(
                        mesh, ids, docs, valid, matched,
                        kf.committed.n_values))
                    for vid, c in enumerate(counts):
                        if c > 0:
                            agg[kf.committed.values[vid]] = int(c)
                if not kf.uncommitted.is_empty:
                    pairs = list(kf.uncommitted.pairs)
                    mk = self._host_mask_at(
                        matched, {d for _, d in pairs}, True, ctx)
                    for v, d in pairs:
                        if mk[d] > 0:
                            agg[v] = agg.get(v, 0) + 1
                top = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))[
                    : fdef.limit
                ]
                out[field_name] = FacetResult(count=len(agg), values=dict(top))
            elif isinstance(fdef, BoolFacetDefinition):
                if ftype != ValueType.BOOL:
                    raise ValueError(
                        f'"{field_name}" is not a bool field (facet shape'
                        " does not match the field type)"
                    )
                bf = self._bool[fid]
                true_mask, has_mask = self._device.sharded_bool_arrays(
                    bf.committed, cap_s)
                tc, fc = _to_host(se.bool_facet_counts(
                    mesh, true_mask, has_mask, matched)).tolist()
                if not bf.uncommitted.is_empty:
                    with bf.uncommitted._lk:
                        tdocs = list(bf.uncommitted.true_docs)
                        fdocs = list(bf.uncommitted.false_docs)
                    mk = self._host_mask_at(matched, tdocs + fdocs, True, ctx)
                    tc += sum(1 for d in tdocs if mk[d] > 0)
                    fc += sum(1 for d in fdocs if mk[d] > 0)
                values = {}
                if fdef.true:
                    values["true"] = int(tc)
                if fdef.false:
                    values["false"] = int(fc)
                out[field_name] = FacetResult(count=len(values), values=values)
        return out

    # -- batched serving (reference: collection_read.py:1867-2183) -----------

    def search_vector_batch(
        self,
        terms: List[str],
        ai_service,
        filter_mask: torch.Tensor,
        cand: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """[B, cap] vector scores for a coalesced query batch (one corpus
        product for all B queries). The batch shares one filter (the
        batcher keys on it), so a selective candidate set applies to
        every row."""
        cap = self.capacity
        scores = torch.zeros(len(terms), cap, dtype=torch.float32,
                             device=self.device)
        put = self._device.put
        by_model: Dict[str, List[int]] = {}
        for fid, f in self.fields.items():
            if f.type == ValueType.EMBEDDING and f.model:
                by_model.setdefault(f.model, []).append(fid)
        fm_host = None
        for model, fids in by_model.items():
            tracing.phase("search_batch.embed", n=len(terms))
            q = ai_service.embed_query(model, terms)                # [B, D]
            tracing.phase("search_batch.dispatch")
            qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
            q_dev = put(np.asarray(qn, np.float32))
            for fid in fids:
                vf = self._vector[fid]
                if not vf.committed.is_empty:
                    if cand is not None and self.cfg.vector_index == "exact":
                        rows, row_docs = self._selective_vector_rows(
                            vf.committed, cand
                        )
                        n = len(rows)
                        n_pad = bucket_pad(max(n, 1), (256, 2048, 16384))
                        r = np.zeros(n_pad, np.int32); r[:n] = rows
                        dd = np.zeros(n_pad, np.int32); dd[:n] = row_docs
                        v = np.zeros(n_pad, np.float32); v[:n] = 1.0
                        vecs, _, _ = self._device.vector_arrays(vf.committed)
                        scores = scores + vector_ops.selective_scores_batch(
                            vecs, put(r), put(dd), put(v), q_dev, n_docs=cap,
                        )
                    else:
                        # the exact product, whatever the index (the
                        # reference's; read_side batches vector modes of
                        # exact indexes only)
                        vecs, docs, valid = self._device.vector_rows(
                            vf.committed
                        )
                        scores = scores + vector_ops.brute_force_scores_batch(
                            vecs, docs, valid, q_dev, filter_mask, n_docs=cap,
                            identity=_vec_docs_identity(vf.committed),
                        )
                if not vf.uncommitted.is_empty:
                    if fm_host is None:
                        fm_host = _WindowMask(_to_host(filter_mask))
                    for row, term_q in enumerate(qn):
                        host_out: Dict[int, float] = {}
                        vf.uncommitted.search(term_q, fm_host, self.deleted,
                                              host_out)
                        if host_out:
                            scores[row] = self._scatter_add(scores[row], host_out)
        return scores

    def search_fulltext_batch(
        self, terms: List[str], boost: Dict[str, float],
        filter_mask: torch.Tensor,
    ) -> torch.Tensor:
        """[B, cap] BM25 scores for a coalesced batch through the span
        scorer (committed segments; uncommitted windows scored host-side
        per row, as in the single-query path)."""
        cap = self.capacity
        scores = torch.zeros(len(terms), cap, dtype=torch.float32,
                             device=self.device)
        put = self._device.put
        fm_host = None
        for fid in self._string_properties(None):
            f = self.fields[fid]
            parser = get_parser(f.locale or self.default_locale)
            expansions = [query_expansion(parser, t) for t in terms]
            field_boost = float(boost.get(f.name, 1.0))
            sf = self._string[fid]
            committed = sf.committed
            gi = committed.global_info() + sf.uncommitted.global_info()
            span_pairs = [
                expanded_spans(committed.term_dict, toks, stems)
                for toks, stems in expansions
            ]
            span_rows = [spans for spans, _ in span_pairs]
            surf_rows = [spans[:ns] for spans, ns in span_pairs]
            ts_host = committed.term_starts
            g_totals = [
                int(sum(ts_host[hi] - ts_host[lo] for lo, hi in row))
                for row in span_rows
            ]
            # Rows group by (phrase, own g bucket, own pp bucket): phrase is
            # per row (a single-token query batched with a multi-token one
            # gets no position boost), and a light query never pays a
            # heavy one's posting budget
            if max(g_totals, default=0) > 0:
                max_tok = 32
                d_docs, d_tf, d_ni, d_plens = self._device.string_arrays(
                    committed
                )
                groups: Dict[Tuple[bool, int, int], List[int]] = {}
                for row, (tokens, _stems) in enumerate(expansions):
                    if g_totals[row] <= 0:
                        continue
                    phrase = len(tokens) > 1
                    g_budget = bucket_pad(g_totals[row],
                                          self.cfg.budget_bucket_steps)
                    if phrase:
                        # positions budget over SURFACE spans only: the
                        # phrase boost never reads stem spans
                        pp_total = int(sum(
                            committed.pos_starts[ts_host[hi]]
                            - committed.pos_starts[ts_host[lo]]
                            for lo, hi in surf_rows[row]
                        ))
                        pp_budget = bucket_pad(max(pp_total, 1),
                                               self.cfg.budget_bucket_steps)
                    else:
                        pp_budget = 1
                    groups.setdefault((phrase, g_budget, pp_budget),
                                      []).append(row)
                for (phrase, g_budget, pp_budget), rows in sorted(groups.items()):
                    d_tstarts, d_pstarts, d_pos = self._device.span_arrays(
                        committed, phrase
                    )
                    # memory guard: at most _BATCH_SLOT_BUDGET gathered
                    # postings per call
                    chunk = max(1, self._BATCH_SLOT_BUDGET // g_budget)
                    for c0 in range(0, len(rows), chunk):
                        rows_c = rows[c0: c0 + chunk]
                        spans_b = np.zeros((len(rows_c), max_tok, 2), np.int32)
                        ph_spans_b = np.zeros_like(spans_b)
                        for i, r in enumerate(rows_c):
                            spans = span_rows[r][:max_tok]
                            if spans:
                                spans_b[i, : len(spans)] = spans
                            surf = surf_rows[r][:max_tok]
                            if surf:
                                ph_spans_b[i, : len(surf)] = surf
                        sub = bm25_ops.bm25_scores_from_spans_batch(
                            d_tstarts, d_docs, d_tf, d_ni, d_plens, d_pstarts,
                            d_pos, put(spans_b), field_boost, filter_mask,
                            float(np.float32(gi.avgdl)),
                            # the combined committed + uncommitted N (the
                            # reference's shared GlobalInfo)
                            float(np.float32(gi.total_documents)),
                            n_docs=cap, g_budget=g_budget,
                            pp_budget=pp_budget, phrase=phrase,
                            phrase_spans_b=put(ph_spans_b),
                        )
                        ridx = put(np.asarray(rows_c, np.int64))
                        scores = scores.index_add(0, ridx, sub)
            if not sf.uncommitted.is_empty:
                if fm_host is None:
                    fm_host = _WindowMask(_to_host(filter_mask))
                for row, (tokens, stems) in enumerate(expansions):
                    host_out: Dict[int, float] = {}
                    sf.uncommitted.search(
                        tokens, field_boost, gi, fm_host, self.deleted,
                        host_out, exact_tokens=stems,
                    )
                    if host_out:
                        scores[row] = self._scatter_add(scores[row], host_out)
        return scores

    # Per-call cap on the span scorer's gathered postings: B * g_budget
    # slots of intermediates. Larger groups split into chunks.
    _BATCH_SLOT_BUDGET = 32 * 1024 * 1024

    # Per-chunk cap on the batched fused program's dense intermediates:
    # each chunk holds b * capacity f32 scores per modality (64M slots,
    # 256 MB per modality)
    _BATCH_DENSE_SLOTS = 64 * 1024 * 1024

    def search_batch(
        self, params_list: List[SearchParams], ai_service
    ) -> List[Tuple[List[Tuple[int, float]], int]]:
        """Batched search of compatible queries (same mode, filters, boost
        and fusion; no facets): one device program scores the batch, from
        one pinned view of the reader (``_pinned``).
        Returns [(ranked [(doc_id, score)], match count)] per query.

        Traced (``utils/tracing``): one ``search_batch`` span with its
        ``route`` and ``chunks``, tiled by the phases ``search_batch.embed``,
        ``.plan``, ``.dispatch`` (one a chunk's device program), ``.sync``
        and ``.reply``."""
        with tracing.span("search_batch", profile=True, phased=True,
                          n=len(params_list)):
            tracing.phase("search_batch.plan")
            return self._pinned(self._search_batch, params_list, ai_service)

    def _search_batch(self, params_list: List[SearchParams], ai_service):
        if not params_list:
            return []
        from ..server import metrics as m

        p0 = params_list[0]
        if (p0.mode != SearchModeKind.FULLTEXT
                and self.cfg.vector_index in ANN_VMODES):
            # an ANN index scores each query on its own candidates, which
            # the batch's corpus product cannot give: rows one by one
            # (read_side batches vector modes of exact indexes only)
            tracing.annotate(route="ann_rows")
            m.VECTOR_PATH.inc(path="batch_ann_rows")
            out_ann = []
            for p in params_list:
                ranked, count, _ = self.search(p, ai_service)
                out_ann.append((ranked, count))
            return out_ann
        if len(params_list) == 1 and self._vector_fast_field(p0) is None:
            # a lone query gains nothing from the batch program: the
            # single-query fused program serves it
            helig = self._hybrid_fused_eligible(p0)
            if helig is not None:
                tracing.annotate(route="fused_" + helig[0], chunks=1)
                m.VECTOR_PATH.inc(path="batch_fused_" + helig[0])
                ranked, count, _ = self._search_hybrid_fused(
                    p0, ai_service, *helig
                )
                return [(ranked, count)]
        # phrase rows take the single-query path (K4 costs the same per
        # row either way); read_side._batchable applies the same policy
        if p0.mode != SearchModeKind.VECTOR and any(
            len(p.term.split()) > 1 for p in params_list
        ):
            tracing.annotate(route="phrase_split")
            out_mixed: List[Optional[Tuple[List[Tuple[int, float]], int]]] = (
                [None] * len(params_list)
            )
            plain: List[int] = []
            for i, p in enumerate(params_list):
                if len(p.term.split()) > 1:
                    ranked, count, _ = self.search(p, ai_service)
                    out_mixed[i] = (ranked, count)
                else:
                    plain.append(i)
            if plain:
                sub = self.search_batch(
                    [params_list[i] for i in plain], ai_service
                )
                for i, r in zip(plain, sub):
                    out_mixed[i] = r
            return out_mixed  # every slot filled above
        if (
            p0.mode == SearchModeKind.VECTOR
            and all(p.vector is None for p in params_list)
            and max(p.limit for p in params_list) <= 128
        ):
            fast_fid = self._vector_fast_field(p0)
            if fast_fid is not None:
                tracing.annotate(route="knn_fast", chunks=1)
                m.VECTOR_PATH.inc(path="batch_knn_fast")
                return self._search_batch_vector_topk_fast(
                    params_list, ai_service, fast_fid
                )
        # the batched fused program: one committed string field at most,
        # no live windows, at most one number filter, exact vectors
        helig = self._hybrid_fused_eligible(p0)
        if (
            helig is not None
            and (helig[0] == "fulltext" or self.cfg.vector_index == "exact")
            and len(helig[1]) <= 1
            and not helig[5]
            and len(helig[3]) <= 1
            and all(k in ("range", "eq") for k, _f, _p in helig[3])
            and all(
                not p.facets
                and p.limit <= 1024
                and p.vector is None
                and (p0.mode == SearchModeKind.VECTOR or p.term.strip())
                for p in params_list
            )
        ):
            mode, sfids, vfid, filts, _facs, _live = helig
            nf = (filts[0][1], filts[0][2]) if filts else None
            tracing.annotate(route="fused_" + mode)
            m.VECTOR_PATH.inc(path="batch_fused_" + mode)
            return self._search_batch_hybrid_fused(
                params_list, ai_service, mode,
                sfids[0] if sfids else None, vfid, nf,
            )
        tracing.annotate(route="generic")
        filter_mask = self._filter_mask(p0.where)
        terms = [p.term for p in params_list]
        cand = (
            self._filter_candidates(p0.where)
            if p0.mode != SearchModeKind.FULLTEXT else None
        )
        # the per-mode scorers plan and enqueue by turns (and embed:
        # search_vector_batch opens its own phases)
        tracing.phase("search_batch.dispatch")
        if p0.mode == SearchModeKind.VECTOR:
            scores = self.search_vector_batch(terms, ai_service, filter_mask,
                                              cand=cand)
        elif p0.mode == SearchModeKind.FULLTEXT:
            scores = self.search_fulltext_batch(terms, p0.boost, filter_mask)
        else:
            ft = self.search_fulltext_batch(terms, p0.boost, filter_mask)
            vec = self.search_vector_batch(terms, ai_service, filter_mask,
                                           cand=cand)
            if p0.fusion == HybridFusion.MINMAX:
                scores = torch.stack([fusion_ops.minmax_fuse(f, v)
                                      for f, v in zip(ft, vec)])
            else:
                scores = torch.stack([fusion_ops.rrf_fuse(f, v)
                                      for f, v in zip(ft, vec)])
        k = min(max(p.limit for p in params_list), self.capacity)
        vals_t, idx_t = topk_ops.topk_stable(scores, k)
        counts_t = torch.sum(scores > 0, dim=1)
        tracing.phase("search_batch.sync")
        vals, idx, counts = _to_host(vals_t), _to_host(idx_t), _to_host(counts_t)
        tracing.phase("search_batch.reply")
        out = []
        for row, p in enumerate(params_list):
            ranked = [
                (int(d), float(s))
                for d, s in zip(idx[row][: p.limit], vals[row][: p.limit])
                if s > 0.0
            ]
            out.append((ranked, int(counts[row])))
        return out

    # -- fused kNN (K2 + K3 | K5 | K6) -----------------------------------------

    def _vector_fast_field(self, params: SearchParams) -> Optional[int]:
        """The fused kNN (ops/knn.py) serves a query directly when nothing
        downstream needs dense scores: pure vector mode, no filters or
        facets, few deletes, one embedding field, committed-dominant.
        Single-vector docs take K2 + K3 (exact) or K5 (int8); multi-vector
        (chunked) docs take K6, exact mode only, when their rows are
        doc-ascending with at most 64 per doc. Returns that field id, or
        None for the general path. The reference's backend gate
        (collection_read.py:2847-2850) is gone: this branch is taken on any
        device, whatever ``use_pallas`` says."""
        if (
            params.mode != SearchModeKind.VECTOR
            or params.facets
            or params.where
            # a small tombstone window is corrected host-side exactly
            or len(self.deleted) > 64
            # the ANN indexes keep their own candidate structures
            or self.cfg.vector_index not in ("exact", "int8")
            # phase 2 gathers k*SUB rows per query: deep limits stay dense
            or params.limit > 128
        ):
            return None
        emb = [
            fid for fid, f in self.fields.items()
            if f.type == ValueType.EMBEDDING and f.model
        ]
        if len(emb) != 1:
            return None
        vf = self._vector[emb[0]]
        if vf.committed.is_empty or len(vf.uncommitted.entries) > 10_000:
            return None
        c = vf.committed
        if c.n_vectors < 4096:
            return None  # small corpora: the dense path is already cheap
        single = getattr(c, "_single_vec_per_doc", None)
        if single is None:
            single = len(np.unique(c.vec_docs)) == c.n_vectors
            c._single_vec_per_doc = single
        if single:
            return emb[0]
        # multi-vector docs: K6 has no int8 variant, as in the reference
        if self.cfg.vector_index != "exact":
            return None
        return emb[0] if _multivec_fast_eligible(c) else None

    def _vector_topk_fast_core(
        self, params_list: List[SearchParams], fid: int, qn: np.ndarray
    ) -> List[Tuple[List[Tuple[int, float]], int]]:
        """Fused-kNN serving of qn [B, D] normalized queries aligned with
        params_list, with the host tombstone and freshness-window merges."""
        from ..ops import knn as knn_ops

        tracing.phase("search_batch.plan")
        # capture the field container ONCE (commit swaps it atomically)
        vfield = self._vector[fid]
        c = vfield.committed
        use_int8 = self.cfg.vector_index == "int8"
        multivec = not c._single_vec_per_doc
        if use_int8:
            codes_dev, scales_dev, _, _ = self._device.vector_int8_arrays(c)
            p_pad = codes_dev.shape[0]
        else:
            vecs_dev, rowdocs_dev, _ = self._device.vector_arrays(c)
            p_pad = vecs_dev.shape[0]
        bn = 2048
        while p_pad % bn:
            bn //= 2
        # no batch bucketing: the port runs eagerly, so the reference's
        # static query-count buckets (for its compiled shapes) would only
        # add zero queries to K2 and K3
        qb = np.asarray(qn, np.float32)
        limit = max(p.limit for p in params_list)
        # over-fetch by the tombstone count so dropping deleted docs can
        # never underfill the requested limit
        want = limit + len(self.deleted)
        k = 16 if want <= 16 else min(bucket_pad(want, (16, 128, 1024)), c.n_vectors)
        k = min(k, c.n_vectors)
        q_dev = self._device.put(qb)
        tracing.phase("search_batch.dispatch", chunk=0)
        if multivec:
            # rows aggregate by doc in the kernel (sum of relu cos, the
            # dense scorer's semantics); ids come back as DOC ids
            m_max = 1 << max(0, int(np.ceil(np.log2(c._max_chunks))))
            vals_t, rows_t, count_t = knn_ops.knn_topk_multivec_with_count(
                vecs_dev, rowdocs_dev,
                self._device.vector_rowstarts(c, self.capacity),
                q_dev.to(vecs_dev.dtype), k=k, block_rows=bn, m_max=m_max,
                n_valid=c.n_vectors, n_docs=self.capacity,
            )
        elif use_int8:
            # the quantized cosines, as the int8 dense scorer gives them.
            # int8_phase1 gates nothing: K5 serves "xla" and "pallas" alike
            vals_t, rows_t, count_t = knn_ops.knn_topk_int8_with_count(
                codes_dev, scales_dev, q_dev, k=k, block_rows=bn,
                n_valid=c.n_vectors,
            )
        else:
            vals_t, rows_t, count_t = knn_ops.knn_topk_with_count(
                vecs_dev, q_dev.to(vecs_dev.dtype), k=k, block_rows=bn,
                n_valid=c.n_vectors,
            )
        tracing.phase("search_batch.sync")
        vals, rows, count = _to_host(vals_t), _to_host(rows_t), _to_host(count_t)
        tracing.phase("search_batch.reply")
        unc = vfield.uncommitted
        deleted = self.deleted
        # tombstone correction: deleted docs' committed vectors are on host
        del_rows: List[Tuple[int, np.ndarray]] = []
        if deleted:
            order = getattr(c, "_sel_order", None)
            if order is None:
                order = np.argsort(c.vec_docs, kind="stable").astype(np.int64)
                c._sel_order = order
                c._sel_docs = c.vec_docs[order]
            for dd in deleted:
                j = np.searchsorted(c._sel_docs, dd, "left")
                j2 = np.searchsorted(c._sel_docs, dd, "right")
                if j2 > j:
                    del_rows.append((dd, c.vecs[order[j:j2]]))
        out = []
        for r, p in enumerate(params_list):
            docs = rows[r] if multivec else c.vec_docs[rows[r]]
            ranked = [
                (int(d), float(s))
                for d, s in zip(docs, vals[r])
                if s > 0.0 and int(d) not in deleted
            ][: p.limit]
            n_match = int(count[r])
            if del_rows and use_int8:
                # the kernel counted positive QUANTIZED sims: replay its
                # arithmetic, so a doc whose float and quantized sims
                # differ in sign near zero still corrects the count exactly
                q_scale = max(float(np.max(np.abs(qn[r]))), 1e-9) / 127.0
                q8 = np.clip(np.round(qn[r] / q_scale), -127, 127)
            for dd, vm in del_rows:  # vm: [rows_of_doc, D]
                if use_int8:
                    v_scale = np.maximum(np.abs(vm).max(axis=1), 1e-9) / 127.0
                    v8 = np.clip(np.round(vm / v_scale[:, None]), -127, 127)
                    sims_d = v8 @ q8
                else:
                    sims_d = vm @ qn[r]
                if float(np.max(sims_d)) > 0.0:
                    n_match -= 1
            if not unc.is_empty:
                # freshness-window overlay: host-score the window and merge
                # per doc (a reinserted doc id can be in both)
                host_out: Dict[int, float] = {}
                unc.search(qn[r], None, self.deleted, host_out)
                if host_out:
                    merged: Dict[int, float] = dict(ranked)
                    dup = 0
                    for d2, s2 in host_out.items():
                        if d2 in merged:
                            merged[d2] += s2
                            dup += 1
                        else:
                            merged[d2] = s2
                    n_match += len(host_out) - dup
                    ranked = sorted(merged.items(), key=lambda t: -t[1])[: p.limit]
            out.append((ranked, n_match))
        return out

    def _search_vector_topk_fast(
        self, params: SearchParams, ai_service, fid: int
    ) -> Tuple[List[Tuple[int, float]], int]:
        c = self._vector[fid].committed
        qn = self._resolve_query_vec(
            self.fields[fid].model, params.term, ai_service, params.vector
        )
        if params.vector is not None and len(qn) != c.dimension:
            raise ValueError(
                f"query vector has dimension {len(qn)}; collection "
                f"embedding fields have [{c.dimension}]"
            )
        return self._vector_topk_fast_core([params], fid, qn[None, :])[0]

    def _search_batch_vector_topk_fast(
        self, params_list: List[SearchParams], ai_service, fid: int
    ) -> List[Tuple[List[Tuple[int, float]], int]]:
        tracing.phase("search_batch.embed", n=len(params_list))
        q = ai_service.embed_query(self.fields[fid].model,
                                   [p.term for p in params_list])
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        return self._vector_topk_fast_core(params_list, fid, qn)

    # -- fused hybrid (one call per query; ops/hybrid.py) ---------------------

    # host-merge budget for live freshness windows on the fused path
    _FUSED_WINDOW_CAP = 2048

    def _hybrid_fused_eligible(self, params: SearchParams):
        """The one-call fused program applies when the whole query is
        expressible with committed-only filter predicates and facets and
        small freshness windows. Covers hybrid, fulltext (any number of
        string fields) and filtered vector. Returns (mode, string_fids,
        vector_fid, filts, facs, windows_live) or None."""
        if params.limit > 1024:
            return None
        mode = {
            SearchModeKind.HYBRID: "hybrid",
            SearchModeKind.FULLTEXT: "fulltext",
            SearchModeKind.VECTOR: "vector",
        }[params.mode]
        if mode != "vector" and not params.term.strip():
            return None
        sfids: Tuple[int, ...] = ()
        vfid = None
        live = False
        if mode != "vector":
            if params.properties is None:
                cand = [
                    fid for fid, f in self.fields.items()
                    if f.type == ValueType.STRING
                ]
            else:
                cand = []
                for name in params.properties:
                    fid = self.field_by_name.get(name)
                    if fid is None or self.fields[fid].type != ValueType.STRING:
                        return None  # let the normal path raise ValueError
                    cand.append(fid)
            window = 0
            keep = []
            for fid in cand:
                sf = self._string[fid]
                window += len(sf.uncommitted)
                if not sf.uncommitted.is_empty:
                    live = True
                if sf.committed.n_terms or not sf.uncommitted.is_empty:
                    keep.append(fid)
            if not keep or window > self._FUSED_WINDOW_CAP:
                return None
            if not any(self._string[fid].committed.n_terms for fid in keep):
                return None  # nothing committed: the window path is cheap
            sfids = tuple(keep)
        if mode != "fulltext":
            # mesh mode keeps the ANN modes on their replicated or sharded
            # paths, as the reference does (its ANN device caches are
            # single-chip layouts)
            if (self.cfg.vector_index != "exact"
                    and self._device.mesh is not None):
                return None
            vfids = [
                fid for fid, f in self.fields.items()
                if f.type == ValueType.EMBEDDING and f.model
            ]
            if len(vfids) != 1:
                return None
            vf = self._vector[vfids[0]]
            if vf.committed.is_empty:
                return None
            if not vf.uncommitted.is_empty:
                if len(vf.uncommitted.entries) > self._FUSED_WINDOW_CAP:
                    return None
                live = True
            vfid = vfids[0]
        filts = []
        for fname, filt in (params.where or {}).items():
            fid = self.field_by_name.get(fname)
            if fid is None:
                return None  # let the normal path raise the user error
            ftype = self.fields[fid].type
            if isinstance(filt, NumberFilter) and ftype == ValueType.NUMBER:
                if not self._number[fid].uncommitted.is_empty:
                    return None
                filts.append(("eq" if filt.op == "eq" else "range", fid, filt))
            elif isinstance(filt, BoolFilter) and ftype == ValueType.BOOL:
                if not self._bool[fid].uncommitted.is_empty:
                    return None
                filts.append(("bool", fid, filt))
            elif isinstance(filt, StringFilter) and ftype == ValueType.STRING:
                if not self._keyword[fid].uncommitted.is_empty:
                    return None
                filts.append(("keyword", fid, filt))
            else:
                return None  # mistyped: the normal path raises
        facs = []
        for fname, fdef in (params.facets or {}).items():
            fid = self.field_by_name.get(fname)
            if fid is None:
                return None
            ftype = self.fields[fid].type
            if isinstance(fdef, NumberFacetDefinition) and ftype == ValueType.NUMBER:
                if not self._number[fid].uncommitted.is_empty:
                    return None
                facs.append(("number", fid, fname, fdef))
            elif isinstance(fdef, StringFacetDefinition) and ftype == ValueType.STRING:
                kf = self._keyword[fid]
                if not kf.uncommitted.is_empty or kf.committed.is_empty:
                    return None
                facs.append(("keyword", fid, fname, fdef))
            elif isinstance(fdef, BoolFacetDefinition) and ftype == ValueType.BOOL:
                if not self._bool[fid].uncommitted.is_empty:
                    return None
                facs.append(("bool", fid, fname, fdef))
            else:
                return None  # facet/field type mismatch: normal path raises
        return mode, sfids, vfid, tuple(filts), tuple(facs), live

    def _fused_string_field(self, fid: int, params: SearchParams, cap: int):
        """Per-field pieces for the packed fused program: (fdev, ihost,
        fhost, fstat, window_out), as in the reference."""
        f = self.fields[fid]
        locale = f.locale or self.default_locale
        tokens, stems = query_expansion(get_parser(locale), params.term)
        sf = self._string[fid]
        committed = sf.committed
        gi = committed.global_info() + sf.uncommitted.global_info()
        field_boost = float(params.boost.get(f.name, 1.0))

        window_out: Dict[int, float] = {}
        if not sf.uncommitted.is_empty:
            # unmasked, deletes kept: the in-program mask multiplies the
            # merged scores (identical: the mask is {0,1} per doc)
            sf.uncommitted.search(
                tokens, field_boost, gi, None, None, window_out,
                exact_tokens=stems,
            )
        if committed.n_terms == 0:
            return None, None, None, None, window_out

        token_spans, n_surf = expanded_spans(committed.term_dict, tokens, stems)
        phrase = len(tokens) > 1
        ts_host = committed.term_starts

        # Zipf-head terms score via precomputed dense rows; light terms
        # keep the blocked scan. Mesh mode keeps the scan, as the
        # reference does (its rows would replicate per device); live
        # windows keep it too (rows embed avgdl, which moves with every
        # window insert).
        dense_rows = None
        d_sel = d_w = None
        if self._device.mesh is None and sf.uncommitted.is_empty:
            dense_rows, row_by_term = self._device.dense_term_rows(
                committed, cap, gi.avgdl
            )
            if dense_rows is not None:
                p_lo, p_len, sel, wsel = bm25_ops.split_spans_dense(
                    token_spans, ts_host, row_by_term,
                    committed.term_df(), gi.total_documents,
                )
                if sel and len(sel) <= bm25_ops.DENSE_SEL_BUCKETS[-1]:
                    d_sel, d_w = bm25_ops.pad_dense_sel(sel, wsel)
                else:
                    dense_rows = None  # none selected / over bucket
        if dense_rows is None:
            p_lo = [int(ts_host[lo]) for lo, hi in token_spans]
            p_len = [int(ts_host[hi] - ts_host[lo]) for lo, hi in token_spans]

        # reference gate collection_read.py:3284-3287: the aligned plan
        # (K1), always
        need = bm25_ops.aligned_blocks_needed(p_len)
        nb = bucket_pad(max(need, 1), bm25_ops.PLAN_BUCKETS)
        ihost: List[np.ndarray] = list(
            bm25_ops.build_block_plan_aligned(p_lo, p_len, nb)
        )
        d_docs, d_tf, d_ni, d_plens = self._device.string_arrays(committed)

        n_sp = 0
        ph_terms = ph_bits = ph_bounds = None
        if phrase:
            # reference gate collection_read.py:3310-3313: the windowed
            # contract (K4), always; its window arguments go unused
            ph_terms, ph_bits, ph_bounds = (
                self._device.phrase_stream_arrays(committed, cap)
            )
            spans_a = self._phrase_spans(token_spans, n_surf)
            n_sp = spans_a.shape[0]
            ihost.append(spans_a.reshape(-1))

        use_dense = dense_rows is not None
        n_dsel = 0
        fhost = [np.asarray(
            [1.0 if phrase else field_boost, gi.avgdl, gi.total_documents,
             field_boost],
            np.float32,
        )]
        if use_dense:
            n_dsel = len(d_sel)
            ihost.append(d_sel)
            fhost.append(d_w)
        fdev = (
            d_docs, d_tf, d_ni, d_plens,
            dense_rows if use_dense else None,
            None, None, ph_terms, ph_bounds, None, ph_bits,
        )
        fstat = (nb, phrase, use_dense, phrase, 0, 0, n_sp, n_dsel)
        return fdev, ihost, fhost, fstat, window_out

    def _fused_vector_args(self, committed, limit: int):
        """Committed vector operands of the fused program and of
        ``_committed_vector_scores``: (vmode, v_statics, v_ann, (vecs,
        vec_docs, vec_valid)), the exact triple None-filled for the other
        modes. An ANN mode whose structures were not built (the field is
        below ``ivf_threshold``) serves the exact rows, as the reference
        does. The ANN candidate count is max(limit, 10) times the expand
        (the tuned one for IVF-PQ), and nprobe the tuned one, else the
        config's."""
        mode = self.cfg.vector_index
        cfg = self.cfg
        if mode == "ivf_pq" and committed.has_ivf and committed.has_pq:
            arrays = self._device.vector_ivfpq_arrays(committed)
            expand = committed.tuned_expand or cfg.ivf_candidate_expand
            cand_k = min(max(limit, 10) * expand, committed.n_vectors)
            nprobe = min(committed.tuned_nprobe or cfg.ivf_nprobe,
                         arrays[4].shape[0])
            return ("ivf_pq", (nprobe, cand_k, expand, committed.pq_residual),
                    arrays, (None, None, None))
        if mode == "ivf" and committed.has_ivf:
            arrays = self._device.vector_ivf_arrays(committed)
            cand_k = min(max(limit, 10) * cfg.ivf_candidate_expand,
                         committed.n_vectors)
            nprobe = min(committed.tuned_nprobe or cfg.ivf_nprobe,
                         arrays[2].shape[0])
            return ("ivf", (nprobe, cand_k), arrays, (None, None, None))
        if mode == "pq" and committed.has_pq:
            cand_k = min(max(limit, 10) * cfg.ivf_candidate_expand,
                         committed.n_vectors)
            return ("pq", (cand_k,), self._device.vector_pq_arrays(committed),
                    (None, None, None))
        if mode == "int8":
            return ("int8", (), self._device.vector_int8_rows(committed),
                    (None, None, None))
        return ("exact", (_vec_docs_identity(committed),), None,
                self._device.vector_rows(committed))

    def _search_hybrid_fused(
        self,
        params: SearchParams,
        ai_service,
        mode: str,
        sfids: Tuple[int, ...],
        vfid: Optional[int],
        filts: Tuple = (),
        facs: Tuple = (),
        live: bool = False,
    ) -> Tuple[List[Tuple[int, float]], int, Optional[Dict[str, FacetResult]]]:
        from ..ops import hybrid as hybrid_ops

        # a batch's phases where a search_batch serves this query
        tracing.phase("search_batch.plan")
        cap = self.capacity
        put = self._device.put
        fields = []
        field_statics = []
        int_parts: List[np.ndarray] = []
        flt_parts: List[np.ndarray] = []
        u_ft_out: Dict[int, float] = {}
        for fid in sfids:
            fdev, ihost, fhost, fstat, window_out = self._fused_string_field(
                fid, params, cap
            )
            if fdev is not None:
                fields.append(fdev)
                field_statics.append(fstat)
                int_parts += ihost
                flt_parts += fhost
            for doc, sc in window_out.items():
                u_ft_out[doc] = u_ft_out.get(doc, 0.0) + sc

        u_vec_out: Dict[int, float] = {}
        qn = None
        vmode, v_statics, v_ann = "exact", (), None
        if vfid is not None:
            vf = self._vector[vfid]
            raw_vec = params.vector if mode == "vector" else None
            if raw_vec is not None and len(raw_vec) != vf.committed.dimension:
                raise ValueError(
                    f"query vector has dimension {len(raw_vec)}; collection "
                    f"embedding fields have [{vf.committed.dimension}]"
                )
            vmode, v_statics, v_ann, (vecs, vec_docs, vec_valid) = (
                self._fused_vector_args(vf.committed, params.limit)
            )
            tracing.phase("search_batch.embed", n=1)
            qn = self._resolve_query_vec(
                self.fields[vfid].model, params.term, ai_service, raw_vec
            )
            tracing.phase("search_batch.plan")
            if not vf.uncommitted.is_empty:
                vf.uncommitted.search(qn, None, None, u_vec_out)
        else:
            vecs = vec_docs = vec_valid = None

        alive = self._alive_mask_device()
        masked = bool(params.where) or bool(self.deleted)
        # filters: device-cached columns + packed params per predicate
        filter_statics: List[Tuple[str, int]] = []
        filter_cols: List[Tuple] = []
        filter_flts: List[np.ndarray] = []
        for kind, ffid, filt in filts:
            if kind in ("range", "eq"):
                ncomm = self._number[ffid].committed
                dense_plane = self._device.number_dense_plane(ncomm, cap)
                if dense_plane is not None:
                    cols = (dense_plane,)
                    kind = kind + "_dense"
                else:  # multi-value field: segment-scatter path
                    cols = self._device.number_arrays(ncomm)
                fp = np.zeros(4, np.float32)
                if kind.startswith("eq"):
                    fp[0] = fp[1] = filt.value
                else:
                    lo_, hi_, lx_, hx_ = ncomm.filter_bounds(filt)
                    fp[:] = [lo_, hi_, 1.0 if lx_ else 0.0, 1.0 if hx_ else 0.0]
                filter_statics.append((kind, 0))
            elif kind == "bool":
                cols = self._device.bool_arrays(self._bool[ffid].committed, cap)
                fp = np.asarray([1.0 if filt.value else 0.0], np.float32)
                filter_statics.append(("bool", 0))
            else:  # keyword value-set
                kf = self._keyword[ffid]
                wanted_vals = (filt.value,) if filt.op == "eq" else filt.value
                wanted_ids = [
                    kf.committed.id_of(v)
                    for v in wanted_vals
                    if kf.committed.id_of(v) is not None
                ]
                n_w = bucket_pad(max(len(wanted_ids), 1), (4, 16, 64))
                fp = np.full(n_w, -1.0, np.float32)
                fp[: len(wanted_ids)] = wanted_ids
                if kf.committed.is_empty:
                    # no interned column: nothing can match
                    cols = (put(np.zeros(1, np.float32)),
                            put(np.zeros(1, np.int32)),
                            put(np.zeros(1, bool)))
                    filter_statics.append(("keyword", n_w))
                else:
                    kw_plane = self._device.keyword_dense_plane(kf.committed, cap)
                    if kw_plane is not None:
                        cols = (kw_plane,)
                        filter_statics.append(("keyword_dense", n_w))
                    else:
                        cols = self._device.keyword_arrays(kf.committed)
                        filter_statics.append(("keyword", n_w))
            filter_cols.append(tuple(cols))
            filter_flts.append(fp)

        # facets: device-cached columns + packed range bounds (number)
        facet_statics: List[Tuple[str, int]] = []
        facet_cols: List[Tuple] = []
        facet_flts: List[np.ndarray] = []
        for kind, ffid, _fname, fdef in facs:
            if kind == "number":
                ncomm = self._number[ffid].committed
                plane = self._device.number_dense_plane(ncomm, cap)
                # single-valued column: count from the doc-major plane
                # (same counts, no [R, V] -> [R, n_docs] scatter)
                cols = ((plane,) if plane is not None
                        else self._device.number_arrays(ncomm))
                r_real = len(fdef.ranges)
                r_pad = bucket_pad(max(r_real, 1), (4, 16))
                # pad ranges are [+inf, -inf]: empty, count 0, dropped
                lows = np.full(r_pad, 3.4e38, np.float32)
                highs = np.full(r_pad, -3.4e38, np.float32)
                lows[:r_real] = [float(r.low) for r in fdef.ranges]
                highs[:r_real] = [float(r.high) for r in fdef.ranges]
                facet_flts += [lows, highs]
                facet_statics.append(
                    ("number_dense" if plane is not None else "number", r_pad))
            elif kind == "keyword":
                kf = self._keyword[ffid]
                cols = self._device.keyword_arrays(kf.committed)
                facet_statics.append(("keyword", kf.committed.n_values))
            else:  # bool
                cols = self._device.bool_arrays(self._bool[ffid].committed, cap)
                facet_statics.append(("bool", 0))
            facet_cols.append(tuple(cols))

        u_ft_n = u_vec_n = 0
        if u_ft_out:
            u_idx, u_vals = self._padded_scatter_np(
                list(u_ft_out.keys()), list(u_ft_out.values())
            )
            u_ft_n = len(u_idx)
            int_parts.append(u_idx)
        if u_vec_out:
            v_idx, v_vals = self._padded_scatter_np(
                list(u_vec_out.keys()), list(u_vec_out.values())
            )
            u_vec_n = len(v_idx)
            int_parts.append(v_idx)
        # every per-query small array rides ONE int32 + ONE float32 upload
        flt_parts += filter_flts
        flt_parts += facet_flts
        qdim = 0
        if qn is not None:
            qdim = len(qn)
            flt_parts.append(np.asarray(qn, np.float32))
        if u_ft_n:
            flt_parts.append(u_vals)
        if u_vec_n:
            flt_parts.append(v_vals)
        ints = (
            np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in int_parts])
            if int_parts else np.zeros(1, np.int32)
        )
        flts = np.concatenate(
            [np.asarray(a, np.float32).reshape(-1) for a in flt_parts]
        )
        ints_dev, flts_dev = put(ints), put(flts)

        k = min(bucket_pad(params.limit, (16, 128, 1024)), cap)
        tracing.phase("search_batch.dispatch", chunk=0)
        vals_t, idx_t, count_t, fouts_t = hybrid_ops.hybrid_fused_topk_mf(
            ints_dev, flts_dev, tuple(fields), vecs, vec_docs, vec_valid,
            alive, tuple(filter_cols), tuple(facet_cols),
            n_docs=cap, k=k,
            fusion="minmax" if params.fusion == HybridFusion.MINMAX else "rrf",
            filters=tuple(filter_statics), facets=tuple(facet_statics),
            # reference gate collection_read.py:3463-3465: the aligned
            # plan (K1), always, on any device
            masked=masked, mode=mode, bm25_pallas=True,
            field_statics=tuple(field_statics), u_ft_n=u_ft_n,
            u_vec_n=u_vec_n, qdim=qdim, vmode=vmode, v_statics=v_statics,
            v_ann=v_ann,
        )
        tracing.phase("search_batch.sync")
        vals, idx = _to_host(vals_t), _to_host(idx_t)
        count = int(count_t)
        fouts = [_to_host(t) for t in fouts_t]
        tracing.phase("search_batch.reply")
        ranked = [
            (int(d), float(s))
            for d, s in zip(idx[: params.limit], vals[: params.limit])
            if s > 0.0
        ]
        facets_out: Optional[Dict[str, FacetResult]] = None
        if facs:
            # host-side assembly mirrors compute_facets exactly
            facets_out = {}
            for (kind, ffid, fname, fdef), counts in zip(facs, fouts):
                if kind == "number":
                    values = {r.key: int(c) for r, c in zip(fdef.ranges, counts)}
                    facets_out[fname] = FacetResult(count=len(values), values=values)
                elif kind == "keyword":
                    kf = self._keyword[ffid]
                    agg = {
                        kf.committed.values[vid]: int(c)
                        for vid, c in enumerate(counts)
                        if c > 0
                    }
                    top = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))[: fdef.limit]
                    facets_out[fname] = FacetResult(count=len(agg), values=dict(top))
                else:  # bool
                    values = {}
                    if fdef.true:
                        values["true"] = int(counts[0])
                    if fdef.false:
                        values["false"] = int(counts[1])
                    facets_out[fname] = FacetResult(count=len(values), values=values)
        return ranked, count, facets_out

    def _search_batch_hybrid_fused(
        self,
        params_list: List[SearchParams],
        ai_service,
        mode: str,
        sfid: Optional[int],
        vfid: Optional[int],
        nf,
    ) -> List[Tuple[List[Tuple[int, float]], int]]:
        """Batched fused serving (ops/hybrid.hybrid_fused_topk_batch), the
        micro-batcher's path for B > 1 through the single-query program's
        primitives: every row's light-term posting spans go into ONE
        combined aligned block plan, each block tagged with its row, so
        the batch is one K1 launch into [b, cap]; Zipf-head terms ride a
        [b, H] idf-weight product against the commit-static dense rows;
        the vector half is one corpus product for all b queries. One host
        sync for all memory chunks (a chunk bounds b * cap dense floats).
        Rows are not padded to the reference's batch buckets: the port
        runs eagerly, so a padding row would only add work."""
        from ..ops import hybrid as hybrid_ops

        plan_ph = tracing.phase("search_batch.plan")
        cap = self.capacity
        put = self._device.put
        p0 = params_list[0]
        b_real = len(params_list)
        k = min(bucket_pad(max(p.limit for p in params_list), (16, 128, 1024)),
                cap)
        dev = self.device
        zf = torch.zeros(1, dtype=torch.float32, device=dev)
        zi = torch.zeros(1, dtype=torch.int32, device=dev)
        dense_rows = None
        if sfid is not None:
            f = self.fields[sfid]
            parser = get_parser(f.locale or self.default_locale)
            sf = self._string[sfid]
            committed = sf.committed
            gi = committed.global_info() + sf.uncommitted.global_info()
            gi_avgdl, gi_n = gi.avgdl, gi.total_documents
            field_boost = float(p0.boost.get(f.name, 1.0))
            ts_host = committed.term_starts
            row_by_term = None
            if self._device.mesh is None:
                # windows are empty by eligibility, so avgdl is
                # commit-static; mesh mode keeps the scan (as
                # _fused_string_field)
                dense_rows, row_by_term = self._device.dense_term_rows(
                    committed, cap, gi_avgdl
                )
            term_df = committed.term_df() if dense_rows is not None else None
            row_plans: List[Tuple[List[int], List[int]]] = []
            row_sels: List[Tuple[List[int], List[float]]] = []
            n_terms = 0
            for p in params_list:
                tokens, stems = query_expansion(parser, p.term)
                # non-phrase by construction (search_batch routes phrases)
                spans = expanded_spans(committed.term_dict, tokens, stems)[0]
                n_terms += sum(hi - lo for lo, hi in spans)
                if dense_rows is not None:
                    p_lo, p_len, sel, w = bm25_ops.split_spans_dense(
                        spans, ts_host, row_by_term, term_df, gi_n
                    )
                else:
                    p_lo = [int(ts_host[lo]) for lo, hi in spans]
                    p_len = [int(ts_host[hi] - ts_host[lo]) for lo, hi in spans]
                    sel, w = [], []
                row_plans.append((p_lo, p_len))
                row_sels.append((sel, w))
            # the terms the dense head rows serve, and those K1 scans
            n_dense = sum(len(sel) for sel, _w in row_sels)
            plan_ph["dense_terms"] = n_dense
            plan_ph["k1_terms"] = n_terms - n_dense
            d_docs, d_tf, d_ni, d_plens = self._device.string_arrays(committed)
        else:
            gi_avgdl = gi_n = 1.0
            field_boost = 1.0
            d_docs = zi
            d_tf = d_ni = d_plens = zf

        vf = None
        if vfid is not None:
            vf = self._vector[vfid]
            tracing.phase("search_batch.embed", n=b_real)
            q = ai_service.embed_query(self.fields[vfid].model,
                                       [p.term for p in params_list])
            tracing.phase("search_batch.plan")
            qn = np.asarray(q, np.float32)
            qn = qn / np.maximum(np.linalg.norm(qn, axis=1, keepdims=True),
                                 1e-12)
            qdim = qn.shape[1]
            vecs, vec_docs, vec_valid = self._device.vector_rows(vf.committed)
        else:
            qdim = 0
            vecs = vec_docs = vec_valid = None

        alive = self._alive_mask_device()
        masked = bool(p0.where) or bool(self.deleted)
        nf_host = None
        if nf is not None:
            nfid, filt = nf
            ncomm = self._number[nfid].committed
            dense_plane = self._device.number_dense_plane(ncomm, cap)
            if dense_plane is not None:
                nvals, ndocs, nvalid = dense_plane, None, None
                dsuf = "_dense"
            else:
                nvals, ndocs, nvalid = self._device.number_arrays(ncomm)
                dsuf = ""
            if filt.op == "eq":
                kind = "eq" + dsuf
                nf_host = np.asarray([filt.value, filt.value, 1.0, 1.0],
                                     np.float32)
            else:
                kind = "range" + dsuf
                lo_, hi_, lx_, hx_ = ncomm.filter_bounds(filt)
                nf_host = np.asarray(
                    [lo_, hi_, 1.0 if lx_ else 0.0, 1.0 if hx_ else 0.0],
                    np.float32,
                )
        else:
            kind = "none"
            nvals = ndocs = nvalid = None

        use_dense = dense_rows is not None
        fusion = "minmax" if p0.fusion == HybridFusion.MINMAX else "rrf"
        # memory chunks: each holds b * cap f32 scores per modality
        chunk = 4
        for bb in (256, 64, 16, 4):
            if bb * cap <= self._BATCH_DENSE_SLOTS and bb * cap < 2**31:
                chunk = bb
                break
        tracing.annotate(chunks=-(-b_real // chunk))
        pending = []
        for c0 in range(0, b_real, chunk):
            tracing.phase("search_batch.plan")
            rows_c = list(range(c0, min(c0 + chunk, b_real)))
            b = len(rows_c)
            int_parts: List[np.ndarray] = []
            flt_parts: List[np.ndarray] = [
                np.asarray([field_boost, gi_avgdl, gi_n], np.float32)
            ]
            if nf_host is not None:
                flt_parts.append(nf_host)
            nb = 1
            if sfid is not None:
                plan = bm25_ops.build_batch_plan_aligned(
                    [row_plans[r] for r in rows_c])
                nb = len(plan[0])
                int_parts += list(plan)
                if use_dense:
                    w_mat = np.zeros((b, int(dense_rows.shape[0])), np.float32)
                    for i, r in enumerate(rows_c):
                        sel, w = row_sels[r]
                        for s_row, s_w in zip(sel, w):
                            w_mat[i, s_row] += s_w
                    flt_parts.append(w_mat.reshape(-1))
            if qdim:
                flt_parts.append(qn[rows_c].reshape(-1))
            ints = put(np.concatenate(int_parts) if int_parts
                       else np.zeros(1, np.int32))
            flts = put(np.concatenate(flt_parts))
            tracing.phase("search_batch.dispatch", chunk=c0 // chunk)
            out = hybrid_ops.hybrid_fused_topk_batch(
                ints, flts, d_docs, d_tf, d_ni, d_plens,
                dense_rows if use_dense else zf,
                vecs, vec_docs, vec_valid, alive, nvals, ndocs, nvalid,
                n_docs=cap, k=k, fusion=fusion, nf=kind, masked=masked,
                mode=mode, n_blocks=nb, b=b, qdim=qdim, dense=use_dense,
                vec_identity=(_vec_docs_identity(vf.committed)
                              if vf is not None else False),
            )
            pending.append((rows_c, out))
        # one host sync for every chunk's results; a chunk's replies are
        # built while the device runs the chunks after it
        results: List[Optional[Tuple[List[Tuple[int, float]], int]]] = (
            [None] * b_real
        )
        for c_i, (rows_c, (vals_t, idx_t, counts_t)) in enumerate(pending):
            tracing.phase("search_batch.sync", chunk=c_i)
            vals, idx, counts = (_to_host(vals_t), _to_host(idx_t),
                                 _to_host(counts_t))
            tracing.phase("search_batch.reply", chunk=c_i)
            for i, r in enumerate(rows_c):
                p = params_list[r]
                ranked = [
                    (int(d), float(s))
                    for d, s in zip(idx[i][: p.limit], vals[i][: p.limit])
                    if s > 0.0
                ]
                results[r] = (ranked, int(counts[i]))
        return results  # every slot filled: chunks partition the rows

    def search(
        self, params: SearchParams, ai_service
    ) -> Tuple[List[Tuple[int, float]], int, Optional[Dict[str, FacetResult]]]:
        """Returns (ranked [(doc_id, score)], match count, facets), read
        from one pinned view of the reader (``_pinned``)."""
        return self._pinned(self._search, params, ai_service)

    def _search(self, params: SearchParams, ai_service):
        if self._use_sharded(params):
            return self._search_sharded(params, ai_service)
        # the fused kNN outranks the fused dense program for eligible
        # (unfiltered exact) vector queries
        fast_fid = self._vector_fast_field(params)
        if fast_fid is not None:
            from ..server import metrics as m

            m.VECTOR_PATH.inc(path="fast")
            ranked, count = self._search_vector_topk_fast(params, ai_service, fast_fid)
            return ranked, count, None
        helig = self._hybrid_fused_eligible(params)
        if helig is not None:
            from ..server import metrics as m

            m.VECTOR_PATH.inc(path="fused_" + helig[0])
            return self._search_hybrid_fused(params, ai_service, *helig)
        scores = self.search_scores(params, ai_service)
        facets = self.compute_facets(scores, params.facets) if params.facets else None
        k = min(params.limit, self.capacity)
        vals_t, idx_t, count_t = topk_ops.topk_with_count(scores, k)
        vals, idx = _to_host(vals_t), _to_host(idx_t)
        ranked = [(int(d), float(s)) for d, s in zip(idx, vals) if s > 0.0]
        return ranked, int(count_t), facets

    def warmup(self, ai_service=None) -> int:
        """Build the device caches of every committed structure ahead of
        the first query (the reference compiles its programs here; the
        port runs eagerly and compiles nothing). Returns caches built. A
        mesh reader builds the per-shard layouts its mesh path reads."""
        if self._device.mesh is not None and self._device.n_shards >= 2:
            return self._warmup_sharded()
        n = 0
        cap = self.capacity
        for sf in self._string.values():
            c = sf.committed
            if c.n_terms:
                self._device.string_arrays(c)
                self._device.phrase_stream_arrays(c, cap)
                if sf.uncommitted.is_empty:
                    gi = c.global_info()
                    self._device.dense_term_rows(c, cap, gi.avgdl)
                n += 1
        for vf in self._vector.values():
            if not vf.committed.is_empty:
                # the caches of whatever the field's index serves
                self._fused_vector_args(vf.committed, 10)
                n += 1
        for nf in self._number.values():
            self._device.number_arrays(nf.committed)
            self._device.number_dense_plane(nf.committed, cap)
            n += 1
        for kf in self._keyword.values():
            if not kf.committed.is_empty:
                self._device.keyword_arrays(kf.committed)
                self._device.keyword_dense_plane(kf.committed, cap)
                n += 1
        for bf in self._bool.values():
            self._device.bool_arrays(bf.committed, cap)
            n += 1
        self._alive_mask_device()
        return n

    def _warmup_sharded(self) -> int:
        _mesh, _S, local_cap, cap_s = self._sharded_ctx()
        dc = self._device
        n = 0
        for sf in self._string.values():
            c = sf.committed
            if c.n_terms:
                dc.sharded_string_arrays(c, local_cap)
                dc.sharded_phrase_stream(c, local_cap)
                n += 1
        for vf in self._vector.values():
            c = vf.committed
            if c.is_empty:
                continue
            mode = self.cfg.vector_index
            if mode in ("ivf", "pq"):
                self._fused_vector_args(c, 10)  # replicated, first device
            elif mode == "ivf_pq" and c.has_ivf and c.has_pq:
                dc.sharded_ivfpq_arrays(c, local_cap)
            elif mode == "int8":
                dc.sharded_vector_int8_arrays(c, local_cap)
            else:
                dc.sharded_vector_arrays(c, local_cap)
                if (len(np.unique(c.vec_docs)) != c.n_vectors
                        and _multivec_fast_eligible(c)):
                    dc.sharded_vector_rowstarts(c, local_cap)
            n += 1
        for nf in self._number.values():
            dc.sharded_number_arrays(nf.committed, local_cap)
            n += 1
        for kf in self._keyword.values():
            if not kf.committed.is_empty:
                dc.sharded_keyword_arrays(kf.committed, local_cap)
                n += 1
        for bf in self._bool.values():
            dc.sharded_bool_arrays(bf.committed, cap_s)
            n += 1
        self._alive_mask_sharded(cap_s)
        return n

    # -- cross-slice global statistics (multislice DFS mode) ------------------

    def export_term_stats(self) -> Dict[str, Any]:
        """Per-string-field committed statistics for the multi-slice
        global-idf exchange: terms + df arrays + (n_docs, total_len).
        Commit-static — call after commit; uncommitted windows excluded."""
        out: Dict[str, Any] = {}
        for fid, sf in self._string.items():
            c = sf.committed
            if c.n_terms == 0:
                continue
            out[self.fields[fid].name] = {
                "terms": list(c.term_dict.terms),
                "df": np.diff(c.term_starts).astype(np.float32).tolist(),
                "n_docs": int(c.n_docs_with_field),
                "total_len": int(c.total_len),
            }
        return out

    def apply_global_stats(self, stats: Dict[str, Any]) -> None:
        """Install merged cross-slice statistics; invalidates the affected
        device caches so the next query scores with global idf."""
        for name, s in stats.items():
            fid = self.field_by_name.get(name)
            if fid is None or fid not in self._string:
                continue
            c = self._string[fid].committed
            if c.n_terms == 0:
                continue
            c.set_stats_override(
                dict(zip(s["terms"], s["df"])), s["n_docs"], s["total_len"]
            )
            self._device.drop(c)

    # -- facets (reference: collection.rs:1004-1126) --------------------------

    def compute_facets(
        self, scores: torch.Tensor, facet_defs: Dict[str, Any]
    ) -> Dict[str, FacetResult]:
        matched = facet_ops.matched_mask(scores)
        matched_host: Optional[np.ndarray] = None
        out: Dict[str, FacetResult] = {}
        for field_name, fdef in facet_defs.items():
            fid = self.field_by_name.get(field_name)
            if fid is None:
                raise ValueError(f"unknown facet field {field_name}")
            ftype = self.fields[fid].type
            if isinstance(fdef, NumberFacetDefinition):
                if ftype != ValueType.NUMBER:
                    raise ValueError(
                        f'"{field_name}" is not a number field (facet shape'
                        " does not match the field type)"
                    )
                nf = self._number[fid]
                lows = self._device.put(
                    np.asarray([float(r.low) for r in fdef.ranges], np.float32))
                highs = self._device.put(
                    np.asarray([float(r.high) for r in fdef.ranges], np.float32))
                plane = self._device.number_dense_plane(
                    nf.committed, self.capacity)
                if plane is not None:
                    dev_counts = facet_ops.number_facet_counts_dense(
                        plane, lows, highs, matched)
                else:
                    vals, docs, valid = self._device.number_arrays(nf.committed)
                    dev_counts = facet_ops.number_facet_counts(
                        vals, docs, valid, lows, highs, matched,
                        n_docs=self.capacity)
                counts = _to_host(dev_counts).copy()
                if not nf.uncommitted.is_empty:
                    if matched_host is None:
                        matched_host = _to_host(matched)
                    for i, r in enumerate(fdef.ranges):
                        for v, d in nf.uncommitted.pairs:
                            if (float(r.low) <= v <= float(r.high)
                                    and d < len(matched_host)
                                    and matched_host[d] > 0):
                                counts[i] += 1
                values = {r.key: int(c) for r, c in zip(fdef.ranges, counts)}
                out[field_name] = FacetResult(count=len(values), values=values)
            elif isinstance(fdef, StringFacetDefinition):
                if ftype != ValueType.STRING:
                    raise ValueError(
                        f'"{field_name}" is not a string field (facet shape'
                        " does not match the field type)"
                    )
                kf = self._keyword[fid]
                agg: Dict[str, int] = {}
                if not kf.committed.is_empty:
                    ids, docs, valid = self._device.keyword_arrays(kf.committed)
                    counts = _to_host(facet_ops.keyword_facet_counts(
                        ids, docs, valid, matched, n_values=kf.committed.n_values,
                    ))
                    for vid, c in enumerate(counts):
                        if c > 0:
                            agg[kf.committed.values[vid]] = int(c)
                if not kf.uncommitted.is_empty:
                    if matched_host is None:
                        matched_host = _to_host(matched)
                    for v, c in kf.uncommitted.facet_counts(matched_host).items():
                        agg[v] = agg.get(v, 0) + c
                top = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))[: fdef.limit]
                out[field_name] = FacetResult(count=len(agg), values=dict(top))
            elif isinstance(fdef, BoolFacetDefinition):
                if ftype != ValueType.BOOL:
                    raise ValueError(
                        f'"{field_name}" is not a bool field (facet shape'
                        " does not match the field type)"
                    )
                bf = self._bool[fid]
                true_mask, has_mask = self._device.bool_arrays(bf.committed, self.capacity)
                tc, fc = _to_host(
                    facet_ops.bool_facet_counts(true_mask, has_mask, matched)
                ).tolist()
                if not bf.uncommitted.is_empty:
                    if matched_host is None:
                        matched_host = _to_host(matched)
                    t2, f2 = bf.uncommitted.true_false_counts(matched_host)
                    tc += t2
                    fc += f2
                values = {}
                if fdef.true:
                    values["true"] = int(tc)
                if fdef.false:
                    values["false"] = int(fc)
                out[field_name] = FacetResult(count=len(values), values=values)
        return out

    # -- commit / persistence (reference: collection.rs:194-602) --------------

    def commit(self, data_dir: str, offset: int, keep_generations: int = 2) -> None:
        """Merge uncommitted windows into new immutable generations and dump
        to ``data_dir`` as ``gen-{offset}`` + pointer file (the reference's
        format, so either package loads the other's data directory)."""
        live = self._live
        with self._commit_insert_lock:
            cap = self._live_capacity()
            deleted = set(live.deleted)
            # fold each window into a NEW container; publish them all, and
            # the emptied tombstones, in one step under the view lock: a
            # search pins its view wholly before or wholly after a commit
            swaps = []  # (table, field id, new container)
            for fid, sf in list(live.string.items()):
                if not sf.uncommitted.is_empty or deleted:
                    swaps.append((live.string, fid, _StringField(
                        UncommittedStringIndex(),
                        sf.committed.merge(sf.uncommitted, cap, deleted),
                    )))
            for fid, nf in list(live.number.items()):
                if not nf.uncommitted.is_empty or deleted:
                    swaps.append((live.number, fid, _NumberField(
                        UncommittedNumberIndex(),
                        nf.committed.merge(nf.uncommitted, deleted),
                    )))
            for fid, kf in list(live.keyword.items()):
                if not kf.uncommitted.is_empty or deleted:
                    swaps.append((live.keyword, fid, _KeywordField(
                        UncommittedKeywordIndex(),
                        kf.committed.merge(kf.uncommitted, deleted),
                    )))
            for fid, bf in list(live.bool.items()):
                if not bf.uncommitted.is_empty or deleted:
                    swaps.append((live.bool, fid, _BoolField(
                        UncommittedBoolIndex(),
                        bf.committed.merge(bf.uncommitted, cap, deleted),
                    )))
            for fid, vf_old in list(live.vector.items()):
                if not vf_old.uncommitted.is_empty or deleted:
                    merged = vf_old.committed.merge(vf_old.uncommitted, deleted)
                    self._build_ann(merged)
                    swaps.append((live.vector, fid, _VectorField(
                        UncommittedVectorIndex(vf_old.committed.dimension),
                        merged,
                    )))
            with self._view_lock:
                olds = [table[fid].committed for table, fid, _ in swaps]
                for table, fid, container in swaps:
                    table[fid] = container
                # deletions are now folded into every committed generation:
                # REBIND the tombstone set (pinned searches keep the old one)
                live.deleted = set()
            for old in olds:
                self._device.retire(old)
            self.committed_offset = offset
            self.uncommitted_ops = 0

        gen_dir = ensure_dir(os.path.join(data_dir, f"gen-{offset}"))
        for fid, sf in live.string.items():
            atomic_write_npz(os.path.join(gen_dir, f"string-{fid}.npz"), sf.committed.to_arrays())
        for fid, nf in live.number.items():
            atomic_write_npz(os.path.join(gen_dir, f"number-{fid}.npz"), nf.committed.to_arrays())
        for fid, kf in live.keyword.items():
            atomic_write_npz(os.path.join(gen_dir, f"keyword-{fid}.npz"), kf.committed.to_arrays())
        for fid, bf in live.bool.items():
            atomic_write_npz(os.path.join(gen_dir, f"bool-{fid}.npz"), bf.committed.to_arrays())
        for fid, vf in live.vector.items():
            atomic_write_npz(os.path.join(gen_dir, f"vector-{fid}.npz"), vf.committed.to_arrays())
        manifest = {
            "collection_id": self.id,
            "read_api_key": self.read_api_key,
            "description": self.description,
            "default_locale": self.default_locale,
            "doc_count": self.doc_count,
            "max_doc_id": self.max_doc_id,
            "deleted": sorted(live.deleted),
            # cumulative dead slots (folded deletions included): restores
            # the alive mask on load
            "dead": np.nonzero(self._alive[: self.max_doc_id + 1] == 0.0)[0].tolist(),
            "offset": offset,
            "fields": [dataclasses.asdict(f) for f in live.fields.values()],
        }
        atomic_write_json(os.path.join(gen_dir, "manifest.json"), manifest)
        # pointer swap last — readers of a torn commit see the old generation
        atomic_write_json(os.path.join(data_dir, "info.json"), {"generation": offset})
        # snapshot GC: prune generations older than the kept window
        if keep_generations > 0:
            import re as _re
            import shutil as _shutil

            gens = []
            for name in os.listdir(data_dir):
                mo = _re.match(r"^gen-(\d+)$", name)
                if mo:
                    gens.append(int(mo.group(1)))
            for g in sorted(gens, reverse=True)[keep_generations:]:
                _shutil.rmtree(os.path.join(data_dir, f"gen-{g}"), ignore_errors=True)

    def _build_ann(self, committed: CommittedVectorIndex) -> None:
        """The commit-time ANN builds of the reference, on the reader's
        device, once the field holds ``ivf_threshold`` rows: IVF lists
        (then nprobe autotuned), PQ codes, or both (IVF-PQ: residual codes,
        then nprobe and expand autotuned)."""
        cfg = self.cfg
        mode = cfg.vector_index
        if mode not in ANN_VMODES or committed.n_vectors < cfg.ivf_threshold:
            return
        dev = cfg.device
        rotate = {"on": True, "off": False}.get(cfg.pq_rotation, "auto")
        if mode in ("ivf", "ivf_pq"):
            committed.build_ivf(device=dev)
        if mode in ("pq", "ivf_pq"):
            committed.build_pq(rotate=rotate, device=dev)
        if mode in ("ivf", "ivf_pq") and cfg.ivf_autotune:
            committed.tune_nprobe(target_recall=cfg.ivf_autotune_target,
                                  device=dev)

    @staticmethod
    def load(data_dir: str, gpu_cfg: Optional[GpuConfig] = None) -> Optional["CollectionReader"]:
        pointer = read_json(os.path.join(data_dir, "info.json"))
        if not pointer:
            return None
        gen_dir = os.path.join(data_dir, f"gen-{pointer['generation']}")
        manifest = read_json(os.path.join(gen_dir, "manifest.json"))
        if not manifest:
            return None
        reader = CollectionReader(
            manifest["collection_id"],
            manifest["read_api_key"],
            manifest.get("description"),
            gpu_cfg,
            manifest.get("default_locale", "en"),
        )
        reader.doc_count = manifest["doc_count"]
        reader.max_doc_id = manifest["max_doc_id"]
        reader.deleted = set(manifest.get("deleted", []))
        reader.committed_offset = manifest["offset"]
        # dense doc ids: dead slots (cumulative) are masked; ghost slots
        # beyond max_doc_id stay dead
        reader._alive = np.zeros(reader.capacity, dtype=np.float32)
        reader._alive[: reader.max_doc_id + 1] = 1.0
        for d in manifest.get("dead", manifest.get("deleted", [])):
            if d < len(reader._alive):
                reader._alive[d] = 0.0
        for fdata in manifest["fields"]:
            fdata["type"] = ValueType(fdata["type"])
            if fdata.get("embedding_sources") is not None:
                fdata["embedding_sources"] = tuple(fdata["embedding_sources"])
            reader._apply_locked(CreateFieldOp(reader.id, TypedField(**fdata)))
        for fid, f in reader.fields.items():
            if f.type == ValueType.STRING:
                arrays = read_npz(os.path.join(gen_dir, f"string-{fid}.npz"))
                if arrays:
                    reader._string[fid].committed = CommittedStringIndex.from_arrays(arrays)
                kw_arrays = read_npz(os.path.join(gen_dir, f"keyword-{fid}.npz"))
                if kw_arrays:
                    reader._keyword[fid].committed = CommittedKeywordIndex.from_arrays(kw_arrays)
            elif f.type == ValueType.NUMBER:
                arrays = read_npz(os.path.join(gen_dir, f"number-{fid}.npz"))
                if arrays:
                    reader._number[fid].committed = CommittedNumberIndex.from_arrays(arrays)
            elif f.type == ValueType.BOOL:
                arrays = read_npz(os.path.join(gen_dir, f"bool-{fid}.npz"))
                if arrays:
                    reader._bool[fid].committed = CommittedBoolIndex.from_arrays(arrays)
            elif f.type == ValueType.EMBEDDING:
                arrays = read_npz(os.path.join(gen_dir, f"vector-{fid}.npz"))
                if arrays:
                    reader._vector[fid].committed = CommittedVectorIndex.from_arrays(arrays)
        return reader
