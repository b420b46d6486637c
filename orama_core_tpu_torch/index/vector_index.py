"""Vector field index: packed normalized matrix + doc map.

Replaces the reference's HNSW graph (`committed/vector.rs`, hora crate) and
brute-force uncommitted scan (`uncommitted/vector.rs`). Committed vectors
live as one row-major [P, D] matrix (bf16 on device) with ``vec_docs``
mapping rows to documents (multi-vector docs supported, as in the reference
where a doc stores ``Vec<Vec<f32>>``). Exact search is an MXU matmul +
segment accumulation (ops/vector.py); IVF/PQ acceleration layers on top of
the same layout (ops/ivf.py, ops/pq.py).

Port of ``orama_core_tpu/index/vector_index.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


def _normalize(m: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(m, axis=-1, keepdims=True)
    return (m / np.maximum(n, 1e-12)).astype(np.float32)


class UncommittedVectorIndex:
    def __init__(self, dimension: int) -> None:
        self.dimension = dimension
        self.entries: List[Tuple[int, np.ndarray]] = []  # (doc, [k, D] normalized)

    @property
    def is_empty(self) -> bool:
        return not self.entries

    def insert(self, doc_id: int, vectors: Sequence[Sequence[float]]) -> None:
        m = np.asarray(vectors, dtype=np.float32)
        if m.ndim == 1:
            m = m[None, :]
        if m.shape[-1] != self.dimension:
            raise ValueError(
                f"vector dim {m.shape[-1]} != field dim {self.dimension}"
            )
        self.entries.append((doc_id, _normalize(m)))

    def search(
        self,
        query: np.ndarray,
        filter_mask: Optional[np.ndarray],
        deleted: Optional[Set[int]],
        out: Dict[int, float],
    ) -> None:
        """Host brute-force over the freshness window (small by construction).
        Scores: sum of relu(cosine) over the doc's vectors (the reference
        sums per-vector scores too, uncommitted/vector.rs:44-56)."""
        q = query.astype(np.float32)
        q = q / max(float(np.linalg.norm(q)), 1e-12)
        for doc_id, m in self.entries:
            if deleted and doc_id in deleted:
                continue
            if filter_mask is not None and filter_mask[doc_id] == 0:
                continue
            sims = m @ q
            s = float(np.maximum(sims, 0.0).sum())
            if s > 0.0:
                out[doc_id] = out.get(doc_id, 0.0) + s


@dataclasses.dataclass
class CommittedVectorIndex:
    dimension: int
    vecs: np.ndarray      # float32[P, D] normalized (bf16 cast on device)
    vec_docs: np.ndarray  # int32[P]
    # optional IVF acceleration state (built at commit when the corpus is
    # large enough — ops/ivf.py; replaces the reference's HNSW rebuild,
    # committed/vector.rs:222-236)
    ivf_cents: Optional[np.ndarray] = None   # [C, D]
    ivf_lists: Optional[np.ndarray] = None   # int32[C, cap]
    ivf_lens: Optional[np.ndarray] = None    # int32[C]
    # optional PQ compression state (ops/pq.py — supersedes the reference's
    # vestigial reductive-PQ demo, bin/embeddings/pq.rs)
    pq_codebooks: Optional[np.ndarray] = None  # [M, C, D/M]
    pq_codes: Optional[np.ndarray] = None      # uint8[P, M]
    # True => codes quantize IVF residuals (v - cents[cluster]) and ADC
    # adds back q·cents[cluster] — the FAISS IVF-PQ shape; flat PQ's
    # quantization noise swamps within-cluster margins at scale
    pq_residual: bool = False
    # parametric-OPQ basis [D, D]: codes quantize (residual @ R); the ADC
    # stage rotates the query, probe/rerank stay raw (ops/pq.opq_rotation)
    pq_rotation: Optional[np.ndarray] = None
    # (nprobe, ADC expand) chosen by tune_nprobe() against brute-force
    # ground truth (None => use the config defaults)
    tuned_nprobe: Optional[int] = None
    tuned_expand: Optional[int] = None

    @staticmethod
    def empty(dimension: int) -> "CommittedVectorIndex":
        return CommittedVectorIndex(
            dimension=dimension,
            vecs=np.zeros((0, dimension), dtype=np.float32),
            vec_docs=np.zeros(0, dtype=np.int32),
        )

    @property
    def has_ivf(self) -> bool:
        return self.ivf_cents is not None

    @property
    def has_pq(self) -> bool:
        return self.pq_codebooks is not None

    # The ANN builders (IVF lists, PQ codebooks, nprobe autotuning) train
    # on the device in the reference (vector_index.py:113-282). Only the
    # exact layout is ported in this slice.
    def build_pq(self, *args, **kwargs) -> None:
        raise NotImplementedError("IVF/PQ: a later port slice")

    def build_ivf(self, *args, **kwargs) -> None:
        raise NotImplementedError("IVF/PQ: a later port slice")

    def tune_nprobe(self, *args, **kwargs) -> Optional[int]:
        raise NotImplementedError("IVF/PQ: a later port slice")

    @property
    def n_vectors(self) -> int:
        return len(self.vec_docs)

    @property
    def is_empty(self) -> bool:
        return self.n_vectors == 0

    def merge(
        self, uncommitted: UncommittedVectorIndex, deleted: Optional[Set[int]] = None
    ) -> "CommittedVectorIndex":
        deleted = deleted or set()
        keep = (
            ~np.isin(self.vec_docs, list(deleted))
            if deleted and len(self.vec_docs)
            else slice(None)
        )
        parts_v = [self.vecs[keep]]
        parts_d = [self.vec_docs[keep]]
        for doc_id, m in uncommitted.entries:
            if doc_id in deleted:
                continue
            parts_v.append(m)
            parts_d.append(np.full(len(m), doc_id, dtype=np.int32))
        vecs = np.concatenate(parts_v) if parts_v else np.zeros((0, self.dimension), np.float32)
        docs = np.concatenate(parts_d) if parts_d else np.zeros(0, np.int32)
        return CommittedVectorIndex(
            dimension=self.dimension, vecs=vecs.astype(np.float32), vec_docs=docs.astype(np.int32)
        )

    def to_arrays(self) -> Dict[str, np.ndarray]:
        out = {
            "vecs": self.vecs,
            "vec_docs": self.vec_docs,
            "dim": np.asarray([self.dimension], dtype=np.int64),
        }
        if self.has_ivf:
            out["ivf_cents"] = self.ivf_cents
            out["ivf_lists"] = self.ivf_lists
            out["ivf_lens"] = self.ivf_lens
        if self.has_pq:
            out["pq_codebooks"] = self.pq_codebooks
            out["pq_codes"] = self.pq_codes
            out["pq_residual"] = np.asarray([int(self.pq_residual)], np.int64)
            if self.pq_rotation is not None:
                out["pq_rotation"] = self.pq_rotation
        if self.tuned_nprobe is not None:
            out["tuned_nprobe"] = np.asarray([self.tuned_nprobe], np.int64)
        if self.tuned_expand is not None:
            out["tuned_expand"] = np.asarray([self.tuned_expand], np.int64)
        return out

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray]) -> "CommittedVectorIndex":
        tuned = arrays.get("tuned_nprobe")
        tuned_e = arrays.get("tuned_expand")
        return CommittedVectorIndex(
            dimension=int(arrays["dim"][0]),
            vecs=arrays["vecs"].astype(np.float32),
            vec_docs=arrays["vec_docs"].astype(np.int32),
            ivf_cents=arrays.get("ivf_cents"),
            ivf_lists=arrays.get("ivf_lists"),
            ivf_lens=arrays.get("ivf_lens"),
            pq_codebooks=arrays.get("pq_codebooks"),
            pq_codes=arrays.get("pq_codes"),
            pq_residual=bool(arrays.get("pq_residual", [0])[0]),
            pq_rotation=arrays.get("pq_rotation"),
            tuned_nprobe=int(tuned[0]) if tuned is not None else None,
            tuned_expand=int(tuned_e[0]) if tuned_e is not None else None,
        )
