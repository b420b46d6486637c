"""Vector field index: packed normalized matrix + doc map.

Replaces the reference's HNSW graph (`committed/vector.rs`, hora crate) and
brute-force uncommitted scan (`uncommitted/vector.rs`). Committed vectors
live as one row-major [P, D] matrix (bf16 on device) with ``vec_docs``
mapping rows to documents (multi-vector docs supported, as in the reference
where a doc stores ``Vec<Vec<f32>>``). Exact search is an MXU matmul +
segment accumulation (ops/vector.py); IVF/PQ acceleration layers on top of
the same layout (ops/ivf.py, ops/pq.py).

Port of ``orama_core_tpu/index/vector_index.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``. The ANN index builds (``build_ivf``,
``build_pq``, ``tune_nprobe``) train on the ``device`` their caller
passes (the reader's), with torch generators for their random draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

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

    def build_pq(
        self,
        m: Optional[int] = None,
        n_codes: int = 256,
        seed: int = 0,
        rotate: Any = "auto",
        device: str = "cuda",
    ) -> None:
        """Train per-subspace codebooks on ``device`` and encode the corpus.
        M defaults to D/8 (8 dims per subspace, ~32x compression at f32).
        ``rotate``: "auto" (default) measures held-out reconstruction error
        raw vs parametric-OPQ basis (ops/pq.choose_rotation) and keeps the
        better; True forces it, False disables."""
        import torch

        from ..ops import ivf as ivf_ops
        from ..ops import pq as pq_ops

        if self.n_vectors == 0:
            return
        d = self.dimension
        if m is None:
            m = max(1, d // 8)
        while d % m:
            m -= 1
        v = torch.as_tensor(np.asarray(self.vecs, np.float32), device=device)
        if self.has_ivf:
            # residual IVF-PQ: quantize v - cents[cluster(v)]
            cents = torch.as_tensor(self.ivf_cents, device=device)
            assign = ivf_ops.assign_clusters_chunked(v, cents)
            v = pq_ops.residuals(v, cents, torch.as_tensor(assign,
                                                           device=device))
            self.pq_residual = True
        else:
            self.pq_residual = False
        nc = min(n_codes, max(self.n_vectors, 2))
        if rotate == "auto" and m > 1:
            self.pq_rotation = pq_ops.choose_rotation(v, m, seed + 1,
                                                      n_codes=nc)
        elif rotate is True and m > 1:
            self.pq_rotation = pq_ops.opq_rotation(v, m)
        else:
            self.pq_rotation = None
        if self.pq_rotation is not None:
            v = v @ torch.as_tensor(self.pq_rotation, device=device)
        books = pq_ops.pq_train(v, torch.Generator().manual_seed(seed), m=m,
                                n_codes=nc)
        codes = pq_ops.pq_encode(v, books)
        self.pq_codebooks = books.cpu().numpy().astype(np.float32)
        self.pq_codes = codes.cpu().numpy().astype(np.uint8)

    def build_ivf(self, n_clusters: Optional[int] = None, seed: int = 0,
                  device: str = "cuda") -> None:
        """Cluster the corpus on ``device`` (spherical k-means) and pack
        member lists. C defaults to ~sqrt(P) rounded to a multiple of 8."""
        import torch

        from ..ops import ivf as ivf_ops

        p = self.n_vectors
        if p == 0:
            return
        if n_clusters is None:
            n_clusters = max(8, int(np.sqrt(p) / 8) * 8)
        n_clusters = min(n_clusters, max(1, p))
        v = torch.as_tensor(np.asarray(self.vecs, np.float32), device=device)
        cents = ivf_ops.kmeans(v, torch.Generator().manual_seed(seed),
                               n_clusters, iters=10)
        assign = ivf_ops.assign_clusters_chunked(v, cents)
        # skew control (ops/ivf.split_skewed): the list table pads to the
        # largest cluster, so oversized clusters are split until bounded
        # by ~4x the mean
        cents, assign = ivf_ops.split_skewed(
            v, cents, assign,
            target=max(256, 4 * p // n_clusters),
            rng=np.random.default_rng(seed + 1),
        )
        lists, lens, _ = ivf_ops.build_ivf_lists(assign, int(cents.shape[0]))
        self.ivf_cents = cents.cpu().numpy().astype(np.float32)
        self.ivf_lists = lists
        self.ivf_lens = lens

    def tune_nprobe(
        self,
        k: int = 10,
        target_recall: float = 0.95,
        n_sample: int = 128,
        expand: int = 10,
        seed: int = 7,
        device: str = "cuda",
    ) -> Optional[int]:
        """Autotune nprobe against brute-force ground truth on ``device``:
        sample held-out-style queries (perturbed corpus rows), double
        nprobe until recall@k >= target; with PQ, a plateau then doubles
        the ADC expand up to 128. Sets and returns ``tuned_nprobe``."""
        import torch

        from ..ops import ivf as ivf_ops
        from ..ops.topk import topk_stable

        if not self.has_ivf or self.n_vectors < 2 * k:
            return None
        rng = np.random.default_rng(seed)
        n_sample = min(n_sample, self.n_vectors)
        rows = rng.choice(self.n_vectors, size=n_sample, replace=False)
        q = self.vecs[rows] + 0.05 * rng.standard_normal(
            (n_sample, self.dimension)
        ).astype(np.float32)
        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        put = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
        q_dev = put(q.astype(np.float32))
        v_dev = put(np.asarray(self.vecs, np.float32))
        # brute-force ground truth, 16 queries at a time: one
        # [n_sample, P] sims matrix at 10M vectors is ~5 GB
        gt_parts = []
        for lo in range(0, n_sample, 16):
            _, gt_c = topk_stable(q_dev[lo:lo + 16] @ v_dev.T, k)
            gt_parts.append(gt_c.cpu().numpy())
        gt = np.concatenate(gt_parts, axis=0)
        cents, lists, lens = (put(self.ivf_cents), put(self.ivf_lists),
                              put(self.ivf_lens))
        n_clusters = self.ivf_lists.shape[0]
        if self.has_pq:
            codes, books = put(self.pq_codes), put(self.pq_codebooks)
            rot = (put(self.pq_rotation) if self.pq_rotation is not None
                   else None)

        def recall_at(nprobe: int, exp: int) -> float:
            if self.has_pq:
                _, ids = ivf_ops.ivf_pq_search(
                    codes, books, v_dev, cents, lists, lens, q_dev,
                    nprobe=nprobe, k=k, expand=exp,
                    residual=self.pq_residual, rotation=rot,
                )
            else:
                _, ids = ivf_ops.ivf_search(
                    v_dev, cents, lists, lens, q_dev, nprobe=nprobe, k=k
                )
            ids = ids.cpu().numpy()
            hits = sum(len(set(ids[i]) & set(gt[i])) for i in range(n_sample))
            return hits / float(n_sample * k)

        # grow nprobe until the target or a plateau; a plateau with PQ means
        # the ADC candidate budget is the bottleneck: grow expand instead
        nprobe, prev = 1, -1.0
        while True:
            recall = recall_at(nprobe, expand)
            if recall >= target_recall or nprobe >= n_clusters:
                break
            if self.has_pq and prev >= 0 and recall - prev < 0.005:
                break
            prev = recall
            nprobe = min(nprobe * 2, n_clusters)
        while self.has_pq and recall < target_recall and expand < 128:
            expand *= 2
            recall = recall_at(nprobe, expand)
        self.tuned_nprobe = int(nprobe)
        self.tuned_expand = int(expand)
        return self.tuned_nprobe

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
