"""Vector scoring: similarity matmuls + per-doc accumulation.

Port of ``orama_core_tpu/ops/vector.py`` (exact mode; the reference's
brute-force scan, `uncommitted/vector.rs`). The committed corpus is bf16.
The reference multiplies bf16 operands with f32 accumulation
(``preferred_element_type=f32``); a torch bf16 matmul would round its
output to bf16, so here both operands are upcast to f32 before the
product (exact for bf16 inputs) and scores are never bf16. The upcast
runs in row chunks so a large corpus never needs a whole f32 copy.
Callers on the card disable TF32 (``torch.backends.cuda.matmul.
allow_tf32 = False``), so the f32 product is full precision.

On the card, the batched serving product over an identity layout
(``brute_force_scores_batch``) takes a hand-written kernel
(csrc/knn_dense_scores.cu): bf16 x bf16 products with f32 accumulation,
the reference's own arithmetic, written straight into the [B, n_docs]
doc scores with no f32 copy of the corpus. Every other corpus, and every
CPU tensor, takes the torch code, its plain twin."""

from __future__ import annotations

import torch

from . import _cuda
from ..utils import tracing

_CHUNK = 1 << 18  # corpus rows upcast at a time
# the widest bf16 row the streaming kernels take (csrc/knn_stream.cuh): a
# chunk of 8 queries, 16 bytes a column, beside the 64-KB corpus ring
_STREAM_MAX_D = 8192


def sims_f32(vecs: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """f32[P, Q]: ``vecs`` [P, D] against ``queries`` [Q, D], both rounded
    to the corpus dtype first (as the reference casts its queries), then
    multiplied in f32."""
    q = queries.to(vecs.dtype).to(torch.float32)
    if vecs.dtype == torch.float32:
        return vecs @ q.T
    out = torch.empty(vecs.shape[0], q.shape[0], dtype=torch.float32,
                      device=vecs.device)
    for lo in range(0, vecs.shape[0], _CHUNK):
        out[lo:lo + _CHUNK] = vecs[lo:lo + _CHUNK].to(torch.float32) @ q.T
    return out


def doc_scores(sims: torch.Tensor, vec_docs: torch.Tensor, n_docs: int,
               identity: bool) -> torch.Tensor:
    """[P] row scores -> [n_docs] doc scores (sum over a doc's rows). With
    ``identity`` (row i IS doc i) the scatter is a pad/slice."""
    p = sims.shape[0]
    if identity:
        if p >= n_docs:
            return sims[:n_docs]
        return torch.nn.functional.pad(sims, (0, n_docs - p))
    out = torch.zeros(n_docs, dtype=torch.float32, device=sims.device)
    return out.index_add_(0, vec_docs.long(), sims)


def brute_force_scores(vecs, vec_docs, vec_valid, query, filter_mask,
                       n_docs: int, identity: bool = False) -> torch.Tensor:
    """float32[n_docs]: sum of relu(cos) over each doc's vectors."""
    sims = sims_f32(vecs, query[None, :])[:, 0]
    sims = torch.clamp(sims, min=0.0) * vec_valid
    return doc_scores(sims, vec_docs, n_docs, identity) * filter_mask


def selective_scores(vecs, rows, row_docs, row_valid, query,
                     n_docs: int) -> torch.Tensor:
    """Gather-then-score for selective filters: score only the candidate
    docs' vector rows (same semantics as brute_force_scores restricted to
    the candidate set)."""
    vr = vecs[rows.long()]
    sims = sims_f32(vr, query[None, :])[:, 0]
    sims = torch.clamp(sims, min=0.0) * row_valid
    out = torch.zeros(n_docs, dtype=torch.float32, device=vecs.device)
    return out.index_add_(0, row_docs.long(), sims)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the streaming kernels read queries: rows in 16-byte loads,
    so the base must be 16-byte aligned (a fresh copy where a view is
    not)."""
    return t.clone() if t.data_ptr() % 16 else t


def dense_scores(vecs, vec_valid, queries, filter_mask,
                 n_docs: int) -> torch.Tensor:
    """The dense scores kernel: float32[B, n_docs] with row r of query q
    ``max(q_bf16 . vecs[r], 0) * vec_valid[r] * filter_mask[r]`` for r <
    min(P, n_docs) and ``0 * filter_mask[r]`` past the corpus, as
    ``brute_force_scores_batch`` computes over an identity layout. Raises
    ValueError on inputs the kernel cannot read: a corpus that is not a
    contiguous bf16 [P, D] with D % 8 == 0, D <= _STREAM_MAX_D and a
    16-byte aligned base (TMA boxes), row validity or a doc mask that is
    not a contiguous f32 [P] or [n_docs], or a tensor off the corpus's
    card."""
    if (vecs.dtype != torch.bfloat16 or vecs.dim() != 2
            or not vecs.is_contiguous()):
        raise ValueError(f"the dense scores kernel reads a contiguous bf16 "
                         f"[P, D] corpus, not {vecs.dtype} "
                         f"{tuple(vecs.shape)}")
    p, d = vecs.shape
    if d % 8 or d > _STREAM_MAX_D:
        raise ValueError(f"the dense scores kernel needs D % 8 == 0 and "
                         f"D <= {_STREAM_MAX_D} (D={d})")
    if vecs.data_ptr() % 16:
        raise ValueError("the dense scores kernel reads the corpus through "
                         "a TMA tensor map: vecs must start 16-byte aligned")
    for t, n, name in ((vec_valid, p, "vec_valid"),
                       (filter_mask, n_docs, "filter_mask")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n,)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: the dense scores kernel reads a "
                             f"contiguous f32 [{n}], not {t.dtype} "
                             f"{tuple(t.shape)}")
    q = queries.to(torch.bfloat16).contiguous()
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"queries {tuple(q.shape)} against a corpus of "
                         f"width {d}")
    if not (vecs.is_cuda and all(t.device == vecs.device
                                 for t in (vec_valid, filter_mask, q))):
        raise ValueError("the dense scores kernel needs every tensor on the "
                         "corpus's card")
    q = _aligned(q)
    out = torch.empty(q.shape[0], n_docs, dtype=torch.float32,
                      device=vecs.device)
    lib = _cuda.lib("knn_dense_scores")
    _cuda.LAUNCHES["knn_dense_scores"] += 1
    _cuda.check(lib.knn_dense_scores(
        _cuda.ptr(vecs), _cuda.ptr(q), _cuda.ptr(vec_valid),
        _cuda.ptr(filter_mask), _cuda.ptr(out), int(min(p, n_docs)),
        int(n_docs), int(d), int(q.shape[0]), _cuda.stream(),
    ), "knn_dense_scores")
    return out


def brute_force_scores_batch(vecs, vec_docs, vec_valid, queries, filter_mask,
                             n_docs: int, identity: bool = False
                             ) -> torch.Tensor:
    """float32[B, n_docs], the micro-batched serving path: one product for
    the whole query batch ``queries`` [B, D] (the corpus read once for B
    queries). A bf16 corpus on the card in the identity layout takes the
    dense scores kernel, which raises where it cannot read its inputs;
    every other corpus (on the CPU, in f32, with several rows a doc, or
    with no rows to read) has no kernel and takes
    ``brute_force_scores_batch_plain``. The open span is told which ran
    (``route``: ``kernel`` or ``torch``)."""
    if (vecs.is_cuda and identity and vecs.dtype == torch.bfloat16
            and vecs.shape[0] > 0):
        tracing.note(route="kernel")
        return dense_scores(vecs, vec_valid, queries, filter_mask, n_docs)
    tracing.note(route="torch")
    return brute_force_scores_batch_plain(vecs, vec_docs, vec_valid, queries,
                                          filter_mask, n_docs, identity)


def brute_force_scores_batch_plain(vecs, vec_docs, vec_valid, queries,
                                   filter_mask, n_docs: int,
                                   identity: bool = False) -> torch.Tensor:
    """The torch version of ``brute_force_scores_batch``, on any device.
    With ``identity`` the per-row scatter is a pad/slice; otherwise each
    row is summed per doc by its own ``index_add_``."""
    sims = torch.clamp(sims_f32(vecs, queries), min=0.0) * vec_valid[:, None]
    sims = sims.T                                            # [B, P]
    p = sims.shape[1]
    if identity:
        if p >= n_docs:
            scores = sims[:, :n_docs]
        else:
            scores = torch.nn.functional.pad(sims, (0, n_docs - p))
    else:
        docs = vec_docs.long()
        scores = torch.zeros(sims.shape[0], n_docs, dtype=torch.float32,
                             device=vecs.device)
        for row in range(sims.shape[0]):
            scores[row].index_add_(0, docs, sims[row])
    return scores * filter_mask[None, :]


def selective_scores_batch(vecs, rows, row_docs, row_valid, queries,
                           n_docs: int) -> torch.Tensor:
    """[B, n_docs] batch variant of selective_scores: one candidate set
    shared by the batch (the micro-batcher keys on the filter)."""
    vr = vecs[rows.long()]
    sims = torch.clamp(sims_f32(vr, queries), min=0.0) * row_valid[:, None]
    sims = sims.T                                            # [B, R]
    docs = row_docs.long()
    out = torch.zeros(sims.shape[0], n_docs, dtype=torch.float32,
                      device=vecs.device)
    for row in range(sims.shape[0]):
        out[row].index_add_(0, docs, sims[row])
    return out
