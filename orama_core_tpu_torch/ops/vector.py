"""Vector scoring: similarity matmuls + per-doc accumulation.

Port of ``orama_core_tpu/ops/vector.py`` (exact mode; the reference's
brute-force scan, `uncommitted/vector.rs`). The committed corpus is bf16.
The reference multiplies bf16 operands with f32 accumulation
(``preferred_element_type=f32``); a torch bf16 matmul would round its
output to bf16, so here both operands are upcast to f32 before the
product (exact for bf16 inputs) and scores are never bf16. The upcast
runs in row chunks so a large corpus never needs a whole f32 copy.
Callers on the card disable TF32 (``torch.backends.cuda.matmul.
allow_tf32 = False``), so the f32 product is full precision."""

from __future__ import annotations

import torch

_CHUNK = 1 << 18  # corpus rows upcast at a time


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


def brute_force_scores_batch(vecs, vec_docs, vec_valid, queries, filter_mask,
                             n_docs: int, identity: bool = False
                             ) -> torch.Tensor:
    """float32[B, n_docs], the micro-batched serving path: one product for
    the whole query batch ``queries`` [B, D] (the corpus read once for B
    queries). With ``identity`` the per-row scatter is a pad/slice;
    otherwise each row is summed per doc by its own ``index_add_``."""
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
