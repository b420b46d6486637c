"""Product quantization with asymmetric-distance (ADC) scoring.

Port of ``orama_core_tpu/ops/pq.py`` (which supersedes the reference's
disabled PQ demo, `bin/embeddings/pq.rs`):

- Train: D is split into M subspaces of D/M dims; Euclidean k-means per
  subspace. The reference vmaps the M trainings into one program, whose
  [M, P, C] f32 similarities would not fit the card at 1M rows; here the
  subspaces train one after another (``ops/ivf.kmeans``, rows in chunks).
- Encode: per subspace, the nearest centroid -> uint8 codes [P, M].
- Score (ADC): per query the [M, C] table of subquery·centroid products,
  then score = sum_m LUT[m, code[p, m]]. The reference runs C
  compare-accumulate passes (gathers are slow on a TPU); the port gathers
  from the table and sums over m, the same sum in another order.

All plain torch on the tensors' device: no function here reaches a
Pallas kernel in the reference."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ivf import _rows_per_block, adc_lut, gathered_sims, kmeans
from .topk import topk_stable

_ROWS = 1 << 18  # rows of the ADC scan gathered at a time


def pq_train(vecs: torch.Tensor, generator: torch.Generator, m: int,
             n_codes: int = 256, iters: int = 10) -> torch.Tensor:
    """f32[M, n_codes, D/M] codebooks: one Euclidean k-means per subspace,
    initial rows drawn from ``generator`` subspace after subspace."""
    d = vecs.shape[1]
    ds = d // m
    return torch.stack([
        kmeans(vecs[:, i * ds:(i + 1) * ds], generator, n_codes, iters,
               spherical=False)
        for i in range(m)
    ])


def pq_encode(vecs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """uint8[P, M]: the nearest centroid per subspace, argmin |v - c|² =
    argmax (v·c - |c|²/2)."""
    p, d = vecs.shape
    m, _c, ds = codebooks.shape
    books = codebooks.to(torch.float32)
    half_sq = 0.5 * torch.sum(books ** 2, dim=-1)             # [M, C]
    out = torch.empty(p, m, dtype=torch.uint8, device=vecs.device)
    step = _rows_per_block(m * books.shape[1])    # [rows, M, C] f32 blocks
    for lo in range(0, p, step):
        sub = vecs[lo:lo + step].to(torch.float32).reshape(-1, m, ds)
        sims = torch.einsum("pmd,mcd->pmc", sub, books) - half_sq[None]
        out[lo:lo + step] = torch.argmax(sims, dim=-1).to(torch.uint8)
    return out


def adc_scores(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """f32[Q, P]: sum over m of lut[q, m, codes[p, m]] for every row."""
    q_n, m, c = lut.shape
    flat = lut.reshape(q_n, m * c)
    offs = torch.arange(m, device=codes.device) * c
    out = torch.empty(q_n, codes.shape[0], dtype=torch.float32,
                      device=codes.device)
    for lo in range(0, codes.shape[0], _ROWS):
        idx = (codes[lo:lo + _ROWS].long() + offs).reshape(-1)
        out[:, lo:lo + _ROWS] = flat.index_select(1, idx).reshape(
            q_n, -1, m).sum(-1)
    return out


def pq_topk(codes, codebooks, vec_valid, queries, k: int, rotation=None):
    """Batched ADC top-k over every row: (scores f32[Q, k], row ids
    int64[Q, k]). ``rotation`` [D, D]: the codes live in ``v @ R``."""
    scores = adc_scores(codes, adc_lut(codebooks, queries, rotation))
    scores = scores.masked_fill(~(vec_valid[None, :] > 0), float("-inf"))
    return topk_stable(scores, k)


def pq_topk_rerank(codes, codebooks, vecs, vec_valid, queries, k: int,
                   expand: int = 10, rotation=None):
    """Two-stage search: ADC generates k·expand candidates, exact products
    of the unrotated query with the stored rows rerank them. Returns
    (scores f32[Q, k], row ids int64[Q, k])."""
    cand_k = min(k * expand, codes.shape[0])
    _, cand = pq_topk(codes, codebooks, vec_valid, queries, cand_k,
                      rotation=rotation)
    sims = gathered_sims(vecs, cand, queries)
    v, i = topk_stable(sims, k)
    return v, torch.gather(cand, 1, i)


def pq_reconstruct(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """f32[P, D]: each subspace's chosen centroid, concatenated (what ADC
    implicitly scores against)."""
    m = codebooks.shape[0]
    books = codebooks.to(torch.float32)
    return torch.cat([books[i][codes[:, i].long()] for i in range(m)], dim=1)


def residuals(vecs: torch.Tensor, cents: torch.Tensor,
              assign: torch.Tensor) -> torch.Tensor:
    """v - cents[cluster(v)]: what residual IVF-PQ quantizes."""
    return vecs - cents[assign.long()]


def choose_rotation(vecs: torch.Tensor, m: int, seed: int,
                    n_codes: int = 256) -> Optional[np.ndarray]:
    """Data-driven OPQ decision: train trial codebooks in the raw and the
    PCA-balanced basis on a sample (both from ``seed``'s draws) and keep
    the basis with the lower held-out reconstruction error. Rotation wins
    on sparse, lexical-style embeddings and loses where the raw basis
    carries strong intra-subspace correlation. Returns the [D, D]
    rotation or None."""
    n = vecs.shape[0]
    n_tr = min(n, 16_384)
    n_ho = min(max(n - n_tr, 0), 4_096)
    if n_ho < 256:  # tiny corpora: hold out a slice of the training rows
        n_tr = max(1, (n * 3) // 4)
        n_ho = n - n_tr
    if n_ho <= 0 or m <= 1:
        return None
    train = vecs[:n_tr].to(torch.float32)
    hold = vecs[n_tr:n_tr + n_ho].to(torch.float32)
    rot = opq_rotation(train, m)
    rot_t = torch.as_tensor(rot, device=vecs.device)

    def held_out_mse(tr, ho):
        books = pq_train(tr, torch.Generator().manual_seed(seed), m=m,
                         n_codes=n_codes)
        recon = pq_reconstruct(pq_encode(ho, books), books)
        return float(torch.mean((ho - recon) ** 2))

    raw = held_out_mse(train, hold)
    rotated = held_out_mse(train @ rot_t, hold @ rot_t)
    return rot if rotated < raw else None


def opq_rotation(vecs: torch.Tensor, m: int) -> np.ndarray:
    """Parametric OPQ rotation (Ge et al., CVPR'13 eigenvalue allocation):
    an orthonormal R [D, D] such that quantizing ``v @ R`` balances
    variance across the M subspaces. The covariance is taken on the
    tensors' device; the eigendecomposition and the greedy allocation
    (eigen-directions in descending variance, each to the subspace with
    the smallest log-variance sum) are the reference's host numpy."""
    v = vecs.to(torch.float32)
    vc = v - torch.mean(v, dim=0, keepdim=True)
    cov = (vc.T @ vc).cpu().numpy() / max(v.shape[0], 1)
    w, u = np.linalg.eigh(cov)             # ascending eigenvalues
    order = np.argsort(w)[::-1]
    w, u = w[order], u[:, order]
    d = cov.shape[0]
    ds = d // m
    buckets: list = [[] for _ in range(m)]
    sums = np.zeros(m)
    for i in range(d):
        free = [b for b in range(m) if len(buckets[b]) < ds]
        b = min(free, key=lambda b: sums[b])
        buckets[b].append(i)
        sums[b] += float(np.log(max(w[i], 1e-12)))
    perm = [i for b in range(m) for i in buckets[b]]
    return np.ascontiguousarray(u[:, perm], dtype=np.float32)  # v @ R


def pq_compression_ratio(d: int, m: int, dtype_bytes: int = 4) -> float:
    return (d * dtype_bytes) / m

