"""Int8 vector compression: the capacity mode of the vector index.

Port of ``orama_core_tpu/ops/quant.py``. Per-vector symmetric int8:
``codes = clip(round(v / scale), -127, 127)`` with ``scale = max(max|v|,
1e-9) / 127``, the reference's f32 sequence step for step, so the codes
and scales equal the reference's bit for bit (``torch.round`` and
``jnp.round`` both round half to even). XLA compiles the reference's
division by the constant 127 as a multiply by its f32 reciprocal, so the
port multiplies by that reciprocal too. A score is an exact integer
product of int8 codes rescaled by the per-row and per-query scales.

Integer products: CUDA torch has no int8 or int32 ``matmul``. The dense
corpus product goes to ``torch._int_mm`` (int8 x int8 -> int32), which
wants more than 16 rows, a depth that is a multiple of 8 and a multiple
of 8 columns; the query batch is padded to 8 columns. Where those rules
do not hold (a tiny corpus, an odd width) and for the small gathers of
phase 2, the product runs in f32 on the integer codes, which is exact:
|code * code| <= 127 * 127 = 16,129, so every partial sum stays below
2^24 for D <= 1040 (the registry's widest model is 1024). The f32 route
raises above that width. The [P, D] corpus codes are never upcast whole.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import topk_stable

# every int8 x int8 sum of at most this many terms is exact in f32
F32_EXACT_MAX_D = (1 << 24) // (127 * 127)   # 1040
_CHUNK = 1 << 18  # corpus rows upcast at a time on the f32 route
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_int8(vecs: torch.Tensor):
    """[P, D] f32 -> (codes int8[P, D], scales f32[P])."""
    v = vecs.to(torch.float32)
    absmax = v.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax, 1e-9) * _INV_127
    codes = torch.clamp(torch.round(v / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_int8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scales[:, None]


def _check_f32_exact(d: int) -> None:
    if d > F32_EXACT_MAX_D:
        raise ValueError(
            f"int8 products of width {d} are not exact in f32 (at most "
            f"{F32_EXACT_MAX_D})"
        )


def int8_matmul(codes: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """int32[P, Q]: exact ``codes`` int8[P, D] times ``q8`` int8[Q, D]^T."""
    p, d = codes.shape
    qn = q8.shape[0]
    if p > 16 and d % 8 == 0 and d > 0:
        qpad = -(-max(qn, 1) // 8) * 8
        qp = torch.zeros(qpad, d, dtype=torch.int8, device=codes.device)
        qp[:qn] = q8
        # [D, Qpad] column-major: the int8 GEMM's preferred layout
        return torch._int_mm(codes.contiguous(), qp.T)[:, :qn]
    _check_f32_exact(d)
    qf = q8.to(torch.float32)
    out = torch.empty(p, qn, dtype=torch.int32, device=codes.device)
    for lo in range(0, p, _CHUNK):
        out[lo:lo + _CHUNK] = (
            codes[lo:lo + _CHUNK].to(torch.float32) @ qf.T).to(torch.int32)
    return out


def int8_gather_dot(codes: torch.Tensor, q8: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """f32[Q, C]: query q's exact integer product with each of its C
    gathered rows ``codes[rows[q]]`` (phase 2 of the int8 kNN). The sums
    are integers below 2^24, so the f32 product is exact (D <= 1040)."""
    _check_f32_exact(codes.shape[1])
    cand = codes[rows.long()].to(torch.float32)              # [Q, C, D]
    return torch.einsum("qd,qcd->qc", q8.to(torch.float32), cand)


def int8_brute_force_scores(codes, scales, vec_docs, vec_valid, query,
                            filter_mask, n_docs: int) -> torch.Tensor:
    """float32[n_docs]: the contract of ``vector.brute_force_scores`` on
    int8 storage (the query is quantized on the fly)."""
    q8, q_scale = quantize_int8(query[None, :])
    acc = int8_matmul(codes, q8)[:, 0]
    sims = acc.to(torch.float32) * scales * q_scale[0]
    sims = torch.clamp(sims, min=0.0) * vec_valid
    out = torch.zeros(n_docs, dtype=torch.float32, device=codes.device)
    return out.index_add_(0, vec_docs.long(), sims) * filter_mask


def int8_topk_sims(codes, scales, vec_valid, queries, k: int):
    """Batched int8 exact top-k: (values f32[Q, k], indices int64[Q, k])."""
    q8, q_scale = quantize_int8(queries)
    acc = int8_matmul(codes, q8).T                            # [Q, P]
    sims = acc.to(torch.float32) * scales[None, :] * q_scale[:, None]
    sims = torch.where(vec_valid[None, :] > 0, sims,
                       torch.full_like(sims, float("-inf")))
    return topk_stable(sims, k)
