"""Fused brute-force kNN: streaming sub-block max + exact rescore.

Port of ``orama_core_tpu/ops/pallas_knn.py`` (single-vector bf16/f32; the
int8 and multi-vector kernels are a later slice). The selection is split
in two phases, as in the reference:

  Phase 1 (K2, csrc/knn_subblock_max.cu): the corpus streams once against
  the queries and ONLY the per-sub-block max similarity (and the count of
  sims > 0) per query is written; the [N, Q] similarities never reach
  device memory.

  Phase 2: the k best sub-blocks per query are picked (tiered block-max
  filter) and their rows rescored exactly (K3, csrc/knn_rescore.cu), then
  the final top-k is taken from the k*SUB candidates.

Exactness: every true top-k element lives in a sub-block whose max is >=
the k-th best value, and at most k sub-blocks can have a max above it, so
the top-k sub-blocks by max contain the true top-k.

The reference pads query batches to 8 rows and selects the owner query's
rescore row with a one-hot matmul; both are TPU layout rules, not
contracts, and the port does neither. The K2/K3 kernels take bf16
corpora (the engine's layout); their plain versions take bf16 or f32.
"""

from __future__ import annotations

import torch

from . import _cuda
from .topk import topk_stable
from .vector import sims_f32

NEG = -3.0e38

_TIER_GROUP = 128  # sub-blocks per selection group


def _pick_sub(block_rows: int, sub_rows: int) -> int:
    """Sub-block size, as the reference picks it (block_rows / sub stays a
    multiple of 8)."""
    sub = min(sub_rows, block_rows // 8)
    while sub > 1 and block_rows % (8 * sub):
        sub //= 2
    return sub


# -- K2: per-sub-block max / positive count -----------------------------------


def subblock_max_plain(vecs: torch.Tensor, queries: torch.Tensor, sub: int,
                       n_valid: int):
    """Plain torch version of K2: (bmax f32[N/sub, Q], bcnt int32[N/sub, Q])
    of the [N, Q] sims, rows >= n_valid scoring NEG (and never counted)."""
    n = vecs.shape[0]
    sims = sims_f32(vecs, queries)                           # [N, Q]
    rows = torch.arange(n, device=vecs.device)[:, None]
    sims = torch.where(rows < n_valid, sims, torch.full_like(sims, NEG))
    s3 = sims.reshape(n // sub, sub, -1)
    return s3.amax(dim=1), (s3 > 0).sum(dim=1).to(torch.int32)


def subblock_max(vecs: torch.Tensor, queries: torch.Tensor, sub: int,
                 n_valid: int):
    """K2: per-sub-block max and positive count, (f32[N/sub, Q],
    int32[N/sub, Q]). Sub-blocks at or above n_valid come out as NEG / 0
    without a read of their rows."""
    if not vecs.is_cuda:
        return subblock_max_plain(vecs, queries, sub, n_valid)
    _cuda.require(vecs, "vecs", torch.bfloat16, 2)
    queries = queries.to(torch.bfloat16).contiguous()
    _cuda.require(queries, "queries", torch.bfloat16, 2)
    n, d = vecs.shape
    qn = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError("queries and vecs differ in dimension")
    if d % 8 or sub % 32 or n % sub:
        raise ValueError(f"K2 needs D % 8 == 0 and sub % 32 == 0 (D={d}, "
                         f"sub={sub}, N={n})")
    if vecs.data_ptr() % 16:
        raise ValueError("K2 reads the corpus in 16-byte chunks: vecs must "
                         "start 16-byte aligned")
    bmax = torch.empty(n // sub, qn, dtype=torch.float32, device=vecs.device)
    bcnt = torch.empty(n // sub, qn, dtype=torch.int32, device=vecs.device)
    lib = _cuda.lib("knn_subblock_max")
    _cuda.LAUNCHES["knn_subblock_max"] += 1
    _cuda.check(lib.knn_subblock_max(
        _cuda.ptr(vecs), _cuda.ptr(queries), _cuda.ptr(bmax),
        _cuda.ptr(bcnt), int(n), int(d), int(qn), int(sub), int(n_valid),
        _cuda.stream(),
    ), "knn_subblock_max")
    return bmax, bcnt


# -- K3: rescore of selected sub-blocks ---------------------------------------


def rescore_subblocks_plain(vecs: torch.Tensor, queries: torch.Tensor,
                            sub_ids_flat: torch.Tensor, k: int, sub: int):
    """Plain torch version of K3: f32[nsel, sub], the exact sims of each
    selected sub-block's rows against its owner query (slot g belongs to
    query g // k)."""
    nsel = sub_ids_flat.shape[0]
    dev = vecs.device
    rows = sub_ids_flat.long()[:, None] * sub + torch.arange(sub, device=dev)
    slab = vecs[rows].to(torch.float32)                      # [nsel, sub, D]
    owner = torch.arange(nsel, device=dev) // k
    q = queries.to(vecs.dtype).to(torch.float32)[owner]      # [nsel, D]
    return torch.einsum("gsd,gd->gs", slab, q)


def rescore_subblocks(vecs: torch.Tensor, queries: torch.Tensor,
                      sub_ids_flat: torch.Tensor, k: int, sub: int):
    """K3: exact rescore of the selected sub-blocks -> f32[nsel, sub]."""
    if not vecs.is_cuda:
        return rescore_subblocks_plain(vecs, queries, sub_ids_flat, k, sub)
    _cuda.require(vecs, "vecs", torch.bfloat16, 2)
    queries = queries.to(torch.bfloat16).contiguous()
    ids = sub_ids_flat.to(torch.int32).contiguous()
    _cuda.require(ids, "sub_ids", torch.int32, 1)
    n, d = vecs.shape
    qn = queries.shape[0]
    nsel = ids.shape[0]
    if d % 2:
        raise ValueError("K3 needs an even dimension")
    if nsel > qn * k:
        raise ValueError("more selected slots than queries * k")
    out = torch.empty(nsel, sub, dtype=torch.float32, device=vecs.device)
    lib = _cuda.lib("knn_rescore")
    _cuda.LAUNCHES["knn_rescore"] += 1
    _cuda.check(lib.knn_rescore(
        _cuda.ptr(vecs), _cuda.ptr(queries), _cuda.ptr(ids), _cuda.ptr(out),
        int(nsel), int(d), int(qn), int(k), int(sub), _cuda.stream(),
    ), "knn_rescore")
    return out


# -- phase 2 selection --------------------------------------------------------


def _tiered_subblock_topk(bmax: torch.Tensor, k: int, group: int = _TIER_GROUP):
    """Exact top-k sub-block ids int64[Q, k] from the [nsub, Q] phase-1
    table via the block-max filter applied recursively: per-group max,
    top-k groups, then top-k inside the k winning groups' slices."""
    n, qn = bmax.shape
    ng = -(-n // group)
    if ng <= 2 or k > ng:
        return topk_stable(bmax.T, min(k, n))[1]
    if ng * group != n:
        pad = torch.full((ng * group - n, qn), NEG, dtype=bmax.dtype,
                         device=bmax.device)
        bmax = torch.cat([bmax, pad], 0)
    g3 = bmax.reshape(ng, group, qn)
    gmax_t = g3.amax(dim=1).T                                # [Q, ng]
    gi = topk_stable(gmax_t, k)[1]                           # [Q, k]
    q_ix = torch.arange(qn, device=bmax.device)[:, None]
    sl = g3.permute(2, 0, 1)[q_ix, gi]                       # [Q, k, group]
    li = topk_stable(sl.reshape(qn, k * group), k)[1]
    return torch.gather(gi, 1, li // group) * group + li % group


def _candidate_rows(sub_ids: torch.Tensor, sub: int) -> torch.Tensor:
    qn, k = sub_ids.shape
    ar = torch.arange(sub, device=sub_ids.device)
    return (sub_ids[:, :, None] * sub + ar).reshape(qn, k * sub)


def _final_topk(sims, rows, k, n_valid):
    sims = torch.where(rows < n_valid, sims, torch.full_like(sims, NEG))
    v, i = topk_stable(sims, k)
    return v, torch.gather(rows, 1, i).to(torch.int32)


def _select_and_rescore(vecs, queries, bmax, k, sub, n_valid, qn):
    """Phase 2 fast path: tiered exact sub-block selection + K3 rescore."""
    sub_ids = _tiered_subblock_topk(bmax, k)                 # [Q, k]
    out = rescore_subblocks(vecs, queries, sub_ids.reshape(-1), k, sub)
    sims = out.reshape(qn, k * sub)
    return _final_topk(sims, _candidate_rows(sub_ids, sub), k, n_valid)


def _rescore_topk(bmax_t, vecs, queries, k, sub, n_valid, qn):
    """Phase 2 for sub % 8 != 0: pick the k best sub-blocks per query from
    bmax_t [Q, nsub], gather and rescore their rows exactly, final top-k."""
    nsub = bmax_t.shape[1]
    if nsub >= 4 * _TIER_GROUP and k <= nsub:
        sub_ids = _tiered_subblock_topk(bmax_t.T, k)
    else:
        sub_ids = topk_stable(bmax_t, k)[1]
    rows = _candidate_rows(sub_ids, sub)
    cand = vecs[rows].to(torch.float32)                      # [Q, k*SUB, D]
    q = queries.to(vecs.dtype).to(torch.float32)
    sims = torch.einsum("qd,qcd->qc", q, cand)
    return _final_topk(sims, rows, k, n_valid)


def _dense_topk_with_count(vecs, queries, k, n_valid):
    """Small corpus: the candidate phase would touch most rows anyway."""
    sims = sims_f32(vecs, queries).T                         # [Q, N]
    cols = torch.arange(sims.shape[1], device=sims.device)[None, :]
    sims = torch.where(cols < n_valid, sims, torch.full_like(sims, NEG))
    v, i = topk_stable(sims, k)
    cnt = (sims > 0).sum(dim=1).to(torch.int32)
    return v, i.to(torch.int32), cnt


def knn_topk_with_count(vecs: torch.Tensor, queries: torch.Tensor,
                        k: int = 10, block_rows: int = 2048,
                        sub_rows: int = 32, n_valid: int = -1):
    """(values f32[Q, k], indices int32[Q, k], count int32[Q]): exact top-k
    over the corpus plus each query's count of sims > 0 (the engine's
    vector-mode match count), from one streaming pass."""
    n, _d = vecs.shape
    qn = queries.shape[0]
    if n % block_rows:
        raise ValueError("pad corpus to a multiple of block_rows")
    if n_valid < 0:
        n_valid = n
    sub = _pick_sub(block_rows, sub_rows)
    nsub = n // sub
    if k * sub * 4 >= n_valid or k > nsub:
        return _dense_topk_with_count(vecs, queries, k, n_valid)
    bmax, bcnt = subblock_max(vecs, queries, sub, n_valid)
    count = bcnt.sum(dim=0, dtype=torch.int32)               # [Q]
    if sub % 8 == 0:
        v, i = _select_and_rescore(vecs, queries, bmax, k, sub, n_valid, qn)
    else:
        v, i = _rescore_topk(bmax.T, vecs, queries, k, sub, n_valid, qn)
    return v, i, count


def knn_topk(vecs: torch.Tensor, queries: torch.Tensor, k: int = 10,
             block_rows: int = 2048, sub_rows: int = 32, n_valid: int = -1):
    """(values f32[Q, k], indices int32[Q, k]) — exact brute-force top-k."""
    v, i, _ = knn_topk_with_count(
        vecs, queries, k=k, block_rows=block_rows, sub_rows=sub_rows,
        n_valid=n_valid,
    )
    return v, i
