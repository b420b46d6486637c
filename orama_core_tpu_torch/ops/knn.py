"""Fused brute-force kNN: streaming sub-block max + exact rescore.

Port of ``orama_core_tpu/ops/pallas_knn.py``: single-vector bf16/f32,
int8 (capacity mode) and multi-vector (chunked) documents. The selection
is split in two phases, as in the reference:

  Phase 1: the corpus streams once against the queries and ONLY the
  per-sub-block max similarity (and a positive count) per query is
  written; the [N, Q] similarities never reach device memory. K2
  (csrc/knn_subblock_max.cu) for bf16 rows, K5
  (csrc/knn_subblock_max_int8.cu) for int8 codes, K6
  (csrc/knn_subblock_max_mv.cu) for chunked docs, whose metric is the
  max of the per-doc running relu sum.

  Phase 2: the k best sub-blocks per query are picked (tiered block-max
  filter) and their rows rescored exactly (K3, csrc/knn_rescore.cu, for
  bf16 rows; a gather and product for int8 rows and chunked docs), then
  the final top-k is taken from the candidates.

Exactness: every true top-k element lives in a sub-block whose max is >=
the k-th best value, and at most k sub-blocks can have a max above it, so
the top-k sub-blocks by max contain the true top-k.

B1, the phase-1 probe forms of ``benchmarks/knn_tune_bench.py`` (K2
without the count, masked everywhere or at the edge, queries given as
[D, Q], and the bare product rows), live here too, for
``tools/knn_tune_bench.py`` (csrc/knn_phase1_variants.cu, on the one-pass
core csrc/knn_wide.cuh: up to 256 queries a corpus pass).

The reference pads query batches to 8 rows and selects the owner query's
rescore row with a one-hot matmul; both are TPU layout rules, not
contracts, and the port does neither. The K2/K3 kernels take bf16
corpora (the engine's layout); their plain versions take bf16 or f32.
"""

from __future__ import annotations

import torch

from . import _cuda, quant
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


# K2, K5 and K6 keep a chunk of at least 8 queries resident in shared
# memory beside a ring of corpus tiles (csrc/knn_stream.cuh; 64 KB in
# bf16, 48 KB in int8): 16 bytes a column in bf16 and 8 in int8, so widths
# up to 8,192 and 16,384 fit (every registry width is <= 1,024)
_STREAM_MAX_D = 8192
_STREAM_MAX_D_INT8 = 16384


def _aligned(queries: torch.Tensor) -> torch.Tensor:
    """The queries as K2/K6 read them: rows in 16-byte loads, so the base
    must be 16-byte aligned (a fresh copy where a view is not)."""
    return queries.clone() if queries.data_ptr() % 16 else queries


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
    if d % 8 or d > _STREAM_MAX_D or sub % 32 or n % sub:
        raise ValueError(f"K2 needs D % 8 == 0, D <= {_STREAM_MAX_D} and "
                         f"sub % 32 == 0 (D={d}, sub={sub}, N={n})")
    if vecs.data_ptr() % 16:
        raise ValueError("K2 reads the corpus through a TMA tensor map: vecs "
                         "must start 16-byte aligned")
    queries = _aligned(queries)
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


# -- B1: phase-1 probe forms (tools/knn_tune_bench.py) -----------------------

PROBE_SUBS = (32, 64, 128)  # the bench's sub-blocks (k_base, k_sub64, k_sub128)
_MAX_ONLY = {  # mask -> (the kernel's form, its launch count)
    "all": (0, "knn_max_only"),
    "edge": (1, "knn_max_only_edge"),
}


def subblock_max_only_plain(vecs: torch.Tensor, queries: torch.Tensor,
                            sub: int, n_valid: int,
                            mask: str = "all") -> torch.Tensor:
    """Plain torch version of the probes' max forms: K2's bmax f32[N/sub,
    Q] without the count, rows >= n_valid scoring NEG. ``mask`` says only
    where the kernel masks ("edge": the tile that crosses n_valid), not
    what it computes, so every row is masked here."""
    if mask not in _MAX_ONLY:
        raise ValueError(f"mask must be one of {tuple(_MAX_ONLY)}: {mask!r}")
    n = vecs.shape[0]
    sims = sims_f32(vecs, queries)                           # [N, Q]
    rows = torch.arange(n, device=vecs.device)[:, None]
    sims = torch.where(rows < n_valid, sims, torch.full_like(sims, NEG))
    return sims.reshape(n // sub, sub, -1).amax(dim=1)


def _max_only_launch(vecs, queries, qn, qd, sub, n_valid, form, key):
    """Launch form ``form`` of knn_max_only over ``qn`` queries of width
    ``qd`` (queries [Q, D], or qt [D, Q8] for form 2, Q8 = Q rounded up to
    8). The queries stream beside the corpus, so D is bounded by nothing
    in shared memory, unlike K2's."""
    _cuda.require(vecs, "vecs", torch.bfloat16, 2)
    _cuda.require(queries, "queries", torch.bfloat16, 2)
    n, d = vecs.shape
    if qd != d:
        raise ValueError("queries and vecs differ in dimension")
    if d % 8 or sub not in PROBE_SUBS or n % sub:
        raise ValueError(f"{key} needs D % 8 == 0, sub in {PROBE_SUBS} and "
                         f"N % sub == 0 (D={d}, sub={sub}, N={n})")
    if vecs.data_ptr() % 16:
        raise ValueError(f"{key} reads the corpus through a TMA tensor map: "
                         "vecs must start 16-byte aligned")
    bmax = torch.empty(n // sub, qn, dtype=torch.float32, device=vecs.device)
    lib = _cuda.lib("knn_phase1_variants")
    _cuda.LAUNCHES[key] += 1
    _cuda.check(lib.knn_max_only(
        _cuda.ptr(vecs), _cuda.ptr(queries), _cuda.ptr(bmax), int(n), int(d),
        int(qn), int(sub), int(n_valid), form, _cuda.stream(),
    ), key)
    return bmax


def subblock_max_only(vecs: torch.Tensor, queries: torch.Tensor, sub: int,
                      n_valid: int, mask: str = "all") -> torch.Tensor:
    """B1's ``k_base`` / ``k_rmax`` / ``k_sub64`` / ``k_sub128`` (sub = 32,
    32, 64, 128) and, with ``mask="edge"``, ``k_masklast``: the
    per-sub-block max f32[N/sub, Q] of K2 with no count. On the card
    ``k_base`` and ``k_rmax`` are one kernel: the reshape was a Mosaic
    layout. Sub-blocks at or above n_valid come out as NEG without a
    read of their rows."""
    if not vecs.is_cuda:
        return subblock_max_only_plain(vecs, queries, sub, n_valid, mask)
    if mask not in _MAX_ONLY:
        raise ValueError(f"mask must be one of {tuple(_MAX_ONLY)}: {mask!r}")
    form, key = _MAX_ONLY[mask]
    queries = _aligned(queries.to(torch.bfloat16).contiguous())
    return _max_only_launch(vecs, queries, queries.shape[0],
                            queries.shape[-1], sub, n_valid, form, key)


def subblock_max_only_qt(vecs: torch.Tensor, qt: torch.Tensor, sub: int,
                         n_valid: int) -> torch.Tensor:
    """B1's ``k_qt``: ``subblock_max_only`` with the queries given as qt
    [D, Q]. The kernel reads qt as it is, by TMA, into wgmma's transposed
    operand (no transpose on the way in). TMA needs rows of a multiple of
    16 bytes, so where Q % 8 != 0 qt's rows are padded to the next
    multiple of 8 (columns the kernel never reads)."""
    if not vecs.is_cuda:
        return subblock_max_only_plain(vecs, qt.T, sub, n_valid)
    qt = qt.to(torch.bfloat16).contiguous()
    qn = qt.shape[-1]
    if qn % 8:
        qt = torch.nn.functional.pad(qt, (0, 8 - qn % 8))
    return _max_only_launch(vecs, qt, qn, qt.shape[0], sub, n_valid, 2,
                            "knn_max_only_qt")


def phase1_rows_plain(vecs: torch.Tensor, queries: torch.Tensor, bn: int,
                      sub: int) -> torch.Tensor:
    """Plain torch version of B1's ``k_mm``: f32[N/sub, Q] with
    ``out[b * (bn/sub) + r, q] = vecs[b * bn + r] . queries[q]`` for
    r < bn/sub, unmasked."""
    n = vecs.shape[0]
    keep = bn // sub
    rows = (torch.arange(n // bn, device=vecs.device)[:, None] * bn
            + torch.arange(keep, device=vecs.device)).reshape(-1)
    return sims_f32(vecs[rows], queries)


def phase1_rows(vecs: torch.Tensor, queries: torch.Tensor, bn: int,
                sub: int) -> torch.Tensor:
    """B1's ``k_mm``, the bare product rows of phase 1 (see the plain
    version). The kernel reads the kept rows alone (keep = bn / sub of
    every bn-row block, through a 3-D tensor map over them) and writes
    their f32 products: its time is this function's. keep must be a
    multiple of 64 or divide 64, so that a 64-row box holds 64
    consecutive kept rows."""
    if not vecs.is_cuda:
        return phase1_rows_plain(vecs, queries, bn, sub)
    _cuda.require(vecs, "vecs", torch.bfloat16, 2)
    queries = _aligned(queries.to(torch.bfloat16).contiguous())
    _cuda.require(queries, "queries", torch.bfloat16, 2)
    n, d = vecs.shape
    qn = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError("queries and vecs differ in dimension")
    keep = bn // sub if sub >= 1 and bn % sub == 0 else 0
    if d % 8 or bn < 1 or n % bn or not keep or (keep % 64 and 64 % keep):
        raise ValueError(f"k_mm needs D % 8 == 0, N % bn == 0, bn % sub == 0 "
                         f"and keep = bn / sub a multiple of 64 or a divisor "
                         f"of 64 (D={d}, N={n}, bn={bn}, sub={sub})")
    if vecs.data_ptr() % 16:
        raise ValueError("k_mm reads the corpus through a TMA tensor map: "
                         "vecs must start 16-byte aligned")
    out = torch.empty(n // bn * keep, qn, dtype=torch.float32,
                      device=vecs.device)
    lib = _cuda.lib("knn_phase1_variants")
    _cuda.LAUNCHES["knn_phase1_rows"] += 1
    _cuda.check(lib.knn_phase1_rows(
        _cuda.ptr(vecs), _cuda.ptr(queries), _cuda.ptr(out), int(n), int(d),
        int(qn), int(bn), int(keep), _cuda.stream(),
    ), "knn_phase1_rows")
    return out


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


# K3's ring holds at least two stages of one query row and one corpus row
# at this width (csrc/knn_rescore.cu)
_RESCORE_MAX_D = 28672


def rescore_subblocks(vecs: torch.Tensor, queries: torch.Tensor,
                      sub_ids_flat: torch.Tensor, k: int, sub: int):
    """K3: exact rescore of the selected sub-blocks -> f32[nsel, sub].
    Persistent blocks stream the selected slabs through a ring of bulk
    async copies (16-byte rows and a 16-byte aligned corpus), or of
    4-byte copies for any other even width."""
    if not vecs.is_cuda:
        return rescore_subblocks_plain(vecs, queries, sub_ids_flat, k, sub)
    _cuda.require(vecs, "vecs", torch.bfloat16, 2)
    queries = _aligned(queries.to(torch.bfloat16).contiguous())
    ids = sub_ids_flat.to(torch.int32).contiguous()
    _cuda.require(ids, "sub_ids", torch.int32, 1)
    n, d = vecs.shape
    qn = queries.shape[0]
    nsel = ids.shape[0]
    if d % 2 or d > _RESCORE_MAX_D:
        raise ValueError(f"K3 needs an even dimension <= {_RESCORE_MAX_D} "
                         f"(D={d})")
    if queries.shape[1] != d:
        raise ValueError("queries and vecs differ in dimension")
    if vecs.data_ptr() % 4:
        raise ValueError("K3 copies rows in 4-byte words at least: vecs "
                         "must start 4-byte aligned")
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


def _select_subblocks(bmax_t, k):
    """The k best sub-block ids int64[Q, k] per query from bmax_t [Q, nsub]
    (the tiered filter once the table is large)."""
    nsub = bmax_t.shape[1]
    if nsub >= 4 * _TIER_GROUP and k <= nsub:
        return _tiered_subblock_topk(bmax_t.T, k)
    return topk_stable(bmax_t, k)[1]


def _rescore_topk(bmax_t, rescore, k, sub, n_valid):
    """Phase 2: pick the k best sub-blocks per query from bmax_t [Q, nsub],
    rescore their rows exactly with ``rescore(rows)`` (rows int64[Q, C] ->
    f32[Q, C]), final top-k."""
    rows = _candidate_rows(_select_subblocks(bmax_t, k), sub)
    return _final_topk(rescore(rows), rows, k, n_valid)


def _exact_rescore(vecs, queries):
    q = queries.to(vecs.dtype).to(torch.float32)

    def rescore(rows):
        cand = vecs[rows].to(torch.float32)                  # [Q, C, D]
        return torch.einsum("qd,qcd->qc", q, cand)

    return rescore


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
        v, i = _rescore_topk(bmax.T, _exact_rescore(vecs, queries), k, sub,
                             n_valid)
    return v, i, count


def knn_topk(vecs: torch.Tensor, queries: torch.Tensor, k: int = 10,
             block_rows: int = 2048, sub_rows: int = 32, n_valid: int = -1):
    """(values f32[Q, k], indices int32[Q, k]) — exact brute-force top-k."""
    v, i, _ = knn_topk_with_count(
        vecs, queries, k=k, block_rows=block_rows, sub_rows=sub_rows,
        n_valid=n_valid,
    )
    return v, i


# -- K5: int8 per-sub-block max / positive count ------------------------------


def subblock_max_int8_plain(codes: torch.Tensor, scales: torch.Tensor,
                            q8: torch.Tensor, sub: int, n_valid: int):
    """Plain torch version of K5: (bmax f32[N/sub, Q], bcnt int32[N/sub,
    Q]) of ``acc * scales[row]``, acc being the exact int32 product of the
    codes with the int8 queries, rows >= n_valid scoring NEG. The query
    scale is left out, as in the reference: a positive constant per
    column changes no selection, and phase 2 restores it."""
    n = codes.shape[0]
    acc = quant.int8_matmul(codes, q8)                       # int32 [N, Q]
    sims = acc.to(torch.float32) * scales[:, None]
    rows = torch.arange(n, device=codes.device)[:, None]
    sims = torch.where(rows < n_valid, sims, torch.full_like(sims, NEG))
    s3 = sims.reshape(n // sub, sub, -1)
    return s3.amax(dim=1), (s3 > 0).sum(dim=1).to(torch.int32)


def subblock_max_int8(codes: torch.Tensor, scales: torch.Tensor,
                      q8: torch.Tensor, sub: int, n_valid: int):
    """K5: K2's outputs over int8 codes int8[N, D], per-row scales f32[N]
    and int8 queries int8[Q, D]. Sub-blocks at or above n_valid come out
    as NEG / 0 without a read of their rows."""
    if not codes.is_cuda:
        return subblock_max_int8_plain(codes, scales, q8, sub, n_valid)
    _cuda.require(codes, "codes", torch.int8, 2)
    _cuda.require(scales, "scales", torch.float32, 1)
    q8 = q8.contiguous()
    _cuda.require(q8, "q8", torch.int8, 2)
    n, d = codes.shape
    qn = q8.shape[0]
    if q8.shape[1] != d or scales.shape[0] != n:
        raise ValueError("codes, scales and q8 disagree in shape")
    if d % 16 or d > _STREAM_MAX_D_INT8 or sub % 32 or n % sub:
        raise ValueError(f"K5 needs D % 16 == 0, D <= {_STREAM_MAX_D_INT8} "
                         f"and sub % 32 == 0 (D={d}, sub={sub}, N={n})")
    if codes.data_ptr() % 16 or q8.data_ptr() % 16:
        raise ValueError("K5 reads the codes through a TMA tensor map and "
                         "the queries in 16-byte chunks: both must start "
                         "16-byte aligned")
    bmax = torch.empty(n // sub, qn, dtype=torch.float32, device=codes.device)
    bcnt = torch.empty(n // sub, qn, dtype=torch.int32, device=codes.device)
    lib = _cuda.lib("knn_subblock_max_int8")
    _cuda.LAUNCHES["knn_subblock_max_int8"] += 1
    _cuda.check(lib.knn_subblock_max_int8(
        _cuda.ptr(codes), _cuda.ptr(scales), _cuda.ptr(q8), _cuda.ptr(bmax),
        _cuda.ptr(bcnt), int(n), int(d), int(qn), int(sub), int(n_valid),
        _cuda.stream(),
    ), "knn_subblock_max_int8")
    return bmax, bcnt


def knn_topk_int8_with_count(codes: torch.Tensor, scales: torch.Tensor,
                             queries: torch.Tensor, k: int = 10,
                             block_rows: int = 2048, sub_rows: int = 32,
                             n_valid: int = -1):
    """(values f32[Q, k], indices int32[Q, k], count int32[Q]) over int8
    codes [N, D] with per-row scales f32[N]; the f32 queries [Q, D] are
    quantized on the fly. Values are the quantized cosines, and the count
    is of positive QUANTIZED sims, as the int8 dense scorer counts."""
    n, _d = codes.shape
    if n % block_rows:
        raise ValueError("pad corpus to a multiple of block_rows")
    if n_valid < 0:
        n_valid = n
    sub = _pick_sub(block_rows, sub_rows)
    nsub = n // sub
    q8, q_scale = quant.quantize_int8(queries)
    q_scale = q_scale[:, None]
    if k * sub * 4 >= n_valid or k > nsub:
        acc = quant.int8_matmul(codes, q8).T                 # [Q, N]
        sims = acc.to(torch.float32) * scales[None, :] * q_scale
        cols = torch.arange(n, device=codes.device)[None, :]
        sims = torch.where(cols < n_valid, sims, torch.full_like(sims, NEG))
        v, i = topk_stable(sims, k)
        cnt = (sims > 0).sum(dim=1).to(torch.int32)
        return v, i.to(torch.int32), cnt
    bmax, bcnt = subblock_max_int8(codes, scales, q8, sub, n_valid)
    count = bcnt.sum(dim=0, dtype=torch.int32)

    def int8_sims(rows):
        acc = quant.int8_gather_dot(codes, q8, rows)
        return acc * scales[rows] * q_scale

    v, i = _rescore_topk(bmax.T, int8_sims, k, sub, n_valid)
    return v, i, count


def knn_topk_int8(codes: torch.Tensor, scales: torch.Tensor,
                  queries: torch.Tensor, k: int = 10, block_rows: int = 2048,
                  sub_rows: int = 32, n_valid: int = -1):
    """(values f32[Q, k], indices int32[Q, k]) — exact int8 top-k."""
    v, i, _ = knn_topk_int8_with_count(
        codes, scales, queries, k=k, block_rows=block_rows,
        sub_rows=sub_rows, n_valid=n_valid,
    )
    return v, i


# -- K6: multi-vector per-sub-block max of the per-doc running sum -----------


def subblock_max_mv_plain(vecs: torch.Tensor, row_docs: torch.Tensor,
                          queries: torch.Tensor, sub: int, n_valid: int,
                          m_max: int):
    """Plain torch version of K6 over doc-ascending rows (each doc's rows
    contiguous, at most ``m_max`` of them). Per row, seg = the inclusive
    running sum of relu(sim) over the earlier rows of its doc; per
    sub-block, bmax f32[N/sub, Q] = the max of seg and bcnt int32[N/sub,
    Q] = the number of rows that are the first positive row of their doc.
    Rows >= n_valid score 0 and join no doc, so a sub-block wholly past
    n_valid has max 0 and count 0.

    The running sum adds each row's m_max - 1 predecessors directly
    (offsets whose doc id equals the row's), never as a difference of
    global prefix sums, whose f32 rounding at 1M rows would reorder
    hits."""
    n = vecs.shape[0]
    dev = vecs.device
    sims = sims_f32(vecs, queries)                           # [N, Q]
    valid = (torch.arange(n, device=dev) < n_valid)[:, None]
    rel = torch.where(valid, torch.clamp(sims, min=0.0),
                      torch.zeros_like(sims))
    pos = valid & (sims > 0)
    docs = torch.where(valid[:, 0], row_docs.to(torch.int64),
                       torch.full((n,), -1, dtype=torch.int64, device=dev))
    seg = rel.clone()
    seen = torch.zeros_like(pos)
    for o in range(1, min(m_max, n)):
        same = (docs[o:] == docs[:-o])[:, None]
        seg[o:] += torch.where(same, rel[:-o], torch.zeros_like(rel[:-o]))
        seen[o:] |= same & pos[:-o]
    first = pos & ~seen
    qn = sims.shape[1]
    return (seg.reshape(n // sub, sub, qn).amax(dim=1),
            first.reshape(n // sub, sub, qn).sum(dim=1).to(torch.int32))


def subblock_max_mv(vecs: torch.Tensor, row_docs: torch.Tensor,
                    queries: torch.Tensor, sub: int, n_valid: int,
                    m_max: int):
    """K6: the multi-vector phase-1 table (see the plain version)."""
    if not vecs.is_cuda:
        return subblock_max_mv_plain(vecs, row_docs, queries, sub, n_valid,
                                     m_max)
    _cuda.require(vecs, "vecs", torch.bfloat16, 2)
    _cuda.require(row_docs, "row_docs", torch.int32, 1)
    queries = queries.to(torch.bfloat16).contiguous()
    _cuda.require(queries, "queries", torch.bfloat16, 2)
    n, d = vecs.shape
    qn = queries.shape[0]
    if queries.shape[1] != d or row_docs.shape[0] != n:
        raise ValueError("vecs, row_docs and queries disagree in shape")
    if (d % 8 or d > _STREAM_MAX_D or sub % 32 or n % sub
            or not 1 <= m_max <= 64):
        raise ValueError(f"K6 needs D % 8 == 0, D <= {_STREAM_MAX_D}, "
                         f"sub % 32 == 0 and 1 <= m_max <= 64 (D={d}, "
                         f"sub={sub}, N={n}, m_max={m_max})")
    if vecs.data_ptr() % 16:
        raise ValueError("K6 reads the corpus through a TMA tensor map: vecs "
                         "must start 16-byte aligned")
    queries = _aligned(queries)
    bmax = torch.empty(n // sub, qn, dtype=torch.float32, device=vecs.device)
    bcnt = torch.empty(n // sub, qn, dtype=torch.int32, device=vecs.device)
    lib = _cuda.lib("knn_subblock_max_mv")
    _cuda.LAUNCHES["knn_subblock_max_mv"] += 1
    _cuda.check(lib.knn_subblock_max_mv(
        _cuda.ptr(vecs), _cuda.ptr(row_docs), _cuda.ptr(queries),
        _cuda.ptr(bmax), _cuda.ptr(bcnt), int(n), int(d), int(qn), int(sub),
        int(n_valid), int(m_max), _cuda.stream(),
    ), "knn_subblock_max_mv")
    return bmax, bcnt


def _rescore_topk_segmented(vecs, queries, bmax_t, row_docs, row_starts,
                            k: int, over: int, sub: int, m_max: int,
                            n_valid: int):
    """Phase 2 for multi-vector docs, the reference's two stages:

    2a (candidate docs): the top k*over sub-blocks by phase 1's metric
    hold the true top-k docs' last rows; each is gathered with the
    predecessors a doc can span (duplicates masked), so a doc ending in a
    selected sub-block has all its rows gathered and its partial sum is
    its exact total.

    2b (exact rescore): for the top k*over docs by 2a sum, every chunk
    row (through the doc CSR ``row_starts``) is rescored, the sum of relu
    cos taken, and the final doc top-k returned.

    Returns (values f32[Q, k], DOC ids int32[Q, k])."""
    qn, nsub = bmax_t.shape
    dev = vecs.device
    k2 = min(k * over, nsub)
    sub_ids = _select_subblocks(bmax_t, k2)                  # [Q, k2]
    span = -(-(m_max - 1) // sub) + 1                        # sub-blocks/doc
    ext = (sub_ids[:, :, None]
           - torch.arange(span, device=dev)).reshape(qn, k2 * span)
    ext = torch.sort(ext.clamp(0, nsub - 1), dim=1).values
    dup = torch.cat([torch.zeros(qn, 1, dtype=torch.bool, device=dev),
                     ext[:, 1:] == ext[:, :-1]], dim=1)      # mask repeats
    rows = _candidate_rows(ext, sub)                         # [Q, C]
    c = rows.shape[1]
    q = queries.to(vecs.dtype).to(torch.float32)
    sims = torch.einsum("qd,qcd->qc", q, vecs[rows].to(torch.float32))
    keep = (rows < n_valid) & ~dup.repeat_interleave(sub, dim=1)
    sims = torch.where(keep, torch.clamp(sims, min=0.0), torch.zeros_like(sims))
    d = row_docs[rows]                                       # [Q, C]
    order = torch.argsort(d, dim=1, stable=True)
    ds = torch.gather(d, 1, order)
    ss = torch.gather(sims, 1, order)
    is_start = torch.cat([torch.ones(qn, 1, dtype=torch.bool, device=dev),
                          ds[:, 1:] != ds[:, :-1]], dim=1)
    run_id = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    totals = torch.zeros(qn, c, dtype=torch.float32, device=dev)
    totals.scatter_add_(1, run_id, ss)
    per_elem = torch.gather(totals, 1, run_id)
    scored = torch.where(is_start, per_elem, torch.full_like(per_elem, NEG))

    kd = min(k2, c)
    v_part, i_part = topk_stable(scored, kd)                 # [Q, kd]
    docs_kd = torch.gather(ds, 1, i_part).to(torch.int64)
    # slots past the distinct candidate docs hold non-start positions
    # (NEG): -1 keeps them from duplicating a real doc in the final top-k
    docs_kd = torch.where(v_part > NEG / 2, docs_kd,
                          torch.full_like(docs_kd, -1))
    safe = docs_kd.clamp_min(0)
    starts = row_starts[safe].to(torch.int64)                # [Q, kd]
    lens = row_starts[safe + 1].to(torch.int64) - starts
    ar = torch.arange(m_max, device=dev)
    rows2 = (starts[:, :, None] + ar).clamp(0, n_valid - 1)  # [Q, kd, M]
    valid2 = ar < lens[:, :, None]
    sims2 = torch.einsum("qd,qkmd->qkm", q, vecs[rows2].to(torch.float32))
    sums = torch.where(valid2, torch.clamp(sims2, min=0.0),
                       torch.zeros_like(sims2)).sum(dim=2)   # [Q, kd]
    sums = torch.where(docs_kd >= 0, sums, torch.full_like(sums, NEG))
    v, i = topk_stable(sums, k)
    return v, torch.gather(docs_kd, 1, i).to(torch.int32)


def knn_topk_multivec_with_count(vecs: torch.Tensor, row_docs: torch.Tensor,
                                 row_starts: torch.Tensor,
                                 queries: torch.Tensor, k: int = 10,
                                 block_rows: int = 2048, sub_rows: int = 32,
                                 over: int = 4, m_max: int = 8,
                                 n_valid: int = -1, n_docs: int = -1):
    """Fused kNN over multi-vector (chunked) docs: (values f32[Q, k], DOC
    ids int32[Q, k], count int32[Q]), a doc's score being the sum of relu
    cos over its chunk rows and the count the number of docs with a
    positive row. ``row_docs`` int32[N] must ascend over the real rows
    (each doc's rows contiguous, at most ``m_max`` of them) and
    ``row_starts`` int32[n_docs + 1] is the doc -> row range CSR."""
    n, _d = vecs.shape
    qn = queries.shape[0]
    if n % block_rows:
        raise ValueError("pad corpus to a multiple of block_rows")
    if n_valid < 0:
        n_valid = n
    sub = _pick_sub(block_rows, sub_rows)
    nsub = n // sub
    if n_docs < 0:
        n_docs = n
    if k * over * sub * 4 >= n_valid or k * over > nsub:
        # small corpus: dense sims + exact per-doc segment sum
        sims = sims_f32(vecs, queries).T                     # [Q, N]
        cols = torch.arange(n, device=vecs.device)[None, :]
        sims = torch.where(cols < n_valid, torch.clamp(sims, min=0.0),
                           torch.zeros_like(sims))
        seg = torch.zeros(qn, n_docs, dtype=torch.float32, device=vecs.device)
        seg.index_add_(1, row_docs.long(), sims)
        v, i = topk_stable(seg, k)
        cnt = (seg > 0).sum(dim=1).to(torch.int32)
        return v, i.to(torch.int32), cnt
    bmax, bcnt = subblock_max_mv(vecs, row_docs, queries, sub, n_valid, m_max)
    count = bcnt.sum(dim=0, dtype=torch.int32)
    v, docs_k = _rescore_topk_segmented(
        vecs, queries, bmax.T, row_docs, row_starts, k, over, sub, m_max,
        n_valid,
    )
    return v, docs_k, count
