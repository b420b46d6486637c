"""BM25 scoring over CSR-packed posting lists, and the phrase boost.

Port of ``orama_core_tpu/ops/bm25.py`` (the reference's per-posting
scoring loops, `committed/string.rs:302-479`, `dto/bm25.rs:53-71`). The
host helpers (block plans, dense head-term rows, window meta) are copied
verbatim; the device paths are torch, and two of them are the wrappers of
hand-written Hopper kernels:

    K1  bm25_scores_blocked_aligned      csrc/bm25_scan.cu
        bm25_scores_blocked_aligned_batch (the same kernel, row ids)
    K4  phrase_boost_docmajor_windowed   csrc/phrase_counts.cu
    B3  bm25_scan_wide, bm25_scan_packed  csrc/bm25_scan_variants.cu (K1's
        four-plane scan at plan blocks of 1,024, 4,096 and 8,192, and its
        packed two-plane form: the probes of tools/bm25_scan_bench.py)

A wrapper launches its kernel for CUDA tensors and runs its plain torch
version (``*_plain``, same signature) for CPU tensors; a CUDA tensor never
falls back. Scoring matches the reference formula (k=1.2, b=0.75):
    idf * tf * (k + 1) / (tf + k * (1 - b + b * len/avgdl))
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils import bucket_pad
from . import _cuda

K1 = 1.2
B = 0.75

BLOCK = 1024  # posting block of the sliced scoring path

# Static block-count buckets for the scan plans (the reference's ladder;
# the plan's length is padded to one of these).
PLAN_BUCKETS = (16, 64, 256, 1024, 2048, 4096, 8192, 16384, 32768, 65536)

PAD_DOC = 2**31 - 1  # sorts last; marks padding rows of the phrase stream


def _f32(x, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device`` from a float or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _bm25_contrib(tf, ni, lens, boost, avgdl, nfd):
    """The reference kernel's float expression, elementwise."""
    idf = torch.log1p(torch.clamp((nfd - ni + 0.5) / (ni + 0.5), min=0.0))
    den = tf + K1 * (1.0 - B + B * lens / torch.clamp(avgdl, min=1e-9))
    return idf * boost * tf * (K1 + 1.0) / torch.clamp(den, min=1e-9)


# -- host helpers (numpy, verbatim) -------------------------------------------


def build_block_plan(p_lo, p_len, n_blocks_budget: int):
    """Host: align each token's posting span to BLOCK multiples and emit
    per-block (source start, valid length). Tiny arrays — O(blocks) ints.

    Returns (block_starts int32[nb], block_valid int32[nb]) padded to
    ``n_blocks_budget`` (pad blocks have valid 0 and start 0)."""
    starts = np.zeros(n_blocks_budget, np.int32)
    valid = np.zeros(n_blocks_budget, np.int32)
    b = 0
    for lo, ln in zip(p_lo, p_len):
        off = 0
        while off < ln and b < n_blocks_budget:
            starts[b] = lo + off
            valid[b] = min(BLOCK, ln - off)
            off += BLOCK
            b += 1
    return starts, valid


def build_block_plan_aligned(p_lo, p_len, n_blocks_budget: int):
    """BLOCK-aligned plan: each emitted block is a whole aligned BLOCK of
    the posting space (block index, not element offset), with the valid
    span given as in-block [lo_off, hi_off).

    Returns (block_idx int32[nb], lo_off int32[nb], hi_off int32[nb]);
    pad blocks have hi_off == 0. Costs at most 1 extra block per span vs
    the unaligned plan."""
    blk_idx = np.zeros(n_blocks_budget, np.int32)
    lo_off = np.zeros(n_blocks_budget, np.int32)
    hi_off = np.zeros(n_blocks_budget, np.int32)
    b = 0
    for lo, ln in zip(p_lo, p_len):
        if ln <= 0:
            continue
        hi = lo + ln
        for blk in range(lo // BLOCK, (hi - 1) // BLOCK + 1):
            if b >= n_blocks_budget:
                return blk_idx, lo_off, hi_off
            blk_idx[b] = blk
            lo_off[b] = max(lo - blk * BLOCK, 0)
            hi_off[b] = min(hi - blk * BLOCK, BLOCK)
            b += 1
    return blk_idx, lo_off, hi_off


def aligned_blocks_needed(p_len_list) -> int:
    """Upper bound on aligned-plan blocks (one extra per span)."""
    return sum((ln + BLOCK - 1) // BLOCK + 1 for ln in p_len_list if ln > 0)


def build_batch_plan_aligned(row_plans):
    """Host: one batch's combined aligned plan, as the reference's batched
    fused serving builds it: each row's real blocks in turn (row i's
    posting spans ``row_plans[i] = (p_lo, p_len)``), then pad blocks
    (hi_off 0, row 0) up to a PLAN_BUCKETS bucket. Returns
    (block_idx, lo_off, hi_off, row_id), int32[nb] each."""
    need = sum(aligned_blocks_needed(p_len) for _lo, p_len in row_plans)
    nb = bucket_pad(max(need, 1), PLAN_BUCKETS)
    plan = np.zeros((4, nb), np.int32)
    at = 0
    for i, (p_lo, p_len) in enumerate(row_plans):
        bi, lo, hi = build_block_plan_aligned(
            p_lo, p_len, aligned_blocks_needed(p_len))
        # the bound over-counts: keep the row's real blocks
        real = int(np.count_nonzero(hi))
        plan[:3, at:at + real] = (bi[:real], lo[:real], hi[:real])
        plan[3, at:at + real] = i
        at += real
    return tuple(plan)


def idf_from_counts(ni, n_docs_with_field):
    """Host-side idf: ln1p((N - ni + 0.5) / (ni + 0.5))."""
    ni = np.asarray(ni, dtype=np.float64)
    return np.log1p(
        (n_docs_with_field - ni + 0.5) / (ni + 0.5)
    ).astype(np.float32)


# -- K1: posting block scan ---------------------------------------------------


def bm25_blocked_contrib(post_docs, post_tf, post_ni, post_lens, block_starts,
                         block_valid, field_boost, avgdl, n_field_docs,
                         n_blocks: int):
    """The unaligned block-sliced scan WITHOUT the per-doc reduction:
    (contrib f32[nb, BLOCK], docs int64[nb, BLOCK]). Slices start at
    ``block_starts`` (clamped so a slice never leaves the array, as the
    reference's dynamic_slice does)."""
    dev = post_docs.device
    p = post_docs.shape[0]
    starts = torch.clamp(block_starts.long(), 0, max(p - BLOCK, 0))
    idx = starts[:, None] + torch.arange(BLOCK, device=dev)[None, :]
    valid = (
        torch.arange(BLOCK, device=dev)[None, :] < block_valid.long()[:, None]
    ).to(torch.float32)
    contrib = _bm25_contrib(
        post_tf[idx], post_ni[idx], post_lens[idx], _f32(field_boost, dev),
        _f32(avgdl, dev), _f32(n_field_docs, dev),
    )
    return contrib * valid, post_docs[idx].long()


def bm25_scores_blocked(post_docs, post_tf, post_ni, post_lens, block_starts,
                        block_valid, field_boost, avgdl, n_field_docs,
                        n_docs: int, n_blocks: int) -> torch.Tensor:
    """Block-sliced BM25 over the unaligned plan -> f32[n_docs]."""
    contrib, docs = bm25_blocked_contrib(
        post_docs, post_tf, post_ni, post_lens, block_starts, block_valid,
        field_boost, avgdl, n_field_docs, n_blocks,
    )
    out = torch.zeros(n_docs, dtype=torch.float32, device=post_docs.device)
    return out.index_add_(0, docs.reshape(-1), contrib.reshape(-1))


def bm25_blocked_contrib_aligned(post_docs, post_tf, post_ni, post_lens,
                                 block_idx, lo_off, hi_off, field_boost,
                                 avgdl, n_field_docs, block: int = BLOCK):
    """The aligned block scan WITHOUT the per-doc reduction, the function
    of the reference's ``bm25_blocked_contrib_pallas`` (K1's TPU kernel):
    (contrib f32[nb, block], docs int64[nb, block]), contributions zero
    outside each block's [lo, hi) window (plan blocks of ``block``
    postings; the engine's are BLOCK)."""
    dev = post_docs.device
    j = torch.arange(block, device=dev)[None, :]
    idx = block_idx.long()[:, None] * block + j
    valid = ((j >= lo_off.long()[:, None]) & (j < hi_off.long()[:, None]))
    contrib = _bm25_contrib(
        post_tf[idx], post_ni[idx], post_lens[idx], _f32(field_boost, dev),
        _f32(avgdl, dev), _f32(n_field_docs, dev),
    ) * valid.to(torch.float32)
    return contrib, post_docs[idx].long()


def bm25_scores_blocked_aligned_plain(post_docs, post_tf, post_ni, post_lens,
                                      block_idx, lo_off, hi_off, field_boost,
                                      avgdl, n_field_docs, n_docs: int,
                                      n_blocks: int) -> torch.Tensor:
    """Plain torch version of K1 (same contract as the wrapper)."""
    contrib, docs = _in_row(*bm25_blocked_contrib_aligned(
        post_docs, post_tf, post_ni, post_lens, block_idx, lo_off, hi_off,
        field_boost, avgdl, n_field_docs,
    ), n_docs)
    out = torch.zeros(n_docs, dtype=torch.float32, device=post_docs.device)
    return out.index_add_(0, docs.reshape(-1), contrib.reshape(-1))


def _in_row(contrib, docs, n_docs: int):
    """K1's doc bound: a doc id outside [0, n_docs) adds nothing (to doc
    0), as the reference's ``segment_sum`` drops an id outside its
    segments."""
    out = (docs >= 0) & (docs < n_docs)
    return contrib * out, docs * out


def bm25_scores_blocked_aligned_batch_plain(post_docs, post_tf, post_ni,
                                            post_lens, block_idx, lo_off,
                                            hi_off, row_id, field_boost,
                                            avgdl, n_field_docs, n_docs: int,
                                            n_blocks: int,
                                            b: int) -> torch.Tensor:
    """Plain torch version of K1 over a batch's combined plan (same
    contract as ``bm25_scores_blocked_aligned_batch``): the reference's
    ``bm25_blocked_contrib_pallas`` and a segment sum over
    ``row_id * n_docs + doc``."""
    contrib, docs = _in_row(*bm25_blocked_contrib_aligned(
        post_docs, post_tf, post_ni, post_lens, block_idx, lo_off, hi_off,
        field_boost, avgdl, n_field_docs,
    ), n_docs)
    seg = docs + row_id.long()[:, None] * n_docs
    out = torch.zeros(b * n_docs, dtype=torch.float32, device=post_docs.device)
    return out.index_add_(0, seg.reshape(-1), contrib.reshape(-1)).reshape(
        b, n_docs)


def _k1_check(post_docs, post_tf, post_ni, post_lens, plan, n_blocks):
    """Raise unless K1 takes these posting columns and plan arrays."""
    _cuda.require(post_docs, "post_docs", torch.int32, 1)
    for name, t in (("post_tf", post_tf), ("post_ni", post_ni),
                    ("post_lens", post_lens)):
        _cuda.require(t, name, torch.float32, 1)
        if t.shape != post_docs.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != post_docs")
    if post_docs.shape[0] % BLOCK:
        raise ValueError("pad posting arrays to a BLOCK multiple")
    for name, t in (("post_docs", post_docs), ("post_tf", post_tf),
                    ("post_ni", post_ni), ("post_lens", post_lens)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel's 16-byte loads need a "
                             "16-byte aligned tensor")
    for name, t in plan:
        _cuda.require(t, name, torch.int32, 1)
        if t.shape[0] != n_blocks:
            raise ValueError(f"{name}: expected {n_blocks} plan blocks")


def _k1_launch(post_docs, post_tf, post_ni, post_lens, block_idx, lo_off,
               hi_off, row_id, scalars, n_docs: int, n_blocks: int,
               rows: int) -> torch.Tensor:
    """Fill f32[rows * n_docs] and launch K1 right behind the fill."""
    dev = post_docs.device
    scalars = [_cuda.scalar_arg(x, dev) for x in scalars]
    lib = _cuda.lib("bm25_scan")
    # the fill must be the launch right before the kernel's: the kernel
    # overlaps its loads with it (csrc/bm25_scan.cu)
    scores = torch.zeros(rows * n_docs, dtype=torch.float32, device=dev)
    if n_docs == 0:
        return scores
    _cuda.LAUNCHES["bm25_scan"] += 1
    _cuda.check(lib.bm25_scan(
        _cuda.ptr(post_docs), _cuda.ptr(post_tf), _cuda.ptr(post_ni),
        _cuda.ptr(post_lens), _cuda.ptr(block_idx), _cuda.ptr(lo_off),
        _cuda.ptr(hi_off), None if row_id is None else _cuda.ptr(row_id),
        *[p for _t, p, _v in scalars], *[v for _t, _p, v in scalars],
        _cuda.ptr(scores), int(n_blocks), int(n_docs), _cuda.stream(),
    ), "bm25_scan")
    return scores


def bm25_scores_blocked_aligned(post_docs, post_tf, post_ni, post_lens,
                                block_idx, lo_off, hi_off, field_boost,
                                avgdl, n_field_docs, n_docs: int,
                                n_blocks: int) -> torch.Tensor:
    """K1: BM25 posting scan over the aligned block plan -> f32[n_docs].

    Port of the reference's ``bm25_scores_blocked_pallas`` (same
    arguments, no ``interpret``): per plan block, an aligned BLOCK of the
    posting columns, scored inside its [lo, hi) window, summed per doc.
    The per-doc sum is fused into the kernel with atomics, so sums differ
    from the plain version in the last bits (order of addition).

    The plan is ``build_block_plan_aligned``'s: every real block (hi > 0)
    comes before every pad block (hi == 0), and the kernel stops at the
    first pad. The three scalars are Python numbers (kernel arguments, no
    upload) or 0-d tensors on the card (read by the kernel)."""
    if not post_docs.is_cuda:
        return bm25_scores_blocked_aligned_plain(
            post_docs, post_tf, post_ni, post_lens, block_idx, lo_off,
            hi_off, field_boost, avgdl, n_field_docs, n_docs, n_blocks,
        )
    _k1_check(post_docs, post_tf, post_ni, post_lens,
              (("block_idx", block_idx), ("lo_off", lo_off),
               ("hi_off", hi_off)), n_blocks)
    return _k1_launch(post_docs, post_tf, post_ni, post_lens, block_idx,
                      lo_off, hi_off, None, (field_boost, avgdl, n_field_docs),
                      n_docs, n_blocks, 1)


def bm25_scores_blocked_aligned_batch(post_docs, post_tf, post_ni, post_lens,
                                      block_idx, lo_off, hi_off, row_id,
                                      field_boost, avgdl, n_field_docs,
                                      n_docs: int, n_blocks: int,
                                      b: int) -> torch.Tensor:
    """K1 over a batch's combined aligned plan -> f32[b, n_docs]: plan
    block i scores into row ``row_id[i]`` (int32[n_blocks]). The plan is
    the reference's combined plan (``_search_batch_hybrid_fused``): every
    row's real blocks first, then the pad blocks (hi == 0, row 0), and the
    kernel stops at the first pad. One launch and one fill of b * n_docs
    floats for the whole batch."""
    if not post_docs.is_cuda:
        return bm25_scores_blocked_aligned_batch_plain(
            post_docs, post_tf, post_ni, post_lens, block_idx, lo_off,
            hi_off, row_id, field_boost, avgdl, n_field_docs, n_docs,
            n_blocks, b,
        )
    _k1_check(post_docs, post_tf, post_ni, post_lens,
              (("block_idx", block_idx), ("lo_off", lo_off),
               ("hi_off", hi_off), ("row_id", row_id)), n_blocks)
    return _k1_launch(post_docs, post_tf, post_ni, post_lens, block_idx,
                      lo_off, hi_off, row_id,
                      (field_boost, avgdl, n_field_docs), n_docs, n_blocks,
                      b).reshape(b, n_docs)


# -- B3: K1's wide-block and packed forms (tools/bm25_scan_bench.py) ---------

SCAN_BLOCKS = (1024, 4096, 8192)  # the bench's plan blocks


def bm25_scan_wide_plain(post_docs, post_tf, post_ni, post_lens, block_idx,
                         lo_off, hi_off, field_boost, avgdl, n_field_docs,
                         n_docs: int, block: int) -> torch.Tensor:
    """Plain torch version of ``bm25_scan_wide``: K1's function over a
    plan of ``block``-posting blocks (the bench's ``mk_pallas4`` and its
    segment sum) -> f32[n_docs]."""
    contrib, docs = _in_row(*bm25_blocked_contrib_aligned(
        post_docs, post_tf, post_ni, post_lens, block_idx, lo_off, hi_off,
        field_boost, avgdl, n_field_docs, block=block,
    ), n_docs)
    out = torch.zeros(n_docs, dtype=torch.float32, device=post_docs.device)
    return out.index_add_(0, docs.reshape(-1), contrib.reshape(-1))


def _scan_check(planes, plan, n_blocks: int, block: int) -> None:
    """Raise unless the B3 kernels take these planes and plan arrays."""
    if block not in SCAN_BLOCKS:
        raise ValueError(f"block must be one of {SCAN_BLOCKS}: {block}")
    for name, t, dtype in planes:
        _cuda.require(t, name, dtype, 1)
        if t.shape != planes[0][1].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != post_docs")
        if t.shape[0] % block:
            raise ValueError(f"{name}: pad posting arrays to a {block} "
                             "multiple")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel's 16-byte loads need a "
                             "16-byte aligned tensor")
    for name, t in plan:
        _cuda.require(t, name, torch.int32, 1)
        if t.shape[0] != n_blocks:
            raise ValueError(f"{name}: expected {n_blocks} plan blocks")


def _scan_launch(key: str, args, scalars, n_docs: int, n_blocks: int,
                 block: int, device) -> torch.Tensor:
    """Fill f32[n_docs] and launch ``key`` of bm25_scan_variants right
    behind the fill, as K1 is launched."""
    lib = _cuda.lib("bm25_scan_variants")
    # the scalars travel as kernel arguments: a 0-d tensor is read here
    scalars = [float(x) for x in scalars]
    scores = torch.zeros(n_docs, dtype=torch.float32, device=device)
    if n_docs == 0:
        return scores
    _cuda.LAUNCHES[key] += 1
    _cuda.check(getattr(lib, key)(
        *[_cuda.ptr(t) for t in args], *scalars, _cuda.ptr(scores),
        int(n_blocks), int(n_docs), int(block), _cuda.stream(),
    ), key)
    return scores


def bm25_scan_wide(post_docs, post_tf, post_ni, post_lens, block_idx,
                   lo_off, hi_off, field_boost, avgdl, n_field_docs,
                   n_docs: int, block: int) -> torch.Tensor:
    """B3's ``mk_pallas4`` at ``block`` in SCAN_BLOCKS: K1's four-plane scan
    (docs int32; tf, ni, lens f32: 16 B a posting) over an aligned plan of
    ``block``-posting blocks (real blocks first, then pads with hi_off ==
    0, where the kernel stops) -> f32[n_docs], summed with atomics; a doc
    id outside [0, n_docs) is dropped. At 1,024 it computes K1's function
    (``bm25_scores_blocked_aligned``) through the same template."""
    n_blocks = int(block_idx.shape[0])
    if not post_docs.is_cuda:
        return bm25_scan_wide_plain(
            post_docs, post_tf, post_ni, post_lens, block_idx, lo_off,
            hi_off, field_boost, avgdl, n_field_docs, n_docs, block)
    planes = (("post_docs", post_docs, torch.int32),
              ("post_tf", post_tf, torch.float32),
              ("post_ni", post_ni, torch.float32),
              ("post_lens", post_lens, torch.float32))
    plan = (("block_idx", block_idx), ("lo_off", lo_off), ("hi_off", hi_off))
    _scan_check(planes, plan, n_blocks, block)
    return _scan_launch(
        "bm25_scan_wide", [t for _n, t, _d in planes] + [t for _n, t in plan],
        (field_boost, avgdl, n_field_docs), n_docs, n_blocks, block,
        post_docs.device)


def pack_tf_lens(post_tf, post_lens) -> torch.Tensor:
    """int32 ``tf | lens << 16`` (both below 65,536), the bench's packed
    plane."""
    tf = post_tf.to(torch.int64)
    lens = post_lens.to(torch.int64)
    return ((tf | (lens << 16)) & 0xFFFFFFFF).to(torch.int32)


def bm25_scan_packed_plain(post_docs, packed, block_idx, lo_off, hi_off,
                           ni_blk, field_boost, avgdl, n_field_docs,
                           n_docs: int, block: int) -> torch.Tensor:
    """Plain torch version of ``bm25_scan_packed``: the bench's
    ``mk_pallas_packed`` and its segment sum -> f32[n_docs]. tf is
    ``packed & 0xFFFF`` and lens the LOGICAL shift ``packed >> 16`` (masked
    after torch's arithmetic shift); ni is the plan block's."""
    dev = post_docs.device
    j = torch.arange(block, device=dev)[None, :]
    idx = block_idx.long()[:, None] * block + j
    valid = ((j >= lo_off.long()[:, None]) & (j < hi_off.long()[:, None]))
    p = packed[idx].to(torch.int64)
    tf = (p & 0xFFFF).to(torch.float32)
    lens = ((p >> 16) & 0xFFFF).to(torch.float32)
    ni = ni_blk.to(torch.float32)[:, None]
    contrib = _bm25_contrib(
        tf, ni, lens, _f32(field_boost, dev), _f32(avgdl, dev),
        _f32(n_field_docs, dev)) * valid.to(torch.float32)
    contrib, docs = _in_row(contrib, post_docs[idx].long(), n_docs)
    out = torch.zeros(n_docs, dtype=torch.float32, device=dev)
    return out.index_add_(0, docs.reshape(-1), contrib.reshape(-1))


def bm25_scan_packed(post_docs, packed, block_idx, lo_off, hi_off, ni_blk,
                     field_boost, avgdl, n_field_docs, n_docs: int,
                     block: int) -> torch.Tensor:
    """B3's ``mk_pallas_packed`` at ``block`` in SCAN_BLOCKS: K1's scan
    over two planes, docs int32 and ``packed`` int32 = tf | lens << 16
    (``pack_tf_lens``), with ni int32 per plan block (``ni_blk``): 8 B a
    posting where K1 reads 16 -> f32[n_docs], summed with atomics; a doc
    id outside [0, n_docs) is dropped. The plan is laid out as
    ``bm25_scan_wide``'s."""
    n_blocks = int(block_idx.shape[0])
    if not post_docs.is_cuda:
        return bm25_scan_packed_plain(
            post_docs, packed, block_idx, lo_off, hi_off, ni_blk,
            field_boost, avgdl, n_field_docs, n_docs, block)
    planes = (("post_docs", post_docs, torch.int32),
              ("packed", packed, torch.int32))
    plan = (("block_idx", block_idx), ("lo_off", lo_off), ("hi_off", hi_off),
            ("ni_blk", ni_blk))
    _scan_check(planes, plan, n_blocks, block)
    return _scan_launch(
        "bm25_scan_packed", [t for _n, t, _d in planes] + [t for _n, t in plan],
        (field_boost, avgdl, n_field_docs), n_docs, n_blocks, block,
        post_docs.device)


def bm25_scores_from_spans(term_starts, post_docs, post_tf, post_ni,
                           post_lens, pos_starts, positions, spans,
                           field_boost, filter_mask, avgdl, n_field_docs,
                           n_docs: int, g_budget: int, pp_budget: int,
                           phrase: bool, masked: bool = True,
                           phrase_spans=None) -> torch.Tensor:
    """Span-resolved BM25 (the reference's multi-dispatch span path): the
    host ships per-token term-id ranges; postings and idf resolve on the
    device. With ``phrase`` the phrase boost comes from the positions of
    ``phrase_spans`` (default ``spans``) through phrase_boost_by_doc."""
    dev = post_docs.device
    field_boost = _f32(field_boost, dev)
    avgdl = _f32(avgdl, dev)
    nfd = _f32(n_field_docs, dev)

    def span_gather(lo, hi, budget, limit):
        lens = (hi - lo).long()
        total = lens.sum()
        idx = torch.repeat_interleave(lo.long(), lens) + (
            torch.arange(int(total), device=dev)
            - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
        )
        idx = idx[:budget]
        valid = torch.zeros(budget, dtype=torch.float32, device=dev)
        valid[: idx.shape[0]] = 1.0
        idx = torch.nn.functional.pad(idx, (0, budget - idx.shape[0]))
        return torch.clamp(idx, 0, limit - 1), valid

    ts = term_starts.long()
    sp = spans.long()
    gather_idx, valid = span_gather(
        ts[sp[:, 0]], ts[sp[:, 1]], g_budget, post_docs.shape[0]
    )
    ni = post_ni[gather_idx]
    idf = torch.log1p(torch.clamp((nfd - ni + 0.5) / (ni + 0.5), min=0.0))
    idf = idf * valid
    docs = post_docs[gather_idx].long()
    tf = post_tf[gather_idx]
    lens_g = post_lens[gather_idx]
    denom = tf + K1 * (1.0 - B + B * lens_g / torch.clamp(avgdl, min=1e-9))
    if phrase:
        ph = sp if phrase_spans is None else phrase_spans.long()
        ps = pos_starts.long()
        p_idx, p_valid = span_gather(
            ps[ts[ph[:, 0]]], ps[ts[ph[:, 1]]], pp_budget,
            positions.shape[0],
        )
        owning = torch.searchsorted(pos_starts, p_idx.to(pos_starts.dtype),
                                    right=True).long() - 1
        p_doc = post_docs[torch.clamp(owning, 0, post_docs.shape[0] - 1)]
        boost_by_doc = phrase_boost_by_doc(
            p_doc, positions[p_idx], p_valid, field_boost, n_docs
        )
        contrib = idf * tf * (K1 + 1.0) / torch.clamp(denom, min=1e-9)
        contrib = contrib * boost_by_doc[docs]
    else:
        contrib = idf * field_boost * tf * (K1 + 1.0) / torch.clamp(
            denom, min=1e-9
        )
    if masked:
        contrib = contrib * filter_mask[docs]
    out = torch.zeros(n_docs, dtype=torch.float32, device=dev)
    return out.index_add_(0, docs, contrib)


def bm25_scores_from_spans_batch(term_starts, post_docs, post_tf, post_ni,
                                 post_lens, pos_starts, positions, spans_b,
                                 field_boost, filter_mask, avgdl,
                                 n_field_docs, n_docs: int, g_budget: int,
                                 pp_budget: int, phrase: bool,
                                 masked: bool = True,
                                 phrase_spans_b=None) -> torch.Tensor:
    """[B, n_docs]: ``bm25_scores_from_spans`` for each row of ``spans_b``
    int32[B, MAXTOK, 2] (and of ``phrase_spans_b``, the surface-only spans
    of phrase rows), the index arrays shared by the rows. The reference
    vmaps the rows; here they run one after another."""
    return torch.stack([
        bm25_scores_from_spans(
            term_starts, post_docs, post_tf, post_ni, post_lens, pos_starts,
            positions, spans_b[r], field_boost, filter_mask, avgdl,
            n_field_docs, n_docs=n_docs, g_budget=g_budget,
            pp_budget=pp_budget, phrase=phrase, masked=masked,
            phrase_spans=None if phrase_spans_b is None else phrase_spans_b[r],
        )
        for r in range(spans_b.shape[0])
    ])


def phrase_boost_by_doc(pos_docs, pos_vals, valid, user_boost,
                        n_docs: int) -> torch.Tensor:
    """Per-doc phrase boost from an unsorted (doc, position) list: sort the
    pairs, then count distinct positions (``anyorder``) and adjacent +1
    pairs (``sequences``) per doc; matched docs get
    ``anyorder + 2*sequences + user_boost``, others ``user_boost``."""
    dev = pos_docs.device
    big = 2**30
    docs_k = torch.where(valid > 0, pos_docs.long(),
                         torch.full_like(pos_docs, big, dtype=torch.long))
    pos_k = torch.where(valid > 0, pos_vals.long(),
                        torch.full_like(pos_vals, big, dtype=torch.long))
    order = torch.sort(docs_k * (2**31) + pos_k, stable=True).indices
    docs_s, pos_s = docs_k[order], pos_k[order]
    same_doc = docs_s[1:] == docs_s[:-1]
    dup = same_doc & (pos_s[1:] == pos_s[:-1])
    adj = same_doc & (pos_s[1:] == pos_s[:-1] + 1)
    is_real = (docs_s < big).to(torch.float32)
    distinct = torch.cat([is_real[:1], (~dup).to(torch.float32) * is_real[1:]])
    safe = torch.where(docs_s < big, docs_s, torch.zeros_like(docs_s))
    anyorder = torch.zeros(n_docs, dtype=torch.float32, device=dev)
    anyorder.index_add_(0, safe, distinct)
    seq = torch.zeros(n_docs, dtype=torch.float32, device=dev)
    seq.index_add_(0, safe[1:], adj.to(torch.float32))
    ub = _f32(user_boost, dev)
    return torch.where(anyorder > 0, anyorder + 2.0 * seq + ub, ub)


# -- phrase stream (doc-major) ------------------------------------------------


def sort_phrase_stream(docs: torch.Tensor, poss: torch.Tensor,
                       terms: torch.Tensor):
    """Sort the (doc, pos, term) stream by (doc, pos), stable: one int64
    key ``doc << 32 | pos`` through a stable sort — the reference's
    ``lax.sort(..., num_keys=2)`` (stable), element for element."""
    key = (docs.long() << 32) | poss.long()
    order = torch.sort(key, stable=True).indices
    return docs[order], poss[order], terms[order]


def _shift_r(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    head = torch.full((n,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([head, a[:-n]])


def _shift_l(a: torch.Tensor, fill) -> torch.Tensor:
    tail = torch.full((1,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a[1:], tail])


def phrase_static_bits(docs: torch.Tensor, poss: torch.Tensor) -> torch.Tensor:
    """Commit-static per-position flag bits over the doc-major stream
    (uint8): 1 = first of its (doc, pos) group, 2 = group follows pos-1 in
    the same doc, 4 = next element shares this (doc, pos), 8 = valid."""
    valid = docs < PAD_DOC
    prev_doc = _shift_r(docs, 1, -1)
    prev_pos = _shift_r(poss, 1, -9)
    first = ((docs != prev_doc) | (poss != prev_pos)) & valid
    adj_key = (docs == prev_doc) & (poss == prev_pos + 1)
    next_same = (_shift_l(docs, -2) == docs) & (_shift_l(poss, -9) == poss)
    u8 = torch.uint8
    return (first.to(u8) + adj_key.to(u8) * 2 + next_same.to(u8) * 4
            + valid.to(u8) * 8)


def _matched(terms: torch.Tensor, spans: torch.Tensor) -> torch.Tensor:
    m = torch.zeros(terms.shape, dtype=torch.bool, device=terms.device)
    for j in range(spans.shape[0]):
        m = m | ((terms >= spans[j, 0]) & (terms < spans[j, 1]))
    return m


def _group_flags(first, adj_key, next_same, matched):
    """(anyc, seqc) bool: the reference's group logic (group size <= 2)."""
    m_next = _shift_l(matched, False)
    grp_any = matched | (next_same & m_next)
    m_prev = _shift_r(matched, 1, False)
    m_prev2 = _shift_r(matched, 2, False)
    first_prev = _shift_r(first, 1, True)
    prev_grp_matched = m_prev | (~first_prev & m_prev2)
    anyc = first & grp_any
    seqc = first & adj_key & grp_any & prev_grp_matched
    return anyc, seqc


def _phrase_group_flags_bits(bits, terms, spans):
    """Per-position (anyc, seqc) as f32 from the commit-static bits."""
    matched = _matched(terms, spans) & ((bits & 8) > 0)
    anyc, seqc = _group_flags(
        (bits & 1) > 0, (bits & 2) > 0, (bits & 4) > 0, matched
    )
    return anyc.to(torch.float32), seqc.to(torch.float32)


def _boost_from_counts(anyorder, seq, user_boost):
    """anyorder + 2*seq + user_boost where a doc matched, user_boost
    elsewhere. A Python ``user_boost`` stays a scalar (no upload)."""
    a = anyorder.to(torch.float32)
    s = seq.to(torch.float32)
    if isinstance(user_boost, torch.Tensor):
        ub = _f32(user_boost, a.device)
    else:
        ub = float(np.float32(user_boost))
    return torch.where(a > 0, a + 2.0 * s + ub, ub)


def phrase_boost_docmajor(docs, poss, terms, doc_bounds, spans, user_boost,
                          n_docs: int) -> torch.Tensor:
    """Sort-free phrase boost over the commit-static doc-major stream:
    per-doc counts of matched (doc, pos) groups (``anyorder``) and of
    matched groups following a matched group at pos-1 (``sequences``),
    read through the per-doc CSR bounds of the stream. Counts are
    integer cumsums (exact at any stream length), from K4 on the card."""
    anyorder, seq = phrase_counts(phrase_static_bits(docs, poss), terms,
                                  doc_bounds, spans, n_docs)
    return _boost_from_counts(anyorder, seq, user_boost)


# The reference's windowed reduction bins each _PH_PB-position block into a
# commit-static doc window (Mosaic has no scatter). The port keeps its host
# helper and the constants that shape it, beside the reference's other
# host helpers; nothing on the serving path calls it, because K4 counts
# per doc directly and reads no windows.
_PH_PB = 2048              # positions per stream block
_PH_SUB = 16               # sub-runs per block
_PH_SUBLEN = _PH_PB // _PH_SUB
_PH_W_CAP = 1024
_PH_WSUB_CAP = 256
_PH_GRP = 8                # stream blocks per reference grid step


def phrase_window_meta(doc_bounds, pp: int, pp_pad: int):
    """Host: per-block aligned window bases + static window widths of the
    reference's windowed phrase kernel, from the per-doc CSR
    ``doc_bounds``. Returns (w_base int32[nb], W, wsub) or None when the
    corpus is too doc-dense for the windowed layout."""
    if pp_pad % (_PH_PB * _PH_GRP) != 0 or pp <= 0:
        return None
    nb = pp_pad // _PH_PB

    def doc_of(p):
        return np.searchsorted(doc_bounds, p, side="right") - 1

    starts = np.arange(nb, dtype=np.int64) * _PH_PB
    live = starts < pp
    ends = np.minimum(starts + _PH_PB, pp) - 1
    first = np.where(live, doc_of(np.minimum(starts, pp - 1)), 0)
    last = np.where(live, doc_of(ends), 0)
    rng = (last - first + 1) * live
    W = int(rng.max()) if nb else 1
    W = max(((W + 127) // 128) * 128, 128)
    if W > _PH_W_CAP:
        return None

    nsub = pp_pad // _PH_SUBLEN
    s_starts = np.arange(nsub, dtype=np.int64) * _PH_SUBLEN
    s_live = s_starts < pp
    s_ends = np.minimum(s_starts + _PH_SUBLEN, pp) - 1
    s_first = np.where(s_live, doc_of(np.minimum(s_starts, pp - 1)), 0)
    s_last = np.where(s_live, doc_of(s_ends), 0)
    s_rng = (s_last - s_first + 1) * s_live
    wsub = int(s_rng.max()) if nsub else 1
    wsub = max(((wsub + 7) // 8) * 8, 8)
    if wsub > _PH_WSUB_CAP:
        return None
    if _PH_SUB * wsub * 2 * W * 4 > 4 * 1024 * 1024:
        return None

    w_base = ((first // W) * W * live).astype(np.int32)
    return w_base, W, wsub


def phrase_counts_plain(bits, terms, doc_bounds, spans, n_docs: int):
    """Plain torch version of K4's counting: (anyorder int32[n_docs],
    seq int32[n_docs]) over the doc-sorted stream, in the cumsum form of
    phrase_boost_docmajor: integer running sums of the per-position flags
    read at the per-doc CSR bounds ``doc_bounds`` int32[n_docs + 1]."""
    anyc, seqc = _phrase_group_flags_bits(bits, terms, spans)
    zero = torch.zeros(1, dtype=torch.int64, device=bits.device)
    csa = torch.cat([zero, torch.cumsum(anyc.to(torch.int64), 0)])
    css = torch.cat([zero, torch.cumsum(seqc.to(torch.int64), 0)])
    at = doc_bounds.long()
    anyorder = (csa[at[1:]] - csa[at[:-1]])[:n_docs].to(torch.int32)
    seq = (css[at[1:]] - css[at[:-1]])[:n_docs].to(torch.int32)
    return anyorder, seq


def phrase_counts(bits, terms, doc_bounds, spans, n_docs: int):
    """K4: per-doc (anyorder, seq) int32 counts over the doc-sorted stream
    (csrc/phrase_counts.cu); the plain version for CPU tensors. Each
    block of the kernel owns whole docs and writes each of their counts
    once, so the outputs are allocated without a fill."""
    if not bits.is_cuda:
        return phrase_counts_plain(bits, terms, doc_bounds, spans, n_docs)
    _cuda.require(bits, "bits", torch.uint8, 1)
    _cuda.require(terms, "terms", torch.int32, 1)
    _cuda.require(doc_bounds, "doc_bounds", torch.int32, 1)
    spans = spans.to(torch.int32).contiguous()
    _cuda.require(spans, "spans", torch.int32, 2)
    pp = bits.shape[0]
    if terms.shape[0] != pp:
        raise ValueError("bits/terms must have one entry per position")
    if pp >= 2**31:
        raise ValueError("the phrase stream must hold fewer than 2^31 "
                         "positions")
    if doc_bounds.shape[0] != n_docs + 1:
        raise ValueError(f"doc_bounds: expected {n_docs + 1} entries")
    if spans.shape[0] > 32 or spans.shape[1] != 2:
        raise ValueError("spans must be [<=32, 2]")
    for name, t in (("bits", bits), ("terms", terms)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel's 16-byte copies need a "
                             "16-byte aligned tensor")
    anyorder = torch.empty(n_docs, dtype=torch.int32, device=bits.device)
    seq = torch.empty(n_docs, dtype=torch.int32, device=bits.device)
    lib = _cuda.lib("phrase_counts")
    _cuda.LAUNCHES["phrase_counts"] += 1
    _cuda.check(lib.phrase_counts(
        _cuda.ptr(bits), _cuda.ptr(terms), _cuda.ptr(doc_bounds),
        _cuda.ptr(spans), _cuda.ptr(anyorder), _cuda.ptr(seq), int(pp),
        int(spans.shape[0]), int(n_docs), _cuda.stream(),
    ), "phrase_counts")
    return anyorder, seq


def stream_doc_bounds(docs: torch.Tensor, n_docs: int) -> torch.Tensor:
    """Per-doc CSR bounds int32[n_docs + 1] of a (doc, pos)-sorted stream
    whose padding holds PAD_DOC: bounds[d] = positions of docs below d."""
    at = torch.arange(n_docs + 1, dtype=docs.dtype, device=docs.device)
    return torch.searchsorted(docs, at).to(torch.int32)


def phrase_boost_docmajor_windowed(docs, poss, terms, w_base, spans,
                                   user_boost, n_docs: int, W: int,
                                   wsub: int,
                                   bits: Optional[torch.Tensor] = None,
                                   combine: str = "segsum",
                                   bounds: Optional[torch.Tensor] = None,
                                   ) -> torch.Tensor:
    """K4 path: the reference's windowed phrase boost contract (same
    arguments, no ``interpret``) and a result bit-identical to
    phrase_boost_docmajor. The per-doc counts come from K4
    (``phrase_counts``), which needs no windows: ``w_base``, ``W``,
    ``wsub`` and ``combine`` are accepted for the signature and unused.
    Without ``bits`` they are derived from (docs, poss) first; without
    ``bounds`` (the stream's per-doc CSR, int32[n_docs + 1]) they are
    derived from ``docs`` with one searchsorted."""
    if bits is None:
        bits = phrase_static_bits(docs, poss)
    if bounds is None:
        bounds = stream_doc_bounds(docs, n_docs)
    anyorder, seq = phrase_counts(bits, terms, bounds, spans, n_docs)
    return _boost_from_counts(anyorder, seq, user_boost)


# -- dense per-term score rows (Zipf head) ------------------------------------
#
# The per-posting factor g(tf, len) is commit-static; only idf and the field
# boost are query-dependent per-term scalars. The few head terms that hold
# most postings are precomputed at commit as dense [cap] g rows, and a
# query adds them as one weighted row-sum instead of scanning their
# postings.


def build_dense_term_rows(term_starts, post_docs, post_tf, doc_lens_dense,
                          cap: int, avgdl: float, budget: int,
                          df_ratio: int):
    """Host (numpy): pick heavy terms and build their dense g rows.

    Heavy = posting-span width >= max(cap // df_ratio, 8), top ``budget``
    by width. Rows embed avgdl but NOT idf or boost. Returns
    (rows float32[H, cap], row_by_term {t: row}) or None."""
    if budget <= 0 or len(term_starts) < 2:
        return None
    spans = np.diff(term_starts)
    thresh = max(cap // max(df_ratio, 1), 8)
    heavy = np.nonzero(spans >= thresh)[0]
    if heavy.size == 0:
        return None
    if heavy.size > budget:
        heavy = heavy[np.argsort(spans[heavy], kind="stable")[::-1][:budget]]
        heavy.sort()
    rows = np.zeros((len(heavy), cap), np.float32)
    for r, t in enumerate(heavy):
        lo, hi = int(term_starts[t]), int(term_starts[t + 1])
        docs = post_docs[lo:hi]
        tf = post_tf[lo:hi].astype(np.float32)
        lens = doc_lens_dense[docs]
        den = tf + K1 * (1.0 - B + B * lens / max(float(avgdl), 1e-9))
        rows[r, docs] = tf * (K1 + 1.0) / np.maximum(den, 1e-9)
    return rows, {int(t): r for r, t in enumerate(heavy)}


def split_spans_dense(token_spans, term_starts, row_by_term, term_df,
                      n_for_idf):
    """Host: split token term-spans into light posting subspans + heavy
    rows. Returns (p_lo, p_len, sel_rows, sel_idf)."""
    p_lo: list = []
    p_len: list = []
    sel: list = []
    w: list = []
    for lo, hi in token_spans:
        cur = int(term_starts[lo])
        for t in range(lo, hi):
            r = row_by_term.get(t)
            if r is None:
                continue
            t_lo, t_hi = int(term_starts[t]), int(term_starts[t + 1])
            if t_lo > cur:
                p_lo.append(cur)
                p_len.append(t_lo - cur)
            cur = t_hi
            ni = float(term_df[t])
            w.append(
                math.log1p(max((n_for_idf - ni + 0.5) / (ni + 0.5), 0.0))
            )
            sel.append(r)
        end = int(term_starts[hi])
        if end > cur:
            p_lo.append(cur)
            p_len.append(end - cur)
    return p_lo, p_len, sel, w


DENSE_SEL_BUCKETS = (2, 8, 32)


def pad_dense_sel(sel, w, buckets=DENSE_SEL_BUCKETS):
    """Pad (sel, w) to a bucketed length; pads select row 0 with weight 0."""
    n = len(sel)
    if n > buckets[-1]:
        raise ValueError(f"dense selection {n} exceeds bucket {buckets[-1]}")
    hb = next(b for b in buckets if b >= n)
    sel_a = np.zeros(hb, np.int32)
    w_a = np.zeros(hb, np.float32)
    sel_a[:n] = sel
    w_a[:n] = w
    return sel_a, w_a


def dense_rows_contrib(rows, sel, w, boost) -> torch.Tensor:
    """boost * sum_h w[h] * rows[sel[h]] — the heavy-term scores (f32)."""
    picked = rows[sel.long()]                             # [H, cap]
    return _f32(boost, rows.device) * (w.to(torch.float32) @ picked)
