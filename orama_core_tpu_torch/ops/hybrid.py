"""Fused hybrid serving program: one call per query.

Port of ``orama_core_tpu/ops/hybrid.py`` (``hybrid_fused_topk_mf``, every
``vmode``; the reference's sequential hybrid join, collection.rs:730-772).
The whole query

    filter masks -> per-field BM25 (K1 scan + dense head rows + K4 phrase
    boost) -> exact bf16 or int8 vector product, or the ANN candidates of
    IVF, PQ or IVF-PQ scattered onto their docs -> RRF/min-max fusion ->
    top-k + count + facet counts

runs as one sequence of device launches with no host sync before the
results are read. The staging layout is the reference's (two small
buffers, one int32 and one float32, unpacked at static offsets), so the
engine's host packing ports line for line. ``hybrid_fused_topk_batch``
serves a micro-batch of rows in the same way (exact vectors only).
"""

from __future__ import annotations

import torch

from ..utils import tracing
from . import bm25 as bm25_ops
from . import facets as facet_ops
from . import filters as filter_ops
from . import ivf as ivf_ops
from . import pq as pq_ops
from . import quant as quant_ops
from . import vector as vector_ops
from .fusion import (dense_topk, minmax_fuse, rrf_candidate_count,
                     rrf_fuse_topk, rrf_fuse_topk_batch)


def _field_fulltext_score(fargs, fstat, *, n_docs: int, bm25_pallas: bool):
    """One string field's dense BM25 scores: the blocked posting scan
    (aligned plan -> K1, or the unaligned plain scan), optional dense
    Zipf-head rows, optional phrase multiplier (K4, under either of the
    reference's phrase contracts). ``fstat`` = (n_blocks, phrase, dense,
    ph_windowed, ph_W, ph_wsub); ``fargs`` as in the reference."""
    (
        post_docs, post_tf, post_ni, post_lens, b_starts, b_valid,
        ba_idx, ba_lo, ba_hi, bm25_boost, avgdl, nfd,
        dense_rows, d_sel, d_w,
        ph_docs, ph_poss, ph_terms, ph_bounds, ph_wbase, ph_bits,
        ph_spans, ph_boost,
    ) = fargs
    n_blocks, phrase, dense, _ph_windowed, ph_W, ph_wsub = fstat
    if bm25_pallas:
        ft = bm25_ops.bm25_scores_blocked_aligned(
            post_docs, post_tf, post_ni, post_lens, ba_idx, ba_lo, ba_hi,
            bm25_boost, avgdl, nfd, n_docs=n_docs, n_blocks=n_blocks,
        )
    else:
        ft = bm25_ops.bm25_scores_blocked(
            post_docs, post_tf, post_ni, post_lens, b_starts, b_valid,
            bm25_boost, avgdl, nfd, n_docs=n_docs, n_blocks=n_blocks,
        )
    if dense:
        # heavy-term scores added BEFORE the phrase multiplier, exactly as
        # the scan's contribution for those terms would be
        ft = ft + bm25_ops.dense_rows_contrib(dense_rows, d_sel, d_w,
                                              bm25_boost)
    if phrase:
        # both of the reference's phrase contracts reach K4: the windowed
        # one carries the bits, the cumsum one the per-doc bounds, and
        # the wrapper derives what it is not given from docs and positions
        ft = ft * bm25_ops.phrase_boost_docmajor_windowed(
            ph_docs, ph_poss, ph_terms, ph_wbase, ph_spans, ph_boost,
            n_docs=n_docs, W=ph_W, wsub=ph_wsub, bits=ph_bits,
            bounds=ph_bounds,
        )
    return ft


def ann_vector_scores(vmode: str, v_statics: tuple, v_ann: tuple,
                      query: torch.Tensor, *, n_docs: int) -> torch.Tensor:
    """f32[n_docs]: the ANN candidates of one query (``vmode`` "ivf_pq",
    "ivf" or "pq", operands as ``_fused_vector_args`` resolves them), each
    adding relu(similarity) to its doc (the reference's ``.at[].add``)."""
    q = query[None, :]
    if vmode == "ivf_pq":
        codes, books, fvecs, cents, lists, lens, v_docs, rot = v_ann
        nprobe, cand_k, expand, residual = v_statics
        sims, rows = ivf_ops.ivf_pq_search(
            codes, books, fvecs, cents, lists, lens, q, nprobe=nprobe,
            k=cand_k, expand=expand, residual=residual, rotation=rot,
        )
    elif vmode == "ivf":
        fvecs, cents, lists, lens, v_docs = v_ann
        nprobe, cand_k = v_statics
        sims, rows = ivf_ops.ivf_search(fvecs, cents, lists, lens, q,
                                        nprobe=nprobe, k=cand_k)
    elif vmode == "pq":
        codes, books, fvecs, v_docs, v_valid, rot = v_ann
        (cand_k,) = v_statics
        sims, rows = pq_ops.pq_topk_rerank(codes, books, fvecs, v_valid, q,
                                           k=cand_k, expand=1, rotation=rot)
    else:
        raise ValueError(f"vmode={vmode!r} is not an ANN mode")
    out = torch.zeros(n_docs, dtype=torch.float32, device=query.device)
    return out.index_add_(0, v_docs[rows[0].long()].long(),
                          torch.clamp(sims[0], min=0.0))


def hybrid_fused_topk_mf(
    ints, flts, fields, vecs, vec_docs, vec_valid, alive_mask, filter_cols,
    facet_cols=(), *, n_docs: int, k: int, fusion: str, filters, facets=(),
    masked: bool, mode: str, bm25_pallas: bool, field_statics, u_ft_n: int,
    u_vec_n: int, qdim: int, vmode: str = "exact", v_statics: tuple = (),
    v_ann=None,
):
    """Multi-string-field fused serving with live freshness windows: the
    whole query in one call and two small uploads (``ints``, ``flts``).
    Arguments, staging layout and returns are the reference's (see its
    docstring), plus one facet kind: ("number_dense", n) counts a
    single-valued number column from its doc-major plane (cols =
    (plane,)). Returns (vals f32[k], ids int32[k], count int32, facet
    counts tuple)."""
    dev = alive_mask.device
    ic = [0]
    fc = [0]

    def take_i(n):
        v = ints[ic[0]: ic[0] + n]
        ic[0] += n
        return v

    def take_f(n):
        v = flts[fc[0]: fc[0] + n]
        fc[0] += n
        return v

    z1 = torch.zeros(1, dtype=torch.int32, device=dev)
    per_field = []
    for fdev, fstat in zip(fields, field_statics):
        nb, phrase, dense, ph_windowed, ph_W, ph_wsub, n_sp, n_dsel = fstat
        (post_docs, post_tf, post_ni, post_lens, dense_rows,
         ph_docs, ph_poss, ph_terms, ph_bounds, ph_wbase, ph_bits) = fdev
        if bm25_pallas:
            ba_idx, ba_lo, ba_hi = take_i(nb), take_i(nb), take_i(nb)
            b_starts = b_valid = z1
        else:
            b_starts, b_valid = take_i(nb), take_i(nb)
            ba_idx = ba_lo = ba_hi = z1
        ph_spans = (
            take_i(n_sp * 2).reshape(n_sp, 2) if phrase
            else torch.zeros((1, 2), dtype=torch.int32, device=dev)
        )
        d_sel = take_i(n_dsel) if dense else z1
        per_field.append((
            post_docs, post_tf, post_ni, post_lens,
            b_starts, b_valid, ba_idx, ba_lo, ba_hi,
            dense_rows, d_sel, ph_spans,
            ph_docs, ph_poss, ph_terms, ph_bounds, ph_wbase, ph_bits,
        ))
    u_ft_idx = take_i(u_ft_n) if u_ft_n else None
    u_vec_idx = take_i(u_vec_n) if u_vec_n else None

    flt_field = []
    for fstat in field_statics:
        dense, n_dsel = fstat[2], fstat[7]
        scalars = take_f(4)
        d_w = take_f(n_dsel) if dense else torch.zeros(1, device=dev)
        flt_field.append((scalars, d_w))
    filter_params = []
    for kind, n_wanted in filters:
        if kind in ("range", "eq", "range_dense", "eq_dense"):
            filter_params.append(take_f(4))
        elif kind == "bool":
            filter_params.append(take_f(1))
        else:  # keyword
            filter_params.append(take_f(n_wanted))
    facet_params = []
    for kind, n in facets:
        facet_params.append(
            (take_f(n), take_f(n)) if kind.startswith("number") else None
        )
    query = take_f(qdim) if qdim else None
    u_ft_vals = take_f(u_ft_n) if u_ft_n else None
    u_vec_vals = take_f(u_vec_n) if u_vec_n else None

    mask = alive_mask
    for (kind, _nw), cols, fp in zip(filters, filter_cols, filter_params):
        if kind == "range_dense":
            m = filter_ops.number_range_mask_dense(
                cols[0], fp[0], fp[1], fp[2] > 0, fp[3] > 0
            )
        elif kind == "eq_dense":
            m = filter_ops.number_eq_mask_dense(cols[0], fp[0])
        elif kind == "range":
            m = filter_ops.number_range_mask(
                cols[0], cols[1], cols[2], fp[0], fp[1], fp[2] > 0,
                fp[3] > 0, n_docs=n_docs,
            )
        elif kind == "eq":
            m = filter_ops.number_eq_mask(
                cols[0], cols[1], cols[2], fp[0], n_docs=n_docs
            )
        elif kind == "bool":
            true_mask, has_mask = cols
            m = torch.where(fp[0] > 0, true_mask, has_mask * (1.0 - true_mask))
        elif kind == "keyword_dense":
            m = filter_ops.value_set_mask_dense(cols[0], fp)
        else:  # keyword value-set
            m = filter_ops.value_set_mask(
                cols[0], cols[1], cols[2], fp, n_docs=n_docs
            )
        mask = filter_ops.combine_masks(mask, m)
    if mode != "vector":
        ft = torch.zeros(n_docs, dtype=torch.float32, device=dev)
        for pf, fstat, (scalars, d_w) in zip(per_field, field_statics,
                                             flt_field):
            nb, phrase, dense, ph_windowed, ph_W, ph_wsub, _n_sp, _nd = fstat
            (post_docs, post_tf, post_ni, post_lens,
             b_starts, b_valid, ba_idx, ba_lo, ba_hi,
             dense_rows, d_sel, ph_spans,
             ph_docs, ph_poss, ph_terms, ph_bounds, ph_wbase, ph_bits) = pf
            fargs = (
                post_docs, post_tf, post_ni, post_lens, b_starts, b_valid,
                ba_idx, ba_lo, ba_hi,
                scalars[0], scalars[1], scalars[2],
                dense_rows, d_sel, d_w,
                ph_docs, ph_poss, ph_terms, ph_bounds, ph_wbase, ph_bits,
                ph_spans, scalars[3],
            )
            ft = ft + _field_fulltext_score(
                fargs, (nb, phrase, dense, ph_windowed, ph_W, ph_wsub),
                n_docs=n_docs, bm25_pallas=bm25_pallas,
            )
        if u_ft_n:
            ft = ft.index_add(0, u_ft_idx.long(), u_ft_vals)
        if masked:
            ft = ft * mask
    if mode != "fulltext":
        if vmode == "exact":
            identity = bool(v_statics and v_statics[0])
            sims = vector_ops.sims_f32(vecs, query[None, :])[:, 0]
            sims = torch.clamp(sims, min=0.0) * vec_valid
            vec = vector_ops.doc_scores(sims, vec_docs, n_docs, identity)
        elif vmode == "int8":
            codes, scales, v_docs, v_valid = v_ann
            # the mask is {0,1}: applying it here AND after the window add
            # is idempotent, as in the reference
            vec = quant_ops.int8_brute_force_scores(
                codes, scales, v_docs, v_valid, query, mask, n_docs=n_docs
            )
        else:  # "ivf_pq", "ivf", "pq"
            vec = ann_vector_scores(vmode, v_statics, v_ann, query,
                                    n_docs=n_docs)
        if u_vec_n:
            vec = vec.index_add(0, u_vec_idx.long(), u_vec_vals)
        vec = vec * mask

    def facet_counts(matched):
        outs = []
        for (kind, n), cols, fp in zip(facets, facet_cols, facet_params):
            if kind == "number":
                outs.append(facet_ops.number_facet_counts(
                    cols[0], cols[1], cols[2], fp[0], fp[1], matched,
                    n_docs=n_docs,
                ))
            elif kind == "number_dense":
                outs.append(facet_ops.number_facet_counts_dense(
                    cols[0], fp[0], fp[1], matched
                ))
            elif kind == "keyword":
                outs.append(facet_ops.keyword_facet_counts(
                    cols[0], cols[1], cols[2], matched, n_values=n
                ))
            else:  # bool
                outs.append(facet_ops.bool_facet_counts(
                    cols[0], cols[1], matched
                ))
        return tuple(outs)

    if mode == "fulltext":
        fused = ft
        matched = ft > 0
    elif mode == "vector":
        fused = vec
        matched = vec > 0
    else:
        matched = (ft > 0) | (vec > 0)
        if fusion == "rrf":
            vals, idx, count = rrf_fuse_topk(ft, vec, k, rrf_candidate_count(k))
            return (vals, idx.to(torch.int32), count,
                    facet_counts(matched.to(torch.float32)))
        fused = minmax_fuse(ft, vec)
    vals, idx = dense_topk(fused, k)
    count = torch.sum(fused > 0).to(torch.int32)
    return (vals, idx.to(torch.int32), count,
            facet_counts(matched.to(torch.float32)))


def hybrid_fused_topk_batch(
    ints, flts, post_docs, post_tf, post_ni, post_lens, dense_rows, vecs,
    vec_docs, vec_valid, alive_mask, nf_vals, nf_docs, nf_valid, *,
    n_docs: int, k: int, fusion: str, nf: str, masked: bool, mode: str,
    n_blocks: int, b: int, qdim: int, dense: bool, vec_identity: bool = False,
):
    """Batched serving of ``b`` non-phrase rows that share one filter, with
    the single-query program's primitives (the reference's
    ``hybrid_fused_topk_batch``, aligned plan only):

        number filter -> K1 over ONE combined aligned plan whose blocks
        carry their row id (scores [b, n_docs] from one launch) + the
        Zipf-head rows as a [b, H] @ [H, n_docs] weight product -> one
        corpus product for the b query vectors -> per-row RRF or min-max
        fusion -> top-k + counts

    Staging (the reference's, two small uploads):
      ints: [block_idx, lo_off, hi_off, row_id] nb each (mode != vector)
      flts: [boost, avgdl, nfd], [nf lo, hi, lx, hx] (nf != "none"),
            [W b*H row-major] (dense), [queries b*qdim] (mode != fulltext)
    ``nf`` is "none", "range", "eq", "range_dense" or "eq_dense"; dummies
    stand in for the arrays a mode does not read. Returns (vals f32[b, k],
    ids int32[b, k], counts int32[b])."""
    ic = [0]
    fc = [0]

    def take_i(n):
        v = ints[ic[0]: ic[0] + n]
        ic[0] += n
        return v

    def take_f(n):
        v = flts[fc[0]: fc[0] + n]
        fc[0] += n
        return v

    scalars = take_f(3)
    boost, avgdl, nfd = scalars[0], scalars[1], scalars[2]
    if nf == "none":
        mask = alive_mask
    else:
        fp = take_f(4)
        if nf == "range_dense":
            m = filter_ops.number_range_mask_dense(
                nf_vals, fp[0], fp[1], fp[2] > 0, fp[3] > 0)
        elif nf == "eq_dense":
            m = filter_ops.number_eq_mask_dense(nf_vals, fp[0])
        elif nf == "range":
            m = filter_ops.number_range_mask(
                nf_vals, nf_docs, nf_valid, fp[0], fp[1], fp[2] > 0,
                fp[3] > 0, n_docs=n_docs)
        elif nf == "eq":
            m = filter_ops.number_eq_mask(nf_vals, nf_docs, nf_valid, fp[0],
                                          n_docs=n_docs)
        else:
            raise ValueError(f"nf={nf!r}")
        mask = filter_ops.combine_masks(alive_mask, m)
    # traced: each phase a profiler range, timed on the stream by events
    dev = flts.device
    if mode != "vector":
        with tracing.span("fused.bm25", profile=True, device=dev, b=b):
            ba_idx, ba_lo, ba_hi, row_id = (take_i(n_blocks) for _ in range(4))
            ft = bm25_ops.bm25_scores_blocked_aligned_batch(
                post_docs, post_tf, post_ni, post_lens, ba_idx, ba_lo, ba_hi,
                row_id, boost, avgdl, nfd, n_docs=n_docs, n_blocks=n_blocks,
                b=b,
            )
            if dense:
                h = dense_rows.shape[0]
                w = take_f(b * h).reshape(b, h)
                ft = ft + boost * (w @ dense_rows)
            if masked:
                ft = ft * mask[None, :]
    if mode != "fulltext":
        # brute_force_scores_batch sets the span's route (kernel or torch)
        with tracing.span("fused.vector", profile=True, device=dev, b=b):
            queries = take_f(b * qdim).reshape(b, qdim)
            vec = vector_ops.brute_force_scores_batch(
                vecs, vec_docs, vec_valid, queries, mask, n_docs=n_docs,
                identity=vec_identity,
            )
    with tracing.span("fused.rank", profile=True, device=dev, b=b):
        if mode == "fulltext":
            fused = ft
        elif mode == "vector":
            fused = vec
        elif fusion == "rrf":
            vals, idx, counts = rrf_fuse_topk_batch(
                ft, vec, k, rrf_candidate_count(k))
            return vals, idx.to(torch.int32), counts
        else:
            # min-max per row: each row divides by its own max
            m = torch.clamp(torch.maximum(ft.amax(dim=1), vec.amax(dim=1)),
                            min=1e-9)
            fused = (ft + vec) / m[:, None]
        vals, idx = dense_topk(fused, k)
        counts = torch.sum(fused > 0, dim=1).to(torch.int32)
        return vals, idx.to(torch.int32), counts
