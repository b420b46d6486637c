"""Fused hybrid serving program: one call per query.

Port of ``orama_core_tpu/ops/hybrid.py`` (``hybrid_fused_topk_mf``,
``vmode="exact"``; the reference's sequential hybrid join,
collection.rs:730-772). The whole query

    filter masks -> per-field BM25 (K1 scan + dense head rows + K4 phrase
    boost) -> exact vector matmul -> RRF/min-max fusion -> top-k + count
    + facet counts

runs as one sequence of device launches with no host sync before the
results are read. The staging layout is the reference's (two small
buffers, one int32 and one float32, unpacked at static offsets), so the
engine's host packing ports line for line. The ANN vmodes (int8, ivf,
pq, ivf_pq) and the batched program are later slices.
"""

from __future__ import annotations

import torch

from . import bm25 as bm25_ops
from . import facets as facet_ops
from . import filters as filter_ops
from . import vector as vector_ops
from .fusion import dense_topk, minmax_fuse, rrf_candidate_count, rrf_fuse_topk


def _field_fulltext_score(fargs, fstat, *, n_docs: int, bm25_pallas: bool):
    """One string field's dense BM25 scores: the blocked posting scan
    (aligned plan -> K1, or the unaligned plain scan), optional dense
    Zipf-head rows, optional phrase multiplier (windowed contract -> K4,
    or the cumsum version). ``fstat`` = (n_blocks, phrase, dense,
    ph_windowed, ph_W, ph_wsub); ``fargs`` as in the reference."""
    (
        post_docs, post_tf, post_ni, post_lens, b_starts, b_valid,
        ba_idx, ba_lo, ba_hi, bm25_boost, avgdl, nfd,
        dense_rows, d_sel, d_w,
        ph_docs, ph_poss, ph_terms, ph_bounds, ph_wbase, ph_bits,
        ph_spans, ph_boost,
    ) = fargs
    n_blocks, phrase, dense, ph_windowed, ph_W, ph_wsub = fstat
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
        if ph_windowed:
            ft = ft * bm25_ops.phrase_boost_docmajor_windowed(
                ph_docs, ph_poss, ph_terms, ph_wbase, ph_spans, ph_boost,
                n_docs=n_docs, W=ph_W, wsub=ph_wsub, bits=ph_bits,
            )
        else:
            ft = ft * bm25_ops.phrase_boost_docmajor(
                ph_docs, ph_poss, ph_terms, ph_bounds, ph_spans, ph_boost,
                n_docs=n_docs,
            )
    return ft


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
    if vmode != "exact":
        raise NotImplementedError(f"vmode={vmode!r}: a later port slice")
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
        identity = bool(v_statics and v_statics[0])
        sims = vector_ops.sims_f32(vecs, query[None, :])[:, 0]
        sims = torch.clamp(sims, min=0.0) * vec_valid
        vec = vector_ops.doc_scores(sims, vec_docs, n_docs, identity)
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
