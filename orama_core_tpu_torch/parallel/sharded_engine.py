"""Sharded serving path: the engine's mesh programs over per-shard tensors.

Port of ``orama_core_tpu/parallel/sharded_engine.py``. With
``gpu.mesh_shape`` configured, every committed structure lives as
per-shard arrays over the mesh's ``data`` axis (shard-local doc-id
spaces: doc ``d`` is owned by shard ``d // local_cap`` at local id
``d % local_cap``). Each of the reference's ``shard_map`` programs is a
plain function here: its local body runs once per shard, on the shard's
device (``mesh.per_shard``), with the single-device functions of
``ops/``; then the merge runs on the mesh's first device. The tiled
``all_gather`` is a concatenation of the per-shard results in shard order
(``mesh.gather``), ``psum`` a sum (``mesh.psum``), and every final
selection is ``topk_stable``, so ties break toward the lower shard, then
the lower index, as ``lax.top_k`` does over the gathered ``[S * k]``.

Dense ``[cap]`` arrays (filter masks, per-field scores) exist only as
per-shard ``[local_cap]`` tensors (``mesh.Sharded``). The port runs
eagerly, so the reference's ``lru_cache`` of compiled programs has no
counterpart.

The hand-written kernels run per shard where the reference runs its
single-chip kernels or scorers: K2 + K3 (single-vector) and K6
(multi-vector) in ``vector_topk_fast``; K1 in ``blocked_bm25``, over the
aligned block plan, where the reference's local body is the plain
blocked scorer; K4 in ``blocked_phrase_boost``, over each shard's slice of
the doc-sorted phrase stream, where the reference's body is the plain
``phrase_boost_blocked``. The counts and scores are the same functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import bm25 as bm25_ops
from ..ops import facets as facet_ops
from ..ops import filters as filter_ops
from ..ops import quant as quant_ops
from ..ops import vector as vector_ops
from ..ops.fusion import rrf_candidate_count  # noqa: F401 (one definition)
from ..ops.topk import topk_stable
from .mesh import (
    Mesh, Sharded, gather, per_shard, psum, put_stacked, replicate,
)

RRF_K = 60.0


# --- committed scoring -------------------------------------------------------


def blocked_bm25(mesh: Mesh, docs: Sharded, tf: Sharded, ni: Sharded,
                 plens: Sharded, plans: np.ndarray, boost, avgdl, nfd,
                 mask: Sharded, n_local_docs: int, n_blocks: int,
                 masked: bool) -> Sharded:
    """(per-shard posting columns [S][Ppad], aligned block plans int32
    [S, 3, nb] as (block_idx, lo_off, hi_off), scalars, mask) -> BM25
    scores [S][local_cap]: K1 once per shard over the shard's plan
    (``ops/bm25.bm25_scores_blocked_aligned``)."""
    plan = put_stacked(mesh, np.asarray(plans, np.int32))

    def local(s, _dev):
        p = plan[s]
        raw = bm25_ops.bm25_scores_blocked_aligned(
            docs[s], tf[s], ni[s], plens[s], p[0], p[1], p[2], boost, avgdl,
            nfd, n_docs=n_local_docs, n_blocks=n_blocks,
        )
        return raw * mask[s] if masked else raw

    return Sharded(per_shard(mesh, local))


def blocked_phrase_boost(mesh: Mesh, terms: Sharded, bits: Sharded,
                         bounds: Sharded, spans: np.ndarray, user_boost,
                         n_local_docs: int) -> Sharded:
    """(per-shard phrase streams: terms, bits, per-doc bounds
    [S][local_cap + 1]; surface spans int32 [n_sp, 2]; boost) -> per-doc
    phrase boost [S][local_cap]: K4 once per shard. A doc's positions live
    only on its owning shard, so the boost is shard-local."""
    sp = replicate(mesh, np.asarray(spans, np.int32))

    def local(s, _dev):
        return bm25_ops.phrase_boost_docmajor_windowed(
            None, None, terms[s], None, sp[s], user_boost,
            n_docs=n_local_docs, W=0, wsub=0, bits=bits[s], bounds=bounds[s],
        )

    return Sharded(per_shard(mesh, local))


def vector_scores(mesh: Mesh, vecs: Sharded, vec_docs: Sharded,
                  valid: Sharded, query, mask: Sharded,
                  n_local_docs: int) -> Sharded:
    """(vecs [S][Pl, D], local vec_docs, valid, query [D], mask) ->
    sum-of-relu-cos scores [S][local_cap]."""
    q = replicate(mesh, query)
    return Sharded(per_shard(mesh, lambda s, _d: vector_ops.brute_force_scores(
        vecs[s], vec_docs[s], valid[s], q[s], mask[s], n_docs=n_local_docs)))


def vector_scores_int8(mesh: Mesh, codes: Sharded, scales: Sharded,
                       vec_docs: Sharded, valid: Sharded, query,
                       mask: Sharded, n_local_docs: int) -> Sharded:
    q = replicate(mesh, query)
    return Sharded(per_shard(mesh, lambda s, _d: quant_ops.int8_brute_force_scores(
        codes[s], scales[s], vec_docs[s], valid[s], q[s], mask[s],
        n_docs=n_local_docs)))


def vector_topk_fast(mesh: Mesh, vecs: Sharded, rowdocs: Sharded,
                     rowstarts: Optional[Sharded], query,
                     n_local_docs: int, k: int, block_rows: int, m_max: int,
                     n_valid: int, multivec: bool):
    """Mesh counterpart of the single-device fused kNN: each shard runs
    the fused top-k on its LOCAL rows (K2 + K3, or K6 for multi-vector
    docs; never a dense [cap] score array), ids globalize by shard
    offset, and the O(S*k) gather + top-k and the summed match count come
    back on the mesh's first device: (values f32[kk], global doc ids
    int64[kk], count). Per-shard row layouts stay doc-ascending (the
    stable shard partition keeps the committed order; pad rows sit at
    local_cap-1 with zero vectors)."""
    from ..ops import knn as knn_ops

    kk = min(k, n_valid)
    q = replicate(mesh, query)

    def local(s, _dev):
        qs = q[s].to(torch.float32)[None, :].to(vecs[s].dtype)
        if multivec:
            vals, docs, cnt = knn_ops.knn_topk_multivec_with_count(
                vecs[s], rowdocs[s], rowstarts[s], qs, k=kk,
                block_rows=block_rows, m_max=m_max, n_valid=n_valid,
                n_docs=n_local_docs,
            )
        else:
            vals, rows, cnt = knn_ops.knn_topk_with_count(
                vecs[s], qs, k=kk, block_rows=block_rows, n_valid=n_valid,
            )
            docs = rowdocs[s][rows.long()]
        return vals[0], docs[0].long() + s * n_local_docs, cnt[0]

    outs = per_shard(mesh, local)
    v_all = gather(mesh, [o[0] for o in outs])               # [S*kk]
    g_all = gather(mesh, [o[1] for o in outs])
    vf, ix = topk_stable(v_all, kk)
    return vf, g_all[ix], psum(mesh, [o[2] for o in outs])


def ivfpq_scores(mesh: Mesh, codes: Sharded, books, vecs: Sharded, cents,
                 lists: Sharded, lens: Sharded, docs: Sharded, rot, query,
                 mask: Sharded, n_local_docs: int, nprobe: int, cand_k: int,
                 expand: int, residual: bool) -> Sharded:
    """Sharded IVF-PQ serving: every shard probes the SAME global
    centroids, ADC-scans its own slice of the probed clusters' members,
    exact-reranks its top candidates and scatters them into its dense
    local score slice. The union of the per-shard candidate sets holds
    the single-device candidate set (a row's local ADC rank is never
    worse than its global rank), so recall is >= the replicated path's at
    the same nprobe / expand; the match count is the union's."""
    from ..ops import ivf as ivf_ops

    q = replicate(mesh, query)
    bk = replicate(mesh, books)
    ct = replicate(mesh, cents)
    rt = replicate(mesh, rot) if rot is not None else [None] * len(q)

    def local(s, dev):
        kk = min(cand_k, nprobe * lists[s].shape[1])
        sims, rows = ivf_ops.ivf_pq_search(
            codes[s], bk[s], vecs[s], ct[s], lists[s], lens[s],
            q[s][None, :], nprobe=nprobe, k=kk, expand=expand,
            residual=residual, rotation=rt[s],
        )
        d = docs[s][rows[0].long()].long()
        contrib = torch.clamp(sims[0], min=0.0)  # -inf pads -> 0
        out = torch.zeros(n_local_docs, dtype=torch.float32, device=dev)
        return out.index_add_(0, d, contrib) * mask[s]

    return Sharded(per_shard(mesh, local))


# --- filters ------------------------------------------------------------------


def number_range_mask(mesh: Mesh, vals: Sharded, docs: Sharded,
                      valid: Sharded, lo: float, hi: float, lx: bool,
                      hx: bool, n_local_docs: int) -> Sharded:
    return Sharded(per_shard(mesh, lambda s, _d: filter_ops.number_range_mask(
        vals[s], docs[s], valid[s], lo, hi, lx, hx, n_docs=n_local_docs)))


def number_eq_mask(mesh: Mesh, vals: Sharded, docs: Sharded, valid: Sharded,
                   value: float, n_local_docs: int) -> Sharded:
    return Sharded(per_shard(mesh, lambda s, _d: filter_ops.number_eq_mask(
        vals[s], docs[s], valid[s], value, n_docs=n_local_docs)))


def keyword_set_mask(mesh: Mesh, ids: Sharded, docs: Sharded, valid: Sharded,
                     wanted, n_local_docs: int) -> Sharded:
    """Keyword eq/in filter over per-shard (value-id, doc) columns; masks
    stay shard-local."""
    w = replicate(mesh, np.asarray(wanted, np.float32))
    return Sharded(per_shard(mesh, lambda s, _d: filter_ops.value_set_mask(
        ids[s], docs[s], valid[s], w[s], n_docs=n_local_docs)))


# --- facets --------------------------------------------------------------------
#
# Facet counts are masked reductions (ops/facets.py) over doc-disjoint
# shards: each shard reduces its local columns against its local matched
# slice, then one sum merges the counts (O(values), never a dense gather).


def number_facet_counts(mesh: Mesh, vals: Sharded, docs: Sharded,
                        valid: Sharded, lows, highs, matched: Sharded,
                        n_local_docs: int) -> torch.Tensor:
    lo = replicate(mesh, lows)
    hi = replicate(mesh, highs)
    return psum(mesh, per_shard(mesh, lambda s, _d: facet_ops.number_facet_counts(
        vals[s], docs[s], valid[s], lo[s], hi[s], matched[s],
        n_docs=n_local_docs)))


def keyword_facet_counts(mesh: Mesh, ids: Sharded, docs: Sharded,
                         valid: Sharded, matched: Sharded,
                         n_values: int) -> torch.Tensor:
    return psum(mesh, per_shard(mesh, lambda s, _d: facet_ops.keyword_facet_counts(
        ids[s], docs[s], valid[s], matched[s], n_values=n_values)))


def bool_facet_counts(mesh: Mesh, true_mask: Sharded, has_mask: Sharded,
                      matched: Sharded) -> torch.Tensor:
    return psum(mesh, per_shard(mesh, lambda s, _d: facet_ops.bool_facet_counts(
        true_mask[s], has_mask[s], matched[s])))


# --- host-window overlay -------------------------------------------------------


def _owned(idx: np.ndarray, s: int, n_local_docs: int):
    """(positions, local ids) of the global ids in ``idx`` shard s owns."""
    li = idx - s * n_local_docs
    own = np.nonzero((li >= 0) & (li < n_local_docs))[0]
    return own, li[own]


def scatter_add(mesh: Mesh, scores: Sharded, idx, vals,
                n_local_docs: int) -> Sharded:
    """Scatter (global doc ids, values) into a sharded dense array, out of
    place: each shard applies only the entries it owns. idx/vals are
    small host arrays (the uncommitted window), so no O(cap) traffic."""
    idx = np.asarray(idx, np.int64)
    vals = np.asarray(vals, np.float32)
    if scores.stacked is not None:
        flat = scores.stacked.reshape(-1).index_add(
            0, torch.as_tensor(idx, device=mesh.root),
            torch.as_tensor(vals, device=mesh.root))
        return Sharded.of_stacked(flat.reshape(scores.stacked.shape))

    def local(s, dev):
        own, li = _owned(idx, s, n_local_docs)
        if not len(own):
            return scores[s]
        return scores[s].index_add(0, torch.as_tensor(li, device=dev),
                                   torch.as_tensor(vals[own], device=dev))

    return Sharded(per_shard(mesh, local))


def gather_values(mesh: Mesh, arr: Sharded, idx,
                  n_local_docs: int) -> np.ndarray:
    """Values of a sharded dense array at (few) global doc ids, on the
    host: the filter or matched mask at the uncommitted window's docs,
    without pulling the whole array. O(n_idx) traffic."""
    idx = np.asarray(idx, np.int64)
    out = np.zeros(len(idx), np.float32)
    if arr.stacked is not None:
        t = arr.stacked.reshape(-1)[torch.as_tensor(idx, device=mesh.root)]
        return t.detach().cpu().numpy().astype(np.float32)
    for s, dev in enumerate(mesh.data_devices):
        own, li = _owned(idx, s, n_local_docs)
        if len(own):
            out[own] = arr[s][torch.as_tensor(li, device=dev)].cpu().numpy()
    return out


# --- top-k merges ---------------------------------------------------------------


def _local_topk_merge(mesh: Mesh, scores: Sharded, k: int, n_local_docs: int):
    """Local top-k per shard -> gather k per shard -> re-top-k. Ties go
    as in a global ``lax.top_k`` (lower global id wins): the gathered
    blocks are in shard order and ``topk_stable`` keeps positions."""
    kk = min(k, n_local_docs)

    def local(s, _dev):
        v, i = topk_stable(scores[s], kk)
        return v, i + s * n_local_docs

    outs = per_shard(mesh, local)
    v_all = gather(mesh, [o[0] for o in outs])               # [S*kk]
    g_all = gather(mesh, [o[1] for o in outs])
    vf, ix = topk_stable(v_all, k)
    return vf, g_all[ix]


def _matched_count(mesh: Mesh, scores: Sharded) -> torch.Tensor:
    return psum(mesh, per_shard(mesh, lambda s, _d: torch.sum(
        scores[s] > 0).to(torch.int32)))


def topk_with_count(mesh: Mesh, scores: Sharded, k: int, n_local_docs: int):
    """Sharded ``ops/topk.topk_with_count``: (scores [S][local_cap]) ->
    (values [k], global ids [k], matched count) on the first device."""
    vf, gf = _local_topk_merge(mesh, scores, k, n_local_docs)
    return vf, gf, _matched_count(mesh, scores)


def minmax_topk(mesh: Mesh, ft: Sharded, vec: Sharded, k: int,
                n_local_docs: int):
    """Hybrid min-max fusion + top-k: fused = (ft + vec) / max(max ft,
    max vec), monotone in ft + vec, so per-shard top-k merges exactly."""
    peaks = per_shard(mesh, lambda s, _d: torch.maximum(
        ft[s].max(), vec[s].max()))
    m = torch.clamp(torch.stack([p.to(mesh.root) for p in peaks]).max(),
                    min=1e-9)
    fused = ft.map(lambda a, b, mm: (a + b) / mm.to(a.device), vec, m)
    vf, gf = _local_topk_merge(mesh, fused, k, n_local_docs)
    return vf, gf, _matched_count(mesh, fused)


def _shard_ranks(scores: torch.Tensor, g: torch.Tensor, cand: torch.Tensor,
                 s: int, n_local_docs: int) -> torch.Tensor:
    """This shard's part of each candidate's global rank: #{docs here with
    a higher score} + #{docs here with an equal score and a lower global
    id}, from one stable sort of the shard's scores and two binary
    searches a candidate (no [local_cap, n_cand] compare matrix)."""
    n = n_local_docs
    srt, order = torch.sort(scores, stable=True)             # ascending
    lo = torch.searchsorted(srt, cand, right=False)
    hi = torch.searchsorted(srt, cand, right=True)
    li = g - s * n
    own = (li >= 0) & (li < n)
    # an owned candidate's place in the stable order, less the start of
    # its run of equal scores: the equal docs here with a lower local id
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=scores.device)
    eq_lower = torch.where(
        own, pos[li.clamp(0, n - 1)] - lo,
        torch.where(li >= n, hi - lo, torch.zeros_like(lo)))
    return (n - hi) + eq_lower


def rrf_topk(mesh: Mesh, ft: Sharded, vec: Sharded, k: int, cand: int,
             n_local_docs: int):
    """Hybrid RRF fusion + top-k without a global argsort.

    RRF needs GLOBAL ranks. Each shard proposes its top-``cand`` docs per
    modality; the union (gathered, O(S*cand)) provably holds the true
    fused top-k when cand >= 2k + 61 (``ops/fusion.rrf_candidate_count``).
    The candidates' exact global ranks are counted, reproducing the
    replicated path's stable order (``ops/fusion._ranks``) as integers:
    rank(d) = #{s' > s} + #{s' == s and gid' < gid}, summed over shards
    (``_shard_ranks``)."""
    n = n_local_docs
    cc = min(cand, n)

    def propose(s, _dev):
        return tuple(topk_stable(x[s], cc)[1] + s * n for x in (ft, vec))

    props = per_shard(mesh, propose)
    g_cand = torch.cat([gather(mesh, [p[0] for p in props]),
                        gather(mesh, [p[1] for p in props])])  # [2*S*cc]
    g_sh = replicate(mesh, g_cand)

    def values_at(s, _dev):
        li = g_sh[s] - s * n
        own = (li >= 0) & (li < n)
        lic = li.clamp(0, n - 1)
        return tuple(torch.where(own, x[s][lic], torch.zeros((), device=_dev))
                     for x in (ft, vec))

    vals = per_shard(mesh, values_at)
    ft_c = psum(mesh, [v[0] for v in vals])
    vec_c = psum(mesh, [v[1] for v in vals])
    c_sh = replicate(mesh, torch.stack([ft_c, vec_c]))

    def ranks(s, _dev):
        return torch.stack([
            _shard_ranks(x[s], g_sh[s], c_sh[s][j], s, n)
            for j, x in enumerate((ft, vec))])

    r = psum(mesh, per_shard(mesh, ranks)).to(torch.float32)
    zero = torch.zeros_like(ft_c)
    fused = (torch.where(ft_c > 0, 1.0 / (RRF_K + r[0] + 1.0), zero)
             + torch.where(vec_c > 0, 1.0 / (RRF_K + r[1] + 1.0), zero))
    # dedup docs proposed by both modalities (identical fused scores):
    # sort by gid, kill repeats, then top-k over fused
    g_s, order = torch.sort(g_cand, stable=True)
    f_s = fused[order]
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=g_s.device),
                     g_s[1:] == g_s[:-1]])
    f_s = torch.where(dup, torch.full_like(f_s, float("-inf")), f_s)
    vf, ix = topk_stable(f_s, k)
    vf = torch.clamp(vf, min=0.0)  # pad slots (-inf) -> 0 = unmatched
    count = psum(mesh, per_shard(mesh, lambda s, _d: torch.sum(
        (ft[s] > 0) | (vec[s] > 0)).to(torch.int32)))
    return vf, g_s[ix], count
