"""Document-sharded search steps over a device mesh.

Port of ``orama_core_tpu/parallel/sharded_search.py``: the standalone
sharded programs (the reference's tests and its multi-chip dry run drive
them; the engine's mesh path is ``sharded_engine``). Every query runs on
all document shards: each shard scores its local slice, takes a local
top-k, and the k-per-shard candidates are gathered in shard order on the
mesh's first device and re-topped. Traffic per query is O(shards * k),
independent of corpus size.

Each factory returns a function of flat ``[S * L, ...]`` arrays (host or
device), split into their S row blocks (``mesh.shard_rows``); the query
and the scalars are replicated. Shard-local doc ids are
``local_id + shard * shard_cap`` so global ids reconstruct without a
lookup table.
"""

from __future__ import annotations

import torch

from ..ops import fusion as fusion_ops
from ..ops import quant as quant_ops
from ..ops.topk import topk_stable
from ..ops.vector import sims_f32
from .mesh import Mesh, gather, per_shard, replicate, shard_rows


def _merge(mesh: Mesh, outs, k: int):
    v_all = gather(mesh, [v for v, _ in outs])               # [S*k]
    g_all = gather(mesh, [g for _, g in outs])
    vf, idx = topk_stable(v_all, k)
    return vf, g_all[idx]


def sharded_vector_topk(mesh: Mesh, k: int, shard_cap: int):
    """An exact sharded kNN: (vecs [S*Pl, D], vec_docs, valid, query [D])
    -> (global top-k scores, global doc ids)."""

    def run(vecs, vec_docs, valid, query):
        vs, ds, ms = (shard_rows(mesh, a) for a in (vecs, vec_docs, valid))
        q = replicate(mesh, query)

        def local(s, _dev):
            sims = sims_f32(vs[s], q[s][None, :])[:, 0]
            sims = torch.where(ms[s] > 0, sims,
                               torch.full_like(sims, float("-inf")))
            v, i = topk_stable(sims, k)
            return v, ds[s][i].long() + s * shard_cap

        return _merge(mesh, per_shard(mesh, local), k)

    return run


def sharded_int8_topk(mesh: Mesh, k: int, shard_cap: int):
    """Compressed-corpus variant of sharded_vector_topk: each shard scores
    its int8 slice (int32 accumulation), rescales by its per-row scales
    and the query's, local top-k, merge."""

    def run(codes, scales, vec_docs, valid, query):
        cs, ss, ds, ms = (shard_rows(mesh, a)
                          for a in (codes, scales, vec_docs, valid))
        q = replicate(mesh, query)

        def local(s, _dev):
            q8, q_scale = quant_ops.quantize_int8(
                q[s].to(torch.float32)[None, :])
            acc = quant_ops.int8_matmul(cs[s], q8)[:, 0]
            sims = acc.to(torch.float32) * ss[s] * q_scale[0]
            sims = torch.where(ms[s] > 0, sims,
                               torch.full_like(sims, float("-inf")))
            v, i = topk_stable(sims, k)
            return v, ds[s][i].long() + s * shard_cap

        return _merge(mesh, per_shard(mesh, local), k)

    return run


def sharded_hybrid_step(mesh: Mesh, k: int, shard_cap: int,
                        n_local_docs: int):
    """A full hybrid query step over the mesh: per-shard BM25 (a gather
    of the posting slots to score, summed per doc), vector product, RRF
    fusion, local top-k and the gathered merge."""

    def run(post_docs, post_tf, doc_lens, g_idx, g_idf, vecs, vec_docs,
            vec_valid, query, filter_mask, avgdl):
        pd, pt, dl, gi, gw, vs, vd, vv, fm = (shard_rows(mesh, a) for a in (
            post_docs, post_tf, doc_lens, g_idx, g_idf, vecs, vec_docs,
            vec_valid, filter_mask))
        q = replicate(mesh, query)
        a = float(avgdl)

        def local(s, dev):
            docs = pd[s][gi[s].long()].long()
            tf = pt[s][gi[s].long()]
            den = tf + 1.2 * (1.0 - 0.75 + 0.75 * dl[s][docs] / max(a, 1e-9))
            contrib = gw[s] * tf * 2.2 / torch.clamp(den, min=1e-9)
            contrib = contrib * fm[s][docs]
            ft = torch.zeros(n_local_docs, dtype=torch.float32, device=dev)
            ft.index_add_(0, docs, contrib)
            sims = torch.clamp(sims_f32(vs[s], q[s][None, :])[:, 0],
                               min=0.0) * vv[s]
            vec = torch.zeros(n_local_docs, dtype=torch.float32, device=dev)
            vec.index_add_(0, vd[s].long(), sims)
            fused = fusion_ops.rrf_fuse(ft, vec * fm[s])
            v, i = topk_stable(fused, k)
            return v, i + s * shard_cap

        return _merge(mesh, per_shard(mesh, local), k)

    return run
