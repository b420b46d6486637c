"""The port's mesh programs (``orama_core_tpu_torch/parallel/``) against the
JAX package's, on the CPU.

Each ``sharded_engine`` and ``sharded_search`` function gets the same numpy
inputs as the reference's program of the same name, which runs under
``shard_map`` on the first S of the conftest's 8 virtual CPU devices; the
port's mesh puts its S shards on the CPU. S is 2, 3 and 8. The per-shard
layouts come from each package's own ``_DeviceCache`` where the function
reads them (the posting columns, the phrase positions or stream, the
vector rows). Tolerances: ids, integer counts and facet counts exact; f32
scores rtol 1e-5 (the order of summation differs); the vector fast path's
match count within 1 (a similarity within rounding of zero may change
sign), as the reference's own mesh test allows. The reference's fused kNN
runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orama_core_tpu.config import TpuConfig
from orama_core_tpu.engine.collection_read import _DeviceCache as RefCache
from orama_core_tpu.index import CommittedStringIndex as RefStringIndex
from orama_core_tpu.index import CommittedVectorIndex as RefVectorIndex
from orama_core_tpu.parallel import sharded_engine as ref_se
from orama_core_tpu.parallel import sharded_search as ref_ss
from orama_core_tpu.parallel.mesh import make_mesh as ref_make_mesh
from orama_core_tpu_torch.config import GpuConfig
from orama_core_tpu_torch.engine.collection_read import _DeviceCache
from orama_core_tpu_torch.index import (
    CommittedStringIndex,
    CommittedVectorIndex,
    UncommittedStringIndex,
)
from orama_core_tpu_torch.ops import bm25 as bm25_ops
from orama_core_tpu_torch.ops import fusion as fusion_ops
from orama_core_tpu_torch.ops import topk as topk_ops
from orama_core_tpu_torch.parallel import mesh as pmesh
from orama_core_tpu_torch.parallel import sharded_engine as se
from orama_core_tpu_torch.parallel import sharded_search as ss

SHARDS = [2, 3, 8]
RTOL = 1e-5


def _meshes(S):
    """(port mesh, reference mesh) of S data shards."""
    devs = jax.devices()
    if len(devs) < S:
        pytest.skip("needs the conftest's 8 virtual devices")
    return (pmesh.make_mesh((S, 1), device="cpu"),
            ref_make_mesh((S, 1), ("data", "model"), devices=devs[:S]))


def _caches(S, **knobs):
    """(port, reference) device caches over S data shards."""
    port = _DeviceCache(GpuConfig(device="cpu", mesh_shape=(S, 1), **knobs))
    ref = RefCache.__new__(RefCache)
    ref.cfg = TpuConfig(**knobs)
    ref._store, ref._keepalive = {}, {}
    ref._mesh = ref_make_mesh((S, 1), ("data", "model"),
                              devices=jax.devices()[:S])
    return port, ref


def _np(x):
    if isinstance(x, pmesh.Sharded):
        return x.to_host()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sh(mesh, arr):
    """Host [S, ...] numpy onto the port's mesh."""
    return pmesh.put_stacked(mesh, np.asarray(arr))


def _string_index(rng, n_docs, vocab=40, doc_len=(3, 12)):
    """A committed string index (port) of random docs: each doc a
    sequence of Zipf-drawn words, with its positions."""
    unc = UncommittedStringIndex()
    for d in range(n_docs):
        n = int(rng.integers(*doc_len))
        words = rng.zipf(1.4, n) % vocab
        terms = {}
        for pos, w in enumerate(words):
            terms.setdefault(f"w{w:03d}", []).append(pos)
        unc.insert(d, n, {t: tuple(p) for t, p in terms.items()})
    return CommittedStringIndex.empty().merge(unc, n_docs, set())


# --- committed scoring -----------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_blocked_bm25_and_phrase_boost_match_reference(S):
    """K1's and K4's mesh programs (their plain versions here) against the
    reference's blocked scorers, on each package's per-shard layouts of
    one string index, for single terms, prefixes and phrases."""
    pm, rm = _meshes(S)
    rng = np.random.default_rng(S)
    local_cap = 48
    n_docs = local_cap * S - 5
    idx = _string_index(rng, n_docs)
    ref_idx = RefStringIndex.from_arrays(idx.to_arrays())
    pc, rc = _caches(S)
    p_docs, p_tf, p_ni, p_lens, ts_sh = pc.sharded_string_arrays(
        idx, local_cap)
    r_arrays = rc.sharded_string_arrays(ref_idx, local_cap)
    np.testing.assert_array_equal(ts_sh, r_arrays[6])
    terms, bits, bounds = pc.sharded_phrase_stream(idx, local_cap)
    mask_np = (rng.random(S * local_cap) > 0.2).astype(np.float32)
    mask = pmesh.shard_rows(pm, mask_np)
    td = idx.term_dict
    for query in (["w001"], ["w00"], ["w001", "w002"], ["w003", "w001", "w01"]):
        spans = [td.prefix_range(t) for t in query]
        spans = [(lo, hi) for lo, hi in spans if hi > lo]
        lo_sh = [[int(ts_sh[s, lo]) for lo, hi in spans] for s in range(S)]
        len_sh = [[int(ts_sh[s, hi] - ts_sh[s, lo]) for lo, hi in spans]
                  for s in range(S)]
        nb = bm25_ops.PLAN_BUCKETS[0]
        plans = np.stack([np.stack(bm25_ops.build_block_plan_aligned(
            lo_sh[s], len_sh[s], nb)) for s in range(S)])
        r_plans = [bm25_ops.build_block_plan(lo_sh[s], len_sh[s], nb)
                   for s in range(S)]
        for masked in (False, True):
            got = se.blocked_bm25(pm, p_docs, p_tf, p_ni, p_lens, plans, 1.5,
                                  6.0, float(n_docs), mask, local_cap, nb,
                                  masked)
            want = ref_se.blocked_bm25(rm, local_cap, nb, masked)(
                *r_arrays[:4],
                jnp.asarray(np.stack([p[0] for p in r_plans])),
                jnp.asarray(np.stack([p[1] for p in r_plans])),
                jnp.float32(1.5), jnp.float32(6.0), jnp.float32(n_docs),
                jnp.asarray(mask_np),
            )
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                                       atol=1e-6, err_msg=str(query))
        # phrase boost over the surface spans, from each shard's positions
        spans_a = np.zeros((4, 2), np.int32)
        spans_a[:len(spans)] = spans
        got = se.blocked_phrase_boost(pm, terms, bits, bounds, spans_a, 2.0,
                                      local_cap)
        ps = r_arrays[7]
        pp_lo = [[int(ps[s][ts_sh[s, lo]]) for lo, hi in spans]
                 for s in range(S)]
        pp_len = [[int(ps[s][ts_sh[s, hi]] - ps[s][ts_sh[s, lo]])
                   for lo, hi in spans] for s in range(S)]
        pb = [bm25_ops.build_block_plan(pp_lo[s], pp_len[s], nb)
              for s in range(S)]
        want = ref_se.blocked_phrase_boost(rm, local_cap, nb)(
            r_arrays[4], r_arrays[5], jnp.asarray(np.stack([p[0] for p in pb])),
            jnp.asarray(np.stack([p[1] for p in pb])), jnp.float32(2.0))
        np.testing.assert_array_equal(_np(got), np.asarray(want), str(query))


def _vector_index(rng, n_docs, d, max_rows=1):
    n_rows = rng.integers(1, max_rows + 1, n_docs)
    docs = np.repeat(np.arange(n_docs, dtype=np.int32), n_rows)
    vecs = rng.standard_normal((len(docs), d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return CommittedVectorIndex(dimension=d, vecs=vecs, vec_docs=docs)


@pytest.mark.parametrize("S", SHARDS)
def test_vector_scores_match_reference(S):
    """Dense sharded vector scores (exact bf16 rows and int8 codes) on each
    package's layouts of one index, with a filter mask."""
    pm, rm = _meshes(S)
    rng = np.random.default_rng(10 + S)
    local_cap, d = 40, 24
    v = _vector_index(rng, local_cap * S - 3, d, max_rows=3)
    rv = RefVectorIndex.from_arrays(v.to_arrays())
    pc, rc = _caches(S)
    q = rng.standard_normal(d).astype(np.float32)
    q /= np.linalg.norm(q)
    mask_np = (rng.random(S * local_cap) > 0.3).astype(np.float32)
    mask = pmesh.shard_rows(pm, mask_np)
    got = se.vector_scores(pm, *pc.sharded_vector_arrays(v, local_cap), q,
                           mask, local_cap)
    want = ref_se.vector_scores(rm, local_cap)(
        *rc.sharded_vector_arrays(rv, local_cap), jnp.asarray(q),
        jnp.asarray(mask_np))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=1e-6)
    got = se.vector_scores_int8(pm, *pc.sharded_vector_int8_arrays(
        v, local_cap), q, mask, local_cap)
    want = ref_se.vector_scores_int8(rm, local_cap)(
        *rc.sharded_vector_int8_arrays(rv, local_cap), jnp.asarray(q),
        jnp.asarray(mask_np))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("multivec", [False, True])
@pytest.mark.parametrize("S", SHARDS)
def test_vector_topk_fast_matches_reference(S, multivec):
    """The per-shard fused kNN (K2 + K3, or K6; their plain versions here)
    and its gathered merge against the reference's program in interpret
    mode. Shards pad to 1,024 rows (single-vector, tiled in 1,024-row
    blocks) or 4,096 (multi-vector); at k = 5 both take the kernels'
    branch, at k = 16 the dense one."""
    pm, rm = _meshes(S)
    rng = np.random.default_rng(20 + S)
    local_cap, d = 700, 64
    v = _vector_index(rng, local_cap * S, d, max_rows=3 if multivec else 1)
    rv = RefVectorIndex.from_arrays(v.to_arrays())
    pc, rc = _caches(S, posting_bucket_steps=(1024, 4096, 16384))
    vecs, rowdocs, _ = pc.sharded_vector_arrays(v, local_cap)
    r_vecs, r_rowdocs, _ = rc.sharded_vector_arrays(rv, local_cap)
    p_l = int(vecs.shape[0])
    bn = 2048
    while p_l % bn:
        bn //= 2
    m_max = 4 if multivec else 1
    rs = pc.sharded_vector_rowstarts(v, local_cap) if multivec else None
    r_rs = (rc.sharded_vector_rowstarts(rv, local_cap) if multivec
            else r_rowdocs)
    for k in (5, 16):
        q = rng.standard_normal(d).astype(np.float32)
        q /= np.linalg.norm(q)
        vals, gids, count = se.vector_topk_fast(
            pm, vecs, rowdocs, rs, q, local_cap, k, bn, m_max, p_l, multivec)
        rv_, rg, rcnt = ref_se.vector_topk_fast(
            rm, local_cap, k, bn, m_max, p_l, multivec, True)(
            r_vecs, r_rowdocs, r_rs, jnp.asarray(q))
        np.testing.assert_array_equal(_np(gids), np.asarray(rg))
        np.testing.assert_allclose(_np(vals), np.asarray(rv_), rtol=RTOL)
        assert abs(int(count) - int(rcnt)) <= 1


@pytest.mark.parametrize("S", SHARDS)
def test_ivfpq_scores_match_reference(S):
    """Sharded IVF-PQ (probe the shared centroids, ADC over the shard's
    members, exact rerank, scatter) on the same synthetic stacked arrays,
    plain and residual, with and without a rotation."""
    pm, rm = _meshes(S)
    rng = np.random.default_rng(30 + S)
    local_cap, d, m, c, cl, p_l, cap = 64, 16, 4, 16, 6, 128, 128
    codes = rng.integers(0, c, (S, p_l, m)).astype(np.uint8)
    books = rng.standard_normal((m, c, d // m)).astype(np.float32)
    vecs = rng.standard_normal((S, p_l, d)).astype(np.float32)
    cents = rng.standard_normal((cl, d)).astype(np.float32)
    lens = rng.integers(5, 30, (S, cl)).astype(np.int32)
    lists = np.zeros((S, cl, cap), np.int32)
    for s in range(S):
        perm = rng.permutation(p_l)
        at = 0
        for j in range(cl):
            lists[s, j, :lens[s, j]] = perm[at:at + lens[s, j]] % p_l
            at = (at + lens[s, j]) % (p_l - 30)
    docs = rng.integers(0, local_cap, (S, p_l)).astype(np.int32)
    rot = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)
    mask_np = (rng.random(S * local_cap) > 0.2).astype(np.float32)
    for residual, rotation in ((False, None), (True, rot)):
        got = se.ivfpq_scores(
            pm, _sh(pm, codes), torch.as_tensor(books), _sh(pm, vecs),
            torch.as_tensor(cents), _sh(pm, lists), _sh(pm, lens),
            _sh(pm, docs), None if rotation is None else torch.as_tensor(
                rotation), q, pmesh.shard_rows(pm, mask_np), local_cap,
            3, 8, 2, residual)
        want = ref_se.ivfpq_scores(rm, local_cap, 3, 8, 2, residual)(
            jnp.asarray(codes), jnp.asarray(books), jnp.asarray(vecs),
            jnp.asarray(cents), jnp.asarray(lists), jnp.asarray(lens),
            jnp.asarray(docs), jnp.asarray(
                np.eye(d, dtype=np.float32) if rotation is None else rotation),
            jnp.asarray(q), jnp.asarray(mask_np))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


# --- filters and facets ------------------------------------------------------


def _columns(rng, S, n_pad, local_cap, n_values):
    vals = rng.integers(0, n_values, (S, n_pad)).astype(np.float32)
    docs = rng.integers(0, local_cap, (S, n_pad)).astype(np.int32)
    valid = rng.random((S, n_pad)) > 0.1
    return vals, docs, valid


@pytest.mark.parametrize("S", SHARDS)
def test_filter_masks_and_facets_match_reference(S):
    pm, rm = _meshes(S)
    rng = np.random.default_rng(40 + S)
    local_cap, n_pad = 32, 48
    vals, docs, valid = _columns(rng, S, n_pad, local_cap, 12)
    P = [_sh(pm, a) for a in (vals, docs, valid)]
    R = [jnp.asarray(a) for a in (vals, docs, valid)]
    for lo, hi, lx, hx in ((2.0, 7.0, False, False), (2.0, 7.0, True, True)):
        got = se.number_range_mask(pm, *P, lo, hi, lx, hx, local_cap)
        want = ref_se.number_range_mask(rm, local_cap)(
            *R, jnp.float32(lo), jnp.float32(hi), jnp.array(lx), jnp.array(hx))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    got = se.number_eq_mask(pm, *P, 5.0, local_cap)
    want = ref_se.number_eq_mask(rm, local_cap)(*R, jnp.float32(5.0))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    wanted = np.asarray([3.0, 9.0, -1.0, -1.0], np.float32)
    got = se.keyword_set_mask(pm, *P, wanted, local_cap)
    want = ref_se.keyword_set_mask(rm, local_cap)(*R, jnp.asarray(wanted))
    np.testing.assert_array_equal(_np(got), np.asarray(want))

    matched_np = (rng.random(S * local_cap) > 0.4).astype(np.float32)
    matched = pmesh.shard_rows(pm, matched_np)
    lows = np.asarray([0.0, 4.0, 9.0], np.float32)
    highs = np.asarray([3.0, 8.0, 20.0], np.float32)
    got = se.number_facet_counts(pm, *P, lows, highs, matched, local_cap)
    want = ref_se.number_facet_counts(rm, local_cap, 3)(
        *R, jnp.asarray(lows), jnp.asarray(highs), jnp.asarray(matched_np))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    got = se.keyword_facet_counts(pm, *P, matched, 12)
    want = ref_se.keyword_facet_counts(rm, local_cap, 12)(
        *R, jnp.asarray(matched_np))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    tm = (rng.random(S * local_cap) > 0.5).astype(np.float32)
    hm = np.maximum(tm, (rng.random(S * local_cap) > 0.5).astype(np.float32))
    got = se.bool_facet_counts(pm, pmesh.shard_rows(pm, tm),
                               pmesh.shard_rows(pm, hm), matched)
    want = ref_se.bool_facet_counts(rm, local_cap)(
        jnp.asarray(tm), jnp.asarray(hm), jnp.asarray(matched_np))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("S", SHARDS)
def test_scatter_add_and_gather_values_match_reference(S):
    pm, rm = _meshes(S)
    rng = np.random.default_rng(50 + S)
    local_cap = 16
    base_np = rng.random(S * local_cap).astype(np.float32)
    idx = rng.choice(S * local_cap, 12, replace=False).astype(np.int32)
    vals = rng.random(12).astype(np.float32)
    for stacked in (True, False):
        base = pmesh.shard_rows(pm, base_np)
        if not stacked:  # per-shard tensors (shards on several devices)
            base = pmesh.Sharded([p.clone() for p in base])
        got = se.scatter_add(pm, base, idx, vals, local_cap)
        want = ref_se.scatter_add(rm, local_cap)(
            jnp.asarray(base_np), jnp.asarray(idx), jnp.asarray(vals))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL)
        np.testing.assert_array_equal(_np(base), base_np)  # out of place
        got = se.gather_values(pm, base, idx, local_cap)
        want = ref_se.gather_values(rm, local_cap)(
            jnp.asarray(base_np), jnp.asarray(idx))
        np.testing.assert_array_equal(got, np.asarray(want))


# --- top-k merges --------------------------------------------------------------


def _scores(rng, n, ties):
    """Sparse non-negative scores; with ``ties`` every value is one of a
    few, so equal scores straddle shards and the merge's tie order (lower
    global id first) decides the ranking."""
    s = rng.random(n).astype(np.float32)
    if ties:
        s = np.round(s * 4).astype(np.float32) / 4
    s[rng.random(n) > 0.5] = 0.0
    return s


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("S", SHARDS)
def test_topk_merges_match_reference(S, ties):
    """topk_with_count, minmax_topk and rrf_topk against the reference's
    programs (and the single-device fusion over the whole arrays): ids
    and counts exact, scores rtol 1e-5; with ties, the gid tie-break."""
    pm, rm = _meshes(S)
    rng = np.random.default_rng(60 + S + 7 * ties)
    local_cap = 96
    n = S * local_cap
    ft_np, vec_np = _scores(rng, n, ties), _scores(rng, n, ties)
    ft, vec = pmesh.shard_rows(pm, ft_np), pmesh.shard_rows(pm, vec_np)
    jft, jvec = jnp.asarray(ft_np), jnp.asarray(vec_np)
    for k in (1, 10, 40):
        v, g, c = se.topk_with_count(pm, ft, k, local_cap)
        rv, rg, rc = ref_se.topk_with_count(rm, k, local_cap)(jft)
        np.testing.assert_array_equal(_np(g), np.asarray(rg))
        np.testing.assert_allclose(_np(v), np.asarray(rv), rtol=RTOL)
        assert int(c) == int(rc)
        v, g, c = se.minmax_topk(pm, ft, vec, k, local_cap)
        rv, rg, rc = ref_se.minmax_topk(rm, k, local_cap)(jft, jvec)
        np.testing.assert_array_equal(_np(g), np.asarray(rg))
        np.testing.assert_allclose(_np(v), np.asarray(rv), rtol=RTOL)
        assert int(c) == int(rc)
        cand = se.rrf_candidate_count(k)
        v, g, c = se.rrf_topk(pm, ft, vec, k, cand, local_cap)
        rv, rg, rc = ref_se.rrf_topk(rm, k, cand, local_cap)(jft, jvec)
        np.testing.assert_array_equal(_np(g), np.asarray(rg))
        np.testing.assert_allclose(_np(v), np.asarray(rv), rtol=RTOL)
        assert int(c) == int(rc)
        # the single-device fusion over the whole arrays: same ranking
        fused = fusion_ops.rrf_fuse(torch.as_tensor(ft_np),
                                    torch.as_tensor(vec_np))
        sv, si = topk_ops.topk_stable(fused, k)
        keep = _np(sv) > 0
        np.testing.assert_array_equal(_np(g)[keep], _np(si)[keep])
        np.testing.assert_allclose(_np(v)[keep], _np(sv)[keep], rtol=RTOL)


def test_rrf_ranks_count_ties_by_global_id():
    """_shard_ranks equals the compare-and-count definition for candidates
    owned by this shard, by earlier shards and by later ones."""
    rng = np.random.default_rng(5)
    n, s = 50, 1
    sc = np.round(rng.random(n) * 3).astype(np.float32)
    g = np.asarray([0, 10, 49, 50, 60, 75, 99, 100, 140], np.int64)
    owner_vals = np.asarray([1.0, 2.0, 0.0, sc[0], sc[10], sc[25], sc[49],
                             3.0, 2.0], np.float32)
    got = se._shard_ranks(torch.as_tensor(sc), torch.as_tensor(g),
                          torch.as_tensor(owner_vals), s, n)
    gids = np.arange(n) + s * n
    want = [int(np.sum((sc > v) | ((sc == v) & (gids < gg))))
            for v, gg in zip(owner_vals, g)]
    np.testing.assert_array_equal(_np(got), want)


# --- sharded_search ------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_search_steps_match_reference(S):
    pm, rm = _meshes(S)
    rng = np.random.default_rng(70 + S)
    PL, D, K = 16, 8, 5
    vecs = rng.standard_normal((S * PL, D)).astype(np.float32)
    vec_docs = np.tile(np.arange(PL, dtype=np.int32), S)
    valid = (rng.random(S * PL) > 0.1).astype(np.float32)
    q = rng.standard_normal(D).astype(np.float32)
    v, g = ss.sharded_vector_topk(pm, K, PL)(vecs, vec_docs, valid, q)
    rv, rg = ref_ss.sharded_vector_topk(rm, K, PL)(
        jnp.asarray(vecs), jnp.asarray(vec_docs), jnp.asarray(valid),
        jnp.asarray(q))
    np.testing.assert_array_equal(_np(g), np.asarray(rg))
    np.testing.assert_allclose(_np(v), np.asarray(rv), rtol=RTOL)

    from orama_core_tpu.ops.quant import quantize_int8 as ref_q8

    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    codes, scales = ref_q8(jnp.asarray(vn))
    v, g = ss.sharded_int8_topk(pm, K, PL)(
        np.asarray(codes), np.asarray(scales), vec_docs, valid, q)
    rv, rg = ref_ss.sharded_int8_topk(rm, K, PL)(
        codes, scales, jnp.asarray(vec_docs), jnp.asarray(valid),
        jnp.asarray(q))
    np.testing.assert_array_equal(_np(g), np.asarray(rg))
    np.testing.assert_allclose(_np(v), np.asarray(rv), rtol=RTOL)

    LD, LP, LV, D2 = 32, 64, 32, 16
    args = (
        rng.integers(0, LD, S * LP).astype(np.int32),
        rng.uniform(1, 3, S * LP).astype(np.float32),
        rng.uniform(5, 50, S * LD).astype(np.float32),
        rng.integers(0, LP, S * 16).astype(np.int32),
        rng.uniform(0.1, 2, S * 16).astype(np.float32),
        rng.standard_normal((S * LV, D2)).astype(np.float32),
        rng.integers(0, LD, S * LV).astype(np.int32),
        np.ones(S * LV, np.float32),
        rng.standard_normal(D2).astype(np.float32),
        (rng.random(S * LD) > 0.2).astype(np.float32),
    )
    v, g = ss.sharded_hybrid_step(pm, 4, LD, LD)(*args, 20.0)
    rv, rg = ref_ss.sharded_hybrid_step(rm, 4, LD, LD)(
        *[jnp.asarray(a) for a in args], jnp.float32(20.0))
    np.testing.assert_array_equal(_np(g), np.asarray(rg))
    np.testing.assert_allclose(_np(v), np.asarray(rv), rtol=RTOL)


# --- the mesh itself -----------------------------------------------------------


def test_make_mesh_places_shards():
    m = pmesh.make_mesh((4, 2), device="cpu")
    assert m.shape == {"data": 4, "model": 2}
    assert m.data_devices == [torch.device("cpu")] * 4 and m.shared
    m = pmesh.make_mesh((3,), ("data",), devices=["cpu", "cpu", "cpu"])
    assert m.shape == {"data": 3} and len(m.data_devices) == 3
    with pytest.raises(ValueError):
        pmesh.make_mesh((3, 1), devices=["cpu", "cpu"])
    sh = pmesh.shard_rows(pmesh.make_mesh((2, 1), device="cpu"),
                          np.arange(8, dtype=np.int32))
    assert sh.stacked is not None and sh[1].tolist() == [4, 5, 6, 7]
    assert sh[1].data_ptr() == sh.stacked[1].data_ptr()  # views
    twice = sh.map(lambda a: a * 2)
    assert twice.to_host().tolist() == [0, 2, 4, 6, 8, 10, 12, 14]


def test_cuda_mesh_puts_shards_on_cards_in_blocks(monkeypatch):
    """Shard s of S goes on card s * n_cards // S: one card hosts all."""
    for n_cards, want in ((1, [0, 0, 0, 0]), (2, [0, 0, 1, 1]),
                          (4, [0, 1, 2, 3])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n_cards: n)
        m = pmesh.make_mesh((4, 1), device="cuda")
        assert [d.index for d in m.data_devices] == want
        assert m.root == torch.device("cuda", 0)
        assert m.shared == (n_cards == 1)
