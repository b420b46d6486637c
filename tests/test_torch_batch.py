"""Batched serving of the PyTorch port against the JAX package.

The same numpy inputs go through the reference and the port:

- ``ops/fusion.rrf_fuse_topk_batch``: ids, counts and integer ranks equal,
  scores within 1e-6, on rows with and without score ties;
- K1 over a batch's combined plan (``bm25_scores_blocked_aligned_batch``,
  its plain twin on the CPU) against the reference's
  ``bm25_blocked_contrib_pallas`` in interpret mode plus its segment sum,
  rtol 1e-5;
- ``ops/hybrid.hybrid_fused_topk_batch`` on the staging the reference
  engine builds (its kernel branches forced, Pallas in interpret mode):
  ids and counts equal, scores within rtol 1e-5;
- ``CollectionReader.search_batch`` on a reference reader and a port
  reader fed the same writes: same ids and counts, scores within rtol
  1e-5, over the vector fast path, the batched fused program, the
  per-mode batch paths, phrase rows, deletes, live windows and memory
  chunks;
- the micro-batcher, alone and behind ``ReadSide.search``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orama_core_tpu.ops.bm25 as ref_bm25
import orama_core_tpu.ops.fusion as ref_fusion
import orama_core_tpu.ops.hybrid as ref_hybrid
from orama_core_tpu.types import SearchParams as RefParams
from orama_core_tpu_torch.ops import bm25 as port_bm25
from orama_core_tpu_torch.ops import fusion as port_fusion
from orama_core_tpu_torch.ops import hybrid as port_hybrid
from orama_core_tpu_torch.types import SearchParams as PortParams
from test_torch_engine import READ, WRITE, Pair, _fast_readers
from test_torch_hybrid import to_torch


# -- rrf_fuse_topk_batch -------------------------------------------------------


def _stable_ranks(row: np.ndarray) -> np.ndarray:
    """rank[d] = #{s' > s_d} + #{s' == s_d, d' < d}."""
    order = np.argsort(-row, kind="stable")
    ranks = np.empty(len(row), np.int64)
    ranks[order] = np.arange(len(row))
    return ranks


@pytest.mark.parametrize("n", [1000, 4096])
@pytest.mark.parametrize("ties", [False, True])
def test_rrf_fuse_topk_batch_matches_reference(ties, n):
    rng = np.random.default_rng(3 + int(ties))
    b = 5
    if ties:  # few distinct values: many equal scores per row
        ft = np.round(rng.random((b, n)) * 4, 1)
        vec = np.round(rng.random((b, n)), 2)
    else:
        ft = rng.random((b, n))
        vec = rng.random((b, n))
    ft = (ft * (rng.random((b, n)) > 0.4)).astype(np.float32)
    vec = (vec * (rng.random((b, n)) > 0.3)).astype(np.float32)
    ft[2] = 0.0  # a row that no fulltext term matched
    for k in (1, 10, 16):
        cand = port_fusion.rrf_candidate_count(k)
        rv, ri, rc = jax.device_get(ref_fusion.rrf_fuse_topk_batch(
            jnp.asarray(ft), jnp.asarray(vec), k, cand))
        pv, pi, pc = port_fusion.rrf_fuse_topk_batch(
            torch.from_numpy(ft), torch.from_numpy(vec), k, cand)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        # row r of the batch is rrf_fuse_topk of row r
        for r in range(b):
            sv, si, sc = port_fusion.rrf_fuse_topk(
                torch.from_numpy(ft[r]), torch.from_numpy(vec[r]), k, cand)
            assert torch.equal(si, pi[r]) and torch.equal(sv, pv[r])
            assert int(sc) == int(pc[r])
    # the candidates' ranks, as integers, are the stable full-sort ranks,
    # from the rows' sort and from the histogram, over several rows and one
    g = rng.integers(0, n, (b, 64))
    for scores in (ft, vec):
        for rows in (slice(0, b), slice(3, 4)):
            s_t, g_t = torch.from_numpy(scores[rows]), torch.from_numpy(g[rows])
            want = np.stack([_stable_ranks(s)[gr]
                             for s, gr in zip(scores[rows], g[rows])])
            for got in (port_fusion._candidate_ranks(s_t, g_t),
                        port_fusion._histogram_ranks(s_t, g_t)):
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ties", [False, True])
def test_rrf_fuse_topk_batch_sorted_rows_match_reference(ties, monkeypatch):
    """Batches of up to ``_SORT_MAX_ROWS`` rows rank by sorting each row;
    the case above takes the histogram (5 rows). Sorted rows, forced here
    for a wider batch, give the reference's fused top-k too."""
    monkeypatch.setattr(port_fusion, "_SORT_MAX_ROWS", 64)
    rng = np.random.default_rng(11 + int(ties))
    b, n, k = 9, 2048, 10
    ft = rng.random((b, n)) * (rng.random((b, n)) > 0.5)
    vec = rng.random((b, n)) * (rng.random((b, n)) > 0.2)
    if ties:
        ft, vec = np.round(ft * 4, 1), np.round(vec, 2)
    ft, vec = ft.astype(np.float32), vec.astype(np.float32)
    cand = port_fusion.rrf_candidate_count(k)
    rv, ri, rc = jax.device_get(ref_fusion.rrf_fuse_topk_batch(
        jnp.asarray(ft), jnp.asarray(vec), k, cand))
    pv, pi, pc = port_fusion.rrf_fuse_topk_batch(
        torch.from_numpy(ft), torch.from_numpy(vec), k, cand)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


# -- K1 over a combined plan ---------------------------------------------------


def _combined_plan(rows):
    """The engine's combined plan of ``rows`` as int32[4, nb] (block,
    lo, hi, row id), and nb."""
    plan = np.stack(port_bm25.build_batch_plan_aligned(rows))
    return plan, plan.shape[1]


@pytest.mark.parametrize("b", [1, 3, 17])
def test_k1_batch_twin_matches_reference(b):
    rng = np.random.default_rng(b)
    n_docs, n_post = 3000, 48 * 1024
    docs = rng.integers(0, n_docs, n_post).astype(np.int32)
    tf = rng.integers(1, 5, n_post).astype(np.float32)
    ni = rng.uniform(1, 500, n_post).astype(np.float32)
    lens = rng.uniform(5, 80, n_post).astype(np.float32)
    rows = []
    for r in range(b):
        if r % 4 == 1:
            rows.append(([], []))  # a row with no postings
            continue
        n_sp = int(rng.integers(1, 4))
        p_lo = [int(x) for x in rng.integers(0, n_post - 3000, n_sp)]
        rows.append((p_lo, [int(x) for x in rng.integers(1, 3000, n_sp)]))
    plan, nb = _combined_plan(rows)
    boost, avgdl, nfd = 1.3, 40.0, 2500.0
    contrib, docs_o = ref_bm25.bm25_blocked_contrib_pallas(
        jnp.asarray(docs), jnp.asarray(tf), jnp.asarray(ni),
        jnp.asarray(lens), *(jnp.asarray(a) for a in plan[:3]),
        jnp.float32(boost), jnp.float32(avgdl), jnp.float32(nfd),
        n_blocks=nb, interpret=True,
    )
    seg = docs_o.reshape(nb, -1) + jnp.asarray(plan[3])[:, None] * n_docs
    want = np.asarray(jax.ops.segment_sum(
        contrib.reshape(-1), seg.reshape(-1), num_segments=b * n_docs,
    )).reshape(b, n_docs)
    cols = [torch.from_numpy(a) for a in (docs, tf, ni, lens)]
    got = port_bm25.bm25_scores_blocked_aligned_batch(
        *cols, *(torch.from_numpy(a) for a in plan), boost, avgdl, nfd,
        n_docs=n_docs, n_blocks=nb, b=b,
    ).numpy()
    assert got.shape == (b, n_docs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for r, (_lo, p_len) in enumerate(rows):
        assert (got[r] > 0).any() == bool(p_len)
        # row r alone is the single-row scan of its own plan
        if p_len:
            single, snb = _combined_plan([rows[r]])
            one = port_bm25.bm25_scores_blocked_aligned(
                *cols, *(torch.from_numpy(a) for a in single[:3]), boost,
                avgdl, nfd, n_docs=n_docs, n_blocks=snb,
            ).numpy()
            np.testing.assert_allclose(got[r], one, rtol=1e-5, atol=1e-6)


# -- hybrid_fused_topk_batch on the reference engine's staging -----------------


def _ref_engine(tmp, dense=False):
    from orama_core_tpu import build_orama
    from orama_core_tpu.config import OramaxConfig

    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp / "w")
    cfg.reader_side.data_dir = str(tmp / "r")
    cfg.ai.backend = "fake"
    if dense:  # 'common' qualifies as a Zipf-head term at this size
        cfg.tpu.bm25_dense_df_ratio = 10**6
    e = build_orama(cfg, start_background=False)
    e.write_side.create_collection("master", "c", read_api_key=READ,
                                   write_api_key=WRITE)
    e.flush()
    rng = np.random.default_rng(9)
    vocab = ["solar", "wind", "panel", "turbine", "cake", "flour", "quantum",
             "laser"]
    docs = []
    for i in range(150):
        words = list(rng.choice(vocab, size=int(rng.integers(3, 10))))
        if dense:
            words += ["common"] * int(rng.integers(1, 3))
        docs.append({
            "id": str(i), "body": " ".join(words),
            "price": float(rng.integers(0, 20)),
            # several values per doc: the filter has no doc-major plane
            "sizes": [float(x) for x in rng.integers(0, 10, 2)],
        })
    e.write_side.write("c", docs, WRITE)
    e.flush()
    e.commit()
    reader = e.read_side._reader("c")
    reader.cfg._test_force_fast_path = True
    return e


@pytest.fixture(scope="module")
def ref_engines(tmp_path_factory):
    engines = {dense: _ref_engine(tmp_path_factory.mktemp(f"batch{dense}"),
                                  dense)
               for dense in (False, True)}
    yield engines
    for e in engines.values():
        e.close()


BATCHES = {  # name: (dense, mode, extra params, terms, expected nf kind)
    "fulltext": (False, "fulltext", {}, ["solar", "cake", "zzz", "laser"],
                 "none"),
    "hybrid_rrf": (False, "hybrid", {}, ["wind", "flour", "quantum"], "none"),
    "hybrid_minmax": (False, "hybrid", {"fusion": "minmax"},
                      ["panel", "turbine", "laser"], "none"),
    "vector_range_dense": (False, "vector",
                           {"where": {"price": {"between": [3, 12]}}},
                           ["solar power", "cake recipe", "lasers"],
                           "range_dense"),
    "vector_eq_dense": (False, "vector", {"where": {"price": {"eq": 7}}},
                        ["wind", "flour"], "eq_dense"),
    "hybrid_range": (False, "hybrid", {"where": {"sizes": {"gte": 4}}},
                     ["solar", "cake", "panel"], "range"),
    "fulltext_eq": (False, "fulltext", {"where": {"sizes": {"eq": 3}}},
                    ["wind", "quantum"], "eq"),
    "dense_fulltext": (True, "fulltext", {}, ["common", "solar", "common"],
                       "none"),
    "dense_hybrid": (True, "hybrid", {"where": {"price": {"lt": 15}}},
                     ["common", "laser", "cake"], "range_dense"),
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_fused_batch_program_matches_reference(ref_engines, monkeypatch,
                                               name):
    dense, mode, extra, terms, nf = BATCHES[name]
    engine = ref_engines[dense]
    reader = engine.read_side._reader("c")
    calls = []
    orig = ref_hybrid.hybrid_fused_topk_batch

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, kwargs, jax.device_get(out)))
        return out

    monkeypatch.setattr(ref_hybrid, "hybrid_fused_topk_batch", spy)
    params = [RefParams.from_json(dict(extra, term=t, mode=mode, limit=20))
              for t in terms]
    reader.search_batch(params, engine.read_side.ai)
    assert len(calls) == 1, name
    args, kwargs, (rv, ri, rc) = calls[0]
    assert kwargs["nf"] == nf and kwargs["dense"] == dense, kwargs
    assert kwargs["bm25_pallas"] or mode == "vector"
    kw = {k: v for k, v in kwargs.items()
          if k not in ("interpret", "bm25_pallas")}
    pv, pi, pc = port_hybrid.hybrid_fused_topk_batch(*to_torch(args), **kw)
    rv, ri, rc = np.asarray(rv), np.asarray(ri), np.asarray(rc)
    assert pv.shape == rv.shape and pc.shape == rc.shape
    np.testing.assert_array_equal(pc.numpy(), rc)
    matched = rv > 0
    assert matched.sum() > 0, name
    np.testing.assert_array_equal(pi.numpy()[matched], ri[matched])
    np.testing.assert_allclose(pv.numpy(), rv, rtol=1e-5, atol=1e-7)


# -- search_batch on both readers ----------------------------------------------


def _docs(n=80, seed=4):
    rng = np.random.default_rng(seed)
    vocab = ["cat", "dog", "mat", "sat", "bird", "tree", "sky", "fish",
             "moon", "rain"]
    return [{
        "id": str(i),
        "title": " ".join(rng.choice(vocab, size=int(rng.integers(2, 8)))),
        "price": int(rng.integers(0, 60)),
        "in_stock": bool(i % 3),
    } for i in range(n)]


def _compare_batch(pair, bodies, cid="c1"):
    ref = pair.ref.read_side._reader(cid)
    port = pair.port.read_side._reader(cid)
    want = ref.search_batch([RefParams.from_json(dict(b)) for b in bodies],
                            pair.ref.read_side.ai)
    got = port.search_batch([PortParams.from_json(dict(b)) for b in bodies],
                            pair.port.read_side.ai)
    assert len(got) == len(want) == len(bodies)
    for body, (pr, pc), (rr, rc) in zip(bodies, got, want):
        assert [d for d, _ in pr] == [d for d, _ in rr], body
        assert pc == rc, body
        np.testing.assert_allclose([s for _, s in pr], [s for _, s in rr],
                                   rtol=1e-5, err_msg=str(body))
    return got


WORDS = ["cat", "dog", "mat", "bird", "sky", "fish", "moon", "rain", "tree",
         "sat", "zzz", "ca", "do", "bi", "mo", "ra", "tr"]


def _rows(n, **extra):
    return [dict(extra, term=WORDS[i % len(WORDS)], limit=5 + i % 7)
            for i in range(n)]


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    p.create()
    p.write(_docs())
    p.commit()
    yield p
    p.close()


def _spy_paths(monkeypatch, reader):
    """Record which of the port reader's batch paths serve a call."""
    seen = []
    for name in ("_search_batch_hybrid_fused", "_search_hybrid_fused",
                 "search_fulltext_batch", "search_vector_batch"):
        orig = getattr(reader, name)
        monkeypatch.setattr(
            reader, name,
            lambda *a, _n=name, _o=orig, **k: seen.append(_n) or _o(*a, **k))
    return seen


@pytest.mark.parametrize("n", [1, 3, 17])
def test_search_batch_modes_match(pair, monkeypatch, n):
    seen = _spy_paths(monkeypatch, pair.port.read_side._reader("c1"))
    fused = "_search_batch_hybrid_fused" if n > 1 else "_search_hybrid_fused"
    for extra, path in (
            ({"mode": "fulltext"}, fused),
            ({"mode": "hybrid"}, fused),
            ({"mode": "hybrid", "fusion": "minmax"}, fused),
            ({"mode": "vector", "where": {"price": {"lt": 30}}}, fused),
            # a bool filter takes the per-mode path, and its few
            # candidates the selective gather
            ({"mode": "vector", "where": {"in_stock": False}},
             "search_vector_batch"),
            ({"mode": "hybrid", "where": {"in_stock": True}},
             "search_fulltext_batch")):
        seen.clear()
        _compare_batch(pair, _rows(n, **extra))
        # a lone query takes the single-query fused program
        assert (path if n > 1 else fused) in seen, (extra, seen)


def test_search_batch_phrase_rows_deletes_and_windows(pair):
    mixed = [{"term": "cat sat"}, {"term": "dog"}, {"term": "bird sky tree"},
             {"term": "moon", "limit": 3}, {"term": "fish rain"}]
    _compare_batch(pair, mixed)
    _compare_batch(pair, [dict(b, mode="hybrid") for b in mixed])
    pair.do(lambda e: e.write_side.delete_documents("c1", ["3", "7", "11"],
                                                    WRITE))
    pair.do(lambda e: e.flush())
    _compare_batch(pair, _rows(6, mode="hybrid"))
    _compare_batch(pair, _rows(4, mode="fulltext"))
    # a live freshness window: the per-mode batch paths serve it
    pair.write([{"id": "live1", "title": "cat dog moon", "price": 5},
                {"id": "live2", "title": "fish rain", "price": 50}])
    for extra in ({"mode": "fulltext"}, {"mode": "hybrid"},
                  {"mode": "vector"}, {"mode": "vector",
                                       "where": {"price": {"lt": 30}}}):
        _compare_batch(pair, _rows(5, **extra))


def test_search_batch_memory_chunks(pair, monkeypatch):
    """Batches split into memory chunks with the rows routed back: the
    fused program's dense chunk and the span scorer's slot budget."""
    from orama_core_tpu.engine.collection_read import CollectionReader as Ref
    from orama_core_tpu_torch.engine.collection_read import (
        CollectionReader as Port,
    )

    cap = pair.port.read_side._reader("c1").capacity
    for cls in (Ref, Port):
        monkeypatch.setattr(cls, "_BATCH_DENSE_SLOTS", cap * 4)
        monkeypatch.setattr(cls, "_BATCH_SLOT_BUDGET", 4 * 1024)
    _compare_batch(pair, _rows(10, mode="fulltext"))
    _compare_batch(pair, _rows(9, mode="hybrid"))
    pair.write([{"id": "live", "title": "cat cat dog", "price": 1}])
    _compare_batch(pair, _rows(12, mode="fulltext"))


@pytest.mark.parametrize("n", [3, 17])
def test_search_batch_vector_fast_path_matches(n, monkeypatch):
    from orama_core_tpu.models.ai_service import AIService as RefAI
    from orama_core_tpu_torch.models.ai_service import AIService as PortAI

    ref, port = _fast_readers()
    calls = []
    orig = port._vector_topk_fast_core
    monkeypatch.setattr(port, "_vector_topk_fast_core",
                        lambda *a, **k: calls.append(len(a[0])) or orig(*a, **k))
    terms = [f"query {i} about {WORDS[i % len(WORDS)]}" for i in range(n)]
    bodies = [{"term": t, "mode": "vector", "limit": 3 + i % 9}
              for i, t in enumerate(terms)]
    want = ref.search_batch([RefParams.from_json(b) for b in bodies], RefAI())
    got = port.search_batch([PortParams.from_json(b) for b in bodies],
                            PortAI())
    assert calls == [n], "the batch did not take the fused kNN at its size"
    for body, (pr, pc), (rr, rc) in zip(bodies, got, want):
        assert [d for d, _ in pr] == [d for d, _ in rr], body
        assert pc == rc, body
        np.testing.assert_allclose([s for _, s in pr], [s for _, s in rr],
                                   rtol=1e-5)


# -- the micro-batcher ---------------------------------------------------------


def test_microbatcher_coalesces_and_distributes():
    from orama_core_tpu_torch.server.batcher import MicroBatcher

    calls = []

    def run(key, payloads):
        calls.append((key, list(payloads)))
        return [p * 2 for p in payloads]

    b = MicroBatcher(run, max_batch=8, max_wait_ms=20)
    results = {}

    def worker(i):
        results[i] = b.submit(("k",), i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5)
    b.stop()
    assert not any(t.is_alive() for t in threads)
    assert results == {i: i * 2 for i in range(5)}
    assert sum(len(p) for _, p in calls) == 5
    assert len(calls) <= 3


def test_microbatcher_propagates_errors():
    from orama_core_tpu_torch.server.batcher import MicroBatcher

    def run(key, payloads):
        raise RuntimeError("boom")

    b = MicroBatcher(run, max_batch=4, max_wait_ms=1)
    with pytest.raises(RuntimeError):
        b.submit(("k",), 1)
    b.stop()


def test_batched_read_side_matches_unbatched(tmp_path):
    """query_batching=True: concurrent searches through the read side
    coalesce and give the hits and counts of unbatched searches."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig

    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp_path / "w")
    cfg.reader_side.data_dir = str(tmp_path / "r")
    cfg.writer_side.commit_interval_sec = 3600
    cfg.reader_side.commit_interval_sec = 3600
    cfg.ai.backend = "fake"
    cfg.gpu.query_batching = True
    cfg.gpu.batch_wait_ms = 20.0
    engine = build_orama(cfg, start_background=False, device="cpu")
    try:
        assert engine.read_side._batcher is not None
        engine.write_side.create_collection("master", "c", READ, WRITE)
        engine.flush()
        engine.write_side.write("c", _docs(60, seed=8), WRITE)
        engine.flush()
        engine.commit()
        reader = engine.read_side._reader("c")
        storage = engine.read_side.doc_storage["c"]
        bodies = ([{"term": w, "mode": m} for w in ("cat", "moon", "fish")
                   for m in ("fulltext", "vector", "hybrid")]
                  + [{"term": "dog", "where": {"price": {"lt": 30}}},
                     {"term": "cat sat"}])  # a phrase: not batched
        outs = {}

        def q(i):
            outs[i] = engine.read_side.search(
                "c", PortParams.from_json(dict(bodies[i])), READ)

        threads = [threading.Thread(target=q, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, body in enumerate(bodies):
            ranked, count, _ = reader.search(PortParams.from_json(dict(body)),
                                             engine.read_side.ai)
            assert [h.id for h in outs[i].hits] == [
                storage.get(d)["id"] for d, _ in ranked], body
            assert outs[i].count == count, body
            np.testing.assert_allclose([h.score for h in outs[i].hits],
                                       [s for _, s in ranked], rtol=1e-5)
    finally:
        engine.close()
    assert not engine.read_side._batcher._thread.is_alive()
