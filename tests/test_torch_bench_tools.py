"""The port's six BASELINE-config tools (``tools/engine_bench``,
``embed_bench``, ``int8_30m_bench``, ``pq_100m_bench``,
``sharded_int8_bench``, ``sharded_ivfpq_bench``) against the scripts of
``benchmarks/`` of the same names, on the CPU at tiny sizes.

- Each tool prints its script's JSON line: the same metric names and
  keys (the sharded tools add ``cards``, the int8 tool ``clock``).
- ``int8_30m``: the chunked scan and merge, through K5's plain version
  and through the int8 GEMM, equals one ``ops/knn.knn_topk_int8`` top-10
  over the same numpy codes (values and rows exact).
- ``pq_100m``: rows regenerated from their ids equal the build pass's
  rows and the stored codes are those rows' codes; on the script's own
  rows and queries (its row function carried verbatim), the port's
  train, build and search reach at least the script's recall@10 at the
  same tiny size.
- ``engine_bench``: the timed query pass returns the hits of a reference
  engine fed the same ``synth_docs`` (ids equal up to ties within rtol
  1e-5, scores within rtol 1e-5)."""

import contextlib
import dataclasses
import io
import json
import os
import runpy
import sys

import numpy as np
import torch

from orama_core_tpu_torch.tools import (
    embed_bench, engine_bench, int8_30m_bench, pq_100m_bench,
    sharded_int8_bench, sharded_ivfpq_bench,
)
from orama_core_tpu_torch.tools.timing import recall_at_k
from test_torch_bench import _same_hits, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _line(tool, argv, capsys):
    assert tool.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def _reference_line(script, argv):
    """The last stdout line of ``benchmarks/<script>`` run with ``argv``."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [script] + argv
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(ROOT, "benchmarks", script),
                           run_name="__main__")
    finally:
        sys.argv = saved
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_each_tool_prints_its_scripts_metrics(capsys):
    cpu = ["--device", "cpu"]
    row = _line(engine_bench, cpu + ["--docs", "120", "--queries", "2"],
                capsys)
    assert list(row) == [
        "index_docs_per_sec", "commit_sec", "bm25_qps",
        "bm25_boosted_filtered_qps", "vector_qps", "hybrid_rrf_qps",
        "hybrid_filtered_qps", "hybrid_faceted_qps",
        "hybrid_faceted_multidispatch_qps"]
    row = _line(embed_bench, cpu + ["--batch", "2", "--seq", "8",
                                    "--iters", "1"], capsys)
    assert list(row) == ["metric", "value", "unit", "vs_reference_rtx4080"]
    assert row["metric"] == "embeddings_per_sec_bge_small_seq8"
    for phase1 in ("pallas", "xla"):
        row = _line(int8_30m_bench, cpu + [
            "--docs", "20000", "--dim", "16", "--queries", "2",
            "--block", "10000", "--phase1", phase1], capsys)
        assert list(row) == ["metric", "value", "unit", "ms_per_batch",
                             "device_ms_per_batch", "device_ms_per_chunk",
                             "n_chunks", "clock"]
        assert row["metric"] == f"int8_exact_knn_qps_0Mx16_top10_{phase1}"
        assert (row["n_chunks"], row["clock"]) == (1, "host")
    row = _line(pq_100m_bench, cpu + PQ_TINY, capsys)
    assert list(row) == ["metric", "value", "unit", "recall_at_10",
                         "nprobe", "expand", "resident_gb"]
    assert row["metric"] == "ivf_pq_rerank_qps_0Mx32_top10"
    row = _line(sharded_int8_bench, cpu + ["--docs", "1000", "--dim", "16",
                                           "--queries", "4"], capsys)
    assert list(row) == ["metric", "value", "unit", "docs", "queries",
                         "note", "cards"]
    assert (row["metric"], row["cards"]) == (
        "sharded_int8_recall_at_10_1k_8dev", 0)
    assert row["value"] >= 0.9, row
    row = _line(sharded_ivfpq_bench, cpu + ["--docs", "10500", "--dim", "16",
                                            "--queries", "4"], capsys)
    assert list(row) == ["metric", "value", "unit", "docs", "queries",
                         "nprobe", "note", "cards"]
    assert (row["metric"], row["cards"]) == (
        "sharded_ivfpq_recall_at_10_10k_8dev", 0)
    assert row["value"] >= 0.9, row


def test_int8_chunked_scan_equals_the_one_shot_top10():
    from orama_core_tpu_torch.ops.knn import knn_topk_int8

    rng = np.random.default_rng(3)
    n, d, chunk, block = 10_000, 64, 4096, 2048
    codes = rng.integers(-127, 128, (3 * chunk, d)).astype(np.int8)
    scales = rng.uniform(0.5, 1.5, 3 * chunk).astype(np.float32) / 127
    q = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32))
    chunks = [(torch.from_numpy(codes[i:i + chunk]),
               torch.from_numpy(scales[i:i + chunk]))
              for i in range(0, 3 * chunk, chunk)]
    want_v, want_i = knn_topk_int8(torch.from_numpy(codes),
                                   torch.from_numpy(scales), q, k=10,
                                   block_rows=block, n_valid=n)
    assert int(want_i.max()) < n
    for phase1 in ("pallas", "xla"):
        v, i = int8_30m_bench.full_scan(chunks, q, n, phase1, block)
        np.testing.assert_array_equal(v.numpy(), want_v.numpy(), phase1)
        np.testing.assert_array_equal(i.numpy(), want_i.long().numpy(),
                                      phase1)


PQ_TINY = ["--docs", "32768", "--dim", "32", "--modes", "64", "--clusters",
           "64", "--pq-m", "8", "--queries", "8", "--nprobe", "4",
           "--chunk", "8192", "--group", "2", "--train-sample", "8192"]


def test_pq_rows_regenerate_from_their_ids():
    from orama_core_tpu_torch.ops import ivf, pq

    corpus = pq_100m_bench.Corpus.make(32768, 32, 64, 8, "cpu")
    cents, books = pq_100m_bench.train(corpus, 8192, 64, 8)
    index, _ = pq_100m_bench.build(corpus, cents, books, corpus.queries(),
                                   8192)
    ids = torch.randperm(32768, generator=torch.Generator().manual_seed(4))[
        :3000]
    ids = torch.cat([ids, torch.arange(80), torch.tensor([32767])])
    rows = corpus.rows(ids)
    for lo in range(0, 32768, 8192):
        sel = (ids >= lo) & (ids < lo + 8192)
        span = corpus.span(lo, lo + 8192)
        torch.testing.assert_close(rows[sel], span[ids[sel] - lo], rtol=0,
                                   atol=0)
    assign = ivf.assign_clusters(rows.to(torch.bfloat16), cents).long()
    np.testing.assert_array_equal(
        index.codes[ids].numpy(),
        pq.pq_encode(rows - cents[assign], books).numpy())
    # each planted row lies near its query's base row
    base = corpus.span(32768 - 8, 32768)
    cos = (rows[3000:3080] * base[torch.arange(80) // 10]).sum(-1)
    assert float(cos.min()) > 0.97, cos


def _reference_rows(n, d, n_modes, qb):
    """(rows f32[n, d], queries f32[qb, d]): the script's row function and
    queries (benchmarks/pq_100m_bench.py:111-138, :157-163), carried
    verbatim (they are closures of its ``main``)."""
    import jax
    import jax.numpy as jnp

    N, D, QB, NPLANT = n, d, qb, 10
    key = jax.random.PRNGKey(7)
    modes = jax.random.normal(jax.random.PRNGKey(1), (n_modes, D),
                              jnp.float32)
    modes = modes / jnp.linalg.norm(modes, axis=-1, keepdims=True)

    def _base_vec(i):  # un-normalized mixture row
        k = jax.random.fold_in(key, i)
        kw, kn = jax.random.split(k)
        which = jax.random.randint(kw, (), 0, n_modes)
        noise = jax.random.normal(kn, (D,), jnp.float32)
        return modes[which] + (0.25 / np.sqrt(D)) * noise

    def row_vecs(ids):  # int32[B] -> f32[B, D], unit-norm
        def one(i):
            reg = _base_vec(i)
            src = _base_vec(N - QB + i // NPLANT)
            src = src / jnp.linalg.norm(src)
            kp = jax.random.fold_in(jax.random.PRNGKey(13), i)
            pert = src + (0.12 / np.sqrt(D)) * jax.random.normal(
                kp, (D,), jnp.float32)
            return jnp.where(i < QB * NPLANT, pert, reg)

        v = jax.vmap(one)(ids)
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    rows = np.array(jax.jit(row_vecs)(jnp.arange(N, dtype=jnp.int32)))
    qk = jax.random.PRNGKey(11)
    queries = row_vecs(jnp.arange(N - QB, N, dtype=jnp.int32))
    queries = queries + (0.05 / np.sqrt(D)) * jax.random.normal(
        jax.random.fold_in(qk, 1), (QB, D), jnp.float32)
    queries = queries / jnp.linalg.norm(queries, axis=-1, keepdims=True)
    return rows, np.array(queries)


@dataclasses.dataclass
class _TableCorpus(pq_100m_bench.Corpus):
    """Rows looked up in a table: the reference's rows in the port's
    pipeline."""
    table: torch.Tensor = None

    def rows(self, ids):
        return self.table[ids.to(torch.int64)]


def test_pq_recall_holds_the_references_on_its_rows(capsys):
    """The port's train, build and search over the script's own rows and
    queries (so only the index differs, not the data) reach at least the
    script's recall@10 at the same size."""
    n, d, n_modes, qb = 32768, 32, 64, 8
    rows, queries = _reference_rows(n, d, n_modes, qb)
    corpus = _TableCorpus(n, d, qb, torch.zeros(1, d),
                          torch.from_numpy(rows))
    q = torch.from_numpy(queries)
    cents, books = pq_100m_bench.train(corpus, 8192, 64, 8)
    index, gt = pq_100m_bench.build(corpus, cents, books, q, 8192)
    _, ids = pq_100m_bench.search(corpus, index, cents, books, q, 4, 10, 2)
    recall = recall_at_k(ids.numpy(), gt.numpy())
    ref = _reference_line("pq_100m_bench.py", ["--cpu"] + PQ_TINY)
    assert ref["metric"] == "ivf_pq_rerank_qps_0Mx32_top10"
    assert recall >= ref["recall_at_10"], (recall, ref)


def test_engine_bench_hits_equal_a_reference_engines(tmp_path):
    from orama_core_tpu import build_orama as ref_build
    from orama_core_tpu.config import OramaxConfig as RefConfig
    from orama_core_tpu.types import SearchParams as RefParams

    docs = engine_bench.synth_docs(300)
    queries = engine_bench.synth_queries(6)
    report = {}
    port = engine_bench.build_engine(docs, str(tmp_path / "port"), "cpu",
                                     report)
    cfg = RefConfig()
    cfg.writer_side.data_dir = str(tmp_path / "ref" / "w")
    cfg.reader_side.data_dir = str(tmp_path / "ref" / "r")
    ref = ref_build(cfg, start_background=False)
    try:
        ref.write_side.create_collection("master", "bench", "rk", "wk")
        ref.write_side.write("bench", docs, "wk")
        ref.commit()
        ref.read_side._reader("bench").cfg._test_force_fast_path = True
        got = engine_bench.query_families(port, queries, report)
        assert set(got) == {label for label, _, _ in engine_bench.FAMILIES} | {
            "hybrid_faceted_multidispatch_qps"}
        n_hits = 0
        for label, mode, extra in engine_bench.FAMILIES:
            for q, hits in zip(queries, got[label]):
                r = ref.read_side.search("bench", RefParams.from_json(
                    {"term": q, "mode": mode, **extra}), "rk",
                    with_documents=False)
                _same_hits(hits, [(h.id, h.score) for h in r.hits],
                           (label, q))
                n_hits += len(hits)
        assert n_hits > 150
        assert got["hybrid_faceted_multidispatch_qps"] == got[
            "hybrid_faceted_qps"]
    finally:
        port.close()
        ref.close()
