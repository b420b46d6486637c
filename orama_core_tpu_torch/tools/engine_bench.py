"""Engine-level benchmarks: index build docs/s, commit seconds, BM25,
vector and hybrid queries/s.

    python -m orama_core_tpu_torch.tools.engine_bench [--docs 100000]
        [--queries 200] [--device cpu]

Port of ``benchmarks/engine_bench.py`` (BASELINE.md configs 1 and 4:
100k-passage full text with boosts; hybrid BM25 + vector with filters
and RRF). ``build_orama`` with its background loops ingests
``synth_docs`` (the script's seeded generator, ``random.Random``) in
writes of 500, waits until the read side holds every document and every
embedding, commits, then runs each query family: one untimed pass over
the queries, then one timed pass (queries/s over its wall time).

Prints one JSON object of the script's metrics on stdout: the ingest
and commit numbers, then ``bm25_qps``, ``bm25_boosted_filtered_qps``,
``vector_qps``, ``hybrid_rrf_qps``, ``hybrid_filtered_qps``,
``hybrid_faceted_qps`` and ``hybrid_faceted_multidispatch_qps`` (the same
faceted queries with the fused program refused, so each facet is its own
reduction after the scores). The values are unrounded and the card's
name and power limit go to stderr.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import tempfile
import time
from typing import Dict, List, Tuple

from .timing import card_line, log

WORDS = (
    "search engine vector database index query token embed rank score "
    "document passage neural transformer attention matrix kernel compile "
    "shard mesh tensor batch cache memory bandwidth latency throughput "
    "recall precision filter facet hybrid fusion quantize cluster partition "
    "solar wind energy turbine panel recipe flour sugar bake cake quantum "
    "computing physics electron photon laser crystal polymer enzyme protein"
).split()

FACETS = {
    "price": {"ranges": [{"to": 25}, {"from": 25, "to": 50}, {"from": 50}]},
    "in_stock": {"true": True, "false": True},
}
# (label, mode, extra search params) in the script's order
FAMILIES = (
    ("bm25_qps", "fulltext", {}),
    ("bm25_boosted_filtered_qps", "fulltext",
     {"boost": {"title": 2.0}, "where": {"price": {"lte": 50}}}),
    ("vector_qps", "vector", {}),
    ("hybrid_rrf_qps", "hybrid", {}),
    ("hybrid_filtered_qps", "hybrid", {"where": {"in_stock": True}}),
    ("hybrid_faceted_qps", "hybrid", {"facets": FACETS}),
)


def synth_docs(n: int, seed: int = 0) -> List[dict]:
    rng = random.Random(seed)
    docs = []
    for i in range(n):
        body = " ".join(rng.choices(WORDS, k=rng.randint(8, 40)))
        docs.append({
            "id": str(i),
            "title": " ".join(rng.choices(WORDS, k=5)),
            "body": body,
            "price": rng.uniform(0, 100),
            "in_stock": rng.random() > 0.3,
        })
    return docs


def synth_queries(n: int, seed: int = 1) -> List[str]:
    rng = random.Random(seed)
    return [" ".join(rng.choices(WORDS, k=rng.randint(1, 3)))
            for _ in range(n)]


def build_engine(docs: List[dict], data_dir: str, device: str,
                 report: Dict[str, float]):
    """``build_orama`` with its background loops, ``docs`` ingested and
    committed into collection ``bench``; adds ``index_docs_per_sec`` and
    ``commit_sec`` to ``report``."""
    from .. import build_orama
    from ..config import OramaxConfig

    cfg = OramaxConfig()
    cfg.writer_side.data_dir = data_dir + "/w"
    cfg.reader_side.data_dir = data_dir + "/r"
    cfg.writer_side.commit_interval_sec = 1e9
    cfg.reader_side.commit_interval_sec = 1e9
    engine = build_orama(cfg, start_background=True, device=device)
    engine.write_side.create_collection("master", "bench", "rk", "wk")
    t0 = time.perf_counter()
    bs = 500
    for i in range(0, len(docs), bs):
        engine.write_side.write("bench", docs[i:i + bs], "wk")
        if (i // bs) % 40 == 0 and i:
            log(f"  {i}/{len(docs)} ({i / (time.perf_counter() - t0):.0f} "
                "docs/s)")

    def caught_up():
        try:
            n = engine.read_side.count_documents("bench")
        except KeyError:
            return False
        return engine.write_side.pending_embeddings() == 0 and n >= len(docs)

    while not caught_up():
        time.sleep(0.05)
    engine.flush()  # embedding ops still in the channel
    index_dt = time.perf_counter() - t0
    report["index_docs_per_sec"] = len(docs) / index_dt
    log(f"index build: {index_dt:.1f} s -> "
        f"{report['index_docs_per_sec']:.1f} docs/s")
    t0 = time.perf_counter()
    engine.commit()
    report["commit_sec"] = time.perf_counter() - t0
    log(f"commit: {report['commit_sec']:.2f} s")
    return engine


def run(engine, queries: List[str], mode: str, **extra
        ) -> Tuple[float, List[List[Tuple[str, float]]]]:
    """(queries/s of a timed pass after an untimed one, each query's hits
    as (id, score)). The untimed pass runs every query once, so every plan
    size the set reaches is warm before the clock starts."""
    from ..types import SearchParams

    params = [SearchParams.from_json({"term": q, "mode": mode, **extra})
              for q in queries]
    for p in params:
        engine.read_side.search("bench", p, "rk", with_documents=False)
    hits = []
    t0 = time.perf_counter()
    for p in params:
        r = engine.read_side.search("bench", p, "rk", with_documents=False)
        hits.append([(h.id, h.score) for h in r.hits])
    return len(params) / (time.perf_counter() - t0), hits


def query_families(engine, queries: List[str], report: Dict[str, float]
                   ) -> Dict[str, List[List[Tuple[str, float]]]]:
    """Every family's queries/s into ``report``; the hits by label."""
    out = {}
    for label, mode, extra in FAMILIES:
        report[label], out[label] = run(engine, queries, mode, **extra)
        log(f"{label}: {report[label]:.1f} QPS (avg hits "
            f"{sum(map(len, out[label])) / len(queries):.1f})")
    reader = engine.read_side._reader("bench")
    fused = reader._hybrid_fused_eligible
    reader._hybrid_fused_eligible = lambda p: None
    try:
        label = "hybrid_faceted_multidispatch_qps"
        report[label], out[label] = run(engine, queries, "hybrid",
                                        facets=FACETS)
        log(f"{label}: {report[label]:.1f} QPS")
    finally:
        reader._hybrid_fused_eligible = fused
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="orama_core_tpu_torch.tools.engine_bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import require_device

    log(f"device: {card_line(require_device(args.device))}")
    report: Dict[str, float] = {}
    docs = synth_docs(args.docs)
    log(f"indexing {len(docs)} docs ...")
    with tempfile.TemporaryDirectory() as d:
        engine = build_engine(docs, d, args.device, report)
        try:
            query_families(engine, synth_queries(args.queries), report)
        finally:
            engine.close()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
