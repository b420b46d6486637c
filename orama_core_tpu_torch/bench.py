"""Benchmark: exact vector search (brute-force cosine top-10) on one card,
then the engine's serving metrics at 1M documents.

    python -m orama_core_tpu_torch.bench [--device cuda]

Port of the repo's ``bench.py``. BASELINE.md config 2: "exact brute-force
cosine top-10 over 1M x 768-d embeddings (single chip)". The corpus is
``utils/benchgen.hashed_unit_corpus(N_PAD, 768, salt=1)`` in bf16, made
on the device; the search is the fused kNN ``ops/knn.knn_topk`` (K2, then
K3 on the sub-blocks it keeps). The baseline is a numpy f32 matmul plus
argpartition on this host's CPU over a corpus of the same shape (the
stand-in for the reference engine's per-query scan; BASELINE.md:
"measured, not copied").

Stdout carries five JSON lines and nothing else, in this order:

- ``{"metric": "exact_vector_search_qps_1Mx768_top10", "value", "unit":
  "qps", "vs_baseline"}``: queries/s of the larger of the 64- and
  256-query batches, over ITERS back-to-back calls (host clock, closed
  by a device synchronise, after a warm-up call); ``vs_baseline`` is that
  over the CPU baseline's queries/s;
- ``bm25_seq_p50_1m`` and ``hybrid_rrf_seq_p50_1m`` (ms): the p50 of 32
  sequential ``CollectionReader.search`` calls, after one untimed pass
  over the same queries, on ``tools/synthetic``'s 1M collection;
- ``bm25_batched_qps_1m`` and ``hybrid_batched_qps_1m`` (queries/s): 64
  queries as two ``search_batch`` calls of 32, after one untimed pass.

Details (the int8 kNN's rate through K5, recall@10 of the bf16 path
against an f32 exact top-k on 8 queries, the baseline, the card's name
and power limit) go to stderr. A failing phase raises: the process exits
non-zero and prints no result line.

``--docs``, ``--dim``, ``--iters`` and ``--engine-docs`` exist so that
tests can run the module small; their defaults are the benchmark's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .tools.timing import card_line, log, recall_at_k, timed_qps

N, D, K, QB, QB_BIG, ITERS, BN = 1_000_000, 768, 10, 64, 256, 50, 2048
ENGINE_DOCS, ENGINE_TERMS, ENGINE_POSTINGS, ENGINE_DIM = (
    1_000_000, 50_000, 20, 384)
RECALL_QUERIES = 8
EXACT_CHUNK = 1 << 18  # rows of the f32 exact top-k upcast at a time


def exact_topk_f32(vecs: torch.Tensor, queries: torch.Tensor, k: int,
                   n_valid: int) -> torch.Tensor:
    """int64[Q, k]: the f32 exact top-k of f32 ``queries`` over the first
    ``n_valid`` rows of ``vecs`` (upcast to f32 EXACT_CHUNK rows at a
    time)."""
    q = queries.to(torch.float32)
    sims = torch.empty(q.shape[0], n_valid, dtype=torch.float32,
                       device=vecs.device)
    for lo in range(0, n_valid, EXACT_CHUNK):
        hi = min(lo + EXACT_CHUNK, n_valid)
        sims[:, lo:hi] = q @ vecs[lo:hi].to(torch.float32).T
    return torch.topk(sims, k, dim=1).indices


def cpu_baseline_qps(n: int, d: int, queries: np.ndarray,
                     vecs: torch.Tensor) -> float:
    """Queries/s of numpy's f32 scan (matmul + argpartition) of the
    ``queries`` over an [n, d] gaussian corpus on the host, the corpus
    made anew (the same shape and dtype, not the same values); where the
    host cannot hold it, a slice of the card's corpus, scaled to n rows."""
    try:
        v_np = np.random.default_rng(0).standard_normal((n, d),
                                                        dtype=np.float32)
        reps, scale = 2, 1.0
        log_as = f"direct, {n}x{d}"
    except MemoryError:
        rows = 50_000
        v_np = vecs[:rows].to(torch.float32).cpu().numpy()
        reps, scale = 3, n / rows
        log_as = f"scaled from {rows}"
    t0 = time.perf_counter()
    for _ in range(reps):
        sims = queries @ v_np.T
        np.argpartition(-sims, K, axis=1)[:, :K]
    qps = len(queries) / ((time.perf_counter() - t0) / reps * scale)
    log(f"cpu numpy baseline ({log_as}): {qps:.2f} QPS")
    return qps


def exact_vector_metrics(n: int, d: int, iters: int,
                         device: torch.device) -> Dict[str, float]:
    """The headline's measurements: queries/s at 64 and 256 queries
    (K2 + K3), the int8 kNN's (K5), recall@10 and the CPU baseline."""
    from .ops.knn import knn_topk, knn_topk_int8
    from .ops.quant import quantize_int8
    from .utils.benchgen import hashed_unit_corpus

    n_pad = -(-n // BN) * BN
    t0 = time.perf_counter()
    vecs = hashed_unit_corpus(n_pad, d, 1, device=device)  # rows >= n pad
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"corpus {n_pad}x{d} bf16 made in {time.perf_counter() - t0:.1f} s")
    q_np = np.random.default_rng(7).standard_normal((QB, d)).astype(
        np.float32)
    q_np /= np.linalg.norm(q_np, axis=-1, keepdims=True)
    queries = torch.from_numpy(q_np).to(device)
    q_bf16 = queries.to(torch.bfloat16)
    q_big = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (QB_BIG, d))).to(device=device, dtype=torch.bfloat16)

    def search(q):
        return knn_topk(vecs, q, k=K, block_rows=BN, n_valid=n)

    bf16_idx = search(q_bf16)[1].cpu().numpy()
    out: Dict[str, float] = {}
    out["qps_64"], out["ms_64"] = timed_qps(lambda: search(q_bf16), QB,
                                            iters, device)
    log(f"fused kNN: {iters} x {QB} queries -> {out['qps_64']:.1f} QPS "
        f"({out['ms_64']:.3f} ms per {QB}-query batch)")
    out["qps_256"], out["ms_256"] = timed_qps(lambda: search(q_big), QB_BIG,
                                              iters, device)
    log(f"fused kNN, batch {QB_BIG}: {out['qps_256']:.1f} QPS "
        f"({out['ms_256']:.3f} ms per batch)")

    codes, scales = quantize_int8(vecs.to(torch.float32))
    out["int8_qps"], out["int8_ms"] = timed_qps(
        lambda: knn_topk_int8(codes, scales, queries, k=K, block_rows=BN,
                              n_valid=n), QB, iters, device)
    log(f"int8 kNN: {out['int8_qps']:.1f} QPS ({out['int8_ms']:.3f} ms per "
        f"batch)")
    del codes, scales

    gt = exact_topk_f32(vecs, queries[:RECALL_QUERIES], K, n).cpu().numpy()
    out["recall_at_10"] = recall_at_k(bf16_idx[:RECALL_QUERIES], gt)
    log(f"recall@{K} (bf16 vs f32 exact): {out['recall_at_10']:.4f}")
    out["cpu_qps"] = cpu_baseline_qps(n, d, q_np[:RECALL_QUERIES], vecs)
    return out


def draw_terms(rng: np.random.Generator, n: int,
               n_terms: int = ENGINE_TERMS) -> List[str]:
    """``n`` one-word query terms drawn as the reference draws them:
    ``term%06d`` of (Pareto(1.2) x 50) mod n_terms, a Zipf-like head
    bias."""
    ids = [int((rng.pareto(1.2, 1) * 50).astype(int)[0]) % n_terms
           for _ in range(n)]
    return [f"term{t:06d}" for t in ids]


# (metric, unit, mode, queries) in the reference's order
ENGINE_METRICS = (
    ("bm25_seq_p50_1m", "ms", "fulltext", 32),
    ("hybrid_rrf_seq_p50_1m", "ms", "hybrid", 32),
    ("bm25_batched_qps_1m", "qps", "fulltext", 64),
    ("hybrid_batched_qps_1m", "qps", "hybrid", 64),
)
BATCH = 32


def engine_serving_metrics(reader, ai) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) of the four engine metrics, in order: the p50
    of 32 sequential queries (fulltext, then hybrid RRF) and queries/s of
    64 queries in ``search_batch`` calls of 32 (fulltext, then hybrid
    RRF), each after an untimed pass over its queries; the queries come
    from ``draw_terms`` on one ``default_rng(42)``, in that order."""
    from .types import SearchParams

    rng = np.random.default_rng(42)
    out = []
    for metric, unit, mode, n in ENGINE_METRICS:
        params = [SearchParams.from_json({"term": t, "mode": mode})
                  for t in draw_terms(rng, n)]
        if unit == "ms":
            for p in params:
                reader.search(p, ai)
            lat = []
            for p in params:
                t0 = time.perf_counter()
                reader.search(p, ai)
                lat.append(time.perf_counter() - t0)
            lat.sort()
            value = lat[len(lat) // 2] * 1e3
        else:
            batches = [params[i:i + BATCH] for i in range(0, n, BATCH)]
            for b in batches:
                reader.search_batch(b, ai)
            t0 = time.perf_counter()
            done = sum(len(reader.search_batch(b, ai)) for b in batches)
            value = done / (time.perf_counter() - t0)
        log(f"{metric}: {value:.3f} {unit}")
        out.append((metric, value, unit))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="orama_core_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=N)
    ap.add_argument("--dim", type=int, default=D)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--engine-docs", type=int, default=ENGINE_DOCS)
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Tuple[List[dict], Dict[str, float]]:
    """(the five result lines, the headline's details)."""
    from . import configure_torch, require_device
    from .models.ai_service import AIService
    from .tools.synthetic import synthetic_reader

    device = require_device(args.device)
    configure_torch()
    log(f"device: {card_line(device)}")
    m = exact_vector_metrics(args.docs, args.dim, args.iters, device)
    best = max(m["qps_64"], m["qps_256"])
    lines = [{"metric": "exact_vector_search_qps_1Mx768_top10",
              "value": best, "unit": "qps",
              "vs_baseline": best / max(m["cpu_qps"], 1e-9)}]
    t0 = time.perf_counter()
    reader = synthetic_reader(args.engine_docs, ENGINE_TERMS, ENGINE_POSTINGS,
                              ENGINE_DIM, device=str(device))
    log(f"engine collection ({args.engine_docs} docs) built in "
        f"{time.perf_counter() - t0:.1f} s")
    ai = AIService(device=str(device))
    lines += [{"metric": metric, "value": value, "unit": unit}
              for metric, value, unit in engine_serving_metrics(reader, ai)]
    return lines, m


def main(argv=None) -> int:
    lines, _ = run(parse_args(argv))
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
