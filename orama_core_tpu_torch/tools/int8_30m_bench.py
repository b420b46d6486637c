"""Exact int8 kNN at 30M vectors on one card (toward BASELINE config 5's
compressed-at-scale story; the sharded form is
``parallel/sharded_search.sharded_int8_topk``).

    python -m orama_core_tpu_torch.tools.int8_30m_bench [--docs 30000000]
        [--dim 384] [--queries 64] [--block 4096] [--phase1 pallas|xla]
        [--device cpu]

Port of ``benchmarks/int8_30m_bench.py``: 30M x 384 int8 codes are 11.5
GB. The corpus is N_CHUNKS arrays of CHUNK rows (a BLOCK multiple near
1M rows; the last chunk is partial and masked through ``n_valid``).
``score_chunk`` takes one chunk's top-10 and merges it into the running
best; ``full_scan`` runs it over every chunk; the timed loop is 20 full
scans of 64 queries (host clock, closed by a synchronise), and
``chunk_time_ms`` times one chunk's call alone with CUDA events (the
script's device-only figure: ms a chunk x N_CHUNKS).

``--phase1`` picks the chunk's phase 1, keeping the script's names (and
so its metric names): ``pallas`` is the port's counterpart of the Pallas
kernel, K5 (``ops/knn.knn_topk_int8``: sub-block maxima, then the exact
rescore of the kept sub-blocks); ``xla`` is the port's int8 GEMM path
(``ops/quant.int8_topk_sims``: ``torch._int_mm`` over the whole chunk,
then a top-10).

The codes are a clipped gaussian (``clip(40 v, -127, 127)``, v standard
normal in bf16) with constant scales 1/127, as the script's, drawn from
an explicit ``torch.Generator`` per chunk (seed = the chunk's index), so
the values differ from its ``jax.random`` ones; the queries are unit
gaussians from a generator seeded 9. An exact scan's rate does not
depend on the values.

Prints one JSON line, ``{"metric":
"int8_exact_knn_qps_<N/1M>Mx<D>_top10_<phase1>", "value", "unit": "qps",
"ms_per_batch", "device_ms_per_batch", "device_ms_per_chunk",
"n_chunks", "clock"}`` (unrounded; ``clock`` is "cuda events" on the
card and "host" on the CPU, whose times are no device numbers); the
card's name and power limit go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple

import torch

from .timing import card_line, clock, log, time_ms, timed_qps

K, ITERS, CHUNK_REPS = 10, 20, 30


def chunk_rows(n: int, block: int) -> Tuple[int, int]:
    """(CHUNK, N_CHUNKS): a block multiple near 1M rows, the last chunk
    partial."""
    n_pad = -(-n // block) * block
    chunk = block * max(1, min(1_000_000 // block, n_pad // block))
    return chunk, -(-n_pad // chunk)


def gen_chunk(ci: int, rows: int, d: int, device) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Chunk ``ci``'s (codes int8[rows, d], scales f32[rows])."""
    g = torch.Generator(device=device).manual_seed(ci)
    v = torch.randn(rows, d, generator=g, device=device, dtype=torch.bfloat16)
    codes = torch.clamp(v.to(torch.float32) * 40.0, -127, 127).to(torch.int8)
    return codes, torch.full((rows,), 1.0 / 127.0, device=device)


def make_queries(qn: int, d: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(9)
    q = torch.randn(qn, d, generator=g)
    return (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).to(device)


def score_chunk(codes: torch.Tensor, scales: torch.Tensor,
                queries: torch.Tensor, best: Tuple[torch.Tensor, torch.Tensor],
                n_valid: int, base: int, phase1: str, block: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``best`` (values f32[Q, K], global rows int64[Q, K]) merged with the
    top-10 of the chunk's first ``n_valid`` rows (global row = ``base`` +
    local row)."""
    from ..ops.knn import knn_topk_int8
    from ..ops.quant import int8_topk_sims
    from ..ops.topk import topk_stable

    if phase1 == "pallas":
        v, i = knn_topk_int8(codes, scales, queries, k=K, block_rows=block,
                             n_valid=n_valid)
    else:
        valid = (torch.arange(codes.shape[0], device=codes.device)
                 < n_valid).to(torch.float32)
        v, i = int8_topk_sims(codes, scales, valid, queries, K)
    vals = torch.cat([best[0], v], dim=1)
    rows = torch.cat([best[1], i.long() + base], dim=1)
    mv, mi = topk_stable(vals, K)
    return mv, torch.gather(rows, 1, mi)


def full_scan(chunks: List[Tuple[torch.Tensor, torch.Tensor]],
              queries: torch.Tensor, n: int, phase1: str, block: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-10 (values, global rows) of the whole corpus: one
    ``score_chunk`` per chunk."""
    qn = queries.shape[0]
    best = (torch.full((qn, K), float("-inf"), device=queries.device),
            torch.zeros(qn, K, dtype=torch.long, device=queries.device))
    chunk = chunks[0][0].shape[0]
    for ci, (c, s) in enumerate(chunks):
        n_valid = min(chunk, max(1, n - ci * chunk))
        best = score_chunk(c, s, queries, best, n_valid, ci * chunk, phase1,
                           block)
    return best


def chunk_time_ms(chunk: Tuple[torch.Tensor, torch.Tensor],
                  queries: torch.Tensor, phase1: str, block: int) -> float:
    """ms of one full chunk's ``score_chunk``: device time by CUDA events
    on the card (``tools/timing.time_ms``), host time on the CPU."""

    c, s = chunk
    qn = queries.shape[0]
    best = (torch.full((qn, K), float("-inf"), device=queries.device),
            torch.zeros(qn, K, dtype=torch.long, device=queries.device))
    return time_ms(lambda: score_chunk(c, s, queries, best, c.shape[0], 0,
                                       phase1, block), CHUNK_REPS,
                   queries.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="orama_core_tpu_torch.tools.int8_30m_bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=30_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--phase1", choices=("pallas", "xla"), default="pallas",
                    help="pallas: K5 (ops/knn.knn_topk_int8); xla: the int8 "
                         "GEMM (ops/quant.int8_topk_sims)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import configure_torch, require_device

    dev = require_device(args.device)
    configure_torch()
    n, d, qn = args.docs, args.dim, args.queries
    chunk, n_chunks = chunk_rows(n, args.block)
    log(f"device {card_line(dev)}; int8 corpus {n_chunks * chunk}x{d} "
        f"({n_chunks * chunk * d / 1e9:.1f} GB + scales)")
    t0 = time.perf_counter()
    chunks = [gen_chunk(ci, chunk, d, dev) for ci in range(n_chunks)]
    queries = make_queries(qn, d, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"corpus built ({n_chunks} chunk arrays) in "
        f"{time.perf_counter() - t0:.1f} s")

    def scan():
        return full_scan(chunks, queries, n, args.phase1, args.block)


    qps, ms_batch = timed_qps(scan, qn, ITERS, dev)
    log(f"{ITERS} x {qn} queries: {qps:.1f} QPS ({ms_batch:.3f} ms a batch)")
    ms_chunk = chunk_time_ms(chunks[0], queries, args.phase1, args.block)
    dev_batch = ms_chunk * n_chunks
    log(f"device-only: {ms_chunk:.3f} ms/chunk x {n_chunks} chunks = "
        f"{dev_batch:.2f} ms/batch")
    print(json.dumps({
        "metric": f"int8_exact_knn_qps_{n // 1_000_000}Mx{d}_top10_"
                  f"{args.phase1}",
        "value": qps,
        "unit": "qps",
        "ms_per_batch": ms_batch,
        "device_ms_per_batch": dev_batch,
        "device_ms_per_chunk": ms_chunk,
        "n_chunks": n_chunks,
        "clock": clock(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
