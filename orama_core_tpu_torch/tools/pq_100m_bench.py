"""BASELINE config 5 at 100M vectors on one card: IVF + residual PQ ADC +
exact rerank, recall@10 against the exact top-10.

    python -m orama_core_tpu_torch.tools.pq_100m_bench [--docs 100000000]
        [--dim 384] [--modes 4000] [--clusters 4096] [--pq-m 48]
        [--queries 64] [--nprobe 8] [--expand 10] [--chunk 1000000]
        [--group 16] [--train-sample 262144] [--device cpu]

Port of ``benchmarks/pq_100m_bench.py``, keeping its design:

- Each corpus row is a pure function of its row id (``Corpus.rows``): a
  mixture mode plus gaussian-like noise, L2-normalised, so the exact
  rerank regenerates its candidates' rows from their ids and only the PQ
  codes and the IVF lists stay resident. The first QB x 10 rows are
  planted neighbours of the queries: perturbations (noise 0.12 / sqrt(D))
  of the QB query-base rows (the last QB rows); the queries are those
  base rows with noise 0.05 / sqrt(D). Each query so has an unambiguous
  top-10 (cos ~0.99 against the ~0.94 same-mode background).
- IVF centroids and residual PQ codebooks (FAISS IVF-PQ: codes quantize
  ``v - cents[cluster(v)]``) are trained on the first ``--train-sample``
  rows (``ops/ivf.kmeans``, ``ops/pq.pq_train``, 8 iterations each).
- The build pass makes the rows a chunk at a time and drops them: each
  chunk's assignments (bf16 operands, f32 products), codes, exact
  top-10 against the queries (merged into the ground truth) and
  chunk-local IVF lists ([clusters, cap] local row ids, cap set from
  chunk 0's largest list x 1.5; an overflow in a later chunk raises).
- A search probes the same ``--nprobe`` clusters in every chunk, scores
  the probed lists' codes by ADC (the query's table of subspace dots,
  plus the query-centroid dot of the probed slot), keeps the best
  ``10 x --expand`` candidates over ``--group`` chunks at a time, then
  reranks those rows exactly after regenerating them.

The row function is counter-based, as ``utils/benchgen`` is: an integer
hash of (seed, row id, column) gives the noise (a sum of four uniforms,
scaled to unit variance) and the mode index; it has the script's
mixture-of-modes-plus-noise form, not its ``jax.random`` values. The
modes, the queries' noise and the k-means draws come from seeded
``torch.Generator``s. The script kept its codes as grouped chunk arrays
to spare a relay multi-GB allocations; here the codes are one [N, M]
uint8 tensor and the lists one [chunks, clusters, cap] tensor, and
``--group`` is the number of chunks one search step scores.

The timed loop is 20 searches of the 64 queries (host clock, closed by a
synchronise). Prints one JSON line, ``{"metric":
"ivf_pq_rerank_qps_<N/1M>Mx<D>_top10", "value", "unit": "qps",
"recall_at_10", "nprobe", "expand", "resident_gb"}`` (unrounded); the
card's name and power limit go to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Tuple

import torch

from ..utils.benchgen import _MASK, _mix
from .timing import card_line, log, recall_at_k, timed_qps

K, ITERS, NPLANT = 10, 20, 10
# hash salts of the row function
SALT_NOISE, SALT_PLANT, SALT_MODE = 0x7F4A7C15, 0x1B873593, 0x5BD1E995
ROW_BLOCK = 1 << 16  # rows made at a time (int64 temporaries: 8 B x d each)


def hash_normal(ids: torch.Tensor, d: int, salt: int) -> torch.Tensor:
    """f32[len(ids), d]: unit-variance noise, a pure function of (salt,
    row id, column): four hashed uniforms summed (Irwin-Hall(4)), centred
    and scaled."""
    row = _mix((ids * 2654435761 + salt) & _MASK)
    col = (torch.arange(d, dtype=torch.int64, device=ids.device)
           * 2246822519) & _MASK
    key = row[:, None] ^ col[None, :]
    v = torch.zeros(len(ids), d, dtype=torch.float32, device=ids.device)
    for s in (1, 2, 3, 4):
        x = _mix((key + s * 0x27D4EB2F) & _MASK)
        v = v + x.to(torch.float32) * (1.0 / 4294967296.0)
    return (v - 2.0) * math.sqrt(3.0)


@dataclasses.dataclass
class Corpus:
    """Rows [0, n) of dimension d as pure functions of their ids, with
    ``qb`` queries' planted neighbours; ``modes`` f32[n_modes, d] unit
    rows on the device."""
    n: int
    d: int
    qb: int
    modes: torch.Tensor

    @staticmethod
    def make(n: int, d: int, n_modes: int, qb: int, device) -> "Corpus":
        m = torch.randn(n_modes, d, generator=torch.Generator().manual_seed(1))
        m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
        return Corpus(n, d, qb, m.to(device))

    def _base(self, ids: torch.Tensor) -> torch.Tensor:
        which = _mix((ids * 3266489917 + SALT_MODE) & _MASK) % len(self.modes)
        return self.modes[which] + (0.25 / math.sqrt(self.d)) * hash_normal(
            ids, self.d, SALT_NOISE)

    def _rows(self, ids: torch.Tensor) -> torch.Tensor:
        v = self._base(ids)
        planted = ids < self.qb * NPLANT
        if bool(planted.any()):
            pid = ids[planted]
            src = self._base(self.n - self.qb + pid // NPLANT)
            src = src / torch.linalg.vector_norm(src, dim=-1, keepdim=True)
            v[planted] = src + (0.12 / math.sqrt(self.d)) * hash_normal(
                pid, self.d, SALT_PLANT)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """f32[len(ids), d] unit rows of the int64 ``ids``."""
        ids = ids.to(device=self.modes.device, dtype=torch.int64)
        out = torch.empty(len(ids), self.d, dtype=torch.float32,
                          device=self.modes.device)
        for lo in range(0, len(ids), ROW_BLOCK):
            out[lo:lo + ROW_BLOCK] = self._rows(ids[lo:lo + ROW_BLOCK])
        return out

    def span(self, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi), as the build pass makes them."""
        return self.rows(torch.arange(lo, hi, device=self.modes.device))

    def queries(self) -> torch.Tensor:
        """The qb queries: the base rows (the last qb rows) with noise
        0.05 / sqrt(d) from a generator seeded 11, L2-normalised."""
        q = self.span(self.n - self.qb, self.n)
        noise = torch.randn(self.qb, self.d,
                            generator=torch.Generator().manual_seed(11))
        q = q + (0.05 / math.sqrt(self.d)) * noise.to(q.device)
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def chunking(n: int, chunk: int, group: int) -> Tuple[int, int, int]:
    """(CHUNK, N_CHUNKS, GROUP): the script's rule, a chunk halved until it
    divides n, a group shrunk until it divides the chunks."""
    chunk = min(chunk, n)
    while n % chunk:
        chunk //= 2
    n_chunks = n // chunk
    group = min(group, n_chunks)
    while n_chunks % group:
        group -= 1
    return chunk, n_chunks, group


def train(corpus: Corpus, n_sample: int, n_clusters: int, m: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(IVF centroids f32[C, d], residual PQ codebooks f32[m, 256, d/m])
    trained on rows [0, n_sample)."""
    from ..ops import ivf, pq

    sample = corpus.span(0, n_sample)
    cents = ivf.kmeans(sample, torch.Generator().manual_seed(2), n_clusters,
                       iters=8)
    resid = sample - cents[ivf.assign_clusters(sample, cents).long()]
    books = pq.pq_train(resid, torch.Generator().manual_seed(3), m=m, iters=8)
    return cents, books


@dataclasses.dataclass
class Index:
    codes: torch.Tensor   # uint8[N, M], row order
    lists: torch.Tensor   # int32[N_CHUNKS, C, cap]: chunk-local row ids
    lens: torch.Tensor    # int32[N_CHUNKS, C]
    worst: int            # largest chunk-local list seen
    chunk: int

    def resident_gb(self) -> float:
        n_chunks, n_clusters, cap = self.lists.shape
        return (self.codes.numel() / 1e9
                + n_chunks * n_clusters * (cap + 1) * 4 / 1e9)


def build(corpus: Corpus, cents: torch.Tensor, books: torch.Tensor,
          queries: torch.Tensor, chunk: int) -> Tuple[Index, torch.Tensor]:
    """(the index, the exact top-10 rows int64[QB, K]) from one pass over
    the corpus a chunk at a time. The lists' cap is chunk 0's largest
    list x 1.5 + 32, rounded up to 128; a longer list raises."""
    from ..ops import ivf, pq
    from ..ops.topk import topk_stable
    from ..ops.vector import sims_f32

    dev = cents.device
    n_chunks, n_clusters = corpus.n // chunk, cents.shape[0]
    codes = torch.empty(corpus.n, books.shape[0], dtype=torch.uint8,
                        device=dev)
    lists = lens = None
    gt_v = torch.full((corpus.qb, K), float("-inf"), device=dev)
    gt_i = torch.zeros(corpus.qb, K, dtype=torch.int64, device=dev)
    worst = 0
    t0 = time.perf_counter()
    for ci in range(n_chunks):
        lo = ci * chunk
        v = corpus.span(lo, lo + chunk)
        assign = ivf.assign_clusters(v.to(torch.bfloat16), cents).long()
        codes[lo:lo + chunk] = pq.pq_encode(v - cents[assign], books)
        cv, cidx = topk_stable(sims_f32(v.to(torch.bfloat16), queries).T, K)
        mv, mi = topk_stable(torch.cat([gt_v, cv], dim=1), K)
        gt_i = torch.gather(torch.cat([gt_i, cidx.long() + lo], dim=1), 1, mi)
        gt_v = mv
        counts = torch.bincount(assign, minlength=n_clusters)
        longest = int(counts.max())
        if lists is None:
            cap = -(-int(longest * 1.5 + 32) // 128) * 128
            log(f"chunk-local list cap {cap} (chunk-0 max {longest})")
            lists = torch.zeros(n_chunks, n_clusters, cap, dtype=torch.int32,
                                device=dev)
            lens = torch.empty(n_chunks, n_clusters, dtype=torch.int32,
                               device=dev)
        worst = max(worst, longest)
        if worst > cap:
            raise RuntimeError(f"IVF local list overflow: {worst} > {cap}")
        order = torch.argsort(assign, stable=True)
        sorted_cl = assign[order]
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(chunk, device=dev) - starts[sorted_cl]
        lists[ci][sorted_cl, rank] = order.to(torch.int32)
        lens[ci] = counts.to(torch.int32)
        del v
        if ci == 0 or (ci + 1) % 16 == 0:
            el = time.perf_counter() - t0
            log(f"  chunk {ci + 1}/{n_chunks} ({(ci + 1) * chunk / el:,.0f} "
                "rows/s)")
    return Index(codes, lists, lens, worst, chunk), gt_i


def search(corpus: Corpus, index: Index, cents: torch.Tensor,
           books: torch.Tensor, q: torch.Tensor, nprobe: int, expand: int,
           group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores f32[Q, K], rows int64[Q, K]): probe, per-group ADC over the
    chunk-local lists, merge, exact rerank of regenerated rows."""
    from ..ops.ivf import adc_gathered, adc_lut
    from ..ops.topk import topk_stable

    qn, dev = q.shape[0], q.device
    n_chunks, _, cap = index.lists.shape
    ck = K * expand
    probe_sims, probe = topk_stable(q @ cents.T, nprobe)     # [Q, nprobe]
    lut = adc_lut(books, q)                                  # [Q, M, 256]
    slot_sims = probe_sims[:, None, :, None].expand(-1, group, -1, cap)
    pos = torch.arange(cap, device=dev)
    bv = torch.full((qn, ck), float("-inf"), device=dev)
    bi = torch.zeros(qn, ck, dtype=torch.int64, device=dev)
    for g0 in range(0, n_chunks, group):
        g = min(group, n_chunks - g0)
        cand = index.lists[g0:g0 + g][:, probe]        # [g, Q, nprobe, cap]
        valid = pos < index.lens[g0:g0 + g][:, probe][..., None]
        base = (torch.arange(g0, g0 + g, device=dev) * index.chunk)
        rows = (cand.long() + base[:, None, None, None]).permute(
            1, 0, 2, 3).reshape(qn, -1)                # [Q, g*nprobe*cap]
        valid = valid.permute(1, 0, 2, 3).reshape(qn, -1)
        adc = adc_gathered(lut, index.codes[rows])
        adc = adc + slot_sims[:, :g].reshape(qn, -1)
        adc = adc.masked_fill(~valid, float("-inf"))
        v, ci = topk_stable(adc, min(ck, adc.shape[1]))
        mv, mi = topk_stable(torch.cat([bv, v], dim=1), ck)
        bi = torch.gather(torch.cat([bi, torch.gather(rows, 1, ci)], dim=1),
                          1, mi)
        bv = mv
    row_v = corpus.rows(bi.reshape(-1)).reshape(qn, ck, -1)
    sims = torch.einsum("qd,qcd->qc", q, row_v)
    sims = sims.masked_fill(~torch.isfinite(bv), float("-inf"))
    v, i = topk_stable(sims, K)
    return v, torch.gather(bi, 1, i)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="orama_core_tpu_torch.tools.pq_100m_bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=100_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--modes", type=int, default=4000)
    ap.add_argument("--clusters", type=int, default=4096)
    ap.add_argument("--pq-m", type=int, default=48)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--expand", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=1_000_000)
    ap.add_argument("--group", type=int, default=16,
                    help="chunks one search step scores")
    ap.add_argument("--train-sample", type=int, default=262_144)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import configure_torch, require_device

    dev = require_device(args.device)
    configure_torch()
    n, d, m = args.docs, args.dim, args.pq_m
    chunk, n_chunks, group = chunking(n, args.chunk, args.group)
    log(f"device {card_line(dev)}; {n}x{d} as PQ{m} codes "
        f"({n * m / 1e9:.1f} GB, {n_chunks} chunks of {chunk}, {group} a "
        f"search step), {args.modes} modes, {args.clusters} chunk-local "
        "lists")
    corpus = Corpus.make(n, d, args.modes, args.queries, dev)
    t0 = time.perf_counter()
    cents, books = train(corpus, args.train_sample, args.clusters, m)
    log(f"residual PQ codebooks + {args.clusters} IVF centroids trained in "
        f"{time.perf_counter() - t0:.1f} s")
    queries = corpus.queries()
    t0 = time.perf_counter()
    index, gt = build(corpus, cents, books, queries, chunk)
    log(f"build (codes + local lists + exact top-10 over {n_chunks} chunks) "
        f"in {time.perf_counter() - t0:.1f} s; worst local list "
        f"{index.worst}/{index.lists.shape[2]}")

    def run():
        return search(corpus, index, cents, books, queries, args.nprobe,
                      args.expand, group)

    ids = run()[1].cpu().numpy()
    recall = recall_at_k(ids, gt.cpu().numpy())
    qps, ms = timed_qps(run, args.queries, ITERS, dev)
    log(f"{ITERS} x {args.queries} queries: {qps:.1f} QPS ({ms:.3f} ms a "
        f"batch); recall@10={recall:.4f}")
    print(json.dumps({
        "metric": f"ivf_pq_rerank_qps_{n // 1_000_000}Mx{d}_top10",
        "value": qps,
        "unit": "qps",
        "recall_at_10": recall,
        "nprobe": args.nprobe,
        "expand": args.expand,
        "resident_gb": index.resident_gb(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
