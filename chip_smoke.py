#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Builds the port's four hand-written Hopper kernels from
``orama_core_tpu_torch/csrc`` with nvcc (sm_90a), then runs, failing at the
first phase that fails:

1. device: the card's name and power limit, capability (9, 0);
2. a 1M-document collection at the shape of the repo's 1M serving setup
   (``benchmarks/hybrid_1m_bench.py``, regenerated here from a seed:
   50,000 Zipf terms with df ~ rank^-0.9, ~20M postings with one position
   each, 384-d unit vectors for ``fake-base``, a ``price`` number field)
   built straight from committed arrays onto the card;
3. each kernel against its plain torch version on that collection's
   tensors (K1 over a ~1M-posting plan, K2 over the padded 4,194,304 x
   384 bf16 corpus with n_valid = 1,000,000 and Q = 8, and at D = 768 and
   1024 on 262,144 rows, K3 on the rows K2 selects, K4 over the
   ~20M-position phrase stream), timed with CUDA events, with the card's
   least time for the same work beside it;
4. the engine: 32 queries each of fulltext, phrase, hybrid RRF,
   unfiltered vector (the fused kNN) and filtered + faceted vector, with
   the launch counts reset before and read after each mode; one query per
   mode is held against the same collection served on the CPU;
5. the normal entry point: ``build_orama`` on ``cuda`` ingests 5,000
   documents, commits, and every search mode is held against the same
   data directory loaded by ``build_orama(device="cpu")``.

With ``--profile``, each engine mode is also traced with torch.profiler
(device busy share, top ops by device time). The last two lines are the
kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result; nothing runs on the CPU in its place.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
F32_FLOPS = 67e12                # f32 outside the tensor cores
TPU_KERNELS = {
    "bm25_scan": ("orama_core_tpu_torch/csrc/bm25_scan.cu",
                  "orama_core_tpu/ops/bm25.py:324"),
    "knn_subblock_max": ("orama_core_tpu_torch/csrc/knn_subblock_max.cu",
                         "orama_core_tpu/ops/pallas_knn.py:51"),
    "knn_rescore": ("orama_core_tpu_torch/csrc/knn_rescore.cu",
                    "orama_core_tpu/ops/pallas_knn.py:226"),
    "phrase_counts": ("orama_core_tpu_torch/csrc/phrase_counts.cu",
                      "orama_core_tpu/ops/bm25.py:788"),
}
N_DOCS, N_TERMS, AVG_POSTINGS, DIM = 1_000_000, 50_000, 20, 384


class SmokeFailure(RuntimeError):
    pass


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


# -- data ---------------------------------------------------------------------


def synth_arrays(n_docs=N_DOCS, n_terms=N_TERMS, avg_postings=AVG_POSTINGS,
                 dim=DIM, seed=0):
    """Committed arrays of the 1M serving setup, from a seed."""
    from orama_core_tpu_torch.index import (
        CommittedNumberIndex, CommittedStringIndex, CommittedVectorIndex,
        TermDict,
    )

    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    weights = 1.0 / ranks ** 0.9
    df = np.maximum((weights / weights.sum() * n_docs * avg_postings)
                    .astype(np.int64), 1)
    df = np.minimum(df, n_docs)
    term_starts = np.zeros(n_terms + 1, np.int64)
    np.cumsum(df, out=term_starts[1:])
    p = int(term_starts[-1])
    td = TermDict.__new__(TermDict)
    td.terms = [f"term{t:06d}" for t in range(n_terms)]
    doc_lens = rng.integers(20, 200, n_docs).astype(np.float32)
    string_idx = CommittedStringIndex(
        term_dict=td, term_starts=term_starts,
        post_docs=rng.integers(0, n_docs, p).astype(np.int32),
        post_tf=rng.integers(1, 5, p).astype(np.float32),
        pos_starts=np.arange(p + 1, dtype=np.int64),   # one position each
        positions=rng.integers(0, 100, p).astype(np.int32),
        doc_lens_dense=doc_lens, n_docs_with_field=n_docs,
        total_len=int(doc_lens.sum()),
    )
    vecs = rng.standard_normal((n_docs, dim), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    prices = rng.uniform(0, 100, n_docs).astype(np.float32)
    order = np.argsort(prices)
    return {
        "collection_id": "smoke1m", "read_api_key": "rk",
        "fields": [
            {"field_id": 0, "name": "body", "type": "string"},
            {"field_id": 1, "name": "embedding", "type": "embedding",
             "model": "fake-base"},
            {"field_id": 2, "name": "price", "type": "number"},
        ],
        "arrays": {
            "string-0": string_idx.to_arrays(),
            "vector-1": CommittedVectorIndex(
                dimension=dim, vecs=vecs,
                vec_docs=np.arange(n_docs, dtype=np.int32)).to_arrays(),
            "number-2": CommittedNumberIndex(
                vals=prices[order], docs=order.astype(np.int32)).to_arrays(),
        },
        "alive": np.ones(n_docs, np.float32),
        "doc_count": n_docs, "max_doc_id": n_docs - 1,
    }


def make_reader(arrays, device: str):
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.carry import reader_from_arrays

    return reader_from_arrays(**arrays, gpu_cfg=GpuConfig(device=device))


def zipf_term(rng, n_words=1, n_terms=N_TERMS) -> str:
    """Query terms drawn as bench.py draws them (Zipf-like head bias)."""
    ids = (rng.pareto(1.2, n_words) * 50).astype(int) % n_terms
    return " ".join(f"term{t:06d}" for t in ids)


# -- checks -------------------------------------------------------------------


def check_hits(got, want, rtol: float, what: str) -> None:
    """Same ranked hits: scores within rtol position by position, and the
    same ids except that docs whose scores tie within rtol may swap
    (order among near-equal floats depends on summation order)."""
    require(len(got) == len(want), f"{what}: {len(got)} hits vs {len(want)}")
    gs = np.asarray([s for _, s in got], np.float64)
    ws = np.asarray([s for _, s in want], np.float64)
    require(bool(np.all(np.isfinite(gs))), f"{what}: non-finite scores")
    require(np.allclose(gs, ws, rtol=rtol, atol=0),
            f"{what}: scores differ\n{gs[:8]}\n{ws[:8]}")
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and abs(ws[j] - ws[i]) <= rtol * abs(ws[i]):
            j += 1
        if j < len(want):  # a tie group cut by the limit may differ
            require({d for d, _ in got[i:j]} == {d for d, _ in want[i:j]},
                    f"{what}: ids differ at ranks {i}..{j - 1}")
        i = j


def time_ms(fns, iters: int) -> float:
    """Device ms per call, cycling through ``fns`` (callables on inputs
    whose joint footprint exceeds the 50 MB L2 where the engine would find
    them cold). A spin kernel holds the stream while the host queues all
    the calls, so the CUDA events bracket device work only, not the
    host's launch overhead."""
    import torch

    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    for f in fns:
        f()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - h0           # bounds the enqueue time
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * host_s + 1e-3, 5.0) * 2.0e9))  # cycles
    t0.record()
    for i in range(iters):
        fns[i % len(fns)]()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_record(name, max_abs_err, ms, plain_ms, bytes_moved, ops,
                  peak_ops, library_ms=None):
    b, by = bound_ms(bytes_moved, ops, peak_ops)
    src, rep = TPU_KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": 0, "max_abs_err": float(max_abs_err), "ms": float(ms),
        "plain_ms": float(plain_ms), "bound_ms": float(b), "bound_by": by,
        "library_ms": library_ms,
    }


def phase_kernels(reader, rng):
    """Each kernel against its plain version on the collection's tensors."""
    import torch

    from orama_core_tpu_torch.ops import bm25, knn

    cap = reader.capacity
    sf = reader._string[0]
    c = sf.committed
    gi = c.global_info()
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []

    # K1: four consecutive light-term spans (past the dense head rows) of
    # ~1M postings each; one is checked, all four are timed in turn (their
    # ~80 MB exceed the L2, as a stream of different query terms would).
    # The scalars live on the card, as the fused program passes them.
    d_docs, d_tf, d_ni, d_plens = reader._device.string_arrays(c)
    ts = c.term_starts
    scal = [torch.tensor(x, dtype=torch.float32, device="cuda")
            for x in (1.0, gi.avgdl, float(gi.total_documents))]
    calls, n_posts, n_blocks = [], [], []
    t0 = 64
    for _ in range(4):
        t1 = int(np.searchsorted(ts, ts[t0] + 1_000_000))
        p_lo, p_len = [int(ts[t0])], [int(ts[t1] - ts[t0])]
        nb = bm25.aligned_blocks_needed(p_len)
        plan = [torch.as_tensor(a, device="cuda")
                for a in bm25.build_block_plan_aligned(p_lo, p_len, nb)]
        calls.append(((d_docs, d_tf, d_ni, d_plens, *plan, *scal),
                      dict(n_docs=cap, n_blocks=nb)))
        n_posts.append(p_len[0])
        n_blocks.append(nb)
        t0 = t1
    args, kw = calls[0]
    got = bm25.bm25_scores_blocked_aligned(*args, **kw)
    want = bm25.bm25_scores_blocked_aligned_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
            f"K1 disagrees with its plain version: max err {err}")
    require(int((got > 0).sum()) > 100_000, "K1 scored too few docs")
    ms = time_ms([lambda a=a, k=k: bm25.bm25_scores_blocked_aligned(*a, **k)
                  for a, k in calls], 40)
    pms = time_ms([lambda a=a, k=k: bm25.bm25_scores_blocked_aligned_plain(
        *a, **k) for a, k in calls], 8)
    n_post = float(np.mean(n_posts))
    out.append(kernel_record(
        "bm25_scan", err, ms, pms,
        bytes_moved=n_post * 16 + np.mean(n_blocks) * 12 + cap * 4,
        ops=n_post * 20, peak_ops=F32_FLOPS))
    log(f"K1 ok: {n_posts} postings, err {err:.3g}, {ms:.4f} ms")

    # K2: the padded corpus, n_valid real rows, Q = 8
    vf = reader._vector[1]
    vecs, _docs, _valid = reader._device.vector_arrays(vf.committed)
    n_valid = vf.committed.n_vectors
    q = rng.standard_normal((8, vecs.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qd = torch.as_tensor(q, device="cuda").to(torch.bfloat16)
    bm, bc = knn.subblock_max(vecs, qd, 32, n_valid)
    pm, pc = knn.subblock_max_plain(vecs, qd, 32, n_valid)
    torch.cuda.synchronize()
    err = (bm - pm).abs().max().item()
    require(err <= 1e-4, f"K2 max disagrees: {err}")
    sims = vector_sims(vecs, qd, n_valid)
    near0 = (sims.abs() < 1e-5).reshape(-1, 32, sims.shape[1]).any(dim=1)
    near0 = torch.cat([near0, torch.zeros(
        pc.shape[0] - near0.shape[0], pc.shape[1], dtype=torch.bool,
        device="cuda")])
    bad = (bc != pc) & ~near0
    require(int(bad.sum()) == 0, f"K2 counts disagree in {int(bad.sum())} "
            "sub-blocks with no near-zero similarity")
    ms = time_ms(lambda: knn.subblock_max(vecs, qd, 32, n_valid), 20)
    pms = time_ms(lambda: knn.subblock_max_plain(vecs, qd, 32, n_valid), 3)
    d = vecs.shape[1]
    out.append(kernel_record(
        "knn_subblock_max", err, ms, pms,
        bytes_moved=n_valid * d * 2 + 8 * d * 2 + bm.numel() * 8,
        ops=2 * n_valid * d * 8, peak_ops=BF16_FLOPS))
    log(f"K2 ok: err {err:.3g}, {ms:.4f} ms")
    # K2 at the registry's wider embedding widths (768: bge-base, 1024:
    # bge-large), whose rows must not outgrow the kernel's shared memory
    for width in (768, 1024):
        vw = torch.randn(262_144, width, generator=gen, device="cuda")
        vw = (vw / vw.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        qw = torch.randn(8, width, generator=gen, device="cuda")
        qw = (qw / qw.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        wm, _ = knn.subblock_max(vw, qw, 32, 250_000)
        wp, _ = knn.subblock_max_plain(vw, qw, 32, 250_000)
        torch.cuda.synchronize()
        werr = (wm - wp).abs().max().item()
        require(werr <= 1e-4, f"K2 max disagrees at D={width}: {werr}")
        wms = time_ms(lambda: knn.subblock_max(vw, qw, 32, 250_000), 10)
        log(f"K2 ok at D={width}: 262,144 rows, n_valid 250,000, Q=8, "
            f"err {werr:.3g}, {wms:.4f} ms")
        del vw, wm, wp

    # K3: the sub-blocks phase 2 selects for these queries (k = 16); timed
    # in turn with 23 more query batches' selections (~75 MB of rows, past
    # the L2, as after a K2 pass that streamed the corpus)
    k = 16
    ids = knn._tiered_subblock_topk(pm, k).reshape(-1)
    r1 = knn.rescore_subblocks(vecs, qd, ids, k, 32)
    r2 = knn.rescore_subblocks_plain(vecs, qd, ids, k, 32)
    torch.cuda.synchronize()
    err = (r1 - r2).abs().max().item()
    require(err <= 1e-4, f"K3 disagrees: {err}")
    sel = [(qd, ids)]
    for _ in range(23):
        qx = torch.randn(8, d, generator=gen, device="cuda")
        qx = (qx / qx.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        mx, _ = knn.subblock_max(vecs, qx, 32, n_valid)
        sel.append((qx, knn._tiered_subblock_topk(mx, k).reshape(-1)))
    ms = time_ms([lambda q_=q_, i_=i_: knn.rescore_subblocks(
        vecs, q_, i_, k, 32) for q_, i_ in sel], 96)
    pms = time_ms([lambda q_=q_, i_=i_: knn.rescore_subblocks_plain(
        vecs, q_, i_, k, 32) for q_, i_ in sel], 48)
    nsel = ids.numel()
    out.append(kernel_record(
        "knn_rescore", err, ms, pms,
        bytes_moved=nsel * 32 * d * 2 + 8 * d * 2 + nsel * 4 + nsel * 32 * 4,
        ops=2 * nsel * 32 * d, peak_ops=BF16_FLOPS))
    log(f"K3 ok: {nsel} sub-blocks, err {err:.3g}, {ms:.4f} ms")

    # K4: the whole phrase stream, spans of two Zipf-drawn terms
    dw, tw, bits = reader._device.phrase_stream_arrays(c)
    tids = (rng.pareto(1.2, 2) * 50).astype(int) % N_TERMS
    spans = torch.tensor([[t, t + 1] for t in tids] + [[0, 0]] * 2,
                         dtype=torch.int32, device="cuda")
    a1, s1 = bm25.phrase_counts(bits, tw, dw, spans, cap)
    a2, s2 = bm25.phrase_counts_plain(bits, tw, dw, spans, cap)
    torch.cuda.synchronize()
    require(torch.equal(a1, a2) and torch.equal(s1, s2),
            "K4 counts differ from the plain version")
    require(int(a1.sum()) > 0, "K4 counted nothing")
    ms = time_ms(lambda: bm25.phrase_counts(bits, tw, dw, spans, cap), 20)
    pms = time_ms(lambda: bm25.phrase_counts_plain(bits, tw, dw, spans, cap), 3)
    # bytes it must move: the bits and term id of every position, the doc
    # id of each counted group head only (one per anyorder count), the
    # spans, and the two int32[cap] counters
    pp = dw.numel()
    heads = int(a1.sum())
    out.append(kernel_record(
        "phrase_counts", 0.0, ms, pms,
        bytes_moved=pp * 5 + heads * 4 + spans.numel() * 4 + cap * 8,
        ops=pp * 4 * spans.shape[0], peak_ops=F32_FLOPS))
    log(f"K4 ok: {pp} positions, exact, {ms:.4f} ms")
    for rec in out:
        print(json.dumps(rec), flush=True)
    return out


def vector_sims(vecs, qd, n_valid):
    from orama_core_tpu_torch.ops.vector import sims_f32

    return sims_f32(vecs[:n_valid], qd)


MODES = {
    "fulltext": ("fulltext", 1, {}),
    "phrase": ("fulltext", 2, {}),
    "hybrid_rrf": ("hybrid", 1, {}),
    "vector": ("vector", 1, {}),
    "vector_filtered": ("vector", 1, {
        "where": {"price": {"between": [20, 60]}},
        "facets": {"price": {"ranges": [{"from": 0, "to": 25},
                                        {"from": 25, "to": 50}]}},
    }),
}
EXPECT = {  # kernels each mode must launch
    "fulltext": ("bm25_scan",),
    "phrase": ("bm25_scan", "phrase_counts"),
    "hybrid_rrf": ("bm25_scan",),
    "vector": ("knn_subblock_max", "knn_rescore"),
    "vector_filtered": (),
}


def phase_engine(reader, cpu_reader, rng, n_queries=32):
    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    ai = AIService()
    totals = {k: 0 for k in _cuda.LAUNCHES}
    p50 = {}
    for mode, (kind, n_words, extra) in MODES.items():
        bodies = [dict(term=zipf_term(rng, n_words), mode=kind, **extra)
                  for _ in range(n_queries + 4)]
        for body in bodies[:4]:  # first-use allocations
            reader.search(SearchParams.from_json(body), ai)
        _cuda.reset_launches()
        lat = []
        results = []
        for body in bodies[4:]:
            t0 = time.perf_counter()
            res = reader.search(SearchParams.from_json(body), ai)
            lat.append((time.perf_counter() - t0) * 1e3)
            results.append(res)
        counts = dict(_cuda.LAUNCHES)
        for k, v in counts.items():
            totals[k] += v
        for name in EXPECT[mode]:
            require(counts[name] > 0, f"{mode}: {name} was never launched")
        require(sum(1 for r in results if r[1] > 0) >= n_queries // 2,
                f"{mode}: most queries matched nothing")
        for ranked, _n, _f in results:
            scores = [s for _, s in ranked]
            require(all(np.isfinite(scores)), f"{mode}: non-finite score")
            require(scores == sorted(scores, reverse=True),
                    f"{mode}: hits not in descending order")
        # one query per mode against the same collection on the CPU
        p = SearchParams.from_json(bodies[-1])
        got, got_n, got_f = reader.search(p, ai)
        want, want_n, want_f = cpu_reader.search(p, ai)
        check_hits(got, want, 1e-4, f"{mode} vs CPU")
        if kind == "vector":
            # a similarity within rounding of zero may change sign with
            # the order of summation: allow that many flips in the count
            require(abs(got_n - want_n) <= 2, f"{mode}: count {got_n} vs {want_n}")
        else:
            require(got_n == want_n, f"{mode}: count {got_n} vs {want_n}")
        require(_facets(got_f) == _facets(want_f), f"{mode}: facets differ")
        p50[mode] = float(np.percentile(lat, 50))
        log(f"{mode}: p50 {p50[mode]:.3f} ms, launches {counts}")
    return p50, totals


def _device_us(evt) -> float:
    """Device time of a kernel event (ops above the kernels are skipped,
    so a kernel is never counted twice)."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def phase_profile(reader, rng, n_queries=16):
    """Optional (``--profile``): per mode, the device's busy share of the
    wall time and the ops that take the most device time, from
    torch.profiler over a steady window of queries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.types import SearchParams

    ai = AIService()
    for mode, (kind, n_words, extra) in MODES.items():
        params = [SearchParams.from_json(
            dict(term=zipf_term(rng, n_words), mode=kind, **extra))
            for _ in range(n_queries)]
        for p in params[:2]:
            reader.search(p, ai)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for p in params:
                reader.search(p, ai)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        evts = prof.key_averages()
        busy_us = sum(_device_us(e) for e in evts)
        by_name = {}
        for e in evts:
            if _device_us(e) > 0:
                by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + _device_us(e)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "profile": mode, "queries": n_queries,
            "wall_ms_per_query": wall_us / n_queries / 1e3,
            "device_ms_per_query": busy_us / n_queries / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if busy_us else None,
            "top_device_ms_per_query": {
                name: us / n_queries / 1e3 for name, us in top
            },
        }), flush=True)


def _facets(f):
    return None if f is None else {k: (v.count, v.values) for k, v in f.items()}


def phase_build_orama(n_docs=5000, seed=7, device="cuda"):
    """The normal entry point on the card against the CPU on one data dir."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.types import SearchParams

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)

    def cfg():
        c = OramaxConfig()
        c.writer_side.data_dir = os.path.join(work, "w")
        c.reader_side.data_dir = os.path.join(work, "r")
        c.ai.backend = "fake"
        return c

    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    zipf = 1.0 / np.arange(1, 401) ** 0.8
    zipf /= zipf.sum()
    docs = [{
        "id": str(i),
        "title": " ".join(rng.choice(vocab, 3, p=zipf)),
        "body": " ".join(rng.choice(vocab, int(rng.integers(5, 30)), p=zipf)),
        "price": float(rng.uniform(0, 100)),
    } for i in range(n_docs)]
    gpu = build_orama(cfg(), start_background=False, device=device)
    gpu.write_side.create_collection("master", "c", read_api_key="r",
                                     write_api_key="w")
    gpu.flush()
    gpu.write_side.write("c", docs, "w")
    gpu.commit()
    cpu = build_orama(cfg(), start_background=False, device="cpu")
    reader = gpu.read_side._reader("c")
    require(reader.device.type == device, "build_orama did not use the card")
    bodies = [
        {"term": "w3"}, {"term": "w1 w2"}, {"term": "w5 w9", "limit": 20},
        {"term": "w4", "mode": "vector"},
        {"term": "w8", "mode": "vector", "where": {"price": {"lt": 50}},
         "facets": {"price": {"ranges": [{"from": 0, "to": 30}]}}},
        {"term": "w2 w7", "mode": "hybrid"},
        {"term": "w6", "mode": "hybrid", "fusion": "minmax"},
        {"term": "w1", "where": {"price": {"gte": 30}}, "limit": 50},
    ]
    require(reader._vector_fast_field(SearchParams.from_json(bodies[3]))
            is not None, "the fused kNN did not qualify")
    try:
        for body in bodies:
            g = gpu.read_side.search("c", SearchParams.from_json(body), "r")
            c_ = cpu.read_side.search("c", SearchParams.from_json(body), "r")
            check_hits([(h.id, h.score) for h in g.hits],
                       [(h.id, h.score) for h in c_.hits], 1e-4,
                       f"build_orama {body}")
            if body.get("mode") == "vector":
                require(abs(g.count - c_.count) <= 2, f"{body}: counts")
            else:
                require(g.count == c_.count, f"{body}: counts")
            require(g.count > 0, f"{body}: no hits")
            require(_facets(g.facets) == _facets(c_.facets), f"{body}: facets")
    finally:
        gpu.close()
        cpu.close()
        shutil.rmtree(work, ignore_errors=True)
    log(f"build_orama: {len(bodies)} queries equal on cuda and cpu")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's kernels need the card")
        return 2
    sys.path.insert(0, ROOT)
    from orama_core_tpu_torch import configure_torch
    from orama_core_tpu_torch.ops import _cuda

    configure_torch()
    card = card_line()
    cap = torch.cuda.get_device_capability()
    log(f"device: {card}, capability {cap}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    require(tuple(cap) == (9, 0), f"needs capability (9, 0), got {cap}")
    t0 = time.perf_counter()
    _cuda.build_all(force=True)
    log(f"built {len(_cuda.SIGNATURES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    arrays = synth_arrays()
    reader = make_reader(arrays, "cuda")
    reader.warmup()
    torch.cuda.synchronize()
    log(f"1M collection on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(42)
    records = phase_kernels(reader, rng)
    cpu_reader = make_reader(arrays, "cpu")
    p50, launches = phase_engine(reader, cpu_reader, rng)
    del cpu_reader
    if "--profile" in sys.argv[1:]:
        phase_profile(reader, rng)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        require(rec["launches"] > 0, f"{rec['name']} never ran on the main path")
    phase_build_orama()
    print(json.dumps({"p50_ms": p50, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"chip_smoke FAILED: {e}")
        sys.exit(1)
