"""K1's posting-scan forms on the card: four planes or packed two-plane,
at plan blocks of 1,024, 4,096 and 8,192 postings.

The port's counterpart of ``benchmarks/bm25_scan_bench.py``'s Pallas rows
(``pl4_*`` and ``plp_*``), on its data: its Zipf-heavy term mix (seed 0,
``--postings 1000000`` over ``--docs 1048576``: terms of df = P/2, P/4,
... down to 1,024, each over a random sorted doc set with tf in 1-5 and
doc lengths in 8-99), its aligned plans (``plan_aligned``, budgeted at
sum(ceil(df / block) + 1) blocks, the zero tails being the pads that end
a kernel's walk) and its block sizes. Rows:

    segsum      torch's index_add_ of one f32 per posting into the doc
                row: the scattered-add floor the scans sit on (a library
                call, no kernel of the port)
    k1_1024     K1 itself (csrc/bm25_scan.cu), the reference point
    pl4_1024, pl4_4096, pl4_8192   the four-plane form
                (ops.bm25.bm25_scan_wide, csrc/bm25_scan_variants.cu on
                the doc-tile core csrc/bm25_tiles.cuh)
    plp_1024, plp_4096, plp_8192   the packed form: docs and tf | lens
                << 16 (8 B a posting), ni per plan block
                (ops.bm25.bm25_scan_packed)

Every scan row is first held against the numpy oracle (float64 sums of
the same BM25 terms) and fails beyond a relative error of 1e-5 of the
largest score, as the bench validates before it times. Timed calls cycle
over four copies of the posting planes (80 MB), past the card's 50 MB
L2, as a stream of different terms would find them. Each scan row also
times its plain torch version (``plain_ms``); no single PyTorch call
computes a BM25 scan with its per-doc sum, so ``library_ms`` is null.

    python -m orama_core_tpu_torch.tools.bm25_scan_bench [--iters 40]
        [--device cpu --postings 20000 --docs 50000]

It runs on the card unless given ``--device cpu`` (the plain versions,
host time: a rehearsal, not a measurement). It prints one JSON line,
``{"bench": "bm25_scan", "card": ..., "postings", "docs", "results":
{row: {"ms", "bound_ms", "bound_by", "share", "plain_ms", "library_ms",
"rel_err"}}, "repairs": n}``: ``repairs`` counts the scan calls of the
run whose doc-tile check failed and that the kernel repaired
(``ops.bm25.scan_repairs``); the bench's windows ascend, so it is 0.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.bm25 import B, K1
from . import timing

COPIES = 4  # copies of the posting planes the timed calls cycle over
REL_TOL = 1e-5


def zipf_postings(postings: int = 1_000_000, n_docs: int = 1_048_576,
                  seed: int = 0) -> Dict[str, Any]:
    """The bench's generator (``benchmarks/bm25_scan_bench.py:276-322``),
    the same arrays from the same seed: posting planes padded to a
    multiple of 8,192 (docs 0, tf 0, ni 1, lens 1 in the pad), the packed
    plane, the spans and the BM25 scalars."""
    rng = np.random.default_rng(seed)
    dfs = []
    df = max(postings // 2, 1)
    while sum(dfs) + df // 2 < postings and df >= 1024:
        dfs.append(df)
        df //= 2
    lens_by_doc = rng.integers(8, 100, n_docs).astype(np.int32)
    docs_l, tf_l, ni_l, lens_l = [], [], [], []
    p_lo, p_len, p_ni = [], [], []
    off = 0
    for df in dfs:
        ids = np.sort(rng.permutation(n_docs)[:df]).astype(np.int32)
        tf = rng.integers(1, 6, df).astype(np.int32)
        docs_l.append(ids)
        tf_l.append(tf)
        ni_l.append(np.full(df, df, np.float32))
        lens_l.append(lens_by_doc[ids].astype(np.float32))
        p_lo.append(off)
        p_len.append(df)
        p_ni.append(float(df))
        off += df
    big_block = 8192
    p_total = off
    p_pad = -(-p_total // big_block) * big_block
    post_docs = np.zeros(p_pad, np.int32)
    post_tf = np.zeros(p_pad, np.float32)
    post_ni = np.ones(p_pad, np.float32)
    post_lens = np.ones(p_pad, np.float32)
    if dfs:
        post_docs[:p_total] = np.concatenate(docs_l)
        post_tf[:p_total] = np.concatenate(tf_l).astype(np.float32)
        post_ni[:p_total] = np.concatenate(ni_l)
        post_lens[:p_total] = np.concatenate(lens_l)
    packed = (
        post_tf.astype(np.int64).astype(np.uint32)
        | (post_lens.astype(np.int64).astype(np.uint32) << np.uint32(16))
    ).astype(np.int32)
    return {
        "dfs": dfs, "p_lo": p_lo, "p_len": p_len, "p_ni": p_ni,
        "p_total": p_total, "n_docs": n_docs, "lens_by_doc": lens_by_doc,
        "post_docs": post_docs, "post_tf": post_tf, "post_ni": post_ni,
        "post_lens": post_lens, "packed": packed,
        "avgdl": np.float32(lens_by_doc.mean()), "nfd": np.float32(n_docs),
        "boost": np.float32(1.0), "rng": rng,
    }


def oracle(data: Dict[str, Any]) -> np.ndarray:
    """The bench's numpy oracle (``:325-335``): f32[n_docs] of float64 sums
    of each span's BM25 terms."""
    n_docs, avgdl = data["n_docs"], data["avgdl"]
    out = np.zeros(n_docs, np.float64)
    for lo, ln, df in zip(data["p_lo"], data["p_len"], data["p_ni"]):
        idf = np.log1p(max((n_docs - df + 0.5) / (df + 0.5), 0.0))
        d = data["post_docs"][lo:lo + ln]
        t = data["post_tf"][lo:lo + ln].astype(np.float64)
        ln_d = data["post_lens"][lo:lo + ln].astype(np.float64)
        den = t + K1 * (1.0 - B + B * ln_d / avgdl)
        np.add.at(out, d, idf * t * (K1 + 1.0) / den)
    return out.astype(np.float32)


def plan_aligned(p_lo, p_len, p_ni, block: int, nb: int):
    """The bench's aligned plan (``benchmarks/bm25_scan_bench.py:64-83``)
    at any block size, with each plan block's ni: (block_idx int32[nb],
    lo_off int32[nb], hi_off int32[nb], ni f32[nb]); blocks past the
    spans' are zero (hi_off 0: the pads that end a kernel's walk)."""
    blk_idx = np.zeros(nb, np.int32)
    lo_off = np.zeros(nb, np.int32)
    hi_off = np.zeros(nb, np.int32)
    ni_b = np.zeros(nb, np.float32)
    b = 0
    for lo, ln, ni in zip(p_lo, p_len, p_ni):
        if ln <= 0:
            continue
        hi = lo + ln
        for blk in range(lo // block, (hi - 1) // block + 1):
            if b >= nb:
                return blk_idx, lo_off, hi_off, ni_b
            blk_idx[b] = blk
            lo_off[b] = max(lo - blk * block, 0)
            hi_off[b] = min(hi - blk * block, block)
            ni_b[b] = ni
            b += 1
    return blk_idx, lo_off, hi_off, ni_b


def plans(data: Dict[str, Any], block: int):
    """The bench's plan at ``block`` (``:431-432``): (block_idx, lo_off,
    hi_off, ni f32) over sum(ceil(df / block) + 1) blocks."""
    nb = sum((ln + block - 1) // block + 1 for ln in data["p_len"])
    return plan_aligned(data["p_lo"], data["p_len"], data["p_ni"], block, nb)


def run(data: Dict[str, Any], device, iters: int = 40) -> Dict[str, Any]:
    """Validate and time every row on ``data`` (``zipf_postings``);
    returns the JSON line's object."""
    from ..ops import _cuda, bm25

    dev = torch.device(device)
    ref = torch.as_tensor(oracle(data), device=dev)
    ref_max = max(float(ref.max()), 1e-9) if ref.numel() else 1e-9
    n_docs, p_total = data["n_docs"], data["p_total"]
    scal = (float(data["boost"]), float(data["avgdl"]), float(data["nfd"]))

    def put(a):
        return torch.as_tensor(a, device=dev)

    planes = [
        {k: put(data[k]).clone() for k in
         ("post_docs", "post_tf", "post_ni", "post_lens", "packed")}
        for _ in range(COPIES)]
    before = dict(_cuda.LAUNCHES)
    repairs = bm25.scan_repairs(dev)
    results = {}

    def record(name, calls, nbytes, ops, check=None, plain_call=None):
        rec = {}
        if check is not None:
            got = check()
            err = float((got - ref).abs().max()) if got.numel() else 0.0
            rec["rel_err"] = err / ref_max
            if not rec["rel_err"] <= REL_TOL:
                raise RuntimeError(f"{name} disagrees with the oracle: "
                                   f"relative error {rec['rel_err']:.3g}")
        rec["ms"] = timing.time_ms(calls, iters, dev)
        b, by = timing.bound_ms(nbytes, ops, timing.F32_FLOPS)
        rec.update(bound_ms=b, bound_by=by,
                   share=b / rec["ms"] if dev.type == "cuda" else None,
                   plain_ms=None, library_ms=None)
        if plain_call is not None:
            rec["plain_ms"] = timing.time_ms(plain_call, max(iters // 8, 2),
                                             dev)
        results[name] = rec

    # the scattered-add floor: one f32 per posting into the doc row
    contrib = put(data["rng"].standard_normal(p_total).astype(np.float32))
    seg_docs = [p["post_docs"][:p_total].long() for p in planes]
    record("segsum", [lambda d=d: torch.zeros(
        n_docs, dtype=torch.float32, device=dev).index_add_(0, d, contrib)
        for d in seg_docs], p_total * 12 + n_docs * 4, p_total)

    for blk in bm25.SCAN_BLOCKS:
        bi, lo, hi, ni_b = plans(data, blk)
        nb = len(bi)
        plan = [put(a) for a in (bi, lo, hi)]
        ni_i32 = put(ni_b.astype(np.int32))
        plan_bytes = nb * 12

        def four(p, fn=bm25.bm25_scan_wide, blk=blk, plan=plan):
            return fn(p["post_docs"], p["post_tf"], p["post_ni"],
                      p["post_lens"], *plan, *scal, n_docs, blk)

        def two(p, fn=bm25.bm25_scan_packed, blk=blk, plan=plan,
                ni_i32=ni_i32):
            return fn(p["post_docs"], p["packed"], *plan, ni_i32, *scal,
                      n_docs, blk)

        def k1(p, fn=bm25.bm25_scores_blocked_aligned, plan=plan, nb=nb):
            return fn(p["post_docs"], p["post_tf"], p["post_ni"],
                      p["post_lens"], *plan, *scal, n_docs, nb)

        four_bytes = p_total * 16 + plan_bytes + n_docs * 4
        if blk == bm25.BLOCK:
            record("k1_1024", [lambda p=p: k1(p) for p in planes],
                   four_bytes, p_total * 20, check=lambda: k1(planes[0]),
                   plain_call=lambda: k1(
                       planes[0], bm25.bm25_scores_blocked_aligned_plain))
        record(f"pl4_{blk}", [lambda p=p: four(p) for p in planes],
               four_bytes, p_total * 20, check=lambda: four(planes[0]),
               plain_call=lambda: four(planes[0], bm25.bm25_scan_wide_plain))
        record(f"plp_{blk}", [lambda p=p: two(p) for p in planes],
               p_total * 8 + plan_bytes + nb * 4 + n_docs * 4, p_total * 20,
               check=lambda: two(planes[0]),
               plain_call=lambda: two(planes[0],
                                      bm25.bm25_scan_packed_plain))
    return {
        "bench": "bm25_scan", "card": timing.card_line(dev),
        "clock": timing.clock(dev), "postings": p_total, "docs": n_docs,
        "terms": len(data["dfs"]), "results": results,
        "repairs": bm25.scan_repairs(dev) - repairs,
        "launches": {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                     if v != before[k]},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .. import configure_torch, require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--postings", type=int, default=1_000_000)
    ap.add_argument("--docs", type=int, default=1_048_576)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    configure_torch()
    out = run(zipf_postings(args.postings, args.docs), dev, args.iters)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
