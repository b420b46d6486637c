"""Phase-1 and phase-2 probes of the exact kNN kernels on the card.

The port's counterpart of ``benchmarks/knn_tune_bench.py``'s Pallas rows,
at its shape and on its data: a 1,000,000 x 768 bf16 corpus padded to
BN = 2,048 rows (``utils.benchgen.hashed_unit_corpus(n_pad, 768,
salt=1)``), 256 unit queries from ``numpy.random.default_rng(11)``, k =
10. Each row times one function:

    phase1      B1's k_base and k_rmax: per-sub-block max at sub 32,
                every row masked, no count (ops.knn.subblock_max_only);
                k_rmax differs only in Mosaic's reduction layout, so on
                this card the two are one function and one row
    masklast    B1's k_masklast: masked only at the edge
    qt          B1's k_qt: the queries given as qt [D, Q]
    sub64       B1's k_sub64: sub 64
    sub128      B1's k_sub128 (the bench's sub128full phase 1): sub 128
    mm          B1's k_mm: the bare product rows, every tile multiplied
                (ops.knn.phase1_rows): the mainloop's streaming floor;
                its library_ms is torch.matmul over the kept rows, the one
                PyTorch call that computes the same function
    k2          K2 itself at this shape (max and count), beside mm
    prescore    B2: K3 on B2's 2,560 selected sub-blocks, queries from
                qt.T (made once, outside the row)
    qt_transpose  the qt.T.contiguous() that B2's K3 needs
    sub64full, sub128full   end to end at sub 64 / 128: the probe max
                and the port's phase 2 (tiered selection, K3, top-k)
    fulltier    B2 end to end: phase1, the tiered selection, qt.T, K3
                and the final top-k

    python -m orama_core_tpu_torch.tools.knn_tune_bench [--iters 20]
        [--rows phase1,mm] [--device cpu --n 5000 --q 16]

It runs on the card unless given ``--device cpu`` (the plain versions,
host time: a rehearsal, not a measurement). It prints one JSON line,
``{"bench": "knn_tune", "card": ..., "results": {row: {"ms",
"bound_ms", "bound_by", "share", "plain_ms", "library_ms", "launches"}}}``,
the
bound being an H100's least time for the row's work (``tools.timing``);
``plain_ms`` is the plain torch version's time where the row has one,
``library_ms`` that of the one PyTorch call computing the same function
where there is one (k_mm's alone), else null; ``launches`` counts the
row's own kernel launches (``ops._cuda.LAUNCHES``), so B2's K3 launches
(``prescore``) stand apart from the end-to-end rows' K3 launches.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import timing

# benchmarks/knn_tune_bench.py:43-44
N, D, K, QB = 1_000_000, 768, 10, 256
BN, SUB = 2048, 32

ROWS = ("phase1", "masklast", "qt", "sub64", "sub128", "mm", "k2",
        "prescore", "qt_transpose", "sub64full", "sub128full", "fulltier")


def make_inputs(n: int = N, q: int = QB, device="cuda") -> Dict[str, Any]:
    """The bench's corpus and queries on ``device``: vecs bf16[n_pad, D],
    queries bf16[q, D], qt bf16[D, q] (the same values), n_valid = n."""
    from ..utils.benchgen import hashed_unit_corpus

    n_pad = -(-n // BN) * BN
    rng = np.random.default_rng(11)
    q_np = rng.standard_normal((q, D)).astype(np.float32)
    q_np /= np.linalg.norm(q_np, axis=-1, keepdims=True)
    dev = torch.device(device)
    return {
        "vecs": hashed_unit_corpus(n_pad, D, 1, device=dev),
        "queries": torch.as_tensor(q_np, device=dev).to(torch.bfloat16),
        "qt": torch.as_tensor(np.ascontiguousarray(q_np.T),
                              device=dev).to(torch.bfloat16),
        "n_valid": n,
        "device": dev,
    }


def _max_work(n_pad, n_valid, q, sub, out_bytes=4):
    """(bytes, ops) of a max form: the live rows and the queries read
    once, every sub-block's output written once, a multiply-add per live
    element and query."""
    return (n_valid * D * 2 + q * D * 2 + (n_pad // sub) * q * out_bytes,
            2 * n_valid * D * q)


def _rows_work(n_pad, q):
    """(bytes, ops) of k_mm's function: the kept rows (1 of every SUB) and
    the queries read once, their f32 products written once."""
    kept = n_pad // SUB
    return kept * D * 2 + q * D * 2 + kept * q * 4, 2 * kept * D * q


def _topk_work(n_valid, q):
    """(bytes, ops) of the exact top-k's least work: the corpus and the
    queries read once, values and ids written once."""
    return n_valid * D * 2 + q * D * 2 + q * K * 8, 2 * n_valid * D * q


def _k3_work(nsel, q, sub=SUB):
    return (nsel * sub * D * 2 + q * D * 2 + nsel * 4 + nsel * sub * 4,
            2 * nsel * sub * D)


def b2_selection(inp: Dict[str, Any]) -> torch.Tensor:
    """B2's selected sub-blocks: int32[Q * K], q-major, the tiered top-k
    of phase1's table."""
    from ..ops import knn

    bmax = knn.subblock_max_only(inp["vecs"], inp["queries"], SUB,
                                 inp["n_valid"])
    return knn._tiered_subblock_topk(bmax, K).reshape(-1).to(torch.int32)


def full_with(inp, sub: int, queries_for_k3: Callable[[], torch.Tensor]):
    """The end-to-end pipeline at ``sub``: the probe max, the tiered
    selection, K3 on the queries ``queries_for_k3()`` gives, the final
    top-k -> (values f32[Q, K], ids int32[Q, K])."""
    from ..ops import knn

    v, q, nv = inp["vecs"], inp["queries"], inp["n_valid"]
    bmax = knn.subblock_max_only(v, q, sub, nv)
    sub_ids = knn._tiered_subblock_topk(bmax, K)
    out = knn.rescore_subblocks(v, queries_for_k3(), sub_ids.reshape(-1), K,
                                sub)
    return knn._final_topk(out.reshape(q.shape[0], K * sub),
                           knn._candidate_rows(sub_ids, sub), K, nv)


def mm_library(vecs: torch.Tensor, queries: torch.Tensor, bn: int = BN,
               sub: int = SUB) -> torch.Tensor:
    """k_mm's function in one PyTorch call, timed beside the kernel as its
    yardstick (the port never calls it): the kept rows' products
    [N/bn, bn/sub, Q], accumulated in f32 and returned in the inputs'
    type (bf16), where the kernel writes f32."""
    nb, d = vecs.shape[0] // bn, vecs.shape[1]
    return vecs.view(nb, bn, d)[:, :bn // sub] @ queries.T


Row = Tuple[Callable, Optional[Callable], Optional[Callable],
            Tuple[float, float]]


def row_table(inp: Dict[str, Any]) -> Dict[str, Row]:
    """row -> (the call, its plain version's call or None, the one-call
    library equivalent or None, (bytes, ops))."""
    from ..ops import knn

    v, q, qt, nv = inp["vecs"], inp["queries"], inp["qt"], inp["n_valid"]
    n_pad, qn = v.shape[0], q.shape[0]
    ids = b2_selection(inp)
    qtt = qt.T.contiguous()
    mx = knn.subblock_max_only
    mxp = knn.subblock_max_only_plain
    return {
        "phase1": (lambda: mx(v, q, SUB, nv), lambda: mxp(v, q, SUB, nv),
                   None, _max_work(n_pad, nv, qn, SUB)),
        "masklast": (lambda: mx(v, q, SUB, nv, mask="edge"),
                     lambda: mxp(v, q, SUB, nv, mask="edge"), None,
                     _max_work(n_pad, nv, qn, SUB)),
        "qt": (lambda: knn.subblock_max_only_qt(v, qt, SUB, nv),
               lambda: mxp(v, qt.T, SUB, nv), None,
               _max_work(n_pad, nv, qn, SUB)),
        "sub64": (lambda: mx(v, q, 64, nv), lambda: mxp(v, q, 64, nv), None,
                  _max_work(n_pad, nv, qn, 64)),
        "sub128": (lambda: mx(v, q, 128, nv), lambda: mxp(v, q, 128, nv),
                   None, _max_work(n_pad, nv, qn, 128)),
        # the kept rows' bytes and products: the function's own work (the
        # kernel streams and multiplies every row of the corpus)
        "mm": (lambda: knn.phase1_rows(v, q, BN, SUB),
               lambda: knn.phase1_rows_plain(v, q, BN, SUB),
               lambda: mm_library(v, q),
               _rows_work(n_pad, qn)),
        "k2": (lambda: knn.subblock_max(v, q, SUB, nv),
               lambda: knn.subblock_max_plain(v, q, SUB, nv), None,
               _max_work(n_pad, nv, qn, SUB, out_bytes=8)),
        "prescore": (lambda: knn.rescore_subblocks(v, qtt, ids, K, SUB),
                     lambda: knn.rescore_subblocks_plain(v, qtt, ids, K, SUB),
                     None, _k3_work(ids.numel(), qn)),
        "qt_transpose": (lambda: qt.T.contiguous(), None, None,
                         (2 * qt.numel() * 2, 0)),
        "sub64full": (lambda: full_with(inp, 64, lambda: q), None, None,
                      _topk_work(nv, qn)),
        "sub128full": (lambda: full_with(inp, 128, lambda: q), None, None,
                       _topk_work(nv, qn)),
        "fulltier": (lambda: full_with(inp, SUB, lambda: qt.T.contiguous()),
                     None, None, _topk_work(nv, qn)),
    }


def run(inp: Dict[str, Any], rows: Sequence[str] = ROWS,
        iters: int = 20) -> Dict[str, Any]:
    """Time ``rows`` on ``inp`` (``make_inputs``), each with its plain
    version and its library call where it has them; returns the JSON
    line's object."""
    from ..ops import _cuda

    dev = inp["device"]
    table = row_table(inp)
    unknown = [r for r in rows if r not in table]
    if unknown:
        raise ValueError(f"unknown rows {unknown}; known: {list(table)}")
    before = dict(_cuda.LAUNCHES)
    results = {}
    for name in rows:
        call, plain_call, library_call, (nbytes, ops) = table[name]
        row_before = dict(_cuda.LAUNCHES)
        ms = timing.time_ms(call, iters, dev)
        b, by = timing.bound_ms(nbytes, ops, timing.BF16_FLOPS)
        results[name] = {
            "ms": ms, "bound_ms": b, "bound_by": by,
            "share": b / ms if dev.type == "cuda" else None,
            "plain_ms": (None if plain_call is None else
                         timing.time_ms(plain_call, max(iters // 8, 2), dev)),
            "library_ms": (None if library_call is None else
                           timing.time_ms(library_call, iters, dev)),
        }
        results[name]["launches"] = {
            k: v - row_before[k] for k, v in _cuda.LAUNCHES.items()
            if v != row_before[k]}
    return {
        "bench": "knn_tune", "card": timing.card_line(dev),
        "clock": timing.clock(dev), "n": inp["n_valid"],
        "n_pad": inp["vecs"].shape[0], "d": D, "q": inp["queries"].shape[0],
        "k": K, "bn": BN, "sub": SUB, "results": results,
        "launches": {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                     if v != before[k]},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .. import configure_torch, require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--q", type=int, default=QB)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rows", default=",".join(ROWS))
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    configure_torch()
    inp = make_inputs(args.n, args.q, dev)
    out = run(inp, [r for r in args.rows.split(",") if r], args.iters)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
