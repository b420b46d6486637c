"""What holds K5 back, and what its choices cost: variants of
``csrc/knn_stream.cuh`` and ``csrc/knn_subblock_max_int8.cu``, built side
by side from this checkout's sources into ``build/knn_int8_variants/``
and timed in turns on the bench's int8 corpus (``bench.py``'s 1,000,000 x
768 rows, quantized as its int8 line does, padded to its block). Each
variant is a few edits of the sources (``knn_wide_variants.prepare``):

    as_built     the sources as they are
    no_scales    each row's scale is 1 and never loaded: the most that
                 bringing the scales on the ring by TMA could save
    chunk64      at most 64 queries a pass (no m64n128k32 pass)
    ring8        the bf16 ring's 8 boxes (64 KB), so one block has an SM
                 to itself at 64 queries and D = 768
    no_epilogue  the epilogue returns at once: the mainloop alone
    no_products  no wgmma: the loads and the epilogue alone

Rows per variant: K5 at Q = 1, 8, 64, 128 and 256 (sub 32); every
variant in turn, twice. ``as_built``, ``chunk64`` and ``ring8`` are held
to the plain version first (bit for bit).

    python -m orama_core_tpu_torch.tools.knn_int8_variants [--iters 20]

It needs the card and ``nvcc``, and prints one JSON line, ``{"bench":
"knn_int8_variants", "card": ..., "ms": {variant: {row: [ms, ms]}},
"bound_ms": {row: ms}, "exact": {variant: bool}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import knn_wide_variants as kwv
from . import timing

_CORE, _K5 = "knn_stream.cuh", "knn_subblock_max_int8.cu"
_SCALES = ("      s_lo = r_lo < n_valid ? scales[r_lo] : 0.0f;\n"
           "      s_hi = r_lo + 8 < n_valid ? scales[r_lo + 8] : 0.0f;\n")
_TILE = "  __device__ void tile(Acc<NQ, E>& acc, long long row) {\n"
_MMA = "      Mma<NQ, E>::run(acc.d, da + 2 * k, db + 2 * k);\n"
_CHUNK = "constexpr int kMaxChunkInt8 = 128;"
# variant -> (file, text, replacement, occurrences)
VARIANTS: Dict[str, List[Tuple[str, str, str, int]]] = {
    "as_built": [],
    "no_scales": [(_CORE, _SCALES, "      s_lo = s_hi = 1.0f;\n", 1)],
    "chunk64": [(_K5, _CHUNK, "constexpr int kMaxChunkInt8 = 64;", 1)],
    "ring8": [(_CORE, "  static constexpr int kStages = 6;\n",
               "  static constexpr int kStages = 8;\n", 1)],
    "no_epilogue": [(_CORE, _TILE, _TILE + "    if (row >= 0) return;\n",
                     1)],
    "no_products": [(_CORE, _MMA, "", 1)],
}
EXACT = ("as_built", "chunk64", "ring8")
QUERIES = (1, 8, 64, 128, 256)


def make_inputs(device="cuda"):
    """The bench's int8 corpus and its n_valid: codes int8[n_pad, D],
    scales f32[n_pad]."""
    from .. import bench
    from ..ops import quant
    from ..utils.benchgen import hashed_unit_corpus

    n_pad = -(-bench.N // bench.BN) * bench.BN
    codes, scales = quant.quantize_int8(
        hashed_unit_corpus(n_pad, bench.D, 1, device=device).to(
            torch.float32))
    return codes, scales, bench.N


def run(codes, scales, n_valid, libs: Dict[str, str],
        iters: int = 20) -> Dict:
    """Times every variant's rows in turns, twice."""
    import numpy as np

    from ..ops import _cuda, knn, quant

    n, d = codes.shape
    loaded = {name: kwv.load(path, "knn_subblock_max_int8")
              for name, path in libs.items()}
    rng = np.random.default_rng(5)
    q8s = {q: quant.quantize_int8(torch.as_tensor(
        rng.standard_normal((q, d)).astype(np.float32),
        device=codes.device))[0] for q in QUERIES}

    def call(lib, q8):
        bmax = torch.empty(n // 32, q8.shape[0], dtype=torch.float32,
                           device=codes.device)
        bcnt = torch.empty(n // 32, q8.shape[0], dtype=torch.int32,
                           device=codes.device)

        def f():
            _cuda.check(lib.knn_subblock_max_int8(
                codes.data_ptr(), scales.data_ptr(), q8.data_ptr(),
                bmax.data_ptr(), bcnt.data_ptr(), n, d, q8.shape[0], 32,
                n_valid, _cuda.stream()), "knn_subblock_max_int8")
            return bmax, bcnt
        return f

    exact = {}
    for name in EXACT:
        if name in loaded:
            exact[name] = True
            for q8 in q8s.values():
                got = call(loaded[name], q8)()
                want = knn.subblock_max_int8_plain(codes, scales, q8, 32,
                                                   n_valid)
                exact[name] &= bool(torch.equal(got[0], want[0])
                                    and torch.equal(got[1], want[1]))
    ms: Dict[str, Dict[str, List[float]]] = {}
    for _ in range(2):
        for name, lib in loaded.items():
            for q, q8 in q8s.items():
                ms.setdefault(name, {}).setdefault(f"Q={q}", []).append(
                    timing.time_ms(call(lib, q8), iters, codes.device))
    bound = {}
    for q in QUERIES:
        b, _ = timing.bound_ms(
            n_valid * d + n_valid * 4 + q * d + (n // 32) * q * 8,
            2 * n_valid * d * q, timing.INT8_OPS)
        bound[f"Q={q}"] = b
    return {"bench": "knn_int8_variants",
            "card": timing.card_line(codes.device),
            "clock": timing.clock(codes.device), "ms": ms,
            "bound_ms": bound, "exact": exact}


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .. import configure_torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("knn_int8_variants: needs a CUDA card", file=sys.stderr)
        return 2
    configure_torch()
    libs = kwv.build(tuple(VARIANTS), VARIANTS, _K5, "knn_int8_variants")
    out = run(*make_inputs(), libs, args.iters)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
