"""What holds B1's one-pass kernels back: variants of ``csrc/knn_wide.cuh``
and ``csrc/knn_phase1_variants.cu``, built side by side from this
checkout's sources into ``build/knn_wide_variants/`` and timed in turns on
B1's inputs (``tools.knn_tune_bench.make_inputs``: 1,000,000 x 768 bf16,
256 queries). Each variant is a few edits of the sources:

    as_built      the sources as they are
    cluster1      clusters of one block, each loading its whole query box
    cluster4      clusters of four, each block a quarter of every box
    no_setmaxnreg the consumers keep the launch's 168 registers a thread
    no_epilogue   every epilogue returns at once: the mainloop alone
    no_products   no wgmma: the loads and the epilogues alone

Rows per variant: the max form (every row masked) at sub 32, 64 and 128
with Q = 256, at sub 32 with Q = 64, and k_mm at Q = 256; every variant
in turn, twice. The variants that compute (``as_built``, ``cluster1``,
``cluster4``, ``no_setmaxnreg``) are held to the plain versions first.
Beside them, ``torch.matmul`` over k_mm's kept rows
(``knn_tune_bench.mm_library``).

    python -m orama_core_tpu_torch.tools.knn_wide_variants [--iters 20]

It needs the card and ``nvcc``, and prints one JSON line, ``{"bench":
"knn_wide_variants", "card": ..., "ms": {variant: {row: [ms, ms]}},
"max_abs_err": {variant: err}, "library_ms": {"mm": ms}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import timing

_WIDE, _VAR = "knn_wide.cuh", "knn_phase1_variants.cu"
_CLUSTER = "constexpr int kCluster = 2;"
_TILE = "  __device__ void tile(Acc<N>& acc, long long row) {\n"
_MMA = ("      WideMma<N, kTransB>::run(acc.d, da + 2 * k,\n"
        "                               db + (kTransB ? 128 : 2) * k);\n")
_SETMAXNREG = ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");\n',
               '    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");\n')
# variant -> (file, text, replacement, occurrences)
VARIANTS: Dict[str, List[Tuple[str, str, str, int]]] = {
    "as_built": [],
    "cluster1": [(_WIDE, _CLUSTER, "constexpr int kCluster = 1;", 1)],
    "cluster4": [(_WIDE, _CLUSTER, "constexpr int kCluster = 4;", 1)],
    "no_setmaxnreg": [(_WIDE, line, "", 1) for line in _SETMAXNREG],
    "no_epilogue": [(_VAR, _TILE, _TILE + "    if (row >= 0) return;\n", 2)],
    "no_products": [(_WIDE, _MMA, "", 1)],
}
COMPUTING = ("as_built", "cluster1", "cluster4", "no_setmaxnreg")


def prepare(name: str, out: str, variants=None) -> str:
    """The variant's sources: this checkout's csrc/ copied to
    ``out/<name>/`` and edited (``variants``: this tool's VARIANTS, or
    another tool's table of the same form); returns the directory. Raises
    if a source no longer holds the text an edit replaces."""
    from ..ops import _cuda

    src = os.path.join(out, name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src)
    for fn, old, new, count in (variants or VARIANTS)[name]:
        path = os.path.join(src, fn)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {fn} no longer holds the text the "
                               f"variant edits ({old[:40]!r})")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text.replace(old, new))
    return src


def build(names: Sequence[str] = tuple(VARIANTS), variants=None,
          source: str = _VAR, where: str = "knn_wide_variants"
          ) -> Dict[str, str]:
    """Every variant prepared under build/<where>/ and its ``source``
    compiled with the kernels' flags, all at once -> {name: library}."""
    from ..ops import _cuda

    out = os.path.join(os.path.dirname(_cuda.BUILD), where)
    procs = {}
    for name in names:
        src = prepare(name, out, variants)
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib,
             os.path.join(src, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        libs[name] = lib
    return libs


def load(path: str, library: str = "knn_phase1_variants") -> ctypes.CDLL:
    """A variant's library with the entry points of ``library``'s row in
    ``_cuda.SIGNATURES``."""
    from ..ops import _cuda

    lib = ctypes.CDLL(path)
    for fn, argtypes in _cuda.SIGNATURES[library].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def run(inp, libs: Dict[str, str], iters: int = 20) -> Dict:
    """Times every variant's rows on ``inp`` in turns, twice."""
    from ..ops import _cuda, knn
    from . import knn_tune_bench as kb

    v, q, nv = inp["vecs"], inp["queries"], inp["n_valid"]
    n, d = v.shape
    keep = kb.BN // kb.SUB
    loaded = {name: load(path) for name, path in libs.items()}

    def max_call(lib, qs, sub):
        out = torch.empty(n // sub, qs.shape[0], dtype=torch.float32,
                          device=v.device)

        def f():
            _cuda.check(lib.knn_max_only(
                v.data_ptr(), qs.data_ptr(), out.data_ptr(), n, d,
                qs.shape[0], sub, nv, 0, _cuda.stream()), "knn_max_only")
            return out
        return f

    def rows_call(lib):
        out = torch.empty(n // kb.BN * keep, q.shape[0], dtype=torch.float32,
                          device=v.device)

        def f():
            _cuda.check(lib.knn_phase1_rows(
                v.data_ptr(), q.data_ptr(), out.data_ptr(), n, d, q.shape[0],
                kb.BN, keep, _cuda.stream()), "knn_phase1_rows")
            return out
        return f

    q64 = q[:64].contiguous()
    rows = {
        **{f"max_sub{s}": (lambda lib, s=s: max_call(lib, q, s))
           for s in knn.PROBE_SUBS},
        "max_sub32_q64": lambda lib: max_call(lib, q64, 32),
        "mm": rows_call,
    }
    errs = {}
    want_max = knn.subblock_max_only_plain(v, q, kb.SUB, nv)
    want_rows = knn.phase1_rows_plain(v, q, kb.BN, kb.SUB)
    for name in COMPUTING:
        if name in loaded:
            lib = loaded[name]
            errs[name] = max(
                (max_call(lib, q, kb.SUB)() - want_max).abs().max().item(),
                (rows_call(lib)() - want_rows).abs().max().item())
    del want_max, want_rows
    ms: Dict[str, Dict[str, List[float]]] = {}
    for _ in range(2):
        for name, lib in loaded.items():
            for row, make in rows.items():
                ms.setdefault(name, {}).setdefault(row, []).append(
                    timing.time_ms(make(lib), iters, v.device))
    return {"bench": "knn_wide_variants", "card": timing.card_line(v.device),
            "clock": timing.clock(v.device), "ms": ms, "max_abs_err": errs,
            "library_ms": {"mm": timing.time_ms(lambda: kb.mm_library(v, q),
                                                iters, v.device)}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .. import configure_torch
    from . import knn_tune_bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("knn_wide_variants: needs a CUDA card", file=sys.stderr)
        return 2
    configure_torch()
    libs = build()
    out = run(knn_tune_bench.make_inputs(), libs, args.iters)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
