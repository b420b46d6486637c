"""The doc-tile scan's sweep and what holds it back: variants of
``csrc/bm25_tiles.cuh`` (B3's core), built side by side from this
checkout's sources into ``build/bm25_tile_variants/`` and timed in turns
on B3's data (``tools.bm25_scan_bench.zipf_postings``: ~998k Zipf
postings over 1,048,576 docs, four copies of the planes cycled past L2).
Each variant is a few edits of the header:

    as_built        the sources as they are
    t<T>_w<W>       tiles of T docs (2,048, 4,096, 8,192, 16,384) and
                    blocks of W threads (256, 512, 1,024): the sweep that
                    chose the header's kTileDocs and kThreads
    ahead<A>        A chunks of loads in flight a warp in both forms (1,
                    2, 4; as built 1 for four planes, 2 packed)
    red_shared      the add as PTX red.shared.add.f32, in place of
                    atomicAdd
    loads_only      every load and check, no math and no add
    shared_exch     atomicExch in place of the shared atomicAdd: the same
                    traffic with a native shared atomic (wrong sums)
    no_write        no store of the tile: the row is left as it was
    no_atomic       a plain shared store in place of the atomicAdd (wrong
                    sums): what the compare-and-swap loop costs
    no_stream       no run streamed: plan walk, end docs, searches, stores
    walk_only       no_stream without the searches: plan walk, end docs,
                    stores
    write_only      no plan walk at all: the tile's zeros and its stores
    empty           every block returns at once: the launch alone

Rows per variant: the four-plane and packed forms at plan blocks of 1,024,
4,096 and 8,192 (``pl4_*``, ``plp_*``); every variant in turn, twice.
The variants that compute (the sweep, ``as_built``, ``ahead*``,
``red_shared``) are held
to the plain versions first (rtol 1e-5, atol 1e-6) and must repair no
call. Beside them: what ptxas says of the as-built kernels (registers,
spills) and the opcodes of its atomics in the SASS (``cuobjdump
-sass``: ATOMS on shared memory, RED on global, the repair path's), to
show whether the shared f32 add is native or a compare-and-swap loop.

    python -m orama_core_tpu_torch.tools.bm25_tile_variants [--iters 40]

It needs the card and ``nvcc``, and prints one JSON line, ``{"bench":
"bm25_tile_variants", "card": ..., "ms": {variant: {row: [ms, ms]}},
"max_abs_err": {variant: err}, "repairs": {variant: n}, "ptxas": [...],
"atomics": {opcode: count}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import timing

_HDR, _SRC = "bm25_tiles.cuh", "bm25_scan_variants.cu"
SWEEP_TILES = (2048, 4096, 8192, 16384)
SWEEP_THREADS = (256, 512, 1024)
AHEADS = (1, 2, 4)
_NO_REPAIR = (_HDR, "bad) && tid == 0 && atomicExch(",
              "bad) && tid < 0 && atomicExch(")
_NO_STREAM = (_HDR, "      bad |= accumulate<kPacked>(",
              "      bad |= false && accumulate<kPacked>(")
_ACC = "  float* acc = reinterpret_cast<float*>(smem4);\n"
_NO_SEARCH = (_HDR, "      for (int j = warp; j < n_search; j += kWarps) {",
              "      for (int j = warp; j < 0; j += kWarps) {")


def _sweep(tile: int, threads: int) -> List[Tuple[str, str, str]]:
    return [(_HDR, r"constexpr int kTileDocs = \d+;",
             f"constexpr int kTileDocs = {tile};"),
            (_HDR, r"constexpr int kThreads = \d+;",
             f"constexpr int kThreads = {threads};")]


# variant -> [(file, regex, replacement)], each regex found exactly once
VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    "as_built": [],
    **{f"t{t}_w{w}": _sweep(t, w) for t in SWEEP_TILES for w in SWEEP_THREADS},
    **{f"ahead{a}": [(_HDR, rf"constexpr int kAhead{form} = \d+;",
                      f"constexpr int kAhead{form} = {a};")
                     for form in ("Wide", "Packed")] for a in AHEADS},
    "red_shared": [(_HDR, re.escape(
        "atomicAdd(&acc[local], __fdividef(idf * tt[e] * num1, den));"),
        'asm volatile("red.shared.add.f32 [%0], %1;" :: "r"((unsigned)'
        "__cvta_generic_to_shared(&acc[local])), "
        '"f"(__fdividef(idf * tt[e] * num1, den)) : "memory");')],
    "loads_only": [(_HDR, re.escape(
        "atomicAdd(&acc[local], __fdividef(idf * tt[e] * num1, den));"),
        "if (__float_as_uint(tt[e] + ll[e] + (kPacked ? 0.0f : nn[e])) == 7u)"
        " acc[local] = 0.0f;")],
    "shared_exch": [(_HDR, re.escape("atomicAdd(&acc[local], "),
                     "atomicExch(&acc[local], ")],
    "no_write": [(_HDR, re.escape(
        "        *reinterpret_cast<float4*>(scores + base + i) = v;\n"), "")],
    "no_atomic": [(_HDR, re.escape(
        "atomicAdd(&acc[local], __fdividef(idf * tt[e] * num1, den));"),
        "acc[local] = __fdividef(idf * tt[e] * num1, den);")],
    "no_stream": [(f, re.escape(old), new) for f, old, new in
                  (_NO_STREAM, _NO_REPAIR)],
    "walk_only": [(f, re.escape(old), new) for f, old, new in
                  (_NO_STREAM, _NO_SEARCH, _NO_REPAIR)],
    "write_only": [(_HDR, re.escape("    for (int w0 = 0;; w0 += kWindows) {"),
                    "    for (int w0 = 0; w0 < 0; w0 += kWindows) {")],
    "empty": [(_HDR, re.escape(_ACC),
               "  if (n_blocks >= 0) return;\n" + _ACC)],
}
COMPUTING = ("as_built", "red_shared") + tuple(
    f"ahead{a}" for a in AHEADS) + tuple(
    f"t{t}_w{w}" for t in SWEEP_TILES for w in SWEEP_THREADS)
ROWS = tuple(f"{form}_{blk}" for form in ("pl4", "plp")
             for blk in (1024, 4096, 8192))


def prepare(name: str, out: str) -> str:
    """The variant's sources: this checkout's csrc/ copied to
    ``out/<name>/`` and edited; returns the directory. Raises if a source
    no longer holds exactly one match of an edit's pattern."""
    from ..ops import _cuda

    src = os.path.join(out, name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src)
    for fn, pattern, new in VARIANTS[name]:
        path = os.path.join(src, fn)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if len(re.findall(pattern, text)) != 1:
            raise RuntimeError(f"{name}: {fn} no longer holds the text the "
                               f"variant edits ({pattern[:40]!r})")
        with open(path, "w", encoding="utf-8") as f:
            f.write(re.sub(pattern, lambda _m: new, text))
    return src


def build(names: Sequence[str] = tuple(VARIANTS)) -> Tuple[Dict[str, str],
                                                           str]:
    """Every variant prepared under build/bm25_tile_variants/ and compiled
    with the kernels' flags (ptxas verbose), all at once -> ({name:
    library}, the as-built variant's ptxas output)."""
    from ..ops import _cuda

    out = os.path.join(os.path.dirname(_cuda.BUILD), "bm25_tile_variants")
    procs = {}
    for name in names:
        src = prepare(name, out)
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            _cuda.nvcc_command("bm25_scan_variants", os.path.join(src, _SRC),
                               lib, ("-Xptxas", "-v")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, ""
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        libs[name] = lib
        if name == "as_built":
            ptxas = log
    return libs, ptxas


def atomics(lib: str) -> Dict[str, int]:
    """Opcode -> count of the atomics (ATOMS: shared memory) and
    reductions (RED: global) in ``lib``'s SASS."""
    from ..ops import _cuda

    objdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([objdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    counts: Dict[str, int] = {}
    for op in re.findall(r"\b(ATOMS\.[A-Z0-9.]+|ATOMS|RED\.[A-Z0-9.]+)\b",
                         text):
        counts[op] = counts.get(op, 0) + 1
    return counts


def _load(path: str) -> ctypes.CDLL:
    from ..ops import _cuda

    lib = ctypes.CDLL(path)
    for fn, argtypes in _cuda.SIGNATURES["bm25_scan_variants"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _repairs(lib: ctypes.CDLL) -> int:
    from ..ops import _cuda

    out = ctypes.c_ulonglong(0)
    _cuda.check(lib.bm25_scan_repairs(ctypes.addressof(out), _cuda.stream()),
                "bm25_scan_repairs")
    return int(out.value)


def run(data, libs: Dict[str, str], iters: int = 40) -> Dict:
    """Times every variant's rows on ``data`` in turns, twice."""
    from ..ops import _cuda, bm25
    from . import bm25_scan_bench as sb

    dev = torch.device("cuda")
    n_docs = data["n_docs"]
    scal = (float(data["boost"]), float(data["avgdl"]), float(data["nfd"]))
    planes = [{k: torch.as_tensor(data[k], device=dev) for k in
               ("post_docs", "post_tf", "post_ni", "post_lens", "packed")}
              for _ in range(sb.COPIES)]
    plans = {}
    for blk in bm25.SCAN_BLOCKS:
        bi, lo, hi, ni_b = sb.plans(data, blk)
        plans[blk] = ([torch.as_tensor(a, device=dev) for a in (bi, lo, hi)],
                      torch.as_tensor(ni_b.astype("int32"), device=dev))
    loaded = {name: _load(path) for name, path in libs.items()}

    def call(lib, form, blk, p):
        plan, ni_i32 = plans[blk]
        out = torch.empty(n_docs, dtype=torch.float32, device=dev)
        if form == "pl4":
            err = lib.bm25_scan_wide(
                *[p[k].data_ptr() for k in ("post_docs", "post_tf",
                                            "post_ni", "post_lens")],
                *[t.data_ptr() for t in plan], *scal, out.data_ptr(),
                len(plan[0]), n_docs, blk, _cuda.stream())
        else:
            err = lib.bm25_scan_packed(
                p["post_docs"].data_ptr(), p["packed"].data_ptr(),
                *[t.data_ptr() for t in plan], ni_i32.data_ptr(), *scal,
                out.data_ptr(), len(plan[0]), n_docs, blk, _cuda.stream())
        _cuda.check(err, f"{form}_{blk}")
        return out

    errs, repairs = {}, {}
    for name in COMPUTING:
        if name not in loaded:
            continue
        lib = loaded[name]
        before = _repairs(lib)
        err = 0.0
        for row in ROWS:
            form, blk = row.split("_")
            blk = int(blk)
            plan, ni_i32 = plans[blk]
            p = planes[0]
            if form == "pl4":
                want = bm25.bm25_scan_wide_plain(
                    p["post_docs"], p["post_tf"], p["post_ni"],
                    p["post_lens"], *plan, *scal, n_docs, blk)
            else:
                want = bm25.bm25_scan_packed_plain(
                    p["post_docs"], p["packed"], *plan, ni_i32, *scal,
                    n_docs, blk)
            got = call(lib, form, blk, p)
            err = max(err, (got - want).abs().max().item())
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
                raise RuntimeError(f"{name} {row} disagrees with the plain "
                                   f"version: max err {err}")
        errs[name] = err
        repairs[name] = _repairs(lib) - before
        if repairs[name]:
            raise RuntimeError(f"{name} repaired {repairs[name]} calls on "
                               "ascending windows")
    ms: Dict[str, Dict[str, List[float]]] = {}
    for _ in range(2):
        for name, lib in loaded.items():
            for row in ROWS:
                form, blk = row.split("_")
                ms.setdefault(name, {}).setdefault(row, []).append(
                    timing.time_ms(
                        [lambda p=p, lib=lib, form=form, blk=int(blk):
                         call(lib, form, blk, p) for p in planes],
                        iters, dev))
    return {"bench": "bm25_tile_variants", "card": timing.card_line(dev),
            "clock": timing.clock(dev), "ms": ms, "max_abs_err": errs,
            "repairs": repairs}


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .. import configure_torch
    from . import bm25_scan_bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bm25_tile_variants: needs a CUDA card", file=sys.stderr)
        return 2
    configure_torch()
    libs, ptxas = build()
    out = run(bm25_scan_bench.zipf_postings(), libs, args.iters)
    out["ptxas"] = [line.strip() for line in ptxas.splitlines()
                    if "registers" in line or "spill" in line]
    out["atomics"] = atomics(libs["as_built"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
