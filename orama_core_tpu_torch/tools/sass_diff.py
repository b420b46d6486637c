"""Compare the machine code (SASS) of K1, K2 and K6 with another tree's.

K2 (``csrc/knn_subblock_max.cu``) and K6 (``csrc/knn_subblock_max_mv.cu``)
share ``csrc/knn_stream.cuh`` with the phase-1 probe forms
(``csrc/knn_phase1_variants.cu``), and K1 (``csrc/bm25_scan.cu``) shares
its loop (``csrc/bm25_scan.cuh``) with the scan probe forms
(``csrc/bm25_scan_variants.cu``). A change to a shared header meant for
the probes must leave K1, K2 and K6 as they were; this tool shows whether
it did. It compiles each of the three sources of this checkout and of
``OTHER`` (a directory holding ``orama_core_tpu_torch/csrc/`` or the
``csrc`` directory itself, e.g. a ``git archive`` export of the parent
commit unpacked under ``build/``) to a cubin with the build's flags,
disassembles both with ``cuobjdump -sass``, and compares the instruction
lines:

    python -m orama_core_tpu_torch.tools.sass_diff OTHER

It prints one JSON line, ``{source: {"this": instructions, "other":
instructions, "identical": bool}}``, and exits 0 when every pair is
identical, 1 otherwise. It needs the CUDA toolkit (``nvcc``,
``cuobjdump``), not a card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

SOURCES = ("knn_subblock_max", "knn_subblock_max_mv", "bm25_scan")
# an instruction line of cuobjdump -sass: /*0040*/ followed by the opcode
_INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _csrc(root: str) -> str:
    inner = os.path.join(root, "orama_core_tpu_torch", "csrc")
    return inner if os.path.isdir(inner) else root


def _sass(nvcc: str, src: str, out_dir: str, tag: str) -> List[str]:
    """The instruction lines of ``src`` compiled for sm_90a."""
    from ..ops import _cuda

    cubin = os.path.join(out_dir, f"{tag}.cubin")
    flags = [f for f in _cuda.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, src], check=True,
                   capture_output=True, text=True)
    objdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([objdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    return [m.group(1) for m in map(_INSTR.match, text.splitlines()) if m]


def compare(other: str) -> Dict[str, Dict]:
    from ..ops import _cuda

    nvcc = _cuda._nvcc()
    trees = {"this": _cuda.CSRC, "other": _csrc(other)}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor() as pool:
        jobs = {(name, side): pool.submit(
                    _sass, nvcc, os.path.join(csrc, f"{name}.cu"), tmp,
                    f"{side}_{name}")
                for name in SOURCES for side, csrc in trees.items()}
        sass = {key: job.result() for key, job in jobs.items()}
    return {name: {"this": len(sass[name, "this"]),
                   "other": len(sass[name, "other"]),
                   "identical": sass[name, "this"] == sass[name, "other"]}
            for name in SOURCES}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    out = compare(args[0])
    print(json.dumps(out), flush=True)
    return 0 if all(r["identical"] for r in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
