"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled on first use into its own plain-C
shared library, ``build/torch_kernels/lib<name>.so`` under the repository
root (git ignores ``build/``), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

and bound with ``ctypes``: pointers and the stream travel as ``c_void_p``,
every entry point returns ``cudaGetLastError()`` and ``check`` raises when
it is not 0. ``build_all`` starts one ``nvcc`` per source at once, so a
cold process pays the slowest build, not their sum. A library is rebuilt
when its ``.cu`` or any shared header ``csrc/*.cuh`` is newer than it.

The library whose kernel launches another (``DEVICE_LAUNCHES``) is also
built with ``-rdc=true`` and linked with ``-lcudadevrt``.

``LAUNCHES`` counts kernel launches per kernel; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "torch_kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# libraries whose kernels launch kernels: relocatable device code, linked
# with the device runtime (B3's repair is a tail launch)
DEVICE_LAUNCHES = ("bm25_scan_variants",)

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "bm25_scan": 0,
    "knn_subblock_max": 0,
    "knn_rescore": 0,
    "phrase_counts": 0,
    "knn_subblock_max_int8": 0,
    "knn_subblock_max_mv": 0,
    "knn_dense_scores": 0,
    # the probe forms of benchmarks/ (tools/knn_tune_bench.py,
    # tools/bm25_scan_bench.py)
    "knn_max_only": 0,
    "knn_max_only_edge": 0,
    "knn_max_only_qt": 0,
    "knn_phase1_rows": 0,
    "bm25_scan_wide": 0,
    "bm25_scan_packed": 0,
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argument types of each library's entry points
SIGNATURES: Dict[str, Dict[str, List]] = {
    "bm25_scan": {
        # docs, tf, ni, lens, blk, lo, hi, row_id (NULL for one row), then
        # boost, avgdl and nfd as pointers to 0-d f32 on the card (or NULL)
        # and as values (read where the pointer is NULL), scores, n_blocks,
        # n_docs, stream
        "bm25_scan": [_P] * 11 + [_F] * 3 + [_P, _I, _L, _P],
    },
    "knn_subblock_max": {
        # vecs, queries, bmax, bcnt, n, d, q, sub, n_valid, stream
        "knn_subblock_max": [_P] * 4 + [_L, _I, _I, _I, _L, _P],
    },
    "knn_rescore": {
        # vecs, queries, ids, out, nsel, d, q, k, sub, stream
        "knn_rescore": [_P] * 4 + [_I, _I, _I, _I, _I, _P],
    },
    "phrase_counts": {
        # bits, terms, doc_bounds, spans, any, seq, pp, n_spans, n_docs,
        # stream
        "phrase_counts": [_P] * 6 + [_L, _I, _I, _P],
    },
    "knn_subblock_max_int8": {
        # codes, scales, q8, bmax, bcnt, n, d, q, sub, n_valid, stream
        "knn_subblock_max_int8": [_P] * 5 + [_L, _I, _I, _I, _L, _P],
    },
    "knn_subblock_max_mv": {
        # vecs, row_docs, queries, bmax, bcnt, n, d, q, sub, n_valid,
        # m_max, stream
        "knn_subblock_max_mv": [_P] * 5 + [_L, _I, _I, _I, _L, _I, _P],
    },
    "knn_dense_scores": {
        # vecs, queries, valid, mask, out, rows, n_docs, d, q, stream
        "knn_dense_scores": [_P] * 5 + [_L, _L, _I, _I, _P],
    },
    "knn_phase1_variants": {
        # vecs, queries (or qt), bmax, n, d, q, sub, n_valid, form, stream
        "knn_max_only": [_P] * 3 + [_L, _I, _I, _I, _L, _I, _P],
        # vecs, queries, out, n, d, q, bn, keep, stream
        "knn_phase1_rows": [_P] * 3 + [_L, _I, _I, _I, _I, _P],
    },
    "bm25_scan_variants": {
        # docs, tf, ni, lens, blk, lo, hi, boost, avgdl, nfd, scores,
        # n_blocks, n_docs, block, stream
        "bm25_scan_wide": [_P] * 7 + [_F] * 3 + [_P, _I, _L, _I, _P],
        # docs, packed, blk, lo, hi, ni_blk, boost, avgdl, nfd, scores,
        # n_blocks, n_docs, block, stream
        "bm25_scan_packed": [_P] * 6 + [_F] * 3 + [_P, _I, _L, _I, _P],
        # out (host u64), stream: the calls the doc-tile check repaired
        "bm25_scan_repairs": [_P, _P],
    },
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str):
    return os.path.join(CSRC, f"{name}.cu"), os.path.join(BUILD, f"lib{name}.so")


def _fresh(name: str, csrc: str = CSRC, build: str = BUILD) -> bool:
    """True when ``lib<name>.so`` is newer than its ``.cu`` and than every
    shared header (``csrc/*.cuh``) it may include."""
    lib = os.path.join(build, f"lib{name}.so")
    if not os.path.exists(lib):
        return False
    deps = [os.path.join(csrc, f"{name}.cu")] + glob.glob(
        os.path.join(csrc, "*.cuh"))
    built = os.path.getmtime(lib)
    return all(built >= os.path.getmtime(p) for p in deps)


def nvcc_command(name: str, src: str, out: str,
                 extra: Sequence[str] = ()) -> List[str]:
    """The nvcc command that builds library ``name`` from ``src`` into
    ``out`` (``extra`` flags before the source)."""
    if name not in DEVICE_LAUNCHES:
        return [_nvcc(), *NVCC_FLAGS, *extra, "-o", out, src]
    return [_nvcc(), *NVCC_FLAGS, "-rdc=true", *extra, "-o", out, src,
            "-lcudadevrt"]


def _start_build(name: str) -> subprocess.Popen:
    src, lib = _paths(name)
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    return subprocess.Popen(
        nvcc_command(name, src, tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    src, lib = _paths(name)
    tmp = f"{lib}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{out}")
    os.replace(tmp, lib)


def build_all(names: Sequence[str] = tuple(SIGNATURES),
              force: bool = False) -> None:
    """Compile every stale kernel library (every one with ``force``), one
    nvcc per source, all started at once."""
    with _lock:
        procs = {
            n: _start_build(n) for n in names if force or not _fresh(n)
        }
        errors = []
        for n, p in procs.items():
            try:
                _finish_build(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if stale)."""
    hit = _libs.get(name)
    if hit is not None:
        return hit
    build_all([name])
    with _lock:
        if name not in _libs:
            dll = ctypes.CDLL(_paths(name)[1])
            for fn, argtypes in SIGNATURES[name].items():
                getattr(dll, fn).argtypes = argtypes
                getattr(dll, fn).restype = ctypes.c_int
            _libs[name] = dll
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def scalar_arg(x, device):
    """A float kernel argument that is a Python number or a 0-d tensor:
    (tensor to keep alive, its pointer, 0.0) for a tensor, moved to
    ``device`` as f32 if it is not there already, and (None, None, x) for
    a number, which travels by value with no upload."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=torch.float32).reshape(())
        return t, t.data_ptr(), 0.0
    return None, None, float(x)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given type."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
