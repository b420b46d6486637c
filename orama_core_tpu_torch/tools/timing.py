"""Timing and bounds of every kernel record: ``chip_smoke.py``'s and the
kernel probes' (``knn_tune_bench``, ``bm25_scan_bench``), so that every
row of one kernels line is measured with one yardstick; and the helpers of
the entry-point benchmarks (``orama_core_tpu_torch.bench`` and the
BASELINE-config tools): their stderr log, their host-clock rate and
recall@k.

On the card a call's time is device time: CUDA events around ``iters``
calls queued behind a spin kernel, so the events bracket the device's
work and not the host's launch overhead. On the CPU (``--device cpu``,
small shapes, to rehearse the probes' control flow) it is host time, and
the JSON line says so (``"clock": "host"``): it is no device number.
A bound is the least time an H100 SXM could take for a call's work: the
larger of its bytes over the memory's rate and its operations over the
peak rate of their type (NVIDIA's data sheet).
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12        # dense bf16 tensor cores
F32_FLOPS = 67e12          # f32 outside the tensor cores
INT8_OPS = 1979e12         # dense int8 tensor cores


def bound_ms(bytes_moved: float, ops: float,
             peak_ops: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line(device: Union[str, torch.device] = "cuda") -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else torch.cuda.get_device_name(device)


def clock(device: Union[str, torch.device]) -> str:
    return "cuda events" if torch.device(device).type == "cuda" else "host"


def time_ms(fns: Union[Callable, Sequence[Callable]], iters: int,
            device: Union[str, torch.device] = "cuda") -> float:
    """ms per call, cycling through ``fns`` (one warm-up call each first;
    several callables on inputs whose joint footprint exceeds the 50 MB L2
    time the calls cold, where the engine would find their inputs so). On
    the card a spin kernel holds the stream while the host queues all the
    calls, so the CUDA events bracket device work only, not the host's
    launch overhead."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    for f in fns:
        f()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        return (time.perf_counter() - t0) * 1e3 / iters
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


def log(*a) -> None:
    """A line on stderr: stdout carries only a benchmark's JSON lines."""
    print(*a, file=sys.stderr, flush=True)


def timed_qps(step: Callable, n_queries: int, iters: int,
              device: Union[str, torch.device]) -> Tuple[float, float]:
    """(queries/s, ms a call) of ``iters`` back-to-back ``step()`` calls,
    after one warm-up call: host clock around the loop, closed by a
    synchronise on the card."""
    cuda = torch.device(device).type == "cuda"
    step()
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    if cuda:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    return n_queries * iters / dt, dt / iters * 1e3


def recall_at_k(got, want, k: int = 10) -> float:
    """Mean over queries of |got & want| / k (rows of ids: arrays or
    lists)."""
    return float(np.mean([len(set(g) & set(w)) / k
                          for g, w in zip(got, want)]))
