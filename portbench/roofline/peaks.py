"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), and a kernel's least time on them.

The same numbers as ``orama_core_tpu_torch/tools/timing.py``, copied so
that the benchmark's yardstick does not move with the program.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12   # outside the tensor cores


def bound_s(bytes_moved: float, ops: float, peak_ops: float) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
