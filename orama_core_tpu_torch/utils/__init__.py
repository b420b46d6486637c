"""Port of ``orama_core_tpu/utils/__init__.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``."""

import numpy as np

from .file_utils import (
    atomic_write_bytes,
    atomic_write_json,
    atomic_write_npz,
    ensure_dir,
    read_json,
    read_npz,
)


def round_up(x: int, step: int) -> int:
    if step <= 0:
        return x
    return ((x + step - 1) // step) * step


def bucket_pad(n: int, steps) -> int:
    """Smallest bucket >= n from ``steps``; multiples of the last step after.

    Bucketed padding keeps device-call shapes from a small static set so XLA
    recompiles are bounded (SURVEY.md §7 "dynamic shapes")."""
    for s in steps:
        if n <= s:
            return s
    last = steps[-1]
    return round_up(n, last)


def flatten_ranges(
    starts: np.ndarray, lens: np.ndarray, dtype=np.int64
) -> np.ndarray:
    """Vectorized concatenation of [s, s+len) ranges.

    flatten_ranges([2, 10], [3, 2]) -> [2, 3, 4, 10, 11]

    ``dtype=np.int32`` halves memory traffic when the caller knows every
    index fits (the commit repack's hot path on a bandwidth-bound host).
    """
    starts = np.asarray(starts, dtype=dtype)
    lens = np.asarray(lens, dtype=dtype)
    total = int(lens.sum(dtype=np.int64))
    if total == 0:
        return np.zeros(0, dtype=dtype)
    shifts = np.repeat(
        starts - np.concatenate((np.zeros(1, dtype), np.cumsum(lens, dtype=dtype)[:-1])),
        lens,
    )
    return shifts + np.arange(total, dtype=dtype)


__all__ = [
    "atomic_write_bytes",
    "atomic_write_json",
    "atomic_write_npz",
    "ensure_dir",
    "read_json",
    "read_npz",
    "round_up",
    "bucket_pad",
    "flatten_ranges",
]
