"""Synthetic benchmark corpora from a counter-based integer hash.

Port of ``orama_core_tpu/utils/benchgen.py``: the same rows, element for
element. Each element hashes its flat index ``row * d + col`` (uint32,
wrapping) with the salt four times; the four uniforms are summed in the
reference's order (Irwin-Hall(4), shifted by 2), and each row is
L2-normalized. torch has no uint32 arithmetic, so the hash runs in int64
masked to 32 bits after every step that can carry past them: the low 32
bits of a wrapped int64 product are the uint32 product's.

No kernel: a few elementwise passes, made on ``device`` (the card unless
the caller names another) a block of rows at a time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROWS_PER_BLOCK = 1 << 16  # int64 temporaries of one block: 8 B x d each


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 15)
    x = (x * 2246822519) & _MASK
    x = x ^ (x >> 13)
    x = (x * 3266489917) & _MASK
    return x ^ (x >> 16)


def hashed_unit_corpus(n_pad: int, d: int, salt: int,
                       dtype: torch.dtype = torch.bfloat16, device="cuda",
                       rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """[n_pad, d] L2-normalized pseudo-random rows, deterministic in
    (d, salt) and the row index, on ``device`` in ``dtype``. ``rows``
    = (start, stop) makes only those rows of the corpus (the same values
    as the whole corpus's rows there), so a corpus past 2^32 elements,
    where the flat index wraps, can be made and checked a slice at a
    time."""
    start, stop = (0, n_pad) if rows is None else rows
    if not 0 <= start <= stop <= n_pad:
        raise ValueError(f"rows {rows} outside [0, {n_pad}]")
    salt = int(salt) & _MASK
    out = torch.empty(stop - start, d, dtype=dtype, device=device)
    col = torch.arange(d, dtype=torch.int64, device=device)
    for r0 in range(start, stop, _ROWS_PER_BLOCK):
        r1 = min(r0 + _ROWS_PER_BLOCK, stop)
        row = torch.arange(r0, r1, dtype=torch.int64, device=device)
        idx = (row[:, None] * d + col[None, :]) & _MASK
        v = torch.zeros(r1 - r0, d, dtype=torch.float32, device=device)
        for s in (1, 2, 3, 4):  # the reference's order of the four sums
            x = (idx * 2654435761 + ((salt * s) & _MASK)) & _MASK
            v = v + _mix(x).to(torch.float32) * (1.0 / 4294967296.0)
        v = v - 2.0
        n = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
        out[r0 - start:r1 - start] = (v / torch.clamp(n, min=1e-9)).to(dtype)
    return out
