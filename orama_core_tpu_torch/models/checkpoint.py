"""Model parameter checkpointing with ``torch.save``.

Port of ``orama_core_tpu/models/checkpoint.py``. The reference saves its
parameter pytrees through Orbax (JAX's format); the port saves its
parameter dicts (encoder/LLM: random-init, HF-converted or fine-tuned)
with ``torch.save`` and loads them with ``torch.load(weights_only=True)``.
The two formats are not cross-readable; carry parameters across packages
with the models' ``params_from_numpy``.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch


def as_param(a: Any, device, dtype: torch.dtype) -> torch.Tensor:
    """One parameter (a numpy array, e.g. a leaf of the reference's pytree,
    or a tensor) as a contiguous ``dtype`` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.tensor(np.asarray(a, np.float32)).to(
        device=device, dtype=dtype).contiguous()


def save_params(path: str, params: Any) -> None:
    """Write ``params`` (nested dicts and lists of tensors) to the file
    ``path``, atomically (a temporary file renamed into place)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(params, tmp)
    os.replace(tmp, path)


def _like(stored: Any, like: Any) -> Any:
    if isinstance(like, dict):
        return {k: _like(stored[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(s, v) for s, v in zip(stored, like))
    if isinstance(like, torch.Tensor):
        if tuple(stored.shape) != tuple(like.shape):
            raise ValueError(
                f"stored shape {tuple(stored.shape)} != {tuple(like.shape)}")
        return stored.to(device=like.device, dtype=like.dtype)
    return stored


def load_params(path: str, like: Optional[Any] = None) -> Any:
    """Restore a parameter dict. ``like`` (a dict of matching structure,
    e.g. fresh ``init_params`` output) restores each tensor with its dtype
    and device (and checks its shape); without it the stored tensors come
    back on the CPU as saved."""
    stored = torch.load(os.path.abspath(path), map_location="cpu",
                        weights_only=True)
    return _like(stored, like) if like is not None else stored
