"""Durable file helpers: atomic JSON / numpy-archive writes.

Counterpart of the reference's `BufferedFile` (`file_utils.rs:92-252`):
write-to-temp + fsync + atomic rename + PARENT-DIRECTORY fsync — without
the directory sync the rename itself isn't crash-durable, and a commit that
already truncated the WAL could lose acknowledged files on power loss.
Readers never observe torn files (torn-write tolerance at read time mirrors
document_storage.rs:75-86).

Port of ``orama_core_tpu/utils/file_utils.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Optional

import numpy as np


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # platforms/filesystems without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj, ensure_ascii=False).encode("utf-8"))


def read_json(path: str) -> Optional[Any]:
    """Returns None on missing or torn files (reader-tolerant)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def atomic_write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_npz(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Returns None on missing/torn/corrupt archives (np.load raises
    zipfile.BadZipFile on truncation and EOFError on empty files — both
    must fall under the documented reader tolerance)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile, KeyError):
        return None
