"""Write-ahead log: optional durability for the op-channel window.

The reference's in-flight channel is volatile — ops not yet committed by
the read side are lost on crash, with re-ingestion as the implied recovery
model (SURVEY.md §5, operation.rs). With ``writer_side.wal_enabled`` every
stamped op is appended (JSONL, fsync'd per batch) before entering the
channel; on boot the read side replays entries beyond its committed offset,
closing that gap. The read side truncates the log at each commit.

Port of ``orama_core_tpu/wal.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, List

from . import oplog
from .types import TypedField, ValueType
from .utils import ensure_dir
from .utils.file_utils import _fsync_dir

_OP_TYPES = {
    cls.__name__: cls
    for cls in (
        oplog.CreateCollectionOp,
        oplog.CreateFieldOp,
        oplog.InsertDocumentOp,
        oplog.DeleteDocumentsOp,
        oplog.IndexStringOp,
        oplog.IndexKeywordOp,
        oplog.IndexNumberOp,
        oplog.IndexBoolOp,
        oplog.IndexEmbeddingOp,
    )
}


def op_to_json(op) -> Dict[str, Any]:
    d = dataclasses.asdict(op)
    if isinstance(op, oplog.CreateFieldOp):
        d["field"]["type"] = op.field.type.value
    return {"t": type(op).__name__, "d": d}


def op_from_json(obj: Dict[str, Any]):
    cls = _OP_TYPES[obj["t"]]
    d = obj["d"]
    if cls is oplog.CreateFieldOp:
        fd = dict(d["field"])
        fd["type"] = ValueType(fd["type"])
        if fd.get("embedding_sources") is not None:
            fd["embedding_sources"] = tuple(fd["embedding_sources"])
        d = {"collection_id": d["collection_id"], "field": TypedField(**fd)}
    elif cls is oplog.DeleteDocumentsOp:
        d = dict(d)
        d["doc_ids"] = tuple(d["doc_ids"])
    elif cls is oplog.IndexStringOp:
        d = dict(d)
        d["terms"] = {t: tuple(p) for t, p in d["terms"].items()}
    elif cls is oplog.IndexKeywordOp:
        d = dict(d)
        d["values"] = tuple(d["values"])
    elif cls is oplog.IndexEmbeddingOp:
        d = dict(d)
        d["vectors"] = tuple(tuple(v) for v in d["vectors"])
    return cls(**d)


class WriteAheadLog:
    def __init__(self, data_dir: str) -> None:
        self.path = os.path.join(ensure_dir(data_dir), "oplog.wal")
        self._lock = threading.Lock()
        # repair a torn tail BEFORE appending: a crash mid-append leaves a
        # partial line, and appending onto it would merge the next record
        # into one unparseable line — replay/truncate would then silently
        # stop there, destroying acknowledged entries after it
        self._repair_tail()
        self._fh = open(self.path, "ab")

    def _repair_tail(self) -> None:
        """Truncate the log to its longest valid JSONL prefix."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except OSError:
            return
        good = i = 0
        while True:
            j = data.find(b"\n", i)
            if j < 0:
                break
            try:
                json.loads(data[i:j + 1])
            except json.JSONDecodeError:
                break
            good = i = j + 1
        if good != len(data):
            with open(self.path, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())

    def append(self, stamped: oplog.StampedOp) -> None:
        rec = {"o": stamped.offset.value, **op_to_json(stamped.op)}
        line = json.dumps(rec, ensure_ascii=False).encode("utf-8") + b"\n"
        with self._lock:
            self._fh.write(line)

    def sync(self) -> None:
        with self._lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def replay(self, after_offset: int) -> List[oplog.StampedOp]:
        """Entries with offset > after_offset; torn tail lines skipped."""
        out: List[oplog.StampedOp] = []
        with self._lock:
            self._fh.flush()
        try:
            with open(self.path, "rb") as f:
                for raw in f:
                    try:
                        rec = json.loads(raw)
                    except json.JSONDecodeError:
                        break  # torn tail from a crash mid-write
                    if rec["o"] > after_offset:
                        out.append(
                            oplog.StampedOp(
                                oplog.Offset(rec["o"]), op_from_json(rec)
                            )
                        )
        except OSError:
            pass
        return out

    def truncate_through(self, offset: int) -> None:
        """Drop entries with offset <= committed offset (called at read-side
        commit): rewrite the tail atomically."""
        with self._lock:
            self._fh.flush()
            keep: List[bytes] = []
            try:
                with open(self.path, "rb") as f:
                    for raw in f:
                        try:
                            rec = json.loads(raw)
                        except json.JSONDecodeError:
                            break
                        if rec["o"] > offset:
                            keep.append(raw)
            except OSError:
                pass
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.writelines(keep)
                f.flush()
                os.fsync(f.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            # without the directory sync the rename itself isn't
            # crash-durable (same bar as utils/file_utils.atomic_write_*)
            _fsync_dir(os.path.dirname(self.path))
            self._fh = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.flush()
                self._fh.close()
            except OSError:
                pass

    @property
    def last_offset(self) -> int:
        entries = self.replay(-1)
        return entries[-1].offset.value if entries else 0
