"""Raw document storage: uncommitted dict → committed JSONL segments.

Counterpart of the reference's `DocumentStorage`
(`sides/read/document_storage.rs`): uncommitted docs live in memory and are
drained to disk at commit; reads go through an in-memory cache; torn/missing
files yield ``None`` rather than errors (document_storage.rs:75-86).

Layout decision: segment files (JSONL + offset index), not one-file-per-doc
— this host runs on few cores and millions of tiny files would bottleneck
commit; a segment is one sequential write + one fsync. Deleted/updated
docs leave dead lines behind; when more than half of all committed lines
are dead (and segments have piled up), commit compacts live docs into one
fresh segment and GCs the old files one commit later (so in-flight reads
that already resolved an old (segment, offset) never hit a missing file).

Port of ``orama_core_tpu/engine/document_storage.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Set

from ..utils import atomic_write_bytes, atomic_write_json, ensure_dir, read_json


class DocumentStorage:
    # read-cache bound: committed docs re-read cheaply from their segment,
    # so the cache is a working-set accelerator, not a corpus mirror
    CACHE_MAX = 65_536
    # compact when dead lines outnumber live ones and segments piled up
    COMPACT_GARBAGE_RATIO = 0.5
    COMPACT_MIN_SEGMENTS = 4

    def __init__(self, data_dir: str) -> None:
        self.data_dir = ensure_dir(data_dir)
        self._lock = threading.RLock()
        self._uncommitted: Dict[int, Dict[str, Any]] = {}
        self._cache: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        # doc_id -> (segment, byte offset); loaded from manifest
        self._committed_where: Dict[int, List[int]] = {}
        self._segments: List[str] = []
        self._seg_lines: List[int] = []  # lines ever written per segment
        self._pending_gc: List[str] = []  # old segments, deleted next commit
        self._deleted: Set[int] = set()
        # user id ("id" field) -> dense doc id, maintained from the op
        # stream so doc-fetch-by-user-id never reaches into the write side
        # (CQRS: the sides may run as separate processes, operation.rs:119)
        self._by_uid: Dict[str, int] = {}
        self._uid_of: Dict[int, str] = {}
        self._next_seg = 0  # monotonic segment-file counter (survives compaction)
        self.load()

    # -- write path -----------------------------------------------------------

    def add_document(self, doc_id: int, doc: Dict[str, Any]) -> None:
        with self._lock:
            self._uncommitted[doc_id] = doc
            # a re-add must not leave a stale committed version in the
            # read cache (it would be served again after commit)
            self._cache.pop(doc_id, None)
            self._deleted.discard(doc_id)
            uid = doc.get("id")
            if isinstance(uid, str) and uid:
                self._by_uid[uid] = doc_id
                self._uid_of[doc_id] = uid

    def delete_documents(self, doc_ids: Iterable[int]) -> None:
        with self._lock:
            for d in doc_ids:
                self._uncommitted.pop(d, None)
                self._cache.pop(d, None)
                self._deleted.add(d)
                uid = self._uid_of.pop(d, None)
                # a re-insert may already have remapped the uid to its new
                # doc id; only drop the mapping if it still points at d
                if uid is not None and self._by_uid.get(uid) == d:
                    del self._by_uid[uid]

    # -- read path ------------------------------------------------------------

    def get(self, doc_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            if doc_id in self._deleted:
                return None
            doc = self._uncommitted.get(doc_id)
            if doc is not None:
                return doc
            doc = self._cache.get(doc_id)
            if doc is not None:
                self._cache.move_to_end(doc_id)
                return doc
            where = self._committed_where.get(doc_id)
            segments = self._segments
        if where is None:
            return None
        seg_idx, offset = where
        path = os.path.join(self.data_dir, segments[seg_idx])
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                line = f.readline()
            doc = json.loads(line)
        except (OSError, json.JSONDecodeError):
            return None  # torn write tolerance
        with self._lock:
            # re-validate before caching: a delete/update/compact that ran
            # during the unlocked disk read must not be shadowed by a
            # stale cache entry served forever after
            stale = (
                doc_id in self._deleted
                or doc_id in self._uncommitted
                or self._committed_where.get(doc_id) != where
            )
            if not stale:
                self._cache[doc_id] = doc
                self._cache.move_to_end(doc_id)
                while len(self._cache) > self.CACHE_MAX:
                    self._cache.popitem(last=False)
        if stale:
            return self.get(doc_id)  # re-read under current state
        return doc

    def get_many(self, doc_ids: Iterable[int]) -> List[Optional[Dict[str, Any]]]:
        return [self.get(d) for d in doc_ids]

    def doc_id_of(self, user_id: str) -> Optional[int]:
        with self._lock:
            return self._by_uid.get(user_id)

    def user_id_of(self, doc_id: int) -> Optional[str]:
        with self._lock:
            return self._uid_of.get(doc_id)

    def get_by_user_id(self, user_id: str) -> Optional[Dict[str, Any]]:
        doc_id = self.doc_id_of(user_id)
        return self.get(doc_id) if doc_id is not None else None

    # -- commit / load --------------------------------------------------------

    def _write_segment(self, docs: Dict[int, Dict[str, Any]], seg_idx: int) -> str:
        seg_name = f"segment-{seg_idx:06d}.jsonl"
        lines: List[bytes] = []
        offsets: Dict[int, int] = {}
        pos = 0
        for doc_id, doc in docs.items():
            b = json.dumps(doc, ensure_ascii=False).encode("utf-8") + b"\n"
            offsets[doc_id] = pos
            pos += len(b)
            lines.append(b)
        atomic_write_bytes(os.path.join(self.data_dir, seg_name), b"".join(lines))
        with self._lock:
            self._segments.append(seg_name)
            self._seg_lines.append(len(docs))
            new_idx = len(self._segments) - 1
            for doc_id, off in offsets.items():
                self._committed_where[doc_id] = [new_idx, off]
        return seg_name

    def commit(self) -> None:
        # GC segments retired by the PREVIOUS compaction: one-commit delay
        # so reads that resolved an old (segment, offset) before the swap
        # never hit a missing file
        with self._lock:
            gc, self._pending_gc = self._pending_gc, []
        for name in gc:
            try:
                os.remove(os.path.join(self.data_dir, name))
            except OSError:
                pass
        with self._lock:
            pending = dict(self._uncommitted)
            deleted = set(self._deleted)
            seg_idx = self._next_seg
        if pending:
            self._write_segment(pending, seg_idx)
            with self._lock:
                self._next_seg = seg_idx + 1
                for doc_id, doc in pending.items():
                    # an add racing this commit replaced the entry; only
                    # drop what we actually persisted
                    if self._uncommitted.get(doc_id) is doc:
                        del self._uncommitted[doc_id]
        with self._lock:
            for d in deleted:
                self._committed_where.pop(d, None)
            self._deleted -= deleted
            live = len(self._committed_where)
            total = sum(self._seg_lines)
            compact = (
                total > 0
                and live / total < (1.0 - self.COMPACT_GARBAGE_RATIO)
                and len(self._segments) > self.COMPACT_MIN_SEGMENTS
            )
        if compact:
            self._compact()
        with self._lock:
            manifest = {
                "segments": self._segments,
                "seg_lines": self._seg_lines,
                "where": {str(k): v for k, v in self._committed_where.items()},
                "by_uid": {
                    u: d
                    for u, d in self._by_uid.items()
                    if d in self._committed_where
                },
            }
        atomic_write_json(os.path.join(self.data_dir, "manifest.json"), manifest)

    def _compact(self) -> None:
        """Rewrite all live committed docs into one fresh segment; retire
        the old files (deleted at the NEXT commit)."""
        with self._lock:
            where = dict(self._committed_where)
            old_segments = list(self._segments)
            seg_idx = self._next_seg
        # stream each old segment sequentially ONCE (one open per segment,
        # no LRU cache churn) instead of one open+seek+readline per doc
        live: Dict[int, Dict[str, Any]] = {}
        by_seg: Dict[int, Dict[int, int]] = {}
        for doc_id, (si, off) in where.items():
            by_seg.setdefault(si, {})[off] = doc_id
        for si, offs in by_seg.items():
            path = os.path.join(self.data_dir, old_segments[si])
            try:
                with open(path, "rb") as f:
                    for off, doc_id in sorted(offs.items()):
                        f.seek(off)
                        line = f.readline()
                        try:
                            live[doc_id] = json.loads(line)
                        except json.JSONDecodeError:
                            pass  # torn write tolerance
            except OSError:
                continue
        with self._lock:
            # swap to a fresh segment list; _write_segment appends to it
            self._segments = []
            self._seg_lines = []
            self._committed_where = {}
        self._write_segment(live, seg_idx)
        with self._lock:
            self._next_seg = seg_idx + 1
            self._pending_gc.extend(old_segments)

    def load(self) -> None:
        manifest = read_json(os.path.join(self.data_dir, "manifest.json"))
        if not manifest:
            return
        with self._lock:
            self._segments = list(manifest.get("segments", []))
            self._seg_lines = list(
                manifest.get("seg_lines", [0] * len(self._segments))
            )
            self._committed_where = {
                int(k): v for k, v in manifest.get("where", {}).items()
            }
            self._by_uid = {
                str(u): int(d) for u, d in manifest.get("by_uid", {}).items()
            }
            self._uid_of = {d: u for u, d in self._by_uid.items()}
            # startup GC: segment files the manifest no longer references
            # (left by a crash between compaction and its deferred delete)
            referenced = set(self._segments)
            try:
                for name in os.listdir(self.data_dir):
                    if (
                        name.startswith("segment-")
                        and name.endswith(".jsonl")
                        and name not in referenced
                    ):
                        os.remove(os.path.join(self.data_dir, name))
            except OSError:
                pass
            self._next_seg = 1 + max(
                (int(s[8:-6]) for s in self._segments), default=-1
            )

    def count_committed(self) -> int:
        with self._lock:
            return len(self._committed_where)

    def uncommitted_count(self) -> int:
        with self._lock:
            return len(self._uncommitted)
