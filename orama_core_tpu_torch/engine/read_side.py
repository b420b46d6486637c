"""Read side: op consumption, search entry, commit/load.

Counterpart of the reference's `ReadSide` (`sides/read/mod.rs`): consumes
offset-stamped ops from the channel into per-collection readers + document
storage, exposes the search entry (api-key check → CollectionReader.search →
doc fetch), and commits on op-count/interval triggers.

Port of ``orama_core_tpu/engine/read_side.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..config import GpuConfig, ReaderSideConfig
from ..oplog import (
    CreateCollectionOp,
    DeleteDocumentsOp,
    OperationReceiver,
    StampedOp,
)
from ..types import (
    ApiKeyError,
    CollectionNotFound,
    SearchModeKind,
    SearchParams,
    SearchResult,
    SearchResultHit,
)
from ..server import metrics as m
from ..utils import ensure_dir, read_json, atomic_write_json, tracing
from .collection_read import CollectionReader
from .document_storage import DocumentStorage


def dataclasses_to_key(v) -> str:
    """Stable string form of a filter value for batch-compatibility keys."""
    import dataclasses

    if dataclasses.is_dataclass(v):
        return repr(dataclasses.asdict(v))
    return repr(v)


class ReadSide:
    def __init__(
        self,
        cfg: ReaderSideConfig,
        op_receiver: OperationReceiver,
        ai_service,
        gpu_cfg: Optional[GpuConfig] = None,
    ) -> None:
        self.cfg = cfg
        self.rx = op_receiver
        self.ai = ai_service
        self.gpu_cfg = gpu_cfg or GpuConfig()
        self.collections: Dict[str, CollectionReader] = {}
        self.doc_storage: Dict[str, DocumentStorage] = {}
        self._lock = threading.RLock()
        # Serializes op application against commits: the pump thread and the
        # commit-interval thread must not interleave (an op applied mid-commit
        # would be recorded as committed — and its WAL entry truncated — while
        # living only in the in-memory window, losing it on crash). apply()
        # holds it per op; commit() holds it for the whole body, mirroring the
        # reference's commit_insert_mutex (collection.rs:198,614) at side
        # scope. Searches never take it.
        self._apply_commit_lock = threading.RLock()
        self._applied_offset = 0
        self._ops_since_commit = 0
        self.wal = None  # optional WriteAheadLog, wired by Orama
        # called just before WAL truncation (Orama wires write_side.commit
        # so the write-side dump is never staler than the truncation point)
        self.wal_pre_truncate = None
        self._batcher = None
        if self.gpu_cfg.query_batching:
            from ..server.batcher import MicroBatcher

            self._batcher = MicroBatcher(
                self._run_search_batch,
                max_batch=self.gpu_cfg.batch_max,
                max_wait_ms=self.gpu_cfg.batch_wait_ms,
                submit_timeout_s=self.gpu_cfg.batch_submit_timeout_s,
            )
        self.load()

    # -- op application (reference: read/mod.rs:181-249) ----------------------

    def apply(self, stamped: StampedOp) -> None:
        with self._apply_commit_lock:
            self._apply_locked(stamped)

    def _apply_locked(self, stamped: StampedOp) -> None:
        op = stamped.op
        if isinstance(op, CreateCollectionOp):
            with self._lock:
                if op.collection_id not in self.collections:
                    self.collections[op.collection_id] = CollectionReader(
                        op.collection_id,
                        op.read_api_key,
                        op.description,
                        self.gpu_cfg,
                        op.default_locale,
                    )
                    self.doc_storage[op.collection_id] = DocumentStorage(
                        os.path.join(self.cfg.data_dir, "docs", op.collection_id)
                    )
            from ..server import metrics as m

            m.COLLECTION_ADDED.inc(collection=op.collection_id)
        else:
            cid = op.collection_id
            reader = self.collections.get(cid)
            if reader is None:
                raise CollectionNotFound(cid)
            # idempotence per offset: a crash between the per-collection
            # generation pointer swap and the read-side info.json write
            # makes WAL replay re-deliver ops already folded into the
            # collection's committed generation — re-applying them would
            # double doc_count and duplicate postings in the window
            if stamped.offset.value > reader.committed_offset:
                from ..oplog import InsertDocumentOp

                if isinstance(op, InsertDocumentOp):
                    self.doc_storage[cid].add_document(
                        op.doc_id, op.document
                    )
                elif isinstance(op, DeleteDocumentsOp):
                    self.doc_storage[cid].delete_documents(op.doc_ids)
                reader.apply(op)
        self._applied_offset = stamped.offset.value
        self._ops_since_commit += 1

    def pump(self, timeout: float = 0.0) -> int:
        """Apply everything currently in the channel; returns ops applied."""
        from ..server import metrics as m

        n = 0
        while True:
            batch = self.rx.drain()
            if not batch:
                if timeout > 0:
                    s = self.rx.recv(timeout=timeout)
                    if s is None:
                        break
                    batch = s if isinstance(s, list) else [s]
                else:
                    break
            # the commit-exclusion lock is taken once per <=1024-op slice,
            # not per op (per-op acquisition dominated bulk-ingest apply);
            # slicing bounds how long a pending commit can be starved
            for start in range(0, len(batch), 1024):
                with self._apply_commit_lock:
                    for stamped in batch[start : start + 1024]:
                        # per-op isolation: one poisoned op must not discard
                        # the rest of an already-drained batch. The reference
                        # PANICS here (lib.rs:96 "OUCH!"); we log loudly and
                        # keep the offset moving so commit/WAL truncation
                        # never wedge on a permanently-failing op.
                        try:
                            self._apply_locked(stamped)
                            n += 1
                        except Exception as e:
                            from ..utils import tracing

                            tracing.log(
                                "error",
                                f"op {stamped.offset.value} "
                                f"({type(stamped.op).__name__}) dropped: {e!r}",
                            )
                            self._applied_offset = max(
                                self._applied_offset, stamped.offset.value
                            )
            timeout = 0.0
        if n:
            m.COLLECTION_OPS.inc(n)
            m.OPERATION_GAUGE.set(self.rx.pending_ops())
        return n

    # -- search (reference: read/mod.rs:127-179) ------------------------------

    def _reader(self, collection_id: str) -> CollectionReader:
        reader = self.collections.get(collection_id)
        if reader is None:
            raise CollectionNotFound(collection_id)
        return reader

    def check_read_key(self, collection_id: str, key: Optional[str]) -> CollectionReader:
        reader = self._reader(collection_id)
        if key != reader.read_api_key:
            raise ApiKeyError("invalid read api key")
        return reader

    def _batchable(self, params: SearchParams) -> bool:
        return (
            self._batcher is not None
            and not params.facets
            and params.properties is None
            and bool(params.term.strip())
            # raw-vector queries carry their own embedding, which the
            # batched path (keyed and driven by term) cannot represent
            and params.vector is None
            # the batched vector scorer is the exact product; under an
            # int8 index batching would change the scores
            and (
                params.mode == SearchModeKind.FULLTEXT
                or self.gpu_cfg.vector_index == "exact"
            )
            # phrase queries do not batch: K4 costs the same per row
            # either way, so they take the single-query path
            and (
                params.mode == SearchModeKind.VECTOR
                or len(params.term.split()) == 1
            )
        )

    def _batch_key(self, collection_id: str, params: SearchParams):
        import json as _json

        where_key = _json.dumps(
            {k: dataclasses_to_key(v) for k, v in sorted(params.where.items())}
        )
        boost_key = _json.dumps(sorted(params.boost.items()))
        # multi-word terms get phrase boosts and single-word terms must
        # not: keep them in separate batches
        phrase_hint = len(params.term.split()) > 1
        return (
            collection_id, params.mode.value, params.fusion.value,
            where_key, boost_key, phrase_hint,
        )

    def _run_search_batch(self, key, payloads):
        return self._reader(key[0]).search_batch(payloads, self.ai)

    def close(self) -> None:
        """Stop the micro-batcher's collector thread, if there is one."""
        if self._batcher is not None:
            self._batcher.stop()

    def search(
        self,
        collection_id: str,
        params: SearchParams,
        read_api_key: Optional[str] = None,
        skip_auth: bool = False,
        with_documents: bool = True,
    ) -> SearchResult:
        t0 = time.perf_counter()
        # the request's span: the batcher's queue span names it as parent
        with tracing.span("read_side.search") as sp:
            reader = (
                self._reader(collection_id)
                if skip_auth
                else self.check_read_key(collection_id, read_api_key)
            )
            offset = params.offset
            if offset:
                # pagination: rank offset+limit, slice after (the shared
                # kernels and the batcher only know a single k)
                import dataclasses as _dc

                params = _dc.replace(params, limit=params.limit + offset, offset=0)
            batched = self._batchable(params)
            sp["batched"] = batched
            if batched:
                ranked, count = self._batcher.submit(
                    self._batch_key(collection_id, params), params
                )
                facets = None
            else:
                ranked, count, facets = reader.search(params, self.ai)
            if offset:
                ranked = ranked[offset:]
            with tracing.span("read_side.hits", n=len(ranked)):
                hits = self._hits(collection_id, ranked, with_documents)
        elapsed = time.perf_counter() - t0
        m.SEARCH_ELAPSED.observe(elapsed, collection=collection_id)
        return SearchResult(hits=hits, count=count, elapsed_ms=elapsed * 1e3,
                            facets=facets)

    def _hits(self, collection_id: str, ranked, with_documents: bool
              ) -> List[SearchResultHit]:
        storage = self.doc_storage[collection_id]
        hits: List[SearchResultHit] = []
        for doc_id, score in ranked:
            doc = storage.get(doc_id) if with_documents else None
            if doc:
                uid = str(doc.get("id"))
            else:
                # without documents, hits still carry the USER id (the
                # storage keeps the uid map in memory); the dense id is
                # only a last resort for docs missing from storage
                uid = storage.user_id_of(doc_id) or str(doc_id)
            hits.append(SearchResultHit(id=uid, score=score, document=doc))
        return hits

    def count_documents(self, collection_id: str) -> int:
        return self._reader(collection_id).doc_count

    def export_term_stats(self, collection_id: str) -> Dict[str, Any]:
        return self._reader(collection_id).export_term_stats()

    def apply_global_stats(
        self, collection_id: str, stats: Dict[str, Any]
    ) -> None:
        self._reader(collection_id).apply_global_stats(stats)

    def get_document_by_user_id(
        self, collection_id: str, user_id: str
    ) -> Optional[Dict[str, Any]]:
        """Fetch a raw document by its user-facing "id" using the map the
        read side builds from InsertDocumentOp — no write-side access
        (CQRS-safe when the sides run as separate processes)."""
        self._reader(collection_id)  # raises CollectionNotFound
        storage = self.doc_storage.get(collection_id)
        return storage.get_by_user_id(user_id) if storage else None

    # -- commit / load (reference: read/mod.rs:93-125) ------------------------

    @property
    def should_commit(self) -> bool:
        return self._ops_since_commit >= self.cfg.insert_batch_commit_size

    def commit(self) -> None:
        from ..server import metrics as m

        data_dir = ensure_dir(self.cfg.data_dir)
        # Exclusive vs op application (and vs a concurrent commit from the
        # other background thread): the offset is snapshotted ONCE and no op
        # can be applied mid-commit, so every merged segment, info.json, and
        # the WAL truncation all describe exactly the ops <= snapshot.
        with self._apply_commit_lock:
            snapshot = self._applied_offset
            with self._lock:
                collections = dict(self.collections)
            for cid, reader in collections.items():
                with m.COMMIT_ELAPSED.time(side="read", collection=cid):
                    reader.commit(
                        ensure_dir(os.path.join(data_dir, "collections", cid)),
                        snapshot,
                        keep_generations=getattr(self.cfg, "keep_generations", 2),
                    )
                    self.doc_storage[cid].commit()
            atomic_write_json(
                os.path.join(data_dir, "info.json"),
                {"offset": snapshot, "collections": sorted(collections)},
            )
            self._ops_since_commit = 0
            if self.wal is not None:
                # the write side's dump (doc-id map, next_doc_id) must be
                # at least as fresh as the truncation point: WAL entries
                # are the ONLY way absorb_replayed can restore counters
                # after a crash, and truncating beyond a stale write dump
                # would regress next_doc_id and silently reuse doc ids
                if self.wal_pre_truncate is not None:
                    self.wal_pre_truncate()
                self.wal.truncate_through(snapshot)

    def load(self) -> None:
        info = read_json(os.path.join(self.cfg.data_dir, "info.json"))
        if not info:
            return
        self._applied_offset = int(info.get("offset", 0))
        for cid in info.get("collections", []):
            reader = CollectionReader.load(
                os.path.join(self.cfg.data_dir, "collections", cid), self.gpu_cfg
            )
            if reader is not None:
                self.collections[cid] = reader
                self.doc_storage[cid] = DocumentStorage(
                    os.path.join(self.cfg.data_dir, "docs", cid)
                )
