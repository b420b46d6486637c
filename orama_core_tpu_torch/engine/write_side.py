"""Write side: API-key auth, doc-id assignment, op production, commit/load.

Counterpart of the reference's `WriteSide` (`sides/write/mod.rs`): documents
get ids (user "id" forced to a string, generated when missing), each doc is
processed into typed index ops pushed through the op log, embedding work is
queued for async batch computation, and state checkpoints as per-collection
dumps + a global ``{document_count, offset}`` info file.

Port of ``orama_core_tpu/engine/write_side.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, List, Optional, Sequence

from ..config import WriterSideConfig
from ..oplog import (
    CreateCollectionOp,
    DeleteDocumentsOp,
    IndexEmbeddingOp,
    InsertDocumentOp,
    OperationSender,
)
from ..types import ApiKeyError, CollectionNotFound, new_cuid
from ..utils import atomic_write_json, ensure_dir, read_json
from ..utils import tracing
from .collection_write import CollectionWriter, EmbeddingRequest


class WriteSide:
    def __init__(
        self,
        cfg: WriterSideConfig,
        op_sender: OperationSender,
        ai_service,
        hooks=None,
    ) -> None:
        self.cfg = cfg
        self.op_sender = op_sender
        self.ai = ai_service
        self.hooks = hooks
        self.collections: Dict[str, CollectionWriter] = {}
        self._lock = threading.RLock()
        self._embedding_queue: "queue.Queue[EmbeddingRequest]" = queue.Queue(
            maxsize=cfg.embedding_queue_limit
        )
        self._ops_since_commit = 0
        self.load()

    # -- admin ----------------------------------------------------------------

    def check_master_key(self, key: Optional[str]) -> None:
        if key != self.cfg.master_api_key:
            raise ApiKeyError("invalid master api key")

    def _collection(self, collection_id: str) -> CollectionWriter:
        c = self.collections.get(collection_id)
        if c is None:
            raise CollectionNotFound(collection_id)
        return c

    def check_write_key(self, collection_id: str, key: Optional[str]) -> CollectionWriter:
        c = self._collection(collection_id)
        if key != c.write_api_key:
            raise ApiKeyError("invalid write api key")
        return c

    def create_collection(
        self,
        master_key: Optional[str],
        collection_id: str,
        read_api_key: str,
        write_api_key: str,
        description: Optional[str] = None,
        language: str = "en",
        embedding_model: Optional[str] = None,
        embedding_sources: Optional[Sequence[str]] = None,
    ) -> None:
        self.check_master_key(master_key)
        with self._lock:
            if collection_id in self.collections:
                raise ValueError(f"collection {collection_id!r} already exists")
            model = embedding_model or self.cfg.default_embedding_model
            w = CollectionWriter(
                collection_id,
                description,
                read_api_key,
                write_api_key,
                default_locale=language,
                embedding_model=model,
                embedding_sources=embedding_sources,
            )
            # send BEFORE publishing: a concurrent write() that found the
            # collection could otherwise emit Insert/CreateField ops that
            # reach the channel ahead of CreateCollectionOp — the read
            # side would drop them as CollectionNotFound, losing
            # fsync-acked documents
            self.op_sender.send(
                CreateCollectionOp(
                    collection_id, description, read_api_key, language,
                    write_api_key=write_api_key,
                )
            )
            for op in w.drain_field_ops():
                self.op_sender.send(op)
            self.collections[collection_id] = w

    def list_collections(self, master_key: Optional[str]) -> List[Dict[str, Any]]:
        self.check_master_key(master_key)
        with self._lock:
            return [
                {
                    "id": c.id,
                    "description": c.description,
                    "document_count": c.document_count,
                    "fields": {f.name: f.type.value for f in c.fields.values()},
                }
                for c in self.collections.values()
            ]

    def get_collection(self, master_key: Optional[str], collection_id: str) -> Dict[str, Any]:
        self.check_master_key(master_key)
        c = self._collection(collection_id)
        return {
            "id": c.id,
            "description": c.description,
            "document_count": c.document_count,
            "fields": {f.name: f.type.value for f in c.fields.values()},
        }

    # -- write path (reference: write/mod.rs:220-310) -------------------------

    def write(
        self,
        collection_id: str,
        documents: Sequence[Dict[str, Any]],
        write_api_key: Optional[str] = None,
        _skip_auth: bool = False,
    ) -> List[str]:
        """Insert documents; returns the (possibly generated) user ids."""
        if _skip_auth:
            c = self._collection(collection_id)
        else:
            c = self.check_write_key(collection_id, write_api_key)
        from ..server import metrics as m

        user_ids: List[str] = []
        # batch tokenize+stem pre-pass: one native call for every EN string
        # value in the batch (pure text work — safe outside the lock)
        prepared_terms = c.prepare_native_terms(documents)
        for doc in documents:
            doc = dict(doc)
            uid = doc.get("id")
            if not isinstance(uid, str) or not uid:
                uid = new_cuid()
            doc["id"] = uid
            user_ids.append(uid)

            override = None
            if self.hooks is not None:
                from .hooks import SELECT_EMBEDDING_PROPERTIES

                try:
                    override = self.hooks.eval(
                        collection_id, SELECT_EMBEDDING_PROPERTIES, doc
                    )
                except Exception as e:
                    # hook failure (uncaught throw, unsupported subset with
                    # subprocess disabled, bad return type) skips the doc's
                    # embedding but never aborts the write batch — the
                    # reference's `_ => return Ok(())` (fields.rs:431-434)
                    tracing.log(
                        "error",
                        f"hook eval failed for doc {uid!r} in "
                        f"{collection_id!r}: {e}; skipping embedding",
                    )
                    override = []
            # Per-collection serialization from id assignment through op
            # emission: schema inference mutates the field registry
            # (_register_field) and CreateFieldOp MUST reach the channel
            # before any concurrent writer's IndexOp that uses the field —
            # unlocked, two HTTP threads could mint duplicate field_ids or
            # interleave an IndexStringOp ahead of its CreateFieldOp.
            # (Hook eval stays outside: it sees a private doc copy.)
            with c._lock:
                doc_id, replaced = c.assign_doc_id(uid)
                ops, emb_reqs = c.process_document(
                    doc_id, doc, override, prepared_terms
                )
                # one channel send per document (delete-replaced first,
                # then field-creation ops, which must precede the index
                # ops using them)
                doc_ops: List[Any] = []
                if replaced is not None:
                    doc_ops.append(
                        DeleteDocumentsOp(collection_id, (replaced,))
                    )
                doc_ops.extend(c.drain_field_ops())
                doc_ops.append(InsertDocumentOp(collection_id, doc_id, doc))
                doc_ops.extend(ops)
                self.op_sender.send_many(doc_ops)
            for req in emb_reqs:
                try:
                    # bounded wait, then fail LOUDLY like the op channel —
                    # a dead embedding backend must not hang client writes
                    # forever on a full queue
                    self._embedding_queue.put(req, timeout=30.0)
                except queue.Full:
                    raise RuntimeError(
                        "embedding queue full after 30s (embedding backend "
                        "down or underprovisioned)"
                    ) from None
            self._ops_since_commit += len(ops) + 1
            m.ADD_DOCUMENT.inc(collection=collection_id)
        m.EMBEDDING_GAUGE.set(self._embedding_queue.qsize())
        # durability point: the insert is acknowledged only after the WAL
        # batch is fsync'd (one fsync per write() call, not per op)
        self.op_sender.sync_wal()
        return user_ids

    def delete_documents(
        self,
        collection_id: str,
        user_ids: Sequence[str],
        write_api_key: Optional[str] = None,
        _skip_auth: bool = False,
    ) -> int:
        if _skip_auth:
            c = self._collection(collection_id)
        else:
            c = self.check_write_key(collection_id, write_api_key)
        doc_ids = c.lookup_doc_ids(user_ids)
        if doc_ids:
            self.op_sender.send(DeleteDocumentsOp(collection_id, tuple(doc_ids)))
            # forget only AFTER the op is in the channel: a send failure
            # must leave the mapping intact so the client's retry works
            c.forget_doc_ids(user_ids)
            self._ops_since_commit += 1
            self.op_sender.sync_wal()
        return len(doc_ids)

    # -- WAL crash recovery ----------------------------------------------------

    def absorb_replayed(self, stamped) -> None:
        """Fold a WAL-replayed op into WRITE-side state. Boot-time replay
        restores the read side, but the write side's dump (doc-id map,
        next_doc_id, field registry) only persists on ITS commit interval —
        a crash between an fsync-acked write and that commit would
        otherwise regress next_doc_id/_next_field_id and silently reuse
        dense ids, merging a new document's postings into a survivor's."""
        from ..oplog import (
            CreateCollectionOp,
            CreateFieldOp,
            DeleteDocumentsOp,
            InsertDocumentOp,
        )

        op = stamped.op
        cid = getattr(op, "collection_id", None)
        if cid is None:
            return
        with self._lock:
            w = self.collections.get(cid)
            if w is None:
                if isinstance(op, CreateCollectionOp):
                    if op.write_api_key is None:
                        # pre-extension WAL entry: collection exists on the
                        # read side but its write key is unrecoverable
                        tracing.log(
                            "error",
                            f"replayed collection {cid!r} carries no write "
                            "key (old WAL format) — re-create it to write",
                        )
                        return
                    w = CollectionWriter(
                        cid,
                        op.description,
                        op.read_api_key,
                        op.write_api_key,
                        default_locale=op.default_locale,
                        embedding_model=None,  # fields come from CreateFieldOp
                    )
                    self.collections[cid] = w
                return
        if isinstance(op, CreateFieldOp):
            f = op.field
            with w._lock:
                if f.name not in w.fields:
                    w.fields[f.name] = f
                w._next_field_id = max(w._next_field_id, f.field_id + 1)
                # never re-emit: the read side already has this op
                w._pending_field_ops = [
                    p for p in w._pending_field_ops if p.field.name != f.name
                ]
        elif isinstance(op, InsertDocumentOp):
            uid = op.document.get("id")
            with w._lock:
                if isinstance(uid, str) and uid:
                    old = w.doc_id_by_user_id.get(uid)
                    w.doc_id_by_user_id[uid] = op.doc_id
                    if old is None:
                        w.document_count += 1
                w.next_doc_id = max(w.next_doc_id, op.doc_id + 1)
        elif isinstance(op, DeleteDocumentsOp):
            gone = set(op.doc_ids)
            with w._lock:
                drop = [
                    u for u, d in w.doc_id_by_user_id.items() if d in gone
                ]
                for u in drop:
                    del w.doc_id_by_user_id[u]
                    w.document_count -= 1

    # -- embedding pipeline (reference: write/embedding.rs:88-125) ------------

    def process_embeddings(self, max_batch: int = 64) -> int:
        """Drain the embedding queue: group by model, one batched forward per
        model, emit IndexEmbedding ops. Returns number of requests handled.
        (The background loop calls this repeatedly; tests call it directly.)"""
        batch: List[EmbeddingRequest] = []
        while len(batch) < max_batch:
            try:
                batch.append(self._embedding_queue.get_nowait())
            except queue.Empty:
                break
        if not batch:
            return 0
        from ..server import metrics as m

        m.PENDING_EMBEDDING_GAUGE.set(len(batch))
        by_model: Dict[str, List[EmbeddingRequest]] = {}
        for r in batch:
            by_model.setdefault(r.model, []).append(r)
        failed: List[EmbeddingRequest] = []
        first_err: Optional[Exception] = None
        for model, reqs in by_model.items():
            try:
                with m.EMBED_CALC_ELAPSED.time(model=model):
                    vecs = self.ai.embed_passage(
                        model, [r.text for r in reqs]
                    )
            except Exception as ex:
                # a transient backend failure for one model must not
                # silently drop the drained batch (those docs would never
                # get vectors): re-queue for retry, keep processing the
                # other models, and re-raise at the end so the background
                # loop backs off
                failed.extend(reqs)
                first_err = first_err or ex
                continue
            emb_ops: List[Any] = []
            for r, v in zip(reqs, vecs):
                # tolist() converts the whole vector in C (a per-element
                # float(x) genexpr dominated the ingest profile)
                vals = v.tolist() if hasattr(v, "tolist") else [float(x) for x in v]
                emb_ops.append(
                    IndexEmbeddingOp(
                        r.collection_id,
                        r.doc_id,
                        r.field_id,
                        (tuple(vals),),
                    )
                )
            self.op_sender.send_many(emb_ops)
        m.PENDING_EMBEDDING_GAUGE.set(0)
        m.EMBEDDING_GAUGE.set(self._embedding_queue.qsize())
        self.op_sender.sync_wal()
        if failed:
            for r in failed:
                try:
                    self._embedding_queue.put_nowait(r)
                except queue.Full:
                    tracing.log(
                        "error",
                        f"embedding retry dropped (queue full): doc "
                        f"{r.doc_id} model {r.model}",
                    )
            raise first_err  # the background loop backs off on this
        return len(batch)

    def drain_embeddings(self) -> None:
        while self.process_embeddings() > 0:
            pass

    def pending_embeddings(self) -> int:
        return self._embedding_queue.qsize()

    # -- commit / load (reference: write/mod.rs:181-204, 126-156) -------------

    @property
    def should_commit(self) -> bool:
        return self._ops_since_commit >= self.cfg.insert_batch_commit_size

    def commit(self) -> None:
        from ..server import metrics as m

        data_dir = ensure_dir(self.cfg.data_dir)
        with m.COMMIT_ELAPSED.time(side="write"), self._lock:
            total_docs = 0
            for cid, c in self.collections.items():
                cdir = ensure_dir(os.path.join(data_dir, "collections", cid))
                # snapshot under the collection's own lock: a concurrent
                # write() mutates doc_id_by_user_id, and json.dumps over a
                # live dict raises (commit_loop would swallow it and the
                # dump would silently never persist under sustained ingest)
                with c._lock:
                    data = c.dump()
                atomic_write_json(os.path.join(cdir, "info.json"), data)
                total_docs += c.document_count
            atomic_write_json(
                os.path.join(data_dir, "info.json"),
                {"document_count": total_docs, "offset": self.op_sender.offset},
            )
            self._ops_since_commit = 0

    def load(self) -> None:
        data_dir = self.cfg.data_dir
        info = read_json(os.path.join(data_dir, "info.json"))
        if not info:
            return
        self.op_sender.set_offset(int(info.get("offset", 0)))
        cdir = os.path.join(data_dir, "collections")
        if os.path.isdir(cdir):
            for cid in sorted(os.listdir(cdir)):
                dump = read_json(os.path.join(cdir, cid, "info.json"))
                if dump:
                    self.collections[cid] = CollectionWriter.from_dump(dump)
