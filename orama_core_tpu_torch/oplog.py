"""Offset-stamped operation log: the single write→read communication path.

TPU-native counterpart of the reference's op channel
(`sides/write/operation.rs:28-133`): every mutation becomes a typed
``WriteOperation`` stamped with a monotonically increasing ``Offset`` and is
consumed by the read side, which folds it into uncommitted (host-side,
mutable) index state. "Commit" then repacks host state into immutable packed
device arrays — the committed/uncommitted split of the reference, with device
arrays playing the role of the on-disk generation files.

The channel is a bounded in-memory queue (the reference's
``SideChannelType::InMemory``, lib.rs:45-49); the typed-op + offset seam is
where a durable replication log would plug in.

Port of ``orama_core_tpu/oplog.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

from .types import TypedField


@dataclasses.dataclass(frozen=True)
class Offset:
    value: int

    def next(self) -> "Offset":
        return Offset(self.value + 1)


# --- Operation payloads (reference: operation.rs:28-71) ----------------------


@dataclasses.dataclass(frozen=True)
class CreateCollectionOp:
    collection_id: str
    description: Optional[str]
    read_api_key: str
    default_locale: str = "en"
    # carried for WAL crash recovery ONLY (WriteSide.absorb_replayed must
    # be able to reconstruct a collection whose write-side dump never ran);
    # the read side ignores it. Same trust domain as the write-side dump,
    # which persists the key too.
    write_api_key: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CreateFieldOp:
    collection_id: str
    field: TypedField


@dataclasses.dataclass(frozen=True)
class InsertDocumentOp:
    collection_id: str
    doc_id: int
    document: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DeleteDocumentsOp:
    collection_id: str
    doc_ids: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class IndexStringOp:
    """terms: {term: [positions...]} — output of tokenize_and_stem
    (reference: DocumentFieldIndexOperation::IndexString, fields.rs:355-368)."""

    collection_id: str
    doc_id: int
    field_id: int
    field_length: int
    terms: Dict[str, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class IndexKeywordOp:
    """Exact values of a string field for keyword filters/term facets
    (no reference counterpart — string filters are on its roadmap)."""

    collection_id: str
    doc_id: int
    field_id: int
    values: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class IndexNumberOp:
    collection_id: str
    doc_id: int
    field_id: int
    value: float


@dataclasses.dataclass(frozen=True)
class IndexBoolOp:
    collection_id: str
    doc_id: int
    field_id: int
    value: bool


@dataclasses.dataclass(frozen=True)
class IndexEmbeddingOp:
    collection_id: str
    doc_id: int
    field_id: int
    vectors: Tuple[Tuple[float, ...], ...]  # multi-vector per document


WriteOperation = Any  # union of the dataclasses above


@dataclasses.dataclass(frozen=True)
class StampedOp:
    offset: Offset
    op: WriteOperation


class _OpCount:
    """Op-level depth of the channel (queue items may be chunks of ops,
    so qsize() undercounts after send_many)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self, n: int) -> None:
        with self._lock:
            self._n += n

    def value(self) -> int:
        with self._lock:
            return self._n


class OperationSender:
    """Stamps ops with offsets and pushes into the bounded channel."""

    def __init__(
        self, q: "queue.Queue[StampedOp]", count: Optional[_OpCount] = None
    ) -> None:
        self._q = q
        self._count = count or _OpCount()
        self._lock = threading.Lock()
        self._offset = 0
        self.wal = None  # optional WriteAheadLog (wal.py)

    @property
    def offset(self) -> int:
        return self._offset

    def set_offset(self, offset: int) -> None:
        """Restore the counter on reload (reference: offset_storage.rs)."""
        with self._lock:
            self._offset = offset

    def send(self, op: WriteOperation, timeout: float = 30.0) -> Offset:
        # Stamp, enqueue, and WAL-append under ONE lock: stamping inside
        # but publishing outside the lock let concurrent senders reorder
        # ops (queue AND WAL), and a read-side commit between two
        # out-of-order applies would truncate the WAL past an unapplied,
        # already-acknowledged op. Queue-put precedes WAL-append so a Full
        # failure leaves no phantom entry to replay on the next boot (an
        # applied-but-unappended op is covered by the commit itself).
        with self._lock:
            self._offset += 1
            stamped = StampedOp(Offset(self._offset), op)
            try:
                self._q.put(stamped, timeout=timeout)
            except queue.Full:
                # Backpressure with no consumer = deadlock; fail loudly
                # (sync-mode callers must pump within channel capacity).
                raise RuntimeError(
                    "op channel full after "
                    f"{timeout}s — is the read-side pump running? "
                    "(flush() more often in synchronous mode)"
                ) from None
            if self.wal is not None:
                self.wal.append(stamped)
            self._count.add(1)
        return stamped.offset

    def send_batch(self, ops: List[WriteOperation]) -> Offset:
        return self.send_many(ops)

    def send_many(
        self, ops: List[WriteOperation], timeout: float = 30.0
    ) -> Offset:
        """Stamp and enqueue a batch of ops under ONE lock acquisition and
        (at most) a few queue puts — bulk ingest sends ~8 ops per document,
        and per-op put/lock overhead dominated the channel cost.

        Ops are chunked to <=64 per queue item so channel capacity keeps
        its backpressure meaning. Same ordering/durability contract as
        send(): stamping, puts, and WAL appends all happen under the
        sender lock, puts precede their chunk's WAL appends."""
        if not ops:
            return Offset(self._offset)
        with self._lock:
            last = Offset(self._offset)
            for i in range(0, len(ops), 64):
                chunk = []
                for op in ops[i : i + 64]:
                    self._offset += 1
                    last = Offset(self._offset)
                    chunk.append(StampedOp(last, op))
                try:
                    self._q.put(chunk, timeout=timeout)
                except queue.Full:
                    # ops stamped in THIS chunk are lost before any WAL
                    # append (no phantom replay); prior chunks are already
                    # published — same at-least-once boundary as send()
                    raise RuntimeError(
                        "op channel full after "
                        f"{timeout}s — is the read-side pump running? "
                        "(flush() more often in synchronous mode)"
                    ) from None
                if self.wal is not None:
                    for stamped in chunk:
                        self.wal.append(stamped)
                self._count.add(len(chunk))
        return last

    def sync_wal(self) -> None:
        """Group-commit: flush+fsync the WAL once per acknowledged batch
        (append itself only buffers — callers sync before acknowledging)."""
        if self.wal is not None:
            self.wal.sync()

    def pending(self) -> int:
        """Ops (not queue items) currently in flight to the read side."""
        return self._count.value()


class OperationReceiver:
    def __init__(
        self, q: "queue.Queue[StampedOp]", count: Optional[_OpCount] = None
    ) -> None:
        self._q = q
        self._count = count or _OpCount()

    def pending_ops(self) -> int:
        """Ops (not queue items) still undelivered — the channel-depth
        gauge (qsize() undercounts: send_many items are chunks)."""
        return self._count.value()

    def recv(self, timeout: Optional[float] = None) -> Optional[StampedOp]:
        """Pop one queue item. send_many() enqueues chunks, so this may
        return a list of StampedOp; drain() always flattens."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        self._count.add(-(len(item) if isinstance(item, list) else 1))
        return item

    def drain(self, max_ops: int = 100_000) -> List[StampedOp]:
        """Drain everything currently queued without blocking (flattens
        send_many() chunks)."""
        out: List[StampedOp] = []
        while len(out) < max_ops:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, list):
                out.extend(item)
                self._count.add(-len(item))
            else:
                out.append(item)
                self._count.add(-1)
        return out


def channel(capacity: int = 10_000) -> Tuple[OperationSender, OperationReceiver]:
    q: "queue.Queue[StampedOp]" = queue.Queue(maxsize=capacity)
    count = _OpCount()
    return OperationSender(q, count), OperationReceiver(q, count)
