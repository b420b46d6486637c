"""Query micro-batching: coalesce concurrent searches into one device call.

No counterpart in the reference (its per-query Rust scan doesn't benefit);
on TPU batched queries are nearly free — a [B, D] x [D, P] matmul costs
almost the same HBM traffic as [1, D] — so batching is the single biggest
serving-throughput lever. HTTP handler threads submit queries and block;
a collector thread drains the queue every ``max_wait_ms`` (or when
``max_batch`` is reached) and runs one batched search per compatibility
group (same collection/mode/filters/properties).

Port of ``orama_core_tpu/server/batcher.py``: host code, copied as it is.
On the card the same holds: a batch reads the corpus once for all its
queries (K2, the corpus product, one K1 launch over the batch's plan).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class _Pending:
    key: Tuple
    payload: Any
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    # set by a timed-out submitter: the collector drops the entry instead of
    # burning a device batch on a result nobody will read (overload would
    # otherwise AMPLIFY — dead work keeps the backlog that caused the
    # timeouts). Best-effort: an entry already inside a running batch
    # completes anyway.
    abandoned: bool = False


class MicroBatcher:
    """Generic request coalescer.

    ``run_batch(key, payloads) -> results`` executes one compatibility
    group; submit() blocks the caller until its result is ready."""

    def __init__(
        self,
        run_batch: Callable[[Tuple, List[Any]], List[Any]],
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        submit_timeout_s: float = 120.0,
    ) -> None:
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        # must exceed a worst-case first compile (minutes on a dev relay;
        # seconds co-located) or cold-start queries spuriously time out
        self.submit_timeout = submit_timeout_s
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, key: Tuple, payload: Any, timeout: Optional[float] = None) -> Any:
        p = _Pending(key=key, payload=payload)
        self._q.put(p)
        if not p.event.wait(self.submit_timeout if timeout is None else timeout):
            p.abandoned = True
            raise TimeoutError("batched query timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            groups: Dict[Tuple, List[_Pending]] = {}
            for p in batch:
                if p.abandoned:
                    continue  # shed dead work (submitter already timed out)
                groups.setdefault(p.key, []).append(p)
            for key, group in groups.items():
                try:
                    results = self._run_batch(key, [p.payload for p in group])
                    for p, r in zip(group, results):
                        p.result = r
                except BaseException as e:  # propagate to every waiter
                    for p in group:
                        p.error = e
                finally:
                    for p in group:
                        p.event.set()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
