"""Structured tracing: leveled logs, and spans recorded in memory while on.

Counterpart of the reference's tracing stack (`bin/oramacore.rs:44-59`:
tracing-subscriber compact fmt layer + optional JSON file layer, EnvFilter
from RUST_LOG; per-request spans via tower-http). Logs: stdlib logging,
``ORAMAX_LOG`` plays the EnvFilter role.

Spans are off by default. ``enable(capacity)`` starts recording and
``disable()`` stops; both may be called again and from several readers.
While off, ``span()`` and ``phase()`` return one shared null context,
which reads no clock and records nothing. While on, each span closes
into a bounded in-memory buffer as one record (``spans()``): its name,
``start_ns`` and ``end_ns`` from ``time.time_ns()``, its thread, its id,
its parent's id (the thread's innermost open span, or for ``record()``
one passed across threads) and its fields. ``time.time_ns()`` reads the clock on which
``torch.profiler`` stamps host events on Linux, so spans fall on a
profiler trace's timeline unmapped. A span opened with ``profile=True`` is
also a profiler range of the same name: a function-scope record, as
torch's own ops are, where ``record_function``'s user-scope range would
also put a copy of itself over its kernels on the device's timeline,
which a reader of device activity counts as busy (and it costs ~10x
more). One given a CUDA ``device`` records a pair of CUDA events on that
device's current stream, read as ``device_ms`` only when the buffer is
read. A span opened with ``phased=True`` owns phases: ``phase(name)``
closes its open phase, if any, and opens the next, and the owner's close
closes the last, so the phases of a call tile it however its code
branches.

Port of ``orama_core_tpu/utils/tracing.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``; the span recorder is the port's.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_LOGGER = logging.getLogger("oramax")
_configured = False
_local = threading.local()


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname.lower(),
            "target": record.name,
            "message": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out, ensure_ascii=False)


def configure(level: Optional[str] = None, file_path: Optional[str] = None) -> None:
    """Install handlers (idempotent). Level resolution: arg > ORAMAX_LOG >
    info."""
    global _configured
    if _configured:
        return
    level = (level or os.environ.get("ORAMAX_LOG") or "info").upper()
    _LOGGER.setLevel(getattr(logging, level, logging.INFO))
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s")
    )
    _LOGGER.addHandler(console)
    if file_path:
        fh = logging.FileHandler(file_path)
        fh.setFormatter(_JsonFormatter())
        _LOGGER.addHandler(fh)
    _configured = True


def log(level: str, message: str, **fields: Any) -> None:
    configure()
    rec_level = getattr(logging, level.upper(), logging.INFO)
    _LOGGER.log(rec_level, message, extra={"fields": fields or None})


# -- spans ---------------------------------------------------------------------

_on = False
_lock = threading.Lock()
_buf: "collections.deque" = collections.deque(maxlen=1)
_dropped = 0
_ids = itertools.count(1)


class _Null:
    """The span while tracing is off: no clock, no record."""

    __slots__ = ()
    id = None

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key: str, value: Any) -> None:
        pass


_NULL = _Null()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _append(rec: tuple) -> None:
    global _dropped
    with _lock:
        if len(_buf) == _buf.maxlen:
            _dropped += 1
        _buf.append(rec)


class _Span:
    __slots__ = ("name", "fields", "id", "parent", "start_ns", "owner",
                 "phased", "open_phase", "_profile", "_range", "_device",
                 "_events")

    def __init__(self, name: str, parent: Optional[int], profile: bool,
                 device, phased: bool, fields: Dict[str, Any]) -> None:
        self.name = name
        self.fields = fields
        self.id = next(_ids)
        self.parent = parent
        self.owner: Optional[_Span] = None   # set on a phase
        self.phased = phased
        self.open_phase: Optional[_Span] = None
        self._profile = profile
        self._range = None
        self._device = (device if device is not None
                        and getattr(device, "type", None) == "cuda" else None)
        self._events = None

    def __setitem__(self, key: str, value: Any) -> None:
        self.fields[key] = value

    def __enter__(self) -> "_Span":
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1].id
        stack.append(self)
        self.start_ns = time.time_ns()
        if self._profile:
            import torch

            if torch.autograd.profiler._is_profiler_enabled:
                self._range = torch._C._profiler._RecordFunctionFast(self.name)
                self._range.__enter__()
        if self._device is not None:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
            self._events = (ev,)
        return self

    def __exit__(self, *exc) -> bool:
        if self.open_phase is not None:
            self.open_phase.__exit__(None, None, None)
        if self._events is not None:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
            self._events = (self._events[0], ev)
        if self._range is not None:
            try:
                self._range.__exit__(None, None, None)
            except RuntimeError:  # a profiler started after the enter
                pass
        end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # closed out of order (a generator's span)
            stack.remove(self)
        if self.owner is not None and self.owner.open_phase is self:
            self.owner.open_phase = None
        _append((self.name, self.start_ns, end_ns, threading.get_ident(),
                 self.id, self.parent, self.fields, self._events))
        return False


def span(name: str, *, profile: bool = False, device=None,
         phased: bool = False, **fields: Any):
    """A span to use in a ``with`` statement; what it yields takes more
    fields (``s["hits"] = 10``). ``profile`` makes it a profiler range
    while a profiler runs; a CUDA ``device`` (a ``torch.device``) times
    it on that device's current stream; ``phased`` lets ``phase()`` tile
    it. Off: the shared null context."""
    if not _on:
        return _NULL
    return _Span(name, None, profile, device, phased, fields)


def phase(name: str, **fields: Any):
    """Close the open phase of the innermost ``phased`` span of this
    thread and open the next, a profiler range too. Returns it (it takes
    fields as a span does); a no-op where no phased span is open, or the
    innermost open span is not it or its phase."""
    if not _on:
        return _NULL
    stack = _stack()
    if not stack:
        return _NULL
    top = stack[-1]
    owner = top.owner if top.owner is not None else top
    if not owner.phased:
        return _NULL
    if owner.open_phase is not None:
        owner.open_phase.__exit__(None, None, None)
    ph = _Span(name, owner.id, True, None, False, fields)
    ph.owner = owner
    owner.open_phase = ph
    return ph.__enter__()


def annotate(**fields: Any) -> None:
    """Set fields on the innermost ``phased`` span open on this thread."""
    if not _on:
        return
    for s in reversed(_stack()):
        if s.phased:
            s.fields.update(fields)
            return


def note(**fields: Any) -> None:
    """Set fields on the innermost span open on this thread, whatever it
    is (a no-op while off or outside every span)."""
    if not _on:
        return
    stack = _stack()
    if stack:
        stack[-1].fields.update(fields)


def current_id() -> Optional[int]:
    """The id of this thread's innermost open span (None while off)."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1].id if stack else None


def record(name: str, start_ns: int, end_ns: int, *,
           parent: Optional[int] = None, **fields: Any) -> None:
    """Record a span whose ends were stamped elsewhere (``time.time_ns()``)."""
    if _on:
        _append((name, start_ns, end_ns, threading.get_ident(), next(_ids),
                 parent, fields, None))


def enable(capacity: int = 1 << 20) -> None:
    """Start recording into a buffer of ``capacity`` records (the oldest
    go past it, counted by ``dropped()``). Already on: the buffer keeps
    its records and grows to ``capacity`` if that is larger."""
    global _on, _buf, _dropped
    with _lock:
        if _on:
            if capacity > _buf.maxlen:
                _buf = collections.deque(_buf, maxlen=capacity)
            return
        _buf = collections.deque(maxlen=capacity)
        _dropped = 0
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays readable until the next
    ``enable()``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def dropped() -> int:
    """Records lost to the buffer's bound since ``enable()``."""
    return _dropped


def spans() -> List[Dict[str, Any]]:
    """A snapshot of the buffer, oldest first; the buffer is kept. A
    device-timed span's ``device_ms`` waits for its end event."""
    with _lock:
        recs = list(_buf)
    out = []
    for name, s, e, tid, sid, parent, fields, events in recs:
        device_ms = None
        if events is not None and len(events) == 2:
            events[1].synchronize()
            device_ms = float(events[0].elapsed_time(events[1]))
        out.append({"name": name, "start_ns": s, "end_ns": e, "thread": tid,
                    "id": sid, "parent": parent, "fields": dict(fields),
                    "device_ms": device_ms})
    return out
