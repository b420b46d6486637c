"""Structured tracing: spans + leveled logs, console and optional JSON file.

Counterpart of the reference's tracing stack (`bin/oramacore.rs:44-59`:
tracing-subscriber compact fmt layer + optional JSON file layer, EnvFilter
from RUST_LOG; per-request spans via tower-http). Here: stdlib logging with
a span context manager that records elapsed time and emits one structured
record per span close; ``ORAMAX_LOG`` plays the EnvFilter role.

Port of ``orama_core_tpu/utils/tracing.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, Iterator, Optional

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


def _span_stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


@contextlib.contextmanager
def span(name: str, **fields: Any) -> Iterator[Dict[str, Any]]:
    """Timed span; nested spans record their parent. The yielded dict accepts
    extra fields (span["hits"] = 10) recorded at close."""
    configure()
    stack = _span_stack()
    info: Dict[str, Any] = dict(fields)
    parent = stack[-1][0] if stack else None
    t0 = time.perf_counter()
    stack.append((name, info))
    try:
        yield info
    finally:
        stack.pop()
        elapsed = time.perf_counter() - t0
        payload = {"span": name, "elapsed_ms": round(elapsed * 1e3, 3), **info}
        if parent:
            payload["parent"] = parent
        _LOGGER.debug("span close", extra={"fields": payload})


def current_span() -> Optional[str]:
    stack = _span_stack()
    return stack[-1][0] if stack else None
