"""The program's own spans in a traced run, for the readers that read them.

The program (``orama_core_tpu_torch/utils/tracing.py``) records spans in
memory while its recorder is on, which it is not by default. A reader's
``install`` turns it on (``install()``), so only the traced run records.
``named(w, name)`` gives the spans of that name that lie inside the
trace's window, ``[w.trace.ns0, w.trace.ns0 + w.trace.window_s * 1e9]``:
the recorder stamps with ``time.time_ns()``, the clock on which
torch.profiler stamps host events on Linux, so no mapping is needed. It
gives None where the program has no recorder (a program older than it),
the run has no trace, or the recorder dropped a span.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

CAPACITY = 1 << 22  # records: a 30-s window of either cell holds ~2e5
KEY = "program_spans"


def _recorder():
    try:
        from orama_core_tpu_torch.utils import tracing
    except ImportError:
        return None
    if not all(hasattr(tracing, f) for f in ("enable", "spans", "dropped")):
        return None
    return tracing


def install() -> None:
    rec = _recorder()
    if rec is not None:
        rec.enable(capacity=CAPACITY)


def _window(w) -> Optional[Dict[str, List[Dict[str, Any]]]]:
    """The window's spans by name, read once a run (kept in ``w.records``)."""
    if KEY in w.records:
        return w.records[KEY]
    rec, tr = _recorder(), w.trace
    by: Optional[Dict[str, List[Dict[str, Any]]]] = None
    if rec is not None and tr is not None and not rec.dropped():
        lo, hi = tr.ns0, tr.ns0 + tr.window_s * 1e9
        by = {}
        for s in rec.spans():
            if s["start_ns"] >= lo and s["end_ns"] <= hi:
                by.setdefault(s["name"], []).append(s)
    w.records[KEY] = by
    return by


def named(w, name: str) -> Optional[List[Dict[str, Any]]]:
    by = _window(w)
    if by is None:
        return None
    return by.get(name) or None


def ms(s: Dict[str, Any]) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def per_batch_ms(w, *names: str) -> Optional[float]:
    """The time of the named spans in the window, summed, per
    ``search_batch`` call in the window, in ms."""
    batches = named(w, "search_batch")
    found = [s for n in names for s in (named(w, n) or [])]
    if not batches or not found:
        return None
    return sum(ms(s) for s in found) / len(batches)


def device_ms_per_query(w, name: str) -> Optional[float]:
    """The device time of the named spans (their CUDA event pairs) in the
    window, per request answered in it, in ms."""
    found = named(w, name)
    if not found or not w.answered:
        return None
    dev = [s["device_ms"] for s in found if s.get("device_ms") is not None]
    if len(dev) != len(found):
        return None
    return sum(dev) / w.answered
