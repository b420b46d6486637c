"""The traced window: device intervals and host activity from torch.profiler.

The window is the span of the ``portbench.window`` range that the run
opens when its measured window starts and closes when it ends. Device
operations (kernels, copies, fills) are clipped to it; ``busy_s`` is the
length of their union, so operations that overlap count once. Host times
of the harness (``time.perf_counter``) map onto the trace's clock through
the window's two ends.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
BATCH = "portbench.search_batch"
MIN_GAP_NS = 20_000  # idle gaps shorter than 20 us are not labelled


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device: List[Tuple[str, int, int]]      # (name, start ns, end ns), by start
    host: List[Tuple[str, int, int, int]]   # (name, start ns, end ns, thread)
    ns0: int                                # the window's start, trace clock
    t0: float                               # and host clock
    scale: float                            # trace ns per host second

    def ns(self, t: float) -> int:
        return int(self.ns0 + (t - self.t0) * self.scale)


def profiler(device_type: str):
    """A torch.profiler over CPU ops of every thread (where this torch
    offers it) and, on a card, the device."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        cfg = None
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def _events(prof):
    """(name, device?, start ns, end ns, thread) of every profiled event."""
    from torch.autograd import DeviceType

    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        for e in res.events():
            yield (e.name(), e.device_type() != DeviceType.CPU, e.start_ns(),
                   e.end_ns(), e.start_thread_id())
        return
    for e in prof.events():  # older profilers: FunctionEvents in us
        yield (e.name, e.device_type != DeviceType.CPU,
               int(e.time_range.start * 1e3), int(e.time_range.end * 1e3),
               e.thread)


def read(prof, t0: float, t1: float) -> Optional[Trace]:
    """The trace of a window that ran from ``t0`` to ``t1`` (host clock)."""
    device, host = [], []
    window = None
    for name, on_device, s, e, tid in _events(prof):
        if on_device:
            if not name.startswith("portbench."):  # the device-side copy of
                device.append((name, s, e))        # a harness range is no op
        else:
            host.append((name, s, e, tid))
            if name == WINDOW:
                window = (s, e)
    if window is None:
        return None
    w0, w1 = window
    device = sorted(((n, max(s, w0), min(e, w1)) for n, s, e in device
                     if e > w0 and s < w1), key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=_union_ns(device) / 1e9,
                 device=device, host=host, ns0=w0, t0=t0,
                 scale=(w1 - w0) / max(t1 - t0, 1e-9))


def _merged(device) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for _n, s, e in device:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union_ns(device) -> int:
    return sum(e - s for s, e in _merged(device))


def top_device_ops(tr: Trace, n: int = 10) -> List[List]:
    by: Dict[str, int] = {}
    for name, s, e in tr.device:
        key = name[:120]
        by[key] = by.get(key, 0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]


def idle_gaps(tr: Trace, batch_spans, n: int = 10) -> List[List]:
    """The device's idle time in the window, summed by what the batcher's
    thread was doing at each gap's middle: inside a ``search_batch`` call
    (``batch_spans``: (start, end) by the host clock), the innermost
    profiled host op there if the trace holds that thread's ops; or
    ``between search_batch calls``."""
    if not tr.device:
        return []
    batches = sorted((tr.ns(s), tr.ns(e)) for s, e in batch_spans)
    tids = {h[3] for h in tr.host if h[0] == BATCH}
    ops = [h for h in tr.host if h[3] in tids and h[0] != BATCH]
    starts = [h[1] for h in ops]
    b_starts = [b[0] for b in batches]
    spans = _merged(tr.device)
    gaps = []
    prev = None
    for s, e in spans:
        if prev is not None and s - prev >= MIN_GAP_NS:
            gaps.append((prev, s))
        prev = e
    by: Dict[str, int] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "between search_batch calls"
        j = bisect.bisect_right(b_starts, mid) - 1
        if j >= 0 and batches[j][1] >= mid:
            label = "search_batch: host python"
            i = bisect.bisect_right(starts, mid) - 1
            for k in range(i, max(i - 200, -1), -1):
                if ops[k][2] >= mid and ops[k][1] >= batches[j][0]:
                    label = "search_batch: " + ops[k][0][:100]
                    break
        by[label] = by.get(label, 0) + (g1 - g0)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]


def kernel_launches(tr: Trace) -> int:
    """Device kernels in the window (copies and fills by the copy
    engines are not launches; their names start with Memcpy or Memset)."""
    return sum(1 for name, _s, _e in tr.device
               if not name.startswith(("Memcpy", "Memset")))
