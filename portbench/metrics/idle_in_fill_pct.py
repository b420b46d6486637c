"""Share of the device's idle time in the window that falls inside the
program's ``batcher.fill`` spans, in %: the idle time the micro-batcher's
wait for a batch accounts for. Idle is the window less the union of the
device's operation intervals (``portbench/trace.py``)."""

from portbench import spans, trace


def install(w):
    spans.install()


def read(w):
    tr, fills = w.trace, spans.named(w, "batcher.fill")
    if tr is None or not tr.device or not fills:
        return None
    w0, w1 = tr.ns0, tr.ns0 + int(tr.window_s * 1e9)
    idle, prev = [], w0
    for s, e in trace._merged(tr.device):
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        idle.append((prev, w1))
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    inside, i = 0, 0
    for f in sorted(fills, key=lambda s: s["start_ns"]):
        f0, f1 = f["start_ns"], f["end_ns"]
        while i < len(idle) and idle[i][1] <= f0:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < f1:
            inside += min(idle[j][1], f1) - max(idle[j][0], f0)
            j += 1
    return 100.0 * inside / total
