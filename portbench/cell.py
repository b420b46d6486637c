"""One run of one cell: set up, serve the mix's loop for the window, check.

Set-up makes the configuration's collection and the mix's requests from
``--seed``, builds the program's committed reader from the arrays
(``engine.carry.reader_from_arrays``) and places it in a ``ReadSide``
whose ``GpuConfig`` is the configuration's ``serving`` block (query
batching on: every request goes ``ReadSide.search`` -> the micro-batcher
-> ``CollectionReader.search_batch``, as an HTTP handler thread's does).
One direct ``search_batch`` of a full batch loads the kernels, then the
mix's loop (``portbench/loops/<loop>.py``) runs ``warmup_rounds``
requests a client before the window opens. The window closes after
``seconds``, the requests in flight are waited for, the peak memory is
read, the program is freed, and a sample of the window's replies is
compared with the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import compare, spec, trace, trafficgen


@dataclasses.dataclass
class Window:
    """What the per-layer readers read (``portbench/metrics``)."""

    t0: float
    t1: float
    requests: List[Tuple[int, float, float, bool]]   # (client, t_call, t_ret, ok)
    answered: int                                     # ok replies inside [t0, t1]
    batches: List[Tuple[float, float, List[int]]]     # (start, end, clients)
    trace: Optional[trace.Trace]
    records: Dict[str, list]                          # the readers' own records
    capacity: int                                     # docs the reader scores
    cell: spec.Cell


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else math.nan


def _slices(ts: List[float], t0: float, t1: float, width: float) -> List[int]:
    """Counts of the times ``ts`` in consecutive ``width``-s slices of [t0, t1)."""
    n = max(1, int((t1 - t0) // width))
    counts = [0] * n
    for t in ts:
        i = int((t - t0) // width)
        if 0 <= i < n:
            counts[i] += 1
    return counts


def _reply_tuple(result) -> compare.Reply:
    return ([int(h.id) for h in result.hits], [float(h.score) for h in result.hits],
            int(result.count))


def _gpu_config(cell: spec.Cell, device: str, overrides: Dict[str, Any]):
    from orama_core_tpu_torch.config import GpuConfig

    kw = dict(cell.config["serving"], device=device)
    kw.update(overrides)
    return GpuConfig(**kw)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str, t_start: float, serving: Optional[Dict[str, Any]] = None,
             keep_every: Optional[int] = None, log=print) -> Dict[str, Any]:
    """The result line's keys of one run (``checks`` last), and on stderr
    (``log``) the steps. ``serving`` overrides keys of the configuration's
    ``serving`` block and ``keep_every`` the mix's (the int8 control of
    ``portbench/readings.py``, which keeps every reply)."""
    import orama_core_tpu_torch as port
    from orama_core_tpu_torch.config import ReaderSideConfig
    from orama_core_tpu_torch.engine.carry import reader_from_arrays
    from orama_core_tpu_torch.engine.document_storage import DocumentStorage
    from orama_core_tpu_torch.engine.read_side import ReadSide
    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.oplog import channel
    from orama_core_tpu_torch.server import metrics as port_metrics
    from orama_core_tpu_torch.types import SearchParams

    def step(what: str) -> None:
        log(f"set-up {time.perf_counter() - t_start:8.3f} s: {what}")

    port.configure_torch()
    dev = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    step("imports")
    gen = spec.generator(cfg["generator"])
    raw = gen.make(cfg, seed, dev)
    step(f"collection {cfg['name']} drawn ({raw['seconds']:.2f} s)")
    gpu_cfg = _gpu_config(cell, device, serving or {})
    reader = reader_from_arrays(**gen.reader_kwargs(raw, cfg), gpu_cfg=gpu_cfg)
    step("reader built")
    reader.warmup()
    step("reader warmed")
    capacity = int(reader.capacity)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    ai = AIService(device=device)
    rx = channel()[1]
    rs = ReadSide(ReaderSideConfig(data_dir=tmp), rx, ai, gpu_cfg)
    cid = cfg["name"]
    rs.collections[cid] = reader
    rs.doc_storage[cid] = DocumentStorage(f"{tmp}/docs/{cid}")
    reqs = trafficgen.requests(mix, seed)
    params = [[SearchParams.from_json(b) for _k, b in row] for row in reqs]
    vec = cfg.get("vector")
    if vec:  # the query embedder's token cache, as a serving process holds it
        words = sorted({w for row in reqs for _k, b in row for w in b["term"].split()})
        ai.embed_query(vec["model"], words)
    step("requests made")

    first = [row[0] for row in params][: gpu_cfg.batch_max]
    reader.search_batch(first, ai)  # loads (first run: builds) the kernels
    step(f"first search_batch of {len(first)}")

    records: Dict[str, list] = {}
    batches: List[Tuple[float, float, List[int]]] = []
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in cell.per_layer}
    prof = None
    # every run lists its batches (start, end, clients); the traced run
    # also marks each in the trace
    client_of = {id(p): c for c, row in enumerate(params) for p in row}
    inner = reader.search_batch

    def search_batch(params_list, ai_service):
        t_b = time.perf_counter()
        with (torch.profiler.record_function(trace.BATCH) if traced
              else contextlib.nullcontext()):
            out = inner(params_list, ai_service)
        batches.append((t_b, time.perf_counter(),
                        [client_of.get(id(p), -1) for p in params_list]))
        return out

    reader.search_batch = search_batch
    if traced:
        hooks = Window(0.0, 0.0, [], 0, batches, None, records, capacity, cell)
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(hooks)

    # the set-up's objects (the collection's index, the request pool) leave
    # the collector's generations, so that its full passes in the window
    # scan only what the window allocates
    gc.collect()
    gc.freeze()
    loop = spec.loop(mix["loop"]).Loop(
        lambda p: rs.search(cid, p, "read-key", with_documents=False),
        params, trafficgen.kept_offsets(mix, seed),
        keep_every or int(mix["keep_every"]), mix)
    loop.start()
    loop.warm(int(mix["warmup_rounds"]), timeout_s=300.0)
    step(f"{mix['warmup_rounds']} rounds of the loop")
    if traced:
        prof = trace.profiler(dev.type)
        prof.start()
    with (torch.profiler.record_function(trace.WINDOW) if traced
          else contextlib.nullcontext()):
        t0 = time.perf_counter()
        time.sleep(seconds)
    t1 = time.perf_counter()
    setup_s = t0 - t_start
    if prof is not None:
        prof.stop()
    loop.close(t1, timeout_s=60.0)
    log(f"window {t1 - t0:.3f} s closed; set-up {setup_s:.3f} s")
    sizes = [len(b[2]) for b in batches if t0 <= b[0] < t1]
    log(f"batches in the window: {len(sizes)}, "
        f"{sum(sizes) / max(1, len(sizes)):.2f} requests each")
    log("replies per 5 s of the window: " + " ".join(
        str(n) for n in _slices([tr_ for rec in loop.records
                                 for _tc, tr_, ok, _n in rec if ok], t0, t1, 5.0)))
    # the program counts the routes of single-query vector searches only:
    # a batched cell that took its batched route reads none here
    log("single-query vector routes: "
        + "; ".join(port_metrics.VECTOR_PATH.expose()[2:]))

    gc.unfreeze()
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    tr = trace.read(prof, t0, t1) if prof is not None else None
    del prof
    rs.close()
    loop.search = None
    reader.__dict__.pop("search_batch", None)
    del rs, reader, ai, rx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    window_reqs = [(c, tc, tr_, ok) for c, rec in enumerate(loop.records)
                   for tc, tr_, ok, _n in rec if t0 <= tc < t1]
    answered = sum(1 for c, rec in enumerate(loop.records)
                   for tc, tr_, ok, _n in rec if ok and t0 <= tr_ <= t1)
    failed = sum(1 for r in window_reqs if not r[3])

    # the comparison: a sample, drawn from the seed, of the window's replies
    keys = sorted(k for k, reply in loop.replies.items()
                  if not isinstance(reply, Exception)
                  and t0 <= loop.records[k[0]][k[1]][0] < t1)
    rng = np.random.default_rng([int(seed), 3])
    pick = rng.choice(len(keys), size=min(len(keys), int(mix["check_sample"])),
                      replace=False) if keys else []
    sample = [keys[i] for i in sorted(pick)]
    kinds = [reqs[c][n % len(reqs[c])][0] for c, n in sample]
    texts = [params[c][n % len(params[c])].term for c, n in sample]
    replies = [_reply_tuple(loop.replies[k]) for k in sample]
    t = time.perf_counter()
    ref = spec.reference(cfg["reference"])
    values = (compare.numbers(ref, raw, cfg, mix, kinds, texts, replies, dev)
              if sample else {})
    log(f"reference over {len(sample)} replies in {time.perf_counter() - t:.2f} s")
    correct = bool(sample) and failed == 0 and compare.verdict(values, cell.limits)

    if traced:
        w = Window(t0, t1, window_reqs, answered, batches, tr, records, capacity, cell)
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat = [(tr_ - tc) * 1e3 if ok else math.inf for _c, tc, tr_, ok in window_reqs]
        e2e = {"qps": answered / (t1 - t0), "p50_ms": _percentile(lat, 50),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    out: Dict[str, Any] = {
        "correct": correct,
        "attempted": len(window_reqs),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": mem_peak,
        },
    }
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": trace.top_device_ops(tr),
                            "idle_gaps": trace.idle_gaps(tr, [b[:2] for b in batches])}
    checks = {"failed": [failed, 0]}
    for k, lim in cell.limits.items():
        checks[k] = [values.get(k, math.nan), lim]
    out["checks"] = checks
    shutil.rmtree(tmp, ignore_errors=True)
    return out
