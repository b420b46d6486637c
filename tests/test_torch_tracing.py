"""The port's span recorder (``orama_core_tpu_torch/utils/tracing.py``) and
the spans and counters of its served read path, on the CPU.

- Off, every span site returns the one shared null context and records
  nothing; on, spans nest per thread with parent ids, the buffer keeps
  its bound and counts what it drops, and ``enable``/``disable`` may be
  called again.
- Spans share ``torch.profiler``'s host clock: a profiled span encloses
  its own range in a CPU trace; a profiler that starts or stops while a
  profiled span is open on another thread breaks nothing.
- A ``ReadSide`` with the micro-batcher on, serving single-term hybrid and
  vector requests from several threads: one ``read_side.search`` and one
  ``batcher.queued`` a request, each queued span naming a batch that
  exists, and ``search_batch``'s phases covering its span.
- The fused batch's ``chunks``, ``VECTOR_PATH``'s batched labels and
  ``SEARCH_ELAPSED`` in process and over HTTP.
"""

import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from orama_core_tpu_torch.server import metrics as m
from orama_core_tpu_torch.types import SearchParams
from orama_core_tpu_torch.utils import tracing

READ, WRITE = "rk", "wk"
WORDS = ["cat", "dog", "mat", "bird", "sky", "fish", "moon", "rain", "tree"]


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def _docs(n=60, seed=8):
    rng = np.random.default_rng(seed)
    return [{"id": str(i),
             "title": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 8)))),
             "price": int(rng.integers(0, 60))} for i in range(n)]


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """A CPU engine with query batching on (20-ms collector wait)."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig

    tmp = tmp_path_factory.mktemp("tracing")
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp / "w")
    cfg.reader_side.data_dir = str(tmp / "r")
    cfg.writer_side.commit_interval_sec = 3600
    cfg.reader_side.commit_interval_sec = 3600
    cfg.ai.backend = "fake"
    cfg.gpu.query_batching = True
    cfg.gpu.batch_wait_ms = 20.0
    e = build_orama(cfg, start_background=False, device="cpu")
    e.write_side.create_collection("master", "c", READ, WRITE)
    e.flush()
    e.write_side.write("c", _docs(), WRITE)
    e.flush()
    e.commit()
    yield e
    e.close()


def _by_name(recs, name):
    return [r for r in recs if r["name"] == name]


# -- the recorder ----------------------------------------------------------------


SITES = {
    "span": lambda: tracing.span("x", a=1),
    "span_profiled": lambda: tracing.span("x", profile=True, phased=True),
    "span_device": lambda: tracing.span("x", device=torch.device("cpu")),
    "phase": lambda: tracing.phase("x.p"),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_off_records_nothing_and_returns_the_null_context(site):
    tracing.enable()
    tracing.disable()
    null = tracing.span("any")
    ctx = SITES[site]()
    assert ctx is null
    with ctx as s:
        s["hits"] = 10
        assert s.id is None
        tracing.annotate(route="r")
        tracing.record("x", 1, 2, parent=3)
        assert tracing.current_id() is None
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_nesting_and_parent_ids_per_thread():
    tracing.enable()
    ids = {}

    def work(tag):
        with tracing.span("outer", tag=tag) as o:
            assert tracing.current_id() == o.id
            with tracing.span("inner") as i:
                i["k"] = 2
                ids[tag] = (o.id, i.id, threading.get_ident())
            assert tracing.current_id() == o.id
        assert tracing.current_id() is None

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    recs = {r["id"]: r for r in tracing.spans()}
    assert len(recs) == 4
    for tag, (oid, iid, tid) in ids.items():
        outer, inner = recs[oid], recs[iid]
        assert outer["parent"] is None and inner["parent"] == oid
        assert outer["thread"] == inner["thread"] == tid
        assert outer["fields"] == {"tag": tag} and inner["fields"] == {"k": 2}
        assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
            <= outer["end_ns"]
        assert outer["device_ms"] is None


def test_bound_and_drop_counter():
    tracing.enable(capacity=4)
    for i in range(10):
        with tracing.span("s", i=i):
            pass
    recs = tracing.spans()
    assert [r["fields"]["i"] for r in recs] == [6, 7, 8, 9]
    assert tracing.dropped() == 6
    assert len(tracing.spans()) == 4  # a snapshot: the buffer is kept


def test_enable_and_disable_are_idempotent():
    tracing.enable(capacity=2)
    with tracing.span("a"):
        pass
    tracing.enable(capacity=8)   # on already: keeps its records, grows
    tracing.enable(capacity=1)   # never shrinks
    for name in "bcd":
        with tracing.span(name):
            pass
    assert [r["name"] for r in tracing.spans()] == ["a", "b", "c", "d"]
    assert tracing.dropped() == 0 and tracing.enabled()
    tracing.disable()
    tracing.disable()
    assert not tracing.enabled() and len(tracing.spans()) == 4
    tracing.enable()             # off before: a fresh buffer
    assert tracing.spans() == []


def test_phases_tile_their_owner():
    tracing.enable()
    tracing.phase("stray")  # no phased span open: nothing
    with tracing.span("owner", phased=True) as o:
        tracing.phase("p.one")["n"] = 1
        with tracing.span("inside"):
            tracing.phase("ignored")  # the innermost span is no phase
        tracing.annotate(route="r")
        tracing.phase("p.two")
    recs = tracing.spans()
    names = [r["name"] for r in recs]
    assert names == ["inside", "p.one", "p.two", "owner"]
    one, two, owner = recs[1], recs[2], recs[3]
    assert one["parent"] == two["parent"] == o.id
    assert recs[0]["parent"] == one["id"]
    assert one["fields"] == {"n": 1} and owner["fields"] == {"route": "r"}
    assert one["end_ns"] <= two["start_ns"] and two["end_ns"] <= owner["end_ns"]


def test_note_sets_fields_on_the_innermost_open_span():
    tracing.note(lost=1)                     # off: nothing
    tracing.enable()
    tracing.note(lost=2)                     # no span open: nothing
    with tracing.span("owner", phased=True, route="r"):
        tracing.phase("p.one")
        tracing.note(route="kernel")         # the open phase, not its owner
        with tracing.span("inside"):
            tracing.note(k=3)
    recs = {r["name"]: r["fields"] for r in tracing.spans()}
    assert recs == {"inside": {"k": 3}, "p.one": {"route": "kernel"},
                    "owner": {"route": "r"}}


def _profiler_events(prof, name):
    return [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.name() == name]


@pytest.mark.parametrize("kind", ["span", "phase"])
def test_spans_share_the_profilers_clock(kind):
    from torch.profiler import ProfilerActivity, profile

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            if kind == "span":
                with tracing.span("clock.probe", profile=True):
                    torch.ones(256).sum()
                    time.sleep(0.001)
            else:
                with tracing.span("clock.owner", phased=True):
                    tracing.phase("clock.probe")
                    torch.ones(256).sum()
                    time.sleep(0.001)
    recs = _by_name(tracing.spans(), "clock.probe")
    events = sorted(_profiler_events(prof, "clock.probe"))
    assert len(recs) == len(events) == 3
    for r, (s, e) in zip(recs, events):
        assert 0 <= s - r["start_ns"] < 2_000_000, (r, s, e)
        assert 0 <= r["end_ns"] - e < 2_000_000, (r, s, e)


@pytest.mark.parametrize("when", ["starts", "stops"])
def test_profiler_starting_or_stopping_inside_an_open_span(when):
    """A profiled span whose thread sees the profiler start (or stop)
    while it is open closes and records as any other."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    tracing.enable()
    opened, release, errors = threading.Event(), threading.Event(), []

    def work():
        try:
            with tracing.span("across", profile=True):
                opened.set()
                release.wait(10)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    prof = profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    if when == "stops":
        prof.start()
    t = threading.Thread(target=work)
    t.start()
    opened.wait(10)
    if when == "starts":
        prof.start()
    else:
        prof.stop()
    release.set()
    t.join(timeout=10)
    if when == "starts":
        prof.stop()
    assert not t.is_alive() and not errors, errors
    assert [r["name"] for r in tracing.spans()] == ["across"]


# -- the served read path --------------------------------------------------------


def _serve_threads(engine, bodies, n_threads):
    tids, errors = set(), []

    def client(i):
        tids.add(threading.get_ident())
        try:
            for body in bodies[i::n_threads]:
                engine.read_side.search("c", SearchParams.from_json(body), READ)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return tids


@pytest.mark.parametrize("modes", [("hybrid",), ("vector",),
                                   ("hybrid", "vector")])
def test_read_side_spans_of_batched_requests(engine, modes):
    bodies = [{"term": WORDS[i % len(WORDS)], "mode": modes[i % len(modes)],
               "limit": 5} for i in range(24)]
    tracing.enable()
    tids = _serve_threads(engine, bodies, 8)
    recs = tracing.spans()
    assert tracing.dropped() == 0
    by_id = {r["id"]: r for r in recs}
    searches = [r for r in _by_name(recs, "read_side.search")
                if r["thread"] in tids]
    assert len(searches) == len(bodies)
    assert all(r["fields"] == {"batched": True} for r in searches)
    hits = [r for r in _by_name(recs, "read_side.hits") if r["thread"] in tids]
    assert sorted(r["parent"] for r in hits) == sorted(r["id"] for r in searches)
    mine = {r["id"] for r in searches}
    queued = [r for r in _by_name(recs, "batcher.queued") if r["parent"] in mine]
    assert sorted(r["parent"] for r in queued) == sorted(mine)
    batches = {r["id"]: r for r in _by_name(recs, "batcher.batch")}
    served = 0
    for q in queued:
        b = batches[q["fields"]["batch"]]
        assert q["start_ns"] <= q["end_ns"] <= b["start_ns"] + 1_000_000
        served += 1
    assert served == len(bodies)
    sb = [r for r in _by_name(recs, "search_batch")
          if by_id.get(r["parent"], {}).get("name") == "batcher.batch"
          and r["parent"] in {q["fields"]["batch"] for q in queued}]
    assert sum(r["fields"]["n"] for r in sb) == len(bodies)
    for r in sb:
        assert r["fields"]["route"] in ("fused_hybrid", "fused_vector")
        phases = sorted((p["start_ns"], p["end_ns"]) for p in recs
                        if p["parent"] == r["id"]
                        and p["name"].startswith("search_batch."))
        covered = 0
        last = r["start_ns"]
        for s, e in phases:
            covered += max(0, e - max(s, last))
            last = max(last, e)
        span = r["end_ns"] - r["start_ns"]
        assert covered >= 0.9 * span, (r, phases)
        names = {p["name"] for p in recs if p["parent"] == r["id"]}
        assert {"search_batch.plan", "search_batch.dispatch",
                "search_batch.sync", "search_batch.reply"} <= names
        if r["fields"]["route"] == "fused_vector" or "hybrid" in modes:
            assert "search_batch.embed" in names
    fills = [r for r in _by_name(recs, "batcher.fill")
             if r["fields"].get("n", 0) >= 1]
    assert fills and all(r["fields"]["groups"] >= 1 for r in fills)


@pytest.mark.parametrize("b", [3, 9, 17])
def test_fused_batch_chunks(engine, monkeypatch, b):
    """``chunks`` is ceil(b / chunk) under a smaller dense-slot budget (a
    chunk of 4 rows), one dispatch phase and one set of fused spans a
    chunk."""
    from orama_core_tpu_torch.engine.collection_read import CollectionReader

    reader = engine.read_side._reader("c")
    monkeypatch.setattr(CollectionReader, "_BATCH_DENSE_SLOTS",
                        reader.capacity * 4)
    params = [SearchParams.from_json({"term": WORDS[i % len(WORDS)],
                                      "mode": "hybrid"}) for i in range(b)]
    tracing.enable()
    out = reader.search_batch(params, engine.read_side.ai)
    assert len(out) == b
    recs = tracing.spans()
    (sb,) = _by_name(recs, "search_batch")
    chunks = -(-b // 4)
    assert sb["fields"] == {"n": b, "route": "fused_hybrid", "chunks": chunks}
    dispatch = [r for r in recs if r["name"] == "search_batch.dispatch"]
    assert [r["fields"]["chunk"] for r in dispatch] == list(range(chunks))
    for name in ("fused.bm25", "fused.vector", "fused.rank"):
        fused = _by_name(recs, name)
        assert len(fused) == chunks
        assert {r["parent"] for r in fused} == {r["id"] for r in dispatch}
        assert all(r["device_ms"] is None for r in fused)  # no CUDA stream
    plan = [r for r in recs if r["name"] == "search_batch.plan"
            and "dense_terms" in r["fields"]]
    assert len(plan) == 1
    assert plan[0]["fields"]["dense_terms"] + plan[0]["fields"]["k1_terms"] >= b


def _fast_reader():
    """A port reader the fused kNN serves: 8,192 unit rows of 128-d
    (``fake-small``), committed, one embedding field."""
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import CollectionReader
    from orama_core_tpu_torch.index import CommittedVectorIndex
    from orama_core_tpu_torch.oplog import CreateFieldOp
    from orama_core_tpu_torch.types import TypedField, ValueType

    n, d = 8192, 128
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    r = CollectionReader("vfast", "rk", None, GpuConfig(device="cpu"))
    r._apply_locked(CreateFieldOp("vfast", TypedField(
        0, "embedding", ValueType.EMBEDDING, model="fake-small")))
    r.max_doc_id = n - 1
    r._alive = np.ones(r.capacity, dtype=np.float32)
    r.doc_count = n
    r._vector[0].committed = CommittedVectorIndex(
        dimension=d, vecs=vecs, vec_docs=np.arange(n, dtype=np.int32))
    return r


@pytest.mark.parametrize("mode", ["fulltext", "hybrid", "vector", "knn"])
def test_vector_path_counts_each_batch_once(engine, mode):
    from orama_core_tpu_torch.models.ai_service import AIService

    if mode == "knn":
        reader, ai, label = _fast_reader(), AIService(), "batch_knn_fast"
        body = {"mode": "vector", "limit": 5}
        single = "fast"
    else:
        reader, ai = engine.read_side._reader("c"), engine.read_side.ai
        label, body, single = f"batch_fused_{mode}", {"mode": mode}, f"fused_{mode}"
    params = [SearchParams.from_json(dict(body, term=WORDS[i]))
              for i in range(5)]
    labels = (label, single, "fast_sharded")
    before = [m.VECTOR_PATH.get(path=p) for p in labels]
    for _ in range(2):
        assert len(reader.search_batch(params, ai)) == 5
    after = [m.VECTOR_PATH.get(path=p) for p in labels]
    assert [a - b for a, b in zip(after, before)] == [2, 0, 0]


def _search_count(cid):
    for line in m.SEARCH_ELAPSED.expose():
        if line.startswith(f'reader_search_elapsed_sec_count{{collection="{cid}"}}'):
            return int(line.rsplit(" ", 1)[1])
    return 0


@pytest.mark.parametrize("via", ["in_process", "http"])
def test_search_elapsed_counts_each_search_once(tmp_path, via):
    import json

    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import HttpConfig, OramaxConfig
    from orama_core_tpu_torch.server import http

    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp_path / "w")
    cfg.reader_side.data_dir = str(tmp_path / "r")
    cfg.ai.backend = "fake"
    e = build_orama(cfg, start_background=False, device="cpu")
    cid = f"elapsed_{via}"
    ws = None
    try:
        e.write_side.create_collection("master", cid, READ, WRITE)
        e.flush()
        e.write_side.write(cid, _docs(12), WRITE)
        e.flush()
        before = _search_count(cid)
        bodies = [{"term": w} for w in WORDS[:3]]
        if via == "http":
            ws = http.WebServer(e, HttpConfig(host="127.0.0.1", port=0))
            ws.start_background()
            for body in bodies:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{ws.port}/v1/collections/{cid}/search"
                    f"?api-key={READ}", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert r.status == 200
        else:
            for body in bodies:
                e.read_side.search(cid, SearchParams.from_json(body), READ)
        assert _search_count(cid) - before == len(bodies)
    finally:
        if ws is not None:
            ws.stop()
        e.close()


def test_batcher_counters_observe_each_batch_and_request():
    from orama_core_tpu_torch.server.batcher import MicroBatcher

    def count(h):
        return sum(n for _c, _t, n in h._data.values())

    sizes0, waits0 = count(m.BATCH_SIZE), count(m.BATCH_QUEUE_WAIT)
    calls = []
    b = MicroBatcher(lambda key, ps: calls.append(len(ps)) or ps,
                     max_batch=8, max_wait_ms=20)
    threads = [threading.Thread(target=b.submit, args=(("k",), i))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    b.stop()
    assert not any(t.is_alive() for t in threads)
    assert count(m.BATCH_SIZE) - sizes0 == len(calls)
    assert count(m.BATCH_QUEUE_WAIT) - waits0 == 6
