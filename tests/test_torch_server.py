"""The port's HTTP server (``orama_core_tpu_torch/server/http.py``) on the
CPU: tests/test_server.py's thirteen cases against a port engine
(``device="cpu"``, fake AI backend), and one sequence of requests sent to
the reference's server and the port's, whose statuses and bodies must be
equal (``elapsed`` timings dropped, scores within rtol 1e-5).

Hooks: installing one answers 501 (the JS runtime is not ported yet);
listing, fetching and removing stored hooks work as in the reference."""

import json
import os
import urllib.error
import urllib.request

import pytest


def _engine(tmp_path, tag, build, Cfg, **build_kw):
    cfg = Cfg()
    cfg.writer_side.data_dir = str(tmp_path / f"{tag}-writer")
    cfg.reader_side.data_dir = str(tmp_path / f"{tag}-reader")
    cfg.writer_side.insert_batch_commit_size = 10_000_000
    cfg.reader_side.insert_batch_commit_size = 10_000_000
    cfg.writer_side.commit_interval_sec = 3600.0
    cfg.reader_side.commit_interval_sec = 3600.0
    cfg.ai.backend = "fake"
    if hasattr(cfg, "tpu"):
        cfg.tpu._test_force_fast_path = True
    return build(cfg, start_background=False, **build_kw)


def _port_engine(tmp_path):
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig

    return _engine(tmp_path, "port", build_orama, OramaxConfig, device="cpu")


def _serve(engine, http_mod, HttpConfig):
    ws = http_mod.WebServer(engine, HttpConfig(host="127.0.0.1", port=0))
    ws.start_background()
    return ws, f"http://127.0.0.1:{ws.port}"


@pytest.fixture()
def server(tmp_path):
    from orama_core_tpu_torch.config import HttpConfig
    from orama_core_tpu_torch.server import http

    engine = _port_engine(tmp_path)
    ws, base = _serve(engine, http, HttpConfig)
    yield engine, base
    ws.stop()
    engine.close()


def _req(url, method="GET", body=None, bearer=None):
    headers = {"Content-Type": "application/json"}
    if bearer:
        headers["Authorization"] = f"Bearer {bearer}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw = r.read() or b"null"
            try:
                return r.status, json.loads(raw)
            except json.JSONDecodeError:
                return r.status, raw.decode()
    except urllib.error.HTTPError as e:
        payload = e.read()
        try:
            return e.code, json.loads(payload)
        except json.JSONDecodeError:
            return e.code, payload.decode()


def _sse_events(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        return [json.loads(line.decode().strip()[6:]) for line in r
                if line.decode().startswith("data: ")]


def _setup_collection(engine, base):
    status, _ = _req(base + "/v1/collections/create", "POST",
                     {"id": "c1", "read_api_key": "rk", "write_api_key": "wk"},
                     bearer="master")
    assert status == 201
    status, out = _req(base + "/v1/collections/c1/insert", "POST", [
        {"id": "1", "title": "hello tpu world", "price": 3},
        {"id": "2", "title": "another document", "price": 9},
    ], bearer="wk")
    assert status == 200 and out["inserted"] == 2
    engine.flush()


# -- tests/test_server.py on the port ----------------------------------------


def test_health_and_root(server):
    engine, base = server
    status, _ = _req(base + "/health")
    assert status == 200
    status, out = _req(base + "/")
    assert status == 200 and "message" in out


def test_openapi(server):
    _, base = server
    status, spec = _req(base + "/openapi.json")
    assert status == 200
    assert "/v1/collections/{id}/search" in spec["paths"]
    assert spec["info"]["title"] == "orama_core_tpu_torch"


def test_crud_and_search_over_http(server):
    engine, base = server
    _setup_collection(engine, base)
    status, cols = _req(base + "/v1/collections", bearer="master")
    assert status == 200 and cols[0]["id"] == "c1"
    assert cols[0]["document_count"] == 2
    status, col = _req(base + "/v1/collections/c1", bearer="master")
    assert status == 200 and col["fields"]["title"] == "string"
    status, res = _req(base + "/v1/collections/c1/search?api-key=rk", "POST",
                       {"term": "hello"})
    assert status == 200 and res["count"] == 1
    assert res["hits"][0]["id"] == "1"
    assert res["hits"][0]["document"]["title"] == "hello tpu world"
    status, res = _req(base + "/v1/collections/c1/search?api-key=rk", "POST",
                       {"term": "hello another document",
                        "where": {"price": {"gt": 5}}})
    assert status == 200 and [h["id"] for h in res["hits"]] == ["2"]
    model = next(f.model for f in engine.read_side._reader("c1").fields.values()
                 if f.model)
    raw = [float(x) for x in
           engine.read_side.ai.embed_passage(model, ["hello tpu world"])[0]]
    status, res = _req(base + "/v1/collections/c1/search?api-key=rk", "POST",
                       {"mode": "vector", "vector": raw})
    assert status == 200 and res["hits"][0]["id"] == "1"
    status, _ = _req(base + "/v1/collections/c1/search?api-key=rk", "POST",
                     {"mode": "vector", "vector": [1.0, 2.0]})
    assert status == 400


def test_document_get_and_delete(server):
    engine, base = server
    _setup_collection(engine, base)
    status, doc = _req(base + "/v1/collections/c1/documents/1?api-key=rk")
    assert status == 200 and doc["title"] == "hello tpu world"
    status, out = _req(base + "/v1/collections/c1/delete", "POST",
                       {"ids": ["1"]}, bearer="wk")
    assert status == 200 and out["deleted"] == 1
    engine.flush()
    status, res = _req(base + "/v1/collections/c1/search?api-key=rk", "POST",
                       {"term": "hello"})
    assert res["count"] == 0


def test_auth_failures(server):
    engine, base = server
    _setup_collection(engine, base)
    assert _req(base + "/v1/collections", bearer="wrong")[0] == 401
    assert _req(base + "/v1/collections/c1/search?api-key=bad", "POST",
                {"term": "x"})[0] == 401
    assert _req(base + "/v1/collections/c1/insert", "POST", [{"id": "x"}],
                bearer="bad")[0] == 401


def test_404s(server):
    engine, base = server
    assert _req(base + "/nope")[0] == 404
    assert _req(base + "/v1/collections/ghost/search?api-key=rk", "POST",
                {"term": "x"})[0] == 404


def test_bad_body(server):
    engine, base = server
    _setup_collection(engine, base)
    status, _ = _req(base + "/v1/collections/c1/search?api-key=rk", "POST",
                     {"term": "x", "mode": "??"})
    assert status == 400


def test_metrics_endpoint(server):
    engine, base = server
    _setup_collection(engine, base)
    _req(base + "/v1/collections/c1/search?api-key=rk", "POST", {"term": "hello"})
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        text = r.read().decode()
    assert "reader_search_elapsed_sec" in text
    assert "http_requests_total" in text


def test_actions_execute(server):
    engine, base = server
    _setup_collection(engine, base)
    status, res = _req(base + "/v1/c1/actions/execute?api-key=rk", "POST",
                       {"name": "search", "context": json.dumps({"term": "hello"})})
    assert status == 200 and res["count"] == 1
    status, _ = _req(base + "/v1/c1/actions/execute?api-key=rk", "POST",
                     {"name": "dance", "context": "{}"})
    assert status == 422


def test_answer_sse(server):
    engine, base = server
    _setup_collection(engine, base)
    events = _sse_events(base + "/v1/collections/c1/answer?api-key=rk",
                         {"query": "hello tpu"})
    types = [e["type"] for e in events]
    assert types[0] == "acknowledgement"
    assert "optimized-query" in types and "sources" in types
    assert "answer_chunk" in types
    finals = [e for e in events if e["type"] == "answer_chunk"]
    assert finals[-1]["message"]["is_final"] is True
    sources = next(e for e in events if e["type"] == "sources")
    assert sources["message"]["count"] >= 1


def test_planned_answer_sse(server):
    engine, base = server
    _setup_collection(engine, base)
    events = _sse_events(base + "/v1/collections/c1/planned_answer?api-key=rk",
                         {"query": "tell me about tpu"})
    payloads = [json.loads(e["message"]) for e in events]
    actions = [p["action"] for p in payloads]
    assert actions[0] == "ACTION_PLAN"
    assert "PERFORM_ORAMA_SEARCH" in actions and "GIVE_REPLY" in actions
    step = next(p for p in payloads if p["action"] == "PERFORM_ORAMA_SEARCH")
    assert "hits" in json.loads(step["result"])


def test_hooks_api(server):
    """Creating a hook answers 501 with the reason; hooks stored on disk
    (as the reference package writes them) list, fetch under both path
    shapes, survive an insert (the doc's embedding is skipped, as for a
    hook that fails) and remove."""
    engine, base = server
    _setup_collection(engine, base)
    name = "selectEmbeddingProperties"
    code = "function selectEmbeddingProperties(doc) { return ['title']; }"
    status, out = _req(base + "/v1/collections/c1/hooks/create", "POST",
                       {"name": name, "code": code}, bearer="wk")
    assert status == 501 and "not implemented" in out["error"]
    assert "minijs" in out["error"]
    assert _req(base + "/v1/collections/c1/hooks/create", "POST",
                {"name": name, "code": code}, bearer="bad")[0] == 401
    status, hooks = _req(base + "/v1/collections/c1/hooks/list", bearer="wk")
    assert status == 200 and hooks == {}

    hooks_dir = engine.hooks.data_dir
    os.makedirs(hooks_dir, exist_ok=True)
    with open(os.path.join(hooks_dir, "hooks.json"), "w") as f:
        json.dump([{"collection": "c1", "name": name, "code": code}], f)
    engine.hooks._load()
    status, hooks = _req(base + "/v1/collections/c1/hooks/list", bearer="wk")
    assert status == 200 and name in hooks
    status, one = _req(base + f"/v1/collections/c1/hooks/get?name={name}",
                       bearer="wk")
    assert status == 200 and one["code"] == code
    assert _req(base + "/v1/collections/c1/hooks/get?name=nope",
                bearer="wk")[0] == 404
    status, one = _req(base + f"/v1/c1/hooks/get?name={name}", bearer="wk")
    assert status == 200 and one["code"] == code
    status, hooks = _req(base + "/v1/c1/hooks/list", bearer="wk")
    assert status == 200 and name in hooks
    status, _ = _req(base + "/v1/collections/c1/insert", "POST",
                     [{"id": "3", "title": "hooked doc", "body": "x"}],
                     bearer="wk")
    assert status == 200
    engine.flush()
    status, _ = _req(base + "/v1/c1/hooks/remove", "POST", {"name": name},
                     bearer="wk")
    assert status == 200
    assert _req(base + "/v1/c1/hooks/list", bearer="wk")[1] == {}


def test_sse_pump_exits_on_client_disconnect(server, monkeypatch):
    """When an SSE client disconnects mid-stream, the pump thread stops
    instead of blocking on the full queue."""
    import socket
    import time

    engine, base = server
    _setup_collection(engine, base)
    state = {"closed": False, "produced": 0}

    def endless_events(*a, **kw):
        try:
            while True:
                state["produced"] += 1
                yield {"type": "answer_chunk", "message": {"text": "x" * 512}}
        finally:
            state["closed"] = True

    monkeypatch.setattr(
        "orama_core_tpu_torch.engine.answer.answer_events", endless_events)
    host, port = base[len("http://"):].split(":")
    s = socket.create_connection((host, int(port)), timeout=10)
    body = json.dumps({"query": "hi"}).encode()
    s.sendall(
        b"POST /v1/collections/c1/answer?api-key=rk HTTP/1.1\r\n"
        b"Host: x\r\nContent-Type: application/json\r\n"
        b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    s.recv(4096)
    s.close()
    deadline = time.time() + 15
    while not state["closed"] and time.time() < deadline:
        time.sleep(0.2)
    assert state["closed"], "pump thread still alive after client disconnect"
    p = state["produced"]
    time.sleep(1.0)
    assert state["produced"] == p


def test_document_fetch_is_cqrs_safe(server):
    engine, base = server
    _setup_collection(engine, base)
    saved = dict(engine.write_side.collections)
    engine.write_side.collections.clear()
    try:
        status, doc = _req(base + "/v1/collections/c1/documents/1?api-key=rk")
        assert status == 200 and doc["title"] == "hello tpu world"
        assert _req(base + "/v1/collections/c1/documents/ghost?api-key=rk"
                    )[0] == 404
    finally:
        engine.write_side.collections.update(saved)
    engine.commit()
    status, doc = _req(base + "/v1/collections/c1/documents/2?api-key=rk")
    assert status == 200 and doc["title"] == "another document"


def test_malformed_bodies_never_500(server):
    engine, base = server
    hostile = [
        b"not json at all", b"[", b'{"term": ', b"null", b'"just a string"',
        b"[]", b'{"term": {"nested": "object"}}',
        b'{"term": "x", "mode": "warp-drive"}', b'{"term": "x", "limit": "many"}',
        b'{"term": "x", "limit": -5}',
        b'{"term": "x", "where": {"price": {"gt": "soon"}}}',
        b'{"term": "x", "where": {"price": "flat"}}',
        b'{"term": "x", "properties": 7}', b'{"term": "x", "facets": {"price": []}}',
        b'{"vector": "not-a-list", "mode": "vector"}',
        b'{"term": "x", "boost": {"title": "big"}}',
        ('{"term": "' + "x" * 100000 + '"}').encode(),
        b'{"term": "\xc3"}'[:12],
    ]
    for body in hostile:
        for path, bearer in (("/v1/collections/c1/search?api-key=rk", None),
                             ("/v1/collections/c1/insert", "wk")):
            req = urllib.request.Request(
                base + path, data=body,
                headers={"Content-Type": "application/json",
                         **({"Authorization": f"Bearer {bearer}"} if bearer else {})})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    status = r.status
            except urllib.error.HTTPError as e:
                status = e.code
            assert 200 <= status < 500, (status, body[:60], path)


# -- the same requests to both servers -----------------------------------------


def _norm(x):
    if isinstance(x, str) and x[:1] in "{[":
        try:
            return _norm(json.loads(x))
        except json.JSONDecodeError:
            return x
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k != "elapsed"}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _same(a, b, where):
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-7), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def test_responses_equal_reference(tmp_path):
    from orama_core_tpu import build_orama as ref_build
    from orama_core_tpu.config import HttpConfig as RefHttp
    from orama_core_tpu.config import OramaxConfig as RefCfg
    from orama_core_tpu.server import http as ref_http
    from orama_core_tpu_torch.config import HttpConfig
    from orama_core_tpu_torch.server import http

    engines = [_engine(tmp_path, "ref", ref_build, RefCfg), _port_engine(tmp_path)]
    servers = [_serve(engines[0], ref_http, RefHttp), _serve(engines[1], http, HttpConfig)]
    # every body a different length, so BM25 scores do not tie (the
    # packages may order tied hits differently, ROADMAP.md §3)
    docs = [{"id": str(i), "title": f"title {i % 7} tpu" if i % 3 else f"doc {i}",
             "body": f"body words w{i % 5} w{i % 11} shared" + " pad" * i,
             "price": i % 13,
             "tag": ["red", "blue", "green"][i % 3], "ok": bool(i % 2)}
            for i in range(40)]
    steps = [
        ("POST", "/v1/collections/create", {"id": "c1", "read_api_key": "rk",
                                            "write_api_key": "wk"}, "master"),
        ("POST", "/v1/collections/create", {"id": "c1"}, "master"),
        ("POST", "/v1/collections/c1/insert", docs, "wk"),
        ("FLUSH",),
        ("GET", "/v1/collections", None, "master"),
        ("GET", "/v1/collections/c1", None, "master"),
        ("GET", "/v1/collections/c1/documents/7?api-key=rk", None, None),
        ("GET", "/v1/collections/c1/documents/nope?api-key=rk", None, None),
        ("GET", "/health/ai", None, None),
        ("POST", "/v1/c1/actions/execute?api-key=rk",
         {"name": "search", "context": json.dumps({"term": "w3"})}, None),
        ("POST", "/v1/collections/c1/delete", {"ids": ["3", "4"]}, "wk"),
        ("FLUSH",),
        ("COMMIT",),
        ("GET", "/v1/collections/c1/stats/export", None, "wk"),
    ]
    searches = [
        {"term": "tpu"}, {"term": "w3 shared", "limit": 5, "offset": 2},
        {"term": "title tpu", "where": {"price": {"between": [2, 8]}}},
        {"term": "body", "where": {"tag": "red", "ok": True},
         "facets": {"tag": {}, "price": {"ranges": [{"from": 0, "to": 6}]}}},
        {"term": "w1 w4", "mode": "vector"}, {"term": "w2", "mode": "hybrid"},
        {"term": "w2 title", "mode": "hybrid", "fusion": "minmax"},
        {"term": "\"body words\""}, {"term": "x", "mode": "??"},
        {"term": "tpu", "properties": ["title"], "boost": {"title": 2.0}},
        # light terms (df < 8): scored from the posting scan's df column
        {"term": "w9 w10"}, {"term": "w10 pad", "mode": "hybrid"},
    ]
    search_steps = [("POST", "/v1/collections/c1/search?api-key=rk", b, None)
                    for b in searches]
    # merged stats of a second slice (global idf): most terms get a larger
    # df; the searches then run again, so each package's cached device
    # state must follow the import
    steps += search_steps + [("IMPORT",)] + search_steps
    steps += [
        ("POST", "/v1/collections/c1/search?api-key=bad", {"term": "x"}, None),
        ("POST", "/v1/collections/ghost/search?api-key=rk", {"term": "x"}, None),
        ("GET", "/v1/c1/hooks/list", None, "wk"),
        ("GET", "/v1/c1/hooks/get?name=x", None, "wk"),
        ("POST", "/nope", {}, None),
        ("SSE", "/v1/collections/c1/answer?api-key=rk", {"query": "tpu title"}),
        ("SSE", "/v1/collections/c1/planned_answer?api-key=rk",
         {"query": "what about w3?", "messages": [{"role": "user", "content": "hi"}]}),
    ]
    exported, tpu_scores = None, []
    try:
        for i, step in enumerate(steps):
            if step[0] == "IMPORT":
                # every fifth term is left out and keeps its local df
                merged = {
                    name: {"terms": [t for j, t in enumerate(st["terms"]) if j % 5 != 4],
                           "df": [d + 1 + 2 * (j % 3) for j, d in enumerate(st["df"])
                                  if j % 5 != 4],
                           "n_docs": st["n_docs"] + 25,
                           "total_len": st["total_len"] + 400}
                    for name, st in exported.items()}
                step = ("POST", "/v1/collections/c1/stats/import", merged, "wk")
            outs = []
            for engine, (_, base) in zip(engines, servers):
                if step[0] == "FLUSH":
                    engine.flush()
                elif step[0] == "COMMIT":
                    engine.commit()
                elif step[0] == "SSE":
                    outs.append(_sse_events(base + step[1], step[2]))
                else:
                    method, path, body, bearer = step
                    outs.append(_req(base + path, method, body, bearer))
            if outs:
                _same(_norm(outs[1]), _norm(outs[0]), f"step {i} {step[:2]}")
            if len(step) < 4:
                continue
            if step[1].endswith("/stats/export"):
                assert outs[0][0] == 200 and outs[0][1]
                exported = outs[0][1]
            if step[2] == {"term": "tpu"}:
                tpu_scores.append([h["score"] for h in outs[1][1]["hits"]])
        # the import changed the scores it was meant to change
        assert len(tpu_scores) == 2 and tpu_scores[0] != tpu_scores[1]
    finally:
        for ws, _ in servers:
            ws.stop()
        for e in engines:
            e.close()
