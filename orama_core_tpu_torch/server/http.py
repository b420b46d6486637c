"""HTTP API server on the stdlib (ThreadingHTTPServer).

Route surface mirrors the reference's axum router (`web_server/api/`):

    GET  /                                      welcome
    GET  /health                                health check
    GET  /openapi.json                          OpenAPI spec
    GET  /metrics                               Prometheus text
    GET  /v1/collections                        [Bearer master]
    GET  /v1/collections/{id}                   [Bearer master]
    POST /v1/collections/create                 [Bearer master]
    POST /v1/collections/{id}/insert            [Bearer write]
    POST /v1/collections/{id}/delete            [Bearer write]
    POST /v1/collections/{id}/documents/{doc}   GET by user id [?api-key]
    POST /v1/collections/{id}/search            [?api-key=read]
    POST /v1/collections/{id}/answer            SSE [?api-key]
    POST /v1/collections/{id}/planned_answer    SSE [?api-key]
    POST /v1/{id}/actions/execute               [?api-key] (sidecar seam)
    POST /v1/collections/{id}/hooks/create      [Bearer write]
    GET  /v1/{id}/hooks/list                    [Bearer write]
    GET  /v1/{id}/hooks/get?name=               [Bearer write]
    POST /v1/{id}/hooks/remove                  [Bearer write]
      (hooks routes accept both /v1/{id}/ and /v1/collections/{id}/
       shapes, and delete|remove — mirrors hooks.rs:36,68,101,137)

Auth conventions match the reference: admin/write = Authorization Bearer
header (admin.rs:33-45), search/answer/actions = ``?api-key=`` query param
(search.rs:31-48).

Port of ``orama_core_tpu/server/http.py``: the same routes, auth, load
shedding and SSE pump over the port's engine. A route that reaches a
``NotImplementedError`` answers 501 with the reason, not a 500.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..config import HttpConfig
from ..types import ApiKeyError, CollectionNotFound, SearchParams
from ..utils import tracing
from . import metrics as m
from .openapi import openapi_spec


class HttpError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


_HEAVY = re.compile(r"/(search|insert|actions)(/|$)")
# SSE answer streams hold their slot for a full LLM generation
# (seconds-to-minutes) — they get their OWN pool so long streams cannot
# starve millisecond searches out of the shared shed budget
_SSE_ROUTES = re.compile(r"/(answer|planned_answer)(/|$)")

# route label for metrics: collapse per-collection / per-document path
# segments so the Counter's label cardinality stays bounded (raw paths
# leak one counter entry per distinct document id fetched)
_ROUTE_ID = re.compile(r"(/v1/collections/)[^/]+")
_ROUTE_DOC = re.compile(r"(/documents/)[^/]+$")


def _route_label(path: str) -> str:
    path = _ROUTE_ID.sub(r"\1:id", path)
    return _ROUTE_DOC.sub(r"\1:doc", path)


def _make_handler(orama):
    read_side = orama.read_side
    write_side = orama.write_side
    # load shedding for heavy routes (reference has none; unbounded axum
    # queues under overload trade latency for memory — we shed instead)
    in_flight = threading.BoundedSemaphore(
        max(1, getattr(orama.cfg.http, "max_in_flight", 64))
    )
    sse_in_flight = threading.BoundedSemaphore(
        max(1, getattr(orama.cfg.http, "max_sse_streams", 32))
    )
    max_body = int(getattr(orama.cfg.http, "max_body_bytes", 64 * 1024 * 1024))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "oramax"

        # -- plumbing ---------------------------------------------------------

        def log_message(self, fmt, *args):  # route through tracing
            tracing.log("debug", "http " + fmt % args)

        def _bearer(self) -> Optional[str]:
            auth = self.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                return auth[7:].strip()
            return None

        def _query(self) -> Dict[str, str]:
            q = urllib.parse.urlparse(self.path).query
            return {k: v[0] for k, v in urllib.parse.parse_qs(q).items()}

        def _api_key(self) -> Optional[str]:
            return self._query().get("api-key") or self._bearer()

        def _body(self) -> Any:
            length = int(self.headers.get("Content-Length") or 0)
            if length == 0:
                return None
            if length > max_body:
                # refuse before allocating attacker-declared gigabytes
                raise HttpError(413, "request body too large")
            raw = self.rfile.read(length)
            try:
                return json.loads(raw)
            except json.JSONDecodeError:
                raise HttpError(400, "invalid JSON body")

        def _send(self, status: int, payload: Any, content_type="application/json"):
            data = (
                payload
                if isinstance(payload, bytes)
                else json.dumps(payload).encode()
                if content_type == "application/json"
                else str(payload).encode()
            )
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            if orama.cfg.http.allow_cors:
                self.send_header("Access-Control-Allow-Origin", "*")
                # the Fetch spec excludes Authorization from the "*"
                # wildcard — it must be listed explicitly for browser
                # Bearer requests to pass preflight
                self.send_header(
                    "Access-Control-Allow-Headers",
                    "Authorization, Content-Type",
                )
                self.send_header(
                    "Access-Control-Allow-Methods", "GET, POST, OPTIONS"
                )
            self.end_headers()
            self.wfile.write(data)

        def _sse(self, events) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            keepalive = max(0.5, getattr(orama.cfg.http, "sse_keepalive_sec", 15.0))
            # bridge the (possibly slow) event generator through a queue so
            # idle gaps emit SSE comment keepalives instead of stalling
            # proxies (": keepalive" lines are ignored by EventSource)
            import queue as _queue

            q: "_queue.Queue" = _queue.Queue(maxsize=64)
            _DONE, _ERR = object(), object()
            # consumer-gone flag: when the client disconnects mid-stream the
            # pump must not block forever on a full queue (it would leak the
            # thread and keep any in-flight LLM generation alive)
            stopped = threading.Event()

            def put_or_abandon(ev) -> bool:
                """Blocking put that gives up once the consumer is gone.
                The terminal sentinels go through this too: dropping _DONE
                on a momentarily-full queue would leave a live-but-slow
                client looping on keepalives forever."""
                while not stopped.is_set():
                    try:
                        q.put(ev, timeout=1.0)
                        return True
                    except _queue.Full:
                        continue
                return False

            def pump():
                try:
                    for ev in events:
                        if not put_or_abandon(ev):
                            return
                    put_or_abandon(_DONE)
                except Exception as e:  # surface generator errors as an event
                    tracing.log("error", f"sse generator error: {e!r}")
                    put_or_abandon(_ERR)
                finally:
                    close = getattr(events, "close", None)
                    if close is not None:
                        try:
                            close()
                        except Exception:
                            pass

            t = threading.Thread(target=pump, daemon=True)
            t.start()
            try:
                while True:
                    try:
                        ev = q.get(timeout=keepalive)
                    except _queue.Empty:
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        continue
                    if ev is _DONE:
                        break
                    if ev is _ERR:
                        # same {type, message} shape as every other event
                        self.wfile.write(
                            b'data: {"type": "error", '
                            b'"message": "internal error"}\n\n'
                        )
                        self.wfile.flush()
                        break
                    chunk = f"data: {json.dumps(ev)}\n\n".encode()
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # client disconnected
            finally:
                stopped.set()
                # drain so a pump blocked in put(timeout=1) exits promptly
                try:
                    while True:
                        q.get_nowait()
                except _queue.Empty:
                    pass

        # -- routing ----------------------------------------------------------

        def do_OPTIONS(self):
            self._send(204, b"", "text/plain")

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def _route(self, method: str) -> None:
            path = urllib.parse.urlparse(self.path).path.rstrip("/") or "/"
            # SSE streams shed from their own pool (they hold the slot
            # for a whole LLM generation; sharing with /search would let
            # a handful of streams starve every short request)
            pool = (
                sse_in_flight if _SSE_ROUTES.search(path)
                else in_flight if _HEAVY.search(path)
                else None
            )
            if pool is not None and not pool.acquire(blocking=False):
                self.send_response(503)
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", "0")
                self.end_headers()
                m.HTTP_REQUESTS.inc(
                    route=_route_label(path), method=method, status="503"
                )
                return
            try:
                status = self._dispatch(method, path)
            except HttpError as e:
                status = e.status
                self._send(e.status, {"error": str(e)})
            except ApiKeyError as e:
                status = 401
                self._send(401, {"error": str(e) or "unauthorized"})
            except CollectionNotFound as e:
                status = 404
                self._send(404, {"error": f"collection {e} not found"})
            except KeyError as e:
                # a missing required body field is the CLIENT's error
                status = 400
                self._send(400, {"error": f"missing required field {e}"})
            except (ValueError, TypeError) as e:
                status = 400
                self._send(400, {"error": str(e)})
            except NotImplementedError as e:
                status = 501
                self._send(501, {"error": f"not implemented: {e}"})
            except Exception as e:  # pragma: no cover
                status = 500
                tracing.log("error", f"internal error: {e!r}")
                self._send(500, {"error": "internal error"})
            finally:
                if pool is not None:
                    pool.release()
            m.HTTP_REQUESTS.inc(
                route=_route_label(path), method=method, status=str(status)
            )

        def _dispatch(self, method: str, path: str) -> int:
            if method == "GET" and path == "/":
                self._send(200, {"message": "Welcome to Orama (PyTorch/CUDA)"})
                return 200
            if method == "GET" and path == "/health":
                self._send(200, b"OK", "text/plain")
                return 200
            if method == "GET" and path == "/health/ai":
                self._send(200, orama.ai.check_health())
                return 200
            if method == "GET" and path == "/openapi.json":
                self._send(200, openapi_spec())
                return 200
            if method == "GET" and path == "/metrics":
                if not orama.cfg.http.with_prometheus:
                    raise HttpError(404, "metrics disabled")
                self._send(200, m.REGISTRY.expose_text().encode(), "text/plain; version=0.0.4")
                return 200

            if method == "GET" and path == "/v1/collections":
                self._send(200, write_side.list_collections(self._bearer()))
                return 200
            if method == "POST" and path == "/v1/collections/create":
                body = self._body() or {}
                emb = body.get("embeddings") or {}
                write_side.create_collection(
                    self._bearer(),
                    body["id"],
                    read_api_key=body["read_api_key"],
                    write_api_key=body["write_api_key"],
                    description=body.get("description"),
                    language=body.get("language", "en"),
                    embedding_model=emb.get("model"),
                    embedding_sources=emb.get("document_fields"),
                )
                self._send(201, {"collection_id": body["id"]})
                return 201

            mo = re.match(r"^/v1/collections/([^/]+)$", path)
            if mo and method == "GET":
                self._send(200, write_side.get_collection(self._bearer(), mo.group(1)))
                return 200

            mo = re.match(r"^/v1/collections/([^/]+)/insert$", path)
            if mo and method == "POST":
                body = self._body()
                docs = body if isinstance(body, list) else [body]
                if not all(isinstance(d, dict) for d in docs):
                    raise HttpError(
                        400, "insert body must be a document or a list of documents"
                    )
                ids = write_side.write(mo.group(1), docs, self._bearer())
                self._send(200, {"inserted": len(ids), "ids": ids})
                return 200

            mo = re.match(r"^/v1/collections/([^/]+)/delete$", path)
            if mo and method == "POST":
                body = self._body()
                ids = body["ids"] if isinstance(body, dict) else body
                n = write_side.delete_documents(mo.group(1), ids, self._bearer())
                self._send(200, {"deleted": n})
                return 200

            mo = re.match(r"^/v1/collections/([^/]+)/search$", path)
            if mo and method == "POST":
                params = SearchParams.from_json(self._body() or {})
                result = read_side.search(mo.group(1), params, self._api_key())
                self._send(200, result.to_json())
                return 200

            mo = re.match(r"^/v1/collections/([^/]+)/documents/([^/]+)$", path)
            if mo and method == "GET":
                # resolved entirely read-side: the user-id map flows through
                # the op log (InsertDocumentOp carries the forced "id"), so
                # the route keeps working when the sides run as separate
                # processes (CQRS, reference operation.rs:119-133)
                read_side.check_read_key(mo.group(1), self._api_key())
                doc = read_side.get_document_by_user_id(mo.group(1), mo.group(2))
                if doc is None:
                    raise HttpError(404, "document not found")
                self._send(200, doc)
                return 200

            mo = re.match(r"^/v1/collections/([^/]+)/answer$", path)
            if mo and method == "POST":
                from ..engine.answer import answer_events

                body = self._body() or {}
                read_side.check_read_key(mo.group(1), self._api_key())
                self._sse(
                    answer_events(
                        read_side,
                        mo.group(1),
                        body.get("query", ""),
                        body.get("messages"),
                        skip_auth=True,
                    )
                )
                return 200

            mo = re.match(r"^/v1/collections/([^/]+)/planned_answer$", path)
            if mo and method == "POST":
                from ..engine.answer import PartyPlanner

                body = self._body() or {}
                read_side.check_read_key(mo.group(1), self._api_key())
                planner = PartyPlanner(read_side)
                self._sse(
                    {"type": "acknowledgement", "message": json.dumps(ev)}
                    if isinstance(ev, dict)
                    else ev
                    for ev in planner.run(
                        mo.group(1), body.get("query", ""), body.get("messages"),
                        skip_auth=True,
                    )
                )
                return 200

            # cross-slice global-statistics exchange (multi-slice DFS mode,
            # parallel/multislice.sync_global_stats) — operator surface,
            # write-key gated like other internal mutations
            mo = re.match(r"^/v1/collections/([^/]+)/stats/export$", path)
            if mo and method == "GET":
                write_side.check_write_key(mo.group(1), self._bearer())
                self._send(200, read_side.export_term_stats(mo.group(1)))
                return 200
            mo = re.match(r"^/v1/collections/([^/]+)/stats/import$", path)
            if mo and method == "POST":
                write_side.check_write_key(mo.group(1), self._bearer())
                read_side.apply_global_stats(mo.group(1), self._body() or {})
                self._send(200, {"ok": True})
                return 200

            # sidecar action seam (reference: /v1/{id}/actions/execute)
            mo = re.match(r"^/v1/([^/]+)/actions/execute$", path)
            if mo and method == "POST":
                body = self._body() or {}
                name = body.get("name")
                if name != "search":
                    raise HttpError(422, f"Action {name} was not found")
                params = SearchParams.from_json(json.loads(body["context"]))
                result = read_side.search(mo.group(1), params, self._api_key())
                self._send(200, result.to_json())
                return 200

            # the reference nests create under /v1/collections/{id}/ but
            # get/remove/list under /v1/{collection_id}/ (hooks.rs:36,68,
            # 101,137) — accept both shapes for all four, and "remove" as
            # the reference's spelling of delete
            mo = re.match(
                r"^/v1/(?:collections/)?([^/]+)/hooks/"
                r"(create|list|get|delete|remove)$",
                path,
            )
            if mo:
                from ..engine.hooks import HooksRuntime

                cid, action = mo.group(1), mo.group(2)
                if action == "remove":
                    action = "delete"
                write_side.check_write_key(cid, self._bearer())
                hooks: HooksRuntime = orama.hooks
                if action == "create" and method == "POST":
                    body = self._body() or {}
                    hooks.insert_hook(cid, body["name"], body["code"])
                    self._send(200, {"ok": True})
                    return 200
                if action == "list" and method == "GET":
                    self._send(200, hooks.list_hooks(cid))
                    return 200
                if action == "get" and method == "GET":
                    # reference: GET /v1/{id}/hooks/get (hooks.rs:68-99)
                    qs = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query
                    )
                    name = (qs.get("name") or [""])[0]
                    code = hooks.get_hook(cid, name)
                    if code is None:
                        raise HttpError(404, f"hook {name} not found")
                    if not isinstance(code, str):
                        code = f"<python {getattr(code, '__name__', 'fn')}>"
                    self._send(200, {"name": name, "code": code})
                    return 200
                if action == "delete" and method == "POST":
                    body = self._body() or {}
                    hooks.delete_hook(cid, body["name"])
                    self._send(200, {"ok": True})
                    return 200

            raise HttpError(404, f"no route {method} {path}")

    return Handler


class WebServer:
    """Owns the listening socket; `start()` blocks, `start_background()`
    spawns the serve loop (reference: WebServer::start, web_server/mod.rs)."""

    def __init__(self, orama, cfg: Optional[HttpConfig] = None) -> None:
        self.orama = orama
        self.cfg = cfg or orama.cfg.http

        # socketserver's default listen backlog is 5 — a burst of
        # concurrent connects (64-client benchmarks, production fan-in)
        # overflows it and clients see connection resets instead of
        # queueing or a clean 503 from the load shedder
        class _Server(ThreadingHTTPServer):
            request_queue_size = self.cfg.listen_backlog

        self.httpd = _Server(
            (self.cfg.host, self.cfg.port), _make_handler(orama)
        )
        self.httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        tracing.log(
            "info", f"oramax http listening on {self.cfg.host}:{self.port}"
        )
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def serve(orama, cfg: Optional[HttpConfig] = None) -> None:
    WebServer(orama, cfg).start()
