"""gRPC transport for multi-slice coordination.

Port of ``orama_core_tpu/parallel/slice_grpc.py``: the slice interface
(create_collection / write / delete / search / flush / commit / count /
stats export+import) over one generic gRPC method, registered through
grpc's generic APIs as the model sidecar's stubs are (``rpc/stubs.py``).
Payloads are the engine's own JSON wire shapes, byte-identical to what the
HTTP transport posts. ``rpc/slice_service_pb2.py`` is the reference's
generated file byte for byte: the proto package (``orama_slice``) and its
wire names are shared, so either package's client talks to either
package's server, and protobuf's default pool accepts the second,
identical registration when both are imported in one process.

The server wraps a ``multislice.LocalSlice`` (or any object with the
slice interface); the client is a drop-in slice for ``MultiSliceRouter``.
This module needs ``grpcio`` and ``protobuf``; nothing imports it unless
a ``GrpcSlice`` or ``serve_slice`` is asked for, and its ``ImportError``
propagates.
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Any, List, Optional, Sequence

import grpc

from ..rpc import slice_service_pb2 as pb
from ..types import (
    FacetResult,
    SearchParams,
    SearchResult,
    SearchResultHit,
)

SERVICE_NAME = "orama_slice.SliceService"
_CALL_PATH = f"/{SERVICE_NAME}/Call"


# ---------------------------------------------------------------- server


def _result_to_json(r: SearchResult) -> dict:
    return r.to_json()


class _SliceHandlers:
    def __init__(self, slice_obj) -> None:
        self._slice = slice_obj

    def Call(self, request: pb.SliceRequest, context) -> pb.SliceResponse:
        try:
            args = json.loads(request.json.decode()) if request.json else {}
            method = request.method
            s = self._slice
            if method == "create_collection":
                s.create_collection(
                    args["master_key"], request.collection,
                    args["read_key"], args["write_key"],
                    **args.get("kw", {}),
                )
                out: Any = {}
            elif method == "write":
                ids = s.write(request.collection, args["docs"], request.auth)
                out = {"ids": list(ids)}
            elif method == "delete":
                n = s.delete(request.collection, args["ids"], request.auth)
                out = {"deleted": int(n)}
            elif method == "search":
                r = s.search(request.collection, args["params"], request.auth)
                out = _result_to_json(r)
            elif method == "flush":
                s.flush()
                out = {}
            elif method == "commit":
                s.commit()
                out = {}
            elif method == "count":
                out = {"count": int(s.count(request.collection))}
            elif method == "export_term_stats":
                out = {"stats": s.export_term_stats(
                    request.collection, request.auth)}
            elif method == "apply_global_stats":
                s.apply_global_stats(
                    request.collection, args["stats"], request.auth)
                out = {}
            else:
                return pb.SliceResponse(error=f"unknown method {method!r}")
            return pb.SliceResponse(json=json.dumps(out).encode())
        except Exception as e:  # noqa: BLE001 — errors cross the wire as text
            return pb.SliceResponse(error=f"{type(e).__name__}: {e}")


def serve_slice(
    slice_obj, port: int = 0, max_workers: int = 8
) -> grpc.Server:
    """Serve a slice over gRPC; returns the started server (its bound
    port via ``server._port`` convenience attribute when port=0)."""
    handlers = _SliceHandlers(slice_obj)
    rpc_method_handlers = {
        "Call": grpc.unary_unary_rpc_method_handler(
            handlers.Call,
            request_deserializer=pb.SliceRequest.FromString,
            response_serializer=pb.SliceResponse.SerializeToString,
        ),
    }
    generic = grpc.method_handlers_generic_handler(
        SERVICE_NAME, rpc_method_handlers
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((generic,))
    bound = server.add_insecure_port(f"127.0.0.1:{port}" if port == 0
                                     else f"0.0.0.0:{port}")
    server._port = bound  # convenience for tests/examples
    server.start()
    return server


# ---------------------------------------------------------------- client


class GrpcSlice:
    """A slice backed by a remote gRPC slice server — drop-in for
    ``MultiSliceRouter`` next to LocalSlice/HttpSlice."""

    def __init__(self, target: str, timeout_s: float = 30.0) -> None:
        self._channel = grpc.insecure_channel(target)
        self._call = self._channel.unary_unary(
            _CALL_PATH,
            request_serializer=pb.SliceRequest.SerializeToString,
            response_deserializer=pb.SliceResponse.FromString,
        )
        self._timeout = timeout_s

    def _rpc(self, method: str, collection: str = "", auth: str = "",
             **args) -> dict:
        resp = self._call(
            pb.SliceRequest(
                method=method, collection=collection, auth=auth,
                json=json.dumps(args).encode(),
            ),
            timeout=self._timeout,
        )
        if resp.error:
            raise RuntimeError(f"slice rpc {method} failed: {resp.error}")
        return json.loads(resp.json.decode()) if resp.json else {}

    def create_collection(self, master_key, cid, read_key, write_key,
                          **kw) -> None:
        self._rpc("create_collection", cid, master_key=master_key,
                  read_key=read_key, write_key=write_key, kw=kw)

    def write(self, cid: str, docs: List[dict], write_key: str) -> List[str]:
        return self._rpc("write", cid, write_key, docs=docs)["ids"]

    def delete(self, cid: str, ids: Sequence[str], write_key: str) -> int:
        return self._rpc("delete", cid, write_key, ids=list(ids))["deleted"]

    def search(self, cid: str, params_json: dict, read_key: str) -> SearchResult:
        out = self._rpc("search", cid, read_key, params=params_json)
        facets: Optional[dict] = None
        if out.get("facets"):
            facets = {
                name: FacetResult(count=f["count"], values=dict(f["values"]))
                for name, f in out["facets"].items()
            }
        return SearchResult(
            hits=[
                SearchResultHit(
                    id=h["id"], score=h["score"],
                    document=h.get("document"),
                )
                for h in out.get("hits", [])
            ],
            count=int(out.get("count", 0)),
            # to_json packs elapsed.raw = elapsed_ms * 1e6 (types.py)
            elapsed_ms=float(out.get("elapsed", {}).get("raw", 0)) / 1e6,
            facets=facets,
        )

    def flush(self) -> None:
        self._rpc("flush")

    def commit(self) -> None:
        self._rpc("commit")

    def count(self, cid: str) -> int:
        return self._rpc("count", cid)["count"]

    def export_term_stats(self, cid: str, write_key: str):
        return self._rpc("export_term_stats", cid, write_key)["stats"]

    def apply_global_stats(self, cid: str, stats, write_key: str) -> None:
        self._rpc("apply_global_stats", cid, write_key, stats=stats)

    def close(self) -> None:
        self._channel.close()
