"""OpenAPI spec for the HTTP surface (reference: axum_openapi3 generated
spec served at /openapi.json, api/mod.rs:71-79). Hand-maintained here.

Port of ``orama_core_tpu/server/openapi.py``: the same routes; the title
and description name this package."""

from __future__ import annotations

from typing import Any, Dict


def _op(summary: str, auth: str, body: bool = True) -> Dict[str, Any]:
    op: Dict[str, Any] = {
        "summary": summary,
        "description": f"Auth: {auth}",
        "responses": {"200": {"description": "success"}},
    }
    if body:
        op["requestBody"] = {
            "content": {"application/json": {"schema": {"type": "object"}}}
        }
    return op


def openapi_spec() -> Dict[str, Any]:
    spec = {
        "openapi": "3.1.0",
        "info": {
            "title": "orama_core_tpu_torch",
            "version": "0.1.0",
            "description": "Index-and-query engine on PyTorch and CUDA",
        },
        "paths": {
            "/": {"get": _op("Welcome", "none", body=False)},
            "/health": {"get": _op("Health check", "none", body=False)},
            "/health/ai": {
                "get": _op("AI service health (embedding probe)", "none", body=False)
            },
            "/openapi.json": {"get": _op("OpenAPI spec", "none", body=False)},
            "/metrics": {"get": _op("Prometheus metrics", "none", body=False)},
            "/v1/collections": {
                "get": _op("List collections", "Bearer master key", body=False)
            },
            "/v1/collections/create": {
                "post": _op("Create a collection", "Bearer master key")
            },
            "/v1/collections/{id}": {
                "get": _op("Get collection info", "Bearer master key", body=False)
            },
            "/v1/collections/{id}/insert": {
                "post": _op("Insert documents", "Bearer write key")
            },
            "/v1/collections/{id}/delete": {
                "post": _op("Delete documents by id", "Bearer write key")
            },
            "/v1/collections/{id}/search": {
                "post": {
                    **_op("Search (fulltext/vector/hybrid)", "?api-key=read key"),
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "properties": {
                                        "term": {"type": "string"},
                                        "mode": {
                                            "type": "string",
                                            "enum": ["fulltext", "vector", "hybrid"],
                                        },
                                        "limit": {"type": "integer", "default": 10},
                                        "offset": {
                                            "type": "integer",
                                            "default": 0,
                                            "description": "ranked hits to skip (pagination)",
                                        },
                                        "vector": {
                                            "type": "array",
                                            "items": {"type": "number"},
                                            "description": (
                                                "Raw query embedding (mode="
                                                "vector only); skips the "
                                                "embedding model"
                                            ),
                                        },
                                        "boost": {"type": "object"},
                                        "properties": {
                                            "type": "array",
                                            "items": {"type": "string"},
                                        },
                                        "fusion": {
                                            "type": "string",
                                            "enum": ["rrf", "minmax"],
                                        },
                                        "where": {
                                            "type": "object",
                                            "description": (
                                                "Per-field filters. Number: "
                                                '{"eq"|"gt"|"gte"|"lt"|"lte": n} or '
                                                '{"between": [lo, hi]}. Bool: true|false. '
                                                'String (exact): "v", {"eq": "v"}, or '
                                                '{"in": ["v1", "v2"]}.'
                                            ),
                                        },
                                        "facets": {
                                            "type": "object",
                                            "description": (
                                                "Per-field facets. Number: {\"ranges\": "
                                                '[{"from": lo, "to": hi}]}. Bool: '
                                                '{"true": bool, "false": bool}. String '
                                                '(term facet): {} or {"limit": N}.'
                                            ),
                                        },
                                    },
                                }
                            }
                        }
                    },
                }
            },
            "/v1/collections/{id}/documents/{doc_id}": {
                "get": _op("Fetch one document", "?api-key=read key", body=False)
            },
            "/v1/collections/{id}/answer": {
                "post": _op("RAG answer (SSE stream)", "?api-key=read key")
            },
            "/v1/collections/{id}/planned_answer": {
                "post": _op("Agentic planned answer (SSE stream)", "?api-key=read key")
            },
            "/v1/{id}/actions/execute": {
                "post": _op("Execute engine action (sidecar seam)", "?api-key=read key")
            },
            # multi-slice DFS statistics exchange (beyond the reference)
            "/v1/collections/{id}/stats/export": {
                "get": _op("Export per-term document frequencies for "
                           "multi-slice global-idf sync", "Bearer write key",
                           body=False)
            },
            "/v1/collections/{id}/stats/import": {
                "post": _op("Apply merged global statistics (DFS mode)",
                            "Bearer write key")
            },
            # hooks: reference path shapes (hooks.rs:36,68,101,137) — the
            # /v1/collections/{id}/hooks/* aliases also resolve
            "/v1/collections/{id}/hooks/create": {
                "post": _op("Register a JS hook", "Bearer write key")
            },
            "/v1/{collection_id}/hooks/list": {
                "get": _op("List hooks", "Bearer write key", body=False)
            },
            "/v1/{collection_id}/hooks/get": {
                "get": _op("Fetch one hook by ?name=", "Bearer write key", body=False)
            },
            "/v1/{collection_id}/hooks/remove": {
                "post": _op("Remove a hook", "Bearer write key")
            },
        },
    }
    # OpenAPI 3.x REQUIRES every path-template variable to be declared —
    # without these, validators and client generators reject the spec
    import re

    for path, item in spec["paths"].items():
        names = re.findall(r"\{([^}]+)\}", path)
        if names:
            item["parameters"] = [
                {
                    "name": n,
                    "in": "path",
                    "required": True,
                    "schema": {"type": "string"},
                }
                for n in names
            ]
    return spec
