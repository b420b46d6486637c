"""gRPC server exposing an in-process AIService to remote consumers.

The TPU engine's models normally run in-process; this server turns the
same seam into a network service so other hosts (or a reference-style
Rust engine) can consume this box's models. Reference analog:
src/ai_server/src/grpc/server.py (the Python sidecar's server half).

Port of ``orama_core_tpu/rpc/server.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Callable, Iterator, Optional

import grpc

from . import ai_service_pb2 as pb
from .stubs import ENUM_TO_MODEL, LLM_TYPE_TO_ROLE, METHODS, SERVICE_NAME

log = logging.getLogger("orama.rpc")

# planner(input, collection_id, messages) -> iterator of (data, finished)
PlannerFn = Callable[[str, str, list], Iterator[tuple]]


class _AiHandlers:
    def __init__(self, ai, planner: Optional[PlannerFn] = None) -> None:
        self.ai = ai
        self.planner = planner

    def CheckHealth(self, request: pb.HealthCheckRequest, context) -> pb.HealthCheckResponse:
        return pb.HealthCheckResponse(status=self.ai.check_health().get("status", "error"))

    def GetEmbedding(self, request: pb.EmbeddingRequest, context) -> pb.EmbeddingResponse:
        model = request.model_name or ENUM_TO_MODEL.get(request.model)
        if model is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "unknown model")
        texts = list(request.input)
        if request.intent == pb.passage:
            vecs = self.ai.embed_passage(model, texts)
        else:
            vecs = self.ai.embed_query(model, texts)
        return pb.EmbeddingResponse(
            embeddings_result=[pb.Embedding(embeddings=row.tolist()) for row in vecs],
            dimensions=int(vecs.shape[1]) if vecs.size else 0,
        )

    def Chat(self, request: pb.ChatRequest, context) -> pb.ChatResponse:
        role = LLM_TYPE_TO_ROLE.get(request.model, "answer")
        text = self.ai.chat(role, request.prompt, request.context or "")
        return pb.ChatResponse(text=text)

    def ChatStream(self, request: pb.ChatRequest, context):
        role = LLM_TYPE_TO_ROLE.get(request.model, "answer")
        for chunk in self.ai.chat_stream(role, request.prompt, request.context or ""):
            yield pb.ChatStreamResponse(text_chunk=chunk, is_final=False)
        yield pb.ChatStreamResponse(text_chunk="", is_final=True)

    def PlannedAnswer(self, request: pb.PlannedAnswerRequest, context):
        if self.planner is None:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "no planner attached (engine-side PartyPlanner runs in-process)",
            )
        messages = [
            {"role": pb.Role.Name(m.role).lower(), "content": m.content}
            for m in request.conversation.messages
        ]
        for data, finished in self.planner(request.input, request.collection_id, messages):
            yield pb.PlannedAnswerResponse(data=data, finished=finished)


def _generic_handler(handlers: _AiHandlers) -> grpc.GenericRpcHandler:
    table = {}
    for spec in METHODS.values():
        fn = getattr(handlers, spec.name)
        if spec.server_streaming:
            h = grpc.unary_stream_rpc_method_handler(
                fn,
                request_deserializer=spec.request.FromString,
                response_serializer=spec.response.SerializeToString,
            )
        else:
            h = grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=spec.request.FromString,
                response_serializer=spec.response.SerializeToString,
            )
        table[spec.name] = h
    return grpc.method_handlers_generic_handler(SERVICE_NAME, table)


def serve_ai(
    ai,
    host: str = "127.0.0.1",
    port: int = 0,
    planner: Optional[PlannerFn] = None,
    max_workers: int = 8,
):
    """Start a gRPC server for ``ai`` (an AIService). Returns (server, port)."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_generic_handler(_AiHandlers(ai, planner)),))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    log.info("AI gRPC server listening on %s:%d", host, bound)
    return server, bound
