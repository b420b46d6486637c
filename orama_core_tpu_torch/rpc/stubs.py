"""Hand-rolled gRPC stub layer for the AI-service contract.

grpcio is in the image but grpcio-tools (the protoc gRPC plugin) is not,
so instead of generated ``*_pb2_grpc.py`` we register the same method
table through grpc's generic APIs: the server via
``grpc.method_handlers_generic_handler`` and the client via
``channel.unary_unary`` / ``channel.unary_stream``. This is exactly what
the generated stubs compile down to.

Reference analog: the tonic client pool in src/ai/mod.rs:42-199 and the
grpc server in src/ai_server/src/grpc/server.py.

Port of ``orama_core_tpu/rpc/stubs.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Type

from . import ai_service_pb2 as pb

SERVICE_NAME = "orama_ai_service.LLMService"


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    name: str
    request: Type
    response: Type
    server_streaming: bool = False

    @property
    def path(self) -> str:
        return f"/{SERVICE_NAME}/{self.name}"


METHODS = {
    m.name: m
    for m in [
        MethodSpec("CheckHealth", pb.HealthCheckRequest, pb.HealthCheckResponse),
        MethodSpec("GetEmbedding", pb.EmbeddingRequest, pb.EmbeddingResponse),
        MethodSpec("Chat", pb.ChatRequest, pb.ChatResponse),
        MethodSpec("ChatStream", pb.ChatRequest, pb.ChatStreamResponse, server_streaming=True),
        MethodSpec(
            "PlannedAnswer",
            pb.PlannedAnswerRequest,
            pb.PlannedAnswerResponse,
            server_streaming=True,
        ),
    ]
}

# OramaModel enum value <-> registry name (models/registry.py). The enum is
# the reference contract's closed model set; model_name covers the rest.
ENUM_TO_MODEL = {
    pb.BGESmall: "bge-small",
    pb.BGEBase: "bge-base",
    pb.BGELarge: "bge-large",
    pb.MultilingualE5Small: "multilingual-e5-small",
    pb.MultilingualE5Base: "multilingual-e5-base",
    pb.MultilingualE5Large: "multilingual-e5-large",
}
MODEL_TO_ENUM = {v: k for k, v in ENUM_TO_MODEL.items()}

LLM_TYPE_TO_ROLE = {
    pb.content_expansion: "content_expansion",
    pb.google_query_translator: "google_query_translator",
    pb.vision: "vision",
    pb.answer: "answer",
}
ROLE_TO_LLM_TYPE = {v: k for k, v in LLM_TYPE_TO_ROLE.items()}
