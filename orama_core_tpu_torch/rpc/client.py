"""Remote AI-service backend: the AIService interface over gRPC.

Drop-in replacement for models/ai_service.AIService when
``ai.remote_url`` is configured — the engine's embedding pipeline and
answer path call the same methods, but the model forward runs on a
remote host (a GPU sidecar, another TPU slice, or a reference-style
Python ai_server). Reference analog: the client pool in
src/ai/mod.rs:42-199 (tonic channel per host, round-robin); here a
single grpc channel multiplexes HTTP/2 streams, which covers the same
concurrency without a pool.

Port of ``orama_core_tpu/rpc/client.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, Sequence

import grpc
import numpy as np

from . import ai_service_pb2 as pb
from .stubs import METHODS, MODEL_TO_ENUM, ROLE_TO_LLM_TYPE

log = logging.getLogger("orama.rpc")


class RemoteAIService:
    """Implements the AIService seam (embed_query/embed_passage/chat/
    chat_stream/check_health) against a remote LLMService endpoint."""

    def __init__(self, url: str, timeout_s: float = 30.0) -> None:
        self.url = url
        self.timeout_s = timeout_s
        self._channel = grpc.insecure_channel(url)
        self._calls = {}
        for spec in METHODS.values():
            factory = self._channel.unary_stream if spec.server_streaming else self._channel.unary_unary
            self._calls[spec.name] = factory(
                spec.path,
                request_serializer=spec.request.SerializeToString,
                response_deserializer=spec.response.FromString,
            )

    def close(self) -> None:
        self._channel.close()

    # -- embeddings -----------------------------------------------------------

    def _embed(self, model: str, texts: Sequence[str], intent) -> np.ndarray:
        req = pb.EmbeddingRequest(
            model=MODEL_TO_ENUM.get(model, pb.BGESmall),
            model_name=model,
            input=list(texts),
            intent=intent,
        )
        resp = self._calls["GetEmbedding"](req, timeout=self.timeout_s)
        if not resp.embeddings_result:
            return np.zeros((0, resp.dimensions), dtype=np.float32)
        return np.asarray([list(e.embeddings) for e in resp.embeddings_result], dtype=np.float32)

    def embed_query(self, model: str, texts: Sequence[str]) -> np.ndarray:
        # Intent prefixes are applied server-side (it owns the registry).
        return self._embed(model, texts, pb.query)

    def embed_passage(self, model: str, texts: Sequence[str]) -> np.ndarray:
        return self._embed(model, texts, pb.passage)

    def check_health(self) -> Dict[str, str]:
        try:
            resp = self._calls["CheckHealth"](
                pb.HealthCheckRequest(service="ai"), timeout=self.timeout_s
            )
            return {"status": resp.status, "backend": f"remote:{self.url}"}
        except grpc.RpcError as e:
            return {"status": "error", "backend": f"remote:{self.url}", "error": str(e.code())}

    # -- chat -----------------------------------------------------------------

    def chat(self, role: str, prompt: str, context: str = "") -> str:
        req = pb.ChatRequest(
            model=ROLE_TO_LLM_TYPE.get(role, pb.answer), prompt=prompt, context=context
        )
        return self._calls["Chat"](req, timeout=self.timeout_s).text

    def chat_stream(self, role: str, prompt: str, context: str = "") -> Iterator[str]:
        req = pb.ChatRequest(
            model=ROLE_TO_LLM_TYPE.get(role, pb.answer), prompt=prompt, context=context
        )
        for resp in self._calls["ChatStream"](req, timeout=self.timeout_s):
            if resp.text_chunk:
                yield resp.text_chunk
            if resp.is_final:
                return

    # -- planned answer (optional; engine normally plans in-process) ---------

    def planned_answer(self, text: str, collection_id: str, messages=()) -> Iterator[tuple]:
        conv = pb.Conversation(
            messages=[
                pb.ConversationMessage(
                    role=getattr(pb, m.get("role", "user").upper(), pb.USER),
                    content=m.get("content", ""),
                )
                for m in messages
            ]
        )
        req = pb.PlannedAnswerRequest(input=text, collection_id=collection_id, conversation=conv)
        for resp in self._calls["PlannedAnswer"](req, timeout=self.timeout_s):
            yield resp.data, resp.finished
