"""gRPC seam for remote model backends (reference: src/ai_server/service.proto).

- ``serve_ai(ai, host, port)``: expose an in-process AIService over gRPC.
- ``RemoteAIService(url)``: consume a remote LLMService as the engine's
  model backend (config ``ai.remote_url``).

Port of ``orama_core_tpu/rpc/__init__.py``. ``ai_service_pb2.py`` is the
reference's generated file, byte for byte: the proto package
(``orama_ai_service``) and its wire names are shared, so either package's
client talks to either package's server, and protobuf's default pool
accepts the second, identical registration when both are imported in one
process. Do not regenerate it here; regenerate the reference's and copy it.

This package needs ``grpcio`` and ``protobuf``; the engine imports it only
when ``ai.remote_url`` or ``ai.grpc_port`` is set.
"""

from .client import RemoteAIService
from .server import serve_ai

__all__ = ["RemoteAIService", "serve_ai"]
