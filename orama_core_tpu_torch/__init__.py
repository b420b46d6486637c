"""orama_core_tpu_torch — the index-and-query engine on PyTorch and CUDA.

Port of ``orama_core_tpu`` (the JAX/TPU package, which stays the
reference) to one NVIDIA H100: full-text BM25, phrase, vector and hybrid
search with filters and facets, over committed indexes kept on the card.
The host side (op log, write side, indexes, tokenizer, storage) is the
reference's code; the scoring core is torch plus six hand-written Hopper
kernels (``csrc/``). Vector fields serve exact (bf16) or int8 indexes
(``cfg.gpu.vector_index = "int8"``), with single- or multi-vector docs,
and the ANN indexes ``"ivf"``, ``"pq"`` and ``"ivf_pq"``, trained at
commit on the engine's device (plain torch: the reference computes them
outside its Pallas kernels).

``build_orama(...)`` assembles the engine as the reference does
(`lib.rs:65-160`): AI service + write side + read side on one op channel,
optionally with the background loops. Everything runs on ``cuda`` unless
the caller passes ``device="cpu"`` (or sets ``cfg.gpu.device``); on the CPU
every kernel runs as its plain torch version. Nothing falls back from the
card to the CPU.

With ``ai.backend = "jax"`` passages and queries embed with the port's
transformer encoder and answers decode with its LLM, on the same device
(``models/``); ``python -m orama_core_tpu_torch`` serves the HTTP API
(``server/http.py``).

``selectEmbeddingProperties`` hooks run on the bundled MiniJS interpreter
(``engine/hooks.py``, ``engine/minijs.py``). ``ai.remote_url`` takes the
models from a gRPC sidecar (``rpc.RemoteAIService``) and ``ai.grpc_port``
serves this engine's models as one (``rpc.serve_ai``); ``rpc`` needs
``grpcio`` and ``protobuf`` and is imported only when one of the two is
set.

``gpu.mesh_shape`` (S, 1) shards each collection over S data shards of a
device mesh (``parallel/mesh.py``; several shards may share one card) and
serves its queries through the mesh programs (``parallel/
sharded_engine.py``), the kernels launched once per shard;
``parallel/multislice.py`` routes documents and queries over whole
engines (in process, over HTTP, or over gRPC with ``parallel/
slice_grpc.py``, imported only where it is asked for).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from .config import OramaxConfig
from .engine import ReadSide, WriteSide
from .models.ai_service import AIService
from .oplog import channel

__version__ = "0.1.0"


def configure_torch() -> None:
    """Numerics the port relies on: full-precision f32 matrix products on
    the card (TF32 would keep ~3 decimal digits of the exact scores)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_device(device) -> torch.device:
    """``device`` as a torch device. A CUDA device that is not there
    raises: nothing runs on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain torch versions"
        )
    return dev


class Orama:
    """The assembled engine (the reference's (WriteSide, ReadSide) pair)."""

    def __init__(self, cfg: OramaxConfig, start_background: bool = True) -> None:
        configure_torch()
        self.cfg = cfg
        require_device(cfg.gpu.device)
        if cfg.ai.remote_url:
            # the models run on the sidecar; search still runs on
            # cfg.gpu.device. A missing grpc raises here, naming the
            # package: never serve the in-process models in its place.
            from .rpc import RemoteAIService

            self.ai = RemoteAIService(cfg.ai.remote_url)
        else:
            self.ai = AIService(cfg.ai, device=cfg.gpu.device)
        self._grpc_server = None
        tx, rx = channel(cfg.writer_side.channel_capacity)
        from .engine.hooks import HooksRuntime
        import os as _os

        self.hooks = HooksRuntime(_os.path.join(cfg.writer_side.data_dir, "hooks"))
        self.write_side = WriteSide(cfg.writer_side, tx, self.ai, hooks=self.hooks)
        self.read_side = ReadSide(cfg.reader_side, rx, self.ai, cfg.gpu)
        self.wal = None
        if cfg.writer_side.wal_enabled:
            from .wal import WriteAheadLog

            self.wal = WriteAheadLog(cfg.writer_side.data_dir)
            tx.wal = self.wal
            self.read_side.wal = self.wal
            self.read_side.wal_pre_truncate = self.write_side.commit
            # crash recovery: replay the durable window beyond the last
            # committed read-side offset
            replayed = self.wal.replay(self.read_side._applied_offset)
            for stamped in replayed:
                self.read_side.apply(stamped)
                self.write_side.absorb_replayed(stamped)
            tx.set_offset(
                max(tx.offset, self.wal.last_offset, self.read_side._applied_offset)
            )
        # model sidecar server LAST: it serves PlannedAnswer against
        # read_side, which must exist before a client's first call
        if cfg.ai.grpc_port is not None and not cfg.ai.remote_url:
            from .rpc import serve_ai

            def _planner(text, collection_id, messages):
                # serve PlannedAnswer like the reference sidecar does
                # (ai_server planned_answer); engine-side steps run here
                import json as _json

                from .engine.answer import PartyPlanner

                for ev in PartyPlanner(self.read_side).run(
                    collection_id, text, conversation=messages, skip_auth=True
                ):
                    yield _json.dumps(ev), False
                yield "", True

            self._grpc_server, self.grpc_port = serve_ai(
                self.ai, port=cfg.ai.grpc_port, planner=_planner,
                host=cfg.ai.grpc_host,
            )
        self._stop = threading.Event()
        self._threads = []
        if start_background:
            self._spawn_background()

    # -- background loops (reference: lib.rs:93-99, write/mod.rs:158-179) -----

    def _spawn_background(self) -> None:
        from .utils import tracing

        def pump_loop():
            while not self._stop.is_set():
                try:
                    n = self.read_side.pump(timeout=0.05)
                    if self.read_side.should_commit:
                        self.read_side.commit()
                except Exception as e:
                    tracing.log("error", f"op pump error (op dropped): {e!r}")
                    n = 0
                if n == 0:
                    time.sleep(0.01)

        def embedding_loop():
            while not self._stop.is_set():
                try:
                    n = self.write_side.process_embeddings()
                except Exception as e:
                    tracing.log("error", f"embedding loop error: {e!r}")
                    n = 0
                    time.sleep(0.5)  # back off on a failing model backend
                if n == 0:
                    time.sleep(0.02)

        def commit_loop():
            last_w = last_r = time.monotonic()
            while not self._stop.is_set():
                now = time.monotonic()
                if now - last_w >= self.cfg.writer_side.commit_interval_sec:
                    try:
                        self.write_side.commit()
                    except Exception:
                        pass  # log-and-continue (reference write/mod.rs:174-176)
                    last_w = now
                if now - last_r >= self.cfg.reader_side.commit_interval_sec:
                    try:
                        if self.read_side._ops_since_commit > 0:
                            self.read_side.commit()
                    except Exception:
                        pass
                    last_r = now
                time.sleep(0.2)

        for fn in (pump_loop, embedding_loop, commit_loop):
            t = threading.Thread(target=fn, daemon=True, name=fn.__name__)
            t.start()
            self._threads.append(t)

    # -- synchronous control for tests / batch ingest -------------------------

    def flush(self) -> None:
        """Make all writes visible to search: drain embeddings + apply ops."""
        self.write_side.drain_embeddings()
        self.read_side.pump()
        if self.wal is not None:
            self.wal.sync()

    def commit(self) -> None:
        """Commit both sides (reference: WriteSide::commit + ReadSide::commit)."""
        self.flush()
        self.write_side.commit()
        self.read_side.commit()

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=1.0)
        if hasattr(self.ai, "close"):
            self.ai.close()
        self.read_side.close()


def build_orama(
    cfg: Optional[OramaxConfig] = None,
    start_background: bool = True,
    device: Optional[str] = None,
) -> Orama:
    """Assemble the engine. ``device`` ("cuda" or "cpu") overrides
    ``cfg.gpu.device``; the default is the card."""
    cfg = cfg or OramaxConfig()
    if device is not None:
        cfg.gpu.device = device
    return Orama(cfg, start_background=start_background)


def start(cfg: Optional[OramaxConfig] = None) -> None:
    """Boot the full server and block: the engine with its background
    loops, then the HTTP API on ``cfg.http`` (the reference's ``start``).
    Without ``cfg`` the configuration is loaded as the entry point loads
    it (``CONFIG_PATH`` and ``ORAMAX_`` variables)."""
    cfg = cfg or OramaxConfig.load()
    orama = build_orama(cfg, start_background=True)
    from .server.http import serve

    serve(orama, cfg.http)
