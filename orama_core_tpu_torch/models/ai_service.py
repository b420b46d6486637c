"""AI service: embeddings + chat, in-process.

Replaces the reference's gRPC client/server pair (`src/ai/mod.rs` tonic
client + `src/ai_server/` Python sidecar): on TPU the embedding model runs
*in-process* as a JAX forward pass sharing the device with the search
kernels — no serialization boundary on the query hot path. The service
keeps the same seam (embed with query/passage intent, chat, chat_stream) so
a remote backend could be swapped in.

Backends:
- "fake": deterministic hash-projection embedder + canned LLM (tests/CI)
- "jax":  models/encoder.py transformer encoder (random or HF-loaded
          weights) and models/llm.py decoder for chat (the reference's
          backend name, kept so its configuration files load)

Port of ``orama_core_tpu/models/ai_service.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``. The service also takes the device
the models run on (``cfg.gpu.device`` in ``build_orama``): the embedding
loop's thread and the read side's threads then name the same card.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import AiConfig
from .fake import FakeEmbedder, FakeLLM
from .registry import model_info


class AIService:
    def __init__(self, cfg: Optional[AiConfig] = None, device: str = "cuda") -> None:
        self.cfg = cfg or AiConfig()
        self.device = device
        self._lock = threading.Lock()
        self._embedders: Dict[str, object] = {}
        self._llm: Optional[object] = None

    # -- embeddings -----------------------------------------------------------

    def _resolve_checkpoint(self, model: str) -> Optional[str]:
        """Encoder checkpoint dir for ``model``: ``embedding_checkpoint_path``
        may point at one checkpoint or at a directory of per-model subdirs."""
        import os

        root = getattr(self.cfg, "embedding_checkpoint_path", None)
        if not root:
            return None
        per_model = os.path.join(root, model)
        if os.path.exists(os.path.join(per_model, "config.json")):
            return per_model
        if os.path.exists(os.path.join(root, "config.json")):
            return root
        return None

    def _embedder(self, model: str):
        # double-checked: construction (checkpoint load + jit setup) can
        # take tens of seconds and must not serialize traffic to models
        # that are already built
        e = self._embedders.get(model)
        if e is not None:
            return e
        info = model_info(model)
        if model.startswith("lexical"):
            from .lexical import LexicalEmbedder

            e = LexicalEmbedder(info.dim)
        elif self.cfg.backend == "jax" and not model.startswith("fake"):
            e = self._jax_embedder(model, info)
        else:
            e = FakeEmbedder(info.dim)
        with self._lock:
            return self._embedders.setdefault(model, e)

    def _jax_embedder(self, model: str, info):
        """Transformer forward when a real checkpoint is on disk; otherwise
        the documented fallback ladder: ``jax-*`` registry entries keep the
        random-init encoder (compile/perf paths), pretrained-family names
        (bge/e5) degrade to the deterministic lexical embedder — random
        transformer weights would rank by noise (models/lexical.py)."""
        import logging

        from .encoder import EncoderEmbedder

        ckpt = self._resolve_checkpoint(model)
        if ckpt is not None:
            from .hf_loader import load_encoder_checkpoint, load_encoder_tokenizer

            loaded = load_encoder_checkpoint(ckpt)
            if loaded is not None:
                cfg, params = loaded
                tok = load_encoder_tokenizer(ckpt, cfg.max_len)
                if tok is None:
                    # real weights + the hash tokenizer = confident noise
                    # (blake2b buckets bear no relation to the trained
                    # vocab). Refuse the pairing; fall through to lexical.
                    logging.getLogger("oramax.ai").warning(
                        "checkpoint %s has weights but no loadable "
                        "tokenizer files — refusing to pair pretrained "
                        "weights with the hash tokenizer; using the "
                        "lexical fallback", ckpt,
                    )
                else:
                    if cfg.out_dim != info.dim:
                        logging.getLogger("oramax.ai").warning(
                            "checkpoint %s dim %d != registry dim %d for %s",
                            ckpt, cfg.out_dim, info.dim, model,
                        )
                    return EncoderEmbedder(
                        model, cfg=cfg, params=params, tokenizer=tok,
                        device=self.device,
                    )
        if model.startswith("jax"):
            return EncoderEmbedder(model, device=self.device)
        logging.getLogger("oramax.ai").warning(
            "no checkpoint for %s (embedding_checkpoint_path=%r) — using the "
            "lexical fallback embedder; run scripts/prepare_checkpoint.py for "
            "pretrained weights",
            model, getattr(self.cfg, "embedding_checkpoint_path", None),
        )
        from .lexical import LexicalEmbedder

        return LexicalEmbedder(info.dim)

    def embed_query(self, model: str, texts: Sequence[str]) -> np.ndarray:
        """[len(texts), dim] float32 (intent prefix per model registry;
        reference: GetEmbedding with intent=query, models.py:57-61)."""
        info = model_info(model)
        prefixed = [info.query_prefix + t for t in texts]
        return self._embed_batched(model, prefixed)

    def embed_passage(self, model: str, texts: Sequence[str]) -> np.ndarray:
        info = model_info(model)
        prefixed = [info.passage_prefix + t for t in texts]
        return self._embed_batched(model, prefixed)

    def _embed_batched(self, model: str, texts: Sequence[str]) -> np.ndarray:
        e = self._embedder(model)
        bs = max(1, self.cfg.max_batch_size)
        outs: List[np.ndarray] = []
        for i in range(0, len(texts), bs):
            outs.append(e.embed(texts[i : i + bs]))
        if not outs:
            return np.zeros((0, model_info(model).dim), dtype=np.float32)
        return np.concatenate(outs, axis=0)

    def check_health(self) -> Dict[str, str]:
        """Liveness probe (reference: gRPC CheckHealth, grpc/server.py:26-35):
        runs one tiny embedding forward through the active backend."""
        try:
            out = self.embed_query(self.cfg.embedding_model, ["ping"])
            ok = out.shape[0] == 1 and bool(np.isfinite(out).all())
            return {"status": "ok" if ok else "degraded", "backend": self.cfg.backend}
        except Exception as e:
            return {"status": "error", "backend": self.cfg.backend, "error": str(e)}

    # -- chat -----------------------------------------------------------------

    def _get_llm(self):
        llm = self._llm
        if llm is not None:
            return llm
        if self.cfg.backend == "jax" and self.cfg.llm_model != "fake-llm":
            from .llm import ChatLLM

            llm = ChatLLM(
                self.cfg.llm_model,
                self.cfg.hf_model_path,
                temperature=getattr(self.cfg, "llm_temperature", 0.0),
                device=self.device,
            )
        else:
            llm = FakeLLM()
        with self._lock:
            if self._llm is None:
                self._llm = llm
            return self._llm

    def chat(self, role: str, prompt: str, context: str = "") -> str:
        return self._get_llm().chat(role, prompt, context)

    def chat_stream(self, role: str, prompt: str, context: str = "") -> Iterator[str]:
        return self._get_llm().chat_stream(role, prompt, context)
