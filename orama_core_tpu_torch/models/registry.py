"""Embedding / LLM model registry.

Mirrors the reference's model table (`ai/mod.rs:17-27`,
`ai_server/src/embeddings/models.py`): BGE small/base/large and
multilingual-E5 small/base/large, plus deterministic "fake" models used by
tests/CI (the reference's fake-AI-server seam, test_utils.rs:96-133).

E5-family models require ``query:`` / ``passage:`` intent prefixes
(reference models.py:57-61); BGE-family prefixes queries only.

Port of ``orama_core_tpu/models/registry.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EmbeddingModelInfo:
    name: str
    dim: int
    query_prefix: str = ""
    passage_prefix: str = ""
    hf_repo: Optional[str] = None
    max_input_tokens: int = 512


_E5_Q = "query: "
_E5_P = "passage: "
_BGE_Q = "Represent this sentence for searching relevant passages: "

EMBEDDING_MODELS: Dict[str, EmbeddingModelInfo] = {
    m.name: m
    for m in [
        EmbeddingModelInfo("fake-small", 128),
        EmbeddingModelInfo("fake-base", 384),
        EmbeddingModelInfo("bge-small", 384, _BGE_Q, "", "BAAI/bge-small-en-v1.5"),
        EmbeddingModelInfo("bge-base", 768, _BGE_Q, "", "BAAI/bge-base-en-v1.5"),
        EmbeddingModelInfo("bge-large", 1024, _BGE_Q, "", "BAAI/bge-large-en-v1.5"),
        EmbeddingModelInfo(
            "multilingual-e5-small", 384, _E5_Q, _E5_P, "intfloat/multilingual-e5-small"
        ),
        EmbeddingModelInfo(
            "multilingual-e5-base", 768, _E5_Q, _E5_P, "intfloat/multilingual-e5-base"
        ),
        EmbeddingModelInfo(
            "multilingual-e5-large", 1024, _E5_Q, _E5_P, "intfloat/multilingual-e5-large"
        ),
        # JAX-native encoder (models/encoder.py) with randomly initialized or
        # HF-converted weights
        EmbeddingModelInfo("jax-minilm", 384, _E5_Q, _E5_P),
        # Deterministic lexical random-indexing embedder (models/lexical.py):
        # the zero-checkpoint out-of-box tier — no prefixes (symmetric model)
        EmbeddingModelInfo("lexical-small", 384),
        EmbeddingModelInfo("lexical-base", 768),
    ]
}

# Model groups (reference embeddings.py: en / multilingual / small / all)
MODEL_GROUPS: Dict[str, Tuple[str, ...]] = {
    "fake": ("fake-small", "fake-base"),
    "en": ("bge-small", "bge-base", "bge-large"),
    "multilingual": (
        "multilingual-e5-small",
        "multilingual-e5-base",
        "multilingual-e5-large",
    ),
    "small": ("bge-small", "multilingual-e5-small"),
}


def model_info(name: str) -> EmbeddingModelInfo:
    try:
        return EMBEDDING_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown embedding model {name!r}") from None


def model_dim(name: str) -> int:
    return model_info(name).dim
