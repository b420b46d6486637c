"""Deterministic fake embedder + LLM for tests and CI.

Plays the role of the reference's in-process fake AI server
(`test_utils.rs:96-133`, which runs a real local fastembed model): here the
embedder is a *hash-projection bag-of-words* — each token hashes (stable
blake2b, not Python's salted ``hash``) to a pseudo-random unit vector and a
text embeds to the normalized sum. Texts sharing tokens get high cosine —
enough signal for retrieval tests — and results are bit-identical across
processes and platforms.

Port of ``orama_core_tpu/models/fake.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterator, Sequence

import numpy as np

_TOKEN = re.compile(r"[a-z0-9]+")


class FakeEmbedder:
    def __init__(self, dim: int) -> None:
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    def _token_vec(self, token: str) -> np.ndarray:
        v = self._cache.get(token)
        if v is None:
            seed = int.from_bytes(
                hashlib.blake2b(token.encode(), digest_size=8).digest(), "big"
            )
            rng = np.random.default_rng(seed)
            v = rng.standard_normal(self.dim).astype(np.float32)
            v /= max(float(np.linalg.norm(v)), 1e-12)
            self._cache[token] = v
        return v

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, text in enumerate(texts):
            tokens = _TOKEN.findall(text.lower())
            if not tokens:
                continue
            acc = np.zeros(self.dim, dtype=np.float32)
            for t in tokens:
                acc += self._token_vec(t)
            n = float(np.linalg.norm(acc))
            if n > 0:
                out[i] = acc / n
        return out


class FakeLLM:
    """Canned-but-context-aware chat stub.

    The reference's fake server leaves chat as ``todo!()``; this one answers
    deterministically so the full answer/RAG pipeline is testable offline."""

    def chat(self, role: str, prompt: str, context: str = "") -> str:
        import json as _json

        if role in ("google_query_translator", "pp:OPTIMIZE_QUERY"):
            # "optimize the query": keep the content words — wrapped in the
            # reference's {"query": ...} reply contract (prompts/main.py:43-49)
            words = _TOKEN.findall(prompt.lower())
            return _json.dumps({"query": " ".join(words[:8]) or prompt})
        if role == "pp:GENERATE_QUERIES":
            words = _TOKEN.findall(prompt.lower())
            return _json.dumps({"queries": [" ".join(words[:6]) or prompt]})
        if role == "pp:CREATE_CODE":
            return _json.dumps({"code": f"// generated for: {prompt[:60]}"})
        if role == "pp:DESCRIBE_INPUT_CODE":
            return _json.dumps({"description": f"code about {prompt[:60]}"})
        if role == "party_planner":
            return (
                '{"actions": ['
                '{"step": "OPTIMIZE_QUERY", "description": "optimize"},'
                '{"step": "PERFORM_ORAMA_SEARCH", "description": "search"},'
                '{"step": "GIVE_REPLY", "description": "reply"}]}'
            )
        snippet = context.strip()[:200]
        if snippet:
            return f"Based on the retrieved context: {snippet}"
        return f"No relevant context found for: {prompt.strip()[:100]}"

    def chat_stream(self, role: str, prompt: str, context: str = "") -> Iterator[str]:
        text = self.chat(role, prompt, context)
        # stream in word chunks like a token streamer would
        words = text.split(" ")
        for i in range(0, len(words), 4):
            chunk = " ".join(words[i : i + 4])
            yield chunk + (" " if i + 4 < len(words) else "")
