"""Out-of-box lexical embedder: deterministic hashed random-indexing.

The reference ships pretrained fastembed/ONNX weights and therefore has
retrieval-quality embeddings on first boot (embeddings/models.py:18-76).
This image is zero-egress, so a fresh deployment has no checkpoint on disk;
before this module the ``jax`` backend silently embedded with a random-init
transformer, whose similarities are noise. ``LexicalEmbedder`` is the honest
out-of-box default instead: a classical random-indexing / feature-hashing
bag-of-features encoder whose cosine similarity tracks *lexical* overlap —
not semantic like BGE/E5, but a real ranking signal (shared stems and
character n-grams score high), deterministic across processes, and
language-agnostic.

Construction (all deterministic, no trained weights):
- word features: unicode word tokens, sub-linear tf weight ``1 + ln(tf)``
- character n-gram features (3..5-grams of ``^word$``): robust to
  inflection and to languages without whitespace stemming; weighted 0.4
  relative to whole words
- every feature maps (stable blake2b seed, NOT Python's salted ``hash``) to
  a pseudo-random unit vector in R^dim; a text embeds to the weighted sum,
  L2-normalized — so cosine(text_a, text_b) approximates the weighted
  Jaccard-style overlap of their feature multisets.

When an operator drops a real checkpoint (scripts/prepare_checkpoint.py),
AIService upgrades the model to the true transformer forward; this class is
the documented fallback tier, mirrored after the reference's fake-AI seam
(test_utils.rs:96-133) but built for production first-boot use.

Port of ``orama_core_tpu/models/lexical.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import math
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

_WORD = re.compile(r"\w+", re.UNICODE)

_NGRAM_WEIGHT = 0.4
_NGRAM_SIZES = (3, 4, 5)


class LexicalEmbedder:
    """Deterministic lexical embedding model (see module docstring)."""

    # feature-vector cache bound: vectors re-derive cheaply from their
    # blake2b seed, so the cache is a pure speedup for the Zipf head —
    # unbounded it would grow ~dim*4 bytes per DISTINCT corpus feature
    # (tens of GB over a few million indexed docs)
    MAX_CACHE = 1 << 17

    def __init__(self, dim: int, max_features_per_text: int = 4096) -> None:
        self.dim = dim
        self.max_features = max_features_per_text
        self._vecs: Dict[str, np.ndarray] = {}

    # -- feature extraction ---------------------------------------------------

    @staticmethod
    def _features(text: str) -> List[Tuple[str, float]]:
        words = _WORD.findall(text.lower())
        if not words:
            return []
        tf = Counter(words)
        feats: List[Tuple[str, float]] = []
        for w, n in tf.items():
            wt = 1.0 + math.log(n)
            feats.append(("w:" + w, wt))
            padded = f"^{w}$"
            seen = set()
            for k in _NGRAM_SIZES:
                if len(padded) < k:
                    continue
                for i in range(len(padded) - k + 1):
                    g = padded[i : i + k]
                    if g not in seen:
                        seen.add(g)
                        feats.append(("g:" + g, _NGRAM_WEIGHT * wt))
        return feats

    def _vec(self, feature: str) -> np.ndarray:
        v = self._vecs.get(feature)
        if v is None:
            seed = int.from_bytes(
                hashlib.blake2b(feature.encode(), digest_size=8).digest(), "big"
            )
            rng = np.random.default_rng(seed)
            v = rng.standard_normal(self.dim).astype(np.float32)
            v /= max(float(np.linalg.norm(v)), 1e-12)
            if len(self._vecs) < self.MAX_CACHE:
                self._vecs[feature] = v
        return v

    # -- embedding --------------------------------------------------------------

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, text in enumerate(texts):
            feats = self._features(text)[: self.max_features]
            if not feats:
                continue
            acc = np.zeros(self.dim, dtype=np.float32)
            for f, wt in feats:
                acc += wt * self._vec(f)
            n = float(np.linalg.norm(acc))
            if n > 0:
                out[i] = acc / n
        return out
