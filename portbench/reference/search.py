"""The plain reference of the engine's search semantics, in plain torch.

It imports nothing of the program, of ``jax`` or of ``orama_core_tpu``.
Given the generated collection (``portbench/generators``' raw arrays) and
the requests' text, it works out again everything the program derives:

- the query embedding of ``fake-base`` (a frozen copy of the hash
  bag-of-words embedder: each ``[a-z0-9]+`` token of the lowercased text
  seeds ``numpy.random.default_rng`` with the first 8 bytes of its
  blake2b digest and draws a unit normal vector; a text embeds to the
  normalised sum), normalised once more as the engine does;
- BM25 (k1 1.2, b 0.75, idf ln(1 + (N - df + 0.5) / (df + 0.5)), df the
  posting count of the term, avgdl the mean document length), each
  posting's contribution summed per document;
- the cosine of the rows as stored (rounded to bfloat16, as the
  configuration states) with the query rounded likewise, the products
  summed in float64;
- and, in ``portbench/comparisons/``, RRF (k 60, ranks in the stable
  descending order), the top-k and the match count.

Scores come back in float64 on ``device``; the caller works in blocks of
requests or rows so that they fit.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

K1 = 1.2
B = 0.75
RRF_K = 60.0

_TOKEN = re.compile(r"[a-z0-9]+")


class HashEmbedder:
    """Frozen copy of ``fake-base``'s embedder (384-d for ``fake-base``)."""

    def __init__(self, dim: int) -> None:
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    def _token_vec(self, token: str) -> np.ndarray:
        v = self._cache.get(token)
        if v is None:
            seed = int.from_bytes(
                hashlib.blake2b(token.encode(), digest_size=8).digest(), "big")
            v = np.random.default_rng(seed).standard_normal(self.dim).astype(
                np.float32)
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


def query_vectors(texts: Sequence[str], dim: int) -> np.ndarray:
    """f32[len(texts), dim]: the embedded, normalised queries."""
    q = HashEmbedder(dim).embed(texts)
    return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)


def term_ids(text: str, n_terms: int) -> List[int]:
    """The distinct vocabulary words ``term%06d`` of a request's text."""
    out: List[int] = []
    for tok in _TOKEN.findall(text.lower()):
        if tok.startswith("term") and tok[4:].isdigit() and len(tok) == 10:
            t = int(tok[4:])
            if t < n_terms and t not in out:
                out.append(t)
    return out


class Bm25:
    """BM25 rows of one string field, from the raw posting arrays."""

    def __init__(self, raw: Dict[str, Any], n_terms: int, device) -> None:
        self.n = int(raw["n_docs"])
        self.n_terms = n_terms
        self.device = device
        self.term_starts = raw["term_starts"]
        self.post_docs = raw["post_docs"]
        self.post_tf = raw["post_tf"]
        lens = torch.as_tensor(raw["doc_lens"], dtype=torch.float64)
        self.avgdl = float(lens.sum()) / self.n
        self.lens = lens.to(device)

    def rows(self, texts: Sequence[str]) -> torch.Tensor:
        """f64[len(texts), n_docs]: each text's BM25 score of every doc."""
        out = torch.zeros(len(texts), self.n, dtype=torch.float64,
                          device=self.device)
        for i, text in enumerate(texts):
            for t in term_ids(text, self.n_terms):
                lo, hi = int(self.term_starts[t]), int(self.term_starts[t + 1])
                if hi <= lo:
                    continue
                df = float(hi - lo)
                idf = np.log1p(max((self.n - df + 0.5) / (df + 0.5), 0.0))
                docs = torch.as_tensor(self.post_docs[lo:hi].astype(np.int64),
                                       device=self.device)
                tf = torch.as_tensor(self.post_tf[lo:hi], dtype=torch.float64,
                                     device=self.device)
                den = tf + K1 * (1.0 - B + B * self.lens[docs] / self.avgdl)
                out[i].index_add_(0, docs, idf * tf * (K1 + 1.0) / den)
        return out


class Cosine:
    """Cosines of the stored (bfloat16) rows against queries, in float64."""

    def __init__(self, vecs: np.ndarray, device, block_rows: int = 1 << 20) -> None:
        self.vecs = vecs
        self.n = vecs.shape[0]
        self.device = device
        self.block_rows = block_rows

    @staticmethod
    def stored(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(torch.float64)

    def blocks(self, queries: np.ndarray):
        """Yields (lo, f64[len(queries), rows]) over row blocks."""
        q = self.stored(torch.as_tensor(queries, device=self.device))
        for lo in range(0, self.n, self.block_rows):
            rows = torch.as_tensor(self.vecs[lo:lo + self.block_rows],
                                   device=self.device)
            yield lo, q @ self.stored(rows).T

    def rows(self, queries: np.ndarray) -> torch.Tensor:
        """f64[len(queries), n]: every row's cosine."""
        out = torch.empty(len(queries), self.n, dtype=torch.float64,
                          device=self.device)
        for lo, s in self.blocks(queries):
            out[:, lo:lo + s.shape[1]] = s
        return out
