"""Token-budgeted text chunking for long documents.

Counterpart of the reference's `Chunker` (`nlp/chunker.rs:8-66`: tiktoken
text splitter + markdown splitter + tree-sitter code splitters). Long-input
handling on TPU is a data-layout problem: each chunk becomes one vector of a
multi-vector document (the vector index already supports several vectors per
doc), and scoring reduces per-doc (SURVEY.md §5 "long-context").

Token counting here is a whitespace/word heuristic (~1 token per word-piece
of <=4 chars) rather than a BPE — the budget only needs to be approximately
right for embedding-model context limits.

Port of ``orama_core_tpu/nlp/chunker.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import re
from typing import List

_WORD = re.compile(r"\S+")
_MD_HEADING = re.compile(r"^(#{1,6})\s", re.MULTILINE)
_SENTENCE_END = re.compile(r"(?<=[.!?])\s+")


def approx_token_count(text: str) -> int:
    n = 0
    for m in _WORD.finditer(text):
        n += max(1, (len(m.group()) + 3) // 4)
    return n


class Chunker:
    def __init__(self, max_tokens: int = 256, overlap: int = 0) -> None:
        if overlap >= max_tokens:
            raise ValueError("overlap must be smaller than max_tokens")
        self.max_tokens = max_tokens
        self.overlap = overlap

    def chunk_text(self, text: str) -> List[str]:
        text = text.strip()
        if not text:
            return []
        if approx_token_count(text) <= self.max_tokens:
            return [text]
        pieces = _SENTENCE_END.split(text)
        return self._assemble(pieces)

    def chunk_markdown(self, text: str) -> List[str]:
        """Split at headings first, then by sentences within oversize parts."""
        text = text.strip()
        if not text:
            return []
        bounds = [m.start() for m in _MD_HEADING.finditer(text)]
        if not bounds or bounds[0] != 0:
            bounds.insert(0, 0)
        bounds.append(len(text))
        sections = [text[a:b].strip() for a, b in zip(bounds, bounds[1:])]
        out: List[str] = []
        for sec in sections:
            if not sec:
                continue
            out.extend(self.chunk_text(sec))
        return out

    def chunk_code(self, text: str) -> List[str]:
        """Code splitting at blank-line block boundaries (the reference uses
        tree-sitter; block boundaries are a language-agnostic approximation)."""
        text = text.rstrip()
        if not text:
            return []
        blocks = re.split(r"\n\s*\n", text)
        return self._assemble(blocks, sep="\n\n")

    def _assemble(self, pieces: List[str], sep: str = " ") -> List[str]:
        chunks: List[str] = []
        cur: List[str] = []
        cur_tokens = 0
        for piece in pieces:
            piece = piece.strip()
            if not piece:
                continue
            t = approx_token_count(piece)
            if t > self.max_tokens:
                # hard-split an oversize piece by the TOKEN budget, not a
                # word count — long words charge (len+3)//4 tokens each, so
                # max_tokens WORDS could overflow the model context ~2x
                if cur:
                    chunks.append(sep.join(cur))
                    cur, cur_tokens = [], 0
                part: List[str] = []
                part_tokens = 0
                for w in piece.split():
                    wt = max(1, (len(w) + 3) // 4)
                    if part and part_tokens + wt > self.max_tokens:
                        chunks.append(" ".join(part))
                        part, part_tokens = [], 0
                    part.append(w)
                    part_tokens += wt
                if part:
                    chunks.append(" ".join(part))
                continue
            if cur_tokens + t > self.max_tokens and cur:
                chunks.append(sep.join(cur))
                if self.overlap and cur:
                    tail = cur[-1]
                    cur = [tail]
                    cur_tokens = approx_token_count(tail)
                else:
                    cur, cur_tokens = [], 0
            cur.append(piece)
            cur_tokens += t
        if cur:
            chunks.append(sep.join(cur))
        return chunks
