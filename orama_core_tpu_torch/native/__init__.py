"""Native (C++) host runtime: build + ctypes bindings.

The library is built on first use (g++ -O3 -shared; ~2s, cached as
``build/native/liboramax.so`` under the repository root, which git
ignores). Everything degrades to the pure-Python
implementations when the toolchain or build is unavailable — `available()`
reports which path is active.

Port of ``orama_core_tpu/native/__init__.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "oramax_native.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
_LIB = os.path.join(_BUILD, "liboramax.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
            return True
        os.makedirs(_BUILD, exist_ok=True)
        # build under a private name, then rename: concurrent test workers
        # must never load a half-written library
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        out = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            capture_output=True,
            timeout=120,
        )
        if out.returncode != 0:
            return False
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.oramax_tokenize.restype = ctypes.c_void_p
        lib.oramax_tokenize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.oramax_tokenize_n_tokens.restype = ctypes.c_int64
        lib.oramax_tokenize_n_tokens.argtypes = [ctypes.c_void_p]
        lib.oramax_tokenize_bytes_len.restype = ctypes.c_int64
        lib.oramax_tokenize_bytes_len.argtypes = [ctypes.c_void_p]
        lib.oramax_tokenize_copy.argtypes = [ctypes.c_void_p] + [
            ctypes.c_void_p
        ] * 4
        lib.oramax_tokenize_free.argtypes = [ctypes.c_void_p]

        lib.oramax_index_doc.restype = ctypes.c_void_p
        lib.oramax_index_doc.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.oramax_index_doc_sizes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.oramax_index_doc_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.oramax_index_doc_free.argtypes = [ctypes.c_void_p]

        lib.oramax_index_docs.restype = ctypes.c_void_p
        lib.oramax_index_docs.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.oramax_index_docs_sizes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.oramax_index_docs_copy.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        )
        lib.oramax_index_docs_free.argtypes = [ctypes.c_void_p]

        lib.oramax_builder_new.restype = ctypes.c_void_p
        lib.oramax_builder_free.argtypes = [ctypes.c_void_p]
        lib.oramax_builder_insert.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.oramax_builder_n_docs.restype = ctypes.c_int64
        lib.oramax_builder_n_docs.argtypes = [ctypes.c_void_p]
        lib.oramax_builder_total_len.restype = ctypes.c_int64
        lib.oramax_builder_total_len.argtypes = [ctypes.c_void_p]
        lib.oramax_builder_pack.restype = ctypes.c_int64
        lib.oramax_builder_pack.argtypes = [ctypes.c_void_p]
        lib.oramax_builder_packed_sizes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.oramax_builder_packed_copy.argtypes = [ctypes.c_void_p] + [
            ctypes.c_void_p
        ] * 7
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def tokenize_and_stem_en(text: str) -> List[Tuple[str, List[str]]]:
    """Native EN pipeline; same contract as TextParser.tokenize_and_stem."""
    lib = _load()
    assert lib is not None
    data = text.encode("utf-8")
    h = lib.oramax_tokenize(data, len(data), 1)
    try:
        n = lib.oramax_tokenize_n_tokens(h)
        if n == 0:
            return []
        blen = lib.oramax_tokenize_bytes_len(h)
        token_bytes = np.zeros(blen, np.uint8)
        offsets = np.zeros(n + 1, np.int32)
        positions = np.zeros(n, np.int32)
        kinds = np.zeros(n, np.uint8)
        lib.oramax_tokenize_copy(
            h,
            token_bytes.ctypes.data, offsets.ctypes.data,
            positions.ctypes.data, kinds.ctypes.data,
        )
    finally:
        lib.oramax_tokenize_free(h)
    raw = token_bytes.tobytes()
    out: List[Tuple[str, List[str]]] = []
    for i in range(n):
        tok = raw[offsets[i] : offsets[i + 1]].decode("utf-8")
        if kinds[i] == 0:
            out.append((tok, []))
        else:
            out[-1][1].append(tok)
    return out


def index_doc_en(text: str):
    """Whole-document EN indexing in one native call.

    Returns (terms_dict {term: (positions...)}, field_length) — the exact
    payload of IndexStringOp — with one Python object per *unique* term
    instead of per token."""
    lib = _load()
    assert lib is not None
    data = text.encode("utf-8")
    h = lib.oramax_index_doc(data, len(data))
    try:
        sizes = np.zeros(4, np.int64)
        lib.oramax_index_doc_sizes(h, sizes.ctypes.data)
        n_terms, tb_len, n_pos, field_len = (int(x) for x in sizes)
        if n_terms == 0:
            return {}, 0
        term_bytes = np.zeros(max(tb_len, 1), np.uint8)
        term_offsets = np.zeros(n_terms + 1, np.int32)
        pos_starts = np.zeros(n_terms + 1, np.int32)
        positions = np.zeros(max(n_pos, 1), np.int32)
        lib.oramax_index_doc_copy(
            h, term_bytes.ctypes.data, term_offsets.ctypes.data,
            pos_starts.ctypes.data, positions.ctypes.data,
        )
    finally:
        lib.oramax_index_doc_free(h)
    raw = term_bytes.tobytes()
    pos_list = positions.tolist()
    terms = {}
    for i in range(n_terms):
        terms[raw[term_offsets[i] : term_offsets[i + 1]].decode("utf-8")] = tuple(
            pos_list[pos_starts[i] : pos_starts[i + 1]]
        )
    return terms, field_len


def index_docs_en(texts: "List[str]"):
    """Batched :func:`index_doc_en`: N documents in ONE native call.

    Returns a list of (terms_dict, field_length) in input order. The
    per-call ctypes marshalling (~80us/doc: handle management plus four
    output buffers) dominated the single-doc path on bulk ingest."""
    lib = _load()
    assert lib is not None
    if not texts:
        return []
    blobs = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    data = b"".join(blobs)
    h = lib.oramax_index_docs(data, offsets.ctypes.data, len(blobs))
    try:
        sizes = np.zeros(4, np.int64)
        lib.oramax_index_docs_sizes(h, sizes.ctypes.data)
        n_terms, tb_len, n_pos, n_docs = (int(x) for x in sizes)
        term_bytes = np.zeros(max(tb_len, 1), np.uint8)
        term_offsets = np.zeros(n_terms + 1, np.int32)
        pos_starts = np.zeros(n_terms + 1, np.int32)
        positions = np.zeros(max(n_pos, 1), np.int32)
        doc_term_starts = np.zeros(n_docs + 1, np.int32)
        field_lengths = np.zeros(max(n_docs, 1), np.int32)
        lib.oramax_index_docs_copy(
            h, term_bytes.ctypes.data, term_offsets.ctypes.data,
            pos_starts.ctypes.data, positions.ctypes.data,
            doc_term_starts.ctypes.data, field_lengths.ctypes.data,
        )
    finally:
        lib.oramax_index_docs_free(h)
    raw = term_bytes.tobytes()
    pos_list = positions.tolist()
    toff = term_offsets.tolist()
    pstarts = pos_starts.tolist()
    dstarts = doc_term_starts.tolist()
    flens = field_lengths.tolist()
    out = []
    for d in range(n_docs):
        terms = {}
        for i in range(dstarts[d], dstarts[d + 1]):
            terms[raw[toff[i] : toff[i + 1]].decode("utf-8")] = tuple(
                pos_list[pstarts[i] : pstarts[i + 1]]
            )
        out.append((terms, flens[d]))
    return out


_EN_SAFE: "frozenset[str] | None" = None


def _build_en_safe() -> "frozenset[str]":
    """Per-character agreement set between the native EN tokenizer and the
    Python pipeline, built EMPIRICALLY (probe both on each char once).

    The native fold covers most accented Latin but not every codepoint
    (ß/æ/ð/þ fold to 0 and split the word; >= 0x370 is kept raw while
    Python NFKD-folds) — indexing a doc through the native path when the
    query side tokenizes differently makes its terms unreachable. Probing
    beats hand-maintaining two tables in sync."""
    from ..nlp.tokenizer import TextParser

    parser = TextParser("en")
    safe = set()
    # Latin-1 supplement .. Latin Ext-B start, plus general punctuation
    for lo, hi in ((0xA0, 0x250), (0x2000, 0x2070)):
        for cp in range(lo, hi):
            ch = chr(cp)
            probe = f"xx{ch}yy zz"
            try:
                if tokenize_and_stem_en(probe) == parser.tokenize_and_stem(
                    probe
                ):
                    safe.add(ch)
            except Exception:
                pass
    return frozenset(safe)


def en_safe(text: str) -> bool:
    """True when the native EN pipeline provably tokenizes ``text`` exactly
    like the Python pipeline the QUERY side uses. ASCII is always safe;
    other chars consult the probed agreement set; anything un-probed
    (>= U+0250 beyond punctuation) routes to the Python path."""
    if text.isascii():
        return True
    global _EN_SAFE
    if _EN_SAFE is None:
        _EN_SAFE = _build_en_safe()
    safe = _EN_SAFE
    return all(ord(c) < 0x80 or c in safe for c in text)


class NativePostingBuilder:
    """Accumulate per-doc term/position streams, pack committed CSR."""

    def __init__(self) -> None:
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.oramax_builder_new()

    def insert(self, doc_id: int, field_len: int, terms_positions) -> None:
        """terms_positions: iterable of (term, positions list)."""
        toks: List[bytes] = []
        poss: List[int] = []
        for term, positions in terms_positions:
            tb = term.encode("utf-8")
            for p in positions:
                toks.append(tb)
                poss.append(p)
        # n_terms == 0 still registers the document's field length
        offsets = np.zeros(len(toks) + 1, np.int32)
        np.cumsum([len(t) for t in toks], out=offsets[1:])
        blob = b"".join(toks)
        pos_arr = np.asarray(poss, np.int32)
        self._lib.oramax_builder_insert(
            self._h, doc_id, field_len,
            blob, offsets.ctypes.data, len(toks), pos_arr.ctypes.data,
        )

    def pack(self):
        """Returns (terms list, term_starts, post_docs, post_tf, pos_starts,
        positions, n_docs, total_len)."""
        lib = self._lib
        lib.oramax_builder_pack(self._h)
        sizes = np.zeros(5, np.int64)
        lib.oramax_builder_packed_sizes(self._h, sizes.ctypes.data)
        tb_len, n_post, n_pos, n_terms, total_len = (int(x) for x in sizes)
        term_bytes = np.zeros(max(tb_len, 1), np.uint8)
        term_offsets = np.zeros(n_terms + 1, np.int32)
        term_starts = np.zeros(n_terms + 1, np.int64)
        post_docs = np.zeros(max(n_post, 1), np.int32)
        post_tf = np.zeros(max(n_post, 1), np.float32)
        pos_starts = np.zeros(n_post + 1, np.int64)
        positions = np.zeros(max(n_pos, 1), np.int32)
        lib.oramax_builder_packed_copy(
            self._h,
            term_bytes.ctypes.data, term_offsets.ctypes.data,
            term_starts.ctypes.data, post_docs.ctypes.data,
            post_tf.ctypes.data, pos_starts.ctypes.data,
            positions.ctypes.data,
        )
        raw = term_bytes.tobytes()
        terms = [
            raw[term_offsets[i] : term_offsets[i + 1]].decode("utf-8")
            for i in range(n_terms)
        ]
        n_docs = int(lib.oramax_builder_n_docs(self._h))
        return (
            terms, term_starts, post_docs[:n_post], post_tf[:n_post],
            pos_starts, positions[:n_pos], n_docs, total_len,
        )

    def __del__(self):
        try:
            self._lib.oramax_builder_free(self._h)
        except Exception:
            pass
