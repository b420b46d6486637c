"""Write-side collection: schema inference, field registry, doc processing.

Counterpart of the reference's `CollectionWriter`
(`sides/write/collection.rs`, `sides/write/fields.rs`): each inserted
document is flattened, unseen fields are inferred and registered (emitting
``CreateFieldOp``), and every typed field produces index ops into the op
log. Embedding fields enqueue an async request (the embedding queue batches
per model — embedding.rs:88-125).

Doc ids are **dense per collection** (0..N) — they index device arrays
directly (types.py) — with a user-id → doc-id map for lookups/upserts
(reference DocIdStorage, write/collection/doc_id_storage.rs).

Port of ``orama_core_tpu/engine/collection_write.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..nlp import get_parser
from ..oplog import (
    CreateFieldOp,
    IndexBoolOp,
    IndexKeywordOp,
    IndexNumberOp,
    IndexStringOp,
)
from ..types import TypedField, ValueType

AUTO_EMBEDDING_FIELD = "___orama_auto_embedding"
# Bound per-doc vector count for giant documents (32 x 512-token chunks
# ~ 16k tokens of coverage). Overflowing docs keep their FIRST chunks plus
# the LAST one, so tail content stays retrievable (test_multivector).
MAX_EMBEDDING_CHUNKS = 32


def _tokenize_and_stem(text: str, locale: str):
    """EN goes through the native C++ pipeline when built (the reference's
    hot loop, fields.rs:311-353); other locales use the Python parser."""
    if locale == "en":
        from .. import native

        # native only when it provably matches the Python tokenizer the
        # QUERY side uses (native.en_safe) — otherwise indexed terms
        # would be unreachable (e.g. ß splits, Vietnamese stays unfolded)
        if native.available() and native.en_safe(text):
            return native.tokenize_and_stem_en(text)
    return get_parser(locale).tokenize_and_stem(text)


def flatten_document(doc: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested objects flatten to dot-joined keys (reference FlattenDocument)."""
    out: Dict[str, Any] = {}
    for k, v in doc.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_document(v, key + "."))
        else:
            out[key] = v
    return out


def infer_value_type(value: Any) -> Optional[ValueType]:
    if isinstance(value, bool):
        return ValueType.BOOL
    if isinstance(value, (int, float)):
        return ValueType.NUMBER
    if isinstance(value, str):
        return ValueType.STRING
    if isinstance(value, list) and value:
        if all(isinstance(x, bool) for x in value):
            return ValueType.ARRAY_BOOL
        if all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in value):
            return ValueType.ARRAY_NUMBER
        if all(isinstance(x, str) for x in value):
            return ValueType.ARRAY_STRING
    return None  # null / mixed arrays / unsupported -> skipped


@dataclasses.dataclass
class EmbeddingRequest:
    collection_id: str
    doc_id: int
    field_id: int
    model: str
    text: str


class CollectionWriter:
    def __init__(
        self,
        collection_id: str,
        description: Optional[str],
        read_api_key: str,
        write_api_key: str,
        default_locale: str = "en",
        embedding_model: Optional[str] = None,
        embedding_sources: Optional[Sequence[str]] = None,  # None => all strings
    ) -> None:
        self.id = collection_id
        self.description = description
        self.read_api_key = read_api_key
        self.write_api_key = write_api_key
        self.default_locale = default_locale
        self.embedding_model = embedding_model

        self._lock = threading.RLock()
        self.fields: Dict[str, TypedField] = {}
        self._next_field_id = 0
        self.doc_id_by_user_id: Dict[str, int] = {}
        self.next_doc_id = 0
        self.document_count = 0
        self._pending_field_ops: List[CreateFieldOp] = []

        if embedding_model:
            self._register_field(
                AUTO_EMBEDDING_FIELD,
                ValueType.EMBEDDING,
                model=embedding_model,
                embedding_sources=tuple(embedding_sources) if embedding_sources else None,
            )

    # -- field registry -------------------------------------------------------

    def _register_field(
        self,
        name: str,
        vtype: ValueType,
        model: Optional[str] = None,
        embedding_sources: Optional[Tuple[str, ...]] = None,
    ) -> TypedField:
        f = TypedField(
            field_id=self._next_field_id,
            name=name,
            type=vtype,
            model=model,
            embedding_sources=embedding_sources,
            locale=self.default_locale,
        )
        self._next_field_id += 1
        self.fields[name] = f
        self._pending_field_ops.append(CreateFieldOp(self.id, f))
        return f

    def drain_field_ops(self) -> List[CreateFieldOp]:
        ops = self._pending_field_ops
        self._pending_field_ops = []
        return ops

    # -- doc ids --------------------------------------------------------------

    def assign_doc_id(self, user_id: str) -> Tuple[int, Optional[int]]:
        """Returns (new_doc_id, replaced_doc_id_or_None) — same user id twice
        is an upsert: the old internal doc is deleted."""
        with self._lock:
            old = self.doc_id_by_user_id.get(user_id)
            doc_id = self.next_doc_id
            self.next_doc_id += 1
            self.doc_id_by_user_id[user_id] = doc_id
            self.document_count += 1
            if old is not None:
                self.document_count -= 1
            return doc_id, old

    def lookup_doc_ids(self, user_ids: Sequence[str]) -> List[int]:
        """Resolve user ids to doc ids WITHOUT forgetting them — the
        caller pops via forget_doc_ids only after the delete op is safely
        in the channel (popping first would leave ghost documents that
        are searchable but undeletable if the send fails)."""
        with self._lock:
            return [
                d
                for uid in user_ids
                if (d := self.doc_id_by_user_id.get(uid)) is not None
            ]

    def forget_doc_ids(self, user_ids: Sequence[str]) -> None:
        with self._lock:
            for uid in user_ids:
                if self.doc_id_by_user_id.pop(uid, None) is not None:
                    self.document_count -= 1

    # -- document processing (reference: collection.rs:120-180) ---------------

    def prepare_native_terms(
        self, documents: Sequence[Dict[str, Any]]
    ) -> Optional[Dict[str, Tuple[Dict[str, tuple], int]]]:
        """Batch-precompute tokenize+stem for every EN-native-eligible string
        value in ``documents`` — ONE ctypes call for the whole batch instead
        of one per (doc, field). Returns {text: (terms, field_length)} or
        None when the native library is unavailable.

        Pure text->terms work only (no registry mutation), so callers run it
        OUTSIDE the per-collection write lock; `_index_ops_for` re-checks
        locale/type eligibility at use time, so a stale entry is merely
        unused, never wrong."""
        from .. import native

        if not native.available():
            return None
        texts: List[str] = []
        seen = set()
        for doc in documents:
            for key, value in flatten_document(doc).items():
                if key == "id":
                    continue
                if isinstance(value, str):
                    text = value
                elif (
                    isinstance(value, list)
                    and value
                    and all(isinstance(x, str) for x in value)
                ):
                    text = " ".join(value)
                else:
                    continue
                f = self.fields.get(key)
                if f is not None and f.type != ValueType.STRING:
                    continue
                locale = (
                    (f.locale or self.default_locale)
                    if f is not None
                    else self.default_locale
                )
                if locale != "en" or text in seen:
                    continue
                seen.add(text)
                if native.en_safe(text):
                    texts.append(text)
        if not texts:
            return {}
        return dict(zip(texts, native.index_docs_en(texts)))

    def process_document(
        self,
        doc_id: int,
        doc: Dict[str, Any],
        embedding_override: Optional[Any] = None,
        prepared_terms: Optional[Dict[str, Tuple[Dict[str, tuple], int]]] = None,
    ) -> Tuple[List[Any], List[EmbeddingRequest]]:
        """Returns (index ops, embedding requests). The caller sends the
        CreateField/InsertDocument ops first, then these, then queues the
        embedding requests.

        ``embedding_override`` is a selectEmbeddingProperties hook result
        (list of property names, or the string to embed directly) — it takes
        precedence over the field's configured sources
        (reference: fields.rs:410-485 hook input assembly)."""
        flat = flatten_document(doc)
        ops: List[Any] = []
        string_values: List[str] = []

        for key, value in flat.items():
            if key == "id":
                # "id" is stored but not indexed as a search field (reference
                # forces a string id; lookups go through DocIdStorage)
                continue
            vtype = infer_value_type(value)
            if vtype is None:
                continue
            f = self.fields.get(key)
            if f is None:
                base = {
                    ValueType.ARRAY_STRING: ValueType.STRING,
                    ValueType.ARRAY_NUMBER: ValueType.NUMBER,
                    ValueType.ARRAY_BOOL: ValueType.BOOL,
                }.get(vtype, vtype)
                f = self._register_field(key, base)
            ops.extend(self._index_ops_for(f, doc_id, value, prepared_terms))
            if isinstance(value, str):
                string_values.append(value)
            elif isinstance(value, list) and all(isinstance(x, str) for x in value):
                string_values.extend(value)

        emb_reqs: List[EmbeddingRequest] = []
        for f in self.fields.values():
            if f.type != ValueType.EMBEDDING or not f.model:
                continue
            def _src_text(v: Any) -> str:
                # list-valued fields join with spaces like the auto path;
                # str() would embed the Python repr ("['red', 'blue']")
                if isinstance(v, list):
                    return " ".join(_src_text(x) for x in v)
                return v if isinstance(v, str) else str(v)

            if isinstance(embedding_override, str):
                parts = [embedding_override]
            elif isinstance(embedding_override, (list, tuple)):
                parts = [
                    _src_text(flat[src])
                    for src in embedding_override
                    if src in flat
                ]
            elif f.embedding_sources:
                parts = [
                    _src_text(flat[src])
                    for src in f.embedding_sources
                    if src in flat
                ]
            else:
                parts = string_values
            text = " ".join(p for p in parts if p).strip()
            if text:
                # Long inputs chunk into multiple vectors per document (the
                # reference's acknowledged TODO, fields.rs:458-462); the
                # vector index stores/sums multi-vector docs natively.
                from ..models.registry import model_info
                from ..nlp import Chunker, approx_token_count

                budget = model_info(f.model).max_input_tokens
                # a word of L chars counts max(1, ceil(L/4)) tokens, so
                # token count <= char count: short texts skip the scan
                if len(text) > budget and approx_token_count(text) > budget:
                    chunks = Chunker(max_tokens=budget).chunk_text(text)
                    if len(chunks) > MAX_EMBEDDING_CHUNKS:
                        # keep the head AND the tail chunk: truncating to a
                        # pure prefix silently loses end-of-document content
                        chunks = (
                            chunks[: MAX_EMBEDDING_CHUNKS - 1] + chunks[-1:]
                        )
                else:
                    chunks = [text]
                for chunk in chunks:
                    emb_reqs.append(
                        EmbeddingRequest(self.id, doc_id, f.field_id, f.model, chunk)
                    )
        return ops, emb_reqs

    def _index_ops_for(
        self,
        f: TypedField,
        doc_id: int,
        value: Any,
        prepared_terms: Optional[Dict[str, Tuple[Dict[str, tuple], int]]] = None,
    ) -> List[Any]:
        if f.type == ValueType.STRING:
            texts = value if isinstance(value, list) else [value]
            text = " ".join(str(t) for t in texts)
            # exact values ride along for keyword filters / term facets
            # (length-guarded in the keyword index; see keyword_index.py)
            keyword_ops = [
                IndexKeywordOp(
                    self.id, doc_id, f.field_id,
                    values=tuple(str(t) for t in texts),
                )
            ]
            locale = f.locale or self.default_locale
            if locale == "en":
                from .. import native

                hit = (
                    prepared_terms.get(text)
                    if prepared_terms is not None
                    else None
                )
                if hit is not None:
                    # precomputed by the batch pre-pass (one native call
                    # per write batch)
                    terms_t, field_len = hit
                    return keyword_ops + [
                        IndexStringOp(
                            self.id, doc_id, f.field_id,
                            field_length=min(field_len, 65_534),
                            terms=terms_t,
                        )
                    ]
                if native.available() and native.en_safe(text):
                    # one native call: tokenize+stem+group per unique term
                    terms_t, field_len = native.index_doc_en(text)
                    return keyword_ops + [
                        IndexStringOp(
                            self.id, doc_id, f.field_id,
                            field_length=min(field_len, 65_534),
                            terms=terms_t,
                        )
                    ]
            data = get_parser(locale).tokenize_and_stem(text)
            terms: Dict[str, List[int]] = {}
            for position, (original, stemmeds) in enumerate(data):
                terms.setdefault(original, []).append(position)
                for s in stemmeds:
                    terms.setdefault(s, []).append(position)
            return keyword_ops + [
                IndexStringOp(
                    self.id,
                    doc_id,
                    f.field_id,
                    field_length=min(len(data), 65_534),
                    terms={t: tuple(p) for t, p in terms.items()},
                )
            ]
        if f.type == ValueType.NUMBER:
            vals = value if isinstance(value, list) else [value]
            # type-mismatched values are IGNORED, not errors: a later doc
            # carrying a string where the schema inferred a number must not
            # abort the write batch (reference fields.rs:183-189
            # Number::try_from(v).ok(); bools are ints in Python, exclude)
            return [
                IndexNumberOp(self.id, doc_id, f.field_id, float(v))
                for v in vals
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            ]
        if f.type == ValueType.BOOL:
            vals = value if isinstance(value, list) else [value]
            # same ignore-on-mismatch contract (reference fields.rs:236-243)
            return [
                IndexBoolOp(self.id, doc_id, f.field_id, v)
                for v in vals
                if isinstance(v, bool)
            ]
        return []

    # -- dump / load (reference: CollectionDump::V1) --------------------------

    def dump(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "id": self.id,
            "description": self.description,
            "read_api_key": self.read_api_key,
            "write_api_key": self.write_api_key,
            "default_locale": self.default_locale,
            "embedding_model": self.embedding_model,
            "fields": [dataclasses.asdict(f) for f in self.fields.values()],
            "next_field_id": self._next_field_id,
            "doc_id_by_user_id": self.doc_id_by_user_id,
            "next_doc_id": self.next_doc_id,
            "document_count": self.document_count,
        }

    @staticmethod
    def from_dump(data: Dict[str, Any]) -> "CollectionWriter":
        w = CollectionWriter.__new__(CollectionWriter)
        w.id = data["id"]
        w.description = data.get("description")
        w.read_api_key = data["read_api_key"]
        w.write_api_key = data["write_api_key"]
        w.default_locale = data.get("default_locale", "en")
        w.embedding_model = data.get("embedding_model")
        w._lock = threading.RLock()
        w.fields = {}
        for fdata in data["fields"]:
            fdata = dict(fdata)
            fdata["type"] = ValueType(fdata["type"])
            if fdata.get("embedding_sources") is not None:
                fdata["embedding_sources"] = tuple(fdata["embedding_sources"])
            f = TypedField(**fdata)
            w.fields[f.name] = f
        w._next_field_id = data["next_field_id"]
        w.doc_id_by_user_id = dict(data["doc_id_by_user_id"])
        w.next_doc_id = data["next_doc_id"]
        w.document_count = data["document_count"]
        w._pending_field_ops = []
        return w
