"""Carry a committed collection into the port without a disk round trip.

The port keeps the reference's on-disk format, so a data directory
committed by ``orama_core_tpu`` loads here through ``CollectionReader.load``.
This module is the same carry in memory: ``export_arrays`` reads the
committed numpy arrays of a reader of either package (duck-typed, no
import of the reference), in the per-file layout of a commit
(``string-{fid}``, ``keyword-{fid}``, ``number-{fid}``, ``bool-{fid}``,
``vector-{fid}``), and ``reader_from_arrays`` builds a port
``CollectionReader`` from such arrays. A caller can also build the arrays
itself (a benchmark corpus made from a seed) and skip both packages'
write paths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import numpy as np

from ..config import GpuConfig
from ..index import (
    CommittedBoolIndex,
    CommittedKeywordIndex,
    CommittedNumberIndex,
    CommittedStringIndex,
    CommittedVectorIndex,
)
from ..oplog import CreateFieldOp
from ..types import TypedField, ValueType
from .collection_read import CollectionReader


def export_arrays(reader) -> Dict[str, Any]:
    """The committed state of ``reader`` (either package) as keyword
    arguments of ``reader_from_arrays``."""
    arrays: Dict[str, Dict[str, np.ndarray]] = {}
    for tag, table in (("string", reader._string), ("keyword", reader._keyword),
                       ("number", reader._number), ("bool", reader._bool),
                       ("vector", reader._vector)):
        for fid, pair in table.items():
            arrays[f"{tag}-{fid}"] = pair.committed.to_arrays()
    return {
        "collection_id": reader.id,
        "read_api_key": reader.read_api_key,
        "description": reader.description,
        "default_locale": reader.default_locale,
        "fields": [dataclasses.asdict(f) for f in reader.fields.values()],
        "arrays": arrays,
        "alive": np.asarray(reader._alive, np.float32).copy(),
        "doc_count": int(reader.doc_count),
        "max_doc_id": int(reader.max_doc_id),
        "committed_offset": int(reader.committed_offset),
    }


def _typed_field(f) -> TypedField:
    d = dict(f) if isinstance(f, dict) else dataclasses.asdict(f)
    d["type"] = ValueType(getattr(d["type"], "value", d["type"]))
    if d.get("embedding_sources") is not None:
        d["embedding_sources"] = tuple(d["embedding_sources"])
    return TypedField(**d)


_FROM = {
    "string": CommittedStringIndex.from_arrays,
    "keyword": CommittedKeywordIndex.from_arrays,
    "number": CommittedNumberIndex.from_arrays,
    "bool": CommittedBoolIndex.from_arrays,
    "vector": CommittedVectorIndex.from_arrays,
}


def reader_from_arrays(
    collection_id: str,
    read_api_key: str,
    fields: Iterable[Any],
    arrays: Dict[str, Dict[str, np.ndarray]],
    alive: np.ndarray,
    doc_count: int,
    max_doc_id: int,
    gpu_cfg: Optional[GpuConfig] = None,
    description: Optional[str] = None,
    default_locale: str = "en",
    committed_offset: int = 0,
) -> CollectionReader:
    """A port reader serving exactly the given committed arrays (no
    uncommitted window, no tombstones: dead docs are zeros of ``alive``).
    With ``gpu_cfg.mesh_shape`` set it is a mesh reader: its ``warmup``
    builds the per-shard layouts of the same arrays."""
    reader = CollectionReader(
        collection_id, read_api_key, description, gpu_cfg, default_locale
    )
    for f in fields:
        reader._apply_locked(CreateFieldOp(collection_id, _typed_field(f)))
    tables = {
        "string": reader._string, "keyword": reader._keyword,
        "number": reader._number, "bool": reader._bool,
        "vector": reader._vector,
    }
    for key, arr in arrays.items():
        tag, fid = key.rsplit("-", 1)
        tables[tag][int(fid)].committed = _FROM[tag](arr)
    reader.doc_count = int(doc_count)
    reader.max_doc_id = int(max_doc_id)
    reader.committed_offset = int(committed_offset)
    cap = reader.capacity
    reader._alive = np.zeros(cap, np.float32)
    n = min(len(alive), cap)
    reader._alive[:n] = np.asarray(alive, np.float32)[:n]
    return reader
