"""Port of ``orama_core_tpu/engine/__init__.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``."""

from .collection_read import CollectionReader
from .collection_write import CollectionWriter, flatten_document
from .document_storage import DocumentStorage
from .read_side import ReadSide
from .write_side import WriteSide

__all__ = [
    "CollectionReader",
    "CollectionWriter",
    "flatten_document",
    "DocumentStorage",
    "ReadSide",
    "WriteSide",
]
