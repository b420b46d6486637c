"""Port of ``orama_core_tpu/index/__init__.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``."""

from .term_dict import TermDict
from .string_index import (
    CommittedStringIndex,
    GlobalInfo,
    UncommittedStringIndex,
)
from .number_index import CommittedNumberIndex, UncommittedNumberIndex
from .keyword_index import CommittedKeywordIndex, UncommittedKeywordIndex
from .bool_index import CommittedBoolIndex, UncommittedBoolIndex
from .vector_index import CommittedVectorIndex, UncommittedVectorIndex

__all__ = [
    "TermDict",
    "CommittedStringIndex",
    "GlobalInfo",
    "UncommittedStringIndex",
    "CommittedNumberIndex",
    "UncommittedNumberIndex",
    "CommittedKeywordIndex",
    "UncommittedKeywordIndex",
    "CommittedBoolIndex",
    "UncommittedBoolIndex",
    "CommittedVectorIndex",
    "UncommittedVectorIndex",
]
