"""Port of ``orama_core_tpu/nlp/__init__.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``."""

from .tokenizer import TextParser, get_parser, fold_diacritics
from .chunker import Chunker, approx_token_count
from .stemmer import porter_stem
from .locales import LOCALES, DEFAULT_LOCALE, normalize_locale

__all__ = [
    "TextParser",
    "get_parser",
    "fold_diacritics",
    "Chunker",
    "approx_token_count",
    "porter_stem",
    "LOCALES",
    "DEFAULT_LOCALE",
    "normalize_locale",
]
