"""Tokenization pipeline: split → lowercase → diacritics fold → stop words →
optional stemming.

Behavioral mirror of the reference's `TextParser`
(`nlp/tokenizer.rs:153-205`, `nlp/mod.rs:120-138`):
- regex split on non-word runs,
- lowercase, diacritics folded to ASCII (the reference uses a Latin-1/Latin
  Extended-A lookup table, tokenizer.rs:178-205; we use Unicode NFKD
  decomposition + combining-mark strip, a superset of that mapping),
- stop-word removal,
- ``tokenize_and_stem`` yields ``(original, [stem])`` with the stem omitted
  when it equals the original — both get indexed at the same position
  (fields.rs:311-353).

Port of ``orama_core_tpu/nlp/tokenizer.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import functools
import unicodedata
from typing import Iterable, List, Tuple

from . import locales as _locales
from .stemmer import get_stemmer
from .stop_words import stop_words


def fold_diacritics(token: str) -> str:
    """Strip accent marks (é -> e, ώ -> ω) but PRESERVE marks that are
    orthography, not accents: Indic dependent vowels and viramas
    (மரம் without its virama is a different word). The reference's
    replace_diacritics only maps Latin 0xC0-0x17F (tokenizer.rs:173-187)
    and so never touches Indic text either — but it also leaves Greek
    tonos in place; folding it here is deliberate (the Greek stemmer
    folds internally anyway, and dictionary prefixes then match
    accentless queries). NFC-recomposed so Indic output stays in the
    composed form the stemmer tables use."""
    decomposed = unicodedata.normalize("NFKD", token)
    kept = "".join(
        c for c in decomposed
        if not unicodedata.combining(c)
        or "ऀ" <= c <= "௿"
        or "ក" <= c <= "៿"  # Khmer: coeng (ccc=9) is orthography too
    )
    return unicodedata.normalize("NFC", kept)


class TextParser:
    def __init__(self, locale: str = "en") -> None:
        self.locale = _locales.normalize_locale(locale)
        self._split = _locales.split_pattern(self.locale)
        self._stop = stop_words(self.locale)
        self._stem = get_stemmer(self.locale)
        self._cjk = _locales.is_cjk(self.locale)

    def _raw_tokens(self, text: str) -> Iterable[str]:
        for tok in self._split.split(text):
            if not tok:
                continue
            if self._cjk:
                yield from _locales.split_cjk(tok)
            else:
                yield tok

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self._raw_tokens(text):
            tok = tok.lower()
            if tok in self._stop:
                continue
            tok = fold_diacritics(tok)
            if tok and tok not in self._stop:
                out.append(tok)
        return out

    def tokenize_and_stem(self, text: str) -> List[Tuple[str, List[str]]]:
        result: List[Tuple[str, List[str]]] = []
        for tok in self.tokenize(text):
            if self._stem is None:
                result.append((tok, []))
                continue
            stemmed = self._stem(tok)
            result.append((tok, [] if stemmed == tok else [stemmed]))
        return result


@functools.lru_cache(maxsize=64)
def get_parser(locale: str = "en") -> TextParser:
    """Per-locale parser cache (reference: NLPService DashMap,
    nlp/mod.rs:157-175)."""
    return TextParser(locale)
