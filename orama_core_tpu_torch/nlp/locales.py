"""Locale registry (reference: `src/nlp/locales.rs`, 34 locales).

Each locale carries a word-split pattern, an optional stemmer and a
stop-word table. Locales without dedicated resources degrade gracefully to
unicode word splitting with no stemming — the same shape as the reference,
where e.g. UK/ZH have no Snowball stemmer (`nlp/mod.rs:100-108`).

Port of ``orama_core_tpu/nlp/locales.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import re
from typing import Optional

# All locales the reference accepts (locales.rs).
LOCALES = (
    "ar", "bg", "da", "de", "el", "en", "es", "et", "fi", "fr", "ga", "hi",
    "hu", "hy", "id", "it", "jp", "ko", "lt", "ne", "nl", "no", "pt", "ro",
    "ru", "sa", "sl", "sr", "sv", "ta", "tr", "uk", "zh", "km",
)

DEFAULT_LOCALE = "en"

# Full-name aliases the reference's FromStr also accepts (locales.rs:124-157)
# — its own docs use them ('"language": "english"' in create-collection.mdx).
LOCALE_ALIASES = {
    "arabic": "ar", "bulgarian": "bg", "danish": "da", "german": "de",
    "greek": "el", "english": "en", "spanish": "es", "estonian": "et",
    "finnish": "fi", "french": "fr", "irish": "ga", "hindi": "hi",
    "hungarian": "hu", "armenian": "hy", "indonesian": "id", "italian": "it",
    "japanese": "jp", "korean": "ko", "lithuanian": "lt", "nepali": "ne",
    "dutch": "nl", "norwegian": "no", "portuguese": "pt", "romanian": "ro",
    "russian": "ru", "sanskrit": "sa", "slovenian": "sl", "serbian": "sr",
    "swedish": "sv", "tamil": "ta", "turkish": "tr", "ukrainian": "uk",
    "chinese": "zh", "khmer": "km",
}

# Word splitting: unicode-aware "non word" split. CJK locales split on any
# non-letter and additionally break each CJK codepoint into its own token.
#
# Combining marks are NOT \w in Python's re, and Indic dependent-vowel
# signs / viramas are combining marks — a bare [^\w]+ split fragments
# every Tamil/Devanagari word at its vowel signs (மரத்தில் ->
# மரத|த|ல). The reference has the same bug in its own per-locale
# classes (locales.rs:233 TA `[^a-z0-9அ-ஹ]+` excludes U+0BBE..
# U+0BCD, splitting words identically; HI/NE likewise) — fixed here
# rather than mirrored, since the Tamil stemmer operates on whole
# words. The Indic script blocks are added wholesale to the word-char
# class (their letters are already \w; this admits the marks).
# Khmer (km — an addition over the reference's 33 locales) is an abugida
# with the same shape: dependent vowels U+17B6-U+17C5 and the coeng
# subscript marker U+17D2 are combining marks, so the block is admitted
# wholesale too or every Khmer word fragments at its vowel signs.
_INDIC_MARKS = "ऀ-ॿ஀-௿ក-៿"
_DEFAULT_SPLIT = re.compile(rf"[^\w{_INDIC_MARKS}]+", re.UNICODE)
_CJK_LOCALES = frozenset({"zh", "jp", "ko"})
_CJK_CHAR = re.compile(
    "([一-鿿㐀-䶿぀-ヿ가-힯])"
)


def normalize_locale(locale: Optional[str]) -> str:
    if not locale:
        return DEFAULT_LOCALE
    low = locale.lower()
    low = LOCALE_ALIASES.get(low, low)
    if low not in LOCALES:
        raise ValueError(f"unsupported locale {locale!r}")
    return low


def split_pattern(locale: str) -> "re.Pattern[str]":
    return _DEFAULT_SPLIT


def is_cjk(locale: str) -> bool:
    return locale in _CJK_LOCALES


def split_cjk(token: str) -> list:
    """Break CJK runs into single-character tokens, keep latin runs whole."""
    parts = [p for p in _CJK_CHAR.split(token) if p]
    return parts
