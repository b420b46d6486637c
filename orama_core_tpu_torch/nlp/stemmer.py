"""English stemming (Porter algorithm).

The reference uses Snowball stemmers via `rust-stemmers` for ~20 locales
(`nlp/mod.rs:60-108`). Porter is the English Snowball ancestor and produces
near-identical stems for the vast majority of the vocabulary; other locales
currently stem to identity (the reference also has stemmer-less locales).
This is a from-scratch implementation of the published Porter (1980)
algorithm.

Port of ``orama_core_tpu/nlp/stemmer.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

from typing import Optional

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences in the stem ([C](VC)^m[V])."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _cvc(word: str) -> bool:
    """Ends consonant-vowel-consonant, final consonant not w, x or y."""
    if len(word) < 3:
        return False
    return (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
        and word[-1] not in "wxy"
    )


def _replace(word: str, suffix: str, repl: str, min_m: int) -> Optional[str]:
    if not word.endswith(suffix):
        return None
    stem = word[: len(word) - len(suffix)]
    if _measure(stem) > min_m:
        return stem + repl
    return word


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        stem = w[:-3]
        if _measure(stem) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        stem = w[:-2]
        if _has_vowel(stem):
            w = stem
            flag_1b = True
    elif w.endswith("ing"):
        stem = w[:-3]
        if _has_vowel(stem):
            w = stem
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    for suffix, repl in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        out = _replace(w, suffix, repl, 0)
        if out is not None:
            w = out
            break

    # Step 3
    for suffix, repl in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        out = _replace(w, suffix, repl, 0)
        if out is not None:
            w = out
            break

    # Step 4
    for suffix in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suffix):
            stem = w[: len(w) - len(suffix)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion"):
            stem = w[:-3]
            if _measure(stem) > 1 and stem and stem[-1] in "st":
                w = stem

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w


# --- light stemmers for major non-English locales ---------------------------
# Suffix-stripping "light" stemmers (the published Savoy-style approach used
# by Lucene's *LightStemmer family): far simpler than full Snowball but
# captures plural/gender/verb endings that matter for recall. Conservative:
# only strip when a reasonable stem length remains.


def _strip_one(word: str, suffixes, min_stem: int) -> str:
    for suf in suffixes:
        if word.endswith(suf) and len(word) - len(suf) >= min_stem:
            return word[: -len(suf)]
    return word


_FR_SUFFIXES = (
    "issements", "issement", "atrices", "atrice", "ateurs", "ateur",
    "trices", "ements", "erions", "assent", "issons", "issez",
    "ement", "euses", "ences", "aient", "erons", "eront", "erais",
    "erait", "antes", "ions", "ites", "ates", "euse", "ence", "ants",
    "ante", "ires", "ient", "eurs", "ant", "ent", "ire", "ons",
    "eur", "ez", "es", "s", "e",
)

_ES_SUFFIXES = (
    "amientos", "imientos", "amiento", "imiento", "aciones", "uciones",
    "adoras", "adores", "ancias", "acion", "ucion", "adora", "ador",
    "ancia", "mente", "antes", "anzas", "istas", "ables", "ibles",
    "anza", "icos", "icas", "ista", "able", "ible", "ante",
    "osos", "osas", "ico", "ica", "oso", "osa", "ados", "idas",
    "idos", "adas", "ado", "ida", "ido", "ada", "ar", "er", "ir",
    "as", "os", "es", "a", "o", "e",
)

_DE_SUFFIXES = (
    "keiten", "heiten", "ungen", "keit", "heit", "ung", "isch",
    "lich", "end", "ern", "em", "en", "er", "es", "e", "s", "n",
)

_IT_SUFFIXES = (
    "azioni", "azione", "amenti", "imenti", "amento", "imento",
    "mente", "atori", "atore", "anze", "anza", "ici", "ica", "ico",
    "iche", "ichi", "abili", "abile", "ibili", "ibile", "oso",
    "osa", "osi", "ose", "are", "ere", "ire", "ato", "ata", "ati",
    "ate", "uto", "uta", "uti", "ute", "ito", "ita", "iti", "ite",
    "i", "e", "a", "o",
)

_PT_SUFFIXES = (
    "amentos", "imentos", "amento", "imento", "adoras", "adores",
    "acoes", "mente", "idade", "istas", "ista", "avel", "ivel",
    "osos", "osas", "icos", "icas", "ados", "idos", "adas", "idas",
    "ado", "ido", "ada", "ida", "oso", "osa", "ico", "ica",
    "ar", "er", "ir", "os", "as", "es", "a", "o", "e", "s",
)


def _light_stemmer(suffixes, min_stem):
    def stem(word: str) -> str:
        if len(word) <= min_stem:
            return word
        return _strip_one(word, suffixes, min_stem)

    return stem


_LIGHT = {
    "fr": _light_stemmer(_FR_SUFFIXES, 3),
    "es": _light_stemmer(_ES_SUFFIXES, 3),
    "de": _light_stemmer(_DE_SUFFIXES, 4),
    "it": _light_stemmer(_IT_SUFFIXES, 3),
    "pt": _light_stemmer(_PT_SUFFIXES, 3),
}


# Snowball algorithms via NLTK's pure-Python implementations — the same
# algorithm family the reference uses through rust-stemmers
# (nlp/mod.rs:35-108). Covers 14 of the reference's 17 stemmer locales;
# EL/TA/TR have no NLTK Snowball port and use stemmer_extra.py (TR: full
# suffix-chain algorithm with vowel harmony; EL/TA: light inflectional).
_SNOWBALL_LANG = {
    "ar": "arabic", "da": "danish", "de": "german", "en": "english",
    "es": "spanish", "fr": "french", "hu": "hungarian", "it": "italian",
    "nl": "dutch", "no": "norwegian", "pt": "portuguese", "ro": "romanian",
    "ru": "russian", "sv": "swedish",
}
_SNOWBALL_CACHE: dict = {}


def _snowball(locale: str):
    fn = _SNOWBALL_CACHE.get(locale)
    if fn is not None:
        return fn if fn is not False else None
    try:
        from nltk.stem.snowball import SnowballStemmer

        st = SnowballStemmer(_SNOWBALL_LANG[locale])
    except Exception:
        _SNOWBALL_CACHE[locale] = False
        return None
    cache: dict = {}

    def stem(word: str) -> str:
        s = cache.get(word)
        if s is None:
            s = st.stem(word)
            cache[word] = s  # vocabulary is Zipfian — memoize hot words
        return s

    _SNOWBALL_CACHE[locale] = stem
    return stem


def get_stemmer(locale: str):
    """Return a stem function for the locale, or None (identity).

    Snowball (NLTK) for the reference's stemmer locales; fallbacks when
    NLTK is unavailable: full Porter for EN, light suffix stemmers for
    FR/ES/DE/IT/PT; identity otherwise (the reference also has
    stemmer-less locales, nlp/mod.rs:37-108)."""
    if locale in _SNOWBALL_LANG:
        sb = _snowball(locale)
        if sb is not None:
            return sb
    if locale == "en":
        return porter_stem
    if locale in ("tr", "el", "ta"):
        from .stemmer_extra import get_extra_stemmer

        return get_extra_stemmer(locale)
    return _LIGHT.get(locale)
