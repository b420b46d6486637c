"""Stemmers for the reference locales NLTK has no Snowball port for:
Turkish, Greek, Tamil (reference: rust-stemmers Algorithm::Turkish /
::Greek / ::Tamil, nlp/mod.rs:50,101,104).

- Turkish: a from-scratch implementation following the published Snowball
  Turkish algorithm's structure (Çilden 2007): nominal-verb then noun
  suffix classes stripped longest-match-first with vowel-harmony and
  buffer-consonant checks, the -ki chain, and final-consonant devoicing
  restoration. No official-vector oracle exists in this zero-egress image,
  so exact Snowball parity is NOT claimed — behavior is locked by the
  hand-derived vectors in tests/test_stemmers.py instead.
- Greek: full Ntais-structure stemmer (22 sequential rules with
  re-append exception sets and vowel conditions — the algorithm behind
  rust-stemmers Algorithm::Greek); see the section comment for claimed
  fidelity and the two documented conflation-motivated deviations.
- Tamil: Snowball-Tamil step structure (plural -> question/command ->
  -um -> common endings -> case markers -> tense suffixes, each a
  longest-match replace that usually closes the stem with a virama),
  looped tense removal; exception tables reconstructed, behavior locked
  by tests/test_stemmers.py vectors.

Port of ``orama_core_tpu/nlp/stemmer_extra.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

from functools import lru_cache

# ---------------------------------------------------------------- Turkish

_TR_VOWELS = "aeıioöuü"
_TR_BACK = "aıou"
# voiceless consonants trigger the D->t / C->ç allomorphs ("fıstıkçı şahap")
_TR_VOICELESS = "fstkçşhp"

_TR_U_FOR = {"a": "ı", "ı": "ı", "o": "u", "u": "u",
             "e": "i", "i": "i", "ö": "ü", "ü": "ü"}


def _tr_last_vowel(w: str) -> str:
    for ch in reversed(w):
        if ch in _TR_VOWELS:
            return ch
    return ""


def _tr_harmonic(stem: str, suffix: str) -> bool:
    """Progressive vowel harmony: the first suffix vowel must agree with
    the last stem vowel (A-type: a/e by backness; U-type: ı/i/u/ü by
    backness+rounding)."""
    sv = _tr_last_vowel(stem)
    if not sv:
        return True
    for ch in suffix:
        if ch in "ae":
            return (ch == "a") == (sv in _TR_BACK)
        if ch in "ıiuü":
            return _TR_U_FOR[sv] == ch
        if ch in _TR_VOWELS:
            return True
    return True


def _tr_expand(template: str) -> list[str]:
    """Expand a Snowball-style suffix template (A = a/e, U = ı/i/u/ü,
    D = d/t, C = c/ç) into concrete surface forms."""
    forms = [""]
    for ch in template:
        if ch == "A":
            alts = "ae"
        elif ch == "U":
            alts = "ıiuü"
        elif ch == "D":
            alts = "dt"
        elif ch == "C":
            alts = "cç"
        else:
            alts = ch
        forms = [f + a for f in forms for a in alts]
    return forms


def _tr_class(templates: list[str]) -> list[tuple[str, str]]:
    """Concrete (suffix, attach-constraint) pairs for a class, longest
    first. Templates with a leading (y)/(n)/(s)/(U) optional segment
    contribute both variants; constraints encode Turkish morphotactics:
    a buffer-consonant variant attaches only after a vowel, a vowel-
    initial form only after a consonant ("öğretmen-im" vs "araba-yım")."""
    out: dict[str, str] = {}
    def add(form: str, constraint: str) -> None:
        prev = out.get(form)
        # keep the laxer constraint if two templates collide
        out[form] = "" if prev == "" else (prev or constraint)

    for t in templates:
        if t.startswith("+"):
            # "+(y)Uz": buffered variant only — the bare form collides
            # with too many roots ("den-iz", "dom-uz", "yıld-ız")
            close = t.index(")")
            for f in _tr_expand(t[2:close] + t[close + 1:]):
                add(f, "after_vowel")
        elif t.startswith("("):
            close = t.index(")")
            opt, rest = t[1:close], t[close + 1:]
            for f in _tr_expand(opt + rest):
                # y/n/s buffer consonants join two vowels; a buffer vowel
                # (U) joins two consonants
                add(f, "after_cons" if opt in ("U", "A") else "after_vowel")
            for f in _tr_expand(rest):
                # the bare variant's context: after a consonant for y/s
                # templates ("güzel-se" vs "hasta-ysa") and U templates'
                # vowel-initial forms; anywhere for n templates ("araba-da"
                # AND "ev-de" — the n variant marks a preceding possessive)
                if opt == "n":
                    add(f, "after_cons" if f[0] in _TR_VOWELS else "")
                elif opt in ("U", "A"):
                    add(f, "after_vowel")
                else:
                    add(f, "after_cons")
        else:
            for f in _tr_expand(t):
                add(f, "after_cons" if f[0] in _TR_VOWELS else "")
    return sorted(out.items(), key=lambda kv: len(kv[0]), reverse=True)


# Nominal verb suffixes (predicate endings on nouns). No lAr here — the
# plural pass covers it; keeping it in this always-first class cascades
# ("arabalar" -> strip lar -> a case pass then eats the root's final a).
_TR_NOMINAL_VERB = _tr_class([
    "cAsInA", "sUnUz", "(y)mUş", "(y)DU", "(y)sA", "(y)ken",
    "+(y)Uz", "(y)Um", "sUn", "mU", "DUr",
])

# Noun suffix classes stripped as ordered single passes (case, then
# possessive, then plural), mirroring Turkish morphotactics
# root(+lAr)(+poss)(+case); a looped strip over one flat class cascades
# through single-letter suffixes and eats stems ("öğretmen" -> "öğret").
_TR_CASE = _tr_class([
    "(n)DAn", "(n)DA", "(n)Un", "(y)lA", "(y)A", "(n)A",
    "(y)U", "(n)U", "(n)CA",
])
# 1sg/2sg keep only the post-consonantal Um/Un forms: the bare post-
# vocalic single letters ("araba-m") strip real root letters far more
# often than they strip suffixes ("öğretmen" -> "öğretme")
_TR_POSS = _tr_class([
    "lArI", "(U)mUz", "(U)nUz", "(s)U", "Um", "Un",
])
_TR_PLURAL = _tr_class(["lAr"])
_TR_KI = _tr_class(["ki", "kü"])


def _tr_strip_one(word: str, suffixes: list[tuple[str, str]]) -> str | None:
    """Strip the longest applicable suffix, or None. Applicability:
    harmony holds (-ki/-kü exempt), the stem keeps >= 2 chars and a
    vowel, the attach constraint matches the stem-final letter, and D/C
    allomorphs agree with the voicing of the preceding consonant."""
    for suf, constraint in suffixes:
        if not word.endswith(suf) or len(word) - len(suf) < 2:
            continue
        # a 2-char stem may only shed short suffixes or the plural
        # ("ev-de", "ev-ler" yes; "de-niz" no — long suffixes on tiny
        # stems are nearly always misparsed roots)
        if (len(word) - len(suf) < 3 and len(suf) > 2
                and suf not in ("lar", "ler")):
            continue
        stem = word[: -len(suf)]
        if _tr_last_vowel(stem) == "":
            continue
        # -ki/-kü and -(y)ken are harmony-invariable
        if suf not in ("ki", "kü", "ken", "yken") and not _tr_harmonic(stem, suf):
            continue
        if constraint == "after_vowel" and stem[-1] not in _TR_VOWELS:
            continue
        if constraint == "after_cons" and stem[-1] in _TR_VOWELS:
            continue
        if suf[0] in "dt":
            want = "t" if stem[-1] in _TR_VOICELESS else "d"
            if suf[0] != want:
                continue
        if suf[0] in "cç":
            want = "ç" if stem[-1] in _TR_VOICELESS else "c"
            if suf[0] != want:
                continue
        return stem
    return None


@lru_cache(maxsize=65536)
def turkish_stem(word: str) -> str:
    w = word.lower()
    if len(w) < 3 or _tr_last_vowel(w) == "":
        return w
    # one nominal-verb suffix, then the noun chain root(+lAr)(+poss)(+case)
    # stripped back-to-front as ordered single passes; -ki re-opens the
    # chain ("sokaktaki" -> "sokakta" -> "sokak")
    s = _tr_strip_one(w, _TR_NOMINAL_VERB)
    if s is not None:
        w = s

    def noun_chain(w: str) -> str:
        s = _tr_strip_one(w, _TR_CASE)
        skip_poss = False
        if s is not None and len(w) - len(s) == 1 and w[-1] in _TR_VOWELS:
            # bare-vowel accusative ("ev-i") is ambiguous with a longer
            # possessive ("kedi-si"): prefer the longer morpheme
            p = _tr_strip_one(w, _TR_POSS)
            if p is not None and len(p) < len(s):
                s, skip_poss = p, True
        if s is not None:
            # a buffer-y case variant ("kapı-yı") attaches to a bare
            # vowel-final root — a possessive before it would have selected
            # the pronominal-n variant ("kapı-sı-nı") — so don't let the
            # possessive pass eat the root's final vowel
            skip_poss = skip_poss or w[len(s):][0] == "y"
            w = s
        if not skip_poss:
            p = _tr_strip_one(w, _TR_POSS)
            if p is not None:
                w = p
        p = _tr_strip_one(w, _TR_PLURAL)
        if p is not None:
            w = p
        # one final case attempt so plural-stripped words land on the same
        # stem as their unsuffixed form ("öğrenciler"->"öğrenci"->"öğrenç"
        # must agree with "öğrenci"->"öğrenç")
        p = _tr_strip_one(w, _TR_CASE)
        if p is not None:
            w = p
        return w

    # -ki first (it closes the chain: "evde+ki"), min stem 3 so lexical
    # -ki words ("eski", "iki") survive; then the chain on what remains
    s = _tr_strip_one(w, _TR_KI)
    if s is not None and len(s) >= 3:
        w = s
    w = noun_chain(w)
    # restore final devoicing exposed by stripping: kitab- -> kitap
    if w and w[-1] in "bcdğ":
        w = w[:-1] + {"b": "p", "c": "ç", "d": "t", "ğ": "k"}[w[-1]]
    return w


# ----------------------------------------------------------------- Greek

# Full Ntais-structure stemmer (Ntais 2006, "Development of a Greek
# stemmer" — the algorithm behind rust-stemmers Algorithm::Greek and
# Lucene's GreekStemmer): 22 sequential rules, each a longest-match
# suffix strip with a per-rule re-append condition (a set of stems that
# RETAIN part of the suffix, preventing overstemming of specific
# lexemes), ending with the big inflectional-suffix list and the
# comparative endings. Operates on lowercase, tonos-folded text with
# final sigma normalized to σ (equivalent to the paper's uppercase
# form). No Snowball oracle exists in this zero-egress image, so
# byte-exact parity with rust-stemmers is NOT claimed: the rule
# structure, suffix inventories, and vowel conditions follow the
# published algorithm; the re-append exception tables are reconstructed
# and behavior is locked by tests/test_stemmers.py vectors.

_EL_V = "αεηιουω"      # vowels
_EL_V2 = "αεηιοω"      # vowels minus υ (the -ανε re-append condition)


def _el_ends(w: str, *sufs: str):
    """Longest-first endswith over a suffix group; returns the suffix."""
    for s in sorted(sufs, key=len, reverse=True):
        if w.endswith(s):
            return s
    return None


# rule 0: irregular nouns whose oblique stem grows a consonant
# (κρέας/κρέατος, φως/φωτός, ...) and the -γι- family
_EL_STEP0 = {}
for _stems, _sufs in (
    (("φαγ", "σκαγ", "ολογ", "σογ", "τατογ"), ("ια", "ιου", "ιων")),
    (("κρε", "περ", "τερ"), ("ασ", "ατοσ", "ατα", "ατων")),
    (("φω",), ("σ", "τοσ", "τα", "των")),
    (("καθεστ", "γεγον"), ("ωσ", "οτοσ", "οτα", "οτων")),
):
    for _st in _stems:
        for _su in _sufs:
            _EL_STEP0[_st + _su] = _st
_EL_STEP0["καθεστωτοσ"] = "καθεστ"
_EL_STEP0["καθεστωτα"] = "καθεστ"
_EL_STEP0["καθεστωτων"] = "καθεστ"

# per-rule re-append exception sets (stems keeping part of the suffix)
_EL_EXC_AD = ("οκ", "μαμ", "μαν", "μπαμπ", "πατερ", "γιαγι", "νταντ",
              "κυρ", "θει", "πεθερ")
_EL_EXC_ED = ("οπ", "ιπ", "εμπ", "υπ", "γηπ", "δαπ", "κρασπ", "μιλ")
_EL_EXC_OUD = ("αρκ", "καλιακ", "πεταλ", "λιχ", "πλεξ", "σκ", "σ", "φλ",
               "φρ", "βελ", "λουλ", "χν", "σπ", "τραγ", "φε")
_EL_EXC_E = ("θ", "δ", "ελ", "γαλ", "ν", "π", "ιδ", "παρ")
_EL_EXC_IK = ("αλ", "αδ", "ενδ", "αμαν", "αμμοχαλ", "ηθ", "ανηθ",
              "αντιδ", "φυσ", "βρωμ", "γερ", "εξωδ", "καλπ", "καλλιν",
              "καταδ", "μουλ", "μπαν", "μπαγιατ", "μπολ", "μποσ", "νιτ",
              "ξικ", "συνομηλ", "πετσ", "πιτσ", "πικαντ", "πλιατσ",
              "ποστελν", "πρωτοδ", "σερτ", "συναδ", "τσαμ", "υποδ",
              "φιλον", "φυλοδ", "χασ")
_EL_EXC_AM = ("αναπ", "αποθ", "αποκ", "αποστ", "βουβ", "ξεθ", "ουλ",
              "πεθ", "πικρ", "ποτ", "σιχ", "χ")
_EL_EXC_AN = ("βετερ", "βουλκ", "βραχμ", "γ", "δραδουμ", "θ", "καλπουζ",
              "καστελ", "κορμορ", "λαοπλ", "μωαμεθ", "μ", "μουσουλμ",
              "ν", "ουλ", "π", "πελεκ", "πλ", "πολισ", "πορτολ",
              "σαρακατσ", "σουλτ", "τσαρλατ", "ορφ", "τσιγγ", "τσοπ",
              "φωτοστεφ", "χ", "ψυχοπλ", "αγ", "γαλ", "γερ", "δεκ",
              "διπλ", "αμερικαν", "ουρ", "πιθ", "πουριτ", "σ", "ζωντ",
              "ικ", "καστ", "κοπ", "λιχ", "λουθηρ", "μαιντ", "μελ",
              "σιγ", "σπ", "στεγ", "τραγ", "τσαγ", "φ", "ερ", "αδαπ",
              "αθιγγ", "αμηχ", "ανικ", "ανοργ", "απηγ", "απιθ",
              "ατσιγγ", "βασ", "βασκ", "βαθυγαλ", "βιομηχ", "βραχυκ",
              "διατ", "διαφ", "ενοργ", "θυσ", "καπνοβιομηχ", "καταγαλ",
              "κλιβ", "κοιλαρφ", "λιβ", "μεγλοβιομηχ", "μικροβιομηχ",
              "νταβ", "ξηροκλιβ", "ολιγοδαμ", "ολογαλ", "πενταρφ",
              "περηφ", "περιτρ", "πλατ", "πολυδαπ", "πολυμηχ", "στεφ",
              "ταβ", "τετ", "υπερηφ", "υποκοπ", "χαμηλοδαπ", "ψηλοταβ")
_EL_EXC_ET = ("οδ", "αιρ", "φορ", "ταθ", "διαθ", "σχ", "ενδ", "ευρ",
              "τιθ", "υπερθ", "ραθ", "ενθ", "ροθ", "σθ", "πυρ", "αιν",
              "συνδ", "συνθ", "χωρ", "πον", "βρ", "καθ", "ευθ", "εκθ",
              "νετ", "ρον", "αρκ", "βαρ", "βολ", "ωφελ")
_EL_EXC_IEST = ("π", "απ", "συμπ", "ασυμπ", "ακαταπ", "αμεταμφ")
_EL_EXC_EST = ("αλ", "αρ", "εκτελ", "ζ", "μ", "ξ", "παρακαλ", "προ",
               "νισ")
_EL_EXC_HK = ("διαθ", "θ", "παρακαταθ", "προσθ", "συνθ")
_EL_EXC_HK_WHOLE = ("σκωλ", "σκουλ", "ναρθ", "σφ", "οθ", "πιθ")
_EL_EXC_OUS = ("φαρμακ", "χαδ", "αγκ", "αναρρ", "βρομ", "εκλιπ",
               "λαμπιδ", "λεχ", "μ", "πατ", "ρ", "λ", "μεδ", "μεσαζ",
               "υποτειν", "αμ", "αιθ", "ανηκ", "δεσποζ", "ενδιαφερ")
_EL_EXC_OUS_END = ("ποδαρ", "βλεπ", "πανταχ", "φρυδ", "μαντιλ", "μαλλ",
                   "κυματ", "λαχ", "ληγ", "φαγ", "ομ", "πρωτ")
_EL_EXC_AG_WHOLE = ("ψοφ", "ναυλοχ")
_EL_EXC_AG_END = ("οφ", "πελ", "χορτ", "λλ", "σφ", "ρπ", "φρ", "πρ",
                  "λοχ", "σμην")
_EL_EXC_HS = ("ν", "χερσον", "δωδεκαν", "ερημον", "μεγαλον", "επταν")
_EL_EXC_HST = ("ασβ", "σβ", "αχρ", "χρ", "απλ", "αειμν", "δυσχρ",
               "ευχρ", "κοινοχρ", "παλιμψ")
_EL_EXC_OUN = ("ν", "ρ", "σπι", "στραβομουτσ", "κακομουτσ", "εξων")
_EL_EXC_OUM = ("παρασουσ", "φ", "χ", "ωριοπλ", "αζ", "αλλοσουσ",
               "ασουσ")

# rule 21: one final inflectional ending (longest match), after the
# -μα family is folded to its bare stem
_EL_FINAL = sorted([
    "α", "αγατε", "αγαν", "αει", "αμαι", "αν", "ασ", "ασαι", "αται",
    "αω", "ε", "ει", "εισ", "ειτε", "εσαι", "εσ", "εται", "ι", "ιεμαι",
    "ιεμαστε", "ιεται", "ιεσαι", "ιεστε", "ιομασταν", "ιομουν",
    "ιομουνα", "ιονταν", "ιοντουσαν", "ιοσασταν", "ιοσαστε", "ιοσουν",
    "ιοσουνα", "ιοταν", "ιουμα", "ιουμαστε", "ιουνται", "ιουνταν", "η",
    "ηδεσ", "ηδων", "ηθει", "ηθεισ", "ηθειτε", "ηθηκατε", "ηθηκαν",
    "ηθουν", "ηθω", "ηκατε", "ηκαν", "ησ", "ησαν", "ησατε", "ησει",
    "ησεσ", "ησουν", "ησω", "ο", "οι", "ομαι", "ομασταν", "ομουν", "ων",
    "ομουνα", "ονται", "ονταν", "οντουσαν", "οσ", "οσασταν", "οσαστε",
    "οσουν", "οσουνα", "οταν", "ου", "ουμαι", "ουμαστε", "ουν",
    "ουνται", "ουνταν", "ουσ", "ουσαν", "ουσατε", "υ", "υσ", "ω", "ωσ",
], key=len, reverse=True)
_EL_COMPARATIVE = ("εστερ", "εστατ", "οτερ", "οτατ", "υτερ", "υτατ",
                   "ωτερ", "ωτατ")


@lru_cache(maxsize=65536)
def greek_stem(word: str) -> str:
    w = word.lower().replace("ς", "σ")
    w = w.translate(str.maketrans("άέήίόύώϊϋΐΰ", "αεηιουωιυιυ"))
    # rule 0 first, before the length guard: the map's short members
    # (φωσ) must land on the same stem as their long forms (φωτα -> φω)
    if w in _EL_STEP0:
        return _EL_STEP0[w]
    if len(w) < 4 or any(c not in "αβγδεζηθικλμνξοπρστυφχψω" for c in w):
        return w

    def ends_in(stem, excs):
        return any(stem.endswith(e) for e in excs)

    # rule 1: -αδεσ/-αδων
    s = _el_ends(w, "αδεσ", "αδων")
    if s and len(w) > len(s):
        w = w[: -len(s)]
        if ends_in(w, _EL_EXC_AD):
            w += "αδ"
        return w
    # rule 2: -εδεσ/-εδων
    s = _el_ends(w, "εδεσ", "εδων")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if ends_in(w, _EL_EXC_ED):
            w += "εδ"
        return w
    # rule 3: -ουδεσ/-ουδων
    s = _el_ends(w, "ουδεσ", "ουδων")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if ends_in(w, _EL_EXC_OUD):
            w += "ουδ"
        return w
    # rule 4: -εωσ/-εων
    s = _el_ends(w, "εωσ", "εων")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if w in _EL_EXC_E or ends_in(w, _EL_EXC_E):
            w += "ε"
        return w
    # rule 5: -ια/-ιου/-ιων (nouns in -ι); -ιο and -ιεσ added so the
    # neuter nominative (βιβλιο) and feminine plural (αξιεσ) land on the
    # same stem as their other inflections — conflation-motivated
    # extension of the paper's set, same keep-ι-after-vowel condition
    s = _el_ends(w, "ια", "ιου", "ιων", "ιο", "ιεσ")
    if s and len(w) - len(s) >= 2:
        stem = w[: -len(s)]
        if stem and stem[-1] in _EL_V:
            return stem + "ι"
        return stem
    # rule 6: -ικα/-ικο/-ικου/-ικων (adjectives in -ικος)
    s = _el_ends(w, "ικα", "ικο", "ικου", "ικων")
    if s and len(w) - len(s) >= 2:
        stem = w[: -len(s)]
        if (stem and stem[-1] in _EL_V) or ends_in(stem, _EL_EXC_IK):
            return stem + "ικ"
        return stem
    # rule 7: -αμε verb group
    if w == "αγαμε":
        return "αγαμ"
    s = _el_ends(w, "ηθηκαμε", "ουσαμε", "ηκαμε", "ησαμε", "αγαμε")
    if s and len(w) - len(s) >= 1:
        return w[: -len(s)]
    s = _el_ends(w, "αμε")
    if s and len(w) - len(s) >= 2:
        w = w[: -len(s)]
        if ends_in(w, _EL_EXC_AM):
            w += "αμ"
        return w
    # rule 8: -ανε verb group
    s = _el_ends(w, "ηθηκανε", "ουσανε", "ιοντανε", "ιοτανε",
                 "ιουντανε", "οντανε", "οτανε", "ουντανε", "αγανε",
                 "ησανε")
    if s and len(w) - len(s) >= 1:
        if w == "αγανε":
            return "αγαν"
        return w[: -len(s)]
    s = _el_ends(w, "ανε")
    if s and len(w) - len(s) >= 2:
        w = w[: -len(s)]
        if (w and w[-1] in _EL_V2) or ends_in(w, _EL_EXC_AN):
            w += "αν"
        return w
    # rule 9: -ετε
    s = _el_ends(w, "ησετε")
    if s and len(w) - len(s) >= 1:
        return w[: -len(s)]
    s = _el_ends(w, "ετε")
    if s and len(w) - len(s) >= 2:
        w = w[: -len(s)]
        if (w and w[-1] in _EL_V) or ends_in(w, _EL_EXC_ET):
            w += "ετ"
        return w
    # rule 10: -οντασ/-ωντασ (participles)
    s = _el_ends(w, "οντασ", "ωντασ")
    if s and len(w) - len(s) >= 1:
        stem = w[: -len(s)]
        if stem == "αρχ":
            return stem + "οντ"
        if stem == "κρε":
            return stem + "ωντ"
        return stem
    # rule 11: -ομαστε/-ιομαστε
    s = _el_ends(w, "ιομαστε", "ομαστε")
    if s and len(w) - len(s) >= 1:
        stem = w[: -len(s)]
        if stem == "ον":
            return stem + "ομαστ"
        return stem
    # rule 12: -ιεστε/-εστε
    s = _el_ends(w, "ιεστε")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if ends_in(w, _EL_EXC_IEST):
            w += "ιεστ"
        return w
    s = _el_ends(w, "εστε")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if ends_in(w, _EL_EXC_EST):
            w += "εστ"
        return w
    # rule 13: -ηθηκα/-ηθηκεσ/-ηθηκε (passive aorist)
    s = _el_ends(w, "ηθηκα", "ηθηκεσ", "ηθηκε")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if w in _EL_EXC_HK_WHOLE or ends_in(w, _EL_EXC_HK):
            w += "ηκ"
        return w
    # rule 14: -ηκα/-ηκεσ/-ηκε
    s = _el_ends(w, "ηκα", "ηκεσ", "ηκε")
    if s and len(w) - len(s) >= 2:
        w = w[: -len(s)]
        if w in _EL_EXC_HK_WHOLE or ends_in(w, _EL_EXC_HK):
            w += "ηκ"
        return w
    # rule 15: -ουσα/-ουσεσ/-ουσε (imperfect)
    s = _el_ends(w, "ουσα", "ουσεσ", "ουσε")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if ((w and w[-1] in _EL_V) or w in _EL_EXC_OUS
                or ends_in(w, _EL_EXC_OUS_END)):
            w += "ουσ"
        return w
    # rule 16: -αγα/-αγεσ/-αγε
    s = _el_ends(w, "αγα", "αγεσ", "αγε")
    if s and len(w) - len(s) >= 2:
        w = w[: -len(s)]
        if ((w in _EL_EXC_AG_WHOLE or ends_in(w, _EL_EXC_AG_END))
                and not w.endswith("κολλ")):
            w += "αγ"
        return w
    # rule 17: -ησε/-ησου/-ησα
    s = _el_ends(w, "ησε", "ησου", "ησα")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if w in _EL_EXC_HS:
            w += "ησ"
        return w
    # rule 18: -ηστε
    s = _el_ends(w, "ηστε")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if w in _EL_EXC_HST or ends_in(w, _EL_EXC_HST):
            w += "ηστ"
        return w
    # rule 19: -ουνε/-ησουνε/-ηθουνε
    s = _el_ends(w, "ησουνε", "ηθουνε", "ουνε")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if w in _EL_EXC_OUN:
            w += "ουν"
        return w
    # rule 20: -ουμε/-ησουμε/-ηθουμε
    s = _el_ends(w, "ησουμε", "ηθουμε", "ουμε")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)]
        if w in _EL_EXC_OUM:
            w += "ουμ"
        return w
    # rule 21: -ματα/-ματων/-ματοσ fold to -μα, then one final ending
    s = _el_ends(w, "ματα", "ματων", "ματοσ")
    if s and len(w) - len(s) >= 1:
        w = w[: -len(s)] + "μα"
    for suf in _EL_FINAL:
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            st = w[: -len(suf)]
            if any(c in _EL_V for c in st):
                w = st
            break
    # rule 22: comparative/superlative endings
    for suf in _EL_COMPARATIVE:
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            w = w[: -len(suf)]
            break
    # conflation fix (deliberate deviation from the paper, documented):
    # rule 6 strips -ικ- from ΕΛΛΗΝΙΚΑ (-> ελλην) but the final-ending
    # path leaves ΕΛΛΗΝΙΚΟΣ at ελληνικ — the same lexeme lands on two
    # stems. Apply rule 6's own keep/strip condition to a trailing -ικ
    # here so both inflections conflate (exceptions keep their ικ on
    # both paths: φυσικα/φυσικοσ -> φυσικ).
    if w.endswith("ικ") and len(w) >= 5:
        cand = w[:-2]
        if not ((cand and cand[-1] in _EL_V) or ends_in(cand, _EL_EXC_IK)):
            w = cand
    return w


# ----------------------------------------------------------------- Tamil

# Snowball-Tamil structure (Damodharan's algorithm, the one behind
# rust-stemmers Algorithm::Tamil): ordered steps — plural, question
# clitics, command forms, -um clitic, common word endings, vetrumai
# urupukal (case markers), then a looped tense-suffix pass. Each rule is
# a longest-match suffix REPLACE: most close the stem-final consonant
# with a virama (்) rather than bare-stripping, which is what keeps the
# stem a legal Tamil syllable. Exception/suffix tables reconstructed
# from the published algorithm (no oracle in-image); behavior locked by
# tests/test_stemmers.py.

_VIRAMA = "்"  # ்


def _ta_rules(pairs):
    return sorted(pairs, key=lambda kv: len(kv[0]), reverse=True)


_TA_PLURAL = _ta_rules([
    ("ுங்கள்", _VIRAMA),   # -ungal -> ்
    ("ங்கள்", "ம்"),  # -ngal: -am nouns nasal-assimilate
    #   (புத்தகம் -> புத்தகங்கள்) — restore the
    #   nominative so singular and plural share a stem
    ("ற்கள்", "ல்"),  # -rkal -> l்
    ("ட்கள்", "ள்"),  # -tkal -> ள்
    ("கள்", ""),                          # -kal
])
_TA_QUESTION = _ta_rules([
    ("ோ", _VIRAMA), ("ே", _VIRAMA), ("ா", _VIRAMA),
])
_TA_COMMAND = _ta_rules([
    ("பி", ""), ("வி", ""),          # -pi, -vi
])
_TA_UM = _ta_rules([
    ("ும்", _VIRAMA),                     # -um -> ்
])
_TA_COMMON = _ta_rules([
    ("ுடன்", _VIRAMA),               # -udan
    ("ிலிருந்து", _VIRAMA),
    ("விடம்", _VIRAMA),         # -vidam
    ("ாகிய", _VIRAMA),               # -aakiya
    ("ாகி", _VIRAMA),                     # -aaki
    ("ென்று", _VIRAMA),         # -endru
    ("ுக்காக", _VIRAMA),   # -ukkaaka
    ("ுக்கு", _VIRAMA),         # -ukku (dative)
    ("ின்றி", _VIRAMA),         # -indri
    ("ால்", _VIRAMA),                     # -aal (instr.)
    ("ுடைய", _VIRAMA),               # -udaiya
])
_TA_OBLIQUE = []
# regular oblique-stem alternations, restored so case-marked forms land
# on the nominative stem: -am nouns (மரம் -> மரத்த-) and
# geminating -u nouns (வீடு -> வீட்ட-, ஆறு -> ஆற்ற-)
for _case in ("ில்", "ின்", "ை", "ால்", "ிற்கு",
              "ுக்கு", "ோடு", "ுடன்"):
    _TA_OBLIQUE += [
        ("த்த" + _case, "ம்"),
        ("ட்ட" + _case, "டு"),
        ("ற்ற" + _case, "று"),
    ]
_TA_CASE = _ta_rules(_TA_OBLIQUE + [
    ("ினின்று", _VIRAMA),  # -inindru
    ("ின்", _VIRAMA),                     # -in (genitive)
    ("ிற்கு", _VIRAMA),         # -irku (dative)
    ("ில்", _VIRAMA),                     # -il (locative)
    ("ொடு", _VIRAMA),                     # -odu (sociative)
    ("ோடு", _VIRAMA),                     # -oodu
    ("ை", _VIRAMA),                                 # -ai (accusative)
])
_TA_TENSE = _ta_rules([
    # present/past participial and finite endings
    ("கின்ற", _VIRAMA),         # -kindra
    ("கிற", _VIRAMA),                     # -kira
    ("கிறான்", _VIRAMA),   # -kiraan
    ("கிறாள்", _VIRAMA),   # -kiraal
    ("கிறார்", _VIRAMA),   # -kiraar
    ("கிறது", _VIRAMA),         # -kirathu
    ("ான்", _VIRAMA),                     # -aan (3sg.m past)
    ("ாள்", _VIRAMA),                     # -aal (3sg.f past)
    ("ார்", _VIRAMA),                     # -aar (3sg.hon)
    ("ார்கள்", _VIRAMA),   # -aarkal
    ("னர்", _VIRAMA),                     # -nar
    ("து", ""),                                # -thu (3sg.n)
    ("ும்", _VIRAMA),                     # future -um
    ("வேண்டும்", _VIRAMA),
    ("படு", ""),                          # passive -padu
    ("ிய", _VIRAMA),                           # adjectival -iya
])

# steps in algorithm order; (rules, min_stem_chars)
# outermost-first: clitics (question particles, -um) attach last, then
# case markers, then plural — so strip in that order (the reverse of
# attachment: மரம்+கள்+ஐ surfaces as மரங்களை)
_TA_STEPS = (
    (_TA_QUESTION, 3), (_TA_UM, 2), (_TA_COMMON, 2), (_TA_CASE, 2),
    (_TA_PLURAL, 2), (_TA_COMMAND, 3),
)


_TA_VOWEL_SIGNS = "ாிீுூெேைொோௌ" + _VIRAMA


def _ta_apply(w: str, rules, min_stem: int):
    for suf, rep in rules:
        # the replacement counts toward the minimum: oblique rules
        # REBUILD the stem (ஆ + று), they don't just strip
        if w.endswith(suf) and len(w) - len(suf) + len(rep) >= min_stem:
            stem = w[: -len(suf)]
            # the closing virama restores a bare-consonant stem; a stem
            # already ending in a dependent vowel (வரு-) or virama
            # needs no closure
            if rep == _VIRAMA and stem and stem[-1] in _TA_VOWEL_SIGNS:
                rep = ""
            return stem + rep, True
    return w, False


@lru_cache(maxsize=65536)
def tamil_stem(word: str) -> str:
    w = word
    if len(w) < 3:
        return w
    for rules, ms in _TA_STEPS:
        w, _ = _ta_apply(w, rules, ms)
    # looped tense removal (agglutinated verb complexes shed one layer
    # per pass), bounded to keep worst-case linear
    for _ in range(3):
        w2, changed = _ta_apply(w, _TA_TENSE, 2)
        if not changed:
            break
        w = w2
    # collapse a doubled virama left by replace-after-consonant
    while w.endswith(_VIRAMA * 2):
        w = w[:-1]
    return w


@lru_cache(maxsize=4)
def get_extra_stemmer(locale: str):
    return {"tr": turkish_stem, "el": greek_stem, "ta": tamil_stem}.get(locale)
