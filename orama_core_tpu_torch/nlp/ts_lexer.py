"""JavaScript/TypeScript lexer for the code parser.

A real scanner (not regex-over-source): strings with escapes, template
literals with nested ``${}`` substitutions, line/block comments kept as
tokens, regex literals disambiguated from division by the preceding
token, numbers (int/float/hex/bin/exp/bigint/separators), identifiers
incl. unicode/$, and multi-char punctuators longest-match. JSX is lexed
at the parser level (the parser re-scans ``<`` in expression position),
so the lexer stays context-free.

Feeds nlp/code_parser.py, the counterpart of the reference's tree-sitter
TSX front end (src/code_parser/mod.rs:86-130).

Port of ``orama_core_tpu/nlp/ts_lexer.py``: host code, copied line for line.
"""

from __future__ import annotations

import dataclasses
from typing import List

IDENT = "ident"
KEYWORD = "keyword"
STRING = "string"
TEMPLATE = "template"
NUMBER = "number"
REGEX = "regex"
COMMENT = "comment"
PUNCT = "punct"

KEYWORDS = frozenset(
    """break case catch class const continue debugger default delete do else
    enum export extends false finally for function if import in instanceof
    let new null return static super switch this throw true try typeof var
    void while with yield async await of as from interface type namespace
    declare abstract implements private protected public readonly satisfies
    keyof infer is asserts get set""".split()
)

# Longest first so scanning can take the first prefix match.
PUNCTUATORS = sorted(
    [
        ">>>=", "...", "===", "!==", "**=", "<<=", ">>=", ">>>", "&&=", "||=",
        "??=", "=>", "==", "!=", "<=", ">=", "&&", "||", "??", "?.", "++",
        "--", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<", ">>",
        "**", "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-",
        "*", "/", "%", "&", "|", "^", "!", "~", "?", ":", "=", ".", "@", "#",
    ],
    key=len,
    reverse=True,
)

# A regex literal (not division) can follow these: any punctuator that
# cannot terminate an expression, or a keyword like `return`/`typeof`.
_REGEX_AFTER_PUNCT = frozenset(
    p for p in PUNCTUATORS if p not in {")", "]", "}", "++", "--"}
)
_REGEX_AFTER_KEYWORD = frozenset(
    "return typeof instanceof in of new delete void throw case do else yield await".split()
)


@dataclasses.dataclass(frozen=True)
class Tok:
    kind: str
    value: str
    start: int
    end: int
    line: int


def _is_ident_start(c: str) -> bool:
    return c.isalpha() or c in "_$" or ord(c) > 127


def _is_ident_part(c: str) -> bool:
    return c.isalnum() or c in "_$" or ord(c) > 127


class LexError(ValueError):
    pass


def lex(src: str) -> List[Tok]:
    toks: List[Tok] = []
    i, n, line = 0, len(src), 1

    def last_significant() -> Tok | None:
        for t in reversed(toks):
            if t.kind != COMMENT:
                return t
        return None

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c.isspace():
            i += 1
            continue

        # comments
        if c == "/" and i + 1 < n:
            if src[i + 1] == "/":
                j = src.find("\n", i)
                j = n if j < 0 else j
                toks.append(Tok(COMMENT, src[i:j], i, j, line))
                i = j
                continue
            if src[i + 1] == "*":
                j = src.find("*/", i + 2)
                j = n if j < 0 else j + 2
                toks.append(Tok(COMMENT, src[i:j], i, j, line))
                line += src.count("\n", i, j)
                i = j
                continue

        # strings
        if c in "'\"":
            j, start_line = i + 1, line
            while j < n and src[j] != c:
                if src[j] == "\\":
                    j += 1
                elif src[j] == "\n":
                    line += 1
                j += 1
            j = min(j + 1, n)
            toks.append(Tok(STRING, src[i:j], i, j, start_line))
            i = j
            continue

        # template literals (with nested ${} — brace-depth tracked)
        if c == "`":
            j, start_line, depth = i + 1, line, 0
            while j < n:
                ch = src[j]
                if ch == "\\":
                    j += 2
                    continue
                if ch == "\n":
                    line += 1
                elif depth == 0 and ch == "`":
                    j += 1
                    break
                elif ch == "$" and j + 1 < n and src[j + 1] == "{":
                    depth += 1
                    j += 1
                elif ch == "}" and depth > 0:
                    depth -= 1
                elif ch == "{" and depth > 0:
                    depth += 1
                j += 1
            toks.append(Tok(TEMPLATE, src[i:j], i, j, start_line))
            i = j
            continue

        # regex literal vs division
        if c == "/":
            prev = last_significant()
            is_regex = (
                prev is None
                or (prev.kind == PUNCT and prev.value in _REGEX_AFTER_PUNCT)
                or (prev.kind == KEYWORD and prev.value in _REGEX_AFTER_KEYWORD)
            )
            if is_regex:
                j, in_class = i + 1, False
                while j < n and (in_class or src[j] != "/"):
                    if src[j] == "\\":
                        j += 1
                    elif src[j] == "[":
                        in_class = True
                    elif src[j] == "]":
                        in_class = False
                    elif src[j] == "\n":
                        break  # unterminated; treat as division after all
                    j += 1
                if j < n and src[j] == "/":
                    j += 1
                    while j < n and _is_ident_part(src[j]):  # flags
                        j += 1
                    toks.append(Tok(REGEX, src[i:j], i, j, line))
                    i = j
                    continue

        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if c == "0" and i + 1 < n and src[i + 1] in "xXoObB":
                j = i + 2
                while j < n and (src[j].isalnum() or src[j] == "_"):
                    j += 1
            else:
                while j < n and (src[j].isdigit() or src[j] in "._"):
                    j += 1
                if j < n and src[j] in "eE":
                    j += 1
                    if j < n and src[j] in "+-":
                        j += 1
                    while j < n and src[j].isdigit():
                        j += 1
            if j < n and src[j] == "n":  # bigint
                j += 1
            toks.append(Tok(NUMBER, src[i:j], i, j, line))
            i = j
            continue

        # identifiers / keywords
        if _is_ident_start(c):
            j = i + 1
            while j < n and _is_ident_part(src[j]):
                j += 1
            word = src[i:j]
            toks.append(
                Tok(KEYWORD if word in KEYWORDS else IDENT, word, i, j, line)
            )
            i = j
            continue

        # punctuators
        for p in PUNCTUATORS:
            if src.startswith(p, i):
                toks.append(Tok(PUNCT, p, i, i + len(p), line))
                i += len(p)
                break
        else:
            i += 1  # unknown byte: skip (robustness over strictness)

    return toks
