"""Code-aware parsing for code-search indexing.

Counterpart of the reference's tree-sitter TSX parser
(src/code_parser/mod.rs:22-140 token model, :160-540 extraction): typed
tokens — comments, imports (package + identifiers), function
declarations (name, inner comments, params, JSX elements, categorized
identifiers), global lexical-declaration identifiers, global JSX — with
the same extraction semantics the reference's tree-sitter queries
implement:

- function identifiers come grouped by category in this order:
  variable-declarator bindings/values (excluding call/new subtrees),
  then new-expressions (callee + property keys in args), then
  call-expressions (callee head + property keys in args) — matching
  handle_function_declaration's three chained flat() passes.
- object keys and member-access names count as *property* identifiers
  (collected only where the reference collects property_identifier).
- params cover plain, destructured-shorthand, renamed, default-valued
  and rest bindings (the reference's TODO at mod.rs:283 limits it to
  destructured shorthand; this implements the general case).

No tree-sitter runtime ships in this image, so the front end is our own
lexer (nlp/ts_lexer.py) + a recursive-descent structural parser —
a real token-tree walk, not regex extraction. Python sources get a
genuinely deeper treatment than the reference (which supports only
TS/TSX): stdlib ``ast`` + ``tokenize``. Other languages fall back to a
lexical pass (comments + functions + identifiers).

Port of ``orama_core_tpu/nlp/code_parser.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import List, Optional, Sequence, Tuple

from . import ts_lexer
from .ts_lexer import COMMENT, IDENT, KEYWORD, NUMBER, PUNCT, STRING, TEMPLATE, Tok


class TokenKind(str, enum.Enum):
    COMMENT = "comment"
    IMPORT = "import"
    FUNCTION = "function"
    CLASS = "class"
    GLOBAL_IDENTIFIER = "identifier"
    GLOBAL_JSX = "jsx"


@dataclasses.dataclass(frozen=True)
class JsxElement:
    tag: str
    attribute_keys: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class CodeToken:
    kind: TokenKind
    text: str = ""                         # comment text / identifier name
    name: Optional[str] = None             # function/class/import package
    package: Optional[str] = None          # import source
    identifiers: Tuple[str, ...] = ()      # import names / function ids
    params: Tuple[str, ...] = ()           # function parameter bindings
    comments: Tuple[str, ...] = ()         # comments inside a function
    jsx: Tuple[JsxElement, ...] = ()       # jsx inside a function
    line: int = 0


_STMT_KEYWORDS = frozenset(
    "const let var function import export class return if for while do switch try".split()
)

# '<' opens JSX (not comparison/generic) when the previous significant
# token cannot terminate an expression — same predicate family as the
# lexer's regex disambiguation.
_JSX_AFTER_KEYWORD = frozenset(
    "return default do else yield await typeof in of case".split()
)


def clean_comment(raw: str) -> str:
    """Strip comment markers (reference clean_up_comment)."""
    s = raw.strip()
    if s.startswith("//"):
        return s[2:].strip()
    if s.startswith("/*"):
        s = s[2:]
        if s.endswith("*/"):
            s = s[:-2]
        lines = [ln.strip().lstrip("*").strip() for ln in s.splitlines()]
        return " ".join(ln for ln in lines if ln)
    return s


def _unquote(s: str) -> str:
    if len(s) >= 2 and s[0] in "'\"`" and s[-1] == s[0]:
        return s[1:-1]
    return s


class _Cursor:
    """Token cursor over the lexed stream (comments transparent on peek)."""

    def __init__(self, toks: Sequence[Tok], lo: int = 0, hi: Optional[int] = None):
        self.toks = toks
        self.i = lo
        self.hi = len(toks) if hi is None else hi

    def eof(self) -> bool:
        return self.i >= self.hi

    def raw(self) -> Optional[Tok]:
        return self.toks[self.i] if self.i < self.hi else None

    def peek(self, ahead: int = 0) -> Optional[Tok]:
        j, seen = self.i, 0
        while j < self.hi:
            t = self.toks[j]
            if t.kind != COMMENT:
                if seen == ahead:
                    return t
                seen += 1
            j += 1
        return None

    def advance(self) -> Optional[Tok]:
        t = self.raw()
        self.i += 1
        return t

    def skip_comments(self) -> None:
        while not self.eof() and self.toks[self.i].kind == COMMENT:
            self.i += 1

    def expect_punct(self, v: str) -> bool:
        self.skip_comments()
        t = self.raw()
        if t and t.kind == PUNCT and t.value == v:
            self.i += 1
            return True
        return False

    def skip_balanced(self, open_v: str, close_v: str) -> Tuple[int, int]:
        """Cursor at the opener; consume through the matching closer.
        Returns (inner_lo, inner_hi) token indices."""
        # NOT an assert: under python -O the side effect (consuming the
        # opener) would be stripped and every span would mis-compute
        if not self.expect_punct(open_v):
            raise AssertionError(f"cursor not at {open_v!r}")
        lo = self.i
        depth = 1
        while not self.eof():
            t = self.toks[self.i]
            if t.kind == PUNCT:
                if t.value == open_v:
                    depth += 1
                elif t.value == close_v:
                    depth -= 1
                    if depth == 0:
                        hi = self.i
                        self.i += 1
                        return lo, hi
            self.i += 1
        return lo, self.i


def _match(t: Optional[Tok], kind: str, value: Optional[str] = None) -> bool:
    return t is not None and t.kind == kind and (value is None or t.value == value)


# ---------------------------------------------------------------------------
# TS / TSX structural parser
# ---------------------------------------------------------------------------


class _TsParser:
    def __init__(self, src: str, jsx: bool = True) -> None:
        self.toks = ts_lexer.lex(src)
        self.jsx_enabled = jsx

    # -- program ---------------------------------------------------------

    def parse(self) -> List[CodeToken]:
        out: List[CodeToken] = []
        c = _Cursor(self.toks)
        while not c.eof():
            t = c.raw()
            if t.kind == COMMENT:
                text = clean_comment(t.value)
                if text:
                    out.append(CodeToken(TokenKind.COMMENT, text, line=t.line))
                c.advance()
                continue
            if _match(t, KEYWORD, "import") and not _match(c.peek(1), PUNCT, "("):
                out.append(self._parse_import(c))
                continue
            if _match(t, KEYWORD, "export"):
                c.advance()
                nxt = c.peek()
                if _match(nxt, KEYWORD, "default"):
                    c.advance()
                continue
            if _match(t, KEYWORD, "async") and _match(c.peek(1), KEYWORD, "function"):
                c.advance()
                out.append(self._parse_function(c))
                continue
            if _match(t, KEYWORD, "function"):
                out.append(self._parse_function(c))
                continue
            if t.kind == KEYWORD and t.value in ("const", "let", "var"):
                out.extend(self._parse_global_lexical(c))
                continue
            if _match(t, KEYWORD, "class") or (
                _match(t, KEYWORD, "abstract") and _match(c.peek(1), KEYWORD, "class")
            ):
                out.append(self._parse_class(c))
                continue
            if self.jsx_enabled and _match(t, PUNCT, "<") and self._jsx_start(c, at_stmt_start=True):
                for el in self._parse_jsx_tree(c):
                    out.append(
                        CodeToken(
                            TokenKind.GLOBAL_JSX,
                            text=el.tag,
                            jsx=(el,),
                            line=t.line,
                        )
                    )
                continue
            # any other statement: consume one token (block bodies are
            # entered naturally; only declarations produce tokens)
            if _match(t, PUNCT, "{"):
                c.advance()  # enter blocks rather than skipping them
            else:
                c.advance()
        return out

    # -- imports -----------------------------------------------------------

    def _parse_import(self, c: _Cursor) -> CodeToken:
        start = c.raw()
        c.advance()  # 'import'
        idents: List[str] = []
        package = ""
        while not c.eof():
            t = c.raw()
            if t.kind == STRING:
                package = _unquote(t.value)
                c.advance()
                break
            if _match(t, PUNCT, ";"):
                break
            if t.kind == IDENT:
                idents.append(t.value)
            c.advance()
        c.expect_punct(";")
        return CodeToken(
            TokenKind.IMPORT,
            name=package,
            package=package,
            identifiers=tuple(idents),
            line=start.line,
        )

    # -- functions -----------------------------------------------------------

    def _parse_function(self, c: _Cursor) -> CodeToken:
        start = c.raw()
        c.advance()  # 'function'
        if _match(c.peek(), PUNCT, "*"):
            c.advance()
        name = ""
        if c.peek() is not None and c.peek().kind == IDENT:
            c.skip_comments()
            name = c.advance().value
        if _match(c.peek(), PUNCT, "<"):  # generics
            self._skip_type_brackets(c)
        params: Tuple[str, ...] = ()
        if _match(c.peek(), PUNCT, "("):
            lo, hi = c.skip_balanced("(", ")")
            params = self._parse_params(_Cursor(self.toks, lo, hi))
        # return-type annotation
        if _match(c.peek(), PUNCT, ":"):
            c.advance()
            self._skip_type(c, stop={"{"})
        comments: List[str] = []
        jsx: List[JsxElement] = []
        identifiers: List[str] = []
        if _match(c.peek(), PUNCT, "{"):
            lo, hi = c.skip_balanced("{", "}")
            comments, jsx, identifiers = self._analyze_body(lo, hi)
        return CodeToken(
            TokenKind.FUNCTION,
            name=name,
            params=params,
            comments=tuple(comments),
            jsx=tuple(jsx),
            identifiers=tuple(identifiers),
            line=start.line,
        )

    def _parse_params(self, c: _Cursor) -> Tuple[str, ...]:
        """All binding names of a formal-parameter list: plain, shorthand
        destructured, renamed ({a: b} -> b), defaults, rest, array
        patterns. Reference analog (shorthand-only): mod.rs:275-295."""
        out: List[str] = []

        def pattern(c: _Cursor) -> None:
            c.skip_comments()
            t = c.raw()
            if t is None:
                return
            if _match(t, PUNCT, "..."):
                c.advance()
                pattern(c)
                return
            if t.kind == IDENT:
                out.append(t.value)
                c.advance()
                return
            if _match(t, PUNCT, "{") or _match(t, PUNCT, "["):
                close = "}" if t.value == "{" else "]"
                lo, hi = c.skip_balanced(t.value, close)
                inner = _Cursor(self.toks, lo, hi)
                while not inner.eof():
                    inner.skip_comments()
                    it = inner.raw()
                    if it is None:
                        break
                    if _match(it, PUNCT, "..."):
                        inner.advance()
                        pattern(inner)
                    elif it.kind == IDENT:
                        nxt = inner.peek(1)
                        if _match(nxt, PUNCT, ":"):
                            # renamed binding {key: target} or type annot
                            inner.advance()
                            inner.advance()
                            pattern(inner)
                        else:
                            out.append(it.value)
                            inner.advance()
                    elif _match(it, PUNCT, "{") or _match(it, PUNCT, "["):
                        pattern(inner)
                    elif _match(it, PUNCT, "="):
                        # default value: skip to next top-level comma
                        self._skip_to_comma(inner)
                    else:
                        inner.advance()

        while not c.eof():
            pattern(c)
            c.skip_comments()
            t = c.raw()
            if t is None:
                break
            if _match(t, PUNCT, ":"):
                c.advance()
                self._skip_type(c, stop={",", "="})
                continue
            if _match(t, PUNCT, "="):
                self._skip_to_comma(c)
                continue
            if _match(t, PUNCT, ","):
                c.advance()
                continue
            if _match(t, PUNCT, "?"):
                c.advance()
                continue
            c.advance()
        return tuple(out)

    def _skip_to_comma(self, c: _Cursor) -> None:
        depth = 0
        while not c.eof():
            t = c.raw()
            if t.kind == PUNCT:
                if t.value in "([{":
                    depth += 1
                elif t.value in ")]}":
                    depth -= 1
                elif t.value == "," and depth <= 0:
                    return
            c.advance()

    def _skip_type(self, c: _Cursor, stop: set) -> None:
        """Skip a TS type expression until a stop punct at depth 0."""
        depth = 0
        while not c.eof():
            t = c.raw()
            if t.kind == PUNCT:
                if t.value in ("(", "[", "{", "<"):
                    depth += 1
                elif t.value in (")", "]", "}", ">"):
                    if depth == 0:
                        return
                    depth -= 1
                elif depth == 0 and t.value in stop:
                    return
                elif depth == 0 and t.value in (";", ","):
                    return
            c.advance()

    def _skip_type_brackets(self, c: _Cursor) -> None:
        depth = 0
        while not c.eof():
            t = c.advance()
            if t.kind == PUNCT:
                if t.value == "<":
                    depth += 1
                elif t.value in (">", ">>", ">>>"):
                    depth -= len(t.value)
                    if depth <= 0:
                        return

    # -- function-body analysis ------------------------------------------

    def _analyze_body(self, lo: int, hi: int):
        comments = [
            clean_comment(t.value)
            for t in self.toks[lo:hi]
            if t.kind == COMMENT and clean_comment(t.value)
        ]
        jsx = self._collect_jsx(lo, hi)
        decl_ids = self._collect_declarator_ids(lo, hi)
        new_ids = self._collect_new_expression_ids(lo, hi)
        call_ids = self._collect_call_ids(lo, hi)
        # grouped-by-category order, matching the reference's three
        # chained flat() passes (mod.rs:356-420)
        return comments, jsx, decl_ids + new_ids + call_ids

    def _jsx_start(self, c: _Cursor, at_stmt_start: bool = False) -> bool:
        """'<' in expression position followed by a tag-ish token."""
        nxt = c.peek(1)
        if nxt is None:
            return False
        if not (nxt.kind in (IDENT, KEYWORD) or _match(nxt, PUNCT, ">")):
            return False
        if at_stmt_start:
            return True
        # previous significant token must not end an expression
        j = c.i - 1
        while j >= 0 and self.toks[j].kind == COMMENT:
            j -= 1
        if j < 0:
            return True
        prev = self.toks[j]
        if prev.kind in (IDENT, NUMBER, STRING, TEMPLATE):
            return False
        if prev.kind == KEYWORD:
            return prev.value in _JSX_AFTER_KEYWORD
        if prev.kind == PUNCT:
            return prev.value not in (")", "]", "}", "++", "--", ">")
        return False

    def _collect_jsx(self, lo: int, hi: int) -> List[JsxElement]:
        out: List[JsxElement] = []
        c = _Cursor(self.toks, lo, hi)
        while not c.eof():
            t = c.raw()
            if self.jsx_enabled and _match(t, PUNCT, "<") and self._jsx_start(c):
                out.extend(self._parse_jsx_tree(c))
            else:
                c.advance()
        return out

    def _parse_jsx_tree(self, c: _Cursor) -> List[JsxElement]:
        """Parse one JSX element/fragment; return all opening/self-closing
        elements in document order (reference: flat() stops at
        jsx_opening_element / jsx_self_closing_element)."""
        out: List[JsxElement] = []
        stack = 0  # open (non-self-closing) elements incl. fragments
        c.advance()  # first '<'
        first = True
        while not c.eof():
            # we are positioned right after '<' (opening) on entry/loop
            t = c.raw()
            if first or t is not None:
                el, closed, is_fragment = self._parse_jsx_opening(c)
                if el is not None:
                    out.append(el)
                if is_fragment or not closed:
                    stack += 1
                first = False
            if stack == 0:
                return out
            # children: scan until '<' (nested or closing) at this level
            while not c.eof():
                t = c.raw()
                if _match(t, PUNCT, "{"):
                    blo, bhi = c.skip_balanced("{", "}")
                    # expressions may contain nested JSX trees
                    inner = _Cursor(self.toks, blo, bhi)
                    while not inner.eof():
                        it = inner.raw()
                        if _match(it, PUNCT, "<") and self._jsx_start(inner):
                            out.extend(self._parse_jsx_tree(inner))
                        else:
                            inner.advance()
                    continue
                if _match(t, PUNCT, "<"):
                    if _match(c.peek(1), PUNCT, "/"):
                        # closing tag
                        while not c.eof() and not _match(c.raw(), PUNCT, ">"):
                            c.advance()
                        c.advance()  # '>'
                        stack -= 1
                        if stack == 0:
                            return out
                        continue
                    c.advance()  # '<' of a nested opening element
                    break
                c.advance()
            else:
                return out
        return out

    def _parse_jsx_opening(self, c: _Cursor):
        """Cursor just after '<'. Returns (element|None, self_closed, is_fragment)."""
        t = c.raw()
        if _match(t, PUNCT, ">"):  # fragment <>
            c.advance()
            return None, False, True
        tag = ""
        # tag name: ident(.ident)* — first identifier is the tag
        # (reference: html_tag[0], mod.rs:163-177)
        while not c.eof():
            t = c.raw()
            if t.kind in (IDENT, KEYWORD):
                if not tag:
                    tag = t.value
                c.advance()
                if _match(c.raw(), PUNCT, ".") or _match(c.raw(), PUNCT, ":"):
                    c.advance()
                    continue
                break
            break
        attrs: List[str] = []
        self_closed = False
        while not c.eof():
            t = c.raw()
            if _match(t, PUNCT, ">"):
                c.advance()
                break
            if _match(t, PUNCT, "/") and _match(c.peek(1), PUNCT, ">"):
                c.advance()
                c.advance()
                self_closed = True
                break
            if t.kind in (IDENT, KEYWORD):
                # attribute name (join dashed names)
                name = t.value
                c.advance()
                while _match(c.raw(), PUNCT, "-"):
                    c.advance()
                    nt = c.raw()
                    if nt is not None and nt.kind in (IDENT, KEYWORD, NUMBER):
                        name += "-" + nt.value
                        c.advance()
                    else:
                        break
                attrs.append(name)
                if _match(c.raw(), PUNCT, "="):
                    c.advance()
                    vt = c.raw()
                    if _match(vt, PUNCT, "{"):
                        c.skip_balanced("{", "}")
                    else:
                        c.advance()  # string value
                continue
            if _match(t, PUNCT, "{"):  # spread attributes {...props}
                c.skip_balanced("{", "}")
                continue
            c.advance()
        el = JsxElement(tag, tuple(attrs)) if tag else None
        return el, self_closed, False

    # -- identifier categorization ----------------------------------------

    def _skip_call_or_new_subtree(self, c: _Cursor) -> None:
        """Cursor at `new` or at a callee IDENT whose chain ends in '(':
        consume the whole subtree (callee chain + balanced args)."""
        if _match(c.raw(), KEYWORD, "new"):
            c.advance()
        # member chain
        while not c.eof():
            t = c.raw()
            if t.kind in (IDENT, KEYWORD):
                c.advance()
            elif t.kind == PUNCT and t.value in (".", "?."):
                c.advance()
            else:
                break
        if _match(c.raw(), PUNCT, "<"):
            self._skip_type_brackets(c)  # generic call f<T>(...)
        if _match(c.raw(), PUNCT, "("):
            c.skip_balanced("(", ")")

    def _is_call_head(self, c: _Cursor) -> bool:
        """toks[c.i] is IDENT: does its member chain end with '(' ?"""
        j = c.i
        while j < c.hi:
            t = self.toks[j]
            if t.kind in (IDENT, KEYWORD):
                j += 1
            elif t.kind == PUNCT and t.value in (".", "?."):
                j += 1
            else:
                break
        return j < c.hi and _match(self.toks[j], PUNCT, "(")

    def _collect_declarator_ids(self, lo: int, hi: int) -> List[str]:
        """Identifiers in const/let/var declarators, excluding call/new
        subtrees (reference mod.rs:356-383: flat stops at
        call_expression/new_expression) and property keys."""
        out: List[str] = []
        c = _Cursor(self.toks, lo, hi)
        while not c.eof():
            t = c.raw()
            if t.kind == KEYWORD and t.value in ("const", "let", "var"):
                c.advance()
                self._scan_declarator_list(c, out)
            else:
                c.advance()
        return out

    def _scan_declarator_list(self, c: _Cursor, out: List[str]) -> None:
        """From after const/let/var to end of statement (';' or a new
        statement keyword at depth 0)."""
        depth = 0
        prev: Optional[Tok] = None
        while not c.eof():
            t = c.raw()
            if t.kind == PUNCT:
                if t.value in "([{":
                    depth += 1
                elif t.value in ")]}":
                    if depth == 0:
                        return
                    depth -= 1
                elif t.value == ";" and depth == 0:
                    c.advance()
                    return
            if t.kind == KEYWORD and depth == 0 and t.value in _STMT_KEYWORDS:
                if t.value == "new":
                    pass
                else:
                    return
            if _match(t, KEYWORD, "new"):
                self._skip_call_or_new_subtree(c)
                prev = t
                continue
            if t.kind == IDENT:
                if self._is_call_head(c):
                    self._skip_call_or_new_subtree(c)
                    prev = t
                    continue
                is_property = prev is not None and prev.kind == PUNCT and prev.value in (".", "?.")
                is_key = _match(c.peek(1), PUNCT, ":") and depth > 0
                if not is_property and not is_key:
                    out.append(t.value)
            if t.kind != COMMENT:
                prev = t
            c.advance()

    def _collect_new_expression_ids(self, lo: int, hi: int) -> List[str]:
        """new-expressions: plain identifiers (callee head + arg values) and
        property identifiers (object keys, member names) within the subtree
        (reference mod.rs:385-420)."""
        out: List[str] = []
        c = _Cursor(self.toks, lo, hi)
        while not c.eof():
            t = c.raw()
            if _match(t, KEYWORD, "new"):
                start = c.i
                self._skip_call_or_new_subtree(c)
                out.extend(self._subtree_ids(start + 1, c.i, include_props=True))
            else:
                c.advance()
        return out

    def _collect_call_ids(self, lo: int, hi: int) -> List[str]:
        """call-expressions: callee head identifier + property identifiers
        inside the argument list (reference mod.rs:429-515)."""
        out: List[str] = []
        c = _Cursor(self.toks, lo, hi)
        prev: Optional[Tok] = None
        while not c.eof():
            t = c.raw()
            if _match(t, KEYWORD, "new"):
                # callee of `new` is not a call_expression; skip the chain
                # but DO scan its args for nested calls
                c.advance()
                while not c.eof() and (
                    c.raw().kind in (IDENT, KEYWORD)
                    or _match(c.raw(), PUNCT, ".")
                    or _match(c.raw(), PUNCT, "?.")
                ):
                    c.advance()
                prev = t
                continue
            if t.kind == IDENT and not (
                prev is not None and prev.kind == PUNCT and prev.value in (".", "?.")
            ):
                if self._is_call_head(c):
                    out.append(t.value)
                    # move into the argument list and collect property ids;
                    # nested calls inside args are found by the same loop
                    while not c.eof():
                        tt = c.raw()
                        if _match(tt, PUNCT, "("):
                            blo, bhi = c.skip_balanced("(", ")")
                            out.extend(
                                self._subtree_ids(blo, bhi, include_props=True, plain=False)
                            )
                            out.extend(self._collect_call_ids(blo, bhi))
                            break
                        c.advance()
                    prev = t
                    continue
            if t.kind != COMMENT:
                prev = t
            c.advance()
        return out

    def _subtree_ids(
        self, lo: int, hi: int, include_props: bool = False, plain: bool = True
    ) -> List[str]:
        """Identifiers in a token span. plain: names not after '.' and not
        object keys; include_props: object keys + member names."""
        out: List[str] = []
        prev: Optional[Tok] = None
        j = lo
        while j < hi:
            t = self.toks[j]
            if t.kind == IDENT:
                after_dot = prev is not None and prev.kind == PUNCT and prev.value in (".", "?.")
                is_key = (
                    j + 1 < hi
                    and _match(self.toks[j + 1], PUNCT, ":")
                )
                if (after_dot or is_key) and include_props:
                    out.append(t.value)
                elif not after_dot and not is_key and plain:
                    out.append(t.value)
            if t.kind != COMMENT:
                prev = t
            j += 1
        return out

    # -- global lexical declarations / classes ------------------------------

    def _parse_global_lexical(self, c: _Cursor) -> List[CodeToken]:
        """const/let/var at top level: every plain identifier in the whole
        declaration (incl. call/new callees — reference
        handle_global_variable_declaration collects all identifiers,
        mod.rs:213-231)."""
        start = c.raw()
        c.advance()
        lo = c.i
        depth = 0
        prev: Optional[Tok] = None
        while not c.eof():
            t = c.raw()
            if t.kind == PUNCT:
                if t.value in "([{":
                    depth += 1
                elif t.value in ")]}":
                    if depth == 0:
                        break
                    depth -= 1
                elif t.value == ";" and depth == 0:
                    break
            # ASI: at depth 0, a newline between an expression-terminating
            # token and a non-continuation token ends the declaration
            if (
                depth == 0
                and prev is not None
                and t.line > prev.line
                and (
                    prev.kind in (IDENT, NUMBER, STRING, TEMPLATE)
                    or (prev.kind == PUNCT and prev.value in (")", "]", "}", "++", "--"))
                )
                and not (
                    t.kind == PUNCT
                    and t.value not in ("<", "!", "~")
                )
            ):
                break
            if t.kind != COMMENT:
                prev = t
            c.advance()
        hi = c.i
        c.expect_punct(";")
        ids = self._subtree_ids(lo, hi, include_props=False, plain=True)
        return [
            CodeToken(TokenKind.GLOBAL_IDENTIFIER, text=i, name=i, line=start.line)
            for i in ids
        ]

    def _parse_class(self, c: _Cursor) -> CodeToken:
        """Class declarations (capability beyond the reference, which emits
        nothing for classes): name + method names."""
        start = c.raw()
        if _match(start, KEYWORD, "abstract"):
            c.advance()
        c.advance()  # 'class'
        name = ""
        t = c.peek()
        if t is not None and t.kind == IDENT:
            c.skip_comments()
            name = c.advance().value
        while not c.eof() and not _match(c.raw(), PUNCT, "{"):
            c.advance()
        methods: List[str] = []
        if _match(c.raw(), PUNCT, "{"):
            lo, hi = c.skip_balanced("{", "}")
            depth = 0
            j = lo
            while j < hi:
                t = self.toks[j]
                if t.kind == PUNCT:
                    if t.value in "([{":
                        depth += 1
                    elif t.value in ")]}":
                        depth -= 1
                if (
                    depth == 0
                    and t.kind in (IDENT, KEYWORD)
                    and j + 1 < hi
                    and (
                        _match(self.toks[j + 1], PUNCT, "(")
                        or _match(self.toks[j + 1], PUNCT, "<")
                    )
                    and t.value not in ("if", "for", "while", "switch", "catch", "return")
                ):
                    methods.append(t.value)
                j += 1
        return CodeToken(
            TokenKind.CLASS,
            name=name,
            identifiers=tuple(methods),
            line=start.line,
        )


# ---------------------------------------------------------------------------
# Python (stdlib ast — a real grammar, deeper than the reference's TS-only)
# ---------------------------------------------------------------------------


def _parse_python(source: str) -> List[CodeToken]:
    import ast
    import io
    import tokenize as pytokenize

    out: List[CodeToken] = []
    # comments via tokenize (ast drops them)
    comments_by_line = {}
    try:
        for tok in pytokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == pytokenize.COMMENT:
                comments_by_line[tok.start[0]] = tok.string.lstrip("#").strip()
    except (pytokenize.TokenError, IndentationError):
        pass

    try:
        tree = ast.parse(source)
    except SyntaxError:
        return [
            CodeToken(TokenKind.COMMENT, text, line=ln)
            for ln, text in sorted(comments_by_line.items())
        ]

    def func_token(node) -> CodeToken:
        a = node.args
        params = tuple(
            p.arg
            for p in (a.posonlyargs + a.args + a.kwonlyargs)
            if p.arg not in ("self", "cls")
        ) + tuple(p.arg for p in (a.vararg, a.kwarg) if p is not None)
        span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
        comments = [comments_by_line[ln] for ln in span if ln in comments_by_line]
        doc = ast.get_docstring(node)
        if doc:
            comments.insert(0, doc.strip())
        # categorized identifiers, mirroring the TSX semantics:
        # assignment targets/values, then calls (callee head + kwarg names)
        decl_ids: List[str] = []
        call_ids: List[str] = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            decl_ids.append(n.id)
            elif isinstance(sub, ast.Call):
                head = sub.func
                while isinstance(head, ast.Attribute):
                    head = head.value
                if isinstance(head, ast.Name):
                    call_ids.append(head.id)
                call_ids.extend(kw.arg for kw in sub.keywords if kw.arg)
        return CodeToken(
            TokenKind.FUNCTION,
            name=node.name,
            params=params,
            comments=tuple(comments),
            identifiers=tuple(decl_ids + call_ids),
            line=node.lineno,
        )

    body_lines = set()
    for node in tree.body:
        import ast as _ast

        if isinstance(node, (_ast.Import, _ast.ImportFrom)):
            if isinstance(node, _ast.ImportFrom):
                pkg = node.module or "."
                names = [n.asname or n.name for n in node.names]
            else:
                pkg = node.names[0].name
                names = [n.asname or n.name for n in node.names]
            out.append(
                CodeToken(
                    TokenKind.IMPORT,
                    name=pkg,
                    package=pkg,
                    identifiers=tuple(names),
                    line=node.lineno,
                )
            )
        elif isinstance(node, (_ast.FunctionDef, _ast.AsyncFunctionDef)):
            out.append(func_token(node))
            body_lines.update(range(node.lineno, (node.end_lineno or node.lineno) + 1))
        elif isinstance(node, _ast.ClassDef):
            methods = tuple(
                n.name
                for n in node.body
                if isinstance(n, (_ast.FunctionDef, _ast.AsyncFunctionDef))
            )
            out.append(
                CodeToken(
                    TokenKind.CLASS,
                    name=node.name,
                    identifiers=methods,
                    line=node.lineno,
                )
            )
            body_lines.update(range(node.lineno, (node.end_lineno or node.lineno) + 1))
        elif isinstance(node, (_ast.Assign, _ast.AnnAssign)):
            targets = node.targets if isinstance(node, _ast.Assign) else [node.target]
            for tgt in targets:
                for n in _ast.walk(tgt):
                    if isinstance(n, _ast.Name):
                        out.append(
                            CodeToken(
                                TokenKind.GLOBAL_IDENTIFIER,
                                text=n.id,
                                name=n.id,
                                line=node.lineno,
                            )
                        )

    for ln, text in sorted(comments_by_line.items()):
        if ln not in body_lines and text:
            out.append(CodeToken(TokenKind.COMMENT, text, line=ln))
    out.sort(key=lambda t: t.line)
    return out


# ---------------------------------------------------------------------------
# Generic lexical fallback (languages without a structural grammar here)
# ---------------------------------------------------------------------------

_GENERIC_FUNC = re.compile(r"\b(?:fn|func|function|def|void|int|auto)\s+(\w+)\s*\(")
_GENERIC_COMMENT = re.compile(r"//([^\n]*)|/\*(.*?)\*/|#([^\n]*)", re.S)
_GENERIC_IDENT = re.compile(r"\b[A-Za-z_][A-Za-z0-9_]{2,}\b")


def _parse_generic(source: str) -> List[CodeToken]:
    out: List[CodeToken] = []
    for mo in _GENERIC_COMMENT.finditer(source):
        text = next((g for g in mo.groups() if g), "").strip()
        if text:
            out.append(
                CodeToken(TokenKind.COMMENT, text, line=source.count("\n", 0, mo.start()) + 1)
            )
    for mo in _GENERIC_FUNC.finditer(source):
        out.append(
            CodeToken(
                TokenKind.FUNCTION,
                name=mo.group(1),
                line=source.count("\n", 0, mo.start()) + 1,
            )
        )
    seen = set()
    for mo in _GENERIC_IDENT.finditer(source):
        w = mo.group(0)
        if w not in seen:
            seen.add(w)
            out.append(
                CodeToken(
                    TokenKind.GLOBAL_IDENTIFIER,
                    text=w,
                    name=w,
                    line=source.count("\n", 0, mo.start()) + 1,
                )
            )
    return out


# ---------------------------------------------------------------------------


class CodeParser:
    """parse(source, language) -> typed token list (reference NewParser)."""

    def parse(self, source: str, language: str = "tsx") -> List[CodeToken]:
        lang = language.lower().lstrip(".")
        if lang in ("tsx", "jsx", "js", "javascript"):
            return _TsParser(source, jsx=True).parse()
        if lang in ("ts", "typescript"):
            return _TsParser(source, jsx=False).parse()
        if lang in ("py", "python"):
            return _parse_python(source)
        return _parse_generic(source)


def flatten_for_index(tokens: Sequence[CodeToken]) -> List[str]:
    """Searchable strings from a token list (what a code field indexes)."""
    out: List[str] = []
    for t in tokens:
        if t.kind == TokenKind.COMMENT:
            out.append(t.text)
        elif t.kind == TokenKind.IMPORT:
            out.append(t.package or "")
            out.extend(t.identifiers)
        elif t.kind in (TokenKind.FUNCTION, TokenKind.CLASS):
            if t.name:
                out.append(t.name)
            out.extend(t.params)
            out.extend(t.comments)
            out.extend(t.identifiers)
            for el in t.jsx:
                out.append(el.tag)
                out.extend(el.attribute_keys)
        elif t.kind == TokenKind.GLOBAL_IDENTIFIER:
            out.append(t.text)
        elif t.kind == TokenKind.GLOBAL_JSX:
            for el in t.jsx:
                out.append(el.tag)
                out.extend(el.attribute_keys)
    return [s for s in out if s]
