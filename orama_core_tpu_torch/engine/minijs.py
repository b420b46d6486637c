"""Sandboxed mini-JavaScript interpreter for hook execution.

The reference embeds V8 on a dedicated thread (`src/js/deno.rs:77-130`) to
run user `selectEmbeddingProperties(document)` hooks. This image has no JS
engine (no node/deno/quickjs, and none can be downloaded), so dynamic hooks
run on this from-scratch interpreter instead: a tokenizer + Pratt parser +
tree-walking evaluator over a deliberately small JS subset — sandboxed BY
CONSTRUCTION (no host callouts: the evaluator can only touch JSON-shaped
values and a whitelist of string/array/object methods, with a hard step
budget against runaway code).

Supported subset (everything a realistic embedding-selection hook uses):
  - `function name(doc) { ... }`, arrow functions (block or expression body)
  - statements: const/let/var, if/else, return, blocks, expression stmts,
    `for (;;)`, `for..of`, `for..in`, while, do/while, break/continue,
    try/catch/finally, throw
  - literals: strings ('/"/`template ${}` with nesting), numbers,
    true/false/null/undefined, arrays, objects
  - member access `a.b`, `a?.b`, `a["b"]`, calls, ternary, unary `! - + typeof`,
    binary `+ - * / % == != === !== < <= > >= && || ??`, assignment
    `= += -= *= /= %=`, `++`/`--` (prefix and postfix)
  - methods: string toLowerCase/toUpperCase/trim/includes/startsWith/endsWith/
    split/slice/concat/replace/match/search; array includes/filter/map/join/
    slice/concat/flat/indexOf/push/length; number toFixed/toString;
    Object.keys/values/entries, Array.isArray, JSON.stringify/parse,
    String(), Number(), Boolean(), Math.min/max/abs/floor/ceil/round/...
  - classes: `class Name [extends Base] { constructor/methods/static/get }`,
    `new`, `this` (lexical in arrows), `super(...)` / `super.m(...)`
  - regex literals `/pat/gims` with .test/.exec/.source/.flags, and
    regex-aware string match/replace/replaceAll/split/search. Pattern
    syntax is Python `re` (identical over the practical JS subset).
  - generators: `function* g() { yield v; yield* iterable; }` with
    .next(v)/.return(v)/.throw(v), for..of, spread, and Array.from(g()).
    Evaluation is LAZY with V8 semantics: the body pauses at every yield
    on a dedicated worker thread (strictly alternating with the caller),
    so two-way communication (`const x = yield v` sees next's argument)
    and infinite streams consumed incrementally (for..of + break) both
    work; runaway bodies still die on the shared step budget, and
    suspended workers are unwound at hook teardown (see _JsGenerator).
  - destructuring: object/array patterns (nested, renames, defaults,
    holes, `...rest`) in const/let/var declarations, for..of/in heads,
    and function parameters (incl. `param = default` and `...rest`
    params); spread in array literals, object literals ({...src}), and
    call arguments; object shorthand `{title}` and computed keys
    `{[expr]: v}`. Parenthesized arrow parameter lists accept the same
    pattern/default/rest syntax (`([k, v]) => ...`).
  - switch/case/default with JS fallthrough + strict-equality matching;
    the `in` and `instanceof` operators; `delete obj.key`; labeled
    statements with labeled break/continue; bitwise `& | ^ ~ << >> >>>`
    with ToInt32 wrapping; exponentiation `**` (right-associative);
    parseInt/parseFloat/isNaN/isFinite, Number.is*/parse*,
    String.fromCharCode.
  - function expressions (named/anonymous, `function`/`function*`) with
    dynamic `this` bound at the call site (obj.fn(...) sees obj; arrows
    stay lexical); object-literal method shorthand `{ m() {} }` and
    getters `{ get x() {} }` (materialized on access, Object.values/
    entries, JSON.stringify, and hook results); prototype patching
    `Cls.prototype.m = function () {...}` (assignments override
    class-body methods, reads fall back to them); tagged templates
    ``tag`a${x}b` `` (cooked-strings array + values, V8 call shape).
  - async/await over an EAGER promise model (MiniJS has no event loop,
    so async bodies run synchronously and settle immediately — the V8
    observable behavior for CPU-only hooks): `async function`/arrows,
    `await` (unwraps settled promises, throws rejections),
    Promise.resolve/reject/all/allSettled/race, `new Promise(executor)`,
    .then/.catch/.finally. Real async IO (a promise still pending at
    await) is detected and raises MiniJsError -> node-tier fallback.

Anything outside the subset raises MiniJsError — callers fall back to the
other hook tiers (engine/hooks.py). Step/recursion budgets raise
MiniJsFatal, which user-level try/catch cannot swallow.

Port of ``orama_core_tpu/engine/minijs.py``: host code (``json``, ``re``,
``math``), copied line for line, with the same step and recursion budgets.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple


class MiniJsError(Exception):
    pass


class MiniJsFatal(MiniJsError):
    """Resource-budget violations (steps/recursion) — NOT catchable by
    user-level try/catch, so a runaway hook cannot swallow its own kill."""


class MiniJsThrow(MiniJsError):
    """An uncaught user-level `throw` escaping the hook: the hook RAN and
    vetoed this document. Callers must treat it as a per-document hook
    failure (skip the embedding, reference fields.rs:431-434) — NEVER as
    'unsupported JS' to retry on another execution tier, whose re-run
    could take a different branch."""

    def __init__(self, value: Any) -> None:
        super().__init__(f"uncaught throw: {value!r}")
        self.value = value


_UNDEFINED = object()  # JS undefined (distinct from null=None)


# --- tokenizer ----------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<str>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<punct>\.\.\.|=>|\?\.|\?\?|===|!==|==|!=|<=|>=|&&|\|\||\+\+|--
             |\+=|-=|\*=|/=|%=|\*\*|<<|>>>|>>|[-+*/%!<>=(){}\[\],.:;?&|^~])
    """,
    re.VERBOSE | re.DOTALL,
)

_KEYWORDS = {
    "function", "return", "if", "else", "const", "let", "var", "true",
    "false", "null", "undefined", "typeof", "for", "while", "do", "break",
    "continue", "try", "catch", "finally", "throw", "of", "in",
    "class", "new", "this", "yield", "switch", "case", "default",
    "instanceof", "delete",
}


def _skip_string(src: str, i: int) -> int:
    """src[i] is ' or "; return index just past the closing quote."""
    q = src[i]
    j = i + 1
    while j < len(src):
        if src[j] == "\\":
            j += 2
            continue
        if src[j] == q:
            return j + 1
        j += 1
    raise MiniJsError("unterminated string literal")


def _match_brace(src: str, i: int) -> int:
    """src[i] is '{'; return the index of the MATCHING '}' — tracking
    nested braces, strings, and nested templates (the naive first-'}' scan
    mis-parsed `${a ? \"x}\" : b}`)."""
    depth = 0
    j = i
    while j < len(src):
        c = src[j]
        if c == "\\":
            j += 2
            continue
        if c in ("'", '"'):
            j = _skip_string(src, j)
            continue
        if c == "`":
            _, j = _scan_template(src, j)
            continue
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return j
        j += 1
    raise MiniJsError("unterminated ${ in template literal")


def _scan_template(src: str, i: int) -> Tuple[str, int]:
    """src[i] is a backtick; return (inner raw text, index past the
    closing backtick), honoring ${...} nesting (incl. nested templates)."""
    j = i + 1
    while j < len(src):
        c = src[j]
        if c == "\\":
            j += 2
            continue
        if c == "`":
            return src[i + 1 : j], j + 1
        if c == "$" and j + 1 < len(src) and src[j + 1] == "{":
            j = _match_brace(src, j + 1) + 1
            continue
        j += 1
    raise MiniJsError("unterminated template literal")


def _scan_regex(src: str, i: int) -> Tuple[str, int]:
    """src[i] is '/' starting a regex literal; return (raw /pat/flags,
    index past the flags), honoring escapes and character classes."""
    j = i + 1
    in_class = False
    while j < len(src):
        c = src[j]
        if c == "\\":
            j += 2
            continue
        if c == "[":
            in_class = True
        elif c == "]":
            in_class = False
        elif c == "/" and not in_class:
            k = j + 1
            while k < len(src) and src[k] in "gimsuy":
                k += 1
            return src[i:k], k
        elif c == "\n":
            break
        j += 1
    raise MiniJsError("unterminated regex literal")


# a '/' is a division only when the previous token can END a value;
# otherwise it opens a regex literal (the standard lexer heuristic)
_VALUE_END_PUNCT = {")", "]", "++", "--"}
_VALUE_END_KW = {"this", "true", "false", "null", "undefined"}


def _regex_position(out: List[Tuple[str, str]]) -> bool:
    if not out:
        return True
    k, t = out[-1]
    if k in ("num", "str", "tmpl", "name", "regex"):
        return False
    if k == "kw":
        return t not in _VALUE_END_KW
    return t not in _VALUE_END_PUNCT


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    i = 0
    while i < len(src):
        if src[i] == "`":
            # templates need a hand scanner: the closing backtick of a
            # nested `${`...`}` would end a regex-matched token early
            raw, i = _scan_template(src, i)
            out.append(("tmpl", raw))
            continue
        if src[i] == "/" and src[i + 1 : i + 2] not in ("/", "*") and (
            _regex_position(out)
        ):
            raw, i = _scan_regex(src, i)
            out.append(("regex", raw))
            continue
        m = _TOKEN_RE.match(src, i)
        if m is None:
            raise MiniJsError(f"unexpected character {src[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "name" and text in _KEYWORDS:
            out.append(("kw", text))
        else:
            out.append((kind, text))
    out.append(("eof", ""))
    return out


# --- parser (Pratt) -----------------------------------------------------------

_BINARY_PREC = {
    "??": 1, "||": 2, "&&": 3,
    "|": 4, "^": 5, "&": 6,
    "==": 7, "!=": 7, "===": 7, "!==": 7,
    "<": 8, "<=": 8, ">": 8, ">=": 8, "in": 8, "instanceof": 8,
    "<<": 9, ">>": 9, ">>>": 9,
    "+": 10, "-": 10, "*": 11, "/": 11, "%": 11,
    "**": 12,  # right-associative (special-cased in parse_binary)
}


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]) -> None:
        self.toks = tokens
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> None:
        k, t = self.next()
        if t != text:
            raise MiniJsError(f"expected {text!r}, got {t!r}")

    def at(self, text: str) -> bool:
        return self.peek()[1] == text

    def eat(self, text: str) -> bool:
        if self.at(text):
            self.next()
            return True
        return False

    # -- statements -----------------------------------------------------------

    def parse_program(self) -> List[Any]:
        stmts = []
        while self.peek()[0] != "eof":
            stmts.append(self.parse_statement())
        return stmts

    def parse_statement(self) -> Any:
        k, t = self.peek()
        if k == "name" and self.toks[self.i + 1][1] == ":":
            # labeled statement: `outer: for (...) ...`
            self.next()
            self.next()
            return ("label", t, self.parse_statement())
        if t == "function":
            return self.parse_function_decl()
        if k == "name" and t == "async" and self.toks[self.i + 1][1] == "function":
            self.next()  # 'async' — eager subset: body runs synchronously
            return self.parse_function_decl(is_async=True)
        if t == "class":
            return self.parse_class()
        if t in ("const", "let", "var"):
            self.next()
            decls = []
            pats = []
            while True:
                if self.at("{") or self.at("["):
                    tgt = self.parse_binding_target()
                    self.expect("=")
                    pats.append((len(decls), tgt))
                    decls.append((None, self.parse_expression()))
                else:
                    _, name = self.next()
                    init = _UNDEFINED
                    if self.eat("="):
                        init = self.parse_expression()
                    decls.append((name, init))
                if not self.eat(","):
                    break
            self.eat(";")
            if pats:
                entries = []
                pat_at = dict(pats)
                for i, (name, init) in enumerate(decls):
                    tgt = pat_at.get(i, ("bname", name))
                    entries.append((tgt, init))
                return ("declp", entries)
            if len(decls) == 1:
                return ("decl", decls[0][0], decls[0][1])
            return ("decls", decls)
        if t == "switch":
            self.next()
            self.expect("(")
            disc = self.parse_expression()
            self.expect(")")
            self.expect("{")
            cases = []  # (test_expr | None for default, [stmts])
            while not self.eat("}"):
                if self.eat("case"):
                    test = self.parse_expression()
                    self.expect(":")
                else:
                    self.expect("default")
                    self.expect(":")
                    test = None
                body = []
                while not (
                    self.at("case") or self.at("default") or self.at("}")
                ):
                    body.append(self.parse_statement())
                cases.append((test, body))
            return ("switch", disc, cases)
        if t == "return":
            self.next()
            if self.at(";") or self.at("}"):
                self.eat(";")
                return ("return", ("lit", _UNDEFINED))
            e = self.parse_expression()
            self.eat(";")
            return ("return", e)
        if t == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            then = self.parse_statement()
            other = None
            if self.eat("else"):
                other = self.parse_statement()
            return ("if", cond, then, other)
        if t == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            return ("while", cond, self.parse_statement())
        if t == "do":
            self.next()
            body = self.parse_statement()
            self.expect("while")
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            self.eat(";")
            return ("dowhile", body, cond)
        if t == "for":
            return self.parse_for()
        if t == "break":
            self.next()
            label = self.next()[1] if self.peek()[0] == "name" else None
            self.eat(";")
            return ("break", label)
        if t == "continue":
            self.next()
            label = self.next()[1] if self.peek()[0] == "name" else None
            self.eat(";")
            return ("continue", label)
        if t == "throw":
            self.next()
            e = self.parse_expression()
            self.eat(";")
            return ("throw", e)
        if t == "try":
            self.next()
            body = self.parse_statement()  # canonically a block
            catch_name = catch_body = fin = None
            if self.eat("catch"):
                if self.eat("("):
                    _, catch_name = self.next()
                    self.expect(")")
                catch_body = self.parse_statement()
            if self.eat("finally"):
                fin = self.parse_statement()
            if catch_body is None and fin is None:
                raise MiniJsError("try needs catch or finally")
            return ("try", body, catch_name, catch_body, fin)
        if t == "{":
            self.next()
            body = []
            while not self.eat("}"):
                body.append(self.parse_statement())
            return ("block", body)
        e = self.parse_expression()
        self.eat(";")
        return ("expr", e)

    def parse_for(self) -> Any:
        self.expect("for")
        self.expect("(")
        k, t = self.peek()
        if t in ("const", "let", "var"):
            self.next()
            if self.at("{") or self.at("["):
                # for (const [k, v] of pairs) / (const {a} of objs)
                tgt = self.parse_binding_target()
                _, nt = self.next()
                if nt not in ("of", "in"):
                    raise MiniJsError(
                        "destructuring for-head needs of/in"
                    )
                iterable = self.parse_expression()
                self.expect(")")
                body = self.parse_statement()
                return (
                    "forof" if nt == "of" else "forin", tgt, iterable, body
                )
            _, name = self.next()
            nk, nt = self.peek()
            if nt in ("of", "in"):  # for (const x of xs) / (const k in o)
                self.next()
                iterable = self.parse_expression()
                self.expect(")")
                body = self.parse_statement()
                return (
                    "forof" if nt == "of" else "forin",
                    ("bname", name), iterable, body,
                )
            init_e = _UNDEFINED
            if self.eat("="):
                init_e = self.parse_expression()
            init = ("decl", name, init_e)
            self.expect(";")
        elif t == ";":
            self.next()
            init = None
        else:
            init = ("expr", self.parse_expression())
            self.expect(";")
        cond = None if self.at(";") else self.parse_expression()
        self.expect(";")
        update = None if self.at(")") else self.parse_expression()
        self.expect(")")
        return ("for", init, cond, update, self.parse_statement())

    def parse_class(self) -> Any:
        """class Name [extends Base] { constructor/methods/static/get }.
        Members become ("classdecl", name, base_expr|None, ctor|None,
        methods, statics, getters) — method values are plain closure
        bodies (params, body)."""
        self.expect("class")
        _, name = self.next()
        base = None
        if self.at("extends"):
            self.next()
            base = self.parse_postfix(self.parse_primary())
        self.expect("{")
        ctor = None
        methods: Dict[str, Any] = {}
        statics: Dict[str, Any] = {}
        getters: Dict[str, Any] = {}
        while not self.eat("}"):
            if self.eat(";"):
                continue
            is_static = False
            if self.at("static"):
                self.next()
                is_static = True
            is_getter = False
            if self.at("get") and self.toks[self.i + 1][1] != "(":
                self.next()
                is_getter = True
            _, mname = self.next()
            params = self.parse_params()
            self.expect("{")
            body = []
            while not self.eat("}"):
                body.append(self.parse_statement())
            if mname == "constructor" and not is_static and not is_getter:
                ctor = (params, body)
            elif is_getter:
                getters[mname] = (params, body)
            elif is_static:
                statics[mname] = (params, body)
            else:
                methods[mname] = (params, body)
        return ("classdecl", name, base, ctor, methods, statics, getters)

    def parse_function_decl(self, is_async: bool = False) -> Any:
        self.expect("function")
        is_gen = self.eat("*")
        _, name = self.next()
        params = self.parse_params()
        self.expect("{")
        body = []
        while not self.eat("}"):
            body.append(self.parse_statement())
        return ("funcdecl", name, params, body, is_gen, is_async)

    def parse_funcexpr(self, is_async: bool = False) -> Any:
        """`function [name](params) { body }` in expression position —
        the closure binds dynamic `this` at the call site (V8 function
        semantics), unlike arrows which keep lexical `this`."""
        is_gen = self.eat("*")
        name = None
        if self.peek()[0] == "name":
            name = self.next()[1]
        params = self.parse_params()
        self.expect("{")
        body = []
        while not self.eat("}"):
            body.append(self.parse_statement())
        return ("funcexpr", name, params, body, is_gen, is_async)

    def parse_params(self) -> List[Any]:
        """Parameter list entries: a plain name (str), ("rest", name) for
        `...name`, or ("p", binding_target, default_expr|None) for
        destructuring patterns and defaulted names."""
        self.expect("(")
        params: List[Any] = []
        while not self.eat(")"):
            if self.eat(","):
                continue
            if self.eat("..."):
                _, rn = self.next()
                params.append(("rest", rn))
                continue
            if self.at("{") or self.at("["):
                tgt = self.parse_binding_target()
                default = (
                    self.parse_ternary() if self.eat("=") else None
                )
                params.append(("p", tgt, default))
                continue
            k, t = self.next()
            if k != "name":
                raise MiniJsError(f"bad parameter {t!r}")
            if self.at("="):
                self.next()
                params.append(("p", ("bname", t), self.parse_ternary()))
            else:
                params.append(t)
        return params

    def parse_binding_target(self) -> Any:
        """A destructuring binding target: ("bname", name), or
        ("opat", [(key, target, default), ...], rest_name|None), or
        ("apat", [(target, default) | None hole, ...], rest_name|None).
        Nested patterns and `= default` per entry are supported; defaults
        parse as ternary-level expressions (no bare commas)."""
        if self.eat("{"):
            entries = []
            rest = None
            while not self.eat("}"):
                if self.eat(","):
                    continue
                if self.eat("..."):
                    _, rest = self.next()
                    continue
                kk, key = self.next()
                if kk == "str":
                    key = _unescape(key[1:-1])
                elif kk not in ("name", "kw", "num"):
                    raise MiniJsError(f"bad destructuring key {key!r}")
                target: Any = ("bname", key)
                if self.eat(":"):
                    target = self.parse_binding_target()
                default = self.parse_ternary() if self.eat("=") else None
                entries.append((key, target, default))
            return ("opat", entries, rest)
        if self.eat("["):
            elems: List[Any] = []
            rest = None
            while True:
                if self.eat("]"):
                    break
                if self.at(","):
                    self.next()
                    elems.append(None)  # elision hole
                    continue
                if self.eat("..."):
                    _, rest = self.next()
                    self.eat(",")
                    continue
                target = self.parse_binding_target()
                default = self.parse_ternary() if self.eat("=") else None
                elems.append((target, default))
                if not self.eat(","):
                    self.expect("]")
                    break
            return ("apat", elems, rest)
        k, name = self.next()
        if k != "name":
            raise MiniJsError(f"bad binding target {name!r}")
        return ("bname", name)

    # -- expressions ------------------------------------------------------------

    _ASSIGN_OPS = ("=", "+=", "-=", "*=", "/=", "%=")

    def parse_expression(self) -> Any:
        if self.at("yield"):
            self.next()
            deleg = self.eat("*")
            k, t = self.peek()
            if k == "eof" or t in (";", ")", "}", ",", "]"):
                arg = ("lit", _UNDEFINED)
            else:
                arg = self.parse_expression()
            return ("yield", arg, deleg)
        left = self.parse_ternary()
        _, t = self.peek()
        if t in self._ASSIGN_OPS:
            if left[0] not in ("name", "member"):
                raise MiniJsError("invalid assignment target")
            self.next()
            # right-associative: a = b = c
            return ("assign", t, left, self.parse_expression())
        return left

    def parse_ternary(self) -> Any:
        cond = self.parse_binary(0)
        if self.eat("?"):
            a = self.parse_expression()
            self.expect(":")
            b = self.parse_expression()
            return ("ternary", cond, a, b)
        return cond

    def parse_binary(self, min_prec: int) -> Any:
        left = self.parse_unary()
        while True:
            _, t = self.peek()
            prec = _BINARY_PREC.get(t)
            if prec is None or prec < min_prec:
                return left
            self.next()
            # ** is right-associative: recurse at the same level
            right = self.parse_binary(prec if t == "**" else prec + 1)
            left = ("bin", t, left, right)

    def parse_unary(self) -> Any:
        k, t = self.peek()
        if t in ("!", "-", "+", "~"):
            self.next()
            return ("unary", t, self.parse_unary())
        if t in ("++", "--"):
            self.next()
            target = self.parse_postfix(self.parse_primary())
            if target[0] not in ("name", "member"):
                raise MiniJsError("invalid ++/-- target")
            return ("update", t, target, True)
        if t == "typeof":
            self.next()
            return ("typeof", self.parse_unary())
        if t == "delete":
            self.next()
            target = self.parse_unary()
            if target[0] != "member":
                raise MiniJsError("delete needs a property access")
            return ("delete", target)
        if k == "name" and t == "await":
            # eager subset: await unwraps an already-settled promise
            self.next()
            return ("await", self.parse_unary())
        return self.parse_postfix(self.parse_primary())

    def parse_postfix(self, e: Any) -> Any:
        while True:
            _, nt = self.peek()
            if nt in ("++", "--") and e[0] in ("name", "member"):
                self.next()
                e = ("update", nt, e, False)
                continue
            if self.peek()[0] == "tmpl":
                # tagged template: tag`a${x}b` -> tag(["a","b"], x)
                _, raw = self.next()
                strings, exprs = self.parse_template_parts(raw)
                e = ("tag", e, strings, exprs)
            elif self.eat("."):
                _, name = self.next()
                e = ("member", e, ("lit", name), False)
            elif self.eat("?."):
                _, name = self.next()
                e = ("member", e, ("lit", name), True)
            elif self.eat("["):
                idx = self.parse_expression()
                self.expect("]")
                e = ("member", e, idx, False)
            elif self.eat("("):
                args = []
                while not self.eat(")"):
                    if self.eat("..."):
                        args.append(("spread", self.parse_expression()))
                    else:
                        args.append(self.parse_expression())
                    self.eat(",")
                e = ("call", e, args)
            else:
                return e

    def parse_primary(self) -> Any:
        k, t = self.next()
        if k == "num":
            v = float(t)
            return ("lit", int(v) if v.is_integer() else v)
        if k == "str":
            return ("lit", _unescape(t[1:-1]))
        if k == "tmpl":
            return self.parse_template(t)  # token carries the inner text
        if k == "regex":
            return ("regexlit", t)
        if k == "kw":
            if t == "true":
                return ("lit", True)
            if t == "false":
                return ("lit", False)
            if t == "null":
                return ("lit", None)
            if t == "undefined":
                return ("lit", _UNDEFINED)
            if t == "this":
                return ("this",)
            if t == "function":
                return self.parse_funcexpr()
            if t == "new":
                # new Ctor(.member)*(args)
                target = self.parse_primary()
                while self.eat("."):
                    _, nm = self.next()
                    target = ("member", target, ("lit", nm), False)
                args = []
                if self.eat("("):
                    while not self.eat(")"):
                        args.append(self.parse_expression())
                        self.eat(",")
                return ("new", target, args)
            raise MiniJsError(f"unexpected keyword {t!r}")
        if k == "name":
            if t == "async":
                # contextual: async function / async arrow; otherwise a
                # plain identifier named `async`
                nk, nt = self.peek()
                if nt == "function":
                    self.next()
                    return self.parse_funcexpr(is_async=True)
                if nk == "name" and self.toks[self.i + 1][1] == "=>":
                    _, pname = self.next()
                    self.expect("=>")
                    return self.parse_arrow_body([pname], is_async=True)
                if nt == "(":
                    save_a = self.i
                    self.next()  # '('
                    node = self._maybe_paren_arrow(is_async=True)
                    if node is not None:
                        return node
                    self.i = save_a
            # arrow fn:  name => expr
            if self.at("=>"):
                self.next()
                return self.parse_arrow_body([t])
            return ("name", t)
        if t == "(":
            node = self._maybe_paren_arrow(is_async=False)
            if node is not None:
                return node
            e = self.parse_expression()
            self.expect(")")
            return e
        if t == "[":
            items = []
            while not self.eat("]"):
                if self.eat("..."):
                    items.append(("spread", self.parse_expression()))
                else:
                    items.append(self.parse_expression())
                self.eat(",")
            return ("array", items)
        if t == "{":
            pairs = []
            while not self.eat("}"):
                if (
                    self.at("get")
                    and self.toks[self.i + 1][0] in ("name", "str", "kw")
                    and self.toks[self.i + 2][1] == "("
                ):
                    # object-literal getter: { get x() { ... } }
                    self.next()
                    _, gname = self.next()
                    gparams = self.parse_params()
                    self.expect("{")
                    gbody = []
                    while not self.eat("}"):
                        gbody.append(self.parse_statement())
                    pairs.append(
                        (("getter", gname),
                         ("funcexpr", None, gparams, gbody, False, False))
                    )
                    self.eat(",")
                    continue
                if self.eat("..."):
                    # {...obj} spread entry: None key marks a merge
                    pairs.append((None, self.parse_expression()))
                    self.eat(",")
                    continue
                if self.eat("["):
                    # computed key {[expr]: v}: tuple key marks it
                    key_e = self.parse_expression()
                    self.expect("]")
                    self.expect(":")
                    pairs.append((("computed", key_e),
                                  self.parse_expression()))
                    self.eat(",")
                    continue
                kk, key = self.next()
                if kk == "str":
                    key = _unescape(key[1:-1])
                elif kk not in ("name", "num", "kw"):
                    raise MiniJsError(f"bad object key {key!r}")
                if self.at(",") or self.at("}"):
                    # shorthand {title} == {title: title}
                    pairs.append((key, ("name", key)))
                    self.eat(",")
                    continue
                if self.at("("):
                    # method shorthand { m(a) { ... } } — dynamic `this`
                    mparams = self.parse_params()
                    self.expect("{")
                    mbody = []
                    while not self.eat("}"):
                        mbody.append(self.parse_statement())
                    pairs.append(
                        (key,
                         ("funcexpr", None, mparams, mbody, False, False))
                    )
                    self.eat(",")
                    continue
                self.expect(":")
                pairs.append((key, self.parse_expression()))
                self.eat(",")
            return ("object", pairs)
        raise MiniJsError(f"unexpected token {t!r}")

    def _maybe_paren_arrow(self, is_async: bool) -> Optional[Any]:
        """Called with the opening '(' already consumed: try-parse a full
        parameter list (patterns, defaults, rest) followed by `=>`;
        backtrack to just after the '(' and return None on anything that
        isn't an arrow head, so the caller parses a parenthesized
        expression instead."""
        save = self.i
        try:
            params: List[Any] = []
            while not self.eat(")"):
                if self.eat(","):
                    continue
                if self.eat("..."):
                    kk, rn = self.next()
                    if kk != "name":
                        raise MiniJsError("not params")
                    params.append(("rest", rn))
                    continue
                if self.at("{") or self.at("["):
                    tgt = self.parse_binding_target()
                    default = (
                        self.parse_ternary() if self.eat("=") else None
                    )
                    params.append(("p", tgt, default))
                    continue
                kk, tt = self.next()
                if kk != "name":
                    raise MiniJsError("not params")
                if self.at("="):
                    self.next()
                    params.append(
                        ("p", ("bname", tt), self.parse_ternary())
                    )
                else:
                    params.append(tt)
            if self.eat("=>"):
                return self.parse_arrow_body(params, is_async=is_async)
            raise MiniJsError("not arrow")
        except MiniJsError:
            self.i = save
            return None

    def parse_arrow_body(
        self, params: List[str], is_async: bool = False
    ) -> Any:
        if self.at("{"):
            self.next()
            body = []
            while not self.eat("}"):
                body.append(self.parse_statement())
            return ("arrow", params, body, is_async)
        return ("arrow", params,
                [("return", self.parse_expression())], is_async)

    def parse_template_parts(
        self, raw: str
    ) -> Tuple[List[str], List[Any]]:
        """For tagged templates: split the raw template body into the
        cooked string parts (always len(exprs)+1, empties included — the
        V8 shape of the tag's first argument) and the `${}` expression
        nodes."""
        strings: List[str] = []
        exprs: List[Any] = []
        i = 0
        buf = ""
        while i < len(raw):
            if raw.startswith("${", i):
                end = _match_brace(raw, i + 1)
                strings.append(_unescape(buf))
                buf = ""
                sub = _Parser(_tokenize(raw[i + 2:end]))
                exprs.append(sub.parse_expression())
                i = end + 1
            elif raw.startswith("\\", i) and i + 1 < len(raw):
                buf += raw[i : i + 2]
                i += 2
            else:
                buf += raw[i]
                i += 1
        strings.append(_unescape(buf))
        return strings, exprs

    def parse_template(self, raw: str) -> Any:
        """`a ${x} b` -> concat of parts. ${} bounds come from the
        brace-matching scanner, so `${a ? "x}" : b}` and nested templates
        parse correctly."""
        parts: List[Any] = []
        i = 0
        buf = ""
        while i < len(raw):
            if raw.startswith("${", i):
                end = _match_brace(raw, i + 1)
                if buf:
                    parts.append(("lit", _unescape(buf)))
                    buf = ""
                sub = _Parser(_tokenize(raw[i + 2:end]))
                parts.append(("tostr", sub.parse_expression()))
                i = end + 1
            elif raw.startswith("\\", i) and i + 1 < len(raw):
                buf += raw[i : i + 2]
                i += 2
            else:
                buf += raw[i]
                i += 1
        if buf:
            parts.append(("lit", _unescape(buf)))
        if not parts:
            return ("lit", "")
        e = parts[0] if parts[0][0] == "lit" else ("tostr", parts[0][1])
        for p in parts[1:]:
            e = ("bin", "+", ("tostr", e) if e[0] != "lit" else e, p)
        return ("tostr", e)


def _unescape(s: str) -> str:
    return (
        s.replace("\\n", "\n").replace("\\t", "\t").replace("\\'", "'")
        .replace('\\"', '"').replace("\\`", "`").replace("\\\\", "\\")
    )


# --- evaluator ------------------------------------------------------------------


class _JsClass:
    """A class declaration's runtime value: methods are (params, body)
    pairs closed over ``env``; lookup walks the parent chain."""

    def __init__(self, name, parent, ctor, methods, statics, getters, env):
        self.name = name
        self.parent = parent          # _JsClass | None
        self.ctor = ctor              # (params, body) | None
        self.methods = methods
        self.statics = statics
        self.getters = getters
        self.env = env
        # post-declaration `Cls.prototype.x = ...` assignments: closures
        # or data values; looked up before class-body methods (a later
        # prototype assignment overrides, matching V8 where class methods
        # live on the same prototype object)
        self.proto_fns: Dict[str, Any] = {}

    def find_proto(self, name):
        c = self
        while c is not None:
            if name in c.proto_fns:
                return c.proto_fns[name], True
            c = c.parent
        return None, False

    def find_method(self, name):
        c = self
        while c is not None:
            m = c.methods.get(name)
            if m is not None:
                return m, c
            c = c.parent
        return None, None

    def find_getter(self, name):
        c = self
        while c is not None:
            g = c.getters.get(name)
            if g is not None:
                return g, c
            c = c.parent
        return None, None

    def find_ctor(self):
        c = self
        while c is not None:
            if c.ctor is not None:
                return c.ctor, c
            c = c.parent
        return None, None


class _JsProto:
    """The value of ``Cls.prototype`` — a thin mutation seam so hooks can
    do `Cls.prototype.m = function () {...}` (V8 prototype patching).
    Reads resolve assigned entries first, then class-body methods."""

    __slots__ = ("cls",)

    def __init__(self, cls: "_JsClass") -> None:
        self.cls = cls


class _JsPromise:
    """Eager promise: MiniJS has no event loop, so async functions run
    their bodies synchronously and settle immediately. `state` is
    'fulfilled' | 'rejected' | 'pending' (pending only via a `new
    Promise` executor that never settles — awaiting it is an error that
    routes the hook to the node tier)."""

    __slots__ = ("state", "value")

    def __init__(self, state: str, value: Any) -> None:
        self.state = state
        self.value = value


class _JsObject(dict):
    """A class instance: a plain JS object (dict) plus a class pointer —
    dict subclassing keeps every existing object path (member access,
    assignment, JSON.stringify, _strip_undefined) working unchanged."""

    __slots__ = ("cls",)


class _JsRegex:
    """A /pattern/flags literal. Pattern syntax is Python ``re`` (the
    practical JS subset is identical); i/m/s translate to flags, g drives
    match/replace globality, u/y accepted and ignored."""

    def __init__(self, raw: str) -> None:
        body, _, flags = raw.rpartition("/")
        self.source = body[1:]
        self.flags_js = flags
        self.g = "g" in flags
        f = 0
        if "i" in flags:
            f |= re.IGNORECASE
        if "m" in flags:
            f |= re.MULTILINE
        if "s" in flags:
            f |= re.DOTALL
        try:
            self.rx = re.compile(self.source, f)
        except re.error as ex:
            raise MiniJsError(f"bad regex literal: {ex}")

    @staticmethod
    def _match_array(m: "re.Match") -> List[Any]:
        return [m.group(0)] + [
            (g if g is not None else _UNDEFINED) for g in m.groups()
        ]

    def repl_py(self, repl: str) -> str:
        """JS $-replacement -> Python re template ($1..$9, $&, $$)."""
        out = repl.replace("\\", "\\\\")
        out = out.replace("$$", "\x00DOLLAR\x00")
        out = re.sub(r"\$(\d)", r"\\\1", out)
        out = out.replace("$&", "\\g<0>")
        return out.replace("\x00DOLLAR\x00", "$")


class _GenKill(BaseException):
    """Internal: unwinds a suspended generator body when the generator is
    closed (.return(), hook teardown). BaseException so user-level
    try/catch inside the body cannot swallow the teardown."""


class _JsGenerator:
    """A generator object produced by calling a `function*`. Evaluation is
    LAZY with full V8 semantics: the body runs on a dedicated worker
    thread that pauses at every `yield` and resumes on .next(v) — two-way
    communication (`const x = yield v` sees next's argument) and infinite
    streams consumed incrementally both work. Execution strictly
    alternates (the caller blocks while the body runs; the body blocks at
    every yield), so the interpreter is never entered concurrently and
    the shared step budget keeps bounding runaway bodies. Worker threads
    are daemons and are killed at .return()/hook teardown (run_hook's
    finally closes every generator the hook created)."""

    __slots__ = (
        "interp", "params", "body", "defenv", "args", "this",
        "thread", "inq", "outq", "state", "running",
    )

    def __init__(self, interp, params, body, defenv, args, this) -> None:
        import queue
        import threading

        self.interp = interp
        self.params = params
        self.body = body
        self.defenv = defenv
        self.args = args
        self.this = this
        self.inq: Any = queue.Queue()
        self.outq: Any = queue.Queue()
        self.state = "new"        # new | suspended | done
        self.running = False      # body currently executing
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        try:
            msg = self.inq.get()
            if msg[0] == "kill":
                return
            # msg carries the first next(v) argument, discarded (JS)
            ret = self.interp._call_body(
                self.params, self.body, self.defenv, self.args,
                this=self.this, gen=self,
            )
            self.outq.put(("done", ret))
        except _GenKill:
            pass
        except _Throw as th:
            self.outq.put(("throw", th))
        except MiniJsError as ex:  # incl. MiniJsFatal budget kills
            self.outq.put(("fatal", ex))
        except BaseException as ex:  # pragma: no cover - defensive
            self.outq.put(("fatal", MiniJsFatal(f"generator crashed: {ex}")))

    def next_result(self, sent: Any = _UNDEFINED) -> Dict[str, Any]:
        return self._pump(("send", sent))

    def throw_result(self, err: Any) -> Dict[str, Any]:
        """gen.throw(v): raise inside the body at the suspended yield; a
        body-level try/catch around the yield can recover and keep
        yielding (V8). Before the first next(), the throw surfaces
        directly to the caller."""
        if self.state in ("new", "done"):
            self.state = "done"
            raise _Throw(err)
        return self._pump(("throw", err))

    def _pump(self, msg: Tuple[str, Any]) -> Dict[str, Any]:
        if self.state == "done":
            return {"value": _UNDEFINED, "done": True}
        if self.running:
            # the body called its own .next() — V8 throws TypeError
            raise MiniJsError("generator is already running")
        if self.state == "new":
            self.thread.start()
            self.state = "suspended"
        self.running = True
        try:
            self.inq.put(msg)
            try:
                kind, v = self.outq.get(timeout=120.0)
            except Exception:
                self.state = "done"
                raise MiniJsFatal("generator body wedged") from None
        finally:
            self.running = False
        if kind == "yield":
            return {"value": v, "done": False}
        self.state = "done"
        if kind == "done":
            return {"value": v, "done": True}
        raise v  # ("throw", _Throw) or ("fatal", MiniJsError)

    def drain(self) -> List[Any]:
        """Collect all remaining yields (spread, Array.from, destructure
        ...). The step budget bounds infinite generators exactly like an
        infinite loop."""
        out: List[Any] = []
        while True:
            r = self.next_result()
            if r["done"]:
                return out
            out.append(r["value"])

    def close(self, value: Any = _UNDEFINED) -> Dict[str, Any]:
        """.return(v) / teardown: unwind a suspended body and mark done."""
        if self.state == "suspended" and self.thread.is_alive():
            self.inq.put(("kill",))
            self.thread.join(timeout=5.0)
        self.state = "done"
        return {"value": value, "done": True}


class _Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Env"] = None) -> None:
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def get(self, name: str) -> Any:
        e: Optional[_Env] = self
        while e is not None:
            if name in e.vars:
                return e.vars[name]
            e = e.parent
        raise MiniJsError(f"undefined identifier {name!r}")

    def set(self, name: str, value: Any) -> None:
        self.vars[name] = value

    def assign(self, name: str, value: Any) -> None:
        e: Optional[_Env] = self
        while e is not None:
            if name in e.vars:
                e.vars[name] = value
                return
            e = e.parent
        raise MiniJsError(f"assignment to undeclared identifier {name!r}")


class _Return(Exception):
    def __init__(self, value: Any) -> None:
        self.value = value


class _Break(Exception):
    def __init__(self, label: Optional[str] = None) -> None:
        super().__init__(label)
        self.label = label


class _Continue(Exception):
    def __init__(self, label: Optional[str] = None) -> None:
        super().__init__(label)
        self.label = label


class _Throw(Exception):
    """A JS `throw` in flight; .value is the thrown JSON-shaped value."""

    def __init__(self, value: Any) -> None:
        self.value = value


def _truthy(v: Any) -> bool:
    if v is _UNDEFINED or v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    if isinstance(v, str):
        return len(v) > 0
    return True  # objects/arrays are truthy


def _js_str(v: Any) -> str:
    if v is _UNDEFINED:
        return "undefined"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    return str(v)


import math as _math

_MATH_FNS: Dict[str, Callable] = {
    "min": lambda *a: min(a) if a else float("inf"),
    "max": lambda *a: max(a) if a else float("-inf"),
    "abs": abs,
    "floor": lambda x: int(_math.floor(x)),
    "ceil": lambda x: int(_math.ceil(x)),
    "round": lambda x: int(_math.floor(x + 0.5)),  # JS half-up, not banker's
    "trunc": lambda x: int(x),
    "sqrt": _math.sqrt,
    "pow": lambda a, b: a ** b,
    "log": _math.log,
    "log2": _math.log2,
    "log10": _math.log10,
    "exp": _math.exp,
    "sign": lambda x: (x > 0) - (x < 0),
    "hypot": _math.hypot,
}


class _Interp:
    MAX_STEPS = 200_000
    MAX_DEPTH = 64

    def __init__(self) -> None:
        import threading

        self.steps = 0
        # per-thread stack of active generators (None frames for plain
        # functions, so a yield inside a nested non-generator function
        # cannot leak into an enclosing generator — a V8 SyntaxError).
        # Thread-local because each lazy generator body runs on its own
        # worker thread (strictly alternating with the caller).
        self._tl = threading.local()
        # every generator this interpreter created, closed at hook end
        self._gens: List[_JsGenerator] = []
        # label of the statement currently being labeled (consumed by the
        # next loop that starts — see run_stmt "label")
        self._pending_label: Optional[str] = None

    def _gen_stack(self) -> List[Optional[_JsGenerator]]:
        st = getattr(self._tl, "gens", None)
        if st is None:
            st = []
            self._tl.gens = st
        return st

    def close_generators(self) -> None:
        for g in self._gens:
            g.close()
        self._gens.clear()

    def _take_label(self) -> Optional[str]:
        lbl = self._pending_label
        self._pending_label = None
        return lbl

    def tick(self) -> None:
        self.steps += 1
        if self.steps > self.MAX_STEPS:
            raise MiniJsFatal("step budget exhausted (runaway hook)")

    # statements
    def run_block(self, stmts: List[Any], env: _Env) -> None:
        for s in stmts:
            self.run_stmt(s, env)

    def run_stmt(self, s: Any, env: _Env) -> None:
        self.tick()
        op = s[0]
        if op == "decl":
            env.set(s[1], self.eval(s[2], env) if s[2] is not _UNDEFINED else _UNDEFINED)
        elif op == "declp":
            for tgt, init in s[1]:
                v = (
                    self.eval(init, env)
                    if init is not _UNDEFINED else _UNDEFINED
                )
                self.bind_pattern(tgt, v, env)
        elif op == "decls":
            for name, init in s[1]:
                env.set(
                    name,
                    self.eval(init, env) if init is not _UNDEFINED
                    else _UNDEFINED,
                )
        elif op == "return":
            raise _Return(self.eval(s[1], env))
        elif op == "if":
            if _truthy(self.eval(s[1], env)):
                self.run_stmt(s[2], env)
            elif s[3] is not None:
                self.run_stmt(s[3], env)
        elif op == "block":
            self.run_block(s[1], _Env(env))
        elif op == "expr":
            self.eval(s[1], env)
        elif op == "funcdecl":
            env.set(s[1], ("closure", s[2], s[3], env, s[4], True, s[5]))
        elif op == "classdecl":
            _, name, base_e, ctor, methods, statics, getters = s
            parent = None
            if base_e is not None:
                parent = self.eval(base_e, env)
                if not isinstance(parent, _JsClass):
                    raise MiniJsError("extends target is not a class")
            env.set(name, _JsClass(
                name, parent, ctor, methods, statics, getters, env
            ))
        elif op == "while":
            my_label = self._take_label()
            while _truthy(self.eval(s[1], env)):
                self.tick()
                try:
                    self.run_stmt(s[2], env)
                except _Break as b:
                    if b.label and b.label != my_label:
                        raise
                    break
                except _Continue as c:
                    if c.label and c.label != my_label:
                        raise
                    continue
        elif op == "dowhile":
            my_label = self._take_label()
            while True:
                self.tick()
                try:
                    self.run_stmt(s[1], env)
                except _Break as b:
                    if b.label and b.label != my_label:
                        raise
                    break
                except _Continue as c:
                    if c.label and c.label != my_label:
                        raise
                if not _truthy(self.eval(s[2], env)):
                    break
        elif op == "for":
            _, init, cond, update, body = s
            my_label = self._take_label()
            fenv = _Env(env)  # init decl scopes to the loop
            if init is not None:
                self.run_stmt(init, fenv)
            while cond is None or _truthy(self.eval(cond, fenv)):
                self.tick()
                try:
                    self.run_stmt(body, fenv)
                except _Break as b:
                    if b.label and b.label != my_label:
                        raise
                    break
                except _Continue as c:
                    if c.label and c.label != my_label:
                        raise
                if update is not None:
                    self.eval(update, fenv)
        elif op in ("forof", "forin"):
            _, name, iter_e, body = s
            my_label = self._take_label()
            seq = self.eval(iter_e, env)
            if op == "forof":
                if isinstance(seq, str):
                    items: List[Any] = list(seq)
                elif isinstance(seq, list):
                    items = list(seq)
                elif isinstance(seq, _JsGenerator):
                    # lazy pull: infinite generators + break work (V8)
                    def _gen_iter(g: _JsGenerator = seq):
                        while True:
                            r = g.next_result()
                            if r["done"]:
                                return
                            yield r["value"]
                    items = _gen_iter()
                else:
                    raise MiniJsError("for..of needs an array or string")
            else:  # for..in yields keys (string indices for arrays, as JS)
                if isinstance(seq, dict):
                    items = list(seq.keys())
                elif isinstance(seq, list):
                    items = [str(i) for i in range(len(seq))]
                else:
                    raise MiniJsError("for..in needs an object or array")
            for item in items:
                self.tick()
                fenv = _Env(env)
                self.bind_pattern(name, item, fenv)
                try:
                    self.run_stmt(body, fenv)
                except _Break as b:
                    if b.label and b.label != my_label:
                        raise
                    break
                except _Continue as c:
                    if c.label and c.label != my_label:
                        raise
                    continue
        elif op == "switch":
            disc = self.eval(s[1], env)
            cases = s[2]
            start = None
            for i, (test, _body) in enumerate(cases):
                if test is not None and self._switch_match(
                    disc, self.eval(test, env)
                ):
                    start = i
                    break
            if start is None:
                start = next(
                    (i for i, (t2, _b) in enumerate(cases) if t2 is None),
                    None,
                )
            if start is not None:
                senv = _Env(env)
                try:  # fallthrough until break, as in JS
                    for _t, body in cases[start:]:
                        self.run_block(body, senv)
                except _Break as b:
                    if b.label:  # labeled break targets an outer statement
                        raise
        elif op == "label":
            # only a directly-labeled LOOP consumes the label (loops take
            # it as their first action, before any user code can run); a
            # label on a block/if/switch must NOT leak to inner loops —
            # `outer: { for (..) break outer; } done()` exits the BLOCK
            is_loop = s[2][0] in ("for", "forof", "forin", "while", "dowhile")
            prev = self._pending_label
            if is_loop:
                self._pending_label = s[1]
            try:
                self.run_stmt(s[2], env)
            except _Break as b:
                if b.label != s[1]:
                    raise
            finally:
                if is_loop:
                    self._pending_label = prev
        elif op == "break":
            raise _Break(s[1] if len(s) > 1 else None)
        elif op == "continue":
            raise _Continue(s[1] if len(s) > 1 else None)
        elif op == "throw":
            raise _Throw(self.eval(s[1], env))
        elif op == "try":
            _, body, catch_name, catch_body, fin = s
            try:
                try:
                    self.run_stmt(body, env)
                except _Throw as th:
                    if catch_body is None:
                        raise
                    cenv = _Env(env)
                    if catch_name:
                        cenv.set(catch_name, th.value)
                    self.run_stmt(catch_body, cenv)
                except MiniJsFatal:
                    raise  # budgets are not user-catchable
                except MiniJsError as ex:
                    # runtime errors are catchable, surfaced as {message}
                    if catch_body is None:
                        raise
                    cenv = _Env(env)
                    if catch_name:
                        cenv.set(catch_name, {"message": str(ex)})
                    self.run_stmt(catch_body, cenv)
            finally:
                if fin is not None:
                    self.run_stmt(fin, env)
        else:
            raise MiniJsError(f"unsupported statement {op}")

    # expressions
    def eval(self, e: Any, env: _Env) -> Any:
        self.tick()
        op = e[0]
        if op == "lit":
            return e[1]
        if op == "name":
            return env.get(e[1])
        if op == "array":
            out: List[Any] = []
            for x in e[1]:
                if x[0] == "spread":
                    out.extend(self._spread_items(self.eval(x[1], env)))
                else:
                    out.append(self.eval(x, env))
            return out
        if op == "object":
            o: Dict[str, Any] = {}
            for k, v in e[1]:
                if k is None:  # {...src} merge entry
                    src = self.eval(v, env)
                    if not isinstance(src, dict):
                        raise MiniJsError("object spread needs an object")
                    self._merge_own(o, src)
                elif isinstance(k, tuple) and k[0] == "getter":
                    # lazy property: evaluated against the owning object
                    # on each access (_member_value / resolve_data)
                    o[k[1]] = ("jsgetter", self.eval(v, env))
                elif isinstance(k, tuple):  # ("computed", expr)
                    o[_js_str(self.eval(k[1], env))] = self.eval(v, env)
                else:
                    o[k] = self.eval(v, env)
            return o
        if op == "tostr":
            return _js_str(self.eval(e[1], env))
        if op == "ternary":
            return (
                self.eval(e[2], env)
                if _truthy(self.eval(e[1], env))
                else self.eval(e[3], env)
            )
        if op == "unary":
            v = self.eval(e[2], env)
            if e[1] == "!":
                return not _truthy(v)
            if e[1] == "-":
                return -self._num(v)
            if e[1] == "~":
                return ~self._to_i32(v)
            return +self._num(v)
        if op == "assign":
            return self.eval_assign(e[1], e[2], e[3], env)
        if op == "update":
            cur = self._num(self.eval(e[2], env))
            new = cur + 1 if e[1] == "++" else cur - 1
            self._store(e[2], new, env)
            return new if e[3] else cur  # prefix -> new, postfix -> old
        if op == "typeof":
            try:
                v = self.eval(e[1], env)
            except MiniJsFatal:
                raise
            except MiniJsError:
                return "undefined"
            if v is _UNDEFINED:
                return "undefined"
            if v is None:
                return "object"
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, (int, float)):
                return "number"
            if isinstance(v, str):
                return "string"
            if isinstance(v, tuple) and v and v[0] in (
                "closure", "boundm", "method", "native",
            ):
                return "function"
            return "object"
        if op == "bin":
            return self.eval_bin(e[1], e[2], e[3], env)
        if op == "member":
            return self.eval_member(e, env)
        if op == "call":
            return self.eval_call(e, env)
        if op == "arrow":
            # arrows: lexical `this` (binds_this=False), maybe async
            return ("closure", e[1], e[2], env, False, False,
                    len(e) > 3 and bool(e[3]))
        if op == "funcexpr":
            _, name, params, body, is_gen, is_async = e
            fenv = _Env(env)
            clo = ("closure", params, body, fenv, is_gen, True, is_async)
            if name:
                fenv.set(name, clo)  # named fn expr sees itself
            return clo
        if op == "await":
            v = self.eval(e[1], env)
            while isinstance(v, _JsPromise):
                if v.state == "rejected":
                    raise _Throw(v.value)
                if v.state == "pending":
                    raise MiniJsError(
                        "await on a pending promise (real async IO is "
                        "outside the eager MiniJS subset; node tier)"
                    )
                v = v.value
            return v
        if op == "tag":
            fn = self.eval(e[1], env)
            vals = [self.eval(x, env) for x in e[3]]
            return self._invoke(fn, [list(e[2])] + vals)
        if op == "this":
            return env.get("this")
        if op == "regexlit":
            return _JsRegex(e[1])
        if op == "delete":
            m = e[1]  # ("member", obj_e, key_e, optional)
            obj = self.eval(m[1], env)
            key = self.eval(m[2], env)
            if isinstance(obj, dict):
                obj.pop(_js_str(key) if not isinstance(key, str) else key,
                        None)
                return True
            raise MiniJsError("delete needs an object property")
        if op == "yield":
            st = self._gen_stack()
            if not st or st[-1] is None:
                raise MiniJsError("yield outside a generator body")
            gen = st[-1]
            v = self.eval(e[1], env)
            if e[2]:  # yield* — delegate, forwarding sent values (V8)
                if isinstance(v, _JsGenerator):
                    sent: Any = _UNDEFINED
                    while True:
                        r = v.next_result(sent)
                        if r["done"]:
                            return r["value"]  # yield* value = inner return
                        sent = self._emit_yield(gen, r["value"])
                    # unreachable
                if isinstance(v, (list, str)):
                    for item in list(v):
                        self._emit_yield(gen, item)
                    return _UNDEFINED
                raise MiniJsError("yield* needs an iterable")
            # suspend here; evaluates to the next(v) argument (two-way)
            return self._emit_yield(gen, v)
        if op == "new":
            if e[1] == ("name", "Promise"):
                return self._new_promise(e[2], env)
            cls = self.eval(e[1], env)
            if not isinstance(cls, _JsClass):
                raise MiniJsError("new target is not a class")
            inst = _JsObject()
            inst.cls = cls
            args = [self.eval(a, env) for a in e[2]]
            found = cls.find_ctor()
            if found[0] is not None:
                (params, body), owner = found
                self._call_body(
                    params, body, owner.env, args,
                    this=inst, superclass=owner.parent,
                )
            return inst
        raise MiniJsError(f"unsupported expression {op}")

    @staticmethod
    def _num(v: Any) -> float:
        if isinstance(v, bool):
            return 1.0 if v else 0.0
        if isinstance(v, (int, float)):
            return v
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                raise MiniJsError(f"NaN from {v!r}")
        raise MiniJsError(f"not a number: {v!r}")

    def eval_assign(self, opr: str, target: Any, rhs: Any, env: _Env) -> Any:
        val = self.eval(rhs, env)
        if opr != "=":
            val = self._bin_vals(opr[:-1], self.eval(target, env), val)
        self._store(target, val, env)
        return val

    def _store(self, target: Any, val: Any, env: _Env) -> None:
        if target[0] == "name":
            env.assign(target[1], val)
            return
        if target[0] == "member":
            obj = self.eval(target[1], env)
            key = self.eval(target[2], env)
            if isinstance(obj, _JsProto):
                obj.cls.proto_fns[key] = val
                return
            if isinstance(obj, dict):
                obj[key] = val
                return
            if isinstance(obj, list) and isinstance(key, (int, float)):
                i = int(key)
                if 0 <= i < len(obj):
                    obj[i] = val
                    return
                if i == len(obj):
                    obj.append(val)
                    return
                raise MiniJsError("sparse array assignment unsupported")
        raise MiniJsError("invalid assignment target")

    def eval_bin(self, opr: str, le: Any, re_: Any, env: _Env) -> Any:
        if opr == "&&":
            lv = self.eval(le, env)
            return self.eval(re_, env) if _truthy(lv) else lv
        if opr == "||":
            lv = self.eval(le, env)
            return lv if _truthy(lv) else self.eval(re_, env)
        if opr == "??":
            lv = self.eval(le, env)
            return self.eval(re_, env) if lv is None or lv is _UNDEFINED else lv
        return self._bin_vals(opr, self.eval(le, env), self.eval(re_, env))

    def _bin_vals(self, opr: str, lv: Any, rv: Any) -> Any:
        if opr == "+":
            if isinstance(lv, str) or isinstance(rv, str):
                return _js_str(lv) + _js_str(rv)
            return self._num(lv) + self._num(rv)
        if opr in ("==", "==="):
            return self._eq(lv, rv)
        if opr in ("!=", "!=="):
            return not self._eq(lv, rv)
        if opr in ("<", "<=", ">", ">="):
            if isinstance(lv, str) and isinstance(rv, str):
                pass
            else:
                lv, rv = self._num(lv), self._num(rv)
            return {
                "<": lv < rv, "<=": lv <= rv, ">": lv > rv, ">=": lv >= rv,
            }[opr]
        if opr == "instanceof":
            if not isinstance(rv, _JsClass):
                raise MiniJsError("instanceof needs a class")
            if not isinstance(lv, _JsObject):
                return False
            c: Optional[_JsClass] = lv.cls
            while c is not None:
                if c is rv:
                    return True
                c = c.parent
            return False
        if opr == "in":
            if isinstance(rv, dict):
                return _js_str(lv) in rv
            if isinstance(rv, list):
                if lv == "length":
                    return True
                try:
                    n = self._num(lv)
                except MiniJsError:
                    return False  # non-numeric property name on an array
                return float(n).is_integer() and 0 <= int(n) < len(rv)
            raise MiniJsError("'in' needs an object or array")
        if opr in ("&", "|", "^", "<<", ">>", ">>>"):
            a32, b32 = self._to_i32(lv), self._to_i32(rv)
            if opr == "&":
                r = a32 & b32
            elif opr == "|":
                r = a32 | b32
            elif opr == "^":
                r = a32 ^ b32
            elif opr == "<<":
                r = (a32 << (b32 & 31)) & 0xFFFFFFFF
            elif opr == ">>":
                return a32 >> (b32 & 31)
            else:  # >>> logical shift: unsigned result
                return (a32 & 0xFFFFFFFF) >> (b32 & 31)
            return r - 0x100000000 if r >= 0x80000000 else r
        a, b = self._num(lv), self._num(rv)
        if opr == "-":
            return a - b
        if opr == "*":
            return a * b
        if opr == "**":
            try:
                r = a ** b
            except (OverflowError, ZeroDivisionError) as ex:
                raise MiniJsError(f"** overflow: {ex}")
            if isinstance(r, complex):  # (-8) ** 0.5: JS gives NaN
                raise MiniJsError("** of negative base with fractional "
                                  "exponent (JS would give NaN)")
            return r
        if opr == "/":
            if b == 0:
                raise MiniJsError("division by zero")
            return a / b
        if opr == "%":
            return a % b
        raise MiniJsError(f"unsupported operator {opr}")

    def _to_i32(self, v: Any) -> int:
        """JS ToInt32: wrap the numeric value into signed 32-bit."""
        n = self._num(v)
        if n != n or n in (float("inf"), float("-inf")):
            return 0
        r = int(n) & 0xFFFFFFFF
        return r - 0x100000000 if r >= 0x80000000 else r

    def _switch_match(self, a: Any, b: Any) -> bool:
        """switch uses STRICT equality: undefined and null do not match
        each other (unlike the loose leg of _eq)."""
        if (a is _UNDEFINED) != (b is _UNDEFINED):
            return False
        if (a is None) != (b is None):
            return False
        return self._eq(a, b)

    @staticmethod
    def _eq(a: Any, b: Any) -> bool:
        if (a is _UNDEFINED or a is None) and (b is _UNDEFINED or b is None):
            return True
        if isinstance(a, bool) or isinstance(b, bool):
            return a is b
        return a == b

    def eval_member(self, e: Any, env: _Env) -> Any:
        obj = self.eval(e[1], env)
        optional = e[3]
        if obj is _UNDEFINED or obj is None:
            if optional:
                return _UNDEFINED
            raise MiniJsError("member access on null/undefined")
        key = self.eval(e[2], env)
        return self._member_value(obj, key)

    def _member_value(self, obj: Any, key: Any) -> Any:
        """Property lookup on an already-evaluated receiver (shared by
        eval_member and the call path, which needs the receiver for
        dynamic `this` binding)."""
        if isinstance(obj, _JsClass):
            if key == "prototype":
                return _JsProto(obj)
            m = obj.statics.get(key)
            if m is not None:
                return ("boundm", None, m, obj)
            return _UNDEFINED
        if isinstance(obj, _JsProto):
            v, found = obj.cls.find_proto(key)
            if found:
                return v
            m, owner = obj.cls.find_method(key)
            if m is not None:
                return ("boundm", None, m, owner)
            return _UNDEFINED
        if isinstance(obj, _JsGenerator):
            return ("method", obj, key)
        if isinstance(obj, _JsPromise):
            return ("method", obj, key)
        if isinstance(obj, _JsRegex):
            if key == "source":
                return obj.source
            if key == "flags":
                return obj.flags_js
            if key == "global":
                return obj.g
            return ("method", obj, key)
        if isinstance(obj, _JsObject):
            if key in obj:
                return obj[key]
            v, found = obj.cls.find_proto(key)
            if found:
                return v
            m, owner = obj.cls.find_method(key)
            if m is not None:
                return ("boundm", obj, m, owner)
            g, gowner = obj.cls.find_getter(key)
            if g is not None:
                return self._call_body(
                    g[0], g[1], gowner.env, [],
                    this=obj, superclass=gowner.parent,
                )
            return _UNDEFINED
        if isinstance(obj, dict):
            v = obj.get(key, _UNDEFINED)
            if isinstance(v, tuple) and v and v[0] == "jsgetter":
                return self.call_closure(v[1], [], this=obj)
            if v is _UNDEFINED and key == "hasOwnProperty":
                return ("method", obj, key)
            return v
        if isinstance(obj, list):
            if key == "length":
                return len(obj)
            if isinstance(key, (int, float)):
                i = int(key)
                return obj[i] if 0 <= i < len(obj) else _UNDEFINED
            return ("method", obj, key)
        if isinstance(obj, str):
            if key == "length":
                return len(obj)
            return ("method", obj, key)
        if isinstance(obj, (int, float)) and not isinstance(obj, bool):
            return ("method", obj, key)
        raise MiniJsError(f"cannot access {key!r} on {type(obj).__name__}")

    # method/function calls
    def _spread_items(self, v: Any) -> List[Any]:
        if isinstance(v, (list, str)):
            return list(v)
        if isinstance(v, _JsGenerator):
            return v.drain()
        raise MiniJsError("spread needs an iterable")

    def eval_call(self, e: Any, env: _Env) -> Any:
        callee = e[1]
        args = []
        for a in e[2]:
            if a[0] == "spread":
                args.extend(self._spread_items(self.eval(a[1], env)))
            else:
                args.append(self.eval(a, env))
        # global builtins: Object.keys(x), JSON.stringify(x), ...
        if callee[0] == "member" and callee[1][0] == "name":
            base = callee[1][1]
            key_e = callee[2]
            key = key_e[1] if key_e[0] == "lit" else self.eval(key_e, env)
            if base == "Object" and key in ("keys", "values", "entries"):
                (o,) = args
                if not isinstance(o, dict):
                    raise MiniJsError("Object.* needs an object")
                if key == "keys":
                    return list(o.keys())
                if key == "values":
                    return [self._member_value(o, k) for k in o.keys()]
                return [[k, self._member_value(o, k)] for k in o.keys()]
            if base == "Object" and key == "assign":
                if not args or not isinstance(args[0], dict):
                    raise MiniJsError("Object.assign needs an object target")
                tgt = args[0]
                for src in args[1:]:
                    if isinstance(src, dict):
                        self._merge_own(tgt, src)
                return tgt
            if base == "Object" and key == "freeze":
                # sandbox subset: identity (immutability not enforced —
                # plain dicts back JS objects; V8 returns the object)
                return args[0] if args else _UNDEFINED
            if base == "Object" and key == "hasOwn":
                o = args[0] if args else None
                if not isinstance(o, dict):
                    raise MiniJsError("Object.hasOwn needs an object")
                return (args[1] if len(args) > 1 else None) in o
            if base == "Object" and key == "fromEntries":
                src = args[0] if args else None
                if isinstance(src, _JsGenerator):
                    src = src.drain()
                if not isinstance(src, list):
                    raise MiniJsError("Object.fromEntries needs pairs")
                out_o: Dict[str, Any] = {}
                for pair in src:
                    if not isinstance(pair, list) or len(pair) < 2:
                        raise MiniJsError("Object.fromEntries needs pairs")
                    out_o[_js_str(pair[0])] = pair[1]
                return out_o
            if base == "Promise":
                if key == "resolve":
                    v = args[0] if args else _UNDEFINED
                    return (v if isinstance(v, _JsPromise)
                            else _JsPromise("fulfilled", v))
                if key == "reject":
                    return _JsPromise(
                        "rejected", args[0] if args else _UNDEFINED
                    )
                if key in ("all", "allSettled", "race"):
                    src = args[0] if args else None
                    if isinstance(src, _JsGenerator):
                        src = src.drain()
                    if not isinstance(src, list):
                        raise MiniJsError(f"Promise.{key} needs an array")
                    settled = []
                    for it in src:
                        if isinstance(it, _JsPromise):
                            if it.state == "pending":
                                raise MiniJsError(
                                    "pending promise (real async IO is "
                                    "outside the eager MiniJS subset; "
                                    "node tier)"
                                )
                            settled.append((it.state, it.value))
                        else:
                            settled.append(("fulfilled", it))
                    if key == "race":
                        if not settled:
                            raise MiniJsError(
                                "Promise.race of an empty array never "
                                "settles"
                            )
                        return _JsPromise(*settled[0])
                    if key == "allSettled":
                        return _JsPromise("fulfilled", [
                            {"status": st, "value": v} if st == "fulfilled"
                            else {"status": st, "reason": v}
                            for st, v in settled
                        ])
                    for st, v in settled:  # all
                        if st == "rejected":
                            return _JsPromise("rejected", v)
                    return _JsPromise(
                        "fulfilled", [v for _, v in settled]
                    )
                raise MiniJsError(f"unsupported Promise.{key}")
            if base == "JSON" and key == "stringify":
                return json.dumps(_strip_undefined(self.resolve_data(args[0])))
            if base == "JSON" and key == "parse":
                return json.loads(args[0])
            if base == "Number" and key in (
                "isInteger", "isFinite", "isNaN", "parseInt", "parseFloat",
            ):
                v = args[0] if args else _UNDEFINED
                if key == "isInteger":
                    return (
                        isinstance(v, (int, float))
                        and not isinstance(v, bool)
                        and float(v).is_integer()
                    )
                if key == "isFinite":
                    return (
                        isinstance(v, (int, float))
                        and not isinstance(v, bool)
                        and v == v
                        and v not in (float("inf"), float("-inf"))
                    )
                if key == "isNaN":
                    return isinstance(v, float) and v != v
                if key == "parseInt":
                    radix = (
                        int(self._num(args[1]))
                        if len(args) > 1 and args[1] else 0
                    )
                    return _parse_int(v, radix)
                return _parse_float(v)
            if base == "String" and key == "fromCharCode":
                try:
                    return "".join(chr(int(self._num(a))) for a in args)
                except (ValueError, OverflowError) as ex:
                    raise MiniJsError(f"String.fromCharCode: {ex}")
            if base == "Array" and key == "isArray":
                return isinstance(args[0], list)
            if base == "Array" and key == "from":
                src = args[0] if args else _UNDEFINED
                if isinstance(src, _JsGenerator):
                    return src.drain()
                if isinstance(src, (list, str)):
                    return list(src)
                raise MiniJsError("Array.from needs an iterable")
            if base == "Math":
                fn = _MATH_FNS.get(key)
                if fn is None:
                    raise MiniJsError(f"unsupported Math.{key}")
                try:
                    return fn(*[self._num(a) for a in args])
                except (ValueError, OverflowError, TypeError) as ex:
                    raise MiniJsError(f"Math.{key}: {ex}")
            if base == "super":
                # super.m(...) — parent method with the current `this`
                sup = env.get("__superclass__")
                if not isinstance(sup, _JsClass):
                    raise MiniJsError("super outside a subclass method")
                m, owner = sup.find_method(key)
                if m is None:
                    raise MiniJsError(f"no super method {key}")
                return self._call_body(
                    m[0], m[1], owner.env, args,
                    this=env.get("this"), superclass=owner.parent,
                )
        if callee[0] == "name" and callee[1] == "super":
            # super(...) — parent constructor on the current `this`
            sup = env.get("__superclass__")
            if not isinstance(sup, _JsClass):
                raise MiniJsError("super outside a subclass method")
            found = sup.find_ctor()
            if found[0] is not None:
                (params, body), owner = found
                self._call_body(
                    params, body, owner.env, args,
                    this=env.get("this"), superclass=owner.parent,
                )
            return _UNDEFINED
        if callee[0] == "name" and callee[1] in ("String", "Number", "Boolean"):
            (v,) = args or [_UNDEFINED]
            if callee[1] == "String":
                return _js_str(v)
            if callee[1] == "Number":
                return self._num(v)
            return _truthy(v)
        if callee[0] == "name" and callee[1] in (
            "parseInt", "parseFloat", "isNaN", "isFinite",
        ):
            v = args[0] if args else _UNDEFINED
            if callee[1] == "parseInt":
                radix = (
                    int(self._num(args[1]))
                    if len(args) > 1 and args[1] else 0
                )
                return _parse_int(v, radix)
            if callee[1] == "parseFloat":
                return _parse_float(v)
            if callee[1] == "isNaN":
                try:
                    n = self._num(v)
                except MiniJsError:
                    return True
                return n != n
            try:  # isFinite
                n = self._num(v)
            except MiniJsError:
                return False
            return n == n and n not in (float("inf"), float("-inf"))
        if callee[0] == "member":
            # evaluate the receiver once so obj.fn(...) binds dynamic
            # `this` to obj for function-expression values (V8 method
            # call semantics; arrows keep lexical `this`)
            obj = self.eval(callee[1], env)
            if obj is _UNDEFINED or obj is None:
                if callee[3]:
                    return _UNDEFINED
                raise MiniJsError("member access on null/undefined")
            mkey = self.eval(callee[2], env)
            target = self._member_value(obj, mkey)
            this_v = obj if isinstance(obj, dict) else None
            return self._invoke(target, args, this=this_v)
        target = self.eval(callee, env)
        return self._invoke(target, args)

    def _invoke(
        self, fn: Any, args: List[Any], this: Any = None,
        what: str = "call target",
    ) -> Any:
        """Dispatch any callable runtime value (closure, builtin method,
        bound class method, native seam)."""
        if isinstance(fn, tuple) and fn:
            if fn[0] == "closure":
                return self.call_closure(fn, args, this=this)
            if fn[0] == "method":
                return self.call_method(fn[1], fn[2], args)
            if fn[0] == "boundm":
                _, this_v, (params, body), owner = fn
                return self._call_body(
                    params, body, owner.env, args,
                    this=this_v if this_v is not None else this,
                    superclass=owner.parent,
                )
            if fn[0] == "native":
                return fn[1](args)
        raise MiniJsError(f"{what} is not a function")

    def _new_promise(self, arg_nodes: List[Any], env: _Env) -> Any:
        """`new Promise((resolve, reject) => ...)` — the executor runs
        synchronously; first settle wins (V8), resolve adopts a promise
        argument's state."""
        args = [self.eval(a, env) for a in arg_nodes]
        if not args:
            raise MiniJsError("new Promise needs an executor")
        cell = _JsPromise("pending", _UNDEFINED)

        def _settle(state: str):
            def run(cargs: List[Any]) -> Any:
                if cell.state == "pending":
                    v = cargs[0] if cargs else _UNDEFINED
                    if state == "fulfilled" and isinstance(v, _JsPromise):
                        cell.state, cell.value = v.state, v.value
                    else:
                        cell.state, cell.value = state, v
                return _UNDEFINED
            return run

        try:
            self._invoke(
                args[0],
                [("native", _settle("fulfilled")),
                 ("native", _settle("rejected"))],
                what="Promise executor",
            )
        except _Throw as th:
            if cell.state == "pending":
                cell.state, cell.value = "rejected", th.value
        return cell

    def bind_pattern(self, tgt: Any, v: Any, env: _Env) -> None:
        """Bind a destructuring target (parse_binding_target node) against
        a value, recursing through nested patterns; defaults apply on
        undefined (not null), rest entries collect the remainder — the V8
        semantics over JSON-shaped values."""
        kind = tgt[0]
        if kind == "bname":
            env.set(tgt[1], v)
            return
        if kind == "opat":
            _, entries, rest = tgt
            if not isinstance(v, dict):
                raise MiniJsError("cannot destructure a non-object")
            used = set()
            for key, sub, default in entries:
                used.add(key)
                val = v.get(key, _UNDEFINED)
                if val is _UNDEFINED and default is not None:
                    val = self.eval(default, env)
                self.bind_pattern(sub, val, env)
            if rest is not None:
                env.set(rest, {k: x for k, x in v.items() if k not in used})
            return
        # apat
        _, elems, rest = tgt
        if isinstance(v, str):
            seq: List[Any] = list(v)
        elif isinstance(v, list):
            seq = v
        elif isinstance(v, _JsGenerator):
            seq = v.drain()
        else:
            raise MiniJsError("cannot destructure a non-iterable")
        for i, ent in enumerate(elems):
            if ent is None:  # elision hole
                continue
            sub, default = ent
            val = seq[i] if i < len(seq) else _UNDEFINED
            if val is _UNDEFINED and default is not None:
                val = self.eval(default, env)
            self.bind_pattern(sub, val, env)
        if rest is not None:
            env.set(rest, list(seq[len(elems):]))

    def _cb(self, fn: Any, *cb_args: Any) -> Any:
        """Invoke a user callback with JS-style (value, index, array)
        arguments; extra args bind to _UNDEFINED in shorter signatures."""
        return self._invoke(fn, list(cb_args), what="callback")

    def _sort(self, obj: List[Any], cmp: Any) -> List[Any]:
        import functools as _ft

        if cmp is None:
            # JS default sort: lexicographic over string conversions
            obj.sort(key=_js_str)
        else:
            def _c(a: Any, b: Any) -> int:
                r = self._num(self._cb(cmp, a, b))
                return -1 if r < 0 else (1 if r > 0 else 0)

            obj.sort(key=_ft.cmp_to_key(_c))
        return obj

    def _reduce(self, obj: List[Any], args: List[Any]) -> Any:
        cb = args[0] if args else None
        if len(args) > 1:
            acc, start = args[1], 0
        elif obj:
            acc, start = obj[0], 1
        else:
            raise MiniJsError("reduce of empty array with no initial value")
        for i in range(start, len(obj)):
            acc = self._cb(cb, acc, obj[i], i, obj)
        return acc

    def call_closure(
        self, closure: Tuple, args: List[Any], this: Any = None
    ) -> Any:
        _, params, body, defenv, is_gen, binds_this, is_async = closure
        eff_this = this if (binds_this and this is not None) else None
        if is_gen:
            # function*: lazy — nothing runs until .next()/iteration
            g = _JsGenerator(self, params, body, defenv, args, eff_this)
            self._gens.append(g)
            return g
        if is_async:
            # eager subset: the body runs synchronously; a throw settles
            # the returned promise as rejected (V8 async semantics)
            try:
                ret = self._call_body(
                    params, body, defenv, args, this=eff_this
                )
            except _Throw as th:
                return _JsPromise("rejected", th.value)
            return (ret if isinstance(ret, _JsPromise)
                    else _JsPromise("fulfilled", ret))
        return self._call_body(params, body, defenv, args, this=eff_this)

    def _emit_yield(self, gen: "_JsGenerator", v: Any) -> Any:
        """Runs ON the generator's worker thread: hand the yielded value
        to the consumer and block until the next .next(sent) resumes us
        (or teardown unwinds the body)."""
        gen.outq.put(("yield", v))
        msg = gen.inq.get()
        if msg[0] == "kill":
            raise _GenKill()
        if msg[0] == "throw":  # gen.throw(v) resumes as a throw here
            raise _Throw(msg[1])
        return msg[1]

    def _call_body(
        self, params, body, defenv, args, this=None, superclass=None,
        gen=None,
    ):
        # depth is PER-THREAD (each lazy-generator body has its own stack;
        # a suspended generator stays inside _call_body on its worker
        # thread, and must not eat into the caller's recursion budget).
        # steps stay shared: the cross-thread total bounds the hook.
        depth = getattr(self._tl, "depth", 0) + 1
        if depth > self.MAX_DEPTH:
            # budget violations are MiniJsFatal: a user-level try/catch
            # must not swallow the recursion kill and restart the recursion
            raise MiniJsFatal("call depth exhausted (runaway recursion)")
        self._tl.depth = depth
        env = _Env(defenv)
        ai = 0
        for p in params:
            if isinstance(p, str):
                env.set(p, args[ai] if ai < len(args) else _UNDEFINED)
                ai += 1
            elif p[0] == "rest":
                env.set(p[1], list(args[ai:]))
                ai = len(args)
            else:  # ("p", target, default)
                _, tgt, default = p
                v = args[ai] if ai < len(args) else _UNDEFINED
                ai += 1
                if v is _UNDEFINED and default is not None:
                    v = self.eval(default, env)
                self.bind_pattern(tgt, v, env)
        if this is not None:
            env.set("this", this)
            env.set("__superclass__", superclass)
        # every function body gets its own generator frame (None for
        # non-generators), so yield inside a nested plain function or
        # method cannot leak into an enclosing generator — matching V8,
        # where that is a SyntaxError
        st = self._gen_stack()
        st.append(gen)
        try:
            self.run_block(body, env)
            return _UNDEFINED
        except _Return as r:
            return r.value
        finally:
            st.pop()
            self._tl.depth = depth - 1

    def _merge_own(self, dst: Dict[str, Any], src: Dict[str, Any]) -> None:
        """{...src} / Object.assign: getters are evaluated at copy time
        (V8 spreads data values, not accessor descriptors)."""
        for k in list(src.keys()):
            x = src[k]
            if isinstance(x, tuple) and x and x[0] == "jsgetter":
                x = self.call_closure(x[1], [], this=src)
            dst[k] = x

    def resolve_data(self, v: Any, _depth: int = 0) -> Any:
        """Materialize a runtime value into plain JSON-shaped data:
        unwrap settled promises (rejected -> user-level throw), evaluate
        object-literal getters against their owning object. Used for
        JSON.stringify and the final hook result."""
        self.tick()
        if _depth > 64:
            raise MiniJsError("value nesting too deep to materialize")
        if isinstance(v, _JsPromise):
            if v.state == "rejected":
                raise _Throw(v.value)
            if v.state == "pending":
                raise MiniJsError(
                    "pending promise in result (real async IO is outside "
                    "the eager MiniJS subset; node tier)"
                )
            return self.resolve_data(v.value, _depth + 1)
        if isinstance(v, list):
            return [self.resolve_data(x, _depth + 1) for x in v]
        if isinstance(v, dict):
            out: Dict[str, Any] = {}
            for k in list(v.keys()):
                x = v[k]
                if isinstance(x, tuple) and x and x[0] == "jsgetter":
                    x = self.call_closure(x[1], [], this=v)
                out[k] = self.resolve_data(x, _depth + 1)
            return out
        if isinstance(v, (tuple, _JsClass)):
            # functions/bound methods/classes: JSON.stringify omits them
            # from objects, nulls them in arrays, undefined bare (V8);
            # _strip_undefined applies exactly that to this marker. Also
            # keeps interpreter internals (closures carry _Env) from
            # leaking into engine-facing hook results.
            return _UNDEFINED
        if isinstance(v, (_JsRegex, _JsGenerator, _JsProto)):
            # objects with no own enumerable properties -> {} (V8)
            return {}
        return v

    def call_method(self, obj: Any, name: str, args: List[Any]) -> Any:
        self.tick()
        if isinstance(obj, _JsPromise):
            if obj.state == "pending":
                raise MiniJsError(
                    "pending promise (real async IO is outside the eager "
                    "MiniJS subset; node tier)"
                )
            if name == "finally":
                if args and args[0] is not None:
                    self._invoke(args[0], [], what="finally callback")
                return obj
            if name == "then":
                onf = args[0] if args else None
                onr = args[1] if len(args) > 1 else None
            elif name == "catch":
                onf = None
                onr = args[0] if args else None
            else:
                raise MiniJsError(f"unsupported promise method {name!r}")
            cb = onf if obj.state == "fulfilled" else onr
            if cb is None or cb is _UNDEFINED:
                return obj
            try:
                v = self._invoke(cb, [obj.value], what="then callback")
            except _Throw as th:
                return _JsPromise("rejected", th.value)
            return (v if isinstance(v, _JsPromise)
                    else _JsPromise("fulfilled", v))
        if isinstance(obj, _JsGenerator):
            if name == "next":
                return obj.next_result(args[0] if args else _UNDEFINED)
            if name == "return":
                return obj.close(args[0] if args else _UNDEFINED)
            if name == "throw":
                return obj.throw_result(
                    args[0] if args else _UNDEFINED
                )
            raise MiniJsError(f"unsupported generator method {name!r}")
        if isinstance(obj, str):
            table: Dict[str, Callable] = {
                "toLowerCase": lambda: obj.lower(),
                "toUpperCase": lambda: obj.upper(),
                "trim": lambda: obj.strip(),
                "includes": lambda: args[0] in obj,
                "startsWith": lambda: obj.startswith(args[0]),
                "endsWith": lambda: obj.endswith(args[0]),
                "split": lambda: (
                    args[0].rx.split(obj)
                    if args and isinstance(args[0], _JsRegex)
                    else obj.split(args[0]) if args else [obj]
                ),
                "slice": lambda: obj[_slice(args, len(obj))],
                "concat": lambda: obj + "".join(_js_str(a) for a in args),
                "replace": lambda: (
                    args[0].rx.sub(
                        args[0].repl_py(args[1]), obj,
                        count=0 if args[0].g else 1,
                    )
                    if isinstance(args[0], _JsRegex)
                    else obj.replace(args[0], args[1], 1)
                ),
                "replaceAll": lambda: (
                    args[0].rx.sub(args[0].repl_py(args[1]), obj)
                    if isinstance(args[0], _JsRegex)
                    else obj.replace(args[0], args[1])
                ),
                "match": lambda: _str_match(obj, args[0]),
                "search": lambda: (
                    (lambda m: m.start() if m else -1)(args[0].rx.search(obj))
                    if isinstance(args[0], _JsRegex)
                    else obj.find(args[0])
                ),
                "indexOf": lambda: obj.find(args[0]),
                "lastIndexOf": lambda: obj.rfind(args[0]),
                "charAt": lambda: obj[int(args[0])] if 0 <= int(args[0]) < len(obj) else "",
                "charCodeAt": lambda: _char_code_at(
                    obj, int(args[0]) if args else 0
                ),
                "at": lambda: _at(obj, self._num(args[0]) if args else 0),
                "padStart": lambda: _pad(
                    obj, int(args[0]),
                    _js_str(args[1]) if len(args) > 1 else " ", True
                ),
                "padEnd": lambda: _pad(
                    obj, int(args[0]),
                    _js_str(args[1]) if len(args) > 1 else " ", False
                ),
                "repeat": lambda: obj * max(int(args[0]), 0),
                "substring": lambda: _substring(obj, args),
                "trimStart": lambda: obj.lstrip(),
                "trimEnd": lambda: obj.rstrip(),
                "codePointAt": lambda: (
                    ord(obj[int(args[0]) if args else 0])
                    if 0 <= (int(args[0]) if args else 0) < len(obj)
                    else _UNDEFINED
                ),
                "normalize": lambda: __import__("unicodedata").normalize(
                    _js_str(args[0]) if args else "NFC", obj
                ),
                "localeCompare": lambda: (
                    -1 if obj < _js_str(args[0])
                    else (1 if obj > _js_str(args[0]) else 0)
                ),
                "matchAll": lambda: _match_all(obj, args[0] if args else None),
            }
        elif isinstance(obj, list):
            table = {
                "includes": lambda: args[0] in obj,
                "indexOf": lambda: obj.index(args[0]) if args[0] in obj else -1,
                "join": lambda: _js_str(args[0] if args else ",").join(
                    _js_str(x) for x in obj
                ),
                "slice": lambda: obj[_slice(args, len(obj))],
                "concat": lambda: obj + (args[0] if args and isinstance(args[0], list) else list(args)),
                "flat": lambda: _flat_depth(
                    obj, self._num(args[0]) if args else 1
                ),
                "flatMap": lambda: _flat(
                    [self._cb(args[0], x, i, obj) for i, x in enumerate(obj)]
                ),
                "push": lambda: (obj.extend(args), len(obj))[1],
                "pop": lambda: obj.pop() if obj else _UNDEFINED,
                "shift": lambda: obj.pop(0) if obj else _UNDEFINED,
                "unshift": lambda: (obj.__setitem__(
                    slice(0, 0), list(args)
                ), len(obj))[1],
                "reverse": lambda: (obj.reverse(), obj)[1],
                "sort": lambda: self._sort(obj, args[0] if args else None),
                "at": lambda: _at(obj, self._num(args[0]) if args else 0),
                "lastIndexOf": lambda: (
                    len(obj) - 1 - obj[::-1].index(args[0])
                    if args[0] in obj else -1
                ),
                # callbacks receive (value, index, array), as in JS
                "filter": lambda: [
                    x for i, x in enumerate(obj)
                    if _truthy(self._cb(args[0], x, i, obj))
                ],
                "map": lambda: [
                    self._cb(args[0], x, i, obj) for i, x in enumerate(obj)
                ],
                "forEach": lambda: (
                    [self._cb(args[0], x, i, obj)
                     for i, x in enumerate(obj)],
                    _UNDEFINED,
                )[1],
                "find": lambda: next(
                    (x for i, x in enumerate(obj)
                     if _truthy(self._cb(args[0], x, i, obj))),
                    _UNDEFINED,
                ),
                "findIndex": lambda: next(
                    (i for i, x in enumerate(obj)
                     if _truthy(self._cb(args[0], x, i, obj))),
                    -1,
                ),
                "some": lambda: any(
                    _truthy(self._cb(args[0], x, i, obj))
                    for i, x in enumerate(obj)
                ),
                "every": lambda: all(
                    _truthy(self._cb(args[0], x, i, obj))
                    for i, x in enumerate(obj)
                ),
                "reduce": lambda: self._reduce(obj, args),
                "findLast": lambda: next(
                    (x for i, x in reversed(list(enumerate(obj)))
                     if _truthy(self._cb(args[0], x, i, obj))),
                    _UNDEFINED,
                ),
                "findLastIndex": lambda: next(
                    (i for i, x in reversed(list(enumerate(obj)))
                     if _truthy(self._cb(args[0], x, i, obj))),
                    -1,
                ),
                "splice": lambda: _splice(
                    obj, [self._num(a) for a in args[:2]], list(args[2:])
                ),
                "fill": lambda: _fill(
                    obj, args[0] if args else _UNDEFINED,
                    [self._num(a) for a in args[1:3]],
                ),
                # V8 returns iterators; lists behave identically under
                # for..of / spread / destructuring in this subset
                "entries": lambda: [[i, x] for i, x in enumerate(obj)],
                "keys": lambda: list(range(len(obj))),
                "values": lambda: list(obj),
            }
        elif isinstance(obj, _JsRegex):
            table = {
                "test": lambda: obj.rx.search(args[0]) is not None,
                "exec": lambda: (
                    (lambda m: _JsRegex._match_array(m) if m else None)(
                        obj.rx.search(args[0])
                    )
                ),
            }
        elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
            table = {
                "toFixed": lambda: (
                    f"{float(obj):.{int(args[0]) if args else 0}f}"
                ),
                "toString": lambda: _js_str(obj),
                "toPrecision": lambda: (
                    _js_str(obj) if not args
                    else _to_precision(float(obj), int(self._num(args[0])))
                ),
            }
        elif isinstance(obj, dict):
            table = {
                "hasOwnProperty": lambda: (
                    (args[0] if args else None) in obj
                ),
            }
        else:
            raise MiniJsError(f"no methods on {type(obj).__name__}")
        fn = table.get(name)
        if fn is None:
            raise MiniJsError(f"unsupported method .{name}()")
        try:
            return fn()
        except MiniJsError:
            raise
        except (_Return, _Break, _Continue, _Throw):
            raise  # control flow from user callbacks must propagate
        except (ValueError, TypeError, IndexError, KeyError,
                OverflowError) as ex:
            # bad arguments to a builtin must stay inside the MiniJsError
            # contract (hooks.py's tier fallback only catches MiniJs*)
            raise MiniJsError(f".{name}(): {ex}")


def _str_match(s: str, pat: Any) -> Any:
    """JS String.match: with g, all full-match strings (or null); without,
    an exec-style array for the first match (or null)."""
    if not isinstance(pat, _JsRegex):
        pat = _JsRegex(f"/{re.escape(str(pat))}/")
    if pat.g:
        out = [m.group(0) for m in pat.rx.finditer(s)]
        return out or None
    m = pat.rx.search(s)
    return _JsRegex._match_array(m) if m else None


def _slice(args: List[Any], n: int):
    a = int(args[0]) if args else 0
    b = int(args[1]) if len(args) > 1 else n
    return slice(a, b)


def _flat(xs: List[Any]) -> List[Any]:
    """One level of flattening (JS .flat() default / flatMap)."""
    out: List[Any] = []
    for x in xs:
        out.extend(x) if isinstance(x, list) else out.append(x)
    return out


def _flat_depth(xs: List[Any], depth: float) -> List[Any]:
    """JS Array.prototype.flat(depth) — Infinity flattens fully."""
    out = list(xs)
    d = depth
    while d >= 1 and any(isinstance(x, list) for x in out):
        out = _flat(out)
        d -= 1
    return out


def _at(xs, i) -> Any:
    """JS Array/String.prototype.at: negative indexes from the end."""
    i = int(i)
    n = len(xs)
    if i < 0:
        i += n
    return xs[i] if 0 <= i < n else _UNDEFINED


def _pad(s: str, width: int, fill: str, start: bool) -> str:
    """JS padStart/padEnd: multi-char fill repeats then truncates."""
    if not fill or width <= len(s):
        return s
    need = width - len(s)
    pad = (fill * (need // len(fill) + 1))[:need]
    return pad + s if start else s + pad


def _char_code_at(s: str, i: int) -> Any:
    if 0 <= i < len(s):
        return ord(s[i])
    raise MiniJsError("charCodeAt index out of range (JS would give NaN)")


def _parse_int(v: Any, radix: int) -> Any:
    """JS parseInt: leading-prefix parse; radix 0 = auto (0x prefix ->
    16, else 10, per spec). NaN-producing inputs raise (the JSON value
    model has no NaN)."""
    s = _js_str(v).strip()
    neg = s.startswith("-")
    if s[:1] in "+-":
        s = s[1:]
    if radix in (0, 16) and s[:2].lower() == "0x":
        s = s[2:]
        radix = 16
    elif radix == 0:
        radix = 10
    if not 2 <= radix <= 36:
        raise MiniJsError(f"parseInt radix {radix} out of range")
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:radix]
    i = 0
    while i < len(s) and s[i].lower() in digits:
        i += 1
    if i == 0:
        raise MiniJsError(f"parseInt({v!r}): no digits (JS would give NaN)")
    n = int(s[:i], radix)
    return -n if neg else n


def _parse_float(v: Any) -> Any:
    s = _js_str(v).strip()
    m = re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    if not m:
        raise MiniJsError(f"parseFloat({v!r}): no number (JS would give NaN)")
    f = float(m.group(0))
    return int(f) if f.is_integer() else f


def _substring(s: str, args: List[Any]) -> str:
    """JS substring: clamps to [0, len], swaps out-of-order bounds."""
    n = len(s)
    a = min(max(int(args[0]) if args else 0, 0), n)
    b = min(max(int(args[1]) if len(args) > 1 else n, 0), n)
    if a > b:
        a, b = b, a
    return s[a:b]


def _splice(obj: List[Any], nums: List[float], items: List[Any]) -> List[Any]:
    """Array.prototype.splice: mutates, returns the removed slice."""
    n = len(obj)
    start = int(nums[0]) if nums else 0
    start = max(n + start, 0) if start < 0 else min(start, n)
    dc = int(nums[1]) if len(nums) > 1 else n - start
    dc = max(0, min(dc, n - start))
    removed = obj[start:start + dc]
    obj[start:start + dc] = items
    return removed


def _fill(obj: List[Any], value: Any, nums: List[float]) -> List[Any]:
    n = len(obj)
    start = int(nums[0]) if nums else 0
    start = max(n + start, 0) if start < 0 else min(start, n)
    end = int(nums[1]) if len(nums) > 1 else n
    end = max(n + end, 0) if end < 0 else min(end, n)
    for i in range(start, end):
        obj[i] = value
    return obj


def _match_all(s: str, pat: Any) -> List[Any]:
    if not isinstance(pat, _JsRegex):
        raise MiniJsError("matchAll needs a regex argument")
    if not pat.g:
        # V8 throws TypeError for a non-global regex
        raise MiniJsError("matchAll requires the /g flag")
    return [_JsRegex._match_array(m) for m in pat.rx.finditer(s)]


def _to_precision(x: float, p: int) -> str:
    if p < 1 or p > 100:
        raise MiniJsError("toPrecision argument out of range")
    out = f"{x:.{p}g}"
    # JS pads to exactly p significant digits (Python %g trims zeros)
    if "e" not in out and "E" not in out:
        digits = len(out.replace("-", "").replace(".", "").lstrip("0")) or 1
        if digits < p:
            if "." not in out:
                out += "."
            out += "0" * (p - digits)
    return out


def _strip_undefined(v: Any) -> Any:
    if v is _UNDEFINED:
        return None
    if isinstance(v, list):
        return [_strip_undefined(x) for x in v]
    if isinstance(v, dict):
        return {k: _strip_undefined(x) for k, x in v.items() if x is not _UNDEFINED}
    return v


def run_hook(code: str, fn_name: str, document: Dict[str, Any]) -> Any:
    """Parse ``code``, call ``fn_name(document)``, return the JSON-shaped
    result (undefined -> None). Raises MiniJsError on unsupported JS."""
    parser = _Parser(_tokenize(code))
    program = parser.parse_program()
    interp = _Interp()
    env = _Env()
    try:
        interp.run_block(program, env)
        fn = env.get(fn_name)
        if not (isinstance(fn, tuple) and fn and fn[0] == "closure"):
            raise MiniJsError(f"{fn_name} is not a function")
        result = interp.call_closure(fn, [document])
        # async hooks return a settled promise; getters materialize here
        result = interp.resolve_data(result)
    except _Throw as th:
        # an uncaught user-level `throw` is a per-document hook veto, not
        # an engine crash and not unsupported JS (engine/hooks.py skips
        # the doc's embedding instead of retrying on another tier)
        raise MiniJsThrow(_js_str(th.value)) from None
    except (_Break, _Continue):
        raise MiniJsError("break/continue outside a loop") from None
    finally:
        # unwind any generator worker threads the hook left suspended
        interp.close_generators()
    return _strip_undefined(result)
