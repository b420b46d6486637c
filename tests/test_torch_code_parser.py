"""The port's code parser (``orama_core_tpu_torch/nlp/code_parser.py`` and
``nlp/ts_lexer.py``) against the JAX package's.

tests/test_code_parser.py's 16 cases run against the port, unchanged but
for the package they import. Then every source in that file (its string
literals that hold code) goes through both packages' lexer and parser in
each language the file uses; the token lists and the strings
``flatten_for_index`` makes of them are equal."""

import pytest

from orama_core_tpu_torch.nlp.code_parser import (
    CodeParser,
    JsxElement,
    TokenKind,
    clean_comment,
    flatten_for_index,
)

P = CodeParser()


def kinds(tokens):
    return [t.kind for t in tokens]


# -- reference golden case 1 (mod.rs test_parser_simple1) --------------------

SIMPLE1 = """
// This is a comment
'use client'

import {
    foo,
    foo2
} from 'foo-package'

function myFunction() {
    if (foo) {
        return console.log("wow")
    } else {
        // Another comment
        return console.log("nope")
    }
}

export default function MyComponent({ children, todo }) {
    const [state, setState] = useState(0)
    return <div id="my-id">{children}</div>
}
"""


def test_reference_golden_1():
    toks = P.parse(SIMPLE1, "tsx")
    assert kinds(toks) == [
        TokenKind.COMMENT,
        TokenKind.IMPORT,
        TokenKind.FUNCTION,
        TokenKind.FUNCTION,
    ]
    assert toks[0].text == "This is a comment"
    imp = toks[1]
    assert imp.package == "foo-package"
    assert imp.identifiers == ("foo", "foo2")
    f1 = toks[2]
    assert f1.name == "myFunction"
    assert f1.comments == ("Another comment",)
    assert f1.params == ()
    assert f1.jsx == ()
    assert f1.identifiers == ("console", "console")
    f2 = toks[3]
    assert f2.name == "MyComponent"
    assert f2.params == ("children", "todo")
    assert f2.jsx == (JsxElement("div", ("id",)),)
    assert f2.identifiers == ("state", "setState", "useState")


# -- reference golden case 2 (nested JSX tree, import default) ---------------

SIMPLE2 = """
// In Next.js, this file would be called: app/layout.jsx
import Providers from './providers'

export default function RootLayout({ children }) {
    return (
    <html lang="en">
        <head />
        <body>
        <Providers>{children}</Providers>
        </body>
    </html>
    )
}"""


def test_reference_golden_2():
    toks = P.parse(SIMPLE2, "tsx")
    assert kinds(toks) == [TokenKind.COMMENT, TokenKind.IMPORT, TokenKind.FUNCTION]
    assert toks[1].package == "./providers"
    assert toks[1].identifiers == ("Providers",)
    f = toks[2]
    assert f.name == "RootLayout"
    assert f.params == ("children",)
    assert f.jsx == (
        JsxElement("html", ("lang",)),
        JsxElement("head", ()),
        JsxElement("body", ()),
        JsxElement("Providers", ()),
    )
    assert f.identifiers == ()


# -- reference golden case 3 (new expression: callee + property keys) --------

SIMPLE3 = """
function makeQueryClient() {
    return new QueryClient({
        defaultOptions: {
            queries: {
                staleTime: 60 * 1000,
            },
        },
    })
}
"""


def test_reference_golden_3():
    toks = P.parse(SIMPLE3, "tsx")
    assert kinds(toks) == [TokenKind.FUNCTION]
    f = toks[0]
    assert f.name == "makeQueryClient"
    assert f.identifiers == ("QueryClient", "defaultOptions", "queries", "staleTime")


# -- reference golden case 4 (calls: callee + object keys in args) -----------

SIMPLE4 = """
function getQueryClient() {
    if (isServer) {
        return makeQueryClient()
    } else {
        if (!browserQueryClient) browserQueryClient = makeQueryClient({ foo: 'bar'})
        return browserQueryClient
    }
}"""


def test_reference_golden_4():
    toks = P.parse(SIMPLE4, "tsx")
    f = toks[0]
    assert f.name == "getQueryClient"
    assert f.identifiers == ("makeQueryClient", "makeQueryClient", "foo")


# -- beyond the goldens -------------------------------------------------------


def test_global_lexical_and_jsx():
    code = """
const qc = makeQueryClient()
let theme = { mode: darkMode }
<App theme={theme} data-test="x" />
"""
    toks = P.parse(code, "tsx")
    idents = [t.text for t in toks if t.kind == TokenKind.GLOBAL_IDENTIFIER]
    # all plain identifiers in the declarations, incl. call callees
    # (reference handle_global_variable_declaration semantics)
    assert idents == ["qc", "makeQueryClient", "theme", "darkMode"]
    jsx = [t for t in toks if t.kind == TokenKind.GLOBAL_JSX]
    assert len(jsx) == 1
    assert jsx[0].jsx[0] == JsxElement("App", ("theme", "data-test"))


def test_params_full_coverage():
    code = """
function f(a, { b, c: renamed, d = 1 }, [e], ...rest) { return a }
function g(x: number, y?: string): void {}
"""
    toks = P.parse(code, "tsx")
    assert toks[0].params == ("a", "b", "renamed", "d", "e", "rest")
    assert toks[1].params == ("x", "y")


def test_arrow_and_generics_not_jsx():
    # `<` after an identifier is a generic/comparison, never JSX
    code = "function h() { const x = foo < bar; const y = baz(1) }"
    f = P.parse(code, "tsx")[0]
    assert f.jsx == ()
    assert "foo" in f.identifiers and "bar" in f.identifiers and "baz" in f.identifiers


def test_ts_mode_no_jsx():
    code = "function cast() { const v = <any>window; return v }"
    f = P.parse(code, "ts")[0]
    assert f.jsx == ()


def test_template_literals_and_regex_opaque():
    code = """
function t() {
    const s = `hello ${name} /not-a-regex/`
    const r = /ab[/]c/g
    const q = done / total
}
"""
    f = P.parse(code, "tsx")[0]
    # template/regex interiors don't leak identifiers; divisions survive
    assert "not" not in f.identifiers
    assert f.identifiers == ("s", "r", "q", "done", "total")


def test_nested_jsx_in_expression():
    code = """
function C({ ok }) {
    return <div>{ok && <span id="inner" />}</div>
}
"""
    f = P.parse(code, "tsx")[0]
    assert f.jsx == (JsxElement("div", ()), JsxElement("span", ("id",)))


def test_class_declaration():
    code = """
export class SearchClient extends Base {
    constructor(url) { this.url = url }
    search(term) { return this.post(term) }
}
"""
    toks = P.parse(code, "tsx")
    cls = [t for t in toks if t.kind == TokenKind.CLASS][0]
    assert cls.name == "SearchClient"
    assert "search" in cls.identifiers and "constructor" in cls.identifiers


def test_comment_cleanup():
    assert clean_comment("// hi there ") == "hi there"
    assert clean_comment("/* multi\n * line\n */") == "multi line"


def test_python_ast_mode():
    code = '''
import numpy as np
from os.path import join

# module comment
CONFIG = {"a": 1}

class Indexer:
    def build(self): pass
    def query(self): pass

def search(term, limit=10):
    """Find stuff."""
    scores = rank(term, k=limit)
    return scores
'''
    toks = P.parse(code, "py")
    by_kind = {}
    for t in toks:
        by_kind.setdefault(t.kind, []).append(t)
    assert [t.package for t in by_kind[TokenKind.IMPORT]] == ["numpy", "os.path"]
    assert by_kind[TokenKind.IMPORT][0].identifiers == ("np",)
    assert by_kind[TokenKind.CLASS][0].name == "Indexer"
    assert by_kind[TokenKind.CLASS][0].identifiers == ("build", "query")
    fn = by_kind[TokenKind.FUNCTION][0]
    assert fn.name == "search"
    assert fn.params == ("term", "limit")
    assert fn.comments[0] == "Find stuff."
    assert "rank" in fn.identifiers and "k" in fn.identifiers
    assert by_kind[TokenKind.GLOBAL_IDENTIFIER][0].text == "CONFIG"
    assert any("module comment" == t.text for t in by_kind[TokenKind.COMMENT])


def test_generic_fallback():
    toks = P.parse("// note\nfn main() { helper(); }", "rs")
    assert any(t.kind == TokenKind.COMMENT and t.text == "note" for t in toks)
    assert any(t.kind == TokenKind.FUNCTION and t.name == "main" for t in toks)


def test_flatten_for_index():
    strings = flatten_for_index(P.parse(SIMPLE1, "tsx"))
    for expected in ("foo-package", "myFunction", "MyComponent", "children", "div", "id"):
        assert expected in strings


def test_malformed_source_no_crash():
    for src in ("function (", "<div", "import {", "const = = =", "class {"):
        P.parse(src, "tsx")  # must not raise
    P.parse("def broken(:", "py")



# -- both packages on every source of tests/test_code_parser.py --------------


def _reference_sources():
    import ast
    import os

    path = os.path.join(os.path.dirname(__file__), "test_code_parser.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    seen, out = set(), []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            continue
        code = node.value
        if len(code) < 5 or not any(c in code for c in "(){}<:=\n"):
            continue
        if code in seen:
            continue
        seen.add(code)
        out.append(pytest.param(code, id=f"line{node.lineno}"))
    return sorted(out, key=lambda p: int(p.id[4:]))


SOURCES = _reference_sources()
LANGUAGES = ("tsx", "ts", "py", "rs")


def _as_plain(tokens):
    import dataclasses
    import enum

    return [
        {k: (v.value if isinstance(v, enum.Enum) else v)
         for k, v in dataclasses.asdict(t).items()}
        for t in tokens
    ]


def _lexed(lexer, source):
    import dataclasses

    return [dataclasses.astuple(t) for t in lexer.lex(source)]


def test_reference_sources_found():
    assert len(SOURCES) >= 15


@pytest.mark.parametrize("source", SOURCES)
def test_source_parses_as_in_reference(source):
    from orama_core_tpu.nlp import code_parser as ref
    from orama_core_tpu.nlp import ts_lexer as ref_lexer
    from orama_core_tpu_torch.nlp import code_parser as port
    from orama_core_tpu_torch.nlp import ts_lexer as port_lexer

    assert _lexed(port_lexer, source) == _lexed(ref_lexer, source)
    for lang in LANGUAGES:
        want = ref.CodeParser().parse(source, lang)
        got = port.CodeParser().parse(source, lang)
        assert _as_plain(got) == _as_plain(want), lang
        assert port.flatten_for_index(got) == ref.flatten_for_index(want), lang
