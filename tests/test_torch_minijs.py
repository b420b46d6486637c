"""The port's MiniJS interpreter (``orama_core_tpu_torch/engine/minijs.py``).

tests/test_minijs.py's 85 cases run against the port's interpreter,
hooks runtime and engine (``build_orama(device="cpu")``), unchanged but
for the package they import. Then a differential test: every hook program
of tests/test_minijs.py (read from that file's string literals) runs in
both packages' ``run_hook`` on fixed and Hypothesis-drawn documents; the
values are equal, or both raise the same error class with the same
message. No test may leave a generator worker thread alive."""

import threading
import time

import pytest

from orama_core_tpu_torch.engine.minijs import MiniJsError, run_hook


def _generator_workers():
    out = []
    for t in threading.enumerate():
        target = getattr(t, "_target", None)
        owner = getattr(target, "__self__", None)
        if type(owner).__name__ == "_JsGenerator":
            out.append(t)
    return out


@pytest.fixture(autouse=True)
def _no_generator_worker_left():
    """A worker left waiting would hold a test process until the suite's
    time limit; run_hook's teardown must end every one it started."""
    before = set(_generator_workers())
    yield
    deadline = time.monotonic() + 5.0
    while True:
        left = [t for t in _generator_workers() if t not in before]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert not left, f"{len(left)} generator worker thread(s) still alive"

FN = "selectEmbeddingProperties"


def run(code, doc):
    return run_hook(code, FN, doc)


def test_dynamic_property_selection():
    code = """
    function selectEmbeddingProperties(doc) {
      if (doc.kind === 'product') {
        return ['title', 'description'];
      }
      return ['body'];
    }
    """
    assert run(code, {"kind": "product"}) == ["title", "description"]
    assert run(code, {"kind": "post"}) == ["body"]


def test_arrow_function_and_template_literal():
    code = """
    const selectEmbeddingProperties = (doc) =>
      `${doc.title ?? ''} ${doc.summary ?? doc.body ?? ''}`.trim();
    """
    assert run(code, {"title": "Solar", "summary": "Panels"}) == "Solar Panels"
    assert run(code, {"body": "fallback"}) == "fallback"


def test_array_methods_and_member_access():
    code = """
    function selectEmbeddingProperties(doc) {
      const fields = Object.keys(doc).filter((k) => typeof doc[k] === 'string');
      return fields.filter((k) => !k.startsWith('_'));
    }
    """
    doc = {"title": "a", "_internal": "x", "price": 3, "body": "b"}
    assert run(code, doc) == ["title", "body"]


def test_string_building_with_concat_and_join():
    code = """
    function selectEmbeddingProperties(doc) {
      const parts = [doc.name, doc.brand].filter((x) => x != null);
      return parts.join(' - ').toLowerCase();
    }
    """
    assert run(code, {"name": "Widget", "brand": "ACME"}) == "widget - acme"
    assert run(code, {"name": "Widget"}) == "widget"


def test_nested_access_ternary_arith():
    code = """
    function selectEmbeddingProperties(doc) {
      const lvl = doc.meta?.level ?? 0;
      return lvl * 2 + 1 > 3 ? ['deep'] : ['shallow'];
    }
    """
    assert run(code, {"meta": {"level": 5}}) == ["deep"]
    assert run(code, {}) == ["shallow"]


def test_null_return_means_no_override():
    code = "function selectEmbeddingProperties(doc) { return null; }"
    assert run(code, {}) is None


def test_runaway_hook_hits_step_budget():
    code = """
    function loop(x) { return loop(x + 1); }
    function selectEmbeddingProperties(doc) { return loop(0); }
    """
    with pytest.raises(MiniJsError):
        run(code, {})


def test_no_host_access_identifiers():
    for snippet in (
        "function selectEmbeddingProperties(d) { return require('fs'); }",
        "function selectEmbeddingProperties(d) { return process.env.HOME; }",
        "function selectEmbeddingProperties(d) { return globalThis.x; }",
    ):
        with pytest.raises(MiniJsError):
            run(snippet, {})


def test_dynamic_hook_through_engine_without_node(tmp_path):
    """End-to-end: a NON-constant hook drives embedding-input selection in
    the write path with no node binary (VERDICT 'done' criterion)."""
    import shutil

    assert shutil.which("node") is None  # this image has no node

    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.engine.hooks import SELECT_EMBEDDING_PROPERTIES

    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp_path / "w")
    cfg.reader_side.data_dir = str(tmp_path / "r")
    e = build_orama(cfg, start_background=False, device="cpu")
    try:
        e.write_side.create_collection("master", "c", "rk", "wk")
        e.hooks.insert_hook(
            "c",
            SELECT_EMBEDDING_PROPERTIES,
            """
            function selectEmbeddingProperties(doc) {
              if (doc.kind === 'code') { return ['snippet']; }
              return ['title'];
            }
            """,
        )
        out = e.hooks.eval(
            "c", SELECT_EMBEDDING_PROPERTIES, {"kind": "code", "snippet": "x"}
        )
        assert out == ["snippet"]
        out2 = e.hooks.eval(
            "c", SELECT_EMBEDDING_PROPERTIES, {"kind": "doc", "title": "t"}
        )
        assert out2 == ["title"]
        # the write path consumes the hook without error
        e.write_side.write(
            "c", [{"id": "1", "kind": "code", "snippet": "let x = 1"}], "wk"
        )
        e.flush()
    finally:
        e.close()


# -- round-3 subset extensions: loops, assignment, try/catch, templates ------


def test_for_loop_hook_runs_on_bundled_tier(tmp_path):
    """A hook with a plain for loop must run on the bundled interpreter —
    no subprocess tier (VERDICT r2 item 9; reference V8 runs arbitrary JS,
    deno.rs:29-101)."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.engine.hooks import SELECT_EMBEDDING_PROPERTIES

    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp_path / "w")
    cfg.reader_side.data_dir = str(tmp_path / "r")
    e = build_orama(cfg, start_background=False, device="cpu")
    try:
        e.write_side.create_collection("master", "c", "rk", "wk")
        assert e.hooks._node is None  # subprocess tier is opt-in & absent
        e.hooks.insert_hook(
            "c",
            SELECT_EMBEDDING_PROPERTIES,
            """
            function selectEmbeddingProperties(doc) {
              let out = [];
              for (let i = 0; i < doc.parts.length; i++) {
                if (doc.parts[i] !== 'skip') { out.push(doc.parts[i]); }
              }
              return out;
            }
            """,
        )
        out = e.hooks.eval(
            "c", SELECT_EMBEDDING_PROPERTIES,
            {"parts": ["title", "skip", "body"]},
        )
        assert out == ["title", "body"]
    finally:
        e.close()


def test_while_do_break_continue():
    code = """
    function f(doc) {
      let out = []; let i = 0;
      while (true) {
        i += 1;
        if (i === 2) { continue; }
        if (i > 4) { break; }
        out.push(i);
      }
      let j = 10;
      do { out.push(j); j--; } while (j > 8);
      return out;
    }
    """
    assert run_hook(code, "f", {}) == [1, 3, 4, 10, 9]


def test_forof_forin_and_compound_assign():
    code = """
    function f(doc) {
      let total = 0;
      for (const v of doc.nums) { total += v; }
      total *= 2;
      const keys = [];
      for (const k in doc.obj) { keys.push(k); }
      return {total: total, keys: keys};
    }
    """
    out = run_hook(code, "f", {"nums": [1, 2, 3], "obj": {"a": 1, "b": 2}})
    assert out == {"total": 12, "keys": ["a", "b"]}


def test_try_catch_finally_throw():
    code = """
    function f(doc) {
      const log = [];
      try { throw {message: 'boom'}; }
      catch (e) { log.push(e.message); }
      finally { log.push('fin'); }
      try { doc.missing.deep; } catch (e) { log.push('rt'); }
      return log;
    }
    """
    assert run_hook(code, "f", {}) == ["boom", "fin", "rt"]


def test_budget_not_catchable():
    from orama_core_tpu_torch.engine.minijs import MiniJsFatal

    code = (
        "function f(d) { try { while (true) { d.x; } } "
        "catch (e) { return 'swallowed'; } }"
    )
    with pytest.raises(MiniJsFatal):
        run_hook(code, "f", {"x": 1})


def test_nested_template_interpolation():
    """`${a ? "x}" : b}` used to mis-parse at the first '}' (VERDICT r2
    item 9 latent bug); nested templates must work too."""
    code = """
    function f(doc) {
      const a = doc.a; const b = 'B';
      return `${a ? "x}" : b}|${`inner ${b}`}|${{k: '}'}.k}`;
    }
    """
    assert run_hook(code, "f", {"a": 1}) == "x}|inner B|}"
    assert run_hook(code, "f", {"a": 0}) == "B|inner B|}"


def test_prefix_postfix_update_semantics():
    code = """
    function f(doc) {
      let i = 5;
      const a = i++;
      const b = ++i;
      const c = i--;
      const d = --i;
      return [a, b, c, d, i];
    }
    """
    assert run_hook(code, "f", {}) == [5, 7, 7, 5, 5]


def test_member_assignment():
    code = """
    function f(doc) {
      doc.tags[0] = 'x';
      doc.extra = doc.tags.length;
      doc.tags[doc.tags.length] = 'appended';
      return doc;
    }
    """
    out = run_hook(code, "f", {"tags": ["a", "b"]})
    assert out == {"tags": ["x", "b", "appended"], "extra": 2}


# -- hypothesis: generated sources agree with a Python oracle ----------------

from hypothesis import given, settings
from hypothesis import strategies as st


@settings(max_examples=60, deadline=None)
@given(
    nums=st.lists(st.integers(min_value=-50, max_value=50), max_size=8),
    threshold=st.integers(min_value=-50, max_value=50),
    start=st.integers(min_value=0, max_value=5),
)
def test_hypothesis_loop_sum_matches_python(nums, threshold, start):
    """Generated for-loop programs over random inputs behave like the
    Python oracle (sum of elements > threshold, counted from `start`)."""
    code = f"""
    function f(doc) {{
      let total = 0; let count = 0;
      for (let i = {start}; i < doc.nums.length; i++) {{
        if (doc.nums[i] > {threshold}) {{ total += doc.nums[i]; count++; }}
      }}
      return `${{count}}:${{total}}`;
    }}
    """
    expected_items = [v for v in nums[start:] if v > threshold]
    expected = f"{len(expected_items)}:{sum(expected_items)}"
    assert run_hook(code, "f", {"nums": nums}) == expected


_TMPL_TEXT = st.text(
    alphabet=st.characters(
        whitelist_categories=("Lu", "Ll", "Nd"), whitelist_characters=" _-"
    ),
    max_size=12,
)


@settings(max_examples=60, deadline=None)
@given(left=_TMPL_TEXT, right=_TMPL_TEXT, flag=st.booleans())
def test_hypothesis_nested_templates(left, right, flag):
    """Ternaries with brace-bearing strings inside ${} always parse to the
    value JS would produce."""
    code = f"""
    function f(doc) {{
      return `{left}${{doc.flag ? "}}" : `<${{doc.x}}>`}}{right}`;
    }}
    """
    mid = "}" if flag else "<42>"
    assert run_hook(code, "f", {"flag": flag, "x": 42}) == f"{left}{mid}{right}"


def test_uncaught_throw_is_minijs_error():
    """An uncaught user-level `throw` must surface as MiniJsError (so
    engine/hooks.py takes its fallback tier), never as a raw internal
    control-flow exception that crashes the write path."""
    code = """
    function selectEmbeddingProperties(doc) {
      if (!doc.title) throw {message: "no title"};
      return ["title"];
    }
    """
    assert run_hook(code, "selectEmbeddingProperties", {"title": "x"}) == ["title"]
    with pytest.raises(MiniJsError, match="uncaught throw"):
        run_hook(code, "selectEmbeddingProperties", {"body": "y"})


def test_stray_break_continue_is_minijs_error():
    with pytest.raises(MiniJsError, match="outside a loop"):
        run_hook("break; function f(d) { return 1; }", "f", {})
    with pytest.raises(MiniJsError, match="outside a loop"):
        run_hook("function f(d) { continue; }", "f", {})


def test_throwing_hook_skips_embedding_not_write(tmp_path):
    """write() with a hook that throws on some docs: the batch must land
    (reference skips the embedding on hook failure, fields.rs:431-434)."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.types import SearchParams

    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp_path / "w")
    cfg.reader_side.data_dir = str(tmp_path / "r")
    cfg.writer_side.commit_interval_sec = 3600
    cfg.reader_side.commit_interval_sec = 3600
    e = build_orama(cfg, start_background=False, device="cpu")
    try:
        e.write_side.create_collection("master", "c", "rk", "wk")
        e.hooks.insert_hook(
            "c",
            "selectEmbeddingProperties",
            'function selectEmbeddingProperties(doc) {'
            ' if (!doc.title) throw "missing"; return ["title"]; }',
        )
        e.write_side.write(
            "c",
            [{"id": "1", "title": "good doc"}, {"id": "2", "body": "no title"}],
            "wk",
        )
        e.flush()
        r = e.read_side.search(
            "c", SearchParams.from_json({"term": "doc", "mode": "fulltext"}), "rk"
        )
        assert {h.id for h in r.hits} == {"1"}
        # both docs were written (doc 2 just has no embedding)
        assert e.read_side.count_documents("c") == 2
    finally:
        e.close()


def test_recursion_budget_not_user_catchable():
    """Depth exhaustion is MiniJsFatal: a user try/catch must not swallow
    the kill and restart the recursion (only the step budget would
    eventually stop it, ~200k wasted steps per document)."""
    from orama_core_tpu_torch.engine.minijs import MiniJsFatal

    code = """
    function f() { try { return f(); } catch (e) { return f(); } }
    function hook(doc) { return f(); }
    """
    with pytest.raises(MiniJsFatal, match="depth"):
        run_hook(code, "hook", {})


def test_hook_throw_never_falls_to_static_tier(tmp_path):
    """A hook that RAN and threw must surface as a per-doc failure — the
    static tier would otherwise return the first `return` literal
    regardless of the branch this document takes."""
    from orama_core_tpu_torch.engine.hooks import HooksRuntime

    rt = HooksRuntime(str(tmp_path))
    rt.insert_hook(
        "c", "selectEmbeddingProperties",
        'function selectEmbeddingProperties(doc) {'
        ' if (!doc.title) throw "veto"; return ["title"]; }',
    )
    assert rt.eval("c", "selectEmbeddingProperties", {"title": "x"}) == ["title"]
    with pytest.raises(RuntimeError, match="hook threw"):
        rt.eval("c", "selectEmbeddingProperties", {"body": "y"})


def test_runtime_unsupported_skips_static_tier(tmp_path, monkeypatch):
    """A hook that parses but hits an unsupported runtime feature must NOT
    get the static tier's branch-blind constant."""
    monkeypatch.delenv("ORAMAX_HOOKS_SUBPROCESS", raising=False)
    from orama_core_tpu_torch.engine.hooks import HooksRuntime

    rt = HooksRuntime(str(tmp_path))
    rt._node = None  # subprocess tier off
    rt.insert_hook(
        "c", "selectEmbeddingProperties",
        # toWellFormed (ES2024) stays outside the MiniJS subset
        'function selectEmbeddingProperties(doc) {'
        ' if (doc.x.toWellFormed() === "y") { return ["a"]; } return ["b"]; }',
    )
    with pytest.raises(RuntimeError):
        rt.eval("c", "selectEmbeddingProperties", {"x": "y"})


def test_hook_cannot_mutate_stored_document(tmp_path):
    """minijs supports member assignment/push; the V8 boundary in the
    reference serializes the doc — hooks must see a copy."""
    from orama_core_tpu_torch.engine.hooks import HooksRuntime

    rt = HooksRuntime(str(tmp_path))
    rt.insert_hook(
        "c", "selectEmbeddingProperties",
        'function selectEmbeddingProperties(doc) {'
        ' doc.title = "HACKED"; doc.tags.push("x"); return ["title"]; }',
    )
    doc = {"title": "original", "tags": ["a"]}
    assert rt.eval("c", "selectEmbeddingProperties", doc) == ["title"]
    assert doc == {"title": "original", "tags": ["a"]}


# --- round 4 surface: classes, this/new/super, regex literals, Math ---------


def _run(code, fn="h", doc=None):
    from orama_core_tpu_torch.engine.minijs import run_hook

    return run_hook(code, fn, doc if doc is not None else {})


def test_class_constructor_methods_this():
    code = """
    class Scorer {
      constructor(base) { this.base = base; this.hits = 0; }
      bump(n) { this.hits += n; return this.hits; }
      total() { return this.base + this.hits; }
    }
    function h(doc) {
      const s = new Scorer(10);
      s.bump(2); s.bump(3);
      return { total: s.total(), hits: s.hits };
    }
    """
    assert _run(code) == {"total": 15, "hits": 5}


def test_class_static_getter_extends_super():
    code = """
    class Base {
      constructor(x) { this.x = x; }
      label() { return "base:" + this.x; }
      static kind() { return "B"; }
      get doubled() { return this.x * 2; }
    }
    class Child extends Base {
      constructor(x, y) { super(x); this.y = y; }
      label() { return super.label() + "/child:" + this.y; }
    }
    function h(doc) {
      const c = new Child(3, 4);
      return [c.label(), Base.kind(), c.doubled, c.x + c.y];
    }
    """
    assert _run(code) == ["base:3/child:4", "B", 6, 7]


def test_arrow_captures_lexical_this():
    code = """
    class Acc {
      constructor() { this.total = 0; }
      addAll(xs) { xs.map((v) => { this.total += v; return v; }); return this.total; }
    }
    function h(doc) { return new Acc().addAll([1, 2, 3]); }
    """
    assert _run(code) == 6


def test_regex_literals_and_string_methods():
    code = """
    function h(doc) {
      const re = /([a-z]+)-(\\d+)/i;
      const m = re.exec("Item-42 extra");
      return {
        test: /\\d+/.test(doc.s),
        none: /zz+/.test(doc.s),
        group: m[2],
        replaced: doc.s.replace(/o/g, "0"),
        first: doc.s.replace(/o/, "0"),
        split: "a1b22c".split(/\\d+/),
        search: doc.s.search(/w/),
        matched: doc.s.match(/o/g),
        source: re.source,
      };
    }
    """
    out = _run(code, doc={"s": "hello world 7"})
    assert out == {
        "test": True, "none": False, "group": "42",
        "replaced": "hell0 w0rld 7", "first": "hell0 world 7",
        "split": ["a", "b", "c"], "search": 6, "matched": ["o", "o"],
        "source": "([a-z]+)-(\\d+)",
    }


def test_regex_vs_division_disambiguation():
    code = """
    function h(doc) {
      const a = 10, b = 4;
      const div = a / b / 2;           // division chain
      const re = /x\\//;                // regex containing an escaped slash
      return [div, re.test("ax/b"), (a) / b];
    }
    """
    assert _run(code) == [1.25, True, 2.5]


def test_math_and_number_methods():
    code = """
    function h(doc) {
      return [
        Math.min(3, 1, 2), Math.max(3, 1, 2), Math.abs(-5),
        Math.floor(2.7), Math.ceil(2.1), Math.round(2.5),
        Math.sqrt(16), Math.pow(2, 10), Math.sign(-3),
        (3.14159).toFixed(2), (7).toString(),
      ];
    }
    """
    assert _run(code) == [1, 3, 5, 2, 3, 3, 4.0, 1024, -1, "3.14", "7"]


def test_class_instance_is_json_shaped():
    code = """
    class P { constructor(n) { this.name = n; this.tags = ["a"]; } }
    function h(doc) { return JSON.stringify(new P("x")); }
    """
    import json

    assert json.loads(_run(code)) == {"name": "x", "tags": ["a"]}


def test_budgets_still_fatal_through_methods():
    import pytest

    from orama_core_tpu_torch.engine.minijs import MiniJsFatal

    code = """
    class L { go() { return this.go(); } }
    function h(doc) { try { return new L().go(); } catch (e) { return "swallowed"; } }
    """
    with pytest.raises(MiniJsFatal):
        _run(code)


def test_generators_basic_and_for_of():
    code = """
    function* parts(doc) { yield doc.title; yield* doc.tags; }
    function h(doc) {
      const out = [];
      for (const p of parts(doc)) out.push(p);
      return out;
    }
    """
    assert _run(code, doc={"title": "t", "tags": ["a", "b"]}) == [
        "t", "a", "b",
    ]


def test_generator_next_protocol_and_return_value():
    code = """
    function* g() { yield 1; yield 2; return 9; }
    function h(doc) {
      const it = g();
      const a = it.next(); const b = it.next();
      const c = it.next(); const d = it.next();
      return [a.value, a.done, b.value, b.done, c.value, c.done, d.done];
    }
    """
    assert _run(code) == [1, False, 2, False, 9, True, True]


def test_generator_delegation_and_array_from():
    code = """
    function* inner() { yield "x"; yield "y"; }
    function* outer() { yield* inner(); yield* [1, 2]; yield* "ab"; }
    function h(doc) { return Array.from(outer()); }
    """
    assert _run(code) == ["x", "y", 1, 2, "a", "b"]


def test_yield_outside_generator_raises():
    with pytest.raises(MiniJsError):
        _run("function h(d) { yield 1; return 0; }")
    # nested plain function inside a generator: V8 SyntaxError analog
    with pytest.raises(MiniJsError):
        _run(
            """
            function* g(cb) { cb(); yield 1; }
            function h(d) {
              function bad() { yield 2; }
              return Array.from(g(bad));
            }
            """
        )


def test_infinite_generator_hits_step_budget():
    from orama_core_tpu_torch.engine.minijs import MiniJsFatal

    # lazy generators (V8): g() alone runs nothing — the budget kill
    # fires when the infinite body is actually consumed, and a
    # user-level try/catch cannot swallow it
    code = """
    function* g() { while (true) yield 1; }
    function h(doc) { try { return [...g()]; } catch (e) { return "swallowed"; } }
    """
    with pytest.raises(MiniJsFatal):
        _run(code)


def test_lazy_generator_creation_is_free():
    code = """
    function* g() { while (true) yield 1; }
    function h(doc) { g(); return "created-not-run"; }
    """
    assert _run(code) == "created-not-run"


def test_destructuring_declarations():
    code = """
    function h(d) {
      const {title, body: bb, missing = 'dflt', ...rest} = d;
      const [a, , c, ...more] = d.tags;
      const {meta: {lang, n = 9}} = d;
      return [title, bb, missing, Object.keys(rest), a, c, more, lang, n];
    }
    """
    doc = {
        "title": "t", "body": "b", "tags": ["x", "y", "z", "w"],
        "meta": {"lang": "en"}, "extra": 1,
    }
    assert _run(code, doc=doc) == [
        "t", "b", "dflt", ["tags", "meta", "extra"], "x", "z", ["w"],
        "en", 9,
    ]


def test_destructuring_for_of_and_params():
    code = """
    function pick({title, tags: [first]}, suffix = '!', ...extras) {
      return title + first + suffix + extras.length;
    }
    function h(d) {
      const out = [];
      for (const [k, v] of Object.entries(d.meta)) out.push(k + '=' + v);
      out.push(pick(d, '?', 1, 2));
      out.push(pick(d));
      return out;
    }
    """
    doc = {"title": "t", "tags": ["x"], "meta": {"a": 1, "b": 2}}
    assert _run(code, doc=doc) == ["a=1", "b=2", "tx?2", "tx!0"]


def test_spread_and_object_shorthand():
    code = """
    function* g() { yield 1; yield 2; }
    function f(a, b, c) { return a + b + c; }
    function h(d) {
      const arr = [...d.tags, 'z', ...'ab', ...g()];
      const merged = {...d.meta, extra: true};
      const {title} = d;
      const short = {title, n: Math.max(...[3, 7, 5])};
      return [arr, merged, short, f(...d.tags, '!')];
    }
    """
    doc = {"title": "t", "tags": ["x", "y"], "meta": {"lang": "en"}}
    assert _run(code, doc=doc) == [
        ["x", "y", "z", "a", "b", 1, 2],
        {"lang": "en", "extra": True},
        {"title": "t", "n": 7},
        "xy!",
    ]


def test_destructuring_type_errors():
    with pytest.raises(MiniJsError):
        _run("function h(d) { const {a} = null; return 0; }")
    with pytest.raises(MiniJsError):
        _run("function h(d) { const [a] = 5; return 0; }")
    with pytest.raises(MiniJsError):
        _run("function h(d) { return [...5]; }")


def test_switch_fallthrough_default_and_strictness():
    code = """
    function h(d) {
      const out = [];
      switch (d.kind) {
        case 'a': out.push(1);          // falls through
        case 'b': out.push(2); break;
        case 'c': out.push(3); break;
        default: out.push(9);
      }
      switch ('zz') { case 'a': out.push(-1); default: out.push(99); }
      switch ('q') { case 'a': out.push(-2); }
      switch (null) { case undefined: out.push(-3); break;
                      case null: out.push(42); }
      return out;
    }
    """
    assert _run(code, doc={"kind": "a"}) == [1, 2, 99, 42]


def test_in_operator_bitwise_and_exponent():
    code = """
    function h(d) {
      return [
        'kind' in d, 'nope' in d, 0 in d.tags, 'length' in d.tags,
        5 & 3, 1 << 4, 5 | 2, 5 ^ 1, -8 >> 1, -1 >>> 28, ~5, ~~3.7,
        2 ** 3 ** 2,
      ];
    }
    """
    assert _run(code, doc={"kind": "a", "tags": ["x"]}) == [
        True, False, True, True,
        1, 16, 7, 4, -4, 15, -6, 3,
        512,
    ]


def test_computed_object_keys():
    code = """
    function h(d) {
      const k = 'a' + 'b';
      return {[k]: 7, [1 + 1]: 'two'};
    }
    """
    assert _run(code) == {"ab": 7, "2": "two"}


def test_array_builtins_reduce_sort_foreach():
    code = """
    function h(d) {
      const sorted = [...d.nums].sort((a, b) => a - b);
      const sum = d.nums.reduce((acc, x) => acc + x, 0);
      const noInit = d.nums.reduce((a, x) => a + x);
      let idxWeighted = 0;
      d.nums.forEach((x, i) => { idxWeighted += x * i; });
      return [
        sorted, sum, noInit, idxWeighted,
        d.nums.findIndex((x) => x === 2),
        d.nums.flatMap((x) => [x, x * 10]),
        [...d.nums].reverse(),
        ['b', 'a', 10, 2].sort(),          // JS default: lexicographic
        d.nums.map((x, i) => x + i),       // callbacks get (value, index)
        d.nums.at(-1),
      ];
    }
    """
    assert _run(code, doc={"nums": [3, 1, 2]}) == [
        [1, 2, 3], 6, 6, 0 * 3 + 1 * 1 + 2 * 2, 2,
        [3, 30, 1, 10, 2, 20], [2, 1, 3], [10, 2, "a", "b"],
        [3, 2, 4], 2,
    ]


def test_string_and_object_builtins():
    code = """
    function h(d) {
      return [
        '5'.padStart(3, '0'), 'q'.padEnd(3, '-'), 'ab'.repeat(2),
        'A'.charCodeAt(0), 'hello'.substring(3, 1), 'abc'.at(-1),
        Object.assign({}, {a: 1}, {b: 2}),
        Object.fromEntries(Object.entries({x: 1, y: 2})),
      ];
    }
    """
    assert _run(code) == [
        "005", "q--", "abab", 65, "el", "c",
        {"a": 1, "b": 2}, {"x": 1, "y": 2},
    ]


def test_reduce_empty_no_initial_raises():
    with pytest.raises(MiniJsError):
        _run("function h(d) { return [].reduce((a, x) => a + x); }")


def test_arrow_param_patterns():
    code = """
    function h(doc) {
      const names = Object.entries(doc)
        .filter(([k, v]) => typeof v === 'string' && !k.startsWith('_'))
        .sort(([a], [b]) => a < b ? -1 : 1)
        .map(([k]) => k);
      const f = ({x} = {x: 9}) => x * 2;
      const g = (a, ...rest) => a + rest.length;
      return [names, f(), f({x: 3}), g(1, 2, 3),
              ({a: 1}).a + ([5])[0]];   // literals still parse in parens
    }
    """
    doc = {"zeta": "z", "alpha": "a", "_x": "s", "n": 3}
    assert _run(code, doc=doc) == [["alpha", "zeta"], 18, 6, 3, 6]


def test_global_number_parsing_functions():
    code = """
    function h(d) {
      return [
        parseInt('42px'), parseInt('ff', 16), parseFloat('3.5rem'),
        isNaN('x'), isFinite(3),
        Number.isInteger(3), Number.isInteger(3.5),
        String.fromCharCode(72, 105),
      ];
    }
    """
    assert _run(code) == [42, 255, 3.5, True, True, True, False, "Hi"]


def test_instanceof_and_delete():
    code = """
    class A {}
    class B extends A {}
    class C {}
    function h(d) {
      const b = new B();
      const o = {a: 1, b: 2};
      delete o.a;
      return [b instanceof B, b instanceof A, b instanceof C,
              Object.keys(o)];
    }
    """
    assert _run(code) == [True, True, False, ["b"]]


def test_labeled_break_continue():
    code = """
    function h(d) {
      let cont = 0;
      outer: for (let i = 0; i < 3; i++) {
        for (let j = 0; j < 3; j++) {
          if (j > 0) continue outer;
          cont++;
        }
      }
      let brk = 0;
      top: for (let i = 0; i < 3; i++) {
        for (let j = 0; j < 3; j++) {
          if (i === 1 && j === 1) break top;
          brk++;
        }
      }
      const r = [];
      w: while (true) {
        for (const x of [1, 2, 3]) {
          if (x === 2) break w;
          r.push(x);
        }
      }
      return [cont, brk, r];
    }
    """
    assert _run(code) == [3, 4, [1]]


def test_label_on_block_and_switch_not_stolen_by_inner_loop():
    """A label on a non-loop statement binds to THAT statement: break
    label exits the block/switch, not just the inner loop (review
    finding: the pending label must not leak to inner loops)."""
    code = """
    function h(d) {
      const r = [];
      outer: {
        for (const x of [1, 2]) { r.push(x); break outer; }
        r.push('done');        // must be skipped
      }
      r.push('after');
      lab: switch (1) {
        case 1:
          for (const x of [1]) { break lab; }
          r.push('more');      // must be skipped
      }
      r.push('end');
      return r;
    }
    """
    assert _run(code) == [1, "after", "end"]


def test_builtin_misuse_stays_minijs_error():
    """Bad arguments to builtins must raise MiniJsError (the hook tier
    fallback in hooks.py only catches MiniJs*), never raw Python
    exceptions (review finding)."""
    for code in (
        "function h(d) { return (-8) ** 0.5; }",
        "function h(d) { return String.fromCharCode(-1); }",
        "function h(d) { return 'a'.repeat({}); }",
        "function h(d) { return [1].lastIndexOf(); }",
        "function h(d) { return parseInt('8', 'x'); }",
        "function h(d) { return 'abc'.substring({}); }",
    ):
        with pytest.raises(MiniJsError):
            _run(code)


def test_parseint_hex_autodetect():
    code = "function h(d) { return [parseInt('0x1f'), parseInt('0x1f', 16)]; }"
    assert _run(code) == [31, 31]


def test_flat_depth():
    code = """
    function h(d) {
      return [
        [[1, [2]], [3]].flat(),
        [[1, [2, [5]]], [3]].flat(2),
        [[1, [2, [5, [7]]]]].flat(99),
      ];
    }
    """
    assert _run(code) == [
        [1, [2], 3], [1, 2, [5], 3], [1, 2, 5, 7],
    ]


# --- round-4 (late) additions: function exprs, this, prototypes, getters,
# --- tagged templates, async/await over the eager promise model ------------


def test_function_expression_named_and_anonymous():
    code = """
    const fact = function f(n) { return n <= 1 ? 1 : n * f(n - 1); };
    const inc = function (x) { return x + 1; };
    function selectEmbeddingProperties(doc) {
      return [fact(5), inc(41)];
    }
    """
    assert run(code, {}) == [120, 42]


def test_method_call_binds_dynamic_this():
    code = """
    function selectEmbeddingProperties(doc) {
      const o = {
        n: 3,
        viaExpr: function () { return this.n * 2; },
        viaShorthand(x) { return this.n + x; },
      };
      // extraction loses `this` (V8): typeof stays function but n is gone
      const f = o.viaExpr;
      let lost = 'no';
      try { f(); } catch (e) { lost = 'yes'; }
      return { a: o.viaExpr(), b: o.viaShorthand(4), lost: lost };
    }
    """
    # extracted call: `this` is unbound -> this.n throws (member on undefined)
    assert run(code, {}) == {"a": 6, "b": 7, "lost": "yes"}


def test_arrow_keeps_lexical_this_inside_method():
    code = """
    class C {
      constructor() { this.v = 10; }
      collect() { return [1, 2].map((x) => x + this.v); }
    }
    function selectEmbeddingProperties(doc) {
      return new C().collect();
    }
    """
    assert run(code, {}) == [11, 12]


def test_prototype_mutation_adds_and_overrides():
    code = """
    class P { constructor(n) { this.n = n; } base() { return 1; } }
    P.prototype.twice = function () { return this.n * 2; };
    P.prototype.base = function () { return 100 + this.n; };
    function selectEmbeddingProperties(doc) {
      const p = new P(7);
      return { t: p.twice(), b: p.base(), ty: typeof P.prototype.twice };
    }
    """
    assert run(code, {}) == {"t": 14, "b": 107, "ty": "function"}


def test_prototype_mutation_inherited_by_subclass():
    code = """
    class A {}
    class B extends A {}
    A.prototype.tag = function () { return 'from-A'; };
    function selectEmbeddingProperties(doc) {
      return new B().tag();
    }
    """
    assert run(code, {}) == "from-A"


def test_object_literal_getter():
    code = """
    function selectEmbeddingProperties(doc) {
      const o = { first: 'a', last: 'b',
                  get full() { return this.first + ' ' + this.last; } };
      o.first = 'x';
      return { direct: o.full, json: JSON.stringify(o),
               vals: Object.values(o) };
    }
    """
    out = run(code, {})
    assert out["direct"] == "x b"
    assert '"full": "x b"' in out["json"].replace('"full":"x b"', '"full": "x b"')
    assert out["vals"] == ["x", "b", "x b"]


def test_getter_materializes_in_hook_result():
    code = """
    function selectEmbeddingProperties(doc) {
      return { get text() { return doc.title.toUpperCase(); } };
    }
    """
    assert run(code, {"title": "abc"}) == {"text": "ABC"}


def test_tagged_template():
    code = """
    const tag = (strings, ...values) =>
      strings.join('|') + '#' + values.join(',');
    function selectEmbeddingProperties(doc) {
      return [tag`a${1}b${2}c`, tag`${doc.t}`, tag`plain`];
    }
    """
    assert run(code, {"t": "z"}) == ["a|b|c#1,2", "|#z", "plain#"]


def test_async_await_basic():
    code = """
    async function selectEmbeddingProperties(doc) {
      const v = await Promise.resolve(5);
      const w = await new Promise((res, rej) => res(v * 2));
      return [v, w, await 7];
    }
    """
    assert run(code, {}) == [5, 10, 7]


def test_async_rejection_try_catch_and_chaining():
    code = """
    const f = async (x) => { if (x < 0) throw 'neg'; return x + 1; };
    async function selectEmbeddingProperties(doc) {
      let caught = '';
      try { await f(-1); } catch (e) { caught = e; }
      const chained = await f(1).then((x) => x * 10).catch((e) => -1);
      const all = await Promise.all([1, Promise.resolve(2)]);
      const settled = await Promise.allSettled([f(3), f(-3)]);
      return { caught, chained, all, settled };
    }
    """
    assert run(code, {}) == {
        "caught": "neg",
        "chained": 20,
        "all": [1, 2],
        "settled": [
            {"status": "fulfilled", "value": 4},
            {"status": "rejected", "reason": "neg"},
        ],
    }


def test_uncaught_async_rejection_is_hook_veto():
    from orama_core_tpu_torch.engine.minijs import MiniJsThrow

    code = """
    async function selectEmbeddingProperties(doc) {
      throw 'veto';
    }
    """
    with pytest.raises(MiniJsThrow):
        run(code, {})


def test_pending_promise_routes_to_fallback_tier():
    code = """
    async function selectEmbeddingProperties(doc) {
      // executor never settles: real async IO is outside the subset
      return await new Promise((res, rej) => {});
    }
    """
    with pytest.raises(MiniJsError):
        run(code, {})


def test_async_identifier_still_usable():
    code = """
    function selectEmbeddingProperties(doc) {
      const async = 3;
      return async + 1;
    }
    """
    assert run(code, {}) == 4


def test_promise_executor_reject_and_first_settle_wins():
    code = """
    async function selectEmbeddingProperties(doc) {
      let caught = '';
      try {
        await new Promise((res, rej) => { rej('bad'); res('late'); });
      } catch (e) { caught = e; }
      const adopted = await new Promise((res) => res(Promise.resolve(9)));
      return { caught, adopted };
    }
    """
    assert run(code, {}) == {"caught": "bad", "adopted": 9}


# --- lazy generators: two-way next(v), infinite streams, throw/return ------


def test_generator_two_way_communication():
    code = """
    function* accumulator() {
      let total = 0;
      while (true) {
        const x = yield total;
        total += x;
      }
    }
    function selectEmbeddingProperties(doc) {
      const g = accumulator();
      g.next();                      // prime to the first yield
      return [g.next(5).value, g.next(7).value];
    }
    """
    assert run(code, {}) == [5, 12]


def test_infinite_generator_forof_break():
    code = """
    function* naturals() { let i = 0; while (true) { yield i++; } }
    function selectEmbeddingProperties(doc) {
      const out = [];
      for (const n of naturals()) { if (n >= 4) break; out.push(n); }
      return out;
    }
    """
    assert run(code, {}) == [0, 1, 2, 3]


def test_yield_star_forwards_sent_values_and_returns_inner_value():
    code = """
    function* inner() { const got = yield 'i1'; yield got; return 'IR'; }
    function* outer() { const r = yield* inner(); yield r; }
    function selectEmbeddingProperties(doc) {
      const g = outer();
      return [g.next().value, g.next('sent').value, g.next().value];
    }
    """
    assert run(code, {}) == ["i1", "sent", "IR"]


def test_generator_throw_caught_in_body():
    code = """
    function* catcher() {
      try { yield 1; } catch (e) { yield 'caught:' + e; }
    }
    function selectEmbeddingProperties(doc) {
      const c = catcher();
      c.next();
      const t = c.throw('boom').value;
      return { t, done: c.next().done };
    }
    """
    assert run(code, {}) == {"t": "caught:boom", "done": True}


def test_generator_throw_uncaught_propagates_to_caller():
    code = """
    function* g() { yield 1; }
    function selectEmbeddingProperties(doc) {
      const it = g();
      it.next();
      try { it.throw('kaput'); } catch (e) { return 'outer:' + e; }
    }
    """
    assert run(code, {}) == "outer:kaput"


def test_generator_return_closes_midway():
    code = """
    function* g() { yield 1; yield 2; yield 3; }
    function selectEmbeddingProperties(doc) {
      const it = g();
      const a = it.next().value;
      const r = it.return(99);
      return [a, r.value, r.done, it.next().done];
    }
    """
    assert run(code, {}) == [1, 99, True, True]


def test_generator_workers_cleaned_up_after_hook():
    import threading

    before = threading.active_count()
    code = """
    function* naturals() { let i = 0; while (true) { yield i++; } }
    function selectEmbeddingProperties(doc) {
      const g = naturals();
      g.next(); g.next();          // leave it suspended
      return 'ok';
    }
    """
    for _ in range(5):
        assert run(code, {}) == "ok"
    # suspended workers are unwound in run_hook's finally
    assert threading.active_count() <= before + 1


def test_many_suspended_generators_do_not_exhaust_depth():
    # a suspended generator stays inside its body on a worker thread;
    # depth is per-thread so 200 primed generators must not trip the
    # caller's recursion budget
    code = """
    function* g(i) { yield i; yield i * 2; }
    function selectEmbeddingProperties(doc) {
      const gens = [];
      for (let i = 0; i < 200; i++) {
        const it = g(i); it.next(); gens.push(it);
      }
      return gens.map((it) => it.next().value).slice(0, 3);
    }
    """
    assert run(code, {}) == [0, 2, 4]


def test_function_values_do_not_leak_into_hook_results():
    # V8 JSON semantics: function-valued entries omitted from objects,
    # null in arrays, undefined bare — and interpreter internals
    # (closures carry their _Env) never reach the engine
    code = """
    function selectEmbeddingProperties(doc) {
      return { a: 1, f: (x) => x, arr: [(x) => x, 2] };
    }
    """
    assert run(code, {}) == {"a": 1, "arr": [None, 2]}

    bare = "const selectEmbeddingProperties = (d) => (x) => x;"
    assert run(bare, {}) is None


def test_json_stringify_omits_functions():
    code = """
    function selectEmbeddingProperties(doc) {
      return JSON.stringify({ a: 1, f: (x) => x, arr: [(x) => x, 2] });
    }
    """
    assert run(code, {}) == '{"a": 1, "arr": [null, 2]}'


def test_spread_and_assign_materialize_getters_at_copy_time():
    code = """
    function selectEmbeddingProperties(doc) {
      const o = { t: 'x', get up() { return this.t.toUpperCase(); } };
      const s = { ...o };
      const a = Object.assign({}, o);
      o.t = 'changed';
      return { s: s.up, a: a.up, live: o.up };
    }
    """
    assert run(code, {}) == {"s": "X", "a": "X", "live": "CHANGED"}


def test_round4_builtin_additions():
    code = """
    function selectEmbeddingProperties(doc) {
      const a = [1, 2, 3, 4];
      const removed = a.splice(1, 2, 'x');
      return {
        splice: [a, removed],
        fill: [9, 9, 9].fill(0, 1),
        entries: [...['a', 'b'].entries()],
        keys: [...['a', 'b'].keys()],
        findLast: [1, 2, 3].findLast((x) => x < 3),
        findLastIndex: [1, 2, 3].findLastIndex((x) => x < 3),
        cp: 'abc'.codePointAt(0),
        lc: 'a'.localeCompare('b'),
        norm: 'abc'.normalize('NFC'),
        frozen: Object.freeze({ a: 1 }),
        hasOwn: Object.hasOwn({ a: 1 }, 'a'),
        hop: ({ a: 1 }).hasOwnProperty('a'),
        hopMiss: ({ a: 1 }).hasOwnProperty('b'),
        prec: (1.5).toPrecision(4),
        matches: [...'a1b2'.matchAll(/\\d/g)].length,
      };
    }
    """
    assert run(code, {}) == {
        "splice": [[1, "x", 4], [2, 3]],
        "fill": [9, 0, 0],
        "entries": [[0, "a"], [1, "b"]],
        "keys": [0, 1],
        "findLast": 2,
        "findLastIndex": 1,
        "cp": 97,
        "lc": -1,
        "norm": "abc",
        "frozen": {"a": 1},
        "hasOwn": True,
        "hop": True,
        "hopMiss": False,
        "prec": "1.500",
        "matches": 2,
    }


def test_matchall_requires_global_flag():
    code = "function f(d) { return 'a'.matchAll(/a/); }"
    with pytest.raises(MiniJsError):
        run_hook(code, "f", {})


# -- differential: both packages' run_hook on the same programs ----------------


def _reference_programs():
    """Every hook program in tests/test_minijs.py (its string literals that
    declare a function or class), with the entry point the test calls."""
    import ast
    import os
    import re

    path = os.path.join(os.path.dirname(__file__), "test_minijs.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    seen, out = set(), []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            continue
        code = node.value
        if len(code) <= 15 or not re.search(r"\bfunction\b|=>|\bclass\b", code):
            continue
        declared = re.findall(
            r"(?:function\*?\s+|(?:const|let|var)\s+)([A-Za-z_$][\w$]*)", code)
        entry = next((n for n in ("selectEmbeddingProperties", "hook", "h", "f")
                      if n in declared), None)
        if entry is None or code in seen:
            continue
        seen.add(code)
        out.append(pytest.param(code, entry, id=f"line{node.lineno}"))
    return sorted(out, key=lambda p: int(p.id[4:]))


PROGRAMS = _reference_programs()

FIXED_DOCS = [
    {},
    {"kind": "product", "title": "Solar", "summary": "Panels",
     "description": "d", "body": "b"},
    {"kind": "post", "title": "t", "tags": ["red", "blue"], "price": 3,
     "_internal": "x", "meta": {"level": 5}, "nums": [3, -1, 7, 0]},
    {"parts": ["title", "skip", "body"], "x": "y", "flag": True,
     "name": "Widget", "brand": "ACME", "items": [1, 2, 3]},
    {"title": None, "body": "fallback", "meta": {}, "nums": []},
]


def _outcome(run_hook_fn, code, entry, doc):
    import copy
    import re

    try:
        return ("value", run_hook_fn(code, entry, copy.deepcopy(doc)))
    except Exception as e:  # the class and message are what is compared
        msg = re.sub(r"0x[0-9a-f]+", "0x", str(e))
        return ("raise", [c.__name__ for c in type(e).__mro__[:-1]], msg)


def _same_key(a, b):
    # each runtime has its own `undefined`, and `o[undefined] = v` leaves it
    # behind as a property key: the two stand for the same JS value
    from orama_core_tpu.engine import minijs as ref_minijs
    from orama_core_tpu_torch.engine import minijs as port_minijs

    undefined = (ref_minijs._UNDEFINED, port_minijs._UNDEFINED)
    if any(a is u for u in undefined) or any(b is u for u in undefined):
        return any(a is u for u in undefined) and any(b is u for u in undefined)
    return a == b


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True  # NaN
    if type(a) is not type(b):
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return len(a) == len(b) and all(
            _same_key(ka, kb) and _same(va, vb)
            for (ka, va), (kb, vb) in zip(a.items(), b.items()))
    return a == b


def _assert_same_outcome(code, entry, doc):
    from orama_core_tpu.engine import minijs as ref_minijs
    from orama_core_tpu_torch.engine import minijs as port_minijs

    want = _outcome(ref_minijs.run_hook, code, entry, doc)
    got = _outcome(port_minijs.run_hook, code, entry, doc)
    assert _same(got, want), (doc, got, want)


def test_reference_programs_found():
    assert len(PROGRAMS) >= 90


@pytest.mark.parametrize("code,entry", PROGRAMS)
def test_program_matches_reference_on_fixed_docs(code, entry):
    for doc in FIXED_DOCS:
        _assert_same_outcome(code, entry, doc)


_KEYS = ("title", "summary", "body", "kind", "tags", "nums", "parts", "meta",
         "x", "flag", "name", "brand", "price", "items", "_internal")
_JSON = st.recursive(
    st.none() | st.booleans()
    | st.integers(min_value=-10**6, max_value=10**6)
    | st.floats(allow_nan=False, allow_infinity=False, width=32)
    | st.text(max_size=8),
    lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(st.sampled_from(_KEYS), inner, max_size=4),
    max_leaves=8,
)


@settings(max_examples=120, deadline=None)
@given(
    program=st.sampled_from(PROGRAMS),
    doc=st.dictionaries(st.sampled_from(_KEYS), _JSON, max_size=6),
)
def test_programs_match_reference_on_drawn_docs(program, doc):
    code, entry = program.values
    _assert_same_outcome(code, entry, doc)
