"""The port's hooks runtime (``orama_core_tpu_torch/engine/hooks.py``)
against the JAX package's.

- the execution tiers (tests/test_final_coverage.py:40 and
  tests/test_minijs.py:95, :142): each call goes to a reference runtime
  and a port runtime, and both give the same value or the same error,
  through MiniJS, constant-return extraction, Python callables and the
  opt-in ``node`` subprocess (a stand-in ``node`` script on ``PATH``);
- engine parity: a reference engine and a port engine (``device="cpu"``,
  fake AI backend) get the same dynamic hook and documents; they embed the
  same texts into the same vectors, skip the same vetoed documents and
  give the same hits for fulltext, vector and hybrid queries (scores
  within rtol 1e-5);
- ``hooks.json`` written by either package loads and runs in the other.
"""

import json
import os
import stat

import numpy as np
import pytest

from orama_core_tpu.types import SearchParams as RefParams
from orama_core_tpu_torch.types import SearchParams as PortParams

FN = "selectEmbeddingProperties"
MASTER, READ, WRITE = "master", "read-key", "write-key"

# a branch, a template literal, an array method and a throw
DYNAMIC_HOOK = """
function selectEmbeddingProperties(doc) {
  if (doc.kind === "faq") {
    return `${doc.title}: ${doc.tags.join(", ")}`;
  }
  if (doc.kind === "bad") {
    throw "vetoed " + doc.id;
  }
  return ["title", "summary"];
}
"""


def _runtimes(tmp_path, **kw):
    from orama_core_tpu.engine.hooks import HooksRuntime as Ref
    from orama_core_tpu_torch.engine.hooks import HooksRuntime as Port

    return (Ref(str(tmp_path / "ref"), **kw), Port(str(tmp_path / "port"), **kw))


def _outcome(fn, *args):
    try:
        return ("value", fn(*args))
    except Exception as e:
        return ("raise", type(e).__name__, str(e))


def _both(runtimes, method, *args):
    """Call ``method`` on both runtimes; their outcomes must be equal."""
    ref, port = (_outcome(getattr(rt, method), *args) for rt in runtimes)
    assert port == ref, (method, args)
    return port


def test_hook_static_eval_tiers_match(tmp_path):
    rts = _runtimes(tmp_path)
    # constant-array and constant-string hooks
    _both(rts, "insert_hook", "c", FN,
          "function selectEmbeddingProperties(doc) { return ['a', 'b']; }")
    assert _both(rts, "eval", "c", FN, {"a": 1}) == ("value", ["a", "b"])
    _both(rts, "insert_hook", "c2", FN,
          "function selectEmbeddingProperties(doc) { return 'title'; }")
    assert _both(rts, "eval", "c2", FN, {}) == ("value", "title")
    # python callable tier
    _both(rts, "insert_hook", "c3", FN, lambda doc: ["x"])
    assert _both(rts, "eval", "c3", FN, {}) == ("value", ["x"])
    assert _both(rts, "list_hooks", "c3") == ("value", {FN: "<python <lambda>>"})
    # unknown name and unbalanced code are rejected the same way
    out = _both(rts, "insert_hook", "c", "otherHook", "function otherHook() {}")
    assert out[:2] == ("raise", "HookValidationError")
    out = _both(rts, "insert_hook", "c", FN,
                "function selectEmbeddingProperties(doc) { return ['a';")
    assert out[:2] == ("raise", "HookValidationError")
    # no hook: no override
    assert _both(rts, "eval", "nohook", FN, {"a": 1}) == ("value", None)
    # persisted string hooks reload (callables are not persisted)
    from orama_core_tpu.engine.hooks import HooksRuntime as Ref
    from orama_core_tpu_torch.engine.hooks import HooksRuntime as Port

    again = (Ref(rts[0].data_dir), Port(rts[1].data_dir))
    assert _both(again, "eval", "c", FN, {}) == ("value", ["a", "b"])
    assert _both(again, "get_hook", "c3", FN) == ("value", None)


def test_dynamic_hooks_run_on_bundled_tier_in_both(tmp_path, monkeypatch):
    """tests/test_minijs.py:95 and :142 on both runtimes: a branching
    hook and a for-loop hook run on MiniJS, with no node and the
    subprocess tier off."""
    monkeypatch.delenv("ORAMAX_HOOKS_SUBPROCESS", raising=False)
    rts = _runtimes(tmp_path)
    assert all(rt._node is None for rt in rts)
    _both(rts, "insert_hook", "c", FN, """
        function selectEmbeddingProperties(doc) {
          if (doc.kind === 'code') { return ['snippet']; }
          return ['title'];
        }""")
    assert _both(rts, "eval", "c", FN, {"kind": "code", "snippet": "x"}) == \
        ("value", ["snippet"])
    assert _both(rts, "eval", "c", FN, {"kind": "doc"}) == ("value", ["title"])
    _both(rts, "insert_hook", "c", FN, """
        function selectEmbeddingProperties(doc) {
          let out = [];
          for (let i = 0; i < doc.parts.length; i++) {
            if (doc.parts[i] !== 'skip') { out.push(doc.parts[i]); }
          }
          return out;
        }""")
    assert _both(rts, "eval", "c", FN, {"parts": ["title", "skip", "body"]}) \
        == ("value", ["title", "body"])


def test_error_mapping_matches(tmp_path, monkeypatch):
    """A throw and a budget kill are per-document RuntimeErrors; a hook
    that parses but needs JS outside the subset is refused with the
    subprocess tier off; a bad return type is refused; the document the
    hook sees is a copy."""
    monkeypatch.delenv("ORAMAX_HOOKS_SUBPROCESS", raising=False)
    rts = _runtimes(tmp_path)
    _both(rts, "insert_hook", "c", FN, DYNAMIC_HOOK)
    out = _both(rts, "eval", "c", FN, {"id": "7", "kind": "bad"})
    assert out[:2] == ("raise", "RuntimeError") and "hook threw" in out[2]
    assert _both(rts, "eval", "c", FN, {"kind": "faq", "title": "T",
                                         "tags": ["a", "b"]}) == \
        ("value", "T: a, b")
    _both(rts, "insert_hook", "c", FN,
          "function selectEmbeddingProperties(d) { while (true) {} }")
    out = _both(rts, "eval", "c", FN, {})
    assert out[:2] == ("raise", "RuntimeError") and "budgets" in out[2]
    _both(rts, "insert_hook", "c", FN,
          'function selectEmbeddingProperties(doc) {'
          ' if (doc.x.toWellFormed() === "y") { return ["a"]; } return ["b"]; }')
    out = _both(rts, "eval", "c", FN, {"x": "y"})
    assert out[:2] == ("raise", "RuntimeError") and "subprocess" in out[2]
    _both(rts, "insert_hook", "c", FN,
          "function selectEmbeddingProperties(doc) { return 3; }")
    out = _both(rts, "eval", "c", FN, {})
    assert out[:2] == ("raise", "RuntimeError") and "unsupported" in out[2]
    _both(rts, "insert_hook", "c", FN,
          'function selectEmbeddingProperties(doc) {'
          ' doc.title = "HACKED"; doc.tags.push("x"); return ["title"]; }')
    doc = {"title": "original", "tags": ["a"]}
    assert _both(rts, "eval", "c", FN, doc) == ("value", ["title"])
    assert doc == {"title": "original", "tags": ["a"]}


def _fake_node(tmp_path, body):
    """A stand-in ``node`` on PATH: a shell script that records its
    arguments and runs ``body``."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    node = bindir / "node"
    node.write_text(
        "#!/bin/sh\n"
        f'printf "%s\\n" "$@" > "{tmp_path}/node_args"\n' + body + "\n")
    node.chmod(node.stat().st_mode | stat.S_IXUSR)
    return str(bindir)


# MiniJS does not parse `||=` and the hook has no constant return, so only
# the subprocess tier can run it
NODE_ONLY_HOOK = (
    "function selectEmbeddingProperties(doc) { doc.k ||= 'body'; "
    "return [doc.k]; }")


@pytest.mark.parametrize("how", ["env", "argument"])
def test_subprocess_tier_opt_in(tmp_path, monkeypatch, how):
    """The node tier runs only when opted into, under --permission, and
    its JSON output is the hook's value, in both packages."""
    monkeypatch.setenv("PATH", _fake_node(tmp_path, "echo '[\"title\"]'")
                       + os.pathsep + os.environ["PATH"])
    monkeypatch.delenv("ORAMAX_HOOKS_SUBPROCESS", raising=False)
    off = _runtimes(tmp_path / "off")
    out = _both(off, "insert_hook", "c", FN, NODE_ONLY_HOOK)
    assert out[:2] == ("raise", "HookValidationError")
    if how == "env":
        monkeypatch.setenv("ORAMAX_HOOKS_SUBPROCESS", "1")
        rts = _runtimes(tmp_path / "on")
    else:
        rts = _runtimes(tmp_path / "on", allow_subprocess=True)
    assert all(rt._node and rt._node.endswith("node") for rt in rts)
    _both(rts, "insert_hook", "c", FN, NODE_ONLY_HOOK)
    assert _both(rts, "eval", "c", FN, {"k": "title"}) == ("value", ["title"])
    args = (tmp_path / "node_args").read_text().splitlines()
    assert args[:2] == ["--permission", "-e"]
    assert "JSON.stringify(selectEmbeddingProperties(__doc))" in args[-1]
    # a hook MiniJS runs never reaches node, opted in or not
    _both(rts, "insert_hook", "c", FN, DYNAMIC_HOOK)
    assert _both(rts, "eval", "c", FN, {"kind": "x"}) == \
        ("value", ["title", "summary"])


@pytest.mark.parametrize("script,needle", [
    ("echo 'node: bad option: --permission' >&2; exit 9", "permission model"),
    ("echo 'ReferenceError: k is not defined' >&2; exit 1", "hook failed"),
])
def test_subprocess_tier_failures(tmp_path, monkeypatch, script, needle):
    """A node without the permission model is refused rather than run
    unsandboxed; a failing script is a per-document RuntimeError."""
    monkeypatch.setenv("PATH", _fake_node(tmp_path, script)
                       + os.pathsep + os.environ["PATH"])
    rts = _runtimes(tmp_path, allow_subprocess=True)
    _both(rts, "insert_hook", "c", FN, NODE_ONLY_HOOK)
    out = _both(rts, "eval", "c", FN, {"k": "title"})
    assert out[:2] == ("raise", "RuntimeError") and needle in out[2]


# -- hooks.json across packages ----------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_hooks_json_loads_in_the_other_package(tmp_path, writer):
    from orama_core_tpu.engine.hooks import HooksRuntime as Ref
    from orama_core_tpu_torch.engine.hooks import HooksRuntime as Port

    src, dst = (Ref, Port) if writer == "ref" else (Port, Ref)
    d = str(tmp_path / "hooks")
    a = src(d)
    a.insert_hook("c1", FN, DYNAMIC_HOOK)
    a.insert_hook("c2", FN,
                  "function selectEmbeddingProperties(doc) { return ['a']; }")
    a.insert_hook("c3", FN, lambda doc: ["not persisted"])
    with open(os.path.join(d, "hooks.json")) as f:
        stored = json.load(f)
    assert stored == [
        {"collection": "c1", "name": FN, "code": DYNAMIC_HOOK},
        {"collection": "c2", "name": FN, "code":
         "function selectEmbeddingProperties(doc) { return ['a']; }"},
    ]
    b = dst(d)
    assert b.list_hooks("c1") == {FN: DYNAMIC_HOOK}
    assert b.get_hook("c3", FN) is None
    doc = {"kind": "faq", "title": "T", "tags": ["x", "y"]}
    assert b.eval("c1", FN, doc) == a.eval("c1", FN, doc) == "T: x, y"
    assert b.eval("c2", FN, {}) == ["a"]
    b.delete_hook("c2", FN)
    assert src(d).get_hook("c2", FN) is None


# -- engine parity -----------------------------------------------------------


def _docs(n=48, seed=3):
    rng = np.random.default_rng(seed)
    words = ["solar", "panel", "battery", "wind", "turbine", "grid", "storage",
             "inverter", "roof", "cable", "meter", "heat", "pump", "charge"]
    out = []
    for i in range(n):
        kind = ("faq", "other", "bad")[0 if i % 2 else (2 if i % 8 == 0 else 1)]
        out.append({
            "id": str(i),
            "kind": kind,
            "title": " ".join(rng.choice(words, 2)),
            "summary": " ".join(rng.choice(words, 4)),
            "body": " ".join(rng.choice(words, 8)),
            "tags": [str(t) for t in rng.choice(words, int(rng.integers(1, 4)))],
            "price": float(rng.integers(1, 100)),
        })
    return out


class HookedPair:
    """A reference engine and a port engine with the same hook; each
    records the texts its AI service embeds and the vectors it returns."""

    def __init__(self, tmp_path):
        from orama_core_tpu import build_orama as ref_build
        from orama_core_tpu.config import OramaxConfig as RefCfg
        from orama_core_tpu_torch import build_orama as port_build
        from orama_core_tpu_torch.config import OramaxConfig as PortCfg

        self.engines, self.embedded = [], []
        for side, build, Cfg in (("ref", ref_build, RefCfg),
                                 ("port", port_build, PortCfg)):
            cfg = Cfg()
            cfg.writer_side.data_dir = str(tmp_path / f"{side}-w")
            cfg.reader_side.data_dir = str(tmp_path / f"{side}-r")
            cfg.writer_side.commit_interval_sec = 3600.0
            cfg.reader_side.commit_interval_sec = 3600.0
            cfg.ai.backend = "fake"
            if side == "ref":
                cfg.tpu._test_force_fast_path = True
                e = build(cfg, start_background=False)
            else:
                e = build(cfg, start_background=False, device="cpu")
            self.engines.append(e)
            self.embedded.append(self._spy(e))
        self.ref, self.port = self.engines

    @staticmethod
    def _spy(engine):
        log = []
        embed_passage = engine.ai.embed_passage

        def spy(model, texts):
            vecs = embed_passage(model, texts)
            log.extend(zip(texts, np.asarray(vecs)))
            return vecs

        engine.ai.embed_passage = spy
        return log

    def do(self, fn):
        for e in self.engines:
            fn(e)

    def compare(self, body):
        r = self.ref.read_side.search("c1", RefParams.from_json(dict(body)), READ)
        p = self.port.read_side.search("c1", PortParams.from_json(dict(body)),
                                       READ)
        assert [h.id for h in p.hits] == [h.id for h in r.hits], body
        assert p.count == r.count, body
        np.testing.assert_allclose([h.score for h in p.hits],
                                   [h.score for h in r.hits], rtol=1e-5,
                                   err_msg=str(body))
        return p


@pytest.mark.parametrize("stage", ["uncommitted", "committed"])
def test_hooked_engines_match(tmp_path, stage):
    pair = HookedPair(tmp_path)
    docs = _docs()
    try:
        pair.do(lambda e: e.write_side.create_collection(
            MASTER, "c1", read_api_key=READ, write_api_key=WRITE))
        pair.do(lambda e: e.flush())
        pair.do(lambda e: e.hooks.insert_hook("c1", FN, DYNAMIC_HOOK))
        pair.do(lambda e: e.write_side.write("c1", docs, WRITE))
        pair.do(lambda e: e.flush())
        if stage == "committed":
            pair.do(lambda e: e.commit())
        ref_log, port_log = pair.embedded
        assert [t for t, _ in port_log] == [t for t, _ in ref_log]
        np.testing.assert_allclose(np.stack([v for _, v in port_log]),
                                   np.stack([v for _, v in ref_log]),
                                   rtol=1e-6, atol=1e-7)
        # the embedded text is the hook's selection, by the write rule
        from orama_core_tpu_torch.engine.collection_write import (
            embedding_text, flatten_document)
        from orama_core_tpu_torch.engine.minijs import MiniJsThrow, run_hook

        want = []
        for d in docs:
            try:
                sel = run_hook(DYNAMIC_HOOK, FN, dict(d))
            except MiniJsThrow:
                continue  # vetoed: stored, not embedded
            want.append(embedding_text(flatten_document(d), sel, (), ()))
        assert [t for t, _ in port_log] == want
        assert pair.port.read_side.count_documents("c1") == len(docs)
        assert pair.ref.read_side.count_documents("c1") == len(docs)
        for d in docs[:10]:
            text = embedding_text(flatten_document(d), None, (), ())
            pair.compare({"term": d["title"], "mode": "fulltext"})
            pair.compare({"term": text, "mode": "vector", "limit": 5})
            pair.compare({"term": d["title"], "mode": "hybrid", "limit": 5})
        # a vetoed document is fulltext-searchable but has no vector
        bad = next(d for d in docs if d["kind"] == "bad")
        hits = pair.compare({"term": bad["body"], "mode": "fulltext",
                             "limit": len(docs)})
        assert bad["id"] in [h.id for h in hits.hits]
        # the faq branch's text finds its own document first
        faq = next(d for d in docs if d["kind"] == "faq")
        text = f"{faq['title']}: {', '.join(faq['tags'])}"
        hits = pair.compare({"term": text, "mode": "vector", "limit": 3})
        assert hits.hits[0].id == faq["id"]
    finally:
        pair.do(lambda e: e.close())
