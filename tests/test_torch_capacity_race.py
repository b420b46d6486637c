"""The single-device reader while writes grow its capacity and commit.

A search sizes its score buffers, masks and K1's output row by the
reader's capacity. Writes past the last capacity bucket grow it, and a
commit then publishes generations holding those doc ids. A search pins
one view of the reader (the field containers, the tombstones, and the
capacity that covers their generations) and reads nothing else, so a
commit that lands while it runs can neither hand it a generation past
its buffers nor be half seen. These tests hold every such search to a
fresh reader that replayed the same writes up to the state the search
read; the mesh twin is tests/test_torch_engine_mesh.py's
``test_concurrent_mesh_searches_while_capacity_grows``.
"""

import sys
import threading

import numpy as np
import pytest

from orama_core_tpu_torch.config import GpuConfig
from orama_core_tpu_torch.engine import collection_read as cr
from orama_core_tpu_torch.engine.collection_read import CollectionReader
from orama_core_tpu_torch.oplog import (CreateFieldOp, IndexEmbeddingOp,
                                        IndexStringOp, InsertDocumentOp)
from orama_core_tpu_torch.types import SearchParams, TypedField, ValueType

WORDS = ["solar", "wind", "cake", "qubit", "grid"]
BODIES = [{"term": "solar"}, {"term": "wind grid"},
          {"term": "x", "mode": "vector"}, {"term": "qubit", "mode": "hybrid"}]
BATCHES = [["solar", "qubit", "cake"], ["grid", "wind"]]


def _doc_ops(i, rng, words=None):
    """The ops of one document: alive, a 3-word body, a 16-d embedding."""
    words = words if words is not None else rng.choice(WORDS, 3)
    return [
        InsertDocumentOp("c", i, {"id": str(i)}),
        IndexStringOp("c", i, 0, len(words),
                      {w: (p,) for p, w in enumerate(words)}),
        IndexEmbeddingOp("c", i, 1,
                         (tuple(map(float, rng.standard_normal(16))),)),
    ]


class Script:
    """A reader's history as a list of events (an op, or a commit), so a
    fresh reader can replay any prefix of it."""

    def __init__(self, tmp_path, seed=9):
        self.tmp = tmp_path
        self.rng = np.random.default_rng(seed)
        self.events = [("op", CreateFieldOp("c", TypedField(
            0, "body", ValueType.STRING))), ("op", CreateFieldOp("c", TypedField(
                1, "emb", ValueType.EMBEDDING, model="fake-small")))]
        for i in range(200):
            self.events += [("op", o) for o in _doc_ops(i, self.rng)]
        self.events.append(("commit", None))
        self.n_commits = 0
        self.fresh = {}

    def round_events(self, base, n=4):
        """Documents past the capacity bucket starting at ``base``, each
        holding every query's words, then a commit."""
        out = []
        for i in range(base, base + n):
            out += [("op", o) for o in _doc_ops(i, self.rng, WORDS)]
        return out + [("commit", None)]

    def play(self, reader, events, tag):
        for kind, op in events:
            if kind == "op":
                reader.apply(op)
            else:
                self.n_commits += 1
                reader.commit(str(self.tmp / f"{tag}-{self.n_commits}"),
                              offset=self.n_commits)

    def reader(self, upto=None, tag="live"):
        r = CollectionReader("c", "rk", None, GpuConfig(device="cpu"))
        self.play(r, self.events[:upto], tag)
        return r

    def fresh_reader(self, upto):
        """A reader that replayed the first ``upto`` events (cached)."""
        if upto not in self.fresh:
            self.fresh[upto] = self.reader(upto, tag=f"fresh{upto}")
        return self.fresh[upto]


class AI:
    """A fixed 16-d query embedding; ``hook`` runs once, on the first
    embedding after it is set (a point inside a vector search)."""

    def __init__(self, seed=3):
        self.q = np.random.default_rng(seed).standard_normal(
            (1, 16)).astype(np.float32)
        self.hook = None

    def embed_query(self, model, texts):
        hook, self.hook = self.hook, None
        if hook is not None:
            hook()
        return np.repeat(self.q, len(texts), axis=0)


def _ids(res):
    return [d for d, _ in res[0]], res[1]


def _search(reader, ai, body):
    if isinstance(body, list):
        return reader.search_batch(
            [SearchParams.from_json({"term": t}) for t in body], ai)
    return reader.search(SearchParams.from_json(dict(body)), ai)


def _same(got, want, what):
    if isinstance(what, list):
        assert len(got) == len(want), what
        for g, w, t in zip(got, want, what):
            _same(g, w, {"term": t})
        return
    assert _ids(got) == _ids(want), what
    np.testing.assert_allclose([s for _, s in got[0]],
                               [s for _, s in want[0]], rtol=1e-5,
                               err_msg=str(what))


def _same_as_one(got, wants, what):
    """``got`` equals one of ``wants``."""
    misses = []
    for want in wants:
        try:
            _same(got, want, what)
            return
        except AssertionError as e:
            misses.append(e)
    raise AssertionError(f"{what}: equal to none of {len(wants)} states: "
                         f"{misses}")


def _cache_holds_only_current(reader):
    """The device cache pins no generation a commit has replaced."""
    current = {id(f.committed) for table in (
        reader._string, reader._number, reader._keyword, reader._bool,
        reader._vector) for f in table.values()}
    stale = [type(o).__name__ for k, o in reader._device._keepalive.items()
             if k not in current]
    assert not stale, f"the device cache keeps superseded generations {stale}"


@pytest.mark.parametrize("body", BODIES + BATCHES, ids=[
    "fulltext", "phrase", "vector", "hybrid", "batch3", "batch2"])
def test_commit_inside_a_search(tmp_path, monkeypatch, body):
    """A writer grows the capacity past the first 8,192 slots and commits
    at a point inside the search (after it began, before it reads the
    string or vector generation). The search returns the hits of the
    state it began in, or, where it met one of the new docs in a window
    it shares with the writer (all of them are past its capacity), those
    of the state after the commit, read from a new view; the next search
    returns those of the new state."""
    script = Script(tmp_path)
    reader = script.reader()
    ai = AI()
    n0 = len(script.events)
    script.events += script.round_events(8192)
    before = _search(script.fresh_reader(n0), ai, body)

    def writer():
        t = threading.Thread(target=script.play,
                             args=(reader, script.events[n0:], "live"))
        t.start()
        t.join()

    # the first of the two hooks a search meets: the vector modes embed
    # their query, the text modes expand their terms
    expand = cr.query_expansion

    def expand_then_write(parser, term):
        hook, ai.hook = ai.hook, None
        if hook is not None:
            hook()
        return expand(parser, term)

    monkeypatch.setattr(cr, "query_expansion", expand_then_write)
    ai.hook = writer
    got = _search(reader, ai, body)
    assert ai.hook is None, "the writer never ran inside the search"
    assert reader.capacity == 16384
    after = _search(script.fresh_reader(len(script.events)), ai, body)
    _same_as_one(got, [before, after], body)
    _same(_search(reader, ai, body), after, body)
    _cache_holds_only_current(reader)


def test_concurrent_searches_while_capacity_grows(tmp_path):
    """Searches from 8 threads (a short switch interval: fulltext, phrase,
    vector, hybrid and batches) while a writer grows the capacity by three
    buckets and commits after each. Every search returns. A search during
    which no op landed (commits may) equals a fresh reader that replayed
    the writes up to one of the points it could have pinned its view at;
    one during which an op landed (a window it shares with the writer
    moved under it) returns well-formed hits of docs that exist. Afterwards
    the hits equal a fresh reader's, and the device cache holds only the
    current generations."""
    script = Script(tmp_path)
    reader = script.reader()
    ai = AI()
    n0 = len(script.events)
    for r in (1, 2, 3):
        script.events += script.round_events(8192 * r)
    # events the live reader began and finished playing: a search that
    # began after ``done`` and ended before ``begun`` moved on can have
    # seen only events[done:begun]
    begun, done = [n0], [n0]
    records, errors = [], []
    queries = BODIES + BATCHES

    def searcher(k):
        try:
            for j in range(12):
                body = queries[(j + k) % len(queries)]
                b = done[0]
                res = _search(reader, ai, body)
                records.append((b, begun[0], body, res))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def writer():
        for i in range(n0, len(script.events)):
            begun[0] = i + 1
            script.play(reader, script.events[i:i + 1], "live")
            done[0] = i + 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=searcher, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        w = threading.Thread(target=writer)
        w.start()
        for t in threads + [w]:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads + [w])
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert reader.capacity == 4 * 8192

    quiet = 0
    for b, a, body, res in records:
        if all(kind == "commit" for kind, _ in script.events[b:a]):
            # a view is pinned wholly before or after each commit
            quiet += 1
            _same_as_one(res, [_search(script.fresh_reader(j), ai, body)
                               for j in range(b, a + 1)], body)
        else:
            for ranked, _count in (res if isinstance(body, list)
                                   else [res[:2]]):
                docs = [d for d, _ in ranked]
                scores = [s for _, s in ranked]
                assert len(set(docs)) == len(docs), body
                assert all(0 <= d < reader.capacity for d in docs), body
                assert scores == sorted(scores, reverse=True), body
    assert quiet, "no search ran between two writes"
    final = script.fresh_reader(len(script.events))
    for body in queries:
        _same(_search(reader, ai, body), _search(final, ai, body), body)
    _cache_holds_only_current(reader)
