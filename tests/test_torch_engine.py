"""The PyTorch port end to end against the JAX package: a reference engine
and a port engine (``device="cpu"``, fake AI backend) receive the same
writes, deletes and commits, and every query must give the same hits, in
the same order, with the same match count and facets, scores within
rtol 1e-5. The reference reader is forced onto its kernel branches
(``_test_force_fast_path``), as tests/test_vector_fast.py and
tests/test_aa_smoke.py do, so both engines take the same branch (the
reference runs its Pallas kernels in interpret mode)."""

import numpy as np
import pytest

from orama_core_tpu.types import SearchParams as RefParams
from orama_core_tpu_torch.types import SearchParams as PortParams

MASTER, READ, WRITE = "master", "read-key", "write-key"


class Pair:
    """A reference engine and a port engine driven in lockstep."""

    def __init__(self, tmp_path, tag="e", **knobs):
        from orama_core_tpu import build_orama as ref_build
        from orama_core_tpu.config import OramaxConfig as RefCfg
        from orama_core_tpu_torch import build_orama as port_build
        from orama_core_tpu_torch.config import OramaxConfig as PortCfg

        self.engines = []
        for side, (build, Cfg) in (("ref", (ref_build, RefCfg)),
                                   ("port", (port_build, PortCfg))):
            cfg = Cfg()
            cfg.writer_side.data_dir = str(tmp_path / f"{tag}-{side}-w")
            cfg.reader_side.data_dir = str(tmp_path / f"{tag}-{side}-r")
            cfg.writer_side.insert_batch_commit_size = 10_000_000
            cfg.reader_side.insert_batch_commit_size = 10_000_000
            cfg.writer_side.commit_interval_sec = 3600.0
            cfg.reader_side.commit_interval_sec = 3600.0
            cfg.ai.backend = "fake"
            dev_cfg = cfg.tpu if side == "ref" else cfg.gpu
            for k, v in knobs.items():
                setattr(dev_cfg, k, v)
            if side == "ref":
                dev_cfg._test_force_fast_path = True
                self.engines.append(build(cfg, start_background=False))
            else:
                self.engines.append(
                    build(cfg, start_background=False, device="cpu"))
        self.ref, self.port = self.engines

    def do(self, fn):
        for e in self.engines:
            fn(e)

    def create(self, cid="c1"):
        self.do(lambda e: e.write_side.create_collection(
            MASTER, cid, read_api_key=READ, write_api_key=WRITE))
        self.do(lambda e: e.flush())

    def write(self, docs, cid="c1"):
        self.do(lambda e: e.write_side.write(cid, docs, WRITE))
        self.do(lambda e: e.flush())

    def commit(self):
        self.do(lambda e: e.commit())

    def compare(self, body, cid="c1"):
        r = self.ref.read_side.search(cid, RefParams.from_json(dict(body)), READ)
        p = self.port.read_side.search(cid, PortParams.from_json(dict(body)), READ)
        assert [h.id for h in p.hits] == [h.id for h in r.hits], body
        assert p.count == r.count, body
        np.testing.assert_allclose([h.score for h in p.hits],
                                   [h.score for h in r.hits], rtol=1e-5,
                                   err_msg=str(body))
        if r.facets is None:
            assert p.facets is None
        else:
            assert {k: (v.count, v.values) for k, v in p.facets.items()} == \
                {k: (v.count, v.values) for k, v in r.facets.items()}, body
        return p

    def close(self):
        self.do(lambda e: e.close())


DOCS = [
    {"id": "1", "title": "The cat sat on the mat", "price": 10, "in_stock": True},
    {"id": "2", "title": "A dog chased the cat", "price": 25, "in_stock": False},
    {"id": "3", "title": "Quantum computing explained", "price": 50, "in_stock": True},
    {"id": "4", "title": "Dogs are loyal animals", "price": 5, "in_stock": True},
]

ENGINE_QUERIES = [
    {"term": "cat"},                                            # simple
    {"term": "dog cat"},                                        # phrase
    {"term": "cat", "limit": 1},                                # limit
    {"term": "cat", "offset": 1, "limit": 1},                   # offset
    {"term": "", "where": {"price": {"gte": 10}}},              # filter only
    {"term": "cat", "where": {"price": {"between": [5, 20]}}},
    {"term": "dog", "where": {"in_stock": False}},
    {"term": "cat", "facets": {
        "price": {"ranges": [{"from": 0, "to": 20}, {"from": 20, "to": 60}]},
        "in_stock": {"true": True, "false": True}}},
    {"term": "computing", "mode": "vector"},
    {"term": "loyal dogs", "mode": "hybrid"},
    {"term": "cat", "mode": "hybrid", "fusion": "minmax"},
    {"term": "cat", "boost": {"title": 3.0}},
    {"term": "cat", "properties": ["title"]},
]


@pytest.mark.parametrize("stage", ["uncommitted", "committed", "mixed"])
def test_engine_queries_match(tmp_path, stage):
    pair = Pair(tmp_path)
    try:
        pair.create()
        pair.write(DOCS)
        if stage != "uncommitted":
            pair.commit()
        if stage == "mixed":
            pair.write([{"id": "5", "title": "another cat appears", "price": 7}])
        for body in ENGINE_QUERIES:
            pair.compare(body)
    finally:
        pair.close()


def test_delete_upsert_and_raw_vector_match(tmp_path):
    pair = Pair(tmp_path)
    try:
        pair.create()
        pair.write(DOCS)
        pair.commit()
        pair.do(lambda e: e.write_side.delete_documents("c1", ["1"], WRITE))
        pair.do(lambda e: e.flush())
        pair.write([{"id": "2", "title": "A new dog story", "price": 26}])
        for body in ({"term": "cat"}, {"term": "dog"},
                     {"term": "dog", "mode": "hybrid"}):
            pair.compare(body)
        pair.commit()
        for body in ({"term": "cat"}, {"term": "dog", "mode": "vector"}):
            pair.compare(body)
        ai = pair.ref.read_side.ai
        target = ai.embed_passage("fake-small", ["Quantum computing explained"])[0]
        p = pair.compare({"mode": "vector", "vector": [float(x) for x in target]})
        assert p.hits[0].id == "3"
    finally:
        pair.close()


def test_phrase_multiterm_ranking_matches(tmp_path):
    pair = Pair(tmp_path)
    try:
        pair.create()
        pair.write([
            {"id": "seq", "body": "machine learning is great"},
            {"id": "sep", "body": "machine tools and deep learning"},
            {"id": "one", "body": "machine parts catalog"},
        ])
        pair.commit()
        p = pair.compare({"term": "machine learning"})
        assert p.hits[0].id == "seq"
    finally:
        pair.close()


def _dense_corpus():
    rng = np.random.default_rng(7)
    vocab = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    docs = []
    for i in range(48):
        words = ["common"] * int(rng.integers(1, 4)) + list(
            rng.choice(vocab, size=int(rng.integers(2, 5))))
        rng.shuffle(words)
        docs.append({"id": str(i), "body": " ".join(words)})
    return docs


def test_fused_and_dense_rows_match(tmp_path):
    """tests/test_aa_smoke.py's canonical fused shape and its dense
    head-term rows (df_ratio huge so 'common' qualifies)."""
    pair = Pair(tmp_path, bm25_dense_terms=16, bm25_dense_df_ratio=10**6)
    try:
        pair.create()
        pair.write(_dense_corpus())
        pair.commit()
        rd = pair.port.read_side._reader("c1")
        sfid = next(f for f, x in rd.fields.items() if x.type.name == "STRING")
        rows, row_by_term = rd._device.dense_term_rows(
            rd._string[sfid].committed, rd.capacity, 1.0)
        assert rows is not None and row_by_term
        for term in ("common", "common alpha", "beta common gamma"):
            p = PortParams.from_json({"term": term, "limit": 32})
            assert rd._hybrid_fused_eligible(p) is not None
            pair.compare({"term": term, "limit": 32})
    finally:
        pair.close()


def test_phrase_windowed_corpus_matches(tmp_path):
    """tests/test_aa_smoke.py's phrase corpus through the fused path and,
    with a live window, the multi-dispatch path (both reach K4)."""
    rng = np.random.default_rng(11)
    vocab = ["cat", "dog", "mat", "sat", "ran", "bird", "tree", "sky"]
    docs = []
    for i in range(260):
        words = list(rng.choice(vocab, size=int(rng.integers(4, 12))))
        if i % 3 == 0:
            words[1:3] = ["cat", "sat"]
        docs.append({"id": str(i), "body": " ".join(words)})
    pair = Pair(tmp_path)
    try:
        pair.create()
        pair.write(docs)
        pair.commit()
        for term in ("cat sat", "sat mat", "dog ran tree"):
            pair.compare({"term": term, "limit": 40})
        pair.write([{"id": "live", "body": "cat sat sky"}])
        rd = pair.port.read_side._reader("c1")
        assert rd._hybrid_fused_eligible(
            PortParams.from_json({"term": "cat sat"})) is not None
        for term in ("cat sat", "sat mat"):
            pair.compare({"term": term, "limit": 40})
            pair.compare({"term": term, "limit": 40, "mode": "hybrid"})
    finally:
        pair.close()


def _fast_readers(tombstones=False, window=False):
    """tests/test_vector_fast.py's reader (8192 x 128, fake-small) and its
    port, carried over from the reference's committed arrays."""
    from orama_core_tpu.config import TpuConfig
    from orama_core_tpu.engine.collection_read import CollectionReader
    from orama_core_tpu.index import CommittedVectorIndex
    from orama_core_tpu.oplog import CreateFieldOp, DeleteDocumentsOp
    from orama_core_tpu.types import TypedField, ValueType
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.carry import export_arrays, reader_from_arrays

    n, d = 8192, 128
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ref = CollectionReader("vfast", "rk", None, TpuConfig())
    ref._apply_locked(CreateFieldOp("vfast", TypedField(
        0, "embedding", ValueType.EMBEDDING, model="fake-small")))
    ref.max_doc_id = n - 1
    ref._alive = np.ones(ref.capacity, dtype=np.float32)
    ref.doc_count = n
    ref._vector[0].committed = CommittedVectorIndex(
        dimension=d, vecs=vecs, vec_docs=np.arange(n, dtype=np.int32))
    ref.cfg._test_force_fast_path = True
    port = reader_from_arrays(**export_arrays(ref), gpu_cfg=GpuConfig(device="cpu"))
    if tombstones:
        from orama_core_tpu_torch.oplog import DeleteDocumentsOp as PortDelete

        ref.apply(DeleteDocumentsOp("vfast", (3, 17, 4000)))
        port.apply(PortDelete("vfast", (3, 17, 4000)))
    if window:
        from orama_core_tpu.models.ai_service import AIService

        q = AIService().embed_query("fake-small", ["fresh stuff"])[0]
        q = q / np.linalg.norm(q)
        for r in (ref, port):
            r._vector[0].uncommitted.insert(n + 1, [q])
            r._vector[0].uncommitted.insert(n + 2, [-q])
            r.max_doc_id = n + 2
            r._alive = np.ones(r.capacity, dtype=np.float32)
    return ref, port


@pytest.mark.parametrize("variant", ["plain", "tombstones", "window"])
def test_fast_knn_reader_matches(variant, monkeypatch):
    from orama_core_tpu.models.ai_service import AIService as RefAI
    from orama_core_tpu_torch.models.ai_service import AIService as PortAI

    ref, port = _fast_readers(tombstones=variant == "tombstones",
                              window=variant == "window")
    calls = []
    orig = port._search_vector_topk_fast
    monkeypatch.setattr(port, "_search_vector_topk_fast",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    for body in ({"term": "solar energy", "mode": "vector", "limit": 7},
                 {"term": "quantum", "mode": "vector"},
                 {"term": "fresh stuff", "mode": "vector", "limit": 20}):
        assert port._vector_fast_field(PortParams.from_json(dict(body))) == 0
        assert ref._vector_fast_field(RefParams.from_json(dict(body))) == 0
        rr, rc, _ = ref.search(RefParams.from_json(dict(body)), RefAI())
        pr, pc, _ = port.search(PortParams.from_json(dict(body)), PortAI())
        assert [d for d, _ in pr] == [d for d, _ in rr], body
        assert pc == rc, body
        np.testing.assert_allclose([s for _, s in pr], [s for _, s in rr],
                                   rtol=1e-5)
    assert len(calls) == 3, "the port did not take the fused kNN branch"


def test_kernel_knobs_gate_nothing(tmp_path, monkeypatch):
    """use_pallas, bm25_pallas and phrase_windowed stay in GpuConfig only so
    the reference's configs load: turned off, the port still serves through
    K1's aligned plan, K4 and the fused kNN, with the same hits."""
    from orama_core_tpu_torch.ops import bm25 as port_bm25

    calls = {"bm25_scores_blocked_aligned": 0, "phrase_counts": 0}
    for name in calls:
        orig = getattr(port_bm25, name)

        def spy(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(port_bm25, name, spy)
    pair = Pair(tmp_path)
    try:
        pair.create()
        pair.write(DOCS)
        pair.commit()
        cfg = pair.port.read_side._reader("c1").cfg
        for knob in ("use_pallas", "bm25_pallas", "phrase_windowed"):
            setattr(cfg, knob, False)
        for body in ({"term": "cat"}, {"term": "dog cat"},
                     {"term": "dog cat", "mode": "hybrid"}):
            pair.compare(body)
    finally:
        pair.close()
    assert calls["bm25_scores_blocked_aligned"] >= 3, calls
    assert calls["phrase_counts"] >= 2, calls
    _ref, port = _fast_readers()
    port.cfg.use_pallas = False
    body = {"term": "quantum", "mode": "vector"}
    assert port._vector_fast_field(PortParams.from_json(body)) == 0
    # int8_phase1 picks the reference's int8 phase 1 (its XLA matmul or
    # its in-kernel dot); on the card K5 serves both, with the same hits
    from orama_core_tpu_torch.ops import knn as port_knn
    from test_torch_engine_int8 import _int8_fast_readers, _search_pair

    k5 = []
    orig = port_knn.subblock_max_int8
    monkeypatch.setattr(port_knn, "subblock_max_int8",
                        lambda *a, **k: k5.append(1) or orig(*a, **k))
    hits = {}
    for phase1 in ("xla", "pallas"):
        ref8, port8 = _int8_fast_readers(phase1=phase1)
        hits[phase1] = _search_pair(ref8, port8, body)
    assert hits["xla"] == hits["pallas"]
    assert len(k5) == 2, "int8_phase1 must not route around K5"


def test_reference_data_dir_loads_into_port(tmp_path):
    """A data directory committed by orama_core_tpu.build_orama loads into
    orama_core_tpu_torch.build_orama, and searching it gives the same hits."""
    from orama_core_tpu import build_orama as ref_build
    from orama_core_tpu.config import OramaxConfig as RefCfg
    from orama_core_tpu_torch import build_orama as port_build
    from orama_core_tpu_torch.config import OramaxConfig as PortCfg

    dirs = {"w": str(tmp_path / "w"), "r": str(tmp_path / "r")}

    def cfg_of(Cfg):
        cfg = Cfg()
        cfg.writer_side.data_dir, cfg.reader_side.data_dir = dirs["w"], dirs["r"]
        cfg.ai.backend = "fake"
        return cfg

    ref = ref_build(cfg_of(RefCfg), start_background=False)
    ref.write_side.create_collection(MASTER, "c1", read_api_key=READ,
                                     write_api_key=WRITE)
    ref.flush()
    ref.write_side.write("c1", DOCS + [
        {"id": str(i), "title": f"cat number {i} on a mat", "price": i}
        for i in range(10, 40)], WRITE)
    ref.flush()
    ref.write_side.delete_documents("c1", ["12"], WRITE)
    ref.commit()
    cfg = cfg_of(RefCfg)
    cfg.tpu._test_force_fast_path = True
    ref.close()
    ref = ref_build(cfg, start_background=False)
    port = port_build(cfg_of(PortCfg), start_background=False, device="cpu")
    try:
        for body in ({"term": "cat mat"}, {"term": "cat", "where": {"price": {"gt": 20}}},
                     {"term": "dog", "mode": "hybrid"}, {"term": "cat", "mode": "vector"}):
            r = ref.read_side.search("c1", RefParams.from_json(body), READ)
            p = port.read_side.search("c1", PortParams.from_json(body), READ)
            assert [h.id for h in p.hits] == [h.id for h in r.hits], body
            assert p.count == r.count and p.count > 0
            np.testing.assert_allclose([h.score for h in p.hits],
                                       [h.score for h in r.hits], rtol=1e-5)
        # the write side reloads too: new ids continue after the carried ones
        port.write_side.write("c1", [{"id": "new", "title": "fresh cat"}], WRITE)
        port.flush()
        p = port.read_side.search("c1", PortParams.from_json({"term": "fresh"}), READ)
        assert [h.id for h in p.hits] == ["new"]
    finally:
        ref.close()
        port.close()
