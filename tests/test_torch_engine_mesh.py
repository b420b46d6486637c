"""The port's mesh reader end to end against the JAX package's, on the CPU
(mirrors tests/test_engine_mesh.py).

The same writes, deletes and commits go to three engines: a reference
engine with ``mesh_shape=(8, 1)`` on the conftest's 8 virtual devices
(forced onto its kernel branches with ``_test_force_fast_path``, so its
mesh vector fast path runs its Pallas kNN in interpret mode), a port
engine with ``mesh_shape=(8, 1)`` (8 shards on the CPU) and a port engine
on one device. Every query must give the same hits in the same order, the
same match count and the same facets on all three, scores within rtol
1e-5: fulltext, phrase, prefix, filtered, faceted, vector (fast and
dense), filtered + faceted vector, hybrid RRF and min-max, int8, chunked
(multi-vector) docs and IVF-PQ (on the reference's trained arrays carried
into the port readers), with deletes and a live uncommitted window."""

import numpy as np
import pytest

from orama_core_tpu.types import SearchParams as RefParams
from orama_core_tpu_torch.types import SearchParams as PortParams

MASTER, READ, WRITE = "master", "rk", "wk"
MESH = (8, 1)
TOPICS = [
    "solar panels convert sunlight", "wind turbines spin in the breeze",
    "bake a chocolate cake", "quantum computing with qubits",
    "solar and wind renewable energy", "grid batteries store solar power",
    "chocolate dessert recipes with sugar", "superconducting qubits and gates",
]
FACETS = {
    "price": {"ranges": [{"from": 0, "to": 150}, {"from": 150, "to": 500}]},
    "tag": {"limit": 10},
    "active": {"true": True, "false": True},
}


def _docs(n=48, start=0, seed=1):
    rng = np.random.default_rng(seed)
    extra = ["alpha", "beta", "river", "mountain", "city", "solar", "wind"]
    out = []
    for i in range(start, start + n):
        body = TOPICS[i % 8] + " " + " ".join(rng.choice(extra, 2))
        out.append({
            "id": str(i), "body": body, "price": i * 10,
            "tag": "green" if ("solar" in body or "wind" in body) else "other",
            "active": i % 2 == 0,
        })
    return out


class Trio:
    """A reference mesh engine, a port mesh engine and a port engine on one
    device, driven in lockstep."""

    def __init__(self, tmp_path, **knobs):
        from orama_core_tpu import build_orama as ref_build
        from orama_core_tpu.config import OramaxConfig as RefCfg
        from orama_core_tpu_torch import build_orama as port_build
        from orama_core_tpu_torch.config import OramaxConfig as PortCfg

        self.engines = []
        for tag, mesh in (("ref", MESH), ("mesh", MESH), ("single", ())):
            Cfg = RefCfg if tag == "ref" else PortCfg
            cfg = Cfg()
            cfg.writer_side.data_dir = str(tmp_path / f"{tag}-w")
            cfg.reader_side.data_dir = str(tmp_path / f"{tag}-r")
            cfg.writer_side.insert_batch_commit_size = 10_000_000
            cfg.reader_side.insert_batch_commit_size = 10_000_000
            cfg.writer_side.commit_interval_sec = 3600.0
            cfg.reader_side.commit_interval_sec = 3600.0
            dev_cfg = cfg.tpu if tag == "ref" else cfg.gpu
            for k, v in dict(knobs, mesh_shape=mesh).items():
                setattr(dev_cfg, k, v)
            if tag == "ref":
                dev_cfg._test_force_fast_path = True
                self.engines.append(ref_build(cfg, start_background=False))
            else:
                self.engines.append(port_build(cfg, start_background=False,
                                               device="cpu"))
        self.ref, self.mesh, self.single = self.engines
        self.do(lambda e: e.write_side.create_collection(
            MASTER, "c", read_api_key=READ, write_api_key=WRITE))
        self.do(lambda e: e.flush())

    def do(self, fn):
        for e in self.engines:
            fn(e)

    def write(self, docs):
        self.do(lambda e: e.write_side.write("c", docs, WRITE))
        self.do(lambda e: e.flush())

    def delete(self, ids):
        self.do(lambda e: e.write_side.delete_documents("c", ids, WRITE))
        self.do(lambda e: e.flush())

    def compare(self, body):
        r = self.ref.read_side.search("c", RefParams.from_json(dict(body)),
                                      READ)
        for e in (self.mesh, self.single):
            p = e.read_side.search("c", PortParams.from_json(dict(body)), READ)
            _same(p, r, body)
        return r

    def close(self):
        self.do(lambda e: e.close())


def _facets(f):
    return None if f is None else {k: (v.count, v.values) for k, v in f.items()}


def _same(p, r, body):
    assert [h.id for h in p.hits] == [h.id for h in r.hits], body
    assert p.count == r.count, (body, p.count, r.count)
    np.testing.assert_allclose([h.score for h in p.hits],
                               [h.score for h in r.hits], rtol=1e-5,
                               err_msg=str(body))
    assert _facets(p.facets) == _facets(r.facets), body


QUERIES = [
    {"term": "solar"},
    {"term": "solar wind"},                                  # phrase
    {"term": "chocolate cake", "limit": 3},
    {"term": "qubit"},                                       # prefix + stem
    {"term": "solar", "where": {"price": {"gte": 100}}},
    {"term": "wind", "where": {"price": {"eq": 90}}},
    {"term": "solar", "where": {"tag": "green", "active": True}},
    {"term": "", "where": {"price": {"lte": 200}}, "facets": FACETS},
    {"term": "solar", "facets": FACETS},
    {"term": "solar energy", "mode": "hybrid"},
    {"term": "solar wind", "mode": "hybrid", "fusion": "minmax",
     "facets": FACETS},
    {"term": "wind", "mode": "vector"},
    {"term": "energy", "mode": "vector", "limit": 20},
    {"term": "energy", "mode": "vector", "where": {"active": False},
     "facets": FACETS},
]


@pytest.mark.parametrize("index", ["exact", "int8"])
def test_mesh_engine_matches_reference_and_single_device(tmp_path, index):
    """Committed, then with deletes, then with a live uncommitted window
    (filters and facets overlay the window from the sharded masks)."""
    trio = Trio(tmp_path, vector_index=index)
    try:
        trio.write(_docs())
        trio.do(lambda e: e.commit())
        rd = trio.mesh.read_side._reader("c")
        assert rd._device.n_shards == 8 and rd._use_sharded(
            PortParams.from_json({"term": "x", "mode": "vector"}))
        for body in QUERIES:
            trio.compare(body)
        trio.delete(["4", "12", "33"])
        for body in QUERIES[:3] + QUERIES[9:]:
            trio.compare(body)
        trio.write(_docs(6, start=100, seed=2))
        for body in QUERIES:
            trio.compare(body)
        # raw client vectors through the mesh path; a wrong width raises
        model = next(f.model for f in rd.fields.values() if f.model)
        raw = [float(x) for x in
               trio.single.read_side.ai.embed_query(model, ["wind"])[0]]
        trio.compare({"mode": "vector", "vector": raw})
        for e in (trio.mesh, trio.ref):
            Params = PortParams if e is trio.mesh else RefParams
            with pytest.raises(ValueError, match="dimension"):
                e.read_side.search("c", Params.from_json(
                    {"mode": "vector", "vector": [1.0, 2.0]}), READ)
    finally:
        trio.close()


def _readers(tmp_path, n_docs, rows, seed, **knobs):
    """(reference mesh, port mesh, port single) CollectionReaders over the
    same committed vector corpus of 1..``rows`` unit rows a doc."""
    from orama_core_tpu.config import TpuConfig
    from orama_core_tpu.engine.collection_read import CollectionReader as RR
    from orama_core_tpu.oplog import (
        CreateFieldOp as RC, IndexEmbeddingOp as RE, InsertDocumentOp as RI)
    from orama_core_tpu.types import TypedField as RT, ValueType as RV
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import CollectionReader
    from orama_core_tpu_torch.oplog import (
        CreateFieldOp, IndexEmbeddingOp, InsertDocumentOp)
    from orama_core_tpu_torch.types import TypedField, ValueType

    rng = np.random.default_rng(seed)
    D = 128
    vecs = [rng.standard_normal((int(rng.integers(1, rows + 1)), D))
            for _ in range(n_docs)]
    ref_cfg = TpuConfig(mesh_shape=MESH, **knobs)
    ref_cfg._test_force_fast_path = True
    out = []
    for tag, (R, C, E, I, T, V, cfg) in (
        ("ref", (RR, RC, RE, RI, RT, RV, ref_cfg)),
        ("mesh", (CollectionReader, CreateFieldOp, IndexEmbeddingOp,
                  InsertDocumentOp, TypedField, ValueType,
                  GpuConfig(device="cpu", mesh_shape=MESH, **knobs))),
        ("single", (CollectionReader, CreateFieldOp, IndexEmbeddingOp,
                    InsertDocumentOp, TypedField, ValueType,
                    GpuConfig(device="cpu", **knobs))),
    ):
        r = R("c", "rk", None, cfg)
        r.apply(C("c", T(0, "emb", V.EMBEDDING, model="fake-small")))
        for i, vs in enumerate(vecs):
            r.apply(I("c", i, {"id": str(i)}))
            r.apply(E("c", i, 0, tuple(tuple(float(x) for x in v)
                                       for v in vs)))
        r.commit(str(tmp_path / tag), offset=1)
        out.append(r)
    return out, rng, D


def _search3(readers, body, count_slack=0):
    ref, mesh, single = readers
    rr, rc, _ = ref.search(RefParams.from_json(dict(body)), None)
    for r in (mesh, single):
        pr, pc, _ = r.search(PortParams.from_json(dict(body)), None)
        assert [d for d, _ in pr] == [d for d, _ in rr], body.get("limit")
        np.testing.assert_allclose([s for _, s in pr], [s for _, s in rr],
                                   rtol=1e-5)
        assert abs(pc - rc) <= count_slack, (pc, rc)
    return rr


@pytest.mark.parametrize("rows", [1, 3], ids=["single_vec", "multivec"])
def test_mesh_vector_fast_path_matches_reference(tmp_path, rows):
    """Unfiltered vector queries take the per-shard fused kNN on the port's
    mesh (K2 + K3, or K6 for chunked docs) and the reference's
    (``fast_sharded``); then a filter, and the dense sharded pipeline."""
    from orama_core_tpu_torch.server import metrics as m

    readers, rng, D = _readers(tmp_path, 3000, rows, seed=rows)
    before = m.VECTOR_PATH.get(path="fast_sharded")
    for limit in (10, 25):
        q = rng.standard_normal(D)
        q /= np.linalg.norm(q)
        body = {"mode": "vector", "vector": [float(x) for x in q],
                "limit": limit}
        # the fused kNN's count may differ by a doc whose similarity is
        # within rounding of zero (the reference's own mesh test allows 1)
        _search3(readers, body, count_slack=1)
    assert m.VECTOR_PATH.get(path="fast_sharded") == before + 2
    mesh = readers[1]
    assert mesh._sharded_vector_fast(PortParams.from_json(
        {"mode": "vector", "vector": [0.0] * D, "limit": 200}), None,
        mesh._sharded_ctx()) is None
    with pytest.raises(ValueError, match="dimension 64"):
        mesh.search(PortParams.from_json(
            {"mode": "vector", "vector": [0.5] * 64, "limit": 5}), None)


def test_mesh_ivf_pq_matches_reference(tmp_path):
    """IVF-PQ over the mesh: the reference mesh reader trains at commit;
    its committed arrays (trained structures included) are carried into a
    port mesh reader and a port reader on one device. The mesh readers
    agree exactly; the single-device reader, whose candidate set is a
    subset, never scores a rank higher."""
    from orama_core_tpu.config import TpuConfig
    from orama_core_tpu.engine.collection_read import CollectionReader as RR
    from orama_core_tpu.oplog import (
        CreateFieldOp, IndexEmbeddingOp, InsertDocumentOp)
    from orama_core_tpu.types import TypedField, ValueType
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.carry import (
        export_arrays, reader_from_arrays)

    N, D, CENTERS = 4000, 64, 32
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((CENTERS, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    vecs = centers[rng.integers(0, CENTERS, N)] + 0.25 * rng.standard_normal(
        (N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    knobs = dict(vector_index="ivf_pq", ivf_threshold=1_000, ivf_nprobe=8,
                 ivf_autotune=False)
    ref = RR("c", "rk", None, TpuConfig(mesh_shape=MESH, **knobs))
    ref.apply(CreateFieldOp("c", TypedField(0, "emb", ValueType.EMBEDDING,
                                            model="fake-small")))
    for i in range(N):
        ref.apply(InsertDocumentOp("c", i, {"id": str(i)}))
        ref.apply(IndexEmbeddingOp("c", i, 0, (tuple(float(x)
                                                     for x in vecs[i]),)))
    ref.commit(str(tmp_path / "ref"), offset=1)
    arrays = export_arrays(ref)
    mesh = reader_from_arrays(**arrays, gpu_cfg=GpuConfig(
        device="cpu", mesh_shape=MESH, **knobs))
    single = reader_from_arrays(**arrays, gpu_cfg=GpuConfig(
        device="cpu", **knobs))
    assert mesh._vector[0].committed.has_pq and mesh.warmup() >= 1
    for q in range(8):
        qv = centers[q] + 0.25 * rng.standard_normal(D).astype(np.float32)
        qv /= np.linalg.norm(qv)
        body = {"mode": "vector", "vector": [float(x) for x in qv],
                "limit": 10}
        p = PortParams.from_json(dict(body))
        assert mesh._use_sharded(p)
        rr, rc, _ = ref.search(RefParams.from_json(dict(body)), None)
        mr, mc, _ = mesh.search(p, None)
        assert [d for d, _ in mr] == [d for d, _ in rr] and mc == rc
        np.testing.assert_allclose([s for _, s in mr], [s for _, s in rr],
                                   rtol=1e-5)
        sr, _sc, _ = single.search(p, None)
        assert len(sr) == len(mr)
        assert all(a >= b - 1e-6 for (_, a), (_, b) in zip(mr, sr))
    # flat IVF and flat PQ stay on the single-device path under a mesh
    for mode in ("ivf", "pq"):
        from orama_core_tpu_torch.engine.collection_read import (
            CollectionReader)

        rd = CollectionReader("c", "rk", None, GpuConfig(
            device="cpu", mesh_shape=MESH, vector_index=mode))
        assert not rd._use_sharded(PortParams.from_json(
            {"mode": "vector", "term": "x"}))
        assert rd._use_sharded(PortParams.from_json({"term": "x"}))


def test_mesh_search_batch_and_ann_run_whole_on_the_first_device(tmp_path):
    """``search_batch`` and the fused program run outside the mesh
    programs, with whole arrays on the mesh's first device: the same
    results as one by one, and the Zipf-head dense rows stay unused (as
    in the reference's mesh mode)."""
    trio = Trio(tmp_path)
    try:
        trio.write(_docs())
        trio.do(lambda e: e.commit())
        rd = trio.mesh.read_side._reader("c")
        ai = trio.mesh.read_side.ai
        params = [PortParams.from_json({"term": t, "mode": mode})
                  for mode in ("fulltext", "hybrid")
                  for t in ("solar", "wind", "chocolate")]
        for p in params:
            (got, got_n), = rd.search_batch([p], ai)
            want, want_n, _ = rd.search(p, ai)
            assert [d for d, _ in got] == [d for d, _ in want]
            assert got_n == want_n
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], rtol=1e-5)
        assert all(k[1][0] != "dense_rows" for k in rd._device._store
                   if isinstance(k[1], tuple))
    finally:
        trio.close()


@pytest.mark.parametrize("stage", ["uncommitted", "committed", "mixed"])
def test_engine_queries_match_on_mesh(tmp_path, stage):
    """tests/test_torch_engine.py's queries (limits, offsets, boosts,
    properties, filters, facets, every mode) on a reference mesh engine
    and a port mesh engine, with nothing committed yet (empty per-shard
    layouts under a live window), committed, and mixed."""
    from test_torch_engine import DOCS, ENGINE_QUERIES, Pair

    pair = Pair(tmp_path, mesh_shape=MESH)
    try:
        pair.create()
        pair.write(DOCS)
        if stage != "uncommitted":
            pair.commit()
        if stage == "mixed":
            pair.write([{"id": "5", "title": "another cat appears",
                         "price": 7}])
        rd = pair.port.read_side._reader("c1")
        assert rd._device.n_shards == 8
        for body in ENGINE_QUERIES:
            assert rd._use_sharded(PortParams.from_json(dict(body)))
            pair.compare(body)
    finally:
        pair.close()


def test_odd_shard_count_matches_single_device(tmp_path):
    """Three shards (local capacity 2,731 for 8,192 slots, so the sharded
    space overhangs the capacity) serve the single-device reader's hits
    through every mode, before and after a commit and a delete."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig

    engines = []
    for tag, mesh in (("mesh", (3, 1)), ("single", ())):
        cfg = OramaxConfig()
        cfg.writer_side.data_dir = str(tmp_path / f"{tag}-w")
        cfg.reader_side.data_dir = str(tmp_path / f"{tag}-r")
        cfg.gpu.mesh_shape = mesh
        e = build_orama(cfg, start_background=False, device="cpu")
        e.write_side.create_collection(MASTER, "c", read_api_key=READ,
                                       write_api_key=WRITE)
        e.flush()
        e.write_side.write("c", _docs(40), WRITE)
        e.flush()
        engines.append(e)
    mesh, single = engines
    try:
        rd = mesh.read_side._reader("c")
        for step in ("window", "commit", "delete"):
            if step == "commit":
                for e in engines:
                    e.commit()
            if step == "delete":
                for e in engines:
                    e.write_side.delete_documents("c", ["3", "17"], WRITE)
                    e.flush()
            assert rd._sharded_ctx()[2:] == (2731, 8193)
            for body in QUERIES:
                want = single.read_side.search(
                    "c", PortParams.from_json(dict(body)), READ)
                got = mesh.read_side.search(
                    "c", PortParams.from_json(dict(body)), READ)
                _same(got, want, (step, body))
    finally:
        for e in engines:
            e.close()


def test_concurrent_mesh_searches_while_capacity_grows(tmp_path):
    """Searches from 8 threads (a short switch interval) against a mesh
    reader whose capacity grows under them (documents past the first
    8,192 slots move every doc's shard, so the per-shard layouts of the
    old size are evicted and rebuilt) and that commits meanwhile: no
    search fails, and afterwards the hits equal a single-device reader's."""
    import sys
    import threading

    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import CollectionReader
    from orama_core_tpu_torch.oplog import (
        CreateFieldOp, IndexEmbeddingOp, IndexStringOp, InsertDocumentOp)
    from orama_core_tpu_torch.types import TypedField, ValueType

    rng = np.random.default_rng(9)
    readers = [CollectionReader("c", "rk", None, GpuConfig(
        device="cpu", mesh_shape=m)) for m in ((4, 1), ())]

    def apply_docs(ids):
        for i in ids:
            words = rng.choice(["solar", "wind", "cake", "qubit", "grid"], 3)
            v = rng.standard_normal(16)
            for r in readers:
                r.apply(InsertDocumentOp("c", i, {"id": str(i)}))
                r.apply(IndexStringOp("c", i, 0, 3, {
                    w: (p,) for p, w in enumerate(words)}))
                r.apply(IndexEmbeddingOp("c", i, 1, (tuple(map(float, v)),)))

    for r in readers:
        r.apply(CreateFieldOp("c", TypedField(0, "body", ValueType.STRING)))
        r.apply(CreateFieldOp("c", TypedField(1, "emb", ValueType.EMBEDDING,
                                              model="fake-small")))
    apply_docs(range(200))
    for i, r in enumerate(readers):
        r.commit(str(tmp_path / str(i)), offset=1)
    mesh, single = readers
    class _AI:  # a fixed 16-d query embedding
        q = rng.standard_normal((1, 16)).astype(np.float32)

        def embed_query(self, model, texts):
            return np.repeat(self.q, len(texts), axis=0)

    ai = _AI()
    bodies = [{"term": "solar"}, {"term": "wind grid"},
              {"term": "x", "mode": "vector"},
              {"term": "qubit", "mode": "hybrid"}]
    errors = []

    def worker():
        try:
            for j in range(12):
                mesh.search(PortParams.from_json(dict(bodies[j % 4])), ai)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        apply_docs(range(8190, 8230))  # past the first 8,192 slots
        mesh.commit(str(tmp_path / "0"), offset=2)
        single.commit(str(tmp_path / "1"), offset=2)
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert mesh.capacity == 16384 and mesh._sharded_ctx()[2] == 4096
    for body in bodies:
        want = single.search(PortParams.from_json(dict(body)), ai)
        got = mesh.search(PortParams.from_json(dict(body)), ai)
        assert [d for d, _ in got[0]] == [d for d, _ in want[0]], body
        assert got[1] == want[1], body
        np.testing.assert_allclose([s for _, s in got[0]],
                                   [s for _, s in want[0]], rtol=1e-5)
