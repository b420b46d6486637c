"""The port's int8 capacity mode (``vector_index="int8"``) end to end
against the JAX package: readers carried from the same committed arrays
and engines driven in lockstep give the same hits in the same order, the
same match counts and facets, scores within rtol 1e-5. The reference
reader is forced onto its kernel branches (``_test_force_fast_path``)."""

import numpy as np
import pytest

from orama_core_tpu.types import SearchParams as RefParams
from orama_core_tpu_torch.types import SearchParams as PortParams

from test_torch_engine import DOCS, ENGINE_QUERIES, WRITE, Pair

INT8_QUERIES = ENGINE_QUERIES + [
    {"term": "computing", "mode": "vector", "where": {"price": {"gte": 10}},
     "facets": {"price": {"ranges": [{"from": 0, "to": 30}]},
                "in_stock": {"true": True, "false": True}}},
    {"term": "loyal dogs", "mode": "hybrid", "where": {"in_stock": True}},
    {"term": "cat", "mode": "vector", "where": {"price": {"lt": 30}}},
]


def _int8_fast_readers(tombstones=False, window=False, phase1="xla"):
    """tests/test_vector_fast.py's 8192 x 128 reader in int8 mode, and
    its port carried over from the reference's committed arrays."""
    from orama_core_tpu.config import TpuConfig
    from orama_core_tpu.engine.collection_read import CollectionReader
    from orama_core_tpu.index import CommittedVectorIndex
    from orama_core_tpu.oplog import CreateFieldOp, DeleteDocumentsOp
    from orama_core_tpu.types import TypedField, ValueType
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.carry import export_arrays, reader_from_arrays
    from orama_core_tpu_torch.oplog import DeleteDocumentsOp as PortDelete

    n, d = 8192, 128
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ref = CollectionReader("vfast", "rk", None,
                           TpuConfig(vector_index="int8", int8_phase1=phase1))
    ref._apply_locked(CreateFieldOp("vfast", TypedField(
        0, "embedding", ValueType.EMBEDDING, model="fake-small")))
    ref.max_doc_id = n - 1
    ref._alive = np.ones(ref.capacity, dtype=np.float32)
    ref.doc_count = n
    ref._vector[0].committed = CommittedVectorIndex(
        dimension=d, vecs=vecs, vec_docs=np.arange(n, dtype=np.int32))
    ref.cfg._test_force_fast_path = True
    port = reader_from_arrays(**export_arrays(ref), gpu_cfg=GpuConfig(
        device="cpu", vector_index="int8", int8_phase1=phase1))
    if tombstones:
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


FAST_BODIES = (
    {"term": "solar energy", "mode": "vector", "limit": 7},
    {"term": "quantum", "mode": "vector"},
    {"term": "fresh stuff", "mode": "vector", "limit": 20},
)


def _search_pair(ref, port, body):
    from orama_core_tpu.models.ai_service import AIService as RefAI
    from orama_core_tpu_torch.models.ai_service import AIService as PortAI

    rr, rc, _ = ref.search(RefParams.from_json(dict(body)), RefAI())
    pr, pc, _ = port.search(PortParams.from_json(dict(body)), PortAI())
    assert [d for d, _ in pr] == [d for d, _ in rr], body
    assert pc == rc, body
    np.testing.assert_allclose([s for _, s in pr], [s for _, s in rr],
                               rtol=1e-5)
    return pr, pc


@pytest.mark.parametrize("variant", ["plain", "tombstones", "window"])
def test_int8_fast_knn_reader_matches(variant, monkeypatch):
    """The fused int8 kNN (K5's wrapper) serves unfiltered vector queries
    with the reference's hits and counts, including the tombstone count
    correction that replays the quantized arithmetic."""
    from orama_core_tpu_torch.ops import knn as port_knn

    ref, port = _int8_fast_readers(tombstones=variant == "tombstones",
                                   window=variant == "window")
    calls = {"knn_topk_int8_with_count": 0, "subblock_max_int8": 0}
    for name in calls:
        orig = getattr(port_knn, name)

        def spy(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(port_knn, name, spy)
    for body in FAST_BODIES:
        assert port._vector_fast_field(PortParams.from_json(dict(body))) == 0
        assert ref._vector_fast_field(RefParams.from_json(dict(body))) == 0
        _search_pair(ref, port, body)
    assert calls["knn_topk_int8_with_count"] == 3, "no int8 fused kNN"
    # limit 20 fetches k = 128, whose 128 * 32 * 4 candidate rows cover
    # the 8192-row corpus: that query takes the small-corpus branch
    assert calls["subblock_max_int8"] == 2, calls
    # the int8 mode keeps only codes on the card: no bf16 rows were built
    assert not [k for k in port._device._store if k[1] == "vec"]


@pytest.mark.parametrize("stage", ["committed", "mixed"])
def test_int8_engine_queries_match(tmp_path, stage):
    """Hybrid, fulltext, filtered and faceted vector (the fused program's
    int8 vmode, and the dense int8 scorer next to a live window)."""
    pair = Pair(tmp_path, vector_index="int8")
    try:
        pair.create()
        pair.write(DOCS)
        pair.commit()
        if stage == "mixed":
            pair.write([{"id": "5", "title": "another cat appears",
                         "price": 7}])
        for body in INT8_QUERIES:
            pair.compare(body)
        rd = pair.port.read_side._reader("c1")
        assert rd.cfg.vector_index == "int8"
        assert not [k for k in rd._device._store if k[1] == "vec"]
    finally:
        pair.close()


def test_int8_filtered_vector_stays_off_bf16_rows(tmp_path):
    """A selective filter next to a live number window takes the dense
    path. In int8 mode that path must score the int8 codes, as the
    reference does, never the bf16 rows by a selective gather."""
    pair = Pair(tmp_path, vector_index="int8")
    try:
        pair.create()
        pair.write(DOCS)
        pair.commit()
        pair.write([{"id": "5", "title": "a cat on a quantum mat",
                     "price": 12}])
        rd = pair.port.read_side._reader("c1")
        body = {"term": "quantum cat", "mode": "vector",
                "where": {"price": {"gte": 8}}}
        assert rd._hybrid_fused_eligible(PortParams.from_json(body)) is None
        assert rd._filter_candidates(PortParams.from_json(body).where) is not None
        p = pair.compare(body)
        assert len(p.hits) >= 2
        assert not [k for k in rd._device._store if k[1] == "vec"]
    finally:
        pair.close()


def test_int8_and_ann_modes_at_construction():
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import CollectionReader

    CollectionReader("c", "rk", None, GpuConfig(device="cpu",
                                                vector_index="int8"))
    # the ANN modes construct (tests/test_torch_engine_ann.py serves
    # them), and so does a mesh reader under every index
    # (tests/test_torch_engine_mesh.py serves it)
    for mode in ("int8", "ivf", "pq", "ivf_pq"):
        rd = CollectionReader("c", "rk", None,
                              GpuConfig(device="cpu", vector_index=mode))
        assert rd.cfg.vector_index == mode
        rd = CollectionReader("c", "rk", None, GpuConfig(
            device="cpu", vector_index=mode, mesh_shape=(2, 1)))
        assert rd._device.n_shards == 2 and rd.cfg.vector_index == mode


def test_int8_reference_data_dir_loads_into_port(tmp_path):
    """An int8-mode reference engine's data directory serves the same
    fast-path hits from the port (the write side commits the same files
    in either mode)."""
    pair = Pair(tmp_path, vector_index="int8")
    try:
        pair.create()
        pair.write([{"id": str(i), "title": f"doc {i} about cats and dogs",
                     "price": i} for i in range(60)])
        pair.commit()
        pair.do(lambda e: e.write_side.delete_documents("c1", ["3"], WRITE))
        pair.do(lambda e: e.flush())
        for body in ({"term": "cats", "mode": "vector", "limit": 20},
                     {"term": "dogs", "mode": "hybrid"}):
            pair.compare(body)
    finally:
        pair.close()
