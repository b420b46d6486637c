"""Chunked (multi-vector) documents through the port's fused kNN (K6)
against the JAX package: tests/test_vector_fast.py's planted-relevance
corpus (1-3 chunk rows per doc) is built through the same ops in both
packages and committed. The port gives the reference fused path's doc
ids and scores (rtol 1e-5), and the exact match count of the dense path:
the reference's fused count can exceed it by the docs whose positive
rows straddle one of its 2048-row grid blocks (see
tests/test_torch_knn_mv.py)."""

import numpy as np
import pytest

from orama_core_tpu.types import SearchParams as RefParams
from orama_core_tpu_torch.types import SearchParams as PortParams

D = 128  # fake-small


def _build(pkg, cfg, data_dir, n_docs=6000, seed=0, deletes=()):
    """A committed chunked collection of ``pkg`` ("ref" or "port")."""
    if pkg == "ref":
        from orama_core_tpu.engine.collection_read import CollectionReader
        from orama_core_tpu.oplog import (
            CreateFieldOp, DeleteDocumentsOp, IndexEmbeddingOp,
            InsertDocumentOp,
        )
        from orama_core_tpu.types import TypedField, ValueType
    else:
        from orama_core_tpu_torch.engine.collection_read import CollectionReader
        from orama_core_tpu_torch.oplog import (
            CreateFieldOp, DeleteDocumentsOp, IndexEmbeddingOp,
            InsertDocumentOp,
        )
        from orama_core_tpu_torch.types import TypedField, ValueType

    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((256, D)).astype(np.float32)
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    centers = modes[rng.integers(0, 256, n_docs)] + (
        0.25 / np.sqrt(D)) * rng.standard_normal((n_docs, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    r = CollectionReader("mv", "rk", None, cfg)
    r.apply(CreateFieldOp("mv", TypedField(0, "emb", ValueType.EMBEDDING,
                                           model="fake-small")))
    for i in range(n_docs):
        r.apply(InsertDocumentOp("mv", i, {"id": str(i)}))
        chunks = centers[i] + (0.12 / np.sqrt(D)) * rng.standard_normal(
            (1 + i % 3, D)).astype(np.float32)
        chunks /= np.linalg.norm(chunks, axis=1, keepdims=True)
        r.apply(IndexEmbeddingOp(
            "mv", i, 0, tuple(tuple(float(x) for x in c) for c in chunks)))
    r.commit(str(data_dir), 1)
    if deletes:
        r.apply(DeleteDocumentsOp("mv", tuple(deletes)))
    return r, centers, rng


def _readers(tmp_path, index="exact", seed=0, deletes=()):
    from orama_core_tpu.config import TpuConfig
    from orama_core_tpu_torch.config import GpuConfig

    ref_fast = TpuConfig(vector_index=index)
    ref_fast._test_force_fast_path = True
    ref, centers, rng = _build("ref", ref_fast, tmp_path / "ref", seed=seed,
                               deletes=deletes)
    dense, _, _ = _build("ref", TpuConfig(vector_index=index),
                         tmp_path / "dense", seed=seed, deletes=deletes)
    port, _, _ = _build("port", GpuConfig(device="cpu", vector_index=index),
                        tmp_path / "port", seed=seed, deletes=deletes)
    return ref, dense, port, centers, rng


def _queries(centers, rng, n=6):
    qs = centers[rng.integers(0, len(centers), n)] + (
        0.05 / np.sqrt(D)) * rng.standard_normal((n, D)).astype(np.float32)
    return qs / np.linalg.norm(qs, axis=1, keepdims=True)


def _body(q, limit=10):
    return {"mode": "vector", "vector": [float(x) for x in q], "limit": limit}


@pytest.mark.parametrize("deletes", [(), (7, 8, 9)], ids=["plain", "tombstones"])
def test_multivec_fast_path_matches_reference(tmp_path, monkeypatch, deletes):
    from orama_core_tpu_torch.ops import knn as port_knn

    ref, dense, port, centers, rng = _readers(tmp_path, seed=len(deletes),
                                              deletes=deletes)
    calls = []
    orig = port_knn.knn_topk_multivec_with_count
    monkeypatch.setattr(port_knn, "knn_topk_multivec_with_count",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    qs = _queries(centers, rng)
    if deletes:
        qs[0] = centers[7] / np.linalg.norm(centers[7])
    for i, q in enumerate(qs):
        body = _body(q, limit=10 if i % 2 else 25)
        assert port._vector_fast_field(PortParams.from_json(body)) == 0
        assert ref._vector_fast_field(RefParams.from_json(body)) == 0
        rr, rc, _ = ref.search(RefParams.from_json(body), None)
        dr, dc, _ = dense.search(RefParams.from_json(body), None)
        pr, pc, _ = port.search(PortParams.from_json(body), None)
        assert [d for d, _ in pr] == [d for d, _ in rr], i
        np.testing.assert_allclose([s for _, s in pr], [s for _, s in rr],
                                   rtol=1e-5)
        assert pc == dc, (pc, dc)
        assert 0 <= rc - pc <= 6, (rc, pc)
        assert not set(deletes) & {d for d, _ in pr}
    assert len(calls) == len(qs), "the port did not take the K6 fused kNN"
    c = port._vector[0].committed
    assert c._max_chunks == 3 and not c._single_vec_per_doc


def test_multivec_int8_stays_dense(tmp_path):
    """No int8 variant of K6 exists (as in the reference): an int8 index of
    chunked docs serves from the dense int8 scorer, with the reference's
    hits and counts."""
    ref, _dense, port, centers, rng = _readers(tmp_path, index="int8")
    for q in _queries(centers, rng, 3):
        body = _body(q)
        assert port._vector_fast_field(PortParams.from_json(body)) is None
        assert ref._vector_fast_field(RefParams.from_json(body)) is None
        rr, rc, _ = ref.search(RefParams.from_json(body), None)
        pr, pc, _ = port.search(PortParams.from_json(body), None)
        assert [d for d, _ in pr] == [d for d, _ in rr]
        assert pc == rc
        np.testing.assert_allclose([s for _, s in pr], [s for _, s in rr],
                                   rtol=1e-5)


def test_multivec_eligibility_matches_reference(tmp_path):
    from orama_core_tpu.engine import collection_read as ref_cr
    from orama_core_tpu_torch.engine import collection_read as port_cr

    from orama_core_tpu_torch.config import GpuConfig

    assert port_cr._MULTIVEC_FAST_MAX_CHUNKS == ref_cr._MULTIVEC_FAST_MAX_CHUNKS
    port, _c, _rng = _build("port", GpuConfig(device="cpu"), tmp_path,
                            n_docs=300)
    c = port._vector[0].committed
    assert port_cr._multivec_fast_eligible(c)
    c2 = type(c)(dimension=c.dimension, vecs=c.vecs,
                 vec_docs=c.vec_docs[::-1].copy())
    assert not port_cr._multivec_fast_eligible(c2)   # not doc-ascending
    docs = np.repeat(np.arange(100, dtype=np.int32), 65)
    c3 = type(c)(dimension=c.dimension, vecs=np.zeros((6500, c.dimension),
                                                      np.float32),
                 vec_docs=docs)
    assert not port_cr._multivec_fast_eligible(c3)   # 65 rows per doc
