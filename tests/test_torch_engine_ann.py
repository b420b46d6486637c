"""The port's ANN vector indexes (``vector_index`` "ivf", "pq", "ivf_pq")
end to end against the JAX package, on the CPU.

A reference engine and a port engine (``device="cpu"``, fake AI backend)
receive the same writes and commits with ``ivf_threshold=1``, so both
train at commit. Initial centroids cannot match across the packages, so
after each commit the reference's trained vector arrays are carried into
the port reader (``from_arrays``, as a data directory committed by the
reference would load): from there every query must give the same hit ids
in the same order, the same match count and facets, scores within rtol
1e-3. Vector, hybrid RRF and min-max, filtered and faceted queries are
held on the fused one-call program and on the multi-call path
(``_committed_vector_scores``), as tests/test_fused_ann.py holds them, and
next to a live freshness window. The port's own commit-time training is
held by persistence (commit, reload, same hits) and routing
(``search_batch`` equals per-row ``search``)."""

import numpy as np
import pytest

from orama_core_tpu.types import SearchParams as RefParams
from orama_core_tpu_torch.index.vector_index import (
    CommittedVectorIndex as PortIndex,
)
from orama_core_tpu_torch.types import SearchParams as PortParams

from test_torch_engine import READ, WRITE, Pair

ANN_MODES = ["pq", "ivf", "ivf_pq"]
TOPICS = [
    "solar panels convert sunlight into electricity",
    "wind turbines generate power from moving air",
    "the recipe needs flour sugar and eggs",
    "bake the cake at 180 degrees",
    "photovoltaic cells and renewable energy",
    "grid scale batteries store solar power",
    "dessert recipes with chocolate and sugar",
    "quantum computing with superconducting qubits",
]


def _docs(n=240, seed=3, start=0):
    """tests/test_fused_ann.py's eight texts as the seeds of ``n`` docs,
    each with a few extra words and a price."""
    rng = np.random.default_rng(seed)
    extra = ["alpha", "beta", "gamma", "delta", "river", "mountain", "city"]
    return [{
        "id": str(start + i),
        "body": TOPICS[i % 8] + " " + " ".join(rng.choice(extra, 3)),
        "price": int(rng.integers(0, 100)),
        "in_stock": bool(i % 3),
    } for i in range(n)]


# limits stay at most 12: the reference's IVF top-k raises when the
# candidate count, max(limit, 10) * expand (8, or IVF-PQ's tuned 10),
# exceeds nprobe * cap (here 1 * 128); the port's top-k takes what is there
BODIES = [
    {"term": "solar sunlight electricity", "mode": "vector"},
    {"term": "solar sunlight electricity", "mode": "vector",
     "where": {"price": {"lte": 50}}},
    {"term": "solar power", "mode": "hybrid"},
    {"term": "wind power", "mode": "hybrid", "where": {"price": {"gte": 10}}},
    {"term": "sugar", "mode": "hybrid", "fusion": "minmax"},
    {"term": "quantum qubits", "mode": "vector", "limit": 12,
     "where": {"in_stock": True},
     "facets": {"price": {"ranges": [{"from": 0, "to": 50},
                                     {"from": 50, "to": 100}]},
                "in_stock": {"true": True, "false": True}}},
    {"term": "cake recipe", "mode": "hybrid", "limit": 5,
     "facets": {"in_stock": {"true": True, "false": True}}},
    {"term": "bake"},
]


def _pair(tmp_path, mode, **knobs):
    knobs = dict(vector_index=mode, ivf_threshold=1, ivf_nprobe=4, **knobs)
    pair = Pair(tmp_path, **knobs)
    pair.create()
    return pair


def _carry(pair, cid="c1"):
    """Serve the reference's trained vector arrays in the port reader."""
    ref_rd = pair.ref.read_side._reader(cid)
    port_rd = pair.port.read_side._reader(cid)
    for fid, vf in ref_rd._vector.items():
        pvf = port_rd._vector[fid]
        port_rd._device.drop(pvf.committed)
        pvf.committed = PortIndex.from_arrays(vf.committed.to_arrays())
    return ref_rd, port_rd


def _compare(pair, body):
    r = pair.ref.read_side.search("c1", RefParams.from_json(dict(body)), READ)
    p = pair.port.read_side.search("c1", PortParams.from_json(dict(body)),
                                   READ)
    assert [h.id for h in p.hits] == [h.id for h in r.hits], body
    assert p.count == r.count, body
    np.testing.assert_allclose([h.score for h in p.hits],
                               [h.score for h in r.hits], rtol=1e-3,
                               err_msg=str(body))
    facets = (lambda f: None if f is None else
              {k: (v.count, v.values) for k, v in f.items()})
    assert facets(p.facets) == facets(r.facets), body
    return p


@pytest.mark.parametrize("path", ["fused", "dense"])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_ann_queries_match_reference(tmp_path, mode, path, monkeypatch):
    pair = _pair(tmp_path, mode)
    try:
        pair.write(_docs())
        pair.commit()
        ref_rd, port_rd = _carry(pair)
        pc = next(iter(port_rd._vector.values())).committed
        assert pc.has_ivf == (mode != "pq") and pc.has_pq == (mode != "ivf")
        calls = []
        orig = port_rd._search_hybrid_fused

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(port_rd, "_search_hybrid_fused", spy)
        if path == "dense":
            for rd in (ref_rd, port_rd):
                monkeypatch.setattr(rd, "_hybrid_fused_eligible",
                                    lambda _p: None)
        for body in BODIES:
            p = _compare(pair, body)
            if body.get("mode") in ("vector", "hybrid"):
                assert p.count > 0, body
        assert bool(calls) == (path == "fused")
        # the ANN structures served, not the exact rows
        tags = {k[1] for k in port_rd._device._store}
        assert {"pq": "vec_pq", "ivf": "vec_ivf",
                "ivf_pq": "vec_ivfpq"}[mode] in tags
        assert "vec" not in tags
    finally:
        pair.close()


@pytest.mark.parametrize("mode", ANN_MODES)
def test_ann_live_window_matches_reference(tmp_path, mode):
    """tests/test_fused_ann.py's freshness window: uncommitted docs are
    scored host-side on top of the committed ANN candidates."""
    pair = _pair(tmp_path, mode)
    try:
        pair.write(_docs(120))
        pair.commit()
        port_rd = _carry(pair)[1]
        fresh = _docs(6, seed=9, start=500)
        for d in fresh:
            d["body"] = "zebra xylophone " + d["body"]
        pair.write(fresh)
        assert not next(iter(port_rd._vector.values())).uncommitted.is_empty
        for body in BODIES[:6]:
            _compare(pair, body)
        p = _compare(pair, {"term": "zebra xylophone", "mode": "hybrid"})
        assert {h.id for h in p.hits} & {d["id"] for d in fresh}
    finally:
        pair.close()


def test_ann_reload_and_tuned_values_match_reference(tmp_path):
    """The reference's committed data directory (trained IVF-PQ arrays)
    loads in the port with every ANN array, and serves the same hits."""
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import CollectionReader

    pair = _pair(tmp_path, "ivf_pq")
    try:
        pair.write(_docs())
        pair.commit()
        ref_rd = pair.ref.read_side._reader("c1")
        rc = next(iter(ref_rd._vector.values())).committed
        assert rc.tuned_nprobe is not None and rc.pq_residual
        port_rd = CollectionReader.load(
            str(tmp_path / "e-ref-r" / "collections" / "c1"),
            GpuConfig(device="cpu", vector_index="ivf_pq"))
        pc = next(iter(port_rd._vector.values())).committed
        for name, val in rc.to_arrays().items():
            np.testing.assert_array_equal(pc.to_arrays()[name], val)
        from orama_core_tpu.models.ai_service import AIService as RefAI
        from orama_core_tpu_torch.models.ai_service import AIService as PortAI

        for body in BODIES[:5]:
            rr, rn, _ = ref_rd.search(RefParams.from_json(dict(body)), RefAI())
            pr, pn, _ = port_rd.search(PortParams.from_json(dict(body)),
                                       PortAI())
            assert [d for d, _ in pr] == [d for d, _ in rr] and pn == rn
    finally:
        pair.close()


@pytest.mark.parametrize("mode", ANN_MODES)
def test_port_build_orama_persists_ann(tmp_path, mode):
    """The port's own commit trains on its device; a commit and reload
    keeps every ANN array and serves the same hits."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig

    def cfg():
        c = OramaxConfig()
        c.writer_side.data_dir = str(tmp_path / "w")
        c.reader_side.data_dir = str(tmp_path / "r")
        c.ai.backend = "fake"
        c.gpu.vector_index = mode
        c.gpu.ivf_threshold = 1
        return c

    e = build_orama(cfg(), start_background=False, device="cpu")
    e.write_side.create_collection("master", "c1", READ, WRITE)
    e.flush()
    e.write_side.write("c1", _docs(), WRITE)
    e.flush()
    e.commit()
    c = next(iter(e.read_side._reader("c1")._vector.values())).committed
    assert c.has_ivf == (mode != "pq") and c.has_pq == (mode != "ivf")
    if mode != "pq":
        assert c.tuned_nprobe is not None
    before = {}
    for body in BODIES:
        r = e.read_side.search("c1", PortParams.from_json(dict(body)), READ)
        before[str(body)] = ([h.id for h in r.hits], r.count)
    arrays = c.to_arrays()
    e.close()
    e2 = build_orama(cfg(), start_background=False, device="cpu")
    try:
        c2 = next(iter(e2.read_side._reader("c1")._vector.values())).committed
        got = c2.to_arrays()
        assert sorted(got) == sorted(arrays)
        for name in arrays:
            np.testing.assert_array_equal(got[name], arrays[name])
        for body in BODIES:
            r = e2.read_side.search("c1", PortParams.from_json(dict(body)),
                                    READ)
            assert ([h.id for h in r.hits], r.count) == before[str(body)]
    finally:
        e2.close()


@pytest.mark.parametrize("mode", ANN_MODES)
def test_search_batch_on_ann_equals_per_row(tmp_path, mode):
    """``search_batch`` serves ANN vector and hybrid rows one by one (the
    batch's exact corpus product would change the hits); the fused kNN
    and the micro-batcher leave ANN vector modes alone."""
    from orama_core_tpu_torch.models.ai_service import AIService

    pair = _pair(tmp_path, mode)
    try:
        pair.write(_docs())
        pair.commit()
        rd = _carry(pair)[1]
        ai = AIService(pair.port.cfg.ai)
        for kind in ("vector", "hybrid", "fulltext"):
            params = [PortParams.from_json({"term": t, "mode": kind})
                      for t in ("solar", "sugar", "power", "qubits")]
            batch = rd.search_batch(params, ai)
            for p, (ranked, count) in zip(params, batch):
                want, want_n, _ = rd.search(p, ai)
                assert ranked == want and count == want_n, (kind, p.term)
            if kind != "fulltext":
                assert rd._vector_fast_field(params[0]) is None
                assert not pair.port.read_side._batchable(params[0])
    finally:
        pair.close()


def test_mesh_shape_still_raises():
    """Sharded serving is ported (tests/test_torch_engine_mesh.py): under
    every ANN index a ``mesh_shape`` reader constructs, with the
    reference's routing: IVF-PQ vector queries ride the mesh, flat IVF and
    flat PQ ones stay on the single-device path, fulltext always shards."""
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import CollectionReader

    vec = PortParams.from_json({"term": "x", "mode": "vector"})
    for mode in ANN_MODES:
        CollectionReader("c", "r", None, GpuConfig(device="cpu",
                                                   vector_index=mode))
        rd = CollectionReader("c", "r", None, GpuConfig(
            device="cpu", vector_index=mode, mesh_shape=(2, 1)))
        assert rd._device.n_shards == 2
        assert rd._use_sharded(vec) == (mode == "ivf_pq")
        assert rd._use_sharded(PortParams.from_json({"term": "x"}))


def test_cuda_build_never_falls_back_to_cpu():
    """Asked for the card on a machine without one, the index builds raise:
    nothing trains on the CPU in its place."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the index builds run on it")
    rng = np.random.default_rng(0)
    v = rng.standard_normal((300, 32)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for build in ("build_ivf", "build_pq"):
        idx = PortIndex(dimension=32, vecs=v,
                        vec_docs=np.arange(300, dtype=np.int32))
        with pytest.raises((RuntimeError, AssertionError)):
            getattr(idx, build)(device="cuda")
        assert not idx.has_ivf and not idx.has_pq
