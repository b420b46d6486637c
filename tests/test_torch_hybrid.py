"""ops/hybrid.py of the PyTorch port against the JAX package on the SAME
staging buffers: the reference engine builds and runs its one-dispatch
program ``hybrid_fused_topk_mf``; every argument it received (the packed
int32/float32 staging, the device-cached field, vector, filter and facet
columns, the statics) is converted to torch and handed to the port's
function. The reference reader is forced onto its kernel branches
(aligned BM25 plan, windowed phrase stream) so both sides run K1/K4
paths; a second pass keeps the reference on its XLA branches. Ids and
facet counts must be equal, scores within rtol 1e-5."""

import numpy as np
import pytest
import jax
import torch

import orama_core_tpu.ops.hybrid as ref_hybrid
from orama_core_tpu.types import SearchParams
from orama_core_tpu_torch.ops import hybrid as port_hybrid

READ, WRITE = "read-key", "write-key"


def to_torch(x):
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (tuple, list)):
        return type(x)(to_torch(v) for v in x)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref_engine(tmp_path_factory):
    from orama_core_tpu import build_orama
    from orama_core_tpu.config import OramaxConfig

    tmp = tmp_path_factory.mktemp("hyb")
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp / "w")
    cfg.reader_side.data_dir = str(tmp / "r")
    cfg.ai.backend = "fake"
    e = build_orama(cfg, start_background=False)
    e.write_side.create_collection("master", "c", read_api_key=READ,
                                   write_api_key=WRITE)
    e.flush()
    rng = np.random.default_rng(3)
    vocab = ["solar", "wind", "panel", "turbine", "cake", "flour", "quantum",
             "laser"]
    docs = []
    for i in range(120):
        docs.append({
            "id": str(i),
            "title": " ".join(rng.choice(vocab, size=3)),
            "body": " ".join(rng.choice(vocab, size=int(rng.integers(6, 14)))),
            "price": float(rng.uniform(0, 100)),
            "in_stock": bool(i % 3),
            "color": ["red", "green", "blue"][i % 3],
        })
    e.write_side.write("c", docs, WRITE)
    e.flush()
    e.commit()
    yield e
    e.close()


FACETS = {
    "price": {"ranges": [{"from": 0, "to": 30}, {"from": 30, "to": 70}]},
    "color": {"limit": 5},
    "in_stock": {"true": True, "false": True},
}

BODIES = [
    {"term": "solar", "mode": "fulltext"},
    {"term": "solar wind", "mode": "fulltext"},                 # phrase
    {"term": "cake flour laser", "mode": "fulltext", "boost": {"title": 2.5}},
    {"term": "solar panel", "mode": "hybrid"},                  # RRF
    {"term": "quantum laser", "mode": "hybrid", "fusion": "minmax"},
    {"term": "turbine", "mode": "vector", "where": {"price": {"lt": 60}},
     "facets": FACETS},
    {"term": "wind", "mode": "hybrid",
     "where": {"in_stock": True, "color": {"in": ["red", "blue"]}},
     "facets": FACETS},
    {"term": "flour", "mode": "fulltext",
     "where": {"price": {"between": [10, 80]}, "color": "green"}},
]


def _capture_ref(monkeypatch, reader, ai, body):
    calls = []
    orig = ref_hybrid.hybrid_fused_topk_mf

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, kwargs, jax.device_get(out)))
        return out

    monkeypatch.setattr(ref_hybrid, "hybrid_fused_topk_mf", spy)
    p = SearchParams.from_json(dict(body, limit=32))
    helig = reader._hybrid_fused_eligible(p)
    assert helig is not None, body
    reader._search_hybrid_fused(p, ai, *helig)
    monkeypatch.setattr(ref_hybrid, "hybrid_fused_topk_mf", orig)
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("kernel_branches", [True, False])
@pytest.mark.parametrize("body", BODIES, ids=[str(i) for i in range(len(BODIES))])
def test_fused_program_matches_reference(ref_engine, monkeypatch, body,
                                         kernel_branches):
    reader = ref_engine.read_side._reader("c")
    monkeypatch.setattr(reader.cfg, "_test_force_fast_path", kernel_branches,
                        raising=False)
    args, kwargs, (rv, ri, rc, rf) = _capture_ref(
        monkeypatch, reader, ref_engine.read_side.ai, body)
    kw = {k: v for k, v in kwargs.items() if k != "interpret"}
    assert kw["bm25_pallas"] == kernel_branches or kw["mode"] == "vector"
    pv, pi, pc, pf = port_hybrid.hybrid_fused_topk_mf(
        *to_torch(args), **{k: to_torch(v) for k, v in kw.items()}
    )
    rv, ri = np.asarray(rv), np.asarray(ri)
    matched = rv > 0
    assert matched.sum() > 0, body
    np.testing.assert_array_equal(pi.numpy()[matched], ri[matched])
    np.testing.assert_allclose(pv.numpy(), rv, rtol=1e-5, atol=1e-7)
    assert int(pc) == int(rc)
    assert len(pf) == len(rf)
    for a, b in zip(pf, rf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fused_program_live_windows_match(ref_engine, monkeypatch):
    """Freshness-window contributions ride the staging as scatter pairs."""
    from orama_core_tpu import build_orama  # noqa: F401  (engine fixture)

    reader = ref_engine.read_side._reader("c")
    monkeypatch.setattr(reader.cfg, "_test_force_fast_path", True,
                        raising=False)
    ref_engine.write_side.write("c", [
        {"id": "w1", "title": "solar wind", "body": "solar panel wind"},
        {"id": "w2", "title": "cake", "body": "flour cake quantum"},
    ], WRITE)
    ref_engine.flush()
    try:
        for body in ({"term": "solar wind", "mode": "fulltext"},
                     {"term": "cake", "mode": "hybrid"}):
            args, kwargs, (rv, ri, rc, _rf) = _capture_ref(
                monkeypatch, reader, ref_engine.read_side.ai, body)
            assert kwargs["u_ft_n"] > 0
            kw = {k: v for k, v in kwargs.items() if k != "interpret"}
            pv, pi, pc, _pf = port_hybrid.hybrid_fused_topk_mf(
                *to_torch(args), **{k: to_torch(v) for k, v in kw.items()}
            )
            rv, ri = np.asarray(rv), np.asarray(ri)
            m = rv > 0
            np.testing.assert_array_equal(pi.numpy()[m], ri[m])
            np.testing.assert_allclose(pv.numpy(), rv, rtol=1e-5, atol=1e-7)
            assert int(pc) == int(rc)
    finally:
        ref_engine.write_side.delete_documents("c", ["w1", "w2"], WRITE)
        ref_engine.flush()
