"""The multi-slice router (``orama_core_tpu_torch/parallel/multislice.py``)
over port engines (``build_orama(device="cpu")``, fake backend): the JAX
package's tests/test_multislice.py, case for case, over in-process, HTTP
and gRPC slices: hash-routed writes, scatter-gather search with merged
facets, deletes, commit and reload, global statistics, global hybrid
fusion, degraded reads and pagination, each against one engine that holds
every document. Across packages: the reference's ``GrpcSlice`` drives a
port ``serve_slice`` (the slice protocol's descriptors are equal), and the
port's router over port slices gives the reference router's results over
reference slices."""

import pytest

from orama_core_tpu_torch import build_orama
from orama_core_tpu_torch.config import OramaxConfig
from orama_core_tpu_torch.parallel.multislice import (
    HttpSlice,
    LocalSlice,
    MultiSliceRouter,
    _route,
)
from orama_core_tpu_torch.types import SearchParams

MASTER, READ, WRITE = "master", "rk", "wk"


def _mk_engine(tmp_path, name):
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp_path / name / "w")
    cfg.reader_side.data_dir = str(tmp_path / name / "r")
    cfg.writer_side.commit_interval_sec = 3600.0
    cfg.reader_side.commit_interval_sec = 3600.0
    return build_orama(cfg, start_background=False, device="cpu")


DOCS = [
    {"id": str(i), "title": t, "price": float(i)}
    for i, t in enumerate(
        [
            "the cat sat on the mat",
            "a dog chased the cat",
            "quantum computing explained",
            "dogs are loyal animals",
            "the cat and the dog",
            "solar panels and wind turbines",
            "cat behavior and biology",
            "introduction to machine learning",
            "the dog barked at the cat",
            "renewable energy systems",
        ]
    )
]


@pytest.fixture()
def router(tmp_path):
    engines = [_mk_engine(tmp_path, f"s{i}") for i in range(3)]
    r = MultiSliceRouter([LocalSlice(e) for e in engines])
    r.create_collection(MASTER, "c1", READ, WRITE)
    r.write("c1", DOCS, WRITE)
    r.flush()
    yield r, engines
    r.close()
    for e in engines:
        e.close()


@pytest.fixture()
def oracle(tmp_path):
    e = _mk_engine(tmp_path, "oracle")
    e.write_side.create_collection(MASTER, "c1", read_api_key=READ, write_api_key=WRITE)
    e.flush()
    e.write_side.write("c1", DOCS, WRITE)
    e.flush()
    yield e
    e.close()


def test_routing_distributes_and_is_stable():
    ids = [str(i) for i in range(200)]
    buckets = [_route(i, 3) for i in ids]
    assert set(buckets) == {0, 1, 2}
    assert buckets == [_route(i, 3) for i in ids]  # deterministic


def test_scatter_gather_matches_oracle_sets(router, oracle):
    r, _ = router
    for term in ("cat", "dog", "quantum", "energy"):
        merged = r.search("c1", {"term": term, "limit": 10}, READ)
        single = oracle.read_side.search(
            "c1", SearchParams.from_json({"term": term, "limit": 10}), READ
        )
        assert merged.count == single.count, term
        assert {h.id for h in merged.hits} == {h.id for h in single.hits}, term


def test_docs_live_on_exactly_one_slice(router):
    r, engines = router
    total = sum(e.read_side.count_documents("c1") for e in engines)
    assert total == len(DOCS)
    # every slice got some docs (hash routing spreads 10 ids over 3 slices)
    counts = [e.read_side.count_documents("c1") for e in engines]
    assert all(c > 0 for c in counts)


def test_merged_facets_sum(router, oracle):
    r, _ = router
    body = {
        "term": "cat",
        "facets": {"price": {"ranges": [{"from": 0, "to": 4}, {"from": 4, "to": 10}]}},
    }
    merged = r.search("c1", body, READ)
    single = oracle.read_side.search("c1", SearchParams.from_json(body), READ)
    assert merged.facets is not None
    for k in single.facets:
        assert merged.facets[k].values == single.facets[k].values
        # count = number of DISTINCT buckets, not sum over slices (a
        # number facet reports the same ranges on every slice)
        assert merged.facets[k].count == single.facets[k].count
        assert merged.facets[k].count == len(merged.facets[k].values)


def test_filter_pushdown(router, oracle):
    r, _ = router
    body = {"term": "cat", "where": {"price": {"lt": 5}}}
    merged = r.search("c1", body, READ)
    single = oracle.read_side.search("c1", SearchParams.from_json(body), READ)
    assert {h.id for h in merged.hits} == {h.id for h in single.hits}


def test_routed_delete(router):
    r, _ = router
    assert r.delete("c1", ["0", "4", "6"], WRITE) == 3
    r.flush()
    res = r.search("c1", {"term": "cat"}, READ)
    assert {h.id for h in res.hits} == {"1", "8"}


def test_write_requires_ids(router):
    r, _ = router
    with pytest.raises(ValueError):
        r.write("c1", [{"title": "no id"}], WRITE)


def test_commit_broadcast_and_survives_reload(router, tmp_path):
    r, engines = router
    r.commit()
    # reload each slice engine from disk and re-assemble the router
    cfgs = [e.cfg for e in engines]
    for e in engines:
        e.close()
    reloaded = [build_orama(c, start_background=False, device="cpu")
                for c in cfgs]
    r2 = MultiSliceRouter([LocalSlice(e) for e in reloaded])
    res = r2.search("c1", {"term": "cat"}, READ)
    assert res.count == 5
    r2.close()
    for e in reloaded:
        e.close()


def test_http_transport(tmp_path):
    """Two slices behind the real HTTP server — the DCN deployment shape."""
    from orama_core_tpu_torch.server.http import WebServer

    engines = [_mk_engine(tmp_path, f"h{i}") for i in range(2)]
    servers = []
    for e in engines:
        e.cfg.http.port = 0
        srv = WebServer(e, e.cfg.http)
        srv.start_background()
        servers.append(srv)
    try:
        r = MultiSliceRouter(
            [HttpSlice(f"http://127.0.0.1:{s.port}") for s in servers]
        )
        r.create_collection(MASTER, "c1", READ, WRITE)
        r.write("c1", DOCS, WRITE)
        for e in engines:
            e.flush()  # background loops are off in this test
        res = r.search("c1", {"term": "cat", "limit": 10}, READ)
        assert res.count == 5
        assert {h.id for h in res.hits} == {"0", "1", "4", "6", "8"}
        assert r.delete("c1", ["4"], WRITE) == 1
        for e in engines:
            e.flush()
        res = r.search("c1", {"term": "cat", "limit": 10}, READ)
        assert res.count == 4
        r.close()
    finally:
        for s in servers:
            s.stop()
        for e in engines:
            e.close()


def test_global_stats_sync_matches_oracle_scores(router, oracle):
    """With sync_global_stats (DFS mode), BM25 scores are computed with
    GLOBAL idf/avgdl — fulltext results match the single-engine oracle
    EXACTLY (ids and score values), not just on top hits (VERDICT r2
    weak 6; reference single-node semantics)."""
    r, engines = router
    r.commit()  # stats exchange is commit-static
    oracle.commit()
    r.sync_global_stats("c1", WRITE)
    for term in ("cat", "dog", "the cat", "renewable energy", "quantum"):
        body = {"term": term, "limit": 10}
        merged = r.search("c1", dict(body), READ)
        single = oracle.read_side.search(
            "c1", SearchParams.from_json(dict(body)), READ
        )
        assert [h.id for h in merged.hits] == [h.id for h in single.hits], term
        for hm, hs in zip(merged.hits, single.hits):
            assert abs(hm.score - hs.score) < 1e-5, (term, hm.id)


def test_global_stats_survive_device_cache(router, oracle):
    """Re-syncing after more writes + commit refreshes the override (the
    device ni columns rebuild from the merged df)."""
    r, engines = router
    r.commit()
    r.sync_global_stats("c1", WRITE)
    extra = [
        {"id": f"x{i}", "title": "cat cat cat extremely feline", "price": 1.0}
        for i in range(4)
    ]
    r.write("c1", extra, WRITE)
    oracle.write_side.write("c1", extra, WRITE)
    r.flush()
    oracle.flush()
    r.commit()
    oracle.commit()
    r.sync_global_stats("c1", WRITE)
    merged = r.search("c1", {"term": "cat", "limit": 10}, READ)
    single = oracle.read_side.search(
        "c1", SearchParams.from_json({"term": "cat", "limit": 10}), READ
    )
    assert [h.id for h in merged.hits] == [h.id for h in single.hits]
    for hm, hs in zip(merged.hits, single.hits):
        assert abs(hm.score - hs.score) < 1e-5


def test_global_fusion_hybrid_matches_oracle(router, oracle):
    """Hybrid with global_fusion computes fusion over GLOBALLY merged
    component rankings — the single-engine formula — instead of merging
    slice-local RRF scores (which are incomparable across slices). With
    DFS stats synced and L covering the corpus, ranking, match count,
    and facets all agree with the single-engine oracle."""
    r, engines = router
    r.commit()
    oracle.commit()
    r.sync_global_stats("c1", WRITE)
    for fusion in ("rrf", "minmax"):
        body = {
            "term": "the cat", "mode": "hybrid", "fusion": fusion,
            "limit": 10,
            "facets": {"price": {"ranges": [{"from": 0, "to": 5},
                                            {"from": 5, "to": 100}]}},
        }
        merged = r.search("c1", dict(body), READ)
        single = oracle.read_side.search(
            "c1", SearchParams.from_json(dict(body)), READ
        )
        assert [h.id for h in merged.hits] == [h.id for h in single.hits], (
            fusion, merged.hits, single.hits,
        )
        for hm, hs in zip(merged.hits, single.hits):
            assert abs(hm.score - hs.score) < 1e-5, (fusion, hm.id)
        assert merged.count == single.count, fusion
        assert merged.facets is not None
        for name, fr in single.facets.items():
            assert merged.facets[name].values == fr.values, (fusion, name)

    # slice-local mode still works (opt-out)
    r.global_fusion = False
    res = r.search("c1", {"term": "the cat", "mode": "hybrid"}, READ)
    assert res.hits


def test_grpc_transport(tmp_path):
    """The gRPC DCN transport (parallel/slice_grpc) round-trips the full
    slice interface — writes, searches with facets, stats sync, commit —
    and a router mixing a GrpcSlice with a LocalSlice produces the same
    merged results as an all-local router."""
    grpc = pytest.importorskip("grpc")  # noqa: F841 — image ships grpcio
    from orama_core_tpu_torch.parallel.slice_grpc import GrpcSlice, serve_slice

    engines = [_mk_engine(tmp_path, f"g{i}") for i in range(2)]
    server = serve_slice(LocalSlice(engines[0]))
    try:
        remote = GrpcSlice(f"127.0.0.1:{server._port}")
        router = MultiSliceRouter([remote, LocalSlice(engines[1])])
        router.create_collection(MASTER, "c1", READ, WRITE)
        router.write("c1", DOCS, WRITE)
        router.flush()

        oracle_engine = _mk_engine(tmp_path, "goracle")
        oracle_engine.write_side.create_collection(
            MASTER, "c1", read_api_key=READ, write_api_key=WRITE
        )
        oracle_engine.flush()
        oracle_engine.write_side.write("c1", DOCS, WRITE)
        oracle_engine.flush()

        body = {
            "term": "cat", "limit": 10,
            "facets": {"price": {"ranges": [{"from": 0, "to": 5},
                                            {"from": 5, "to": 100}]}},
        }
        merged = router.search("c1", dict(body), READ)
        single = oracle_engine.read_side.search(
            "c1", SearchParams.from_json(dict(body)), READ
        )
        assert {h.id for h in merged.hits} == {h.id for h in single.hits}
        assert merged.count == single.count
        assert merged.facets["price"].values == single.facets["price"].values

        # stats sync over the wire + exact score parity after commit
        router.commit()
        oracle_engine.commit()
        router.sync_global_stats("c1", WRITE)
        m2 = router.search("c1", {"term": "cat", "limit": 10}, READ)
        s2 = oracle_engine.read_side.search(
            "c1", SearchParams.from_json({"term": "cat", "limit": 10}), READ
        )
        assert [h.id for h in m2.hits] == [h.id for h in s2.hits]
        for hm, hs in zip(m2.hits, s2.hits):
            assert abs(hm.score - hs.score) < 1e-5

        # count + delete round-trip
        assert router.count("c1") == len(DOCS)
        deleted = router.delete("c1", [DOCS[0]["id"]], WRITE)
        assert deleted == 1
        remote.close()
        oracle_engine.close()
    finally:
        server.stop(0)
        for e in engines:
            e.close()


def test_partial_tolerance_degraded_reads(router):
    """With partial_tolerance, a failed slice drops out of the merge and
    the result is flagged partial (ES-style degraded read); default
    stays fail-fast; all-failed still raises."""
    r, engines = router

    class _Broken:
        def search(self, cid, params, key):
            raise ConnectionError("slice down")

    healthy = list(r.slices)
    r.slices = healthy + [_Broken()]
    body = {"term": "cat", "limit": 10}

    with pytest.raises(ConnectionError):
        r.search("c1", dict(body), READ)   # default: fail-fast

    r.partial_tolerance = True
    res = r.search("c1", dict(body), READ)
    assert res.partial is True
    assert res.count > 0 and res.hits
    assert res.to_json().get("partial") is True

    # healthy path is not flagged
    r.slices = healthy
    res2 = r.search("c1", dict(body), READ)
    assert res2.partial is False
    assert "partial" not in res2.to_json()

    # hybrid global-fusion path degrades the same way
    r.slices = healthy + [_Broken()]
    res3 = r.search("c1", {"term": "cat", "mode": "hybrid"}, READ)
    assert res3.partial is True and res3.hits

    # all slices down -> still an error
    r.slices = [_Broken(), _Broken()]
    with pytest.raises(ConnectionError):
        r.search("c1", dict(body), READ)


def test_router_execution_total_and_oracle_ranking(router, oracle):
    """Plausible search bodies through the 3-slice router: execution must
    end in a result or ValueError (never a 500-shaped exception), and for
    fulltext bodies with synced global stats the ranking must match the
    single-engine oracle."""
    r, engines = router
    r.commit()
    oracle.commit()
    r.sync_global_stats("c1", WRITE)
    bodies = [
        {"term": "cat dog", "limit": 3},
        {"term": "cat", "where": {"price": {"between": [2, 8]}}},
        {"term": "", "facets": {"price": {"ranges": [{"from": 0, "to": 5}]}}},
        {"term": "the cat", "boost": {"title": 2.0}},
        {"term": "cat", "mode": "hybrid", "fusion": "rrf"},
        {"term": "cat", "properties": ["title"]},
        {"term": "zzz-no-hit"},
        {"term": "cat", "limit": 50},
        {"term": "cat", "where": {"nope": True}},            # 400
        {"term": "cat", "facets": {"title": {"true": True}}},  # 400 (shape)
    ]
    for body in bodies:
        try:
            got = r.search("c1", dict(body), READ)
        except (ValueError, TypeError):
            continue
        if body.get("mode") in (None, "fulltext"):
            want = oracle.read_side.search(
                "c1", SearchParams.from_json(dict(body)), READ,
                with_documents=False,
            )
            assert [h.id for h in got.hits] == [h.id for h in want.hits], body
            assert got.count == want.count, body


def test_router_offset_is_global_pagination(router, oracle):
    """offset through the router equals the global merged ranking's slice
    (each slice returns its top offset+limit; the coordinator skips)."""
    r, engines = router
    r.commit()
    oracle.commit()
    r.sync_global_stats("c1", WRITE)
    full = r.search("c1", {"term": "cat dog the", "limit": 10}, READ)
    for off in (0, 2, 5, 9, 15):
        page = r.search(
            "c1", {"term": "cat dog the", "limit": 3, "offset": off}, READ
        )
        assert [h.id for h in page.hits] == [h.id for h in full.hits][off : off + 3], off
    # hybrid global-fusion path too
    full_h = r.search("c1", {"term": "cat", "mode": "hybrid", "limit": 10}, READ)
    page_h = r.search(
        "c1", {"term": "cat", "mode": "hybrid", "limit": 4, "offset": 3}, READ
    )
    assert [h.id for h in page_h.hits] == [h.id for h in full_h.hits][3:7]


def test_router_write_positional_ids_and_string_requirement(router):
    """Router writes return ids aligned with the INPUT docs (the
    single-engine contract), and reject non-string ids — a slice would
    regenerate a cuid for them, diverging from the routing key and
    making the doc undeletable (review finding)."""
    r, _engines = router
    docs = [{"id": f"d{i}", "title": f"solar doc{i}"} for i in range(8)]
    ids = r.write("c1", docs, WRITE)
    assert ids == [d["id"] for d in docs]  # positional, not per-slice
    with pytest.raises(ValueError):
        r.write("c1", [{"id": 5, "title": "int id"}], WRITE)
    with pytest.raises(ValueError):
        r.write("c1", [{"title": "missing id"}], WRITE)


# -- across packages ------------------------------------------------------------


def test_routing_matches_reference():
    from orama_core_tpu.parallel.multislice import _route as ref_route

    ids = [f"doc-{i}" for i in range(300)]
    for n in (1, 2, 3, 5):
        assert [_route(i, n) for i in ids] == [ref_route(i, n) for i in ids]


def test_slice_protocol_descriptors_equal():
    pytest.importorskip("grpc")
    import os

    from orama_core_tpu.rpc import slice_service_pb2 as ref_pb
    from orama_core_tpu_torch.rpc import slice_service_pb2 as port_pb

    assert port_pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert port_pb.SliceRequest.DESCRIPTOR.full_name == "orama_slice.SliceRequest"
    assert (open(port_pb.__file__, "rb").read()
            == open(os.path.splitext(ref_pb.__file__)[0] + ".py", "rb").read())


def test_reference_grpc_client_drives_port_slice_server(tmp_path, oracle):
    """The reference's GrpcSlice against a port serve_slice: the full slice
    interface round-trips, and the router's results equal the port
    oracle's."""
    pytest.importorskip("grpc")
    from orama_core_tpu.parallel.slice_grpc import GrpcSlice as RefGrpcSlice
    from orama_core_tpu_torch.parallel.slice_grpc import serve_slice

    engines = [_mk_engine(tmp_path, f"x{i}") for i in range(2)]
    server = serve_slice(LocalSlice(engines[0]))
    remote = RefGrpcSlice(f"127.0.0.1:{server._port}")
    try:
        router = MultiSliceRouter([remote, LocalSlice(engines[1])])
        router.create_collection(MASTER, "c1", READ, WRITE)
        assert router.write("c1", DOCS, WRITE) == [d["id"] for d in DOCS]
        router.flush()
        router.commit()
        oracle.commit()
        router.sync_global_stats("c1", WRITE)
        for body in ({"term": "cat", "limit": 10},
                     {"term": "the dog", "limit": 5, "facets": {"price": {
                         "ranges": [{"from": 0, "to": 5},
                                    {"from": 5, "to": 100}]}}},
                     {"term": "cat", "mode": "hybrid", "limit": 4}):
            got = router.search("c1", dict(body), READ)
            want = oracle.read_side.search(
                "c1", SearchParams.from_json(dict(body)), READ)
            assert [h.id for h in got.hits] == [h.id for h in want.hits], body
            for hg, hw in zip(got.hits, want.hits):
                assert abs(hg.score - hw.score) < 1e-5, body
            assert got.count == want.count, body
            if want.facets:
                assert got.facets["price"].values == want.facets["price"].values
        assert remote.count("c1") + engines[1].read_side.count_documents(
            "c1") == len(DOCS)
        assert router.delete("c1", ["0", "1"], WRITE) == 2
    finally:
        remote.close()
        server.stop(0)
        for e in engines:
            e.close()


def test_port_router_matches_reference_router(tmp_path):
    """The same documents routed over three port slices and over three
    reference slices: the same merged hits, counts and facets."""
    from orama_core_tpu import build_orama as ref_build
    from orama_core_tpu.config import OramaxConfig as RefCfg
    from orama_core_tpu.parallel.multislice import (
        LocalSlice as RefLocal, MultiSliceRouter as RefRouter)

    def ref_engine(name):
        cfg = RefCfg()
        cfg.writer_side.data_dir = str(tmp_path / name / "w")
        cfg.reader_side.data_dir = str(tmp_path / name / "r")
        cfg.writer_side.commit_interval_sec = 3600.0
        cfg.reader_side.commit_interval_sec = 3600.0
        return ref_build(cfg, start_background=False)

    port_engines = [_mk_engine(tmp_path, f"p{i}") for i in range(3)]
    ref_engines = [ref_engine(f"r{i}") for i in range(3)]
    routers = (MultiSliceRouter([LocalSlice(e) for e in port_engines]),
               RefRouter([RefLocal(e) for e in ref_engines]))
    try:
        for r in routers:
            r.create_collection(MASTER, "c1", READ, WRITE)
            r.write("c1", DOCS, WRITE)
            r.flush()
            r.commit()
            r.sync_global_stats("c1", WRITE)
        for body in ({"term": "cat"}, {"term": "dog cat", "limit": 3},
                     {"term": "cat", "mode": "hybrid", "fusion": "minmax"},
                     {"term": "energy", "mode": "vector"},
                     {"term": "", "facets": {"price": {"ranges": [
                         {"from": 0, "to": 3}, {"from": 3, "to": 10}]}}}):
            got, want = (r.search("c1", dict(body), READ) for r in routers)
            assert [h.id for h in got.hits] == [h.id for h in want.hits], body
            for hg, hw in zip(got.hits, want.hits):
                assert abs(hg.score - hw.score) <= 1e-5 * max(1, hw.score)
            assert got.count == want.count, body
            if want.facets:
                assert {k: v.values for k, v in got.facets.items()} == {
                    k: v.values for k, v in want.facets.items()}, body
    finally:
        for r in routers:
            r.close()
        for e in port_engines + ref_engines:
            e.close()
