"""The port's gRPC model sidecar (``orama_core_tpu_torch/rpc``) against the
JAX package's.

- tests/test_grpc.py's nine cases against the port: its ``serve_ai``,
  ``RemoteAIService`` and engine (``build_orama(device="cpu")``), fake
  backend;
- across packages: the port's server driven by the reference's client and
  the reference's server by the port's client; embeddings equal the
  in-process ones (rtol 1e-6), and chat, health and the planned-answer
  stream agree;
- a port engine with ``ai.remote_url`` pointed at a reference sidecar
  serves the same hits as a reference engine with in-process models.
"""

import json

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from orama_core_tpu_torch.config import OramaxConfig
from orama_core_tpu_torch.models.ai_service import AIService
from orama_core_tpu_torch.rpc import RemoteAIService, serve_ai
from orama_core_tpu_torch.rpc import ai_service_pb2 as pb
from orama_core_tpu_torch.rpc.stubs import ENUM_TO_MODEL, MODEL_TO_ENUM
from orama_core_tpu_torch.types import SearchParams

MASTER, READ, WRITE = "master", "read-key", "write-key"


@pytest.fixture(scope="module")
def backend():
    ai = AIService(device="cpu")  # fake backend: hash-projection embedder
    server, port = serve_ai(ai, port=0)
    client = RemoteAIService(f"127.0.0.1:{port}")
    yield ai, client
    client.close()
    server.stop(grace=0)


# -- tests/test_grpc.py on the port ------------------------------------------


def test_embed_roundtrip_matches_inprocess(backend):
    ai, client = backend
    texts = ["the cat sat", "quantum computing", ""]
    remote = client.embed_query("fake-small", texts)
    local = ai.embed_query("fake-small", texts)
    assert remote.shape == local.shape == (3, 128)
    np.testing.assert_allclose(remote, local, rtol=1e-6)
    # passage intent takes the other prefix path
    rp = client.embed_passage("fake-base", ["doc body"])
    lp = ai.embed_passage("fake-base", ["doc body"])
    np.testing.assert_allclose(rp, lp, rtol=1e-6)


def test_embed_empty_input(backend):
    _, client = backend
    out = client.embed_query("fake-small", [])
    assert out.shape[0] == 0


def test_model_enum_mapping_bijective():
    assert set(ENUM_TO_MODEL.values()) == set(MODEL_TO_ENUM.keys())
    assert MODEL_TO_ENUM["bge-small"] == pb.BGESmall
    assert ENUM_TO_MODEL[pb.MultilingualE5Large] == "multilingual-e5-large"


def test_chat_and_stream(backend):
    ai, client = backend
    full = client.chat("answer", "What is a cat?", context="cats are animals")
    assert isinstance(full, str) and full
    chunks = list(client.chat_stream("answer", "What is a cat?"))
    assert chunks and "".join(chunks)


def test_health(backend):
    _, client = backend
    h = client.check_health()
    assert h["status"] == "ok"
    assert h["backend"].startswith("remote:")


def test_health_unreachable():
    dead = RemoteAIService("127.0.0.1:1", timeout_s=0.5)
    h = dead.check_health()
    assert h["status"] == "error"
    dead.close()


def test_planned_answer_unimplemented_without_planner(backend):
    _, client = backend
    with pytest.raises(grpc.RpcError) as ei:
        list(client.planned_answer("q", "c1"))
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED


def _cfg(tmp_path, Cfg=OramaxConfig, tag=""):
    cfg = Cfg()
    cfg.writer_side.data_dir = str(tmp_path / f"{tag}writer")
    cfg.reader_side.data_dir = str(tmp_path / f"{tag}reader")
    cfg.writer_side.commit_interval_sec = 3600.0
    cfg.reader_side.commit_interval_sec = 3600.0
    return cfg


def test_engine_exposes_grpc_sidecar(tmp_path):
    """ai.grpc_port: the engine doubles as a model sidecar — embeddings and
    PlannedAnswer served over the wire (reference ai_server role)."""
    from orama_core_tpu_torch import build_orama

    cfg = _cfg(tmp_path)
    cfg.ai.grpc_port = 0
    engine = build_orama(cfg, start_background=False, device="cpu")
    client = RemoteAIService(f"127.0.0.1:{engine.grpc_port}")
    try:
        engine.write_side.create_collection(
            MASTER, "c1", read_api_key=READ, write_api_key=WRITE
        )
        engine.flush()
        engine.write_side.write(
            "c1", [{"id": "1", "title": "the cat sat on the mat"}], WRITE
        )
        engine.flush()
        out = client.embed_query("fake-small", ["hello"])
        assert out.shape == (1, 128)
        events = list(client.planned_answer("tell me about cats", "c1"))
        assert events[-1][1] is True  # finished marker
        actions = [json.loads(d)["action"] for d, fin in events if d]
        assert "ACTION_PLAN" in actions and "GIVE_REPLY" in actions
    finally:
        client.close()
        engine.close()


def test_engine_with_remote_backend(tmp_path, backend):
    """Full engine with ai.remote_url: auto-embeddings travel over gRPC and
    vector search works end-to-end."""
    from orama_core_tpu_torch import build_orama

    _, client = backend
    cfg = _cfg(tmp_path)
    cfg.ai.remote_url = client.url
    engine = build_orama(cfg, start_background=False, device="cpu")
    try:
        assert type(engine.ai).__name__ == "RemoteAIService"
        engine.write_side.create_collection(
            MASTER, "c1", read_api_key=READ, write_api_key=WRITE,
            embedding_model="fake-small",
        )
        engine.flush()
        engine.write_side.write(
            "c1",
            [
                {"id": "1", "title": "the cat sat on the mat"},
                {"id": "2", "title": "quantum computing explained"},
            ],
            WRITE,
        )
        engine.flush()
        res = engine.read_side.search(
            "c1",
            SearchParams.from_json({"term": "cat sat mat", "mode": "vector"}),
            READ,
        )
        assert res.count >= 1
        assert res.hits[0].id == "1"
    finally:
        engine.close()


# -- across packages -----------------------------------------------------------

DOCS = [
    {"id": "1", "title": "the cat sat on the mat", "body": "cats purr"},
    {"id": "2", "title": "quantum computing explained", "body": "qubits"},
    {"id": "3", "title": "a dog chased the cat", "body": "dogs bark"},
    {"id": "4", "title": "solar panels on the roof", "body": "energy"},
]


def test_one_proto_registration_shared():
    """Both packages' generated modules are the same file, so the default
    pool holds one ai_service.proto and both see the same messages."""
    from orama_core_tpu.rpc import ai_service_pb2 as ref_pb

    assert ref_pb.DESCRIPTOR.serialized_pb == pb.DESCRIPTOR.serialized_pb
    assert ref_pb.DESCRIPTOR.package == pb.DESCRIPTOR.package == \
        "orama_ai_service"
    assert ref_pb.EmbeddingRequest.DESCRIPTOR.full_name == \
        pb.EmbeddingRequest.DESCRIPTOR.full_name


class Sidecars:
    """A reference engine and a port engine, each serving its models and
    its planner over gRPC (``ai.grpc_port = 0``), with the same documents;
    ``ref_client`` (the reference's client) talks to the PORT's server and
    ``port_client`` to the REFERENCE's."""

    def __init__(self, tmp_path):
        from orama_core_tpu import build_orama as ref_build
        from orama_core_tpu.config import OramaxConfig as RefCfg
        from orama_core_tpu.rpc import RemoteAIService as RefRemote
        from orama_core_tpu_torch import build_orama as port_build

        cfg = _cfg(tmp_path, RefCfg, "ref-")
        cfg.ai.grpc_port = 0
        cfg.tpu._test_force_fast_path = True
        self.ref = ref_build(cfg, start_background=False)
        cfg = _cfg(tmp_path, OramaxConfig, "port-")
        cfg.ai.grpc_port = 0
        self.port = port_build(cfg, start_background=False, device="cpu")
        for e in (self.ref, self.port):
            e.write_side.create_collection(
                MASTER, "c1", read_api_key=READ, write_api_key=WRITE)
            e.flush()
            e.write_side.write("c1", DOCS, WRITE)
            e.flush()
        self.ref_client = RefRemote(f"127.0.0.1:{self.port.grpc_port}")
        self.port_client = RemoteAIService(f"127.0.0.1:{self.ref.grpc_port}")

    def close(self):
        for c in (self.ref_client, self.port_client):
            c.close()
        for e in (self.ref, self.port):
            e.close()


@pytest.fixture()
def sidecars(tmp_path):
    s = Sidecars(tmp_path)
    yield s
    s.close()


@pytest.mark.parametrize("model", ["fake-small", "fake-base"])
def test_cross_package_embeddings(sidecars, model):
    texts = ["the cat sat", "quantum computing", "", "solar roof energy"]
    want_q = sidecars.port.ai.embed_query(model, texts)
    want_p = sidecars.ref.ai.embed_passage(model, texts)
    for client in (sidecars.ref_client, sidecars.port_client):
        np.testing.assert_allclose(client.embed_query(model, texts), want_q,
                                   rtol=1e-6)
        np.testing.assert_allclose(client.embed_passage(model, texts), want_p,
                                   rtol=1e-6)
        assert client.embed_query(model, []).shape[0] == 0


def test_cross_package_chat_and_health(sidecars):
    args = ("answer", "What is a cat?", "cats are animals")
    want = sidecars.ref.ai.chat(*args)
    assert sidecars.ref_client.chat(*args) == want
    assert sidecars.port_client.chat(*args) == want
    want_chunks = list(sidecars.port.ai.chat_stream(*args))
    assert list(sidecars.ref_client.chat_stream(*args)) == want_chunks
    assert list(sidecars.port_client.chat_stream(*args)) == want_chunks
    for client in (sidecars.ref_client, sidecars.port_client):
        h = client.check_health()
        assert h["status"] == "ok" and h["backend"].startswith("remote:")


def test_cross_package_planned_answer(sidecars):
    """The port's planner through the reference's client and the
    reference's planner through the port's client: the same events."""
    conv = [{"role": "user", "content": "hi"},
            {"role": "assistant", "content": "hello"}]
    from_port = list(sidecars.ref_client.planned_answer(
        "tell me about cats", "c1", conv))
    from_ref = list(sidecars.port_client.planned_answer(
        "tell me about cats", "c1", conv))
    assert from_port[-1] == from_ref[-1] == ("", True)
    got = [json.loads(d) for d, _ in from_port[:-1]]
    want = [json.loads(d) for d, _ in from_ref[:-1]]
    assert [e["action"] for e in got] == [e["action"] for e in want]
    assert got[0]["action"] == "ACTION_PLAN" and \
        got[-1]["action"] == "GIVE_REPLY"
    for g, w in zip(got, want):
        if g["action"] == "PERFORM_ORAMA_SEARCH":
            gr, wr = json.loads(g["result"]), json.loads(w["result"])
            assert [h["id"] for h in gr["hits"]] == \
                [h["id"] for h in wr["hits"]]
            np.testing.assert_allclose([h["score"] for h in gr["hits"]],
                                       [h["score"] for h in wr["hits"]],
                                       rtol=1e-5)
        else:
            assert g == w


def test_port_engine_on_reference_sidecar(tmp_path):
    """ai.remote_url on the port, pointed at the reference's sidecar: the
    same hits as a reference engine with its models in process."""
    from orama_core_tpu import build_orama as ref_build
    from orama_core_tpu.config import OramaxConfig as RefCfg
    from orama_core_tpu.models.ai_service import AIService as RefAI
    from orama_core_tpu.rpc import serve_ai as ref_serve
    from orama_core_tpu.types import SearchParams as RefParams
    from orama_core_tpu_torch import build_orama

    server, port = ref_serve(RefAI(), port=0)
    cfg = _cfg(tmp_path, OramaxConfig, "port-")
    cfg.ai.remote_url = f"127.0.0.1:{port}"
    remote = build_orama(cfg, start_background=False, device="cpu")
    rcfg = _cfg(tmp_path, RefCfg, "ref-")
    rcfg.tpu._test_force_fast_path = True
    ref = ref_build(rcfg, start_background=False)
    try:
        assert type(remote.ai).__name__ == "RemoteAIService"
        for e in (remote, ref):
            e.write_side.create_collection(
                MASTER, "c1", read_api_key=READ, write_api_key=WRITE,
                embedding_model="fake-small")
            e.flush()
            e.write_side.write("c1", DOCS, WRITE)
            e.commit()
        for body in ({"term": "cat sat mat", "mode": "vector"},
                     {"term": "cat", "mode": "fulltext"},
                     {"term": "solar energy", "mode": "hybrid"},
                     {"term": "dog", "mode": "vector", "limit": 2}):
            got = remote.read_side.search(
                "c1", SearchParams.from_json(dict(body)), READ)
            want = ref.read_side.search(
                "c1", RefParams.from_json(dict(body)), READ)
            assert [h.id for h in got.hits] == [h.id for h in want.hits], body
            assert got.count == want.count, body
            np.testing.assert_allclose([h.score for h in got.hits],
                                       [h.score for h in want.hits],
                                       rtol=1e-5, err_msg=str(body))
    finally:
        remote.close()
        ref.close()
        server.stop(grace=0)
