"""The port's answer engine (``orama_core_tpu_torch/engine/answer.py``):
the four cases of tests/test_answer_jax_backend.py on the port, and the
event lists of ``answer_events`` and ``PartyPlanner`` held equal to the
reference's on the same documents: with the fake LLM, and with the
decoder (``ai.backend = "jax"``) on carried f32 parameters, whose greedy
tokens and so whole answers are the reference's. Search scores inside
the events compare within rtol 1e-5 (the engine parity tests' bound);
the ``elapsed`` timing field is dropped."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orama_core_tpu_torch import build_orama
from orama_core_tpu_torch.config import OramaxConfig
from orama_core_tpu_torch.engine.answer import answer_events

MASTER, READ, WRITE = "master", "rk", "wk"
DOCS = [
    {"id": "1", "body": "the answer engine test document"},
    {"id": "2", "body": "party planner streaming test doc"},
    {"id": "3", "body": "hybrid search over tpu kernels and vectors"},
    {"id": "4", "body": "an unrelated note about gardening"},
]


def _cfg(Cfg, tmp_path, tag, backend="fake"):
    cfg = Cfg()
    cfg.writer_side.data_dir = str(tmp_path / f"{tag}-w")
    cfg.reader_side.data_dir = str(tmp_path / f"{tag}-r")
    cfg.writer_side.commit_interval_sec = 3600
    cfg.reader_side.commit_interval_sec = 3600
    cfg.ai.backend = backend
    if backend == "jax":
        cfg.ai.llm_model = "jax-tiny"        # random-weight decoder
        cfg.ai.embedding_model = "fake-small"  # embeddings stay deterministic
    return cfg


def _port_engine(tmp_path, backend="fake", docs=DOCS[:1]):
    engine = build_orama(_cfg(OramaxConfig, tmp_path, "port", backend),
                         start_background=False, device="cpu")
    engine.write_side.create_collection(MASTER, "c", READ, WRITE)
    engine.write_side.write("c", docs, WRITE)
    engine.flush()
    return engine


def _ref_engine(tmp_path, backend="fake", docs=DOCS[:1]):
    from orama_core_tpu import build_orama as ref_build
    from orama_core_tpu.config import OramaxConfig as RefCfg

    cfg = _cfg(RefCfg, tmp_path, "ref", backend)
    cfg.tpu._test_force_fast_path = True
    engine = ref_build(cfg, start_background=False)
    engine.write_side.create_collection(MASTER, "c", READ, WRITE)
    engine.write_side.write("c", docs, WRITE)
    engine.flush()
    return engine


# -- tests/test_answer_jax_backend.py on the port ------------------------------


def test_answer_pipeline_with_llm(tmp_path):
    from test_torch_llm import one_thread

    engine = _port_engine(tmp_path, backend="jax")
    try:
        with one_thread():
            events = list(answer_events(engine.read_side, "c", "what is this?",
                                        skip_auth=True))
        types = [e["type"] for e in events]
        assert types[0] == "acknowledgement"
        assert "optimized-query" in types
        assert "sources" in types
        chunks = [e for e in events if e["type"] == "answer_chunk"]
        assert chunks and chunks[-1]["message"]["is_final"] is True
        assert "error" not in types
        from orama_core_tpu_torch.models.llm import ChatLLM

        assert isinstance(engine.ai._get_llm(), ChatLLM)
    finally:
        engine.close()


def test_party_planner_streams_create_code_chunks(tmp_path):
    from orama_core_tpu_torch.engine.answer import PartyPlanner

    engine = _port_engine(tmp_path, docs=DOCS[1:2])
    try:
        planner = PartyPlanner(engine.read_side)
        planner.plan = lambda q: [
            {"step": "CREATE_CODE", "description": "write a long example "
             "function that frobnicates widgets thoroughly and carefully"},
            {"step": "GIVE_REPLY", "description": "reply"},
        ]
        events = list(planner.run("c", "make me code for frobnicating "
                                  "widgets in a loop with retries",
                                  skip_auth=True))
        cc = [e for e in events if e["action"] == "CREATE_CODE"]
        assert len(cc) >= 3
        assert cc[-1].get("done") is True
        assert all("done" not in e for e in cc[:-1])
        assert cc[-1]["result"].startswith("// generated")
        assert "".join(e["result"] for e in cc[:-1]).strip().startswith("{")
    finally:
        engine.close()


def test_party_planner_optimize_query_feeds_search(tmp_path):
    from orama_core_tpu_torch.engine.answer import PartyPlanner

    engine = _port_engine(tmp_path, docs=DOCS[1:2])
    try:
        events = list(PartyPlanner(engine.read_side).run(
            "c", "party planner streaming", skip_auth=True))
        actions = [e["action"] for e in events]
        assert actions[0] == "ACTION_PLAN"
        opt = next(e for e in events if e["action"] == "OPTIMIZE_QUERY")
        assert not opt["result"].strip().startswith("{")
        search = next(e for e in events if e["action"] == "PERFORM_ORAMA_SEARCH")
        assert json.loads(search["result"])["count"] >= 1
    finally:
        engine.close()


def test_query_translator_json_contract():
    from orama_core_tpu_torch.engine.answer import (
        decode_action_result, parse_query_json)
    from orama_core_tpu_torch.models.fake import FakeLLM

    raw = FakeLLM().chat("google_query_translator", "What is a TPU?")
    assert json.loads(raw)["query"]
    assert parse_query_json(raw) == json.loads(raw)["query"]
    assert parse_query_json("plain text reply") == "plain text reply"
    assert parse_query_json('prose {"query": "x"} prose') == "x"
    assert decode_action_result("GENERATE_QUERIES", '{"queries": ["a"]}') == '["a"]'
    assert decode_action_result("CREATE_CODE", "not json") == "not json"


# -- event lists against the reference -----------------------------------------


def _norm(x):
    """Events with their JSON strings parsed and ``elapsed`` dropped."""
    if isinstance(x, str) and x[:1] in "{[":
        try:
            return _norm(json.loads(x))
        except json.JSONDecodeError:
            return x
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k != "elapsed"}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _same(a, b, where="events"):
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-7), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


QUESTIONS = ["what is the answer engine?", "tell me about tpu kernels",
             "gardening"]


@pytest.fixture()
def pair(tmp_path):
    engines = (_ref_engine(tmp_path, docs=DOCS), _port_engine(tmp_path, docs=DOCS))
    yield engines
    for e in engines:
        e.close()


@pytest.mark.parametrize("question", QUESTIONS)
def test_answer_events_equal_reference(pair, question):
    from orama_core_tpu.engine.answer import answer_events as ref_answer

    ref, port = pair
    history = [{"role": "user", "content": "hi"},
               {"role": "assistant", "content": "hello"}]
    want = list(ref_answer(ref.read_side, "c", question, history, skip_auth=True))
    got = list(answer_events(port.read_side, "c", question, history,
                             skip_auth=True))
    _same(_norm(got), _norm(want))
    assert [e["type"] for e in got][-1] == "answer_chunk"


@pytest.mark.parametrize("plan", ["default", "generate_queries", "code"])
def test_party_planner_events_equal_reference(pair, plan):
    from orama_core_tpu.engine.answer import PartyPlanner as RefPlanner
    from orama_core_tpu_torch.engine.answer import PartyPlanner

    steps = {
        "default": None,
        "generate_queries": [
            {"step": "GENERATE_QUERIES", "description": "queries"},
            {"step": "PERFORM_ORAMA_SEARCH", "description": "search"},
            {"step": "ASK_FOLLOWUP", "description": "follow up"},
        ],
        "code": [
            {"step": "DESCRIBE_INPUT_CODE", "description": "describe"},
            {"step": "CREATE_CODE", "description": "code"},
            {"step": "IMPROVE_INPUT", "description": "improve"},
            {"step": "GIVE_REPLY", "description": "reply"},
        ],
    }[plan]
    ref, port = pair
    planners = [RefPlanner(ref.read_side), PartyPlanner(port.read_side)]
    if steps is not None:
        for p in planners:
            p.plan = lambda q: [dict(s) for s in steps]
    want, got = (list(p.run("c", "tell me about tpu kernels",
                            [{"role": "user", "content": "earlier"}],
                            skip_auth=True)) for p in planners)
    _same(_norm(got), _norm(want))


def test_answer_with_decoder_equal_reference(tmp_path):
    """``ai.backend = "jax"`` on both sides with the reference's TINY
    decoder parameters carried into the port's, both at f32: the greedy
    answers, and so the whole event lists, are equal."""
    from orama_core_tpu.engine.answer import answer_events as ref_answer
    from orama_core_tpu.models import llm as ref_llm
    from orama_core_tpu_torch.models import llm
    from test_torch_llm import one_thread

    ref = _ref_engine(tmp_path, backend="jax", docs=DOCS)
    port = _port_engine(tmp_path, backend="jax", docs=DOCS)
    try:
        r, p = ref.ai._get_llm(), port.ai._get_llm()
        r.cfg = dataclasses.replace(ref_llm.TINY, dtype=jnp.float32)
        r.params = ref_llm.init_params(jax.random.PRNGKey(7), r.cfg)
        p.cfg = dataclasses.replace(llm.TINY, dtype=torch.float32)
        p.params = llm.params_from_numpy(jax.tree.map(np.asarray, r.params),
                                         p.cfg, "cpu")
        want = list(ref_answer(ref.read_side, "c", "tpu kernels?", skip_auth=True))
        with one_thread():
            got = list(answer_events(port.read_side, "c", "tpu kernels?",
                                     skip_auth=True))
        _same(_norm(got), _norm(want))
        # the decoder wrote text (seed 7: its first byte tokens are printable)
        assert [e["message"] for e in got if e["type"] == "optimized-query"] != [""]
        assert "".join(e["message"]["text"] for e in got
                       if e["type"] == "answer_chunk")
    finally:
        ref.close()
        port.close()
