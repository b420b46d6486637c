"""Semantic end to end on the port: tests/test_semantic_e2e.py's four
cases on ``orama_core_tpu_torch`` (``device="cpu"``), with the in-repo
trained checkpoint (``tests/assets/tiny-semantic``) loaded by the port's
own safetensors reader and WordPiece tokenizer, and the hits held equal
to the reference engine's on the same checkpoint.

Hits compare equal (ids and order, scores within rtol 1e-4) with the
encoder at f32 on both sides; at the default bf16 each cross-vocabulary
query ranks its target first in both, as the reference test asserts (the
port's bf16 rows differ from the reference's by one more rounding of each
dense output, tests/test_torch_encoder.py)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from orama_core_tpu_torch.types import SearchParams
from test_semantic_e2e import PASSAGES, QUERIES

ASSET = os.path.join(os.path.dirname(__file__), "assets", "tiny-semantic")
MASTER, READ, WRITE = "master", "rk", "wk"


def _configure(cfg, tmp_path, tag, ckpt=ASSET):
    cfg.writer_side.data_dir = str(tmp_path / f"{tag}-w")
    cfg.reader_side.data_dir = str(tmp_path / f"{tag}-r")
    cfg.ai.backend = "jax"
    cfg.ai.embedding_model = "bge-small"
    cfg.writer_side.default_embedding_model = "bge-small"
    cfg.ai.embedding_checkpoint_path = str(ckpt)
    return cfg


def _port(tmp_path, tag="port", ckpt=ASSET):
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig

    return build_orama(_configure(OramaxConfig(), tmp_path, tag, ckpt),
                       start_background=False, device="cpu")


def _ref(tmp_path, tag="ref"):
    from orama_core_tpu import build_orama
    from orama_core_tpu.config import OramaxConfig

    cfg = _configure(OramaxConfig(), tmp_path, tag)
    cfg.tpu._test_force_fast_path = True
    return build_orama(cfg, start_background=False)


@pytest.fixture()
def engine(tmp_path):
    e = _port(tmp_path)
    try:
        yield e
    finally:
        e.close()


def _ranking_docs():
    docs = [{"id": t, "body": text} for t, text in PASSAGES.items()]
    docs += [{"id": f"noise{i}", "body": f"miscellaneous filler entry {i}"}
             for i in range(20)]
    return docs


def _ingest(e, cid, docs):
    e.write_side.create_collection(MASTER, cid, READ, WRITE)
    e.flush()
    e.write_side.write(cid, docs, WRITE)
    e.flush()
    e.commit()


def test_real_weights_loaded_not_fallback(engine):
    from orama_core_tpu_torch.models.encoder import EncoderEmbedder
    from orama_core_tpu_torch.models.lexical import LexicalEmbedder

    emb = engine.read_side.ai._embedder("bge-small")
    assert not isinstance(emb, LexicalEmbedder)
    assert isinstance(emb, EncoderEmbedder)
    assert emb.cfg.hidden == 96 and emb.cfg.layers == 2
    assert emb.device.type == "cpu"


def test_semantic_ranking_end_to_end(engine):
    e = engine
    _ingest(e, "sem", _ranking_docs())
    for topic, q in QUERIES.items():
        r = e.read_side.search(
            "sem",
            SearchParams.from_json({"term": q, "mode": "vector", "limit": 3}),
            READ,
        )
        assert r.hits, q
        assert r.hits[0].id == topic, (
            q, [(h.id, round(h.score, 3)) for h in r.hits])


def test_semantic_hybrid_beats_mismatched_lexical(engine):
    e = engine
    _ingest(e, "hyb", [
        {"id": "right", "body": PASSAGES["baking"]},
        {"id": "decoy", "body": "make cake make cake make a cake word"},
    ] + [{"id": f"n{i}", "body": f"unrelated filler {i}"} for i in range(10)])
    r = e.read_side.search(
        "hyb",
        SearchParams.from_json(
            {"term": "how do I make a cake", "mode": "hybrid", "limit": 3}),
        READ,
    )
    assert {h.id for h in r.hits[:2]} >= {"right"}, [
        (h.id, round(h.score, 3)) for h in r.hits]


def test_checkpoint_path_mechanics(tmp_path):
    """A schema-exact random-weight checkpoint made locally flows through
    the same wiring: the engine builds, the transformer (not the lexical
    tier) embeds, vector search runs."""
    transformers = pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, BertTokenizerFast

    from orama_core_tpu_torch.models.lexical import LexicalEmbedder

    torch.manual_seed(0)
    ckpt = tmp_path / "bge-small"
    BertModel(BertConfig(
        vocab_size=200, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=96, hidden_act="gelu", layer_norm_eps=1e-12,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )).eval().save_pretrained(ckpt, safe_serialization=True)
    vocab = ckpt / "vocab.txt"
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"tok{i}" for i in range(190)] + ["cake", "flour", "oven", "star", "goal"]
    vocab.write_text("\n".join(toks[:200]))
    BertTokenizerFast(vocab_file=str(vocab)).save_pretrained(ckpt)
    e = _port(tmp_path, "mech", ckpt)
    try:
        assert not isinstance(e.read_side.ai._embedder("bge-small"),
                              LexicalEmbedder)
        e.write_side.create_collection(MASTER, "m", READ, WRITE)
        e.flush()
        e.write_side.write("m", [{"id": "a", "body": "cake flour oven"},
                                 {"id": "b", "body": "star goal"}], WRITE)
        e.flush()
        e.commit()
        r = e.read_side.search("m", SearchParams.from_json(
            {"term": "cake", "mode": "vector", "limit": 2}), READ)
        assert len(r.hits) >= 1
    finally:
        e.close()


def _f32_embedders(ref, port):
    """Both engines' ``bge-small`` embedders rebuilt at f32 on the same
    checkpoint (the loaders read equal arrays)."""
    import jax.numpy as jnp

    from orama_core_tpu.models import encoder as ref_enc
    from orama_core_tpu.models.hf_loader import (
        load_encoder_checkpoint as ref_load, load_encoder_tokenizer as ref_tok)
    from orama_core_tpu_torch.models import encoder as enc
    from orama_core_tpu_torch.models.hf_loader import (
        load_encoder_checkpoint, load_encoder_tokenizer)

    rcfg, rparams = ref_load(ASSET)
    rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
    ref.ai._embedders["bge-small"] = ref_enc.JaxEncoderEmbedder(
        "bge-small", cfg=rcfg, params=rparams,
        tokenizer=ref_tok(ASSET, rcfg.max_len))
    cfg, params = load_encoder_checkpoint(ASSET)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    port.ai._embedders["bge-small"] = enc.EncoderEmbedder(
        "bge-small", cfg=cfg, params=params,
        tokenizer=load_encoder_tokenizer(ASSET, cfg.max_len), device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hits_equal_reference(tmp_path, dtype):
    """The reference engine and the port on the same checkpoint, documents
    and queries: vector and hybrid hits equal at f32; at bf16 every query's
    first hit is its topic in both."""
    from orama_core_tpu.types import SearchParams as RefParams

    ref, port = _ref(tmp_path), _port(tmp_path)
    try:
        if dtype == "f32":
            _f32_embedders(ref, port)
        for e in (ref, port):
            _ingest(e, "sem", _ranking_docs())
        for topic, q in QUERIES.items():
            for mode in ("vector", "hybrid"):
                body = {"term": q, "mode": mode, "limit": 5}
                r = ref.read_side.search("sem", RefParams.from_json(body), READ)
                p = port.read_side.search("sem", SearchParams.from_json(body),
                                          READ)
                if dtype == "f32":
                    assert [h.id for h in p.hits] == [h.id for h in r.hits], body
                    assert p.count == r.count, body
                    np.testing.assert_allclose(
                        [h.score for h in p.hits], [h.score for h in r.hits],
                        rtol=1e-4, err_msg=str(body))
                elif mode == "vector":
                    assert p.hits[0].id == r.hits[0].id == topic, body
    finally:
        ref.close()
        port.close()
