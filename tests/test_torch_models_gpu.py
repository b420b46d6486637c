"""The port's models on the card against their plain CPU runs on the same
parameters, and the semantic ranking on the card. This file imports only
torch, numpy and the port, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_models_gpu.py -q

Every test is marked ``gpu`` and skips without a CUDA card. Tolerances:
f32 within 1e-4 (cuBLAS sums in another order; TF32 off, as
``configure_torch`` sets); bf16 embeddings by cosine >= 0.999 per row and
bf16 logits within 0.02 (bf16 rounding of activations after products
accumulated in another order)."""

import os

import numpy as np
import pytest
import torch

ASSET = os.path.join(os.path.dirname(__file__), "assets", "tiny-semantic")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from orama_core_tpu_torch import configure_torch

    configure_torch()


def _cos(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [6, 12])  # jax-minilm, bge-small widths
def test_encoder_on_card_matches_cpu(layers):
    _need_card()
    import dataclasses

    from orama_core_tpu_torch.models import encoder as enc

    cfg = dataclasses.replace(enc.MINILM, layers=layers)
    cpu = enc.init_params(cfg, torch.Generator().manual_seed(layers), "cpu")
    card = enc.params_from_numpy(cpu, cfg, "cuda")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, (16, 128)).astype(np.int32)
    mask = np.ones((16, 128), np.float32)
    for r in range(16):
        mask[r, 8 * r + 1:] = 0.0
    want = enc.encode(cpu, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    got = enc.encode(card, cfg, torch.from_numpy(ids).cuda(),
                     torch.from_numpy(mask).cuda())
    assert got.device.type == "cuda"
    cos = _cos(got.cpu().numpy(), want.numpy())
    assert (cos >= 0.999).all(), cos
    f32 = dataclasses.replace(cfg, dtype=torch.float32, layers=2)
    cpu = enc.init_params(f32, device="cpu")
    card = enc.params_from_numpy(cpu, f32, "cuda")
    want = enc.encode(cpu, f32, torch.from_numpy(ids), torch.from_numpy(mask))
    got = enc.encode(card, f32, torch.from_numpy(ids).cuda(),
                     torch.from_numpy(mask).cuda())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_decoder_on_card_matches_cpu():
    _need_card()
    from orama_core_tpu_torch.models import llm

    f32 = llm.LlmConfig(vocab_size=512, hidden=256, layers=4, heads=8,
                        kv_heads=2, mlp=1024, max_len=128,
                        dtype=torch.float32)
    cpu = llm.init_params(f32, torch.Generator().manual_seed(3), "cpu")
    card = llm.params_from_numpy(cpu, f32, "cuda")
    ids = torch.tensor([[5, 17, 42, 9, 88, 3, 21, 60],
                        [7, 1, 2, 0, 0, 0, 0, 0]], dtype=torch.int32)
    plen = torch.tensor([8, 3])
    want = llm.generate(cpu, f32, ids, plen, max_new=24, eos_id=257)
    got = llm.generate(card, f32, ids.cuda(), plen, max_new=24, eos_id=257)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)

    bf16 = llm.LlmConfig(**{**f32.__dict__, "dtype": torch.bfloat16})
    cpu = llm.params_from_numpy(cpu, bf16, "cpu")
    card = llm.params_from_numpy(cpu, bf16, "cuda")
    seq = torch.cat([ids[:1], want[:1, :-1]], dim=1)
    pos = torch.arange(seq.shape[1], dtype=torch.int32)[None, :]
    lw, _ = llm.forward(cpu, bf16, seq, pos, None, 0)
    lg, _ = llm.forward(card, bf16, seq.cuda(), pos.cuda(), None, 0)
    torch.testing.assert_close(lg.cpu(), lw, atol=0.02, rtol=0)


@pytest.mark.gpu
def test_semantic_ranking_on_card(tmp_path):
    """tiny-semantic through the port's loader and tokenizer on the card,
    the embedding loop on its own thread (``start_background=True``):
    every cross-vocabulary query ranks its topic first."""
    _need_card()
    import time

    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.models.encoder import EncoderEmbedder
    from orama_core_tpu_torch.types import SearchParams

    passages = {
        "baking": "Combine the flour, sugar and butter, then leave the tin "
        "in a hot oven for forty minutes.",
        "astronomy": "The telescope's mirror gathers faint light from "
        "galaxies billions of parsecs away.",
        "football": "The striker volleyed the cross into the top corner "
        "just before the final whistle.",
        "medicine": "The physician prescribed antibiotics after the blood "
        "test confirmed a bacterial infection.",
    }
    queries = {
        "baking": "how do I make a cake",
        "astronomy": "observing distant stars at night",
        "football": "an exciting soccer goal",
        "medicine": "treatment for an illness caused by germs",
    }
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = str(tmp_path / "w")
    cfg.reader_side.data_dir = str(tmp_path / "r")
    cfg.ai.backend = "jax"
    cfg.ai.embedding_model = "bge-small"
    cfg.writer_side.default_embedding_model = "bge-small"
    cfg.ai.embedding_checkpoint_path = ASSET
    e = build_orama(cfg, start_background=True, device="cuda")
    try:
        emb = e.read_side.ai._embedder("bge-small")
        assert isinstance(emb, EncoderEmbedder) and emb.device.type == "cuda"
        e.write_side.create_collection("master", "sem", "rk", "wk")
        docs = [{"id": t, "body": x} for t, x in passages.items()]
        docs += [{"id": f"noise{i}", "body": f"miscellaneous filler entry {i}"}
                 for i in range(20)]
        for _ in range(200):
            try:
                e.write_side.write("sem", docs, "wk")
                break
            except Exception:
                time.sleep(0.05)
        deadline = time.time() + 60
        while time.time() < deadline:  # until every doc has its vector row
            try:
                vf = next(iter(e.read_side._reader("sem")._vector.values()))
            except (StopIteration, KeyError):
                time.sleep(0.1)
                continue
            rows = {d for d, _ in vf.uncommitted.entries}
            rows |= set(vf.committed.vec_docs.tolist())
            if len(rows) == len(docs):
                break
            time.sleep(0.1)
        for topic, q in queries.items():
            r = e.read_side.search("sem", SearchParams.from_json(
                {"term": q, "mode": "vector", "limit": 3}), "rk")
            assert r.hits[0].id == topic, (q, [h.id for h in r.hits])
    finally:
        e.close()
