"""The port's loader on schema-exact HF checkpoints: the three cases of
tests/test_hf_checkpoint_parity.py on ``orama_core_tpu_torch`` (BGE-small's
BERT schema against ``transformers``' ``BertModel``, Qwen2.5's schema with
q/k/v biases and GQA against ``Qwen2ForCausalLM``, and tied embeddings),
with the reference's tolerances (f32 configs), plus the loaded arrays
held equal to the reference loader's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")


def _bert(tmp_path):
    from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    cfg_hf = BertConfig(
        vocab_size=1031, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=96, hidden_act="gelu", layer_norm_eps=1e-12,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    model = BertModel(cfg_hf).eval()
    ckpt = tmp_path / "bge-small-schema"
    model.save_pretrained(ckpt, safe_serialization=True)
    return model, str(ckpt)


def test_encoder_checkpoint_parity(tmp_path):
    """encode() on loaded weights == transformers BertModel mean-pool."""
    from orama_core_tpu_torch.models import encoder as enc
    from orama_core_tpu_torch.models.hf_loader import load_encoder_checkpoint

    model, ckpt = _bert(tmp_path)
    loaded = load_encoder_checkpoint(ckpt)
    assert loaded is not None, "schema-exact checkpoint must load"
    cfg, params = loaded
    assert cfg.hidden == 64 and cfg.layers == 3 and cfg.heads == 4
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = enc.params_from_numpy(params, cfg, "cpu")

    rng = np.random.default_rng(1)
    ids = rng.integers(1, 1031, (3, 17)).astype(np.int64)
    mask = np.ones((3, 17), np.float32)
    mask[1, 12:] = 0.0
    mask[2, 5:] = 0.0
    with torch.no_grad():
        out = model(input_ids=torch.tensor(ids),
                    attention_mask=torch.tensor(mask, dtype=torch.long)
                    ).last_hidden_state.numpy()
    denom = np.maximum(mask.sum(-1, keepdims=True), 1.0)
    gold = (out * mask[:, :, None]).sum(1) / denom
    gold = gold / np.maximum(np.linalg.norm(gold, axis=-1, keepdims=True), 1e-12)
    got = enc.encode(params, cfg, torch.tensor(ids), torch.tensor(mask)).numpy()
    assert np.allclose(got, gold, atol=2e-4), np.abs(got - gold).max()

    # the reference loader reads the same arrays from the same files
    from orama_core_tpu.models.hf_loader import (
        load_encoder_checkpoint as ref_load)

    _, ref_params = ref_load(ckpt)
    _, port_params = load_encoder_checkpoint(ckpt)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(ref_params)[0],
                            jax.tree_util.tree_leaves(port_params)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def _qwen(tmp_path, name, seed, **kw):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(seed)
    model = Qwen2ForCausalLM(Qwen2Config(**kw)).eval()
    ckpt = tmp_path / name
    model.save_pretrained(ckpt, safe_serialization=True)
    return model, str(ckpt)


def test_llm_checkpoint_parity(tmp_path):
    """forward() logits on loaded weights == transformers Qwen2ForCausalLM
    (q/k/v biases, GQA, rotary, RMSNorm eps from config)."""
    from orama_core_tpu_torch.models import llm
    from orama_core_tpu_torch.models.hf_loader import load_llm_checkpoint

    model, ckpt = _qwen(
        tmp_path, "qwen-schema", 0, vocab_size=523, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, max_position_embeddings=256,
        rope_theta=10_000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        attention_dropout=0.0,
    )
    names = set(model.state_dict().keys())
    assert "model.layers.0.self_attn.q_proj.bias" in names
    loaded = load_llm_checkpoint(ckpt)
    assert loaded is not None
    cfg, params, _tok = loaded
    assert cfg.kv_heads == 2 and cfg.heads == 4
    assert "bq" in params["layers"][0], "Qwen2 attention biases must load"
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = llm.params_from_numpy(params, cfg, "cpu")

    rng = np.random.default_rng(2)
    ids = rng.integers(1, 523, (2, 11)).astype(np.int64)
    with torch.no_grad():
        gold = model(input_ids=torch.tensor(ids)).logits.numpy()
    positions = torch.arange(11, dtype=torch.int32)[None, :].expand(2, 11)
    got, _ = llm.forward(params, cfg, torch.tensor(ids), positions, None, 0)
    got = got.numpy()
    assert got.shape == gold.shape
    assert np.allclose(got, gold, atol=5e-3), np.abs(got - gold).max()
    assert np.array_equal(got.argmax(-1), gold.argmax(-1))

    from orama_core_tpu.models.hf_loader import load_llm_checkpoint as ref_load

    rcfg, ref_params, _ = ref_load(ckpt)
    _, port_params, _ = load_llm_checkpoint(ckpt)
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(ref_params)[0],
                            jax.tree_util.tree_leaves(port_params)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_llm_checkpoint_parity_tied_embeddings(tmp_path):
    """Qwen2.5-class checkpoints tie lm_head to embed_tokens: the loader
    falls back to the transposed embedding matrix."""
    from orama_core_tpu_torch.models import llm
    from orama_core_tpu_torch.models.hf_loader import load_llm_checkpoint

    model, ckpt = _qwen(
        tmp_path, "qwen-tied", 3, vocab_size=300, hidden_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        intermediate_size=64, max_position_embeddings=128,
        tie_word_embeddings=True,
    )
    loaded = load_llm_checkpoint(ckpt)
    assert loaded is not None
    cfg, params, _ = loaded
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = llm.params_from_numpy(params, cfg, "cpu")
    ids = torch.arange(1, 8)[None, :]
    with torch.no_grad():
        gold = model(input_ids=ids).logits.numpy()
    pos = torch.arange(7, dtype=torch.int32)[None, :]
    got, _ = llm.forward(params, cfg, ids, pos, None, 0)
    assert np.allclose(got.numpy(), gold, atol=5e-3)
