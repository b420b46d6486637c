"""Parameter checkpoints of the port (``models/checkpoint.py``,
``torch.save`` / ``torch.load(weights_only=True)``): the round trip of
tests/test_model_checkpoint.py on the port's encoder, and the decoder's,
with ``like=`` restoring each tensor's dtype."""

import pytest
import torch

from orama_core_tpu_torch.models import checkpoint as ckpt
from orama_core_tpu_torch.models import encoder as enc
from orama_core_tpu_torch.models import llm


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_encoder_params_roundtrip(tmp_path):
    cfg = enc.EncoderConfig(vocab_size=64, hidden=32, layers=1, heads=4,
                            mlp=64, max_len=16, out_dim=32,
                            dtype=torch.float32)
    params = enc.init_params(cfg, device="cpu")
    path = str(tmp_path / "ckpt" / "encoder.pt")
    ckpt.save_params(path, params)
    like = enc.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    restored = ckpt.load_params(path, like=like)
    for a, b in zip(_leaves(params), _leaves(restored)):
        assert torch.equal(a, b)
    ids = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 1.0, 1.0, 0.0]])
    torch.testing.assert_close(enc.encode(params, cfg, ids, mask),
                               enc.encode(restored, cfg, ids, mask),
                               rtol=1e-6, atol=0)


def test_llm_params_roundtrip_restores_dtypes(tmp_path):
    """bf16 weights and the f32 lm_head come back with their dtypes; with
    a ``like`` of another dtype the tensors are cast to it; a shape that
    does not match raises."""
    cfg = llm.LlmConfig(vocab_size=64, hidden=32, layers=2, heads=4,
                        kv_heads=2, mlp=64, max_len=32)
    params = llm.init_params(cfg, device="cpu")
    path = str(tmp_path / "llm.pt")
    ckpt.save_params(path, params)
    stored = ckpt.load_params(path)
    assert stored["layers"][0]["wq"].dtype == torch.bfloat16
    assert stored["lm_head"].dtype == torch.float32
    for a, b in zip(_leaves(params), _leaves(stored)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    f32 = llm.LlmConfig(**{**cfg.__dict__, "dtype": torch.float32})
    cast = ckpt.load_params(path, like=llm.init_params(f32, device="cpu"))
    assert cast["layers"][1]["w_up"].dtype == torch.float32
    assert torch.equal(cast["layers"][1]["w_up"],
                       params["layers"][1]["w_up"].float())
    wide = llm.LlmConfig(**{**cfg.__dict__, "mlp": 128})
    with pytest.raises(ValueError):
        ckpt.load_params(path, like=llm.init_params(wide, device="cpu"))
