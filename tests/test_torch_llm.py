"""The port's decoder (``orama_core_tpu_torch/models/llm.py``): the eight
cases of tests/test_llm.py on the port, and parity with the JAX package on
carried parameters.

Tolerances: f32 configs, logits within 1e-5 absolute (the same f32
arithmetic summed in another order) and greedy token ids equal; bf16 configs, logits
within 0.01 absolute (the logits here are below 0.6 in magnitude; bf16
keeps 8 bits and the two frameworks round activations at other places,
~2^-8 relative through two layers: 0.0024 measured), and teacher-forced
greedy tokens equal wherever the reference's top-2 margin exceeds twice
that tolerance."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orama_core_tpu.models import llm as ref_llm
from orama_core_tpu_torch.models import llm

BF16_ATOL = 0.01


def _tiny_cfg(dtype=torch.float32, **kw):
    base = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
                mlp=64, max_len=64)
    base.update(kw)
    return llm.LlmConfig(**base, dtype=dtype)


def _ref_cfg(cfg):
    return ref_llm.LlmConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "dtype"},
        dtype=jnp.float32 if cfg.dtype == torch.float32 else jnp.bfloat16)


def _carried(cfg, seed, bias=False):
    """The reference's random parameters (and, with ``bias``, seeded q/k/v
    biases as Qwen2 carries) in both packages."""
    rcfg = _ref_cfg(cfg)
    params = ref_llm.init_params(jax.random.PRNGKey(seed), rcfg)
    tree = jax.tree.map(np.asarray, params)
    if bias:
        rng = np.random.default_rng(seed)
        hd = cfg.head_dim
        for layer in tree["layers"]:
            for name, width in (("bq", cfg.heads), ("bk", cfg.kv_heads),
                                ("bv", cfg.kv_heads)):
                layer[name] = (rng.standard_normal(width * hd) * 0.1).astype(
                    np.float32)
        params = jax.tree.map(jnp.asarray, tree)
    return rcfg, params, llm.params_from_numpy(tree, cfg, "cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


# -- tests/test_llm.py on the port -------------------------------------------


def test_forward_shapes():
    cfg = _tiny_cfg()
    params = llm.init_params(cfg, device="cpu")
    ids = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None, :]
    logits, cache = llm.forward(params, cfg, ids, pos, None, 0)
    assert logits.shape == (1, 4, 64) and logits.dtype == torch.float32
    assert len(cache) == 2


def test_cached_decode_matches_full_forward():
    """Token-by-token decode with the KV cache produces the same greedy
    continuation as rerunning the full sequence each step."""
    cfg = _tiny_cfg()
    params = llm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompt = [1, 5, 9, 2]
    seq = list(prompt)
    for _ in range(6):
        ids = torch.tensor([seq], dtype=torch.int32)
        pos = torch.arange(len(seq), dtype=torch.int32)[None, :]
        logits, _ = llm.forward(params, cfg, ids, pos, None, 0)
        seq.append(int(logits[0, -1].argmax()))
    expected = seq[len(prompt):]
    padded = torch.zeros((1, 8), dtype=torch.int32)
    padded[0, :len(prompt)] = torch.tensor(prompt)
    out = llm.generate(params, cfg, padded, torch.tensor([len(prompt)]),
                       max_new=6, eos_id=63)
    got = out[0].tolist()
    for e, g in zip(expected, got):
        assert e == g, (expected, got)
        if e == 63:
            break


def test_generate_stops_at_eos():
    cfg = _tiny_cfg()
    params = llm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    padded = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32)
    out = llm.generate(params, cfg, padded, torch.tensor([2]), max_new=8,
                       eos_id=0)
    assert out.shape == (1, 8) and out.dtype == torch.int32


def test_byte_tokenizer_roundtrip():
    t = llm.ByteTokenizer()
    ids = t.encode("héllo!")
    assert ids[0] == t.BOS
    assert t.decode(ids[1:]) == "héllo!"
    assert ids == ref_llm.ByteTokenizer().encode("héllo!")


@contextlib.contextmanager
def one_thread():
    """Decode is hundreds of tiny products: under the test runner's
    parallel workers, torch's intra-op threads contend (a chat took two
    minutes at 8 threads a worker, under one second alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_chat_llm_end_to_end():
    chat = llm.ChatLLM(device="cpu")
    with one_thread():
        out = chat.chat("google_query_translator", "what is a TPU?")
        assert isinstance(out, str)
        chunks = list(chat.chat_stream("answer", "hi", context="ctx"))
        assert "".join(chunks) == chat.chat("answer", "hi", context="ctx")


def test_generate_temperature_sampling():
    """temperature > 0 samples from the generator; temperature = 0 is
    greedy and deterministic."""
    cfg = _tiny_cfg(torch.bfloat16, layers=1)
    params = llm.init_params(cfg, device="cpu")
    ids = torch.arange(1, 9, dtype=torch.int32)[None, :]
    plen = torch.tensor([8])

    def gen(**kw):
        return llm.generate(params, cfg, ids, plen, max_new=16, eos_id=63, **kw)

    assert torch.equal(gen(), gen())
    s1 = gen(temperature=1.5, generator=torch.Generator().manual_seed(1))
    s2 = gen(temperature=1.5, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(s1, s2)
    s3 = gen(temperature=1.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(s1, s3)


def test_batched_generate_matches_per_row():
    """Batched generate() with UNEQUAL prompt lengths produces exactly what
    each row produces alone (greedy): the kv cache tracks per-row
    positions."""
    cfg = _tiny_cfg()
    params = llm.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    prompts = [[1, 5, 9, 2, 7, 3], [4, 8]]
    pt, max_new, eos = 8, 6, 63
    solo = []
    for p in prompts:
        padded = torch.zeros((1, pt), dtype=torch.int32)
        padded[0, :len(p)] = torch.tensor(p)
        solo.append(llm.generate(params, cfg, padded, torch.tensor([len(p)]),
                                 max_new=max_new, eos_id=eos)[0].tolist())
    padded = torch.zeros((2, pt), dtype=torch.int32)
    for r, p in enumerate(prompts):
        padded[r, :len(p)] = torch.tensor(p)
    got = llm.generate(params, cfg, padded,
                       torch.tensor([len(p) for p in prompts]),
                       max_new=max_new, eos_id=eos).tolist()
    for r in range(2):
        for e, g in zip(solo[r], got[r]):
            assert e == g, (r, solo[r], got[r])
            if e == eos:
                break


def test_generate_tail_is_eos_not_zeros():
    cfg = _tiny_cfg()
    params = llm.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    padded = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32)
    row = llm.generate(params, cfg, padded, torch.tensor([2]), max_new=8,
                       eos_id=63)[0].tolist()
    if 63 in row:
        first = row.index(63)
        assert all(t == 63 for t in row[first:]), row


# -- parity with the JAX package ---------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_forward_logits_parity_f32(bias):
    cfg = _tiny_cfg()
    rcfg, rp, pp = _carried(cfg, seed=7, bias=bias)
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 64, (2, 11)).astype(np.int32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    want, _ = ref_llm.forward(rp, rcfg, jnp.asarray(ids), jnp.asarray(pos),
                              None, jnp.int32(0))
    got, _ = llm.forward(pp, cfg, _t(ids), _t(pos), None, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_cached_forward_parity_f32():
    """Prefill into the static cache with a right-padded row, then one
    decode step: the logits and the cache's position array equal the
    reference's."""
    cfg = _tiny_cfg()
    rcfg, rp, pp = _carried(cfg, seed=9)
    ids = np.array([[3, 9, 4, 1, 5, 0, 0, 0], [7, 2, 0, 0, 0, 0, 0, 0]],
                   np.int32)
    plen = np.array([5, 2], np.int32)
    ar = np.arange(8, dtype=np.int32)[None, :]
    pos = np.where(ar < plen[:, None], ar, 2**30).astype(np.int32)
    rc = ref_llm.make_cache(rcfg, 2)
    pc = llm.make_cache(cfg, 2, "cpu")
    want, rc = ref_llm.forward(rp, rcfg, jnp.asarray(ids), jnp.asarray(pos),
                               rc, jnp.int32(0))
    got, pc = llm.forward(pp, cfg, _t(ids), _t(pos), pc, 0)
    real = pos < 2**30
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=1e-5, rtol=0)
    tok = np.array([[6], [8]], np.int32)
    step_pos = plen[:, None]
    want, rc = ref_llm.forward(rp, rcfg, jnp.asarray(tok),
                               jnp.asarray(step_pos), rc, jnp.int32(8))
    got, pc = llm.forward(pp, cfg, _t(tok), _t(step_pos), pc, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(pc[1].numpy(), np.asarray(rc[1]))


def test_decode_token_parity_f32():
    """Greedy generate() of both packages on the same f32 parameters and
    padded prompts of unequal lengths gives the same token ids."""
    cfg = _tiny_cfg()
    rcfg, rp, pp = _carried(cfg, seed=11, bias=True)
    ids = np.array([[1, 5, 9, 2, 7, 3, 0, 0], [4, 8, 0, 0, 0, 0, 0, 0],
                    [9, 9, 9, 9, 9, 9, 9, 9]], np.int32)
    plen = np.array([6, 2, 8], np.int32)
    want = ref_llm.generate(rp, rcfg, jnp.asarray(ids), jnp.asarray(plen),
                            max_new=12, eos_id=63)
    got = llm.generate(pp, cfg, _t(ids), _t(plen), max_new=12, eos_id=63)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_teacher_forced_bf16():
    """bf16: the reference's greedy continuation fed through the port's
    forward in one pass; logits within BF16_ATOL and the same argmax
    wherever the reference's top-2 margin exceeds 2 x BF16_ATOL."""
    cfg = _tiny_cfg(torch.bfloat16, vocab_size=128, hidden=64, mlp=128)
    rcfg, rp, pp = _carried(cfg, seed=13, bias=True)
    prompt = np.array([[5, 17, 42, 9, 88, 3, 21, 60]], np.int32)
    cont = np.asarray(ref_llm.generate(
        rp, rcfg, jnp.asarray(prompt), jnp.asarray([8], jnp.int32),
        max_new=16, eos_id=127))
    seq = np.concatenate([prompt, cont], axis=1)[:, :-1]
    pos = np.arange(seq.shape[1], dtype=np.int32)[None, :]
    want, _ = ref_llm.forward(rp, rcfg, jnp.asarray(seq), jnp.asarray(pos),
                              None, jnp.int32(0))
    got, _ = llm.forward(pp, cfg, _t(seq), _t(pos), None, 0)
    want, got = np.asarray(want)[0], got.numpy()[0]
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 2 * BF16_ATOL
    assert sure.sum() >= 4, sure
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    # the reference's own tokens are its argmax at the prompt's last
    # position onwards: the port agrees there too where the margin is clear
    steps = want.argmax(-1)[7:]
    np.testing.assert_array_equal(steps, cont[0, :len(steps)])
