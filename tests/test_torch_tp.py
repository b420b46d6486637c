"""The port's tensor-parallel encoder and decoder against the JAX
package's, on the CPU.

The reference runs its models under ``param_specs`` (Megatron layout)
with GSPMD: tests/test_parallel.py::test_encoder_tp_matches_single_device
(mesh (4, 2), f32, atol 2e-5) and
tests/test_final_coverage.py::test_llm_tp_matches_single_device (mesh
(1, 8), 8 heads over 4 KV heads, f32, atol 2e-4). These mirror them: the
same configs, meshes and tolerances, the reference's parameters carried
into the port (``params_from_numpy``) and placed by the port's
``shard_params``, and the port's sharded forward held against the
reference's sharded forward (on conftest's 8 virtual CPU devices) and its
single-device one. Beyond them: q/k/v biases, the cached forward and
greedy ``generate`` under the layout, a mesh that gives each shard half
a KV head, the stacked layout against one tensor per shard, the specs
leaf for leaf, and the refusal of a split that does not divide.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from orama_core_tpu.models import encoder as ref_enc
from orama_core_tpu.models import llm as ref_llm
from orama_core_tpu.parallel.mesh import make_mesh as ref_mesh
from orama_core_tpu_torch.models import encoder as enc
from orama_core_tpu_torch.models import llm
from orama_core_tpu_torch.parallel.mesh import P, make_mesh, shard_params


def _need8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _ref_place(shape, params, specs):
    mesh = ref_mesh(shape, ("data", "model"),
                    devices=jax.devices()[:int(np.prod(shape))])
    return mesh, jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs)


def _same_specs(port, ref):
    """The port's spec tree equals the reference's, leaf for leaf."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref)
        for k in ref:
            _same_specs(port[k], ref[k])
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref)
        for a, b in zip(port, ref):
            _same_specs(a, b)
    else:
        assert isinstance(port, P) and tuple(port) == tuple(ref), (port, ref)


# -- encoder ------------------------------------------------------------------

ENC = dict(vocab_size=128, hidden=64, layers=2, heads=4, mlp=128, max_len=16,
           out_dim=64)


def _enc_case():
    """tests/test_parallel.py:89's config, parameters and batch."""
    rcfg = ref_enc.EncoderConfig(**ENC, dtype=jnp.float32)
    cfg = enc.EncoderConfig(**ENC, dtype=torch.float32)
    params = ref_enc.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 128, (8, 16)).astype(np.int32)
    mask = np.ones((8, 16), np.float32)
    return rcfg, cfg, params, ids, mask


def test_encoder_param_specs_match_reference():
    for kw in ({}, {"out_dim": 32}):
        rcfg = ref_enc.EncoderConfig(**dict(ENC, **kw))
        cfg = enc.EncoderConfig(**dict(ENC, **kw))
        _same_specs(enc.param_specs(cfg), ref_enc.param_specs(rcfg))


@pytest.mark.parametrize("shape", [(4, 2), (1, 8), (2, 4)])
def test_encoder_tp_matches_reference_tp_and_single_device(shape):
    """At (4, 2), the reference's test exactly (atol 2e-5); (1, 8) splits
    each of the 4 heads in two (every shard gathers its head), (2, 4)
    gives a shard one head."""
    _need8()
    rcfg, cfg, params, ids, mask = _enc_case()
    single = np.asarray(ref_enc.encode(params, rcfg, jnp.asarray(ids),
                                       jnp.asarray(mask)))
    mesh, sp = _ref_place(shape, params, ref_enc.param_specs(rcfg))
    ids_s = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, JP("data", None)))
    mask_s = jax.device_put(jnp.asarray(mask), NamedSharding(mesh, JP("data", None)))
    ref_tp = np.asarray(jax.jit(lambda p, i, m: ref_enc.encode(p, rcfg, i, m))(
        sp, ids_s, mask_s))
    port = enc.params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    placed = shard_params(make_mesh(shape, device="cpu"), port,
                          enc.param_specs(cfg))
    got = enc.encode(placed, cfg, torch.from_numpy(ids),
                     torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref_tp, atol=2e-5)
    np.testing.assert_allclose(got, single, atol=2e-5)


def test_encoder_tp_padded_rows_and_projection():
    """Padded tokens (a ragged mask), non-zero biases of every layer and
    a projected output (``proj``, replicated) on a (2, 2) mesh, against
    the reference's single-device forward (atol 2e-5)."""
    rcfg = ref_enc.EncoderConfig(**dict(ENC, out_dim=32), dtype=jnp.float32)
    cfg = enc.EncoderConfig(**dict(ENC, out_dim=32), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, ref_enc.init_params(
        jax.random.PRNGKey(1), rcfg))
    rng = np.random.default_rng(5)
    for layer in tree["layers"]:
        for name in ("q", "k", "v", "o", "up", "down"):
            layer[name]["b"] = (rng.standard_normal(layer[name]["b"].shape)
                                * 0.1).astype(np.float32)
    ids = rng.integers(1, 128, (8, 16)).astype(np.int32)
    mask = np.ones((8, 16), np.float32)
    for r in range(8):
        mask[r, 2 * r + 2:] = 0.0
    want = np.asarray(ref_enc.encode(jax.tree.map(jnp.asarray, tree), rcfg,
                                     jnp.asarray(ids), jnp.asarray(mask)))
    placed = shard_params(make_mesh((2, 2), device="cpu"),
                          enc.params_from_numpy(tree, cfg, "cpu"),
                          enc.param_specs(cfg))
    got = enc.encode(placed, cfg, torch.from_numpy(ids),
                     torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


# -- decoder ------------------------------------------------------------------

LLM = dict(vocab_size=64, hidden=64, layers=2, heads=8, kv_heads=4, mlp=128,
           max_len=32)


def _llm_case(bias=False, seed=0, **kw):
    """tests/test_final_coverage.py:10's config and parameters (``kw``
    changes the config), with seeded q/k/v biases when ``bias``."""
    conf = dict(LLM, **kw)
    rcfg = ref_llm.LlmConfig(**conf, dtype=jnp.float32)
    cfg = llm.LlmConfig(**conf, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, ref_llm.init_params(
        jax.random.PRNGKey(seed), rcfg))
    if bias:
        rng = np.random.default_rng(seed)
        for layer in tree["layers"]:
            for name, width in (("bq", cfg.heads), ("bk", cfg.kv_heads),
                                ("bv", cfg.kv_heads)):
                layer[name] = (rng.standard_normal(width * cfg.head_dim)
                               * 0.1).astype(np.float32)
    return rcfg, cfg, tree


def test_decoder_param_specs_match_reference():
    for with_bias in (False, True):
        _same_specs(llm.param_specs(llm.LlmConfig(**LLM), with_bias),
                    ref_llm.param_specs(ref_llm.LlmConfig(**LLM), with_bias))


@pytest.mark.parametrize("case", [
    "reference", "bias", "half_kv_head", "half_kv_head_bias", "q_in_halves"])
def test_decoder_tp_matches_reference_tp_and_single_device(case):
    """The reference's test exactly ("reference": mesh (1, 8), 8 heads
    over 4 KV heads, so each shard holds half a KV head's k/v columns;
    atol 2e-4), with biases split by column, mesh (1, 4) over 2 KV heads
    (half a KV head a shard, the other half gathered before rotary), and
    mesh (1, 8) over 4 heads (half a q head a shard)."""
    _need8()
    shape, kw, bias = {
        "reference": ((1, 8), {}, False),
        "bias": ((1, 8), {}, True),
        "half_kv_head": ((1, 4), {"kv_heads": 2}, False),
        "half_kv_head_bias": ((1, 4), {"kv_heads": 2}, True),
        "q_in_halves": ((1, 8), {"heads": 4, "kv_heads": 2}, False),
    }[case]
    rcfg, cfg, tree = _llm_case(bias, **kw)
    params = jax.tree.map(jnp.asarray, tree)
    ids = np.asarray([[1, 5, 9, 2]], np.int32)
    pos = np.arange(4, dtype=np.int32)[None, :]
    single, _ = ref_llm.forward(params, rcfg, jnp.asarray(ids),
                                jnp.asarray(pos), None, jnp.int32(0))
    _mesh, sp = _ref_place(shape, params, ref_llm.param_specs(rcfg, bias))
    ref_tp, _ = jax.jit(lambda p: ref_llm.forward(
        p, rcfg, jnp.asarray(ids), jnp.asarray(pos), None, jnp.int32(0)))(sp)
    placed = shard_params(make_mesh(shape, device="cpu"),
                          llm.params_from_numpy(tree, cfg, "cpu"),
                          llm.param_specs(cfg, bias))
    got, kv = llm.forward(placed, cfg, torch.from_numpy(ids),
                          torch.from_numpy(pos), None, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_tp), atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(single), atol=2e-4)
    assert len(kv) == cfg.layers


@pytest.mark.parametrize("shape", [(1, 8), (1, 4), (2, 2)])
def test_decoder_tp_cached_forward_and_generate(shape):
    """Under the layout (biases on, 2 KV heads): a prefill and two
    one-token steps through the sharded cache equal the reference's cached
    single-device forward (atol 2e-4), and greedy ``generate`` (f32) of two
    prompts of different lengths equals the reference's tokens. (2, 2)
    replicates the prompt over ``data``, as the reference does."""
    rcfg, cfg, tree = _llm_case(True, seed=4, kv_heads=2)
    params = jax.tree.map(jnp.asarray, tree)
    placed = shard_params(make_mesh(shape, device="cpu"),
                          llm.params_from_numpy(tree, cfg, "cpu"),
                          llm.param_specs(cfg, True))
    ids = np.asarray([[1, 5, 9, 2, 7, 3], [3, 4, 7, 0, 0, 0]], np.int32)
    pos = np.asarray([[0, 1, 2, 3, 4, 5], [0, 1, 2, 2**30, 2**30, 2**30]],
                     np.int32)
    rc = ref_llm.make_cache(rcfg, 2)
    pc = llm.make_cache(cfg, 2, "cpu", params=placed)
    want, rc = ref_llm.forward(params, rcfg, jnp.asarray(ids),
                               jnp.asarray(pos), rc, jnp.int32(0))
    got, pc = llm.forward(placed, cfg, torch.from_numpy(ids),
                          torch.from_numpy(pos), pc, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    for step, tok in enumerate(([[11], [12]], [[13], [14]])):
        p1 = np.asarray([[6 + step], [3 + step]], np.int32)
        want, rc = ref_llm.forward(params, rcfg, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(p1), rc, jnp.int32(6 + step))
        got, pc = llm.forward(placed, cfg, torch.tensor(tok),
                              torch.from_numpy(p1), pc, 6 + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    plen = np.asarray([6, 3], np.int32)
    want = np.asarray(ref_llm.generate(params, rcfg, jnp.asarray(ids),
                                       jnp.asarray(plen), 12, 63))
    got = llm.generate(placed, cfg, torch.from_numpy(ids),
                       torch.from_numpy(plen), 12, eos_id=63)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decoder_shard_cache_holds_its_kv_heads():
    """Each shard's cache holds the KV heads its attention reads: at
    (1, 4) over 2 KV heads one whole head each (the shards of a head
    share it), at (1, 2) its own head."""
    _, cfg, tree = _llm_case(kv_heads=2)
    params = llm.params_from_numpy(tree, cfg, "cpu")
    for m, stack in ((4, True), (4, False), (2, True)):
        placed = shard_params(make_mesh((1, m), device="cpu"), params,
                              llm.param_specs(cfg), stack=stack)
        kv, pos = llm.make_cache(cfg, 3, "cpu", params=placed)
        shards = sum(ck.shape[0] for ck, _ in kv[0])
        assert shards == m
        assert all(ck.shape[1:] == (3, cfg.max_len, 1, cfg.head_dim)
                   for ck, _ in kv[0])
        assert len(pos) == len(kv[0])


# -- layouts and specs ----------------------------------------------------------


@pytest.mark.parametrize("model", ["encoder", "decoder"])
def test_stacked_and_per_shard_layouts_agree(model):
    """Shards on one device stacked ``[m, ...]`` (one local body over the
    stack) against one tensor and one local body per (data, model)
    position: equal within 1e-6 (the same products, batched or not)."""
    if model == "encoder":
        _, cfg, params, ids, mask = _enc_case()
        port = enc.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     "cpu")
        outs = []
        for stack in (True, False):
            placed = shard_params(make_mesh((2, 4), device="cpu"), port,
                                  enc.param_specs(cfg), stack=stack)
            layout = placed["tok_emb"].layout
            # per shard: a unit each of the row's 4 shards, each data row
            # its own run (the rows share the CPU's copies of the shards)
            assert len(layout.units) == (1 if stack else 4)
            assert len(layout.runs(8)) == (1 if stack else 2)
            outs.append(enc.encode(placed, cfg, torch.from_numpy(ids),
                                   torch.from_numpy(mask)).numpy())
    else:
        _, cfg, tree = _llm_case(True, kv_heads=2)
        port = llm.params_from_numpy(tree, cfg, "cpu")
        ids = torch.tensor([[1, 5, 9, 2, 7]])
        outs = []
        for stack in (True, False):
            placed = shard_params(make_mesh((1, 4), device="cpu"), port,
                                  llm.param_specs(cfg, True), stack=stack)
            outs.append(llm.generate(placed, cfg, ids, torch.tensor([5]), 8,
                                     eos_id=63).numpy())
            logits, _ = llm.forward(placed, cfg, ids, torch.arange(5)[None],
                                    None, 0)
            outs.append(logits.numpy())
        np.testing.assert_array_equal(outs[0], outs[2])
        outs = outs[1::2]
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-6)


def test_shard_params_places_by_spec():
    """A split leaf's shards are its column (row) blocks in order; a
    replicated leaf is the tensor itself; a stacked unit holds them as
    one ``[M, ...]`` tensor."""
    w = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    tree = {"col": w, "row": w, "rep": w, "vec": torch.arange(8.0)}
    specs = {"col": P(None, "model"), "row": P("model", None), "rep": P(),
             "vec": P("model")}
    placed = shard_params(make_mesh((1, 4), device="cpu"), tree, specs)
    assert placed["col"].parts[0].shape == (4, 4, 2)
    for m in range(4):
        assert torch.equal(placed["col"].parts[0][m], w[:, 2 * m:2 * m + 2])
        assert torch.equal(placed["row"].parts[0][m], w[m:m + 1])
        assert torch.equal(placed["vec"].parts[0][m], tree["vec"][2 * m:2 * m + 2])
    assert torch.equal(placed["rep"].parts[0], w)
    per = shard_params(make_mesh((2, 2), device="cpu"), tree, specs,
                       stack=False)
    assert [u.key()[1:] for u in per["col"].layout.units] == [
        (0, 1), (1, 2)]  # data rows share the CPU's copies
    assert per["col"].layout.rows == [[0, 1], [0, 1]]


def test_shard_params_refuses_an_indivisible_split():
    """A split dimension that does not divide by the ``model`` axis's
    size raises ValueError, where JAX refuses the placement too; so do a
    spec over ``data`` and a batch that does not split over ``data``."""
    _need8()
    with pytest.raises(ValueError):  # JAX: 12 columns over 8 shards
        mesh = ref_mesh((1, 8), ("data", "model"))
        jax.device_put(jnp.zeros((48, 12)),
                       NamedSharding(mesh, JP(None, "model")))
    _, cfg, tree = _llm_case(heads=6, kv_heads=2, hidden=48)  # hd 8
    with pytest.raises(ValueError, match="does not divide"):
        # wk's 16 columns over 32 shards
        shard_params(make_mesh((1, 32), device="cpu"),
                     llm.params_from_numpy(tree, cfg, "cpu"),
                     llm.param_specs(cfg))
    _, ecfg, params, _ids, _mask = _enc_case()
    port = enc.params_from_numpy(jax.tree.map(np.asarray, params), ecfg, "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        shard_params(make_mesh((1, 5), device="cpu"), port,
                     enc.param_specs(ecfg))
    with pytest.raises(ValueError):
        shard_params(make_mesh((1, 2), device="cpu"), {"w": torch.zeros(4)},
                     {"w": P("data")})
    placed = shard_params(make_mesh((2, 2), device="cpu"), port,
                          enc.param_specs(ecfg))
    with pytest.raises(ValueError, match="does not split"):
        enc.encode(placed, ecfg, torch.ones(3, 16, dtype=torch.long),
                   torch.ones(3, 16))


def test_tp_bf16_close_to_single_device():
    """bf16 (the models' working type) at (1, 4) over 2 KV heads and at
    (2, 2) for the encoder: the row split rounds each shard's partial
    product to bf16 before the f32 sum, so outputs move by bf16 noise:
    encoder rows within cosine 0.999 of the single device's, decoder
    logits within 0.02 (the card-only tests' bf16 bound)."""
    _, cfg32, params, ids, mask = _enc_case()
    cfg = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    port = enc.params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    want = enc.encode(port, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    got = enc.encode(shard_params(make_mesh((2, 2), device="cpu"), port,
                                  enc.param_specs(cfg)), cfg,
                     torch.from_numpy(ids), torch.from_numpy(mask))
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert float(cos.min()) >= 0.999
    _, c32, tree = _llm_case(True, kv_heads=2)
    cfg = dataclasses.replace(c32, dtype=torch.bfloat16)
    port = llm.params_from_numpy(tree, cfg, "cpu")
    ids = torch.tensor([[1, 5, 9, 2, 7, 3]])
    pos = torch.arange(6, dtype=torch.int32)[None]
    want, _ = llm.forward(port, cfg, ids, pos, None, 0)
    got, _ = llm.forward(shard_params(make_mesh((1, 4), device="cpu"), port,
                                      llm.param_specs(cfg, True)),
                         cfg, ids, pos, None, 0)
    assert float((got - want).abs().max()) <= 0.02
