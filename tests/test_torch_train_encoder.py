"""Encoder training on the port (``models/train_encoder.py``, the
``tools/train_tiny_encoder`` command line, the checkpoint writer) against
the reference: ``scripts/train_tiny_encoder.py``'s data, its loss under
``jax.value_and_grad`` and its ``optax.adam(2e-3)`` steps through the
reference's ``encode``, on the same seeded numpy inputs, at f32.

Tolerances: the loss within relative 1e-5; each gradient leaf within
1e-4 of that leaf's largest magnitude, except the key biases, whose
gradient is zero in exact arithmetic (softmax ignores a shift common to a
row of logits) and is held in both packages below 1e-6 of the largest
gradient anywhere; after three Adam steps the losses within relative
1e-5 and the parameters, in units of lr, 99.9% within 2e-3 lr of the
reference's, 99.99% and all of them within 0.05 lr (three steps move a
parameter by up to 3 lr). Adam turns rounding noise in a gradient below
its eps, 1e-8, into an update of up to lr, so where the gradients are
mostly noise, as after jax-minilm's collapse, only the quantiles are
bounded."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orama_core_tpu.models import encoder as jenc
from orama_core_tpu_torch.models import encoder as enc
from orama_core_tpu_torch.models import train_encoder as te
from orama_core_tpu_torch.models.hf_loader import (
    WordPieceTokenizer,
    export_bert_checkpoint,
    load_encoder_checkpoint,
    load_encoder_tokenizer,
    read_safetensors,
    write_safetensors,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "tests", "assets", "tiny-semantic")
LAYOUTS = [(32, 4), (48, 12)]  # (hidden, heads): head dims 8 and 4


def _script():
    """scripts/train_tiny_encoder.py as a module (it imports JAX only
    inside main())."""
    spec = importlib.util.spec_from_file_location(
        "train_tiny_encoder_script",
        os.path.join(ROOT, "scripts", "train_tiny_encoder.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _configs(hidden, heads):
    n = len(te.build_vocab())
    cfg = te.train_config(n, hidden=hidden, layers=2, heads=heads)
    jcfg = jenc.EncoderConfig(
        vocab_size=n, hidden=hidden, layers=2, heads=heads, mlp=4 * hidden,
        max_len=64, out_dim=hidden, dtype=jnp.float32)
    return cfg, jcfg


def _loss_fn(jcfg):
    """The script's loss_fn (train_tiny_encoder.py:250-261)."""
    def loss_fn(p, ids_a, mask_a, ids_b, mask_b):
        za = jenc.encode(p, jcfg, ids_a, mask_a)
        zb = jenc.encode(p, jcfg, ids_b, mask_b)
        logits = za @ zb.T / 0.05
        labels = jnp.arange(za.shape[0])
        l = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        l += optax.softmax_cross_entropy_with_integer_labels(
            logits.T, labels).mean()
        return 0.5 * l
    return loss_fn


def _named_leaves(tree):
    return [(name, np.asarray(x)) for name, x in te.named_leaves(tree)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gen_pairs_matches_script(seed):
    script = _script()
    assert te.TOPICS == script.TOPICS and te.FILLER == script.FILLER
    assert te.QUERY_PREFIX == script.QUERY_PREFIX
    assert te.OOV_JUNK == script.OOV_JUNK
    words = {t: s.split() for t, s in script.TOPICS.items()}
    a, b, t = script.gen_pairs(np.random.default_rng(seed), words, 64)
    a2, b2, t2 = te.gen_pairs(np.random.default_rng(seed), te.TOPIC_WORDS, 64)
    assert a == a2 and b == b2
    np.testing.assert_array_equal(t, t2)


def test_vocab_is_the_scripts_and_the_assets():
    script = _script()
    words = {w for s in script.TOPICS.values() for w in s.split()}
    want = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(
        words | set(script.FILLER))
    assert te.build_vocab() == want
    with open(os.path.join(ASSET, "vocab.txt"), encoding="utf-8") as f:
        assert [line.rstrip("\n") for line in f] == want


@pytest.mark.parametrize("hidden,heads", LAYOUTS)
def test_loss_and_gradients_match_value_and_grad(hidden, heads):
    cfg, jcfg = _configs(hidden, heads)
    jp = jenc.init_params(jax.random.PRNGKey(hidden), jcfg)
    batch = te.sample_batch(np.random.default_rng(5),
                            te.TrainTokenizer(te.build_vocab()), 8, "cpu")
    assert all(float(m.sum(-1).min()) >= 3 for m in batch[1::2])
    jl, jg = jax.jit(jax.value_and_grad(_loss_fn(jcfg)))(
        jp, *(jnp.asarray(x.numpy()) for x in batch))
    loss, got = te.loss_and_grads(jax.tree.map(np.asarray, jp), cfg,
                                  [x.numpy() for x in batch], "cpu")
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    want = _named_leaves(jax.tree.map(np.asarray, jg))
    assert [(n, w.shape) for n, w in want] == [(n, g.shape) for n, g in got]
    err = te.gradient_error(got, want)
    assert err["leaf"] <= 1e-4 and err["key_bias"] <= 1e-6, err


@pytest.mark.parametrize("hidden,heads", LAYOUTS)
def test_three_adam_steps_match_optax(hidden, heads):
    cfg, jcfg = _configs(hidden, heads)
    jp = jenc.init_params(jax.random.PRNGKey(hidden + 1), jcfg)
    start = jax.tree.map(np.asarray, jp)
    opt = optax.adam(2e-3)

    @jax.jit
    def step(p, s, *batch):  # the script's step (train_tiny_encoder.py:246)
        loss, grads = jax.value_and_grad(_loss_fn(jcfg))(p, *batch)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    rng = np.random.default_rng(3)
    tok = te.TrainTokenizer(te.build_vocab())
    p, s, want_losses = jp, opt.init(jp), []
    for _ in range(3):
        batch = te.sample_batch(rng, tok, 8, "cpu")
        p, s, loss = step(p, s, *(jnp.asarray(x.numpy()) for x in batch))
        want_losses.append(float(loss))
    params, losses = te.train(cfg, 3, 8, seed=3, device="cpu", params=start)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = [w for _, w in _named_leaves(jax.tree.map(np.asarray, p))]
    diff = np.concatenate([np.abs(g.detach().numpy() - w).ravel()
                           for g, w in zip(te.leaves(params), want)]) / te.LR
    q999, q9999 = np.quantile(diff, [0.999, 0.9999])
    assert q999 <= 2e-3 and q9999 <= 0.05, (q999, q9999, diff.max())
    assert diff.max() <= 0.05, diff.max()
    moved = np.concatenate([np.abs(w - s0).ravel() for w, s0 in zip(
        want, (w for _, w in _named_leaves(start)))]) / te.LR
    assert moved.max() > 1.0  # the steps did move the parameters


def test_train_tokenizer_matches_wordpiece_on_export(tmp_path):
    vocab = te.build_vocab()
    cfg = te.train_config(len(vocab), hidden=32, layers=1)
    export_bert_checkpoint(enc.init_params(cfg, device="cpu"), cfg, vocab,
                           str(tmp_path))
    wp = WordPieceTokenizer.from_dir(str(tmp_path))
    loader_tok = load_encoder_tokenizer(str(tmp_path), cfg.max_len)
    a, b, _ = te.gen_pairs(np.random.default_rng(7), te.TOPIC_WORDS, 64)
    texts = a + b + ["Combine the flour, sugar and butter!", "zzxq? (qubit)"]
    ids, mask = te.TrainTokenizer(vocab)(texts)
    rows = wp(texts, max_length=te.MAX_TOKENS)
    for i, row in enumerate(rows):
        n = int(mask[i].sum())
        assert ids[i, :n].tolist() == row, texts[i]
    ids2, mask2 = loader_tok(texts)
    n = min(ids.shape[1], ids2.shape[1])
    np.testing.assert_array_equal(ids[:, :n], ids2[:, :n])
    np.testing.assert_array_equal(mask[:, :n], mask2[:, :n])


def test_export_roundtrips_through_the_port_loader(tmp_path):
    vocab = te.build_vocab()
    cfg = te.train_config(len(vocab), hidden=32, layers=2)
    params, _ = te.train(cfg, 2, 8, seed=4, device="cpu")
    export_bert_checkpoint(params, cfg, vocab, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "config.json", "model.safetensors", "special_tokens_map.json",
        "tokenizer_config.json", "vocab.txt"]
    cfg2, tree = load_encoder_checkpoint(str(tmp_path))
    assert (cfg2.vocab_size, cfg2.hidden, cfg2.layers, cfg2.heads, cfg2.mlp,
            cfg2.max_len) == (cfg.vocab_size, 32, 2, 4, 128, 64)
    for (name, want), got in zip(
            _named_leaves(enc.params_to_numpy(params)), te.leaves(tree)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert te.roundtrip_cosine(params, cfg, str(tmp_path), "cpu") >= 0.999
    with open(tmp_path / "tokenizer_config.json") as f:
        conf = json.load(f)
    with open(os.path.join(ASSET, "tokenizer_config.json")) as f:
        asset = json.load(f)
    for key in ("added_tokens_decoder", "do_lower_case", "strip_accents",
                "tokenize_chinese_chars", "tokenizer_class", "cls_token",
                "sep_token", "unk_token", "pad_token", "mask_token"):
        assert conf[key] == asset[key], key


@pytest.mark.parametrize("hidden,heads", LAYOUTS)
def test_params_to_numpy_through_reference_encode(hidden, heads):
    cfg, jcfg = _configs(hidden, heads)
    params, _ = te.train(cfg, 1, 8, seed=hidden, device="cpu")
    ids, mask = te.TrainTokenizer(te.build_vocab())(
        te.gen_pairs(np.random.default_rng(9), te.TOPIC_WORDS, 16)[0])
    with torch.no_grad():
        got = enc.encode(params, cfg, torch.from_numpy(ids),
                         torch.from_numpy(mask)).numpy()
    want = np.asarray(jax.jit(jenc.encode, static_argnums=1)(
        enc.params_to_numpy(params), jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_write_safetensors_rewrites_the_asset(tmp_path):
    src = os.path.join(ASSET, "model.safetensors")
    sd = read_safetensors(src)
    out = str(tmp_path / "model.safetensors")
    write_safetensors(sd, out)
    again = read_safetensors(out)
    assert list(again) == list(sd)
    for k, v in sd.items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k
    with open(src, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()  # the safetensors package's own layout


def test_cli_refuses_an_encoder_below_the_gate(tmp_path, capsys):
    from orama_core_tpu_torch.tools import train_tiny_encoder as cli

    rc = cli.main(["--device", "cpu", "--steps", "5",
                   "--out", str(tmp_path / "ck")])
    err = capsys.readouterr().err
    assert rc == 1
    assert "FAIL: encoder failed to learn topic semantics" in err
    assert "step 4: loss" in err
    assert not (tmp_path / "ck").exists()


def test_cli_trains_exports_and_round_trips(tmp_path, capsys):
    from orama_core_tpu_torch.tools import train_tiny_encoder as cli

    rc = cli.main(["--device", "cpu", "--steps", "40", "--hidden", "32",
                   "--layers", "1", "--batch", "32",
                   "--out", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["topic"] > 0.85 and rec["roundtrip_cosine"] >= 0.999
    assert rec["loss_last"] < rec["loss_first"]
    cfg, _ = load_encoder_checkpoint(str(tmp_path / "ck"))
    assert (cfg.hidden, cfg.layers, cfg.heads) == (32, 1, 4)


def test_cli_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    from orama_core_tpu_torch.tools import train_tiny_encoder as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--steps", "1", "--out", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
