"""The port's transformer encoder (``orama_core_tpu_torch/models/encoder.py``)
and checkpoint loader (``models/hf_loader.py``) against the JAX package.

The same parameters (the reference's ``init_params`` carried across with
``params_from_numpy``) and the same numpy token ids go through both
``encode`` functions. Tolerances: f32 configs within 1e-5 (the same
arithmetic in another order of summation); bf16 configs by cosine >= 0.999
per row (the port rounds each dense output to bf16 once more than the
reference, which keeps its f32 accumulator: relative 2^-9 per layer).
Tokenizer ids and loaded arrays are held equal."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from orama_core_tpu.models import encoder as ref_enc
from orama_core_tpu_torch.models import encoder as enc

ASSET = os.path.join(os.path.dirname(__file__), "assets", "tiny-semantic")


def _cfgs(out_dim=64, dtype="f32"):
    kw = dict(vocab_size=100, hidden=64, layers=2, heads=4, mlp=128,
              max_len=32, out_dim=out_dim)
    ref = ref_enc.EncoderConfig(
        **kw, dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    port = enc.EncoderConfig(
        **kw, dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    return ref, port


def _carried(ref_cfg, port_cfg, seed=0):
    params = ref_enc.init_params(jax.random.PRNGKey(seed), ref_cfg)
    tree = jax.tree.map(np.asarray, params)
    return params, enc.params_from_numpy(tree, port_cfg, "cpu")


def _inputs(seed=1, b=4, l=16, vocab=100):
    """Token ids with padded rows: one full row, two cut short, one of a
    single token."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    for row, n in ((1, 11), (2, 5), (3, 1)):
        mask[row, n:] = 0.0
        ids[row, n:] = 0
    return ids, mask


def _both(ref_params, port_params, ref_cfg, port_cfg, ids, mask):
    want = np.asarray(ref_enc.encode(ref_params, ref_cfg, jnp.asarray(ids),
                                     jnp.asarray(mask)))
    got = enc.encode(port_params, port_cfg, torch.from_numpy(ids),
                     torch.from_numpy(mask)).numpy()
    return want, got


def _cosines(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


@pytest.mark.parametrize("out_dim", [64, 48])  # 48: the optional proj layer
def test_encode_parity_f32(out_dim):
    ref_cfg, port_cfg = _cfgs(out_dim, "f32")
    rp, pp = _carried(ref_cfg, port_cfg)
    ids, mask = _inputs()
    want, got = _both(rp, pp, ref_cfg, port_cfg, ids, mask)
    assert got.shape == (4, out_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_encode_parity_bf16():
    ref_cfg, port_cfg = _cfgs(64, "bf16")
    rp, pp = _carried(ref_cfg, port_cfg, seed=3)
    ids, mask = _inputs(seed=4)
    want, got = _both(rp, pp, ref_cfg, port_cfg, ids, mask)
    assert (_cosines(got, want) >= 0.999).all(), _cosines(got, want)


def test_padding_does_not_leak():
    """A row's embedding does not depend on what its pad slots hold or on
    the padded width (the -1e9 attention bias and the masked pool)."""
    _, port_cfg = _cfgs(64, "f32")
    pp = enc.init_params(port_cfg, device="cpu")
    ids, mask = _inputs(seed=5)
    a = enc.encode(pp, port_cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    ids2 = ids.copy()
    ids2[mask == 0] = 7
    b = enc.encode(pp, port_cfg, torch.from_numpy(ids2), torch.from_numpy(mask))
    c = enc.encode(pp, port_cfg, torch.from_numpy(ids[:, :11]),
                   torch.from_numpy(mask[:, :11]))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    torch.testing.assert_close(a[1:], c[1:], atol=1e-5, rtol=0)


def test_hash_tokenizer_ids_equal():
    texts = ["Hello TPU world", "", "one two three four five six seven eight "
             "nine ten", "Ünïcode wörds and   spacing\ttabs", "x " * 700]
    for vocab, max_len in ((100, 32), (30522, 512)):
        want = ref_enc.HashTokenizer(vocab, max_len)(texts)
        got = enc.HashTokenizer(vocab, max_len)(texts)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)


def test_jax_minilm_embedder_matches_reference():
    """The registry's ``jax-minilm`` at its full width (hidden 384, 6
    layers, 12 heads, MLP 1536): the reference embedder's random
    parameters carried into the port's embedder, bf16, on the same
    texts."""
    ref = ref_enc.JaxEncoderEmbedder("jax-minilm")
    port = enc.EncoderEmbedder(
        "jax-minilm", params=jax.tree.map(np.asarray, ref.params), device="cpu")
    assert port.cfg == enc.EncoderConfig()  # MINILM
    texts = ["passage: the quick brown fox", "passage: jumps over",
             "passage: " + " ".join(f"w{i}" for i in range(40))]
    want, got = ref.embed(texts), port.embed(texts)
    assert got.shape == (3, 384) and got.dtype == np.float32
    assert (_cosines(got, want) >= 0.999).all(), _cosines(got, want)
    assert port.embed([]).shape == (0, 384)


# -- checkpoint files --------------------------------------------------------


def test_safetensors_reader_equals_library():
    from safetensors.torch import load_file

    from orama_core_tpu_torch.models.hf_loader import read_safetensors

    path = os.path.join(ASSET, "model.safetensors")
    want, got = load_file(path), read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k


def test_safetensors_reader_dtypes(tmp_path):
    """Every dtype the reader maps, zero-size and scalar tensors too."""
    from safetensors.torch import save_file

    from orama_core_tpu_torch.models.hf_loader import read_safetensors

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(7, generator=g).bfloat16(),
        "f16": torch.randn(2, 2, generator=g).half(),
        "f64": torch.randn(4, generator=g).double(),
        "i64": torch.arange(6).reshape(2, 3),
        "i32": torch.arange(5, dtype=torch.int32),
        "i8": torch.tensor([-3, 4], dtype=torch.int8),
        "u8": torch.tensor([1, 255], dtype=torch.uint8),
        "b": torch.tensor([True, False, True]),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_loaders_arrays_equal_on_tiny_semantic():
    from orama_core_tpu.models.hf_loader import (
        load_encoder_checkpoint as ref_load)
    from orama_core_tpu_torch.models.hf_loader import load_encoder_checkpoint

    ref_cfg, ref_params = ref_load(ASSET)
    cfg, params = load_encoder_checkpoint(ASSET)
    for f in ("vocab_size", "hidden", "layers", "heads", "mlp", "max_len",
              "out_dim"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f
    want = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(params)[0]}
    assert len(got) == len(want)
    for path, w in want:
        g = got[jax.tree_util.keystr(path)]
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_foreign_checkpoint_returns_none(tmp_path, caplog):
    """A RoBERTa-named checkpoint, a config-only dir and an empty dir all
    return None (the reference's contract), the first with a warning."""
    from safetensors.torch import save_file

    from orama_core_tpu_torch.models.hf_loader import (
        load_encoder_checkpoint, load_encoder_tokenizer)

    d = tmp_path / "roberta"
    d.mkdir()
    (d / "config.json").write_text(open(os.path.join(ASSET, "config.json")).read())
    save_file({"roberta.embeddings.word_embeddings.weight": torch.zeros(4, 4)},
              str(d / "model.safetensors"))
    assert load_encoder_checkpoint(str(d)) is None
    assert "does not match" in caplog.text
    (tmp_path / "cfg_only").mkdir()
    (tmp_path / "cfg_only" / "config.json").write_text("{}")
    assert load_encoder_checkpoint(str(tmp_path / "cfg_only")) is None
    assert load_encoder_checkpoint(str(tmp_path)) is None
    assert load_encoder_tokenizer(str(tmp_path), 64) is None


# -- the WordPiece tokenizer against transformers' ------------------------------

_HF = {}


def _hf_tok(path):
    if path not in _HF:
        from transformers import AutoTokenizer

        _HF[path] = AutoTokenizer.from_pretrained(path, local_files_only=True)
    return _HF[path]


def _hf_rows(path, texts, max_len):
    return _hf_tok(path)(list(texts), truncation=True, max_length=max_len,
                         add_special_tokens=True)["input_ids"]


def _port_tok(path):
    from orama_core_tpu_torch.models.hf_loader import WordPieceTokenizer

    return WordPieceTokenizer.from_dir(path)


def _semantic_texts():
    from test_semantic_e2e import PASSAGES, QUERIES

    return list(PASSAGES.values()) + list(QUERIES.values())


def test_wordpiece_equals_transformers_on_semantic_texts():
    texts = _semantic_texts() + [
        "Héllo, WORLD!! naïve café [MASK] x[SEP]y", "中文字符 test\tnew\nline",
        "ΟΔΟΣ straße İstanbul", "a" * 150, "don't stop-believing... 3.14",
        "\x00ctrl\x07chars​ zero-width�", "",
    ]
    assert _port_tok(ASSET)(texts, 64) == _hf_rows(ASSET, texts, 64)
    # truncation keeps [CLS] ... [SEP] inside max_length
    long = [" ".join(_semantic_texts())]
    assert _port_tok(ASSET)(long, 16) == _hf_rows(ASSET, long, 16)


@pytest.fixture(scope="module")
def subword_vocab(tmp_path_factory):
    """A vocab with ## continuations (the asset's has whole words only), so
    the greedy longest-match and the [UNK]-on-failure rules run."""
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("wordpiece")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "un", "##aff",
             "##able", "aff", "##a", "##b", "a", "b", "run", "##ning", "##n",
             "straße", "stras", "##se", "ca", "##fe", "é", "中", ",", ".",
             "!", "'", "-", "s", "t", "##s", "##t", "the", "##e"]
    (d / "vocab.txt").write_text("\n".join(words) + "\n")
    BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(d)
    return str(d)


def test_wordpiece_subwords_equal_transformers(subword_vocab):
    texts = ["unaffable running", "affab unab", "Café straße", "the thee",
             "runn, running! it's a-b", "中中 中x", "ab" * 60]
    assert _port_tok(subword_vocab)(texts, 48) == _hf_rows(
        subword_vocab, texts, 48)


def test_wordpiece_unassigned_and_late_chars_equal_transformers():
    """Unassigned code points and format characters newer than the
    reference's Unicode tables are kept (as [UNK]), not dropped as
    controls; U+2B820..U+2B91F are not spaced out as CJK ideographs."""
    texts = ["΢", "a͸b", "x ࢐y.", "\U00013439 ​",
             "a\U0002b820b", "a\U0002b920b", " ­‮"]
    assert _port_tok(ASSET)(texts, 64) == _hf_rows(ASSET, texts, 64)


_ALPHABET = (
    [chr(c) for c in range(0x20, 0x7F)]                 # ASCII printable
    + [chr(c) for c in range(0xA0, 0x180)]              # Latin-1, Ext-A
    + [chr(c) for c in range(0x391, 0x3CA)]             # Greek
    + [chr(c) for c in range(0x410, 0x450)]             # Cyrillic
    + [chr(c) for c in range(0x2000, 0x2030)]           # spaces, dashes, quotes
    + [chr(c) for c in range(0x300, 0x310)]             # combining marks
    + list("\t\n\r\x00\x07\x1b​�中文字符日本語한국어")
)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.text(alphabet=st.sampled_from(_ALPHABET), max_size=60),
                min_size=1, max_size=4))
def test_wordpiece_equals_transformers_hypothesis(texts):
    assert _port_tok(ASSET)(texts, 64) == _hf_rows(ASSET, texts, 64)


def test_encoder_tokenizer_buckets_match_reference():
    """``load_encoder_tokenizer``'s (ids, mask) with pow2 buckets equal the
    reference's (which wraps transformers' tokenizer)."""
    from orama_core_tpu.models.hf_loader import (
        load_encoder_tokenizer as ref_load)
    from orama_core_tpu_torch.models.hf_loader import load_encoder_tokenizer

    texts = _semantic_texts()
    for batch in (texts, texts[:1], [" ".join(texts)]):
        want = ref_load(ASSET, 64)(batch)
        got = load_encoder_tokenizer(ASSET, 64)(batch)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)


# -- the trained in-repo checkpoint, both packages ---------------------------


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_tiny_semantic_embeddings_match_reference(dtype):
    from orama_core_tpu.models.hf_loader import (
        load_encoder_checkpoint as ref_load, load_encoder_tokenizer as ref_tok)
    from orama_core_tpu_torch.models.hf_loader import (
        load_encoder_checkpoint, load_encoder_tokenizer)

    ref_cfg, ref_params = ref_load(ASSET)
    cfg, params = load_encoder_checkpoint(ASSET)
    if dtype == "f32":
        ref_cfg = dataclasses.replace(ref_cfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ref = ref_enc.JaxEncoderEmbedder("bge-small", cfg=ref_cfg,
                                     params=ref_params,
                                     tokenizer=ref_tok(ASSET, ref_cfg.max_len))
    port = enc.EncoderEmbedder("bge-small", cfg=cfg, params=params,
                               tokenizer=load_encoder_tokenizer(ASSET, cfg.max_len),
                               device="cpu")
    texts = _semantic_texts()
    want, got = ref.embed(texts), port.embed(texts)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (_cosines(got, want) >= 0.999).all(), _cosines(got, want)


def test_ai_service_ladder(tmp_path, caplog):
    """``backend="jax"``: a checkpoint with its tokenizer gives the encoder
    on the service's device; one without tokenizer files, or no checkpoint,
    gives the lexical fallback for pretrained-family names; ``jax-*``
    names give the random-init encoder; ``fake-*`` stay fake. As the
    reference's ladder (orama_core_tpu/models/ai_service.py:71-121)."""
    import shutil

    from orama_core_tpu_torch.config import AiConfig
    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.models.fake import FakeEmbedder
    from orama_core_tpu_torch.models.lexical import LexicalEmbedder

    def service(ckpt=None):
        cfg = AiConfig(backend="jax", embedding_model="jax-minilm",
                       embedding_checkpoint_path=ckpt)
        return AIService(cfg, device="cpu")

    emb = service(ASSET)._embedder("bge-small")
    assert isinstance(emb, enc.EncoderEmbedder) and emb.device.type == "cpu"
    assert emb.cfg.hidden == 96
    no_tok = tmp_path / "no-tokenizer"
    no_tok.mkdir()
    for f in ("config.json", "model.safetensors"):
        shutil.copy(os.path.join(ASSET, f), no_tok / f)
    assert isinstance(service(str(no_tok))._embedder("bge-small"),
                      LexicalEmbedder)
    assert "refusing to pair" in caplog.text
    assert isinstance(service()._embedder("bge-small"), LexicalEmbedder)
    s = service()
    assert isinstance(s._embedder("jax-minilm"), enc.EncoderEmbedder)
    assert isinstance(s._embedder("fake-small"), FakeEmbedder)
    assert s.check_health() == {"status": "ok", "backend": "jax"}
    assert s.embed_query("jax-minilm", ["a", "b c"]).shape == (2, 384)
