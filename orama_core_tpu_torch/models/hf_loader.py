"""Load HuggingFace checkpoints from local disk into the port's parameters.

Port of ``orama_core_tpu/models/hf_loader.py``: the same BERT encoder
mapping (BGE/E5/MiniLM: the ``bert.`` prefix, token-type row 0 folded
into ``pos_emb``, weights transposed) and Qwen2/LLaMA decoder mapping
(q/k/v biases, ``lm_head`` tied to ``embed_tokens`` when absent), and the
same contract: an absent, partial or foreign checkpoint returns None and
logs a warning, and callers keep their fallback.

The loader needs neither ``safetensors`` nor ``transformers`` (the card's
machine has neither): ``read_safetensors`` parses ``model.safetensors``
itself, ``pytorch_model.bin`` goes through ``torch.load(weights_only=True)``,
and the encoder's tokenizer is the BERT WordPiece tokenizer below, read
from ``vocab.txt`` and ``tokenizer_config.json``. The LLM's tokenizer is
``transformers``' where it imports, else the byte-level one, as in the
reference. Parameters come back as f32 tensors on the CPU; the embedder
and the chat model place them (``params_from_numpy``).
"""

from __future__ import annotations

import json
import logging
import os
import re
import unicodedata
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

_LOG = logging.getLogger("oramax.ai")

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}. The format: an 8-byte
    little-endian header length N, N bytes of JSON ({name: {dtype, shape,
    data_offsets: [begin, end]}} plus an optional ``__metadata__``), then
    the raw little-endian tensor bytes, offsets relative to their start."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    n = int.from_bytes(buf[:8], "little")
    header = json.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[spec["dtype"]]
        shape = [int(s) for s in spec["shape"]]
        begin, end = (int(o) for o in spec["data_offsets"])
        numel = int(np.prod(shape)) if shape else 1
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * itemsize:
            raise ValueError(f"{name}: {end - begin} bytes for shape {shape}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(
            buf, dtype=dtype, count=numel, offset=base + begin
        ).reshape(shape)
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """The inverse of ``read_safetensors``: {name: tensor} -> a
    ``.safetensors`` file, laid out as the ``safetensors`` package lays it
    out: larger items first and then by name (every offset stays aligned
    to its item size), a compact JSON header padded with spaces to a
    multiple of 8 bytes, then the raw little-endian bytes. Written to a
    temporary file and renamed into place."""
    names = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, Any] = {}
    blobs = []
    offset = 0
    for name in order:
        t = tensors[name].detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)


def _load_state_dict(path: str) -> Optional[Dict[str, torch.Tensor]]:
    try:
        candidates = [
            os.path.join(path, "pytorch_model.bin"),
            os.path.join(path, "model.safetensors"),
        ]
        for c in candidates:
            if os.path.exists(c):
                if c.endswith(".safetensors"):
                    sd = read_safetensors(c)
                else:
                    sd = torch.load(c, map_location="cpu", weights_only=True)
                return {k: v.to(torch.float32) for k, v in sd.items()}
    except Exception:
        return None
    return None


def load_encoder_checkpoint(path: str):
    """BERT-family -> (EncoderConfig, params) or None (per the module
    contract, a partial/foreign checkpoint — e.g. RoBERTa tensor names or a
    truncated config — returns None rather than raising mid-serve)."""
    try:
        return _load_encoder_checkpoint(path)
    except (KeyError, ValueError, TypeError) as e:
        _LOG.warning(
            "encoder checkpoint at %s does not match the BERT-family "
            "schema (%s) — ignoring it", path, e,
        )
        return None


def _load_encoder_checkpoint(path: str):
    from .encoder import EncoderConfig

    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        hf = json.load(f)
    sd = _load_state_dict(path)
    if sd is None:
        return None
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    cfg = EncoderConfig(
        vocab_size=hf["vocab_size"],
        hidden=hf["hidden_size"],
        layers=hf["num_hidden_layers"],
        heads=hf["num_attention_heads"],
        mlp=hf["intermediate_size"],
        max_len=hf["max_position_embeddings"],
        out_dim=hf["hidden_size"],
    )

    def g(name):
        return sd[prefix + name]

    params: Dict[str, Any] = {
        "tok_emb": g("embeddings.word_embeddings.weight"),
        "pos_emb": g("embeddings.position_embeddings.weight"),
        "emb_ln": {
            "g": g("embeddings.LayerNorm.weight"),
            "b": g("embeddings.LayerNorm.bias"),
        },
        "layers": [],
    }
    # token_type embeddings fold into tok_emb (single segment)
    tt = prefix + "embeddings.token_type_embeddings.weight"
    if tt in sd:
        params["pos_emb"] = params["pos_emb"] + sd[tt][0][None, :]
    for i in range(cfg.layers):
        lp = f"encoder.layer.{i}."

        def d(sub):
            return {
                "w": g(lp + sub + ".weight").T.contiguous(),
                "b": g(lp + sub + ".bias"),
            }

        params["layers"].append(
            {
                "q": d("attention.self.query"),
                "k": d("attention.self.key"),
                "v": d("attention.self.value"),
                "o": d("attention.output.dense"),
                "ln1": {
                    "g": g(lp + "attention.output.LayerNorm.weight"),
                    "b": g(lp + "attention.output.LayerNorm.bias"),
                },
                "up": d("intermediate.dense"),
                "down": d("output.dense"),
                "ln2": {
                    "g": g(lp + "output.LayerNorm.weight"),
                    "b": g(lp + "output.LayerNorm.bias"),
                },
            }
        )
    return cfg, params


_BERT_SPECIALS = {"pad_token": "[PAD]", "unk_token": "[UNK]",
                  "cls_token": "[CLS]", "sep_token": "[SEP]",
                  "mask_token": "[MASK]"}


def export_bert_checkpoint(params, cfg, vocab: Sequence[str], out: str,
                           trained_by: str = "orama_core_tpu_torch") -> None:
    """The encoder's parameters -> an HF BERT checkpoint directory at
    ``out``, the exact inverse of ``load_encoder_checkpoint``'s map:
    ``config.json``, ``model.safetensors`` (f32, weights transposed to
    HF's [out, in], token-type rows zero so folding row 0 into ``pos_emb``
    changes nothing), ``vocab.txt`` and BertTokenizer's
    ``tokenizer_config.json`` and ``special_tokens_map.json`` (written as
    JSON here: no ``transformers`` needed). ``params``: the port's tensors
    or the reference's numpy pytree."""
    from .encoder import params_to_numpy

    tree = params_to_numpy(params)
    os.makedirs(out, exist_ok=True)
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))

    def dense(name, d):
        put(name + ".weight", np.asarray(d["w"]).T)
        put(name + ".bias", d["b"])

    put("embeddings.word_embeddings.weight", tree["tok_emb"])
    put("embeddings.position_embeddings.weight", tree["pos_emb"])
    put("embeddings.token_type_embeddings.weight",
        np.zeros((2, cfg.hidden), np.float32))
    put("embeddings.LayerNorm.weight", tree["emb_ln"]["g"])
    put("embeddings.LayerNorm.bias", tree["emb_ln"]["b"])
    for i, lp in enumerate(tree["layers"]):
        pre = f"encoder.layer.{i}."
        dense(pre + "attention.self.query", lp["q"])
        dense(pre + "attention.self.key", lp["k"])
        dense(pre + "attention.self.value", lp["v"])
        dense(pre + "attention.output.dense", lp["o"])
        put(pre + "attention.output.LayerNorm.weight", lp["ln1"]["g"])
        put(pre + "attention.output.LayerNorm.bias", lp["ln1"]["b"])
        dense(pre + "intermediate.dense", lp["up"])
        dense(pre + "output.dense", lp["down"])
        put(pre + "output.LayerNorm.weight", lp["ln2"]["g"])
        put(pre + "output.LayerNorm.bias", lp["ln2"]["b"])
    write_safetensors(sd, os.path.join(out, "model.safetensors"))

    def dump(name, obj):
        with open(os.path.join(out, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1)

    dump("config.json", {
        "model_type": "bert",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden,
        "num_hidden_layers": cfg.layers,
        "num_attention_heads": cfg.heads,
        "intermediate_size": cfg.mlp,
        "max_position_embeddings": cfg.max_len,
        "layer_norm_eps": 1e-12,
        "hidden_act": "gelu",
        "trained_by": trained_by,
    })
    with open(os.path.join(out, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in vocab))
    index = {t: i for i, t in enumerate(vocab)}
    dump("tokenizer_config.json", {
        "added_tokens_decoder": {
            str(index[t]): {"content": t, "lstrip": False,
                            "normalized": False, "rstrip": False,
                            "single_word": False, "special": True}
            for t in sorted(_BERT_SPECIALS.values(), key=index.__getitem__)
        },
        "clean_up_tokenization_spaces": True,
        "do_basic_tokenize": True,
        "do_lower_case": True,
        "never_split": None,
        "strip_accents": None,
        "tokenize_chinese_chars": True,
        "tokenizer_class": "BertTokenizer",
        **_BERT_SPECIALS,
    })
    dump("special_tokens_map.json", dict(sorted(_BERT_SPECIALS.items())))


# -- BERT WordPiece tokenizer ------------------------------------------------

# The reference tokenizer's ranges, with its 0x2B920 where BERT's original
# Python has 0x2B820: U+2B820..U+2B91F are not spaced out there.
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_whitespace(c: str) -> bool:
    return c in " \t\n\r" or c.isspace()


# Format characters assigned after the Unicode tables the reference
# tokenizer (HF tokenizers' BertNormalizer) was built with: to it they are
# unassigned, and it keeps them, as it keeps every unassigned code point.
_LATE_FORMAT = frozenset([0x890, 0x891, 0x8E2, 0x110CD,
                          *range(0x13430, 0x13440)])


def _is_control(c: str) -> bool:
    """What the reference's clean_text drops: Cc (but tab, newline and
    carriage return), Cf, Co and Cs; never an unassigned (Cn) code point."""
    if c in "\t\n\r":
        return False
    cat = unicodedata.category(c)
    if cat == "Cf":
        return ord(c) not in _LATE_FORMAT
    return cat in ("Cc", "Co", "Cs")


def _is_punctuation(c: str) -> bool:
    cp = ord(c)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(c).startswith("P")


class WordPieceTokenizer:
    """BERT's WordPiece tokenizer (the HF ``BertTokenizer`` /
    ``tokenizer.json`` pipeline a BERT checkpoint ships): BertNormalizer
    (drop NUL, U+FFFD and control chars, whitespace to spaces, spaces
    around CJK ideographs, accents stripped when ``strip_accents`` is true
    or unset with lowercasing, lowercase), BertPreTokenizer (split on
    whitespace, punctuation as tokens of their own), greedy longest-match
    WordPiece with ``##`` continuations (a word longer than 100 chars or
    with no match is ``[UNK]``), and ``[CLS] ... [SEP]``. Special tokens in
    the raw text match as themselves, as HF's added tokens do."""

    def __init__(self, vocab: List[str], lowercase: bool = True,
                 strip_accents: Optional[bool] = None,
                 chinese_chars: bool = True, unk: str = "[UNK]",
                 cls: str = "[CLS]", sep: str = "[SEP]",
                 specials: Sequence[str] = (),
                 max_chars_per_word: int = 100) -> None:
        self.vocab = {t: i for i, t in enumerate(vocab)}
        self.lowercase = lowercase
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.chinese_chars = chinese_chars
        self.unk_id = self.vocab[unk]
        self.cls_id = self.vocab[cls]
        self.sep_id = self.vocab[sep]
        self.max_chars_per_word = max_chars_per_word
        specials = sorted({s for s in specials if s in self.vocab}, key=len,
                          reverse=True)
        self._special = (
            re.compile("(" + "|".join(re.escape(s) for s in specials) + ")")
            if specials else None
        )

    def _normalize(self, text: str) -> str:
        out = []
        for c in text:
            cp = ord(c)
            if cp == 0 or cp == 0xFFFD or _is_control(c):
                continue
            if _is_whitespace(c):
                out.append(" ")
            elif self.chinese_chars and _is_cjk(cp):
                out.append(f" {c} ")
            else:
                out.append(c)
        text = "".join(out)
        if self.strip_accents:
            text = "".join(
                c for c in unicodedata.normalize("NFD", text)
                if unicodedata.category(c) != "Mn"
            )
        if self.lowercase:
            # char by char, as the reference tokenizer lowercases (no
            # context-dependent final sigma)
            text = "".join(c.lower() for c in text)
        return text

    def _words(self, text: str) -> List[str]:
        words: List[str] = []
        for chunk in text.split(" "):  # _normalize mapped whitespace to " "
            cur = []
            for c in chunk:
                if _is_punctuation(c):
                    if cur:
                        words.append("".join(cur))
                    words.append(c)
                    cur = []
                else:
                    cur.append(c)
            if cur:
                words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            found = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                tid = self.vocab.get(piece)
                if tid is not None:
                    found = tid
                    break
                end -= 1
            if found is None:
                return [self.unk_id]
            ids.append(found)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        """Token ids without the [CLS]/[SEP] template."""
        parts = self._special.split(text) if self._special else [text]
        ids: List[int] = []
        for i, part in enumerate(parts):
            if i % 2 == 1:  # a captured special token
                ids.append(self.vocab[part])
                continue
            for w in self._words(self._normalize(part)):
                ids.extend(self._wordpiece(w))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int) -> List[List[int]]:
        """[CLS] ids [SEP] per text, the ids cut so the row fits
        ``max_length`` (HF's ``truncation=True``)."""
        keep = max(0, max_length - 2)
        return [[self.cls_id] + self.encode(t)[:keep] + [self.sep_id]
                for t in texts]

    @classmethod
    def from_dir(cls, path: str) -> Optional["WordPieceTokenizer"]:
        vocab_path = os.path.join(path, "vocab.txt")
        if not os.path.exists(vocab_path):
            return None
        with open(vocab_path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        conf: Dict[str, Any] = {}
        conf_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(conf_path):
            with open(conf_path, encoding="utf-8") as f:
                conf = json.load(f)
        specials = [conf.get(k) for k in ("unk_token", "cls_token", "sep_token",
                                           "pad_token", "mask_token")]
        specials += [
            t.get("content") for t in (conf.get("added_tokens_decoder") or {}).values()
            if isinstance(t, dict)
        ]
        return cls(
            vocab,
            lowercase=bool(conf.get("do_lower_case", True)),
            strip_accents=conf.get("strip_accents"),
            chinese_chars=bool(conf.get("tokenize_chinese_chars", True)),
            unk=conf.get("unk_token") or "[UNK]",
            cls=conf.get("cls_token") or "[CLS]",
            sep=conf.get("sep_token") or "[SEP]",
            specials=[s for s in specials if isinstance(s, str)],
        )


def load_encoder_tokenizer(path: str, max_len: int):
    """The checkpoint's WordPiece tokenizer wrapped to the engine's
    ``texts -> (ids, mask)`` contract with pow2 length buckets (as
    HashTokenizer). Returns None when the checkpoint directory carries no
    ``vocab.txt`` (or its special tokens are missing from it)."""
    try:
        tok = WordPieceTokenizer.from_dir(path)
    except (KeyError, ValueError, OSError) as e:
        _LOG.warning("tokenizer files at %s do not load (%s)", path, e)
        return None
    if tok is None:
        return None

    class _EncoderTok:
        def __call__(self, texts):
            enc = tok(list(texts), max_length=max_len)
            l = max(8, max((len(r) for r in enc), default=1))
            l = min(1 << (l - 1).bit_length(), max_len)
            ids = np.zeros((len(enc), l), np.int32)
            mask = np.zeros((len(enc), l), np.float32)
            for i, r in enumerate(enc):
                n = min(len(r), l)
                ids[i, :n] = r[:n]
                mask[i, :n] = 1.0
            return ids, mask

    return _EncoderTok()


def load_llm_checkpoint(path: str):
    """Qwen2/LLaMA-family -> (LlmConfig, params, tokenizer) or None (same
    graceful-degradation contract as the encoder loader)."""
    try:
        return _load_llm_checkpoint(path)
    except (KeyError, ValueError, TypeError) as e:
        _LOG.warning(
            "LLM checkpoint at %s does not match the Qwen2/LLaMA-family "
            "schema (%s) — ignoring it", path, e,
        )
        return None


def _load_llm_checkpoint(path: str):
    from .llm import LlmConfig

    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        hf = json.load(f)
    sd = _load_state_dict(path)
    if sd is None:
        return None
    cfg = LlmConfig(
        vocab_size=hf["vocab_size"],
        hidden=hf["hidden_size"],
        layers=hf["num_hidden_layers"],
        heads=hf["num_attention_heads"],
        kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        mlp=hf["intermediate_size"],
        max_len=min(hf.get("max_position_embeddings", 2048), 4096),
        rope_theta=hf.get("rope_theta", 10_000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-6),
    )

    def g(name):
        return sd[name]

    def t(name):
        return sd[name].T.contiguous()

    params: Dict[str, Any] = {
        "tok_emb": g("model.embed_tokens.weight"),
        "out_norm": g("model.norm.weight"),
        "lm_head": (
            t("lm_head.weight")
            if "lm_head.weight" in sd
            else t("model.embed_tokens.weight")
        ),
        "layers": [],
    }
    for i in range(cfg.layers):
        lp = f"model.layers.{i}."
        layer = {
            "ln1": g(lp + "input_layernorm.weight"),
            "wq": t(lp + "self_attn.q_proj.weight"),
            "wk": t(lp + "self_attn.k_proj.weight"),
            "wv": t(lp + "self_attn.v_proj.weight"),
            "wo": t(lp + "self_attn.o_proj.weight"),
            "ln2": g(lp + "post_attention_layernorm.weight"),
            "w_gate": t(lp + "mlp.gate_proj.weight"),
            "w_up": t(lp + "mlp.up_proj.weight"),
            "w_down": t(lp + "mlp.down_proj.weight"),
        }
        # Qwen2 carries q/k/v biases (service/models.py's Qwen2.5 default)
        if lp + "self_attn.q_proj.bias" in sd:
            layer["bq"] = g(lp + "self_attn.q_proj.bias")
            layer["bk"] = g(lp + "self_attn.k_proj.bias")
            layer["bv"] = g(lp + "self_attn.v_proj.bias")
        params["layers"].append(layer)
    tokenizer = None
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

        class _HFTok:
            BOS = tok.bos_token_id or 0
            EOS = tok.eos_token_id or 0
            vocab_size = cfg.vocab_size

            def encode(self, text):
                return tok.encode(text)

            def decode(self, ids):
                return tok.decode([int(i) for i in ids], skip_special_tokens=True)

        tokenizer = _HFTok()
    except Exception:
        from .llm import ByteTokenizer

        tokenizer = ByteTokenizer()
    return cfg, params, tokenizer
