"""Transformer encoder: the in-process embedding model, on the card.

Port of ``orama_core_tpu/models/encoder.py``: the same BERT-family
bidirectional encoder (params as a plain dict of tensors), mean-pool + L2
normalize, step for step as the reference's ``encode`` (:114-139). The
dense layers are bf16 products with f32 accumulation; the embeddings,
layer norms, attention logits and softmax are f32.

One rounding more than the reference: a torch bf16 product returns bf16,
where the reference keeps the f32 accumulator (``preferred_element_type``).
Each dense output is rounded to bf16 once (relative 2^-9) before its f32
bias is added; the tests size the bf16 tolerance by it (cosine >= 0.999).
With ``dtype=torch.float32`` the arithmetic is the reference's.

No TPU kernel is on this path: the reference computes the products and the
softmax outside Pallas, so the port runs them as plain torch (``matmul``,
``einsum``, ``softmax``), with the attention product written out as the
reference writes it.

Weights: random (hash tokenizer) by default; retrieval-quality weights
load from local HF checkpoints via models/hf_loader.py.

Tensor parallelism: ``param_specs`` is the reference's Megatron layout
(:82-102), leaf for leaf, and ``encode`` takes parameters placed by it
(``parallel.mesh.shard_params``) as well as plain ones. The batch splits
over ``data``, as the reference places ``ids`` on ``P("data", None)``;
each model shard runs its heads' attention, and the row-split o and down
products give f32 partials that are summed over ``model`` before their
replicated bias is added, once (models/tp.py). The engine does not read
the ``model`` axis, as in the reference: the sharded forward serves the
model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import P
from . import tp
from .checkpoint import as_param
from .registry import model_info


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    mlp: int = 1536
    max_len: int = 512
    out_dim: int = 384  # embedding dim (== hidden unless projected)
    dtype: torch.dtype = torch.bfloat16


MINILM = EncoderConfig()  # MiniLM-L6-class: the "jax-minilm" registry entry


def params_from_numpy(tree: Dict[str, Any], cfg: EncoderConfig,
                      device="cuda") -> Dict[str, Any]:
    """The reference's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``, or as tensors) -> the port's
    parameters on ``device`` (the card unless the caller names another).
    Dense weights are stored in ``cfg.dtype`` (the reference casts them at
    every use, ``_dense``); embeddings, layer norms, biases and the f32
    ``proj`` stay f32."""
    f32, dt = torch.float32, cfg.dtype

    def ln(p):
        return {"g": as_param(p["g"], device, f32), "b": as_param(p["b"], device, f32)}

    def dense(p, wdt):
        return {"w": as_param(p["w"], device, wdt), "b": as_param(p["b"], device, f32)}

    out: Dict[str, Any] = {
        "tok_emb": as_param(tree["tok_emb"], device, f32),
        "pos_emb": as_param(tree["pos_emb"], device, f32),
        "emb_ln": ln(tree["emb_ln"]),
        "layers": [
            {
                **{k: dense(layer[k], dt) for k in ("q", "k", "v", "o", "up", "down")},
                "ln1": ln(layer["ln1"]),
                "ln2": ln(layer["ln2"]),
            }
            for layer in tree["layers"]
        ],
    }
    if "proj" in tree:
        out["proj"] = dense(tree["proj"], f32)
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the port's parameters -> the
    reference's pytree (the same nested dicts and lists) of f32 numpy
    arrays on the host, e.g. to run them through the reference's
    ``encode``."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().to("cpu", torch.float32).numpy()


def init_params(cfg: EncoderConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters (normal, std 0.02; zero biases; unit norms) drawn
    from ``generator`` on its own device (a CPU generator seeded 0 by
    default), then placed on ``device``. ``jax.random`` cannot be matched:
    tests carry the reference's parameters over with ``params_from_numpy``."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    s = 0.02

    def normal(*shape):
        return torch.randn(shape, generator=g, device=g.device) * s

    def dense(i, o):
        return {"w": normal(i, o), "b": torch.zeros(o)}

    def ln():
        return {"g": torch.ones(cfg.hidden), "b": torch.zeros(cfg.hidden)}

    tree: Dict[str, Any] = {
        "tok_emb": normal(cfg.vocab_size, cfg.hidden),
        "pos_emb": normal(cfg.max_len, cfg.hidden),
        "emb_ln": ln(),
        "layers": [],
    }
    for _ in range(cfg.layers):
        tree["layers"].append({
            "q": dense(cfg.hidden, cfg.hidden),
            "k": dense(cfg.hidden, cfg.hidden),
            "v": dense(cfg.hidden, cfg.hidden),
            "o": dense(cfg.hidden, cfg.hidden),
            "ln1": ln(),
            "up": dense(cfg.hidden, cfg.mlp),
            "down": dense(cfg.mlp, cfg.hidden),
            "ln2": ln(),
        })
    if cfg.out_dim != cfg.hidden:
        tree["proj"] = dense(cfg.hidden, cfg.out_dim)
    return params_from_numpy(tree, cfg, device)


def param_specs(cfg: EncoderConfig) -> Dict[str, Any]:
    """Partition specs for tensor parallelism over ``model``, the
    reference's tree (:82-102): q/k/v/up split by column (bias with its
    columns), o/down by row (bias replicated, added after the sum)."""
    col = {"w": P(None, "model"), "b": P("model")}
    row = {"w": P("model", None), "b": P()}
    ln = {"g": P(), "b": P()}
    layer = {
        "q": col, "k": col, "v": col, "o": row,
        "ln1": ln, "up": col, "down": row, "ln2": ln,
    }
    specs: Dict[str, Any] = {
        "tok_emb": P(),
        "pos_emb": P(),
        "emb_ln": ln,
        "layers": [layer for _ in range(cfg.layers)],
    }
    if cfg.out_dim != cfg.hidden:
        specs["proj"] = {"w": P(), "b": P()}
    return specs


def _ln(x, p, eps=1e-12):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _dense(x, p, dtype):
    return torch.matmul(x.to(dtype), p["w"].to(dtype)).float() + p["b"]


def encode(
    params: Dict[str, Any],
    cfg: EncoderConfig,
    ids: torch.Tensor,    # int[B, L]
    mask: torch.Tensor,   # float32[B, L] 1 = real token
) -> torch.Tensor:
    """[B, out_dim] L2-normalized mean-pooled embeddings (f32). Takes
    plain parameters, or parameters placed by ``param_specs``
    (``parallel.mesh.shard_params``), whose output lands on the mesh's
    first device."""
    if tp.is_sharded(params):
        return _encode_sharded(params, cfg, ids, mask)
    dt = cfg.dtype
    b, l = ids.shape
    ids = ids.long()
    mask = mask.float()
    x = params["tok_emb"][ids] + params["pos_emb"][:l][None, :, :]
    x = _ln(x, params["emb_ln"]).to(dt)
    attn_bias = (1.0 - mask[:, None, None, :]) * -1e9  # [B,1,1,L]
    hd = cfg.hidden // cfg.heads
    for layer in params["layers"]:
        q = _dense(x, layer["q"], dt).reshape(b, l, cfg.heads, hd)
        k = _dense(x, layer["k"], dt).reshape(b, l, cfg.heads, hd)
        v = _dense(x, layer["v"], dt).reshape(b, l, cfg.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        w = torch.softmax(logits + attn_bias, dim=-1)
        # the reference rounds the weights to dt, then multiplies with the
        # f32 values in f32 (bf16 x f32 promotes)
        ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(dt).float(), v).reshape(
            b, l, cfg.hidden)
        x = _ln(x.float() + _dense(ctx, layer["o"], dt), layer["ln1"]).to(dt)
        # BERT-family uses exact (erf) gelu — approximate gelu diverges from
        # real BGE/E5 checkpoints
        h = F.gelu(_dense(x, layer["up"], dt), approximate="none").to(dt)
        x = _ln(x.float() + _dense(h, layer["down"], dt), layer["ln2"]).to(dt)
    x = x.float()
    if "proj" in params:
        x = _dense(x, params["proj"], torch.float32)
    denom = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    pooled = (x * mask[:, :, None]).sum(1) / denom
    return pooled / torch.clamp(
        torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)


def _replicated(tree, i: int):
    """The replicated leaves of a placed subtree as unit i holds them."""
    if isinstance(tree, dict):
        return {k: _replicated(v, i) for k, v in tree.items()}
    return tree.parts[i]


def _encode_sharded(params, cfg: EncoderConfig, ids, mask) -> torch.Tensor:
    """``encode`` over placed parameters: each run of data rows (all of
    them on one device) embeds its slice of the batch; the slices are
    gathered in order on the layout's first device."""
    layout = params["tok_emb"].layout
    outs = [
        _encode_run(params, cfg, ids[r0:r1], mask[r0:r1], uids)
        for r0, r1, uids in layout.runs(ids.shape[0])
    ]
    if len(outs) == 1:
        return outs[0].to(layout.root)
    return torch.cat([o.to(layout.root) for o in outs])


def _encode_run(params, cfg: EncoderConfig, ids, mask, uids) -> torch.Tensor:
    """The local bodies of one run: ``encode``'s steps, with the
    products split as ``param_specs`` splits them (models/tp.py)."""
    dt = cfg.dtype
    units = tp.units_of(params["tok_emb"].layout, uids)
    u0, d0 = uids[0], units[0].device
    plan = tp.head_plan(cfg.heads, cfg.heads, cfg.hidden // cfg.heads,
                        params["tok_emb"].layout.n_model)
    hd = plan.hd
    l = ids.shape[1]
    ids = ids.to(d0).long()
    mask = mask.to(d0).float()
    x = params["tok_emb"].parts[u0][ids] + params["pos_emb"].parts[u0][:l][None]
    x = _ln(x, _replicated(params["emb_ln"], u0)).to(dt)
    biases = tp.spread((1.0 - mask[:, None, None, :]) * -1e9, units)
    for layer in params["layers"]:
        xs = tp.spread(x, units)
        q, k, v = (
            tp.heads(tp.col(xs, layer[n]["w"], uids, dt, layer[n]["b"],
                            f32=True), units, plan, "q")
            for n in ("q", "k", "v")
        )
        ctxs = []
        for j, u in enumerate(units):
            logits = torch.einsum("mbqhd,mbkhd->mbhqk", q[j],
                                  k[j]) / math.sqrt(hd)
            w = torch.softmax(logits + biases[j], dim=-1)
            ctx = torch.einsum("mbhqk,mbkhd->mbqhd", w.to(dt).float(), v[j])
            ctxs.append(tp.own_cols(ctx.reshape(ctx.shape[:3] + (-1,)), u,
                                    plan))
        o = tp.row_sum(ctxs, layer["o"]["w"], uids, dt, d0)
        x = _ln(x.float() + (o + layer["o"]["b"].parts[u0]),
                _replicated(layer["ln1"], u0)).to(dt)
        hs = [F.gelu(y, approximate="none").to(dt) for y in tp.col(
            tp.spread(x, units), layer["up"]["w"], uids, dt,
            layer["up"]["b"], f32=True)]
        down = tp.row_sum(hs, layer["down"]["w"], uids, dt, d0)
        x = _ln(x.float() + (down + layer["down"]["b"].parts[u0]),
                _replicated(layer["ln2"], u0)).to(dt)
    x = x.float()
    if "proj" in params:
        x = _dense(x, _replicated(params["proj"], u0), torch.float32)
    denom = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    pooled = (x * mask[:, :, None]).sum(1) / denom
    return pooled / torch.clamp(
        torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)


class HashTokenizer:
    """Deterministic wordpiece-free tokenizer: word -> blake2b bucket.

    Used with random weights (compile/perf paths, tests). With HF weights the
    matching WordPiece tokenizer is used instead (models/hf_loader.py)."""

    def __init__(self, vocab_size: int, max_len: int) -> None:
        self.vocab_size = vocab_size
        self.max_len = max_len
        self._cache: Dict[str, int] = {}

    def _bucket(self, w: str) -> int:
        b = self._cache.get(w)
        if b is None:
            h = int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(), "big")
            b = 1 + (h % (self.vocab_size - 2))  # 0 = pad
            self._cache[w] = b
        return b

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        rows = [[self._bucket(w) for w in t.lower().split()[: self.max_len]] for t in texts]
        l = max(8, max((len(r) for r in rows), default=1))
        l = min(1 << (l - 1).bit_length(), self.max_len)  # pow2 length buckets
        ids = np.zeros((len(texts), l), np.int32)
        mask = np.zeros((len(texts), l), np.float32)
        for i, r in enumerate(rows):
            n = min(len(r), l)
            ids[i, :n] = r[:n]
            mask[i, :n] = 1.0
        return ids, mask


class EncoderEmbedder:
    """AIService backend: tokenizer + encoder forward on ``device``.

    Port of ``JaxEncoderEmbedder`` (orama_core_tpu/models/encoder.py:182-206):
    the same config derivation from the registry entry, tokenizer and
    random init (here from a CPU generator seeded 0, so the card and the
    CPU hold the same parameters). The parameters live on ``device``;
    ``embed`` moves the token ids there and returns host f32 rows."""

    def __init__(
        self,
        model_name: str,
        cfg: Optional[EncoderConfig] = None,
        params=None,
        tokenizer=None,
        device="cuda",
    ) -> None:
        info = model_info(model_name)
        self.cfg = cfg or dataclasses.replace(
            MINILM, hidden=max(info.dim, 128), out_dim=info.dim,
            mlp=4 * max(info.dim, 128),
            heads=max(info.dim, 128) // 32,
        )
        self.device = torch.device(device)
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size, self.cfg.max_len)
        self.params = (
            params_from_numpy(params, self.cfg, self.device)
            if params is not None
            else init_params(self.cfg, device=self.device)
        )

    @torch.inference_mode()
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.out_dim), np.float32)
        ids, mask = self.tokenizer(texts)
        out = encode(
            self.params, self.cfg,
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(mask).to(self.device),
        )
        return out.cpu().numpy().astype(np.float32, copy=False)
