"""Decoder-only LLM: the answer model, on the card.

Port of ``orama_core_tpu/models/llm.py``: the same Qwen/LLaMA-family
decoder (RMSNorm, rotary embeddings on split halves, SwiGLU MLP,
grouped-query attention, optional q/k/v biases) over a parameter dict,
with the reference's static KV cache and its per-row position array
(``forward``), and greedy or sampled decode (``generate``) as a Python
loop over the same state the reference carries through ``lax.while_loop``.

Numerics follow the reference's ``forward`` (:121-208): activations and
weights in ``cfg.dtype`` (bf16), norms' variance, rotary angles,
attention logits and softmax in f32, ``lm_head`` in f32. Attention
logits are bf16 x bf16 products accumulated in f32, computed here as an
f32 product of the upcast operands (the same products, exact in f32).
Grouped-query attention indexes the KV head of query head h as
h // (heads / kv_heads), as the reference's ``jnp.repeat`` does, through
a grouped view of the queries instead of a copy of the cache. The cache
is updated in place (the reference returns a new one).

No TPU kernel is on this path (the reference computes it outside Pallas):
plain torch products, softmax and elementwise ops. Weights: random by
default; real checkpoints load via models/hf_loader.py. Tokenization:
byte-level fallback, the HF tokenizer when a checkpoint is loaded.

Tensor parallelism: ``param_specs`` is the reference's Megatron layout
(:85-99), and ``forward``, ``make_cache`` and ``generate`` take
parameters placed by it (``parallel.mesh.shard_params``) as well as plain
ones. Each model shard computes attention for the q heads its columns
touch, after gathering the columns of the KV heads they use when its own
k/v columns are not those heads (grouped-query attention over more
shards than KV heads gives a shard part of a KV head, and rotary
embedding needs the whole head); its cache holds those KV heads. The
``wo`` and ``w_down`` partials are summed over ``model``; ``tok_emb``,
the norms and ``lm_head`` are replicated (models/tp.py). The batch is
not split over ``data`` (the reference replicates the prompt): the first
data row of the mesh computes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import P
from . import tp
from .checkpoint import as_param


@dataclasses.dataclass(frozen=True)
class LlmConfig:
    vocab_size: int = 512        # byte-level default: 256 bytes + specials
    hidden: int = 256
    layers: int = 4
    heads: int = 8
    kv_heads: int = 4
    mlp: int = 1024
    max_len: int = 1024
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


TINY = LlmConfig()


def params_from_numpy(tree: Dict[str, Any], cfg: LlmConfig,
                      device="cuda") -> Dict[str, Any]:
    """The reference's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``, or as tensors) -> the port's
    parameters on ``device`` (the card unless the caller names another):
    everything the reference casts to ``cfg.dtype`` at use (embeddings,
    norms, weights, biases) is stored in it; ``lm_head`` stays f32 (the
    reference's f32 output product)."""
    dt = cfg.dtype
    return {
        "tok_emb": as_param(tree["tok_emb"], device, dt),
        "out_norm": as_param(tree["out_norm"], device, dt),
        "lm_head": as_param(tree["lm_head"], device, torch.float32),
        "layers": [
            {k: as_param(v, device, dt) for k, v in layer.items()}
            for layer in tree["layers"]
        ],
    }


def init_params(cfg: LlmConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters (normal, std 0.02; unit norms) drawn from
    ``generator`` on its own device (a CPU generator seeded 0 by default)
    and placed on ``device`` in their storage types. Each matrix is drawn
    in f32 and cast at once, so a full-width model made on the card holds
    one f32 matrix at a time."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    s = 0.02
    dt = cfg.dtype

    def mat(i, o, dtype=dt):
        m = torch.randn((i, o), generator=g, device=g.device) * s
        return m.to(device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dt)

    hd = cfg.head_dim
    params: Dict[str, Any] = {
        "tok_emb": mat(cfg.vocab_size, cfg.hidden),
        "out_norm": ones(cfg.hidden),
        "lm_head": mat(cfg.hidden, cfg.vocab_size, torch.float32),
        "layers": [],
    }
    for _ in range(cfg.layers):
        params["layers"].append(
            {
                "ln1": ones(cfg.hidden),
                "wq": mat(cfg.hidden, cfg.heads * hd),
                "wk": mat(cfg.hidden, cfg.kv_heads * hd),
                "wv": mat(cfg.hidden, cfg.kv_heads * hd),
                "wo": mat(cfg.heads * hd, cfg.hidden),
                "ln2": ones(cfg.hidden),
                "w_gate": mat(cfg.hidden, cfg.mlp),
                "w_up": mat(cfg.hidden, cfg.mlp),
                "w_down": mat(cfg.mlp, cfg.hidden),
            }
        )
    return params


def param_specs(cfg: LlmConfig, with_bias: bool = False) -> Dict[str, Any]:
    """Partition specs for tensor parallelism over ``model``, the
    reference's tree (:85-99): wq/wk/wv/w_gate/w_up split by column
    (``bq``/``bk``/``bv`` with their columns), wo/w_down by row, the
    embeddings, norms and ``lm_head`` replicated."""
    col = P(None, "model")
    row = P("model", None)
    layer = {
        "ln1": P(), "wq": col, "wk": col, "wv": col, "wo": row,
        "ln2": P(), "w_gate": col, "w_up": col, "w_down": row,
    }
    if with_bias:
        layer = dict(layer, bq=P("model"), bk=P("model"), bv=P("model"))
    return {
        "tok_emb": P(),
        "out_norm": P(),
        "lm_head": P(),
        "layers": [layer for _ in range(cfg.layers)],
    }


def _rms(x, g, eps=1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * g.to(x.dtype)


def _rope(x, positions, theta):
    # x: [B, T, H, hd]
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def forward(
    params: Dict[str, Any],
    cfg: LlmConfig,
    ids: torch.Tensor,        # int[B, T]
    positions: torch.Tensor,  # int32[B, T]
    kv_cache,
    cache_len: int,           # tokens already in cache
):
    """Returns (logits f32 [B, T, V], kv cache). With a cache, keys/values
    and positions are written in place at [cache_len, cache_len+T) and
    attention spans the full cache with position masking; without one the
    cache returned is the per-layer (k, v) list of this call. Placed
    parameters (``param_specs``) take the sharded forward, with a cache
    from ``make_cache(..., params=params)``."""
    if tp.is_sharded(params):
        return _forward_sharded(params, cfg, ids, positions, kv_cache,
                                cache_len)
    dt = cfg.dtype
    b, t = ids.shape
    hd = cfg.head_dim
    kvh = cfg.kv_heads
    rep = cfg.heads // kvh
    x = params["tok_emb"][ids.long()].to(dt)
    new_kv: List[Tuple[torch.Tensor, torch.Tensor]] = []

    # Cache layout: (per-layer kv list, positions int32[B, max_len]). The
    # positions array records each written slot's TOKEN position per row —
    # slot index alone is wrong the moment a batch has unequal prompt
    # lengths (a short row's kv lands at the batch-wide slot while its
    # query position is row-local; a slot-causal mask then hides the
    # token's own history and exposes pad kv). Unwritten slots hold
    # _POS_UNWRITTEN and can never pass the causal test.
    if kv_cache is not None:
        kv_list, pos_cache = kv_cache
        pos_cache[:, cache_len:cache_len + t] = positions
    else:
        kv_list, pos_cache = None, None

    for li, layer in enumerate(params["layers"]):
        h = _rms(x, layer["ln1"], cfg.rms_eps)
        q = h @ layer["wq"].to(dt)
        k = h @ layer["wk"].to(dt)
        v = h @ layer["wv"].to(dt)
        # Qwen2-family attention projections carry biases (q/k/v only)
        if "bq" in layer:
            q = q + layer["bq"].to(dt)
            k = k + layer["bk"].to(dt)
            v = v + layer["bv"].to(dt)
        q = q.reshape(b, t, cfg.heads, hd)
        k = k.reshape(b, t, kvh, hd)
        v = v.reshape(b, t, kvh, hd)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)

        if kv_list is not None:
            ck, cv = kv_list[li]  # [B, max_len, KVH, hd]
            ck[:, cache_len:cache_len + t] = k
            cv[:, cache_len:cache_len + t] = v
            new_kv.append((ck, cv))
            k_all, v_all = ck, cv
            kv_positions = pos_cache  # [B, max_len] per-row position values
        else:
            k_all, v_all = k, v
            kv_positions = positions
            new_kv.append((k, v))

        # query head g * rep + r attends KV head g (jnp.repeat's order)
        qg = q.reshape(b, t, kvh, rep, hd)
        logits = torch.einsum(
            "btgrd,bkgd->bgrtk", qg.float(), k_all.float()
        ) / math.sqrt(hd)
        # causal mask over per-row kv POSITION VALUES: unwritten slots (and
        # prompt pads, which callers tag _POS_UNWRITTEN) can never pass
        causal = kv_positions[:, None, :] <= positions[:, :, None]  # [B, T, K]
        logits = logits.masked_fill(~causal[:, None, None, :, :], -1e9)
        attn = torch.softmax(logits, dim=-1).to(dt)
        ctx = torch.einsum("bgrtk,bkgd->btgrd", attn, v_all).reshape(b, t, -1)
        x = x + ctx @ layer["wo"].to(dt)

        h = _rms(x, layer["ln2"], cfg.rms_eps)
        gate = F.silu(h @ layer["w_gate"].to(dt))
        up = h @ layer["w_up"].to(dt)
        x = x + (gate * up) @ layer["w_down"].to(dt)

    x = _rms(x, params["out_norm"], cfg.rms_eps)
    logits = x.float() @ params["lm_head"].float()
    if kv_list is not None:
        return logits, (new_kv, pos_cache)
    return logits, new_kv


def _plan(params, cfg: LlmConfig) -> tp.HeadPlan:
    return tp.head_plan(cfg.heads, cfg.kv_heads, cfg.head_dim,
                        params["tok_emb"].layout.n_model)


def _forward_sharded(params, cfg: LlmConfig, ids, positions, kv_cache,
                     cache_len: int):
    """``forward`` over placed parameters: the local bodies of the first
    data row's units (models/tp.py); logits on the ids' device."""
    dt = cfg.dtype
    layout = params["tok_emb"].layout
    uids = layout.rows[0]
    units = tp.units_of(layout, uids)
    u0, d0 = uids[0], units[0].device
    plan = _plan(params, cfg)
    t = ids.shape[1]
    x = params["tok_emb"].parts[u0][ids.to(d0).long()].to(dt)
    pos_u = tp.spread(positions, units)
    if kv_cache is not None:
        kv_list, pos_caches = kv_cache
        for pc in {id(pc): pc for pc in pos_caches}.values():
            pc[:, cache_len:cache_len + t] = positions.to(pc.device)
    new_kv = []
    for li, layer in enumerate(params["layers"]):
        hs = tp.spread(_rms(x, layer["ln1"].parts[u0], cfg.rms_eps), units)
        q, k, v = (
            tp.col(hs, layer[w], uids, dt, layer.get(bn))
            for w, bn in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))
        )
        q = tp.heads(q, units, plan, "q")
        k = tp.heads(k, units, plan, "kv")
        v = tp.heads(v, units, plan, "kv")
        ctxs, layer_kv = [], []
        for j, u in enumerate(units):
            qj = _rope(q[j], pos_u[j], cfg.rope_theta)
            kj = _rope(k[j], pos_u[j], cfg.rope_theta)
            if kv_cache is not None:
                ck, cv = kv_list[li][j]  # [m, B, max_len, nkv, hd]
                ck[:, :, cache_len:cache_len + t] = kj
                cv[:, :, cache_len:cache_len + t] = v[j]
                layer_kv.append((ck, cv))
                k_all, v_all, kv_pos = ck, cv, pos_caches[j]
            else:
                layer_kv.append((kj, v[j]))
                k_all, v_all, kv_pos = kj, v[j], pos_u[j]
            ctx = _attend(qj, k_all, v_all, kv_pos, pos_u[j], plan, u, dt)
            ctxs.append(tp.own_cols(ctx, u, plan))
        new_kv.append(layer_kv)
        x = (x.float() + tp.row_sum(ctxs, layer["wo"], uids, dt, d0)).to(dt)

        hs = tp.spread(_rms(x, layer["ln2"].parts[u0], cfg.rms_eps), units)
        gate = [F.silu(g) for g in tp.col(hs, layer["w_gate"], uids, dt)]
        up = tp.col(hs, layer["w_up"], uids, dt)
        x = (x.float() + tp.row_sum([g * a for g, a in zip(gate, up)],
                                    layer["w_down"], uids, dt, d0)).to(dt)

    x = _rms(x, params["out_norm"].parts[u0], cfg.rms_eps)
    logits = (x.float() @ params["lm_head"].parts[u0].float()).to(ids.device)
    if kv_cache is not None:
        return logits, (new_kv, pos_caches)
    return logits, new_kv


def _attend(q, k_all, v_all, kv_positions, positions, plan: tp.HeadPlan,
            unit, dt):
    """One unit's attention: q ``[m, B, T, nq, hd]`` over its KV heads
    ``[m, B, K, nkv, hd]``, as ``forward`` computes it; returns the
    context ``[m, B, T, nq * hd]``."""
    m, b, t, nq, hd = q.shape
    if not plan.group:  # q heads take their KV heads out of runs: copy
        idx = plan.index("q_to_kv", unit)
        pick = lambda a: torch.stack(  # noqa: E731
            [a[j][:, :, idx[j]] for j in range(m)])
        k_all, v_all = pick(k_all), pick(v_all)
        g, r = nq, 1
    else:
        g, r = nq // plan.group, plan.group
    qg = q.reshape(m, b, t, g, r, hd)
    logits = torch.einsum(
        "mbtgrd,mbkgd->mbgrtk", qg.float(), k_all.float()) / math.sqrt(hd)
    causal = kv_positions[:, None, :] <= positions[:, :, None]  # [B, T, K]
    logits = logits.masked_fill(~causal[:, None, None, :, :], -1e9)
    attn = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("mbgrtk,mbkgd->mbtgrd", attn, v_all).reshape(
        m, b, t, nq * hd)


_POS_UNWRITTEN = 2**30


def make_cache(cfg: LlmConfig, batch: int, device="cuda", params=None):
    """(per-layer kv list, per-row slot-position array) on ``device`` —
    see forward(). For placed ``params``: per layer, one (k, v) pair per
    unit of the first data row, ``[m, B, max_len, nkv, hd]`` (what each
    shard's attention reads: its KV heads), and one position array per
    unit (shared on a device)."""
    if params is not None and tp.is_sharded(params):
        layout = params["tok_emb"].layout
        units = tp.units_of(layout, layout.rows[0])
        nkv = _plan(params, cfg).nkv
        kv = [[tuple(torch.zeros((u.m, batch, cfg.max_len, nkv,
                                  cfg.head_dim), dtype=cfg.dtype,
                                 device=u.device) for _ in range(2))
               for u in units] for _ in range(cfg.layers)]
        pos = tp.spread(torch.full((batch, cfg.max_len), _POS_UNWRITTEN,
                                   dtype=torch.int32), units)
        return kv, pos
    shape = (batch, cfg.max_len, cfg.kv_heads, cfg.head_dim)
    kv = [
        (torch.zeros(shape, dtype=cfg.dtype, device=device),
         torch.zeros(shape, dtype=cfg.dtype, device=device))
        for _ in range(cfg.layers)
    ]
    pos = torch.full((batch, cfg.max_len), _POS_UNWRITTEN, dtype=torch.int32,
                     device=device)
    return kv, pos


@torch.inference_mode()
def generate(
    params, cfg: LlmConfig, prompt_ids: torch.Tensor, prompt_len: torch.Tensor,
    max_new: int, eos_id: int, temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Decode: prefill the padded prompt, then one-token steps with the
    static KV cache until ``max_new`` tokens or every row has hit EOS.
    Returns int32[B, max_new] on the prompt's device.

    temperature <= 0 is greedy argmax; otherwise softmax sampling at the
    given temperature from ``generator`` (the reference serves
    temperature=0.1 sampling, service/models.py:100,117,146)."""
    device = prompt_ids.device
    b, pt = prompt_ids.shape
    prompt_len = prompt_len.to(device=device, dtype=torch.int32)
    cache = make_cache(cfg, b, device, params)
    # right-pad slots get _POS_UNWRITTEN so no later query can attend a pad
    # token's kv (rows with shorter prompts than the padded width)
    arange_pt = torch.arange(pt, dtype=torch.int32, device=device)[None, :]
    positions = torch.where(
        arange_pt < prompt_len[:, None], arange_pt,
        torch.full_like(arange_pt, _POS_UNWRITTEN),
    )
    logits, cache = forward(params, cfg, prompt_ids, positions, cache, 0)
    # logits at the last real prompt token
    last = logits[torch.arange(b, device=device), prompt_len.long() - 1]

    def pick(lg):
        if temperature and temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            return torch.multinomial(
                probs, 1, generator=generator).squeeze(-1).to(torch.int32)
        return lg.argmax(-1).to(torch.int32)

    first_tok = pick(last)
    # init with EOS, not zeros: when decode finishes early the tail slots
    # must decode to nothing (zeros decoded as NUL bytes / '!' tokens)
    out = torch.full((b, max_new), eos_id, dtype=torch.int32, device=device)
    out[:, 0] = first_tok
    done = first_tok == eos_id
    i = 0
    while i < max_new - 1 and not bool(done.all()):
        tok = out[:, i:i + 1]
        # per-row rotary position; the kv SLOT is the batch-uniform pt+i —
        # the pos-tracked cache (forward) reconciles the two
        pos = (prompt_len + i)[:, None]
        logits, cache = forward(params, cfg, tok, pos, cache, pt + i)
        nxt = pick(logits[:, 0])
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        out[:, i + 1] = nxt
        done = done | (nxt == eos_id)
        i += 1
    return out


class ByteTokenizer:
    """Reversible byte-level tokenizer (ids 0..255 = bytes; 256 = BOS,
    257 = EOS). Lets the decode machinery run with random weights and no
    vocab files."""

    BOS, EOS = 256, 257
    vocab_size = 512

    def encode(self, text: str) -> List[int]:
        return [self.BOS] + list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        data = bytes(int(i) for i in ids if int(i) < 256)
        return data.decode("utf-8", errors="replace")


class ChatLLM:
    """AIService chat backend over the decoder on ``device``, with the
    reference's per-role prompt framing (prompts/main.py). Port of
    ``JaxChatLLM`` (orama_core_tpu/models/llm.py:304-351): TINY with random
    weights (a CPU generator seeded 0), or a local checkpoint at
    ``hf_path``."""

    def __init__(
        self,
        model_name: str = "jax-tiny",
        hf_path: Optional[str] = None,
        temperature: float = 0.0,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.cfg = TINY
        self.temperature = float(temperature)
        self.tokenizer = ByteTokenizer()
        loaded = None
        if hf_path:
            from .hf_loader import load_llm_checkpoint

            loaded = load_llm_checkpoint(hf_path)
        if loaded is not None:
            self.cfg, tree, self.tokenizer = loaded
            self.params = params_from_numpy(tree, self.cfg, self.device)
        else:
            self.params = init_params(self.cfg, device=self.device)

    def _generate_text(self, prompt: str, max_new: int = 64) -> str:
        ids = self.tokenizer.encode(prompt)[-(self.cfg.max_len - max_new):]
        pt = max(8, 1 << (len(ids) - 1).bit_length())
        pt = min(pt, self.cfg.max_len - max_new)
        padded = np.zeros((1, pt), np.int32)
        padded[0, : len(ids)] = ids[:pt]
        gen = None
        if self.temperature > 0:
            gen = torch.Generator(self.device).manual_seed(
                int(np.random.randint(0, 2**31 - 1)))
        out = generate(
            self.params, self.cfg,
            torch.from_numpy(padded).to(self.device),
            torch.tensor([min(len(ids), pt)], dtype=torch.int32),
            max_new=max_new, eos_id=self.tokenizer.EOS,
            temperature=self.temperature, generator=gen,
        )
        return self.tokenizer.decode(out[0].cpu().tolist())

    def chat(self, role: str, prompt: str, context: str = "") -> str:
        from .prompts import render

        return self._generate_text(render(role, prompt, context))

    def chat_stream(self, role: str, prompt: str, context: str = "") -> Iterator[str]:
        text = self.chat(role, prompt, context)
        for i in range(0, len(text), 16):
            yield text[i : i + 16]
