"""Tensor parallelism of the encoder and the decoder over the mesh's
``model`` axis: the layout's head plan and the pieces of a local body.

The reference shards its models with ``param_specs`` (Megatron layout:
q/k/v/up/gate split by column, o/down split by row) and lets GSPMD run
each shard's part and insert the collectives. The port runs that layout
itself, single-controller as ``parallel/`` runs the engine's mesh: a
parameter placed by ``parallel.mesh.shard_params`` holds, per ``Unit``
(the model shards of a data row on one device), its shards stacked
``[m, ...]``, and a local body runs once per unit over the stack:

- a column-split product is one batched product per unit, ``[m, B, T,
  c]`` (c = columns / M);
- a row-split product gives f32 partials ``[m, B, T, H]``; they are
  summed over the stack and over the units on the run's first device
  (the ``psum``), and a replicated bias is added once, after the sum;
- norms, embeddings, residuals and the output head are replicated: they
  run once, on the run's first device, and their result goes to every
  other device of the run.

Attention needs whole heads: rotary embedding turns a head's two halves
against each other, and a logit sums over a whole head. Where a shard's
q or k/v columns are not whole heads (M does not divide the head count,
or grouped-query attention gives a shard part of a KV head), the shard
gathers the columns of the heads it reads from all shards before the
rotary step (``HeadPlan``), and after attention keeps only its own
columns of the context for its rows of the row-split output product.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import torch

from ..parallel.mesh import Placed, TPLayout, Unit


class HeadPlan:
    """Which heads model shard m computes attention for. Shard m holds
    columns ``[m * cq, (m + 1) * cq)`` of the q projection (cq = heads *
    hd / M) and ``[m * ck, (m + 1) * ck)`` of k and v (ck = kv_heads * hd
    / M). Its q heads are those its q columns touch (``q_heads[m]``,
    padded to one length ``nq`` by repeating the last); its columns are
    ``q_cols[m]`` of theirs. Its KV heads are those its q heads use
    (head h uses KV head h // (heads / kv_heads)), padded to ``nkv``.
    ``q_local`` / ``kv_local``: the shard's columns are exactly those
    heads, so no gather is needed. ``group``: the q heads of every shard
    take its KV heads in runs of ``group`` (grouped attention without a
    copy); else ``q_to_kv[m]`` maps each q head to its KV head."""

    def __init__(self, heads: int, kv_heads: int, hd: int, M: int) -> None:
        q_cols, k_cols = heads * hd, kv_heads * hd
        if q_cols % M or k_cols % M:
            raise ValueError(f"{M} model shards do not divide {q_cols} q "
                             f"or {k_cols} k/v columns")
        if heads % kv_heads:
            raise ValueError(f"{heads} heads over {kv_heads} KV heads")
        self.M, self.hd = M, hd
        cq, ck = q_cols // M, k_cols // M
        rep = heads // kv_heads
        q_heads = [list(range(m * cq // hd, ((m + 1) * cq - 1) // hd + 1))
                   for m in range(M)]
        kv_heads_m = [sorted({h // rep for h in hs}) for hs in q_heads]
        q_off = [m * cq - q_heads[m][0] * hd for m in range(M)]
        self.q_cols = [list(range(o, o + cq)) for o in q_off]
        self.cq, self.ck = cq, ck
        self.q_local = cq % hd == 0
        self.kv_local = ck % hd == 0 and all(
            kv == list(range(m * ck // hd, (m + 1) * ck // hd))
            for m, kv in enumerate(kv_heads_m))
        self.nq = max(len(h) for h in q_heads)
        self.nkv = max(len(h) for h in kv_heads_m)
        q_to_kv = [[kv.index(h // rep) for h in hs]
                   for hs, kv in zip(q_heads, kv_heads_m)]
        self.q_heads = [h + [h[-1]] * (self.nq - len(h)) for h in q_heads]
        self.kv_heads = [h + [h[-1]] * (self.nkv - len(h))
                         for h in kv_heads_m]
        self.q_to_kv = [t + [t[-1]] * (self.nq - len(t)) for t in q_to_kv]
        r = self.nq // self.nkv
        self.group = r if all(
            t == [j // r for j in range(self.nq)] for t in self.q_to_kv
        ) and self.nq % self.nkv == 0 else 0
        self._index: Dict[tuple, torch.Tensor] = {}

    def index(self, name: str, unit: Unit) -> torch.Tensor:
        """``getattr(self, name)[m0:m1]`` of a unit's shards as a tensor on
        its device, made once: an upload per call would wait on the
        stream."""
        key = (name, unit.m0, unit.m1, str(unit.device))
        t = self._index.get(key)
        if t is None:
            t = torch.tensor(getattr(self, name)[unit.m0:unit.m1],
                             device=unit.device)
            self._index[key] = t
        return t


@functools.lru_cache(maxsize=None)
def head_plan(heads: int, kv_heads: int, hd: int, M: int) -> HeadPlan:
    return HeadPlan(heads, kv_heads, hd, M)


def units_of(layout: TPLayout, uids: Sequence[int]) -> List[Unit]:
    return [layout.units[i] for i in uids]


def spread(x: torch.Tensor, units: Sequence[Unit]) -> List[torch.Tensor]:
    """A replicated activation on every unit's device (one copy a
    device; none where it already lies)."""
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for u in units:
        if u.device not in copies:
            copies[u.device] = x.to(u.device)
        out.append(copies[u.device])
    return out


def col(xs: Sequence[torch.Tensor], w: Placed, uids: Sequence[int], dt,
        b: Placed = None, f32: bool = False) -> List[torch.Tensor]:
    """Column-split product per unit, ``[m, B, T, c]``, plus the split
    bias: in ``dt`` (the decoder's), or with ``f32`` the product in f32
    and the f32 bias added (the encoder's ``_dense``)."""
    out = []
    for x, i in zip(xs, uids):
        # tokens flattened: one batched product over the stack, the
        # activations shared by every shard's product (no copy)
        y = torch.matmul(x.to(dt).reshape(1, -1, x.shape[-1]),
                         w.parts[i].to(dt)).reshape(
                             (-1,) + x.shape[:-1] + (w.parts[i].shape[-1],))
        if f32:
            y = y.float()
        if b is not None:
            y = y + b.parts[i].to(y.dtype)[:, None, None, :]
        out.append(y)
    return out


def row_sum(parts: Sequence[torch.Tensor], w: Placed, uids: Sequence[int],
            dt, root: torch.device) -> torch.Tensor:
    """Row-split product: each unit's f32 partials ``[m, B, T, H]``
    summed over its shards, then over the units on ``root``."""
    total = None
    for a, i in zip(parts, uids):
        p = torch.matmul(a.to(dt).reshape(a.shape[0], -1, a.shape[-1]),
                         w.parts[i].to(dt)).float().sum(0)
        p = p.reshape(a.shape[1:-1] + p.shape[-1:])
        total = p.to(root) if total is None else total + p.to(root)
    return total


def _gather_cols(parts: Sequence[torch.Tensor], root) -> torch.Tensor:
    """All shards' columns ``[m, B, T, c]`` of the units, in shard order,
    as one ``[B, T, M * c]`` on ``root``."""
    st = parts[0] if len(parts) == 1 else torch.cat(
        [p.to(root) for p in parts])
    return st.permute(1, 2, 0, 3).reshape(st.shape[1], st.shape[2], -1)


def heads(parts: Sequence[torch.Tensor], units: Sequence[Unit],
          plan: HeadPlan, kind: str) -> List[torch.Tensor]:
    """Per unit ``[m, B, T, n, hd]``: shard m's q heads (``kind`` "q") or
    KV heads ("kv"). Where the shards' columns are those heads this is a
    view; otherwise every shard's columns are gathered first."""
    if plan.q_local if kind == "q" else plan.kv_local:
        return [p.reshape(p.shape[:3] + (-1, plan.hd)) for p in parts]
    full = _gather_cols(parts, units[0].device)
    full = full.reshape(full.shape[:2] + (-1, plan.hd))
    return [full.to(u.device)[:, :, plan.index(kind + "_heads", u)]
            .movedim(2, 0) for u in units]


def own_cols(ctx: torch.Tensor, unit: Unit, plan: HeadPlan) -> torch.Tensor:
    """A unit's context ``[m, B, T, nq * hd]`` cut to each shard's own q
    columns ``[m, B, T, cq]``, the rows of its output product."""
    if plan.q_local:
        return ctx
    idx = plan.index("q_cols", unit)
    return torch.gather(ctx, -1, idx[:, None, None, :].expand(
        ctx.shape[:3] + (plan.cq,)))


def is_sharded(params) -> bool:
    return isinstance(params.get("tok_emb"), Placed)
