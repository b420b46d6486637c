"""Embedding throughput benchmark.

    python -m orama_core_tpu_torch.tools.embed_bench [--batch 64]
        [--seq 128] [--iters 30] [--device cpu]

Port of ``benchmarks/embed_bench.py``. The reference engine's only
concrete published number (BASELINE.md): "up to 1,200 embeddings per
second" on an RTX 4080 Super (fastembed / ONNX). This measures the
port's encoder (``models/encoder.py``) at BGE-small's width (12 layers,
384 hidden, 33M parameters, bf16) on one card: ``iters`` back-to-back
forwards of a ``[batch, seq]`` batch of token ids (``default_rng(0)``)
after a warm-up forward, host clock closed by a synchronise.

The parameters are drawn from an explicit ``torch.Generator`` (seed 0;
normal, std 0.02), the same distribution as the script's
``init_params`` from ``jax.random``, not the same values. Prints one
JSON line, ``{"metric": "embeddings_per_sec_bge_small_seq<L>", "value",
"unit": "embeddings/s", "vs_reference_rtx4080"}`` (unrounded); the card's
name and power limit go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .timing import card_line, log, timed_qps

# BGE-small-en-v1.5's width
BGE_SMALL = dict(vocab_size=30522, hidden=384, layers=12, heads=12, mlp=1536,
                 max_len=512, out_dim=384)
REFERENCE_RATE = 1200.0  # embeddings/s, BASELINE.md (RTX 4080 Super)


def embed_rate(params, cfg, ids: torch.Tensor, mask: torch.Tensor,
               iters: int) -> float:
    """Embeddings/s of ``iters`` forwards of ``ids`` after a warm-up one
    (host clock, closed by a synchronise on the card)."""
    from ..models import encoder as enc

    with torch.inference_mode():
        eps, ms = timed_qps(lambda: enc.encode(params, cfg, ids, mask),
                            ids.shape[0], iters, ids.device)
    log(f"{iters} x {ids.shape[0]} texts (seq {ids.shape[1]}): {ms:.3f} ms "
        "a batch")
    return eps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="orama_core_tpu_torch.tools.embed_bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import configure_torch, require_device
    from ..models import encoder as enc

    dev = require_device(args.device)
    configure_torch()
    cfg = enc.EncoderConfig(**BGE_SMALL)
    params = enc.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    log(f"device: {card_line(dev)}, model: L{cfg.layers} H{cfg.hidden} "
        "(BGE-small width)")
    b, seq = args.batch, args.seq
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (b, seq)), dtype=torch.int32, device=dev)
    mask = torch.ones(b, seq, dtype=torch.float32, device=dev)
    eps = embed_rate(params, cfg, ids, mask, args.iters)
    print(json.dumps({
        "metric": f"embeddings_per_sec_bge_small_seq{seq}",
        "value": eps,
        "unit": "embeddings/s",
        "vs_reference_rtx4080": eps / REFERENCE_RATE,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
