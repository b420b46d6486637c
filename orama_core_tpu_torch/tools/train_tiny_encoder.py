"""Train the tiny contrastive sentence encoder and export it as an HF BERT
checkpoint, on the card.

Port of ``scripts/train_tiny_encoder.py``, with its arguments and defaults
(700 steps of batch 96, hidden 96, 2 layers, 4 heads, MLP 4 x hidden, 64
positions, f32, seed 0) and its checks: held-out topic accuracy above
0.85 (``models/train_encoder.topic_probe``) before anything is written,
then a loader round trip of cosine above 0.999 through the port's own
reader and WordPiece tokenizer. The export is the checkpoint format an
operator's BGE checkpoint has (``models/hf_loader.export_bert_checkpoint``),
written without ``safetensors`` or ``transformers``.

    python -m orama_core_tpu_torch.tools.train_tiny_encoder [--out DIR]
        [--steps 700] [--batch 96] [--hidden 96] [--layers 2] [--seed 0]
        [--device cuda]

``--out`` defaults to ``build/tiny-semantic`` under the repository root;
point ``ai.embedding_checkpoint_path`` at it to serve it. The last line of
the standard output is a JSON summary (losses, accuracies, the round-trip
cosine, ms a training step: CUDA events on the card, the host clock on
the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "tiny-semantic")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m orama_core_tpu_torch.tools.train_tiny_encoder",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Train, probe, export and round-trip; raises ``GateFailure`` when a
    check fails. Returns the summary (with the trained ``params`` and
    ``cfg`` under those keys)."""
    from .. import configure_torch, require_device
    from ..models import train_encoder as te
    from ..models.hf_loader import export_bert_checkpoint

    dev = require_device(args.device)
    configure_torch()
    vocab = te.build_vocab()
    cfg = te.train_config(len(vocab), hidden=args.hidden, layers=args.layers)
    t0 = time.perf_counter()

    def log(msg):
        print(f"{msg} ({time.perf_counter() - t0:.0f}s)", file=sys.stderr,
              flush=True)

    events = None
    if dev.type == "cuda":
        import torch

        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    params, losses = te.train(cfg, args.steps, args.batch, seed=args.seed,
                              device=dev, log=log)
    # train() returns after reading every loss, which waits for the card
    train_s = time.perf_counter() - t0
    if events is not None:
        events[1].record()
        events[1].synchronize()
        ms_per_step = events[0].elapsed_time(events[1]) / max(args.steps, 1)
    else:
        ms_per_step = train_s * 1e3 / max(args.steps, 1)
    probe = te.topic_probe(params, cfg)
    print(f"held-out retrieval@1: topic {probe['topic']:.3f} "
          f"(chance {probe['chance']:.3f}) | exact pair {probe['pair']:.3f}",
          file=sys.stderr)
    if not probe["topic"] > te.PROBE_GATE:
        raise GateFailure(
            f"encoder failed to learn topic semantics (topic acc "
            f"{probe['topic']} <= {te.PROBE_GATE})")
    export_bert_checkpoint(
        params, cfg, vocab, args.out,
        trained_by="orama_core_tpu_torch.tools.train_tiny_encoder "
        "(contrastive topic encoder; NOT BGE)")
    rt = te.roundtrip_cosine(params, cfg, args.out, dev)
    print(f"loader round-trip cosine: {rt:.5f}", file=sys.stderr)
    if not rt > 0.999:
        raise GateFailure(f"round-trip mismatch ({rt})")
    return {"out": os.path.abspath(args.out), "device": str(dev),
            "steps": args.steps, "batch": args.batch, "losses": losses,
            "probe": probe, "roundtrip_cosine": rt, "train_s": train_s,
            "ms_per_step": ms_per_step,
            "ms_clock": "cuda events" if events is not None else "host",
            "params": params, "cfg": cfg}


class GateFailure(RuntimeError):
    """A check of the trained encoder failed; nothing more is written."""


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    try:
        rec = run(args)
    except GateFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"checkpoint written to {rec['out']}")
    losses = rec["losses"]
    print(json.dumps({
        "out": rec["out"], "device": rec["device"], "steps": rec["steps"],
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "topic": rec["probe"]["topic"], "pair": rec["probe"]["pair"],
        "roundtrip_cosine": rec["roundtrip_cosine"],
        "train_s": rec["train_s"], "ms_per_step": rec["ms_per_step"],
        "ms_clock": rec["ms_clock"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
