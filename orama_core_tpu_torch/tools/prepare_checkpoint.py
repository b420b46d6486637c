"""Validate a local HuggingFace checkpoint for use with the port.

Port of ``scripts/prepare_checkpoint.py``. Checkpoints are prepared on a
machine with network access and dropped on local disk, e.g.

    hf download BAAI/bge-small-en-v1.5 --local-dir /ckpts/bge-small
    hf download Qwen/Qwen2.5-3B-Instruct --local-dir /ckpts/qwen2.5-3b

then the engine is pointed at the directory:

    ai:
      backend: jax
      embedding_model: bge-small
      embedding_checkpoint_path: /ckpts    # dir of per-model subdirs
                                           # (or one checkpoint dir)
      # hf_model_path: /ckpts/qwen2.5-3b   # answer-model (LLM) checkpoint

This tool loads the directory through the port's ``models/hf_loader.py``
(BERT-family encoders, Qwen2/LLaMA-family decoders; neither
``safetensors`` nor ``transformers`` is needed for an encoder), runs one
smoke forward on the card (or the CPU with ``--device cpu``) and prints
the config stanza.

    python -m orama_core_tpu_torch.tools.prepare_checkpoint PATH [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m orama_core_tpu_torch.tools.prepare_checkpoint",
        description="Validate a local HF checkpoint for the port")
    ap.add_argument("path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    path = args.path

    import torch

    from .. import configure_torch, require_device

    dev = require_device(args.device)
    configure_torch()
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        print(f"FAIL: no config.json in {path}")
        return 1
    with open(cfg_path) as f:
        hf = json.load(f)
    archs = hf.get("architectures", [])
    arch = archs[0] if archs else hf.get("model_type", "?")
    print(f"architecture: {arch}")

    is_decoder = any(
        a in str(arch).lower() for a in ("causallm", "qwen", "llama")
    )
    ids = torch.arange(1, 9, device=dev)[None, :]
    if is_decoder:
        from ..models import llm
        from ..models.hf_loader import load_llm_checkpoint

        loaded = load_llm_checkpoint(path)
        if loaded is None:
            print("FAIL: decoder checkpoint did not load (missing weights?)")
            return 1
        cfg, params, tok = loaded
        print(
            f"loaded decoder: hidden={cfg.hidden} layers={cfg.layers} "
            f"heads={cfg.heads}/{cfg.kv_heads} vocab={cfg.vocab_size} "
            f"biases={'yes' if 'bq' in params['layers'][0] else 'no'} "
            f"tokenizer={type(tok).__name__}"
        )
        params = llm.params_from_numpy(params, cfg, dev)
        pos = torch.arange(8, dtype=torch.int32, device=dev)[None, :]
        with torch.inference_mode():
            logits, _ = llm.forward(params, cfg, ids, pos, None, 0)
        print(f"smoke forward ok: logits {tuple(logits.shape)}")
        print("\nconfig.yaml stanza:\n  ai:\n    backend: jax\n"
              f"    llm_model: {os.path.basename(path)}\n"
              f"    hf_model_path: {os.path.abspath(path)}")
    else:
        from ..models import encoder as enc
        from ..models.hf_loader import load_encoder_checkpoint

        loaded = load_encoder_checkpoint(path)
        if loaded is None:
            print("FAIL: encoder checkpoint did not load (missing weights?)")
            return 1
        cfg, params = loaded
        print(
            f"loaded encoder: hidden={cfg.hidden} layers={cfg.layers} "
            f"heads={cfg.heads} vocab={cfg.vocab_size} out_dim={cfg.out_dim}"
        )
        params = enc.params_from_numpy(params, cfg, dev)
        mask = torch.ones((1, 8), device=dev)
        with torch.inference_mode():
            out = enc.encode(params, cfg, ids, mask)
        n = float(torch.linalg.vector_norm(out[0]))
        print(f"smoke forward ok: embedding {tuple(out.shape)}, L2 norm {n:.4f}")
        print("\nconfig.yaml stanza:\n  ai:\n    backend: jax\n"
              f"    embedding_model: {os.path.basename(path)}\n"
              f"    embedding_checkpoint_path: {os.path.abspath(path)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
