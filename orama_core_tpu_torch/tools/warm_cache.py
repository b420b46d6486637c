"""Pay the port's first-use costs ahead of serving.

Port of ``scripts/warm_cache.py``. The reference warms JAX's persistent
compilation cache; the port compiles no programs (it runs eagerly), so
its first-use costs are two others:

1. the kernels: every ``csrc/*.cu`` is compiled by nvcc into
   ``build/torch_kernels/`` (gitignored) the first time a process needs
   it (``ops/_cuda.build_all``, one nvcc per source, all at once); built
   here, a serving process's first query builds nothing;
2. the device caches of a committed collection (``CollectionReader.
   warmup``, ``engine/collection_read.py``): the script's representative
   collection (string + number + bool fields + auto-embedded vectors) is
   built, committed and warmed, which also checks that every structure
   uploads.

    python -m orama_core_tpu_torch.tools.warm_cache [--docs 2000] [--device cpu]

On the CPU (``--device cpu``) no kernel is built: each runs its plain
torch version there. The last line of the standard output is a JSON
summary (kernels built, kernels loaded, caches warmed, seconds).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Sequence


def build_kernels() -> Dict[str, Any]:
    """Compile the stale kernel libraries and load every one. Returns the
    names built and loaded."""
    from ..ops import _cuda

    stale = [n for n in _cuda.SIGNATURES if not _cuda._fresh(n)]
    _cuda.build_all()
    for n in _cuda.SIGNATURES:
        _cuda.lib(n)
    return {"kernels_built": stale, "kernels_loaded": list(_cuda.SIGNATURES)}


def warm(docs: int, device: str) -> Dict[str, Any]:
    from .. import build_orama, require_device
    from ..config import OramaxConfig

    dev = require_device(device)
    rec: Dict[str, Any] = {"device": str(dev), "docs": docs}
    t0 = time.perf_counter()
    if dev.type == "cuda":
        rec.update(build_kernels())
    else:
        rec.update(kernels_built=[], kernels_loaded=[])
    rec["build_s"] = time.perf_counter() - t0

    cfg = OramaxConfig()
    d = tempfile.mkdtemp()
    cfg.writer_side.data_dir = d + "/w"
    cfg.reader_side.data_dir = d + "/r"
    engine = build_orama(cfg, start_background=False, device=device)
    try:
        engine.write_side.create_collection("master", "warm", "rk", "wk")
        rows = [
            {
                "id": f"d{i}",
                "title": f"warm document {i} alpha beta",
                "body": f"gamma delta epsilon {i % 97} content body",
                "price": float(i % 100),
                "in_stock": bool(i % 2),
            }
            for i in range(docs)
        ]
        for i in range(0, len(rows), 500):
            engine.write_side.write("warm", rows[i : i + 500], "wk")
        engine.flush()
        engine.commit()
        reader = engine.read_side._reader("warm")
        t1 = time.perf_counter()
        rec["caches"] = reader.warmup(engine.read_side.ai)
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize()
        rec["warm_s"] = time.perf_counter() - t1
    finally:
        engine.close()
        shutil.rmtree(d, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m orama_core_tpu_torch.tools.warm_cache",
        description="Build the kernels and warm the device caches")
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = warm(args.docs, args.device)
    if rec["kernels_loaded"]:
        print(f"built {len(rec['kernels_built'])} kernels "
              f"({', '.join(rec['kernels_built']) or 'none stale'}), "
              f"{len(rec['kernels_loaded'])} loaded, in {rec['build_s']:.1f}s")
    else:
        print("no kernel is built for the CPU (plain torch versions)")
    print(f"warmed {rec['caches']} device caches in {rec['warm_s']:.1f}s "
          f"({rec['seconds']:.1f}s in all)")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
