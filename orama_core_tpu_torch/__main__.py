"""Server entrypoint: ``python -m orama_core_tpu_torch [--config path]``.

Counterpart of the reference binary (`src/bin/oramacore.rs:35`): load YAML
config (+ env overrides), install tracing, build the engine, serve HTTP.

Port of ``orama_core_tpu/__main__.py``. The engine runs on the configured
device, ``gpu.device`` (the card by default; ``gpu: {device: cpu}`` in the
YAML file, or ``ORAMAX_gpu__device=cpu``, runs it on the CPU).
"""

from __future__ import annotations

import argparse
import sys

from . import build_orama
from .config import OramaxConfig
from .utils import tracing


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="orama_core_tpu_torch",
        description="Index-and-query engine on PyTorch and CUDA",
    )
    parser.add_argument(
        "--config", default=None, help="YAML config path (or CONFIG_PATH env)"
    )
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args(argv)

    cfg = OramaxConfig.load(args.config)
    if args.host:
        cfg.http.host = args.host
    if args.port:
        cfg.http.port = args.port

    tracing.configure(cfg.log.level, cfg.log.file_path)
    tracing.log("info", "booting oramax", version="0.1.0",
                device=cfg.gpu.device)
    orama = build_orama(cfg, start_background=True)
    from .server.http import serve

    try:
        serve(orama, cfg.http)
    except KeyboardInterrupt:
        tracing.log("info", "shutting down: committing both sides")
        orama.commit()
        orama.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
