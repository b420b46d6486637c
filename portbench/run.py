"""Run one cell of the benchmark on this machine's card and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Stdout's last line is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` when traced) and, last, ``checks``: each compared number
beside its limit. Stderr's last lines give the same numbers. With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a torch.profiler trace of the
window. The run exits non-zero and prints no result when there is no CUDA
card, fewer cards than the cell asks for, or when ``jax``, ``jaxlib``,
``flax`` or ``orama_core_tpu`` has been imported by the time the window
has closed.

The program builds its kernels into ``build/torch_kernels`` inside the
checkout (``orama_core_tpu_torch/ops/_cuda.py``), so that only a
checkout's first run builds.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "orama_core_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not read"


def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench import cell as cell_mod
    from portbench import spec

    c = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: nothing measured")
        return 2
    if torch.cuda.device_count() < c.chips:
        log(f"{c.name} needs {c.chips} cards, this machine has "
            f"{torch.cuda.device_count()}")
        return 2
    log(f"card: {card_line()}; host MemAvailable {mem_available_gib():.1f} GiB")
    out = cell_mod.run_cell(c, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}; no result")
        return 3
    for name, (value, limit) in out["checks"].items():
        log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
