"""Readings of the compared numbers over many seeds, one process.

    python3 -m portbench.readings --workload <name> --seeds 11,12,13 --seconds 5 [--index int8]

runs the cell's set-up, window and comparison once per seed (each seed
its own collection and traffic) and prints, per seed, one JSON line with
``correct`` and the compared numbers, then one line with each number's
largest and smallest reading. With ``--index int8`` the program serves
through its own int8 vector index (``GpuConfig.vector_index="int8"``):
the control, the path a later change might take to a lower precision,
which the limits must refuse. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import cell, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--index", default=None, choices=(None, "exact", "int8"))
    ap.add_argument("--keep-every", type=int, default=None,
                    help="compare every n-th reply of a client (the mix's own "
                         "by default; 1 for the slow control)")
    ap.add_argument("--clients", type=int, default=None,
                    help="the mix's clients by default; fewer for the control, "
                         "which serves each request on its client's thread")
    args = ap.parse_args(argv)
    import torch

    c = spec.cell(args.workload)
    if args.clients:
        c.traffic["clients"] = args.clients
    serving = {"vector_index": args.index} if args.index else None
    run.log(f"card: {run.card_line()}")
    seen = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        out = cell.run_cell(c, seed, args.seconds, False, "cuda", t,
                            serving=serving, keep_every=args.keep_every,
                            log=run.log)
        line = {"seed": seed, "index": args.index or c.config["serving"]["vector_index"],
                "correct": out["correct"], "attempted": out["attempted"],
                "failed": out["failed"], "checks": out["checks"],
                "qps": out["metrics"].get("qps", {}).get("value")}
        print(json.dumps(line), flush=True)
        for k, (v, _lim) in out["checks"].items():
            seen.setdefault(k, []).append(v)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"readings": {k: {"max": max(v), "min": min(v)}
                                   for k, v in seen.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
