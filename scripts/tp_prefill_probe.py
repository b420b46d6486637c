"""Where the sharded decoder's prefill spends its time, on the card.

For a 512-token prefill at Qwen2.5-3B's width (``chip_smoke.qwen_params``:
36 layers, seeded bf16 weights), on one device and with every model shard
of meshes (1, 2) and (1, 4) stacked on card 0, prints one JSON line each:

- ``wall_ms``: host clock around ``llm.forward`` and a synchronize, five
  times;
- ``enqueue_ms``: host time until ``llm.forward`` returns (the launches
  queued), five times;
- ``device_ms``: the device time of one forward (torch.profiler);
- ``synchronizes``: whether an op of the forward waits for the card
  (``torch.cuda.set_sync_debug_mode("error")`` raises at the first).

A wall time near the device time means the forward is device-bound; an
enqueue time near it means the host launches no faster than the card
runs them. Run from the repository's root on a machine with the card:

    python scripts/tp_prefill_probe.py
"""

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from orama_core_tpu_torch import configure_torch  # noqa: E402
from orama_core_tpu_torch.models import llm  # noqa: E402
from orama_core_tpu_torch.parallel.mesh import make_mesh, shard_params  # noqa: E402


def probe(name, params, cfg, ids, pos):
    cache = llm.make_cache(cfg, 1, "cuda", params=params)

    def forward():
        return llm.forward(params, cfg, ids, pos, cache, 0)

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    wall, enqueue = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        forward()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    device_ms = sum(cs._device_us(e) for e in prof.key_averages()) / 1e3
    torch.cuda.set_sync_debug_mode("error")
    try:
        forward()
        synchronizes = False
    except RuntimeError:
        synchronizes = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"layout": name, "wall_ms": wall, "enqueue_ms": enqueue,
            "device_ms": device_ms, "synchronizes": synchronizes}


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_prefill_probe: needs a CUDA card", file=sys.stderr)
        return 2
    configure_torch()
    card = cs.card_line()
    cfg, params = cs.qwen_params()
    specs = llm.param_specs(cfg, with_bias=True)
    gen = torch.Generator("cuda").manual_seed(1)
    ids = torch.randint(0, 151643, (1, 512), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos = torch.arange(512, dtype=torch.int32, device="cuda")[None]
    with torch.inference_mode():
        print(json.dumps(dict(probe("single", params, cfg, ids, pos),
                              card=card)), flush=True)
        for shape in ((1, 2), (1, 4)):
            placed = shard_params(make_mesh(shape), params, specs)
            print(json.dumps(dict(probe(str(shape), placed, cfg, ids, pos),
                                  card=card)), flush=True)
            del placed
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
