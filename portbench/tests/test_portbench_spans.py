"""The per-layer metrics that read the program's own spans
(``portbench/spans.py``), read from a traced run of each cell at the small
sizes of ``small.py`` on the CPU.

The CPU run has no device trace and no CUDA stream: ``idle_in_fill_pct``
(device idle inside the batcher's fill) and ``fused_vector_ms_per_query``,
``fused_rank_ms_per_query`` (CUDA event pairs) read None there, and read
on the card only. Every other new metric reads a finite number in each
cell its ``workloads`` lists, and the recorder drops no span."""

import math

import pytest

from portbench import spec
from portbench.tests.small import run_small

NEW = ["batcher_queue_ms_p50", "batcher_fill_ms_mean", "idle_in_fill_pct",
       "embed_ms_mean", "plan_ms_mean", "reply_ms_mean", "chunks_per_batch",
       "fused_vector_ms_per_query", "fused_rank_ms_per_query"]
DEVICE_ONLY = {"idle_in_fill_pct", "fused_vector_ms_per_query",
               "fused_rank_ms_per_query"}
BENCH = spec.load_benchmark()


@pytest.fixture()
def recorder():
    from orama_core_tpu_torch.utils import tracing

    tracing.disable()
    yield tracing
    tracing.disable()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_new_metrics_read_in_their_cells(cell, recorder):
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(NEW) <= set(entries)
    want = [n for n in NEW if cell in entries[n]["workloads"]]
    out = run_small(cell, traced=True)
    assert out["correct"], out["checks"]
    assert recorder.enabled() and recorder.dropped() == 0
    got = out["metrics"]
    for name in want:
        if name in DEVICE_ONLY:
            assert name not in got, (name, got.get(name))
        else:
            v = got[name]["value"]
            assert math.isfinite(v) and v >= 0, (name, v)
            assert got[name]["unit"] == entries[name]["unit"]
    if cell == "signal1m.rrf_batched":
        assert got["chunks_per_batch"]["value"] >= 1
        assert got["plan_ms_mean"]["value"] > 0


def test_new_metrics_read_nothing_without_a_recorder(monkeypatch):
    """Against a program with no span recorder (the parent of these
    readers), every new reader installs and reads None, raising nothing."""
    import types

    from portbench import cell as cell_mod
    from portbench import spans

    monkeypatch.setattr(spans, "_recorder", lambda: None)
    c = spec.cell("signal1m.rrf_batched")
    w = cell_mod.Window(0.0, 1.0, [], 10, [], types.SimpleNamespace(
        ns0=0, window_s=1.0, device=[("k", 0, 10)]), {}, 1, c)
    for name in NEW:
        reader = spec.metric_reader(name)
        reader.install(w)
        assert reader.read(w) is None, name
