"""The result line's keys, and each compared number beside its limit."""

import json
import math

import pytest

from portbench.tests.small import run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(traced):
    out = run_small("signal1m.rrf_batched", traced=traced)
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(out) == want  # the checks come last
    json.dumps(out)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        names = set(out["metrics"])
        assert {"batch_queries_mean", "queue_wait_ms_p50", "search_batch_ms"} <= names
    else:
        assert set(out["metrics"]) == {"qps", "p50_ms", "setup_s"}
        assert all(math.isfinite(m["value"]) and m["value"] > 0
                   for m in out["metrics"].values())
    for name, (value, limit) in out["checks"].items():
        assert isinstance(name, str) and value <= limit
