"""The harness finds every part of a cell by name, and a new configuration,
traffic mix and per-layer metric need only new files and entries."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_part_of_a_cell_is_found_by_name(name):
    c = spec.cell(name)
    assert c.config["name"] == c.config_name
    spec.generator(c.config["generator"])
    spec.reference(c.config["reference"])
    assert set(c.limits) == {"hit_dev", "count_dev"}
    spec.loop(c.traffic["loop"])
    for kind in c.traffic["kinds"]:
        assert callable(spec.comparison(kind["comparison"]).numbers)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "qps"}
    for m in c.per_layer:
        reader = spec.metric_reader(m["name"])
        assert callable(reader.read)


def test_benchmark_json_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        assert 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


ADD = {
    "configs/tiny_text.json": {
        "name": "tiny_text", "generator": "zipf_collection", "reference": "search",
        "n_docs": 5000,
        "text": {"field": "body", "n_terms": 500, "zipf_exponent": 1.0,
                 "mean_doc_words": 20.0},
        "serving": {"device": "cpu", "query_batching": True, "batch_max": 256,
                    "batch_wait_ms": 2.0}},
    # a mode no shipped mix sends, under a loop no shipped mix names
    "traffic/fulltext_few.json": {
        "loop": "closed_counted", "clients": 4, "requests_per_client": 8,
        "kinds": [{"share": 1, "body": {"mode": "fulltext", "limit": 10},
                   "words": {"min": 1, "max": 1, "mean": 1},
                   "comparison": "bm25_topk"}],
        "vocab_terms": 500, "term_draw": {"pareto_shape": 1.2, "scale": 5},
        "warmup_rounds": 2, "keep_every": 1, "check_sample": 16, "pool_seed": 0},
    "limits/tiny_text_fulltext_few.json": {"hit_dev": 1e-5, "count_dev": 0},
}
FILES = {
    "metrics/new_metric.py": '"""A new per-layer metric."""\n\n\ndef read(w):\n    return 1.0\n',
    "loops/closed_counted.py": (
        '"""The closed loop, counting its starts."""\n\n'
        "from portbench.loops import closed\n\nSTARTS = []\n\n\n"
        "class Loop(closed.Loop):\n    def start(self):\n"
        "        STARTS.append(len(self.params))\n        super().start()\n"),
}
PROBE = """
import time
from portbench import cell, spec
from portbench.loops import closed_counted

c = spec.cell("tiny_text.fulltext_few")
assert spec.PKG.startswith(%r)
assert c.chips == 4 and c.config["n_docs"] == 5000 and c.traffic["clients"] == 4
assert c.limits["count_dev"] == 0
names = [m["name"] for m in c.per_layer]
assert "new_metric" in names and "k1_roofline" not in names
out = cell.run_cell(c, 2**31 + 5, 1.0, False, "cpu", time.perf_counter(),
                    log=lambda *a: None)
assert closed_counted.STARTS == [4]
assert out["correct"] is True and out["attempted"] > 0, out["checks"]
print("ran", sorted(out["checks"]))
"""


def test_a_new_cell_mix_and_metric_are_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (root / "portbench" / p).read_bytes()
              for p in _files(root / "portbench")}
    for rel, body in ADD.items():
        assert not (root / "portbench" / rel).exists()
        (root / "portbench" / rel).write_text(json.dumps(body))
    for rel, text in FILES.items():
        assert not (root / "portbench" / rel).exists()
        (root / "portbench" / rel).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny_text", "source": "https://example.org",
                             "file": "portbench/configs/tiny_text.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_text.fulltext_few",
                               "config": "tiny_text", "traffic": "fulltext_few",
                               "chips": 4, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "%",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "qps",
                               "workloads": ["tiny_text.fulltext_few"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), spec.ROOT]))
    out = subprocess.run([sys.executable, "-c", PROBE % str(root)], cwd=root,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ran ['count_dev', 'failed', 'hit_dev']"
    after = {p: (root / "portbench" / p).read_bytes() for p in before}
    assert after == before  # no file that was there changed


def _files(base):
    return [os.path.relpath(os.path.join(d, f), base)
            for d, _dirs, files in os.walk(base) for f in files
            if "__pycache__" not in d]
