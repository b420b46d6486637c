"""The port's bench (``orama_core_tpu_torch/bench.py``) and its 1M
collection (``tools/synthetic.py``) against the repo's ``bench.py`` and
``benchmarks/hybrid_1m_bench.build_synthetic_reader``, on the CPU.

The collection's arrays equal the reference builder's exactly (the same
seed, the same draws in the same order); queries drawn as the bench's
engine metrics draw them give the same hits on both readers (the
reference forced onto its kernel branches): ids equal, except that docs
whose scores tie within rtol 1e-5 may swap inside their tie group,
counts equal, scores within rtol 1e-5. ``bench.main`` prints the
reference's five metric lines in its order, and a failing phase raises
out of it at once, with no retry and no result line."""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from orama_core_tpu_torch import bench
from orama_core_tpu_torch.engine.carry import export_arrays
from orama_core_tpu_torch.tools.synthetic import (
    synthetic_arrays, synthetic_reader,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
METRICS = ["exact_vector_search_qps_1Mx768_top10", "bm25_seq_p50_1m",
           "hybrid_rrf_seq_p50_1m", "bm25_batched_qps_1m",
           "hybrid_batched_qps_1m"]
SMALL = ["--device", "cpu", "--docs", "8192", "--dim", "64", "--iters", "2",
         "--engine-docs", "3000"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run many small torch ops: under the test runner's
    parallel workers, torch's intra-op threads contend (as in
    test_torch_llm.py), so each module here runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_builder():
    return runpy.run_path(os.path.join(ROOT, "benchmarks",
                                       "hybrid_1m_bench.py"))[
        "build_synthetic_reader"]


def _equal_arrays(got, want):
    assert sorted(got) == sorted(want)
    for key, arrays in want.items():
        assert sorted(got[key]) == sorted(arrays), key
        for name, a in arrays.items():
            b = got[key][name]
            assert b.dtype == a.dtype, (key, name, b.dtype, a.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f"{key}/{name}")


def test_synthetic_arrays_equal_the_reference_builders():
    """The drawn arrays, and the whole committed state of the readers
    built from them (the string field's empty keyword index included)."""
    ref = _reference_builder()(3000, 400, 20, 32)
    want = export_arrays(ref)
    got = synthetic_arrays(3000, 400, 20, 32)
    _equal_arrays(got["arrays"],
                  {k: want["arrays"][k] for k in got["arrays"]})
    n = got["doc_count"]
    assert (n, got["max_doc_id"]) == (want["doc_count"], want["max_doc_id"])
    np.testing.assert_array_equal(got["alive"], want["alive"][:n])
    assert not want["alive"][n:].any()
    assert [(f["field_id"], f["name"], f["type"], f.get("model"))
            for f in got["fields"]] == [
        (f["field_id"], f["name"], f["type"].value, f["model"])
        for f in want["fields"]]
    port = export_arrays(synthetic_reader(3000, 400, 20, 32, device="cpu"))
    _equal_arrays(port["arrays"], want["arrays"])
    np.testing.assert_array_equal(port["alive"], want["alive"])


def _tie_groups(ranked):
    """[(doc, score)] -> [(first score, {docs})] over runs of scores equal
    within RTOL."""
    groups = []
    for doc, score in ranked:
        if groups and abs(score - groups[-1][0]) <= RTOL * abs(groups[-1][0]):
            groups[-1][1].add(doc)
        else:
            groups.append((score, {doc}))
    return groups


def _same_hits(got, want, what):
    assert len(got) == len(want), (what, got, want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=RTOL, err_msg=what)
    g, w = _tie_groups(got), _tie_groups(want)
    assert len(g) == len(w), (what, got, want)
    # a tie group cut by the limit may hold other docs
    assert [ids for _, ids in g[:-1]] == [ids for _, ids in w[:-1]], (
        what, got, want)


def test_engine_metric_queries_hit_what_the_reference_hits():
    from orama_core_tpu.models.ai_service import AIService as RefAI
    from orama_core_tpu.types import SearchParams as RefParams
    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.types import SearchParams

    n_terms = 400
    ref = _reference_builder()(3000, n_terms, 20, 384)
    ref.cfg._test_force_fast_path = True
    port = synthetic_reader(3000, n_terms, 20, 384, device="cpu")
    ref_ai, ai = RefAI(), AIService(device="cpu")
    rng = np.random.default_rng(42)
    modes = [mode for _, _, mode, _ in bench.ENGINE_METRICS] + ["vector"]
    counts = [n for _, _, _, n in bench.ENGINE_METRICS] + [32]
    n_hits = 0
    for mode, n in zip(modes, counts):
        for term in bench.draw_terms(rng, n, n_terms)[:8]:
            body = {"term": term, "mode": mode}
            got, gc, _ = port.search(SearchParams.from_json(body), ai)
            want, wc, _ = ref.search(RefParams.from_json(body), ref_ai)
            assert gc == wc, (body, gc, wc)
            _same_hits(got, want, body)
            n_hits += len(got)
    assert n_hits > 250


def test_main_prints_the_five_lines_in_the_references_order(capsys):
    assert bench.main(SMALL) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5, lines
    rows = [json.loads(line) for line in lines]
    assert [r["metric"] for r in rows] == METRICS
    assert set(rows[0]) == {"metric", "value", "unit", "vs_baseline"}
    assert [r["unit"] for r in rows] == ["qps", "ms", "ms", "qps", "qps"]
    for r in rows:
        for key in ("value", "vs_baseline"):
            if key in r:
                assert np.isfinite(r[key]) and r[key] > 0, r
        if r is not rows[0]:
            assert set(r) == {"metric", "value", "unit"}, r


def test_a_failing_phase_raises_at_once_without_a_result(monkeypatch,
                                                         capsys):
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("engine phase failed")

    monkeypatch.setattr(bench, "engine_serving_metrics", broken)
    with pytest.raises(RuntimeError, match="engine phase failed"):
        bench.main(["--device", "cpu", "--docs", "4096", "--dim", "32",
                    "--iters", "1", "--engine-docs", "500"])
    assert calls == [1]
    assert capsys.readouterr().out == ""


def test_without_a_card_the_module_exits_non_zero_with_no_result(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "orama_core_tpu_torch.bench"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
