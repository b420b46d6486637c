"""The port's entry points against the repo's: ``tools/graft_entry`` against
``__graft_entry__.py`` and ``orama_core_tpu_torch.start`` against
``orama_core_tpu.start``, on the CPU.

- ``entry()``: with the reference's parameters carried across
  (``models/encoder.params_from_numpy``), the forward on the same ids and
  mask agrees by cosine >= 0.999 per row (the bf16 encoder's tolerance
  in tests/test_torch_encoder.py).
- ``dryrun_multichip(4, device="cpu")`` runs all four steps; its step 1
  (the sharded hybrid step and the sharded vector top-k) equals the
  reference's programs on the same ``default_rng(1)`` inputs over four of
  the conftest's eight virtual CPU devices: ids exact, scores rtol 1e-5.
- ``start()`` in a subprocess (``ORAMAX_gpu__device=cpu``, a free port)
  answers a create / insert / search over HTTP with the hits of the
  reference's ``start()`` run the same way."""

import json
import os
import runpy
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orama_core_tpu_torch.models import encoder as enc
from orama_core_tpu_torch.tools import graft_entry
from test_torch_bench import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    return runpy.run_path(os.path.join(ROOT, "__graft_entry__.py"))


def _cosines(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def test_entry_forward_matches_the_reference():
    ref_fwd, (ref_params, ref_ids, ref_mask) = _reference()["entry"]()
    want = np.asarray(jax.jit(ref_fwd)(ref_params, ref_ids, ref_mask))
    fwd, (params, ids, mask) = graft_entry.entry("cpu")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    carried = enc.params_from_numpy(
        jax.tree.map(np.asarray, ref_params),
        enc.EncoderConfig(**graft_entry.ENTRY_CFG), "cpu")
    got = fwd(carried, ids, mask).numpy()
    assert got.shape == want.shape == (8, 256)
    assert (_cosines(got, want) >= 0.999).all(), _cosines(got, want)
    own = fwd(params, ids, mask).numpy()
    assert np.isfinite(own).all()
    np.testing.assert_allclose(np.linalg.norm(own, axis=-1), 1.0, atol=1e-5)


def test_dryrun_runs_every_step_and_step_one_matches_the_reference():
    from orama_core_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from orama_core_tpu.parallel.sharded_search import (
        sharded_hybrid_step, sharded_vector_topk,
    )

    n = 4
    out = graft_entry.dryrun_multichip(n, device="cpu")
    assert out["positions"] == n and out["cards"] == 0
    assert out["tp_shape"] == (n, 128)
    assert all(c > 0 for c in out["counts"].values()), out["counts"]
    assert out["ivf_pq_top"][0] == graft_entry.PQ_QUERY_ROW

    # the reference's step 1, drawn as _dryrun_body draws it
    S, LD, LP, LV, D = n, 64, 128, 64, 32
    rng = np.random.default_rng(1)
    post_docs = jnp.asarray(rng.integers(0, LD, S * LP), jnp.int32)
    post_tf = jnp.asarray(rng.uniform(1, 4, S * LP), jnp.float32)
    doc_lens = jnp.asarray(rng.uniform(5, 50, S * LD), jnp.float32)
    g_idx = jnp.asarray(rng.integers(0, LP, S * 32), jnp.int32)
    g_idf = jnp.asarray(rng.uniform(0.1, 2.0, S * 32), jnp.float32)
    vecs = jnp.asarray(rng.standard_normal((S * LV, D)), jnp.bfloat16)
    vec_docs = jnp.asarray(rng.integers(0, LD, S * LV), jnp.int32)
    vec_valid = jnp.ones((S * LV,), jnp.float32)
    query = jnp.asarray(rng.standard_normal(D), jnp.float32)
    filter_mask = jnp.ones((S * LD,), jnp.float32)
    mesh = ref_make_mesh((n,), ("data",), jax.devices()[:n])
    vals, ids = sharded_hybrid_step(mesh, graft_entry.K, shard_cap=LD,
                                    n_local_docs=LD)(
        post_docs, post_tf, doc_lens, g_idx, g_idf, vecs, vec_docs,
        vec_valid, query, filter_mask, jnp.float32(20.0))
    v2, i2 = sharded_vector_topk(mesh, graft_entry.K, shard_cap=LD)(
        vecs, vec_docs, vec_valid, query)

    inputs = graft_entry.step1_inputs(n)
    np.testing.assert_array_equal(
        torch.as_tensor(inputs["vecs"]).to(torch.bfloat16).float().numpy(),
        np.asarray(vecs, np.float32))
    for name, ref in (("post_docs", post_docs), ("post_tf", post_tf),
                      ("doc_lens", doc_lens), ("g_idx", g_idx),
                      ("g_idf", g_idf), ("vec_docs", vec_docs),
                      ("query", query)):
        np.testing.assert_array_equal(inputs[name], np.asarray(ref), name)
    got_v, got_i = out["hybrid"]
    np.testing.assert_array_equal(got_i, np.asarray(ids))
    np.testing.assert_allclose(got_v, np.asarray(vals), rtol=1e-5)
    got_v, got_i = out["knn"]
    np.testing.assert_array_equal(got_i, np.asarray(i2))
    np.testing.assert_allclose(got_v, np.asarray(v2), rtol=1e-5)


# -- start() over HTTP ----------------------------------------------------------

DOCS = [{"id": str(i), "title": f"doc {i} about {w}",
         "body": f"{w} {v} notes number {i}"}
        for i, (w, v) in enumerate(
            (w, v) for w in ("solar", "wind", "grid", "cake", "qubit")
            for v in ("panel", "turbine", "flour", "laser"))]
QUERIES = [{"term": "solar"}, {"term": "wind turbine"},
           {"term": "notes", "limit": 5}, {"term": "cake flour"}]
PORT_CODE = "from orama_core_tpu_torch import start; start()"
REF_CODE = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "from orama_core_tpu import start; start()")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _req(base, path, body=None, bearer=None):
    h = {"Content-Type": "application/json"}
    if bearer:
        h["Authorization"] = "Bearer " + bearer
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(base + path, data=data, headers=h,
                               method="POST" if data else "GET")
    with urllib.request.urlopen(r, timeout=60) as f:
        return f.read()


def _until(fn, what, seconds=240):
    t_end = time.monotonic() + seconds
    while True:
        try:
            got = fn()
            if got is not None:
                return got
        except (OSError, urllib.error.HTTPError):
            pass
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.1)


def _launch(code, tmp, env_extra):
    """(the server process, its base URL): ``code`` run in a subprocess
    on a free port with its data under ``tmp``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **env_extra)
    # no interval commit while the test runs: a committed index adds the
    # phrase boost that the uncommitted window does not, so a server that
    # commits first would answer another question
    env.update({"ORAMAX_http__port": str(port),
                "ORAMAX_writer_side__data_dir": str(tmp / "w"),
                "ORAMAX_reader_side__data_dir": str(tmp / "r"),
                "ORAMAX_writer_side__commit_interval_sec": "3600",
                "ORAMAX_reader_side__commit_interval_sec": "3600"})
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=tmp, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    return proc, f"http://127.0.0.1:{port}"


def _create_insert_search(base):
    _until(lambda: _req(base, "/health") and True, "health")
    _req(base, "/v1/collections/create", {
        "id": "c", "read_api_key": "r", "write_api_key": "w"}, "master")
    _until(lambda: _req(base, "/v1/collections/c/insert", DOCS, "w")
           and True, "insert")
    # the first search only once the read side holds the last document: the
    # reference's alive-mask cache (collection_read._alive_mask_device) can
    # keep a mask copied while inserts were still being applied
    _until(lambda: _req(base, "/v1/collections/c/documents/"
                        + DOCS[-1]["id"] + "?api-key=r") and True,
           "the last document on the read side")

    def search(body):
        return json.loads(_req(base, "/v1/collections/c/search?api-key=r",
                               body))

    _until(lambda: True if search({"term": "notes", "limit": 100})[
        "count"] == len(DOCS) else None, "every document searchable")
    return [search(q) for q in QUERIES]


def test_start_serves_the_hits_of_the_references_start(tmp_path):
    """Both servers start together; both are killed at the end."""
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    servers = [_launch(PORT_CODE, tmp_path / "port",
                       {"ORAMAX_gpu__device": "cpu", "OMP_NUM_THREADS": "1"}),
               _launch(REF_CODE, tmp_path / "ref", {"JAX_PLATFORMS": "cpu"})]
    try:
        got, want = [_create_insert_search(base) for _, base in servers]
    finally:
        for proc, _ in servers:
            proc.kill()
            proc.wait(timeout=60)
    for q, g, w in zip(QUERIES, got, want):
        assert g["count"] == w["count"] > 0, (q, g, w)
        assert [h["id"] for h in g["hits"]] == [h["id"] for h in w["hits"]], (
            q, g, w)
        np.testing.assert_allclose([h["score"] for h in g["hits"]],
                                   [h["score"] for h in w["hits"]], rtol=1e-5)
