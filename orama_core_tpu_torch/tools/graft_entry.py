"""The engine's forward step and its multi-position dry run.

    python -m orama_core_tpu_torch.tools.graft_entry [--device cpu] [--n 8]

Port of the repo's ``__graft_entry__.py``:

- ``entry(device)``: the flagship model's forward step and its inputs,
  ``(fwd, (params, ids, mask))``: the embedding encoder
  (``models/encoder.py``) at ``EncoderConfig(1024, 256, 2, 8, 1024, 64,
  256)``, the compute heart of the write path (auto-embedding) and of
  vector and hybrid queries. Its parameters are drawn from an explicit
  ``torch.Generator`` (seed 0), so their values are not the reference's
  ``jax.random`` ones; the token ids are the reference's.
- ``dryrun_multichip(n, device)``: on the port's mesh of n positions
  (``parallel/mesh.make_mesh``: position i on card ``i * n_cards // n``,
  so one card holds them all), the sharded hybrid query step and the
  sharded vector top-k on tiny shapes, a data x model encoder forward,
  ``build_orama`` with ``gpu.mesh_shape=(n, 1)`` serving hybrid,
  filtered, fresh-window and faceted queries, and the sharded IVF-PQ
  reader. Each step asserts what the reference's asserts.

The module runs on ``cuda`` unless given ``device="cpu"``; a missing card
raises.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Any, Dict

import numpy as np
import torch

ENTRY_CFG = dict(vocab_size=1024, hidden=256, layers=2, heads=8, mlp=1024,
                 max_len=64, out_dim=256)
TP_CFG = dict(vocab_size=512, hidden=128, layers=2, heads=8, mlp=256,
              max_len=32, out_dim=128)
# the sharded query step's tiny shapes (per position)
LOCAL_DOCS, LOCAL_POSTS, LOCAL_VECS, DIM, K = 64, 128, 64, 32, 8
PQ_ROWS, PQ_DIM, PQ_QUERY_ROW = 2048, 128, 7


def check(cond: bool, what) -> None:
    """The reference's asserts, kept under ``python -O``."""
    if not cond:
        raise AssertionError(what)


def entry(device: str = "cuda"):
    """``(fwd, (params, ids, mask))``: ``fwd(params, ids, mask)`` is
    ``encode`` at the entry's config, on ``device``."""
    from .. import require_device
    from ..models import encoder as enc

    dev = require_device(device)
    cfg = enc.EncoderConfig(**ENTRY_CFG)
    params = enc.init_params(cfg, torch.Generator().manual_seed(0), device=dev)

    def fwd(params, ids, mask):
        return enc.encode(params, cfg, ids, mask)

    ids = torch.as_tensor(np.random.default_rng(0).integers(1, 1024, (8, 64)),
                          dtype=torch.int32, device=dev)
    mask = torch.ones(8, 64, dtype=torch.float32, device=dev)
    return fwd, (params, ids, mask)


def step1_inputs(n: int) -> Dict[str, np.ndarray]:
    """The sharded step's host inputs, drawn from ``default_rng(1)`` in the
    reference's order (``vecs`` as drawn, in f64: the caller rounds it to
    bf16)."""
    rng = np.random.default_rng(1)
    s = n
    return {
        "post_docs": rng.integers(0, LOCAL_DOCS, s * LOCAL_POSTS).astype(
            np.int32),
        "post_tf": rng.uniform(1, 4, s * LOCAL_POSTS).astype(np.float32),
        "doc_lens": rng.uniform(5, 50, s * LOCAL_DOCS).astype(np.float32),
        "g_idx": rng.integers(0, LOCAL_POSTS, s * 32).astype(np.int32),
        "g_idf": rng.uniform(0.1, 2.0, s * 32).astype(np.float32),
        "vecs": rng.standard_normal((s * LOCAL_VECS, DIM)),
        "vec_docs": rng.integers(0, LOCAL_DOCS, s * LOCAL_VECS).astype(
            np.int32),
        "vec_valid": np.ones(s * LOCAL_VECS, np.float32),
        "query": rng.standard_normal(DIM).astype(np.float32),
        "filter_mask": np.ones(s * LOCAL_DOCS, np.float32),
    }


def sharded_steps(mesh, inputs: Dict[str, np.ndarray], device):
    """Step 1: (hybrid values, hybrid ids, kNN values, kNN ids) of the
    sharded hybrid step and the sharded vector top-k over ``inputs``."""
    from ..parallel.sharded_search import (
        sharded_hybrid_step, sharded_vector_topk,
    )

    t = {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}
    t["vecs"] = t["vecs"].to(torch.bfloat16)
    step = sharded_hybrid_step(mesh, K, shard_cap=LOCAL_DOCS,
                               n_local_docs=LOCAL_DOCS)
    vals, ids = step(t["post_docs"], t["post_tf"], t["doc_lens"], t["g_idx"],
                     t["g_idf"], t["vecs"], t["vec_docs"], t["vec_valid"],
                     t["query"], t["filter_mask"], 20.0)
    check(vals.shape == (K,) and ids.shape == (K,), (vals.shape, ids.shape))
    knn = sharded_vector_topk(mesh, K, shard_cap=LOCAL_DOCS)
    v2, i2 = knn(t["vecs"], t["vec_docs"], t["vec_valid"], t["query"])
    return vals, ids, v2, i2


def tp_forward(n: int, device):
    """Step 2: the encoder forward with its parameters placed over a data
    x model mesh (``param_specs``, models/tp.py). [batch, 128] f32."""
    from ..models import encoder as enc
    from ..parallel.mesh import make_mesh, shard_params

    shape = (n // 2, 2) if n % 2 == 0 else (1, n)
    mesh = make_mesh(shape, ("data", "model"), device=device.type)
    cfg = enc.EncoderConfig(**TP_CFG)
    params = shard_params(
        mesh, enc.init_params(cfg, torch.Generator().manual_seed(0),
                              device=device),
        enc.param_specs(cfg))
    batch = mesh.shape["data"] * 2
    ids = torch.as_tensor(np.random.default_rng(2).integers(1, 512,
                                                            (batch, 32)),
                          dtype=torch.int32, device=device)
    out = enc.encode(params, cfg, ids, torch.ones(batch, 32, device=device))
    check(out.shape == (batch, 128), out.shape)
    return out


ENGINE_BODIES = (
    {"term": "sharded doc", "mode": "hybrid"},
    {"term": "engine", "where": {"price": {"gte": 2}}},
    {"term": "fresh"},
    # facets ride the mesh path too (sharded masked reductions)
    {"term": "sharded",
     "facets": {"price": {"ranges": [{"from": 0, "to": 100}]}}},
)


def engine_queries(n: int, device) -> Dict[str, int]:
    """Step 3: ``build_orama`` on an (n, 1) mesh: committed documents plus
    a fresh uncommitted one, the four query bodies; their counts."""
    from .. import build_orama
    from ..config import OramaxConfig
    from ..types import SearchParams

    cfg = OramaxConfig()
    with tempfile.TemporaryDirectory() as d:
        cfg.writer_side.data_dir = d + "/w"
        cfg.reader_side.data_dir = d + "/r"
        cfg.gpu.mesh_shape = (n, 1)
        eng = build_orama(cfg, start_background=False, device=device.type)
        try:
            eng.write_side.create_collection("master", "c", "rk", "wk")
            eng.write_side.write("c", [
                {"id": str(i), "title": f"sharded engine doc {i}", "price": i}
                for i in range(4 * n)], "wk")
            eng.flush()
            eng.commit()
            eng.write_side.write("c", [{"id": "w",
                                        "title": "fresh window doc"}], "wk")
            eng.flush()
            counts = {}
            for body in ENGINE_BODIES:
                r = eng.read_side.search("c", SearchParams.from_json(body),
                                         "rk")
                check(r.count > 0, body)
                counts[body["term"]] = r.count
        finally:
            eng.close()
    return counts


def ivf_pq_reader(n: int, device):
    """Step 4: a mesh reader with ``vector_index="ivf_pq"`` over 2,048
    unit rows of 128 dims (``default_rng(5)``), committed; the top hit of
    row 7's own vector must be row 7, through the mesh path when n >= 2.
    Returns the ranked hits."""
    from ..config import GpuConfig
    from ..engine.collection_read import CollectionReader
    from ..oplog import CreateFieldOp, IndexEmbeddingOp, InsertDocumentOp
    from ..types import SearchParams, TypedField, ValueType

    cfg = GpuConfig(device=device.type, mesh_shape=(n, 1),
                    vector_index="ivf_pq", ivf_threshold=256, ivf_nprobe=16,
                    ivf_autotune=False)
    rd = CollectionReader("pq", "rk", None, cfg)
    rd.apply(CreateFieldOp(
        "pq", TypedField(0, "emb", ValueType.EMBEDDING, model="fake-small")))
    pts = np.random.default_rng(5).standard_normal(
        (PQ_ROWS, PQ_DIM)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    for i in range(PQ_ROWS):
        rd.apply(InsertDocumentOp("pq", i, {"id": str(i)}))
        rd.apply(IndexEmbeddingOp("pq", i, 0,
                                  (tuple(float(x) for x in pts[i]),)))
    with tempfile.TemporaryDirectory() as d:
        rd.commit(d, offset=1)
        q = SearchParams.from_json({
            "mode": "vector", "limit": 5,
            "vector": [float(x) for x in pts[PQ_QUERY_ROW]]})
        if n >= 2:
            check(rd._use_sharded(q), "ivf_pq must ride the mesh path")
        ranked, _, _ = rd.search(q, ai_service=None)
    check(ranked and ranked[0][0] == PQ_QUERY_ROW, ranked[:3])
    return ranked


def dryrun_multichip(n: int, device: str = "cuda") -> Dict[str, Any]:
    """The four steps on a mesh of ``n`` positions; what each returned."""
    from .. import configure_torch, require_device
    from ..parallel.mesh import make_mesh, mesh_cards

    dev = require_device(device)
    configure_torch()
    data_mesh = make_mesh((n,), ("data",), device=dev.type)
    vals, ids, v2, i2 = sharded_steps(data_mesh, step1_inputs(n), dev)
    out = tp_forward(n, dev)
    counts = engine_queries(n, dev)
    ranked = ivf_pq_reader(n, dev)
    cards = mesh_cards(data_mesh)
    print(f"dryrun_multichip ok: {n} positions on "
          f"{cards or 'no'} card(s) — sharded hybrid top-{K} + "
          f"dp×tp encoder forward {tuple(out.shape)} + engine mesh serving "
          f"path (incl. facets + IVF-PQ)", flush=True)
    return {"positions": n, "cards": cards,
            "hybrid": (vals.cpu().numpy(), ids.cpu().numpy()),
            "knn": (v2.cpu().numpy(), i2.cpu().numpy()),
            "tp_shape": tuple(out.shape), "counts": counts,
            "ivf_pq_top": [int(d) for d, _ in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="orama_core_tpu_torch.tools.graft_entry",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8,
                    help="mesh positions of the dry run")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    print(tuple(fn(*fargs).shape), flush=True)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
