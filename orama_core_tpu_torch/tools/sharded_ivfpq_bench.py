"""BASELINE config 5, full shape: IVF-PQ compressed vectors sharded over
a mesh, served through the engine's mesh path, recall@10 against the
exact single-device path.

    python -m orama_core_tpu_torch.tools.sharded_ivfpq_bench
        [--docs 200000] [--dim 128] [--queries 64] [--nprobe 64]
        [--device cpu]

Port of ``benchmarks/sharded_ivfpq_bench.py``. Two readers
(``CollectionReader``) take the same unit vectors (``default_rng(0)``:
256 modes, noise 0.25 / sqrt(D)) as raw ops and commit: one on a single
device with the exact index, one with ``mesh_shape=(8, 1)`` and
``vector_index="ivf_pq"`` (``ivf_threshold`` 10,000, ``ivf_nprobe``
``--nprobe``, no autotune), whose commit trains the IVF lists and PQ
codes and whose vector queries take the mesh path
(``collection_read._vector_scores_sharded`` ->
``sharded_engine.ivfpq_scores``: every position probes the same global
centroids and scores its slice of the probed lists). The eight positions
are placed by ``parallel/mesh.make_mesh`` (position i on card
``i * n_cards // 8``; one card holds all eight). The queries are corpus
rows plus noise 0.05 / sqrt(D), sent as raw vectors; the value is the
mean overlap of the two readers' top-10s.

Prints one JSON line, ``{"metric":
"sharded_ivfpq_recall_at_10_<docs/1000>k_8dev", "value", "unit":
"recall", "docs", "queries", "nprobe", "note", "cards"}``: ``cards`` is
the number of cards that held the eight positions (0 on the CPU). Ingest,
commit and query wall seconds and the card's name and power limit go to
stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import List, Tuple

import numpy as np

from .timing import card_line, log, recall_at_k

POSITIONS, IVF_THRESHOLD = 8, 10_000


def make_vecs(docs: int, dim: int) -> Tuple[np.ndarray, np.random.Generator]:
    """(unit vectors f32[docs, dim], the generator, which draws the
    queries next), as the script draws them."""
    rng = np.random.default_rng(0)
    modes = rng.standard_normal((256, dim)).astype(np.float32)
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    which = rng.integers(0, 256, docs)
    vecs = modes[which] + 0.25 / np.sqrt(dim) * rng.standard_normal(
        (docs, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return vecs, rng


def make_queries(vecs: np.ndarray, rng: np.random.Generator,
                 queries: int) -> np.ndarray:
    docs, dim = vecs.shape
    qv = vecs[rng.integers(0, docs, queries)] + (
        0.05 / np.sqrt(dim)) * rng.standard_normal(
        (queries, dim)).astype(np.float32)
    return qv / np.linalg.norm(qv, axis=1, keepdims=True)


def make_reader(mesh_shape, mode: str, vecs: np.ndarray, nprobe: int,
                commit_dir: str, device: str):
    """A reader of ``vecs`` as raw ops (field ``emb``, ``fake-small``),
    committed."""
    from ..config import GpuConfig
    from ..engine.collection_read import CollectionReader
    from ..oplog import CreateFieldOp, IndexEmbeddingOp, InsertDocumentOp
    from ..types import TypedField, ValueType

    cfg = GpuConfig(device=device, mesh_shape=mesh_shape, vector_index=mode,
                    ivf_threshold=IVF_THRESHOLD, ivf_nprobe=nprobe,
                    ivf_autotune=False)
    r = CollectionReader("c", "rk", None, cfg)
    r.apply(CreateFieldOp("c", TypedField(
        name="emb", field_id=0, type=ValueType.EMBEDDING, model="fake-small")))
    t0 = time.perf_counter()
    for i in range(len(vecs)):
        r.apply(InsertDocumentOp("c", i, {"id": str(i)}))
        r.apply(IndexEmbeddingOp("c", i, 0, (tuple(map(float, vecs[i])),)))
    log(f"ingested {len(vecs)} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r.commit(commit_dir, 1)
    log(f"commit (incl. IVF+PQ build) in {time.perf_counter() - t0:.1f} s")
    return r


def run(reader, qv: np.ndarray) -> Tuple[List[List[int]], float]:
    """(each query's top-10 doc ids, wall seconds of the pass)."""
    from ..types import SearchParams

    out = []
    t0 = time.perf_counter()
    for q in qv:
        ranked, _, _ = reader.search(SearchParams.from_json({
            "mode": "vector", "vector": [float(x) for x in q], "limit": 10,
        }), ai_service=None)
        out.append([d for d, _ in ranked])
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="orama_core_tpu_torch.tools.sharded_ivfpq_bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--nprobe", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import require_device
    from ..parallel.mesh import mesh_cards
    from ..types import SearchParams

    log(f"device: {card_line(require_device(args.device))}")
    vecs, rng = make_vecs(args.docs, args.dim)
    with tempfile.TemporaryDirectory() as d:
        single = make_reader((), "exact", vecs, args.nprobe, d + "/s",
                             args.device)
        sharded = make_reader((POSITIONS, 1), "ivf_pq", vecs, args.nprobe,
                              d + "/sh", args.device)
        qv = make_queries(vecs, rng, args.queries)
        if not sharded._use_sharded(SearchParams.from_json(
                {"mode": "vector", "vector": [0.0] * args.dim})):
            raise RuntimeError("ivf_pq must ride the mesh path")
        gt, dt_s = run(single, qv)
        got, dt_sh = run(sharded, qv)
    cards = mesh_cards(sharded._device.mesh)
    log(f"single exact: {dt_s:.3f} s; sharded ivf_pq: {dt_sh:.3f} s")
    print(json.dumps({
        "metric": f"sharded_ivfpq_recall_at_10_{args.docs // 1000}k_8dev",
        "value": recall_at_k(got, gt),
        "unit": "recall",
        "docs": args.docs,
        "queries": args.queries,
        "nprobe": args.nprobe,
        "note": f"engine mesh IVF-PQ path, {POSITIONS} positions on "
                f"{cards or 'no'} card(s)",
        "cards": cards,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
