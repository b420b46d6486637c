"""BASELINE config 5, mesh half: sharded int8 vector search through the
engine's mesh path, recall@10 against the exact single-device path.

    python -m orama_core_tpu_torch.tools.sharded_int8_bench [--docs 200000]
        [--dim 128] [--queries 64] [--device cpu]

Port of ``benchmarks/sharded_int8_bench.py``. Two engines
(``build_orama``): one on a single device with the exact (bf16) index,
one with ``gpu.mesh_shape=(8, 1)`` and ``vector_index="int8"``, its
eight data positions placed by ``parallel/mesh.make_mesh`` (position i
on card ``i * n_cards // 8``; one card holds all eight). Both take the
same vectors as raw embedding ops (no text encoder: the bench is about
the vector path), commit, and answer the same vector queries through
``CollectionReader.search``; the value is the mean overlap of their
top-10s. As in the script, the vectors go into a field of their own
(id 100) beside the collection's own embedding field, so the exact
engine's queries take the dense path, not the fused kNN, and the mesh
engine scores its int8 rows in plain PyTorch: the run launches no
hand-written kernel. The corpus is the script's, from ``default_rng(0)``: 256 unit
modes, noise 0.25 / sqrt(D), ten planted neighbours per query (cos ~0.99
against the ~0.97 same-mode background), queries at noise 0.05 / sqrt(D)
from the planted bases.

Prints one JSON line, ``{"metric":
"sharded_int8_recall_at_10_<docs/1000>k_8dev", "value", "unit":
"recall", "docs", "queries", "note", "cards"}``: ``cards`` is the number
of cards that held the eight positions (0 on the CPU). Wall seconds of
both query passes and the card's name and power limit go to stderr.
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

POSITIONS, NPLANT, FIELD = 8, 10, 100


def make_data(docs: int, dim: int, queries: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(unit vectors f32[docs, dim], unit queries f32[queries, dim]) drawn
    as the script draws them."""
    rng = np.random.default_rng(0)
    modes = rng.standard_normal((256, dim)).astype(np.float32)
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    which = rng.integers(0, 256, docs)
    vecs = modes[which] + 0.25 / np.sqrt(dim) * rng.standard_normal(
        (docs, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    bases = vecs[-queries:].copy()
    for j in range(queries):
        block = bases[j] + 0.12 / np.sqrt(dim) * rng.standard_normal(
            (NPLANT, dim)).astype(np.float32)
        vecs[j * NPLANT:(j + 1) * NPLANT] = block / np.linalg.norm(
            block, axis=1, keepdims=True)
    qv = bases + 0.05 / np.sqrt(dim) * rng.standard_normal(
        (queries, dim)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    return vecs, qv


def make_engine(mesh_shape, vector_index: str, data_dir: str, device: str):
    from .. import build_orama
    from ..config import OramaxConfig

    cfg = OramaxConfig()
    cfg.writer_side.data_dir = data_dir + "/w"
    cfg.reader_side.data_dir = data_dir + "/r"
    cfg.writer_side.commit_interval_sec = 3600.0
    cfg.reader_side.commit_interval_sec = 3600.0
    cfg.gpu.mesh_shape = mesh_shape
    cfg.gpu.vector_index = vector_index
    e = build_orama(cfg, start_background=False, device=device)
    e.write_side.create_collection("master", "c", read_api_key="rk",
                                   write_api_key="wk")
    e.flush()
    return e


def ingest(engine, vecs: np.ndarray, commit_dir: str) -> None:
    """Raw embedding ops into collection ``c``'s reader, then a commit."""
    from ..oplog import CreateFieldOp, IndexEmbeddingOp, InsertDocumentOp
    from ..types import TypedField, ValueType

    reader = engine.read_side.collections["c"]
    reader.apply(CreateFieldOp("c", TypedField(
        name="emb", field_id=FIELD, type=ValueType.EMBEDDING,
        model="fake-small")))
    t0 = time.perf_counter()
    for i in range(len(vecs)):
        reader.apply(InsertDocumentOp("c", i, {"id": str(i)}))
    for i in range(len(vecs)):
        reader.apply(IndexEmbeddingOp("c", i, FIELD,
                                      (tuple(map(float, vecs[i])),)))
    log(f"ingested {len(vecs)} in {time.perf_counter() - t0:.1f} s")
    reader.commit(commit_dir, 1)


class VecAI:
    """Query embeddings by index: term ``q<i>`` is ``qv[i]``."""

    def __init__(self, qv: np.ndarray):
        self.qv = qv

    def embed_query(self, model, texts):
        return self.qv[[int(t[1:]) for t in texts]].astype(np.float32)


def run(engine, qv: np.ndarray) -> Tuple[List[List[int]], float]:
    """(each query's top-10 doc ids, wall seconds of the pass)."""
    from ..types import SearchParams

    reader = engine.read_side.collections["c"]
    ai = VecAI(qv)
    out = []
    t0 = time.perf_counter()
    for i in range(len(qv)):
        ranked, _, _ = reader.search(SearchParams.from_json(
            {"term": f"q{i}", "mode": "vector", "limit": 10}), ai)
        out.append([d for d, _ in ranked])
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="orama_core_tpu_torch.tools.sharded_int8_bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import require_device
    from ..parallel.mesh import mesh_cards

    log(f"device: {card_line(require_device(args.device))}")
    vecs, qv = make_data(args.docs, args.dim, args.queries)
    with tempfile.TemporaryDirectory() as d:
        single = make_engine((), "exact", d + "/s", args.device)
        sharded = make_engine((POSITIONS, 1), "int8", d + "/sh", args.device)
        try:
            ingest(single, vecs, d + "/cs")
            ingest(sharded, vecs, d + "/csh")
            gt, dt_s = run(single, qv)
            got, dt_sh = run(sharded, qv)
            cards = mesh_cards(sharded.read_side.collections["c"]
                               ._device.mesh)
        finally:
            single.close()
            sharded.close()
    log(f"single exact: {dt_s:.3f} s; sharded int8: {dt_sh:.3f} s")
    print(json.dumps({
        "metric": f"sharded_int8_recall_at_10_{args.docs // 1000}k_8dev",
        "value": recall_at_k(got, gt),
        "unit": "recall",
        "docs": args.docs,
        "queries": args.queries,
        "note": f"engine mesh path, {POSITIONS} positions on "
                f"{cards or 'no'} card(s)",
        "cards": cards,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
