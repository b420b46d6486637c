"""Serving-oriented example: micro-batching, raw-vector queries,
selective filters, and the fused vector fast path.

    python -m orama_core_tpu_torch.examples.serving [--device cpu]

Port of ``examples/serving.py``: the same documents, queries and
micro-batcher settings (under ``cfg.gpu``), on the card unless
``--device cpu``. On the card, unfiltered vector queries take the fused
kNN (K2 + K3, ``ops/knn.py``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
from typing import Optional

from .. import build_orama
from ..config import OramaxConfig
from ..types import SearchParams

TITLES = ["red running shoes", "blue walking shoes", "trail backpack",
          "carbon road bike", "wool hiking socks", "waterproof jacket"]
BATCHED = ({"term": "shoes", "mode": "vector"},
           {"term": "bike", "mode": "vector"},
           {"term": "jacket", "mode": "vector"})


def main(device: str = "cuda", workdir: Optional[str] = None):
    """Returns {"batched": {i: ids of BATCHED[i]}, "filtered_hybrid":
    [(id, score rounded to 3 places)], "raw_vector": [first id]}."""
    cfg = OramaxConfig()
    workdir = workdir or tempfile.mkdtemp()
    cfg.writer_side.data_dir = os.path.join(workdir, "writer")
    cfg.reader_side.data_dir = os.path.join(workdir, "reader")
    # coalesce concurrent queries into one device call
    cfg.gpu.query_batching = True
    cfg.gpu.batch_wait_ms = 5.0

    engine = build_orama(cfg, start_background=False, device=device)
    engine.write_side.create_collection(
        "master", "products", read_api_key="rk", write_api_key="wk"
    )
    engine.write_side.write(
        "products",
        [
            {"id": f"p{i}", "title": t, "price": 10.0 * (i + 1), "in_stock": i % 2 == 0}
            for i, t in enumerate(TITLES)
        ],
        "wk",
    )
    engine.flush()
    engine.commit()

    # concurrent queries coalesce in the micro-batcher
    results = {}

    def q(i, body):
        res = engine.read_side.search("products", SearchParams.from_json(body), "rk")
        results[i] = [h.id for h in res.hits]

    threads = [threading.Thread(target=q, args=(i, b))
               for i, b in enumerate(BATCHED)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("batched vector results:", results)

    # selective filter: candidates are listed host-side from the sorted
    # price column; the vector path scores only the survivors
    res = engine.read_side.search(
        "products",
        SearchParams.from_json(
            {"term": "shoes", "mode": "hybrid", "where": {"price": {"lte": 20}}}
        ),
        "rk",
    )
    filtered = [(h.id, round(h.score, 3)) for h in res.hits]
    print("filtered hybrid:", filtered)

    # bring-your-own-embedding: query with a raw vector (skips the model)
    model = next(
        f.model for f in engine.read_side._reader("products").fields.values() if f.model
    )
    raw = [float(x) for x in engine.read_side.ai.embed_passage(model, ["red running shoes"])[0]]
    res = engine.read_side.search(
        "products",
        SearchParams.from_json({"mode": "vector", "vector": raw}),
        "rk",
    )
    first = [h.id for h in res.hits][:1]
    print("raw-vector query:", first)

    engine.close()
    return {"batched": results, "filtered_hybrid": filtered, "raw_vector": first}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
