"""Minimal end-to-end example: build the engine, index, search all modes.

    python -m orama_core_tpu_torch.examples.quickstart [--device cpu]

Port of ``examples/quickstart.py``: the same documents and queries, on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

from .. import build_orama
from ..config import OramaxConfig
from ..types import SearchParams

QUERIES = (
    {"term": "running shoes"},
    {"term": "running shoes", "mode": "vector"},
    {"term": "running shoes", "mode": "hybrid", "where": {"price": {"lt": 70}}},
    {"term": "", "facets": {"in_stock": {"true": True, "false": True}}},
)


def main(device: str = "cuda", workdir: Optional[str] = None):
    """Index three products and run ``QUERIES``; returns, per query, (query,
    [(id, score rounded to 3 places)], the ``in_stock`` facet's values or
    "")."""
    cfg = OramaxConfig()
    workdir = workdir or tempfile.mkdtemp()
    cfg.writer_side.data_dir = os.path.join(workdir, "writer")
    cfg.reader_side.data_dir = os.path.join(workdir, "reader")

    engine = build_orama(cfg, start_background=False, device=device)
    engine.write_side.create_collection(
        "master", "products", read_api_key="rk", write_api_key="wk"
    )
    engine.write_side.write(
        "products",
        [
            {"id": "p1", "title": "Red running shoes", "price": 59.9, "in_stock": True},
            {"id": "p2", "title": "Blue walking shoes", "price": 39.9, "in_stock": True},
            {"id": "p3", "title": "Trail running backpack", "price": 89.0, "in_stock": False},
        ],
        "wk",
    )
    engine.flush()

    out = []
    for body in QUERIES:
        res = engine.read_side.search("products", SearchParams.from_json(body), "rk")
        hits = [(h.id, round(h.score, 3)) for h in res.hits]
        facets = res.facets["in_stock"].values if res.facets else ""
        print(body, "->", hits, facets)
        out.append((body, hits, facets))

    engine.commit()
    engine.close()
    print("data persisted under", workdir)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
