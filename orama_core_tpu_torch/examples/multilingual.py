"""Multilingual search example: per-locale analysis pipelines and
query-side stem expansion.

Demonstrates three locales where surface-prefix matching alone (the
reference's query behavior, collection.rs:928) would miss, and how the
engine's exact-stem expansion recovers them:

- Greek: ΕΛΛΗΝΙΚΑ finds ΕΛΛΗΝΙΚΟΣ via the shared Ntais stem
- Tamil:  மரம் finds both the oblique (மரத்தில்)
  and the plural (மரங்கள்)
- Turkish: kitabı (accusative, devoiced b) finds kitap

    python -m orama_core_tpu_torch.examples.multilingual [--device cpu]

Port of ``examples/multilingual.py``, on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional

from .. import build_orama
from ..config import OramaxConfig
from ..types import SearchParams

MASTER = "master"  # OramaxConfig default master key

CORPORA = {
    "el": [
        {"id": "1", "title": "τα σώματα των ανθρώπων"},
        {"id": "2", "title": "ελληνικός πολιτισμός"},
        {"id": "3", "title": "η ελληνική θάλασσα"},
    ],
    "ta": [
        {"id": "1", "title": "மரத்தில் பறவை"},
        {"id": "2", "title": "மரங்கள் வளரும்"},
    ],
    "tr": [
        {"id": "1", "title": "kitap okudum"},
        {"id": "2", "title": "kitaplar masada"},
    ],
}
QUERIES = {
    "el": ["σώμα", "ελληνικά"],
    "ta": ["மரம்"],
    "tr": ["kitabı"],
}


def main(device: str = "cuda", workdir: Optional[str] = None):
    """Returns [(locale, term, count, ids)] per query; raises when the
    committed path loses the Greek stem expansion."""
    cfg = OramaxConfig()
    d = workdir or tempfile.mkdtemp()
    cfg.writer_side.data_dir = d + "/w"
    cfg.reader_side.data_dir = d + "/r"
    e = build_orama(cfg, start_background=False, device=device)

    for loc, docs in CORPORA.items():
        e.write_side.create_collection(
            MASTER, loc, f"r-{loc}", f"w-{loc}", language=loc
        )
        e.write_side.write(loc, docs, f"w-{loc}")
    e.flush()

    out = []
    for loc, terms in QUERIES.items():
        for t in terms:
            r = e.read_side.search(
                loc, SearchParams.from_json({"term": t}), f"r-{loc}"
            )
            ids = [h.id for h in r.hits]
            print(f"[{loc}] {t!r:>14} -> {r.count} hits {ids}")
            out.append((loc, t, r.count, ids))
    e.commit()
    # committed path produces the same matches
    r = e.read_side.search(
        "el", SearchParams.from_json({"term": "ελληνικά"}), "r-el"
    )
    e.close()
    if r.count < 1:
        raise AssertionError("committed stem expansion must still match")
    print("committed-path expansion OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
