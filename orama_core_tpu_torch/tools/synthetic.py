"""The synthetic 1M-document collection of the bench's engine metrics.

Port of ``benchmarks/hybrid_1m_bench.build_synthetic_reader`` (BASELINE.md
config 4's shape): Zipf posting lists over a vocabulary of ``term%06d``
words (df of rank r ~ r^-0.9, one position per posting), unit vectors for
``fake-base`` and a ``price`` number field, committed straight into a
reader without the write path. The arrays are drawn from
``np.random.default_rng(seed)`` in the reference's order (post_docs,
post_tf, positions, doc_lens, vecs, prices), so with the same arguments
they are the reference's arrays, element for element.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..index import (
    CommittedNumberIndex, CommittedStringIndex, CommittedVectorIndex,
    TermDict,
)

COLLECTION = "bench1m"


def synthetic_arrays(n_docs: int, n_terms: int, avg_postings: int, dim: int,
                     seed: int = 0) -> Dict[str, Any]:
    """Keyword arguments of ``engine.carry.reader_from_arrays`` for the
    collection: ``body`` (string, field 0), ``embedding`` (``fake-base``,
    field 1), ``price`` (number, field 2)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    weights = 1.0 / ranks ** 0.9
    df = np.maximum((weights / weights.sum() * n_docs * avg_postings)
                    .astype(np.int64), 1)
    df = np.minimum(df, n_docs)
    term_starts = np.zeros(n_terms + 1, dtype=np.int64)
    np.cumsum(df, out=term_starts[1:])
    p = int(term_starts[-1])
    post_docs = rng.integers(0, n_docs, p).astype(np.int32)
    post_tf = rng.integers(1, 5, p).astype(np.float32)
    positions = rng.integers(0, 100, p).astype(np.int32)
    doc_lens = rng.integers(20, 200, n_docs).astype(np.float32)
    td = TermDict.__new__(TermDict)
    td.terms = [f"term{t:06d}" for t in range(n_terms)]  # id order
    string_idx = CommittedStringIndex(
        term_dict=td, term_starts=term_starts, post_docs=post_docs,
        post_tf=post_tf, pos_starts=np.arange(p + 1, dtype=np.int64),
        positions=positions, doc_lens_dense=doc_lens,
        n_docs_with_field=n_docs, total_len=int(doc_lens.sum()),
    )
    vecs = rng.standard_normal((n_docs, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    prices = rng.uniform(0, 100, n_docs).astype(np.float32)
    order = np.argsort(prices)
    return {
        "collection_id": COLLECTION, "read_api_key": "rk",
        "fields": [
            {"field_id": 0, "name": "body", "type": "string"},
            {"field_id": 1, "name": "embedding", "type": "embedding",
             "model": "fake-base"},
            {"field_id": 2, "name": "price", "type": "number"},
        ],
        "arrays": {
            "string-0": string_idx.to_arrays(),
            "vector-1": CommittedVectorIndex(
                dimension=dim, vecs=vecs,
                vec_docs=np.arange(n_docs, dtype=np.int32)).to_arrays(),
            "number-2": CommittedNumberIndex(
                vals=prices[order], docs=order.astype(np.int32)).to_arrays(),
        },
        "alive": np.ones(n_docs, np.float32),
        "doc_count": n_docs, "max_doc_id": n_docs - 1,
    }


def synthetic_reader(n_docs: int, n_terms: int, avg_postings: int, dim: int,
                     seed: int = 0, device: str = "cuda"):
    """A port ``CollectionReader`` serving ``synthetic_arrays`` on
    ``device``, its device caches built."""
    from ..config import GpuConfig
    from ..engine.carry import reader_from_arrays

    reader = reader_from_arrays(
        **synthetic_arrays(n_docs, n_terms, avg_postings, dim, seed),
        gpu_cfg=GpuConfig(device=device))
    reader.warmup()
    return reader
