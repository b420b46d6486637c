"""Collections of Zipf-drawn documents, unit vectors and a number field, from a seed.

Text: each document's length in words is 1 + Poisson(``mean_doc_words``
- 1), and each of its words is drawn from ``n_terms`` words ``term%06d``
with the probability of rank r ~ r^-``zipf_exponent``. A document's
postings are its distinct words, each with its count as tf and the
position of its first occurrence, listed by term, each term's documents
distinct and ascending, as an inverted index holds them; a document's
length is its word count, so lengths and postings agree. Vectors: unit
vectors of ``dim``. Number: uniform in ``range``. A configuration without
``text``, ``vector`` or ``number`` has no such field.

``make`` draws the large blocks on the device with one ``torch.Generator``
seeded by ``--seed`` (a few large calls) and returns them as host arrays:
the inputs that both the program and the reference are given.
``reader_kwargs`` packs them into the program's committed-index layout.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch


def postings(text: Dict[str, Any], n: int, g: torch.Generator,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """The documents' words, drawn, as postings in CSR order by term:
    ``term_starts`` i64[n_terms + 1], ``post_docs`` i32, ``post_tf`` f32,
    ``positions`` i32 (the first occurrence), and ``doc_lens`` f32[n]."""
    v = int(text["n_terms"])
    lens = 1 + torch.poisson(torch.full((n,), float(text["mean_doc_words"]) - 1.0,
                                        device=device), generator=g).to(torch.int64)
    ranks = torch.arange(1, v + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -float(text["zipf_exponent"]), 0)
    cdf = (cdf / cdf[-1]).to(torch.float32)
    n_words = int(lens.sum())
    word = torch.searchsorted(cdf, torch.rand(n_words, generator=g, device=device))
    word.clamp_(max=v - 1)
    doc = torch.repeat_interleave(torch.arange(n, device=device), lens)
    pos = torch.arange(n_words, device=device) - (torch.cumsum(lens, 0) - lens)[doc]
    key, perm = torch.sort(doc * v + word, stable=True)
    del doc, word
    key, tf = torch.unique_consecutive(key, return_counts=True)
    first = pos[perm][torch.cumsum(tf, 0) - tf]  # within a key, words keep their order
    del pos, perm
    term, docs = key % v, key // v
    order = torch.sort(term * n + docs).indices
    term_starts = torch.zeros(v + 1, dtype=torch.int64, device=device)
    term_starts[1:] = torch.cumsum(torch.bincount(term, minlength=v), 0)
    return {"term_starts": term_starts, "post_docs": docs[order].to(torch.int32),
            "post_tf": tf[order].to(torch.float32),
            "positions": first[order].to(torch.int32),
            "doc_lens": lens.to(torch.float32)}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def make(cfg: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    """The collection's raw arrays (host numpy), drawn from ``seed``."""
    t0 = time.perf_counter()
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = int(cfg["n_docs"])
    raw: Dict[str, Any] = {"n_docs": n}
    text = cfg.get("text")
    if text:
        raw.update({k: _host(t) for k, t in postings(text, n, g, device).items()})
    vec = cfg.get("vector")
    if vec:
        v = torch.randn((n, int(vec["dim"])), generator=g, device=device)
        v.div_(torch.linalg.vector_norm(v, dim=1, keepdim=True))
        raw["vecs"] = _host(v)
        del v
    num = cfg.get("number")
    if num:
        lo, hi = num["range"]
        raw["numbers"] = _host(torch.rand((n,), generator=g, device=device)
                               * (hi - lo) + lo)
    raw["seconds"] = time.perf_counter() - t0
    return raw


def reader_kwargs(raw: Dict[str, Any], cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Keyword arguments of the program's ``engine.carry.reader_from_arrays``."""
    from orama_core_tpu_torch.index import (
        CommittedNumberIndex, CommittedStringIndex, CommittedVectorIndex,
        TermDict,
    )

    n = raw["n_docs"]
    fields, arrays = [], {}
    text = cfg.get("text")
    if text:
        fid = len(fields)
        td = TermDict.__new__(TermDict)
        td.terms = [f"term{t:06d}" for t in range(int(text["n_terms"]))]
        p = len(raw["post_docs"])
        arrays[f"string-{fid}"] = CommittedStringIndex(
            term_dict=td, term_starts=raw["term_starts"],
            post_docs=raw["post_docs"], post_tf=raw["post_tf"],
            pos_starts=np.arange(p + 1, dtype=np.int64),
            positions=raw["positions"], doc_lens_dense=raw["doc_lens"],
            n_docs_with_field=n, total_len=int(raw["doc_lens"].sum()),
        ).to_arrays()
        fields.append({"field_id": fid, "name": text["field"], "type": "string"})
    vec = cfg.get("vector")
    if vec:
        fid = len(fields)
        arrays[f"vector-{fid}"] = CommittedVectorIndex(
            dimension=int(vec["dim"]), vecs=raw["vecs"],
            vec_docs=np.arange(n, dtype=np.int32)).to_arrays()
        fields.append({"field_id": fid, "name": vec["field"],
                       "type": "embedding", "model": vec["model"]})
    num = cfg.get("number")
    if num:
        fid = len(fields)
        order = np.argsort(raw["numbers"], kind="stable")
        arrays[f"number-{fid}"] = CommittedNumberIndex(
            vals=raw["numbers"][order], docs=order.astype(np.int32)).to_arrays()
        fields.append({"field_id": fid, "name": num["field"], "type": "number"})
    return {
        "collection_id": cfg["name"], "read_api_key": "read-key",
        "fields": fields, "arrays": arrays,
        "alive": np.ones(n, np.float32), "doc_count": n, "max_doc_id": n - 1,
    }
