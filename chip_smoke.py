#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Builds the port's hand-written Hopper kernels (eight sources) from
``orama_core_tpu_torch/csrc`` with nvcc (sm_90a, one process per source,
all started together), then runs, failing at the first phase that fails:

1. device: the card's name and power limit, capability (9, 0);
2. three collections built straight from committed arrays onto the card:
   the shape of the repo's 1M serving setup
   (``benchmarks/hybrid_1m_bench.py``, regenerated here from a seed:
   50,000 Zipf terms with df ~ rank^-0.9, ~20M postings with one position
   each, 384-d unit vectors for ``fake-base``, a ``price`` number field),
   served once with the exact (bf16) vector index and once with
   ``vector_index="int8"``; and a chunked collection of 250,000 documents
   of 1-7 384-d vector rows each (~1M rows, as long texts split at the
   embedding model's 512-token budget give);
3. each kernel against its plain torch version on those collections'
   tensors (K1 over a ~1M-posting plan, also timed with the plan padded
   to its PLAN_BUCKETS bucket; K2 over the padded 4,194,304 x 384 bf16
   corpus with n_valid = 1,000,000 and Q = 8, and at D = 768 and 1024 on
   262,144 rows; K3 on the rows K2 selects; K4 over the ~20M-position
   phrase stream at the engine's 4-span bucket and at 32 real spans; K5
   over the int8 codes of the same corpus and at D = 768 and 1024; K6
   over the chunked corpus at m_max = 8, and at m_max = 64 on docs of up
   to 64 rows), timed with CUDA events, with the card's least time for
   the same work beside it; and K1's parts, from probes built beside the
   kernels (one ``{"k1_probe": ...}`` JSON line): the score vector's fill
   alone, the K1 design of commit 425a76e with stores for its atomics, a
   bare scatter of the same doc ids, and one grid-wide barrier;
4. the engine: 32 queries each of fulltext, phrase, hybrid RRF,
   unfiltered vector (the fused kNN) and filtered + faceted vector on the
   exact collection, unfiltered vector and hybrid RRF on the int8 one,
   and unfiltered vector on the chunked one, with the launch counts reset
   before and read after each mode; one query per mode is held against
   the same collection served on the CPU;
5. the normal entry point: ``build_orama`` on ``cuda`` ingests documents
   and commits, four times (5,000 short documents with the exact index,
   the same with the int8 index, 2,600 documents longer than the model's
   512-token budget, whose chunk rows take K6, and the 5,000 short
   documents with ``vector_index="ivf_pq"`` and ``ivf_threshold`` lowered
   to 1,000, so that commit trains IVF lists, residual PQ codes and the
   tuned nprobe and expand on the card), and every search mode is held
   against the same data directory loaded by ``build_orama(device="cpu")``.

Before phase 5, the ANN phase (one ``{"ann": ...}`` line): the 1M
collection's text and ``price`` with its vectors replaced by
``benchmarks/ann_10m_bench.py``'s clustered corpus (2,000 unit modes,
noise of norm ~0.25, L2-normalised rows, made on the card from a seed),
served with ``vector_index`` = ``ivf``, ``pq`` and ``ivf_pq`` in turn. For
each: the build on the card by the calls ``commit`` makes (seconds,
clusters, list cap, tuned nprobe and expand, GiB of the ANN structures),
recall@10 of 64 near-duplicate queries against brute force over the same
bf16 rows (at least 0.95 for ``ivf`` and ``ivf_pq``; ``pq``'s is
recorded), 32 queries each of unfiltered vector, hybrid RRF (which must
launch K1) and filtered + faceted vector through ``search`` with their
p50 (and, with ``--profile``, device ms and idle share), one query per
mode held against a CPU reader of the same trained arrays (equal hit
ids), and the device ms of one query's ANN search (at 8 and 20 timed
calls; with ``--profile``, its kernel count) and of its ADC scan.

After the ANN phase, the mesh phase (one ``{"mesh": ...}`` line):
``mesh_shape=(4, 1)`` readers, all four shards on card 0, built from the
same committed arrays as single-device readers of the exact collection
(with one posting per (term, doc)), the chunked one, and the ANN phase's
trained IVF-PQ index; 32 queries each of fulltext, phrase, vector (the
per-shard fused kNN), filtered + faceted vector, hybrid RRF and min-max,
chunked vector and IVF-PQ vector, every hit list held against the
single-device reader's (IVF-PQ: no rank scores lower, the union of the
shards' candidates holding the single-device set; one query against the
same mesh on the CPU), with K1, K4, K2, K3 and K6 required to launch at
least once per shard per query of their modes; p50 sharded and single,
the launches, the sharded layouts' GiB; with two or more cards, the exact
collection again with its shards spread over them; then the multi-slice
router over two ``build_orama`` engines on the card (5,000 documents,
``sync_global_stats``) against one engine that holds every document.

Phase 3 also checks and times K3 at 128, 1,024 and 4,096 selected slots
(Q = 8, 64, 256 at k = 16; one ``{"k3_shapes": ...}`` line) and K1 over
the combined plan of a batch of 64 Zipf-drawn terms (row ids; in the K1
probe line, with the fill of its 64 x capacity scores). After phase 3,
K2 and K6 are each checked and timed at Q = 1 (the engine's shape), 8
and 64, and K2 at 256 (batched serving's), on the exact and chunked
corpora, and K5 at Q = 1, 8, 64 and 256 on the exact corpus's codes and
on the bench's 1,000,000 x 768 codes and at Q = 64 on one chunk of
``int8_30m_bench`` (999,424 x 384), each K5 entry equal to its plain
version bit for bit, all with their bounds (one ``{"q_sweep": ...}``
JSON line). After
phase 4, batched serving on the exact collection: ``search_batch`` at
B = 8, 64 and 256 for vector, fulltext and hybrid RRF, each row held
against the single-query ``search`` and one batch of 8 per mode against
the CPU (one ``{"batch": ...}`` line: queries/s over a window of
back-to-back batches, batch p50 and max); the same collection with a
``title`` field beside ``body`` serves batches of 64 fulltext and hybrid
queries (the per-row span scorer's route) against the same queries one
by one (one ``{"two_fields": ...}`` line); and the batched RRF's two
rank methods are timed at B = 1 to 256 (one ``{"rrf_ranks": ...}``
line). After phase 5, ``build_orama`` with ``query_batching=True``
serves 24 concurrent threads through the micro-batcher with the
unbatched hits (one ``{"batcher": ...}`` line).

Last, the serve phase (one ``{"serve": ...}`` line): the port's
``WebServer`` in-process on the card with ``ai.backend="jax"``
(``jax-minilm`` embeddings, the ``jax-tiny`` decoder) and the background
loops; 5,000 short and 2,000 long documents inserted over HTTP until all
are committed with their vectors (ingest seconds, passages/s); 32 queries
each of fulltext, phrase, vector, hybrid RRF and chunked vector over HTTP
(K1-K4, K6), each held against the in-process ``read_side.search`` (p50
of both); one answer and one planned-answer stream in the reference's
event order; the card's passage embeddings against the plain CPU encoder
on the same parameters (cosine >= 0.999); the hooks step (under the
line's ``"hooks"`` key): 5,000 one-row documents (a unique ``ref``
token, ``kind``, title, summary, tags, body) inserted over HTTP into a
collection without a hook and then into
one with a dynamic ``selectEmbeddingProperties`` hook installed over
``hooks/create`` (a branch, a template literal, an array method, a throw
that vetoes 16 documents), the hook's host ms per document (in ingest
and alone) and both ingests' passages/s; 64 sampled stored vectors
against the plain CPU encoder on the text the port's MiniJS selects
(cosine >= 0.999), the vetoed documents stored and fulltext-searchable
with no vector row, 32 vector queries on the hooked text (the document
first; K2, K3) and 32 fulltext queries (K1), each over HTTP and in
process with equal hits, and after ``hooks/remove`` a new document
embedded from its default text; ``tests/assets/tiny-semantic``
loaded on the card by the port's own reader and tokenizer, ranking
tests/test_semantic_e2e.py's four queries; encoder throughput at the
jax-minilm and bge-small widths for 64 x 128 and 64 x 512 tokens against
its bound; the decoder at Qwen2.5-3B's width (seeded bf16 weights made on
the card): prefill of 512 tokens, decode ms per token over 64 tokens
against the bytes a token reads, GiB, and the cached decode's logits
against a full forward.

Then the tp phase (one ``{"tp": ...}`` line): the tensor-parallel encoder
(``param_specs`` placed by ``parallel.mesh.shard_params``, every model
shard stacked on card 0) at both widths and lengths on meshes (2, 2) and
(1, 4), bf16 rows against the single device's (cosine >= 0.999) and f32
within 2e-5; the decoder at Qwen2.5-3B's width on (1, 2) and (1, 4),
teacher-forced through the single device's 64 greedy tokens (relative
L2 of the logits within ``TP_NOISE_FACTOR`` times the single device's
bf16-against-f32 distance at every step, the (1, 1) control exact, the
first token equal), f32 at 2 layers within ``DECODER_REL_TOL``; ms and
device work items per forward and per token beside the single device's,
GiB a shard. The single-device capacity race on the card (8 searching
threads while a writer grows the capacity past three buckets and
commits; K1 and K4 launched, hits held to a CPU reader of the state
read) and ``utils/benchgen.py``'s corpus at 1M x 384 against the CPU's
rows close it.

Last, the train phase (one ``{"train": ...}`` line): the encoder trained
on the card by ``tools/train_tiny_encoder`` at
``scripts/train_tiny_encoder.py``'s defaults (700 steps of batch 96,
hidden 96, 2 layers, f32; held-out topic accuracy above 0.85, loader round
trip at least 0.999, ms a step by CUDA events, peak GiB); one batch's
loss and gradients on the card against the CPU from the same parameters
(the CPU parity test's limits); 200 steps at jax-minilm's width (hidden
384, 6 layers) whose loss collapses to ln 96 as the reference's does,
ms and host ms a step, device work items a step and the bound (3 x the
forward's f32 FLOPs / 67 TFLOP/s); ``build_orama`` serving 4,608
held-out passages from the trained checkpoint, 256 queries each of
vector, hybrid RRF and phrase with topic accuracy@1 at least 0.85 and
K1-K4 launched, their calls held to the plain twins and every query to a
CPU engine fed the card's encoder rows; ``tools/warm_cache`` as its
own process after the kernel libraries are deleted (it builds all eight;
the next first query rebuilds none) and ``tools/prepare_checkpoint`` on
the trained directory.

Then the tune phase (one ``{"tune": ...}`` line): the kernel probes of
``benchmarks/`` at their full shapes, driven through the port's two probe
tools with the launch counts reset before and read after.
``tools/knn_tune_bench`` times B1's forms (``csrc/knn_phase1_variants.cu``:
the per-sub-block max at sub 32, 64 and 128, masked everywhere or at the
edge, queries as [Q, D] or qt [D, Q]; k_mm's bare product rows, which
must take at least the corpus's read time, beside torch.matmul over the
kept rows), K2 at the same shape, B2 (K3 on qt.T at 2,560 selected
sub-blocks) and the end-to-end rows over a 1,000,000 x 768 bf16 corpus
and 256 queries; ``tools/bm25_scan_bench`` holds K1 and B3's four-plane
and packed forms (``csrc/bm25_scan_variants.cu`` on the doc-tile core
``csrc/bm25_tiles.cuh``, plan blocks of 1,024, 4,096 and 8,192) to the
numpy oracle and times them on ~998k Zipf postings over 1,048,576 docs.
Every form is then held to its plain version at those shapes (B1 within
1e-5, B2 within 1e-4, the scans within rtol 1e-5), and each form's
record joins the kernels line (B2 as ``knn_rescore_b2``: the K3 launches
of the probe's B2 row, which K3's own record then leaves out). The
doc-tile kernel's repair count must not move over any of B3's calls on
the bench's ascending windows; one call on the same data with its first
window shuffled must match its plain version and raise the count by
one.

Then the entry phase (one ``{"entry": ...}`` line): the port's
entry points. ``python -m orama_core_tpu_torch.bench``'s run at its full
size (its five result lines; its recall@10 against the f32 exact top-k
at least 0.95; K1, K2, K3 and K5 launched), with each of its steps timed
again by CUDA events beside its K2 or K5 alone (where a step's time
goes); ``tools/graft_entry``'s forward and its dry run on four mesh
positions of card 0; ``orama_core_tpu_torch.start()`` in its own process
on the card, answering 2,000 documents inserted over HTTP and one query
held against an in-process engine fed the same writes (then killed);
and the six BASELINE-config tools (``embed_bench``, ``int8_30m_bench``,
``pq_100m_bench``, ``engine_bench``, ``sharded_int8_bench``,
``sharded_ivfpq_bench``) at their defaults, the published widths and
depths (``ENTRY_TOOLS``), each line checked for its metric name, finite
positive values, its recall floor and one card, and each tool's kernel
launches kept apart and checked for the kernels its path must run (K5
for ``int8_30m``; K1, K4, K2 and K3 for ``engine_bench``; K2 and K3 for
``sharded_ivfpq``'s exact reader; none for the encoder, ``pq_100m`` and
``sharded_int8``, whose exact engine holds two embedding fields and so
scores densely, as its script's does).

With ``--profile``, each engine mode and each batch shape is also traced
with torch.profiler (device busy share, top ops by device time and, per
engine mode, by host self time). The
last three lines are the card's name and power limit, the kernels' JSON
record and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result; nothing runs on the CPU in
its place.

``--k3-compare DIR`` also builds DIR's ``orama_core_tpu_torch/csrc/
knn_rescore.cu`` (an export of an earlier commit) and times it on the
same K3 selections (``compare_ms``).

``--sweep-only`` builds the kernels and runs only the Q sweep, on the same
shapes made on the card from a seed (no collections), then the entry
phase's split of the bench's steps (``{"entry_split": ...}``: the fused
kNN calls at 64 and 256 queries with K2 alone, the 64-query int8 call
with K5 alone), and prints no result line. The sweep and the split need
nothing beyond the kernel wrappers, ``bench.py``, ``utils/benchgen.py``
and ``tools/int8_30m_bench.py``, so this file, copied into a checkout of
an earlier commit of the port that has those, measures that commit's K2,
K5 and K6 and the bench's steps the same way: run both on one card, in
turns (parent, change, change, parent).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the one yardstick of every kernel record, the probes' included: peak
# rates, bounds, device timing and the card line
from orama_core_tpu_torch.tools.timing import (  # noqa: E402
    BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S, INT8_OPS, bound_ms, card_line,
    time_ms,
)
TPU_KERNELS = {
    "bm25_scan": ("orama_core_tpu_torch/csrc/bm25_scan.cu",
                  "orama_core_tpu/ops/bm25.py:324"),
    "knn_subblock_max": ("orama_core_tpu_torch/csrc/knn_subblock_max.cu",
                         "orama_core_tpu/ops/pallas_knn.py:51"),
    "knn_rescore": ("orama_core_tpu_torch/csrc/knn_rescore.cu",
                    "orama_core_tpu/ops/pallas_knn.py:226"),
    "phrase_counts": ("orama_core_tpu_torch/csrc/phrase_counts.cu",
                      "orama_core_tpu/ops/bm25.py:788"),
    "knn_subblock_max_int8": (
        "orama_core_tpu_torch/csrc/knn_subblock_max_int8.cu",
        "orama_core_tpu/ops/pallas_knn.py:94"),
    "knn_subblock_max_mv": ("orama_core_tpu_torch/csrc/knn_subblock_max_mv.cu",
                            "orama_core_tpu/ops/pallas_knn.py:442"),
    # no Pallas kernel: the reference's jnp.dot, left to XLA
    "knn_dense_scores": ("orama_core_tpu_torch/csrc/knn_dense_scores.cu",
                         "orama_core_tpu/ops/vector.py:66"),
    # the probe forms of benchmarks/ (the tune phase)
    "knn_max_only": ("orama_core_tpu_torch/csrc/knn_phase1_variants.cu",
                     "benchmarks/knn_tune_bench.py:114"),
    "knn_max_only_edge": ("orama_core_tpu_torch/csrc/knn_phase1_variants.cu",
                          "benchmarks/knn_tune_bench.py:136"),
    "knn_max_only_qt": ("orama_core_tpu_torch/csrc/knn_phase1_variants.cu",
                        "benchmarks/knn_tune_bench.py:128"),
    "knn_phase1_rows": ("orama_core_tpu_torch/csrc/knn_phase1_variants.cu",
                        "benchmarks/knn_tune_bench.py:122"),
    "bm25_scan_wide": ("orama_core_tpu_torch/csrc/bm25_scan_variants.cu",
                       "benchmarks/bm25_scan_bench.py:86"),
    "bm25_scan_packed": ("orama_core_tpu_torch/csrc/bm25_scan_variants.cu",
                         "benchmarks/bm25_scan_bench.py:149"),
    # B2 is K3 itself, called on qt.T at the probe's shape
    "knn_rescore_b2": ("orama_core_tpu_torch/csrc/knn_rescore.cu",
                       "benchmarks/knn_tune_bench.py:350"),
}
N_DOCS, N_TERMS, AVG_POSTINGS, DIM = 1_000_000, 50_000, 20, 384


class SmokeFailure(RuntimeError):
    pass


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# -- data ---------------------------------------------------------------------


def synth_arrays(n_docs=N_DOCS, n_terms=N_TERMS, avg_postings=AVG_POSTINGS,
                 dim=DIM, seed=0):
    """Committed arrays of the 1M serving setup, from a seed."""
    from orama_core_tpu_torch.index import (
        CommittedNumberIndex, CommittedVectorIndex,
    )

    rng = np.random.default_rng(seed)
    string_idx = synth_string_index(rng, n_docs, n_terms, avg_postings,
                                    (20, 200))
    vecs = rng.standard_normal((n_docs, dim), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    prices = rng.uniform(0, 100, n_docs).astype(np.float32)
    order = np.argsort(prices)
    return {
        "collection_id": "smoke1m", "read_api_key": "rk",
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


def synth_string_index(rng, n_docs, n_terms, avg_postings, doc_len_range):
    """A committed string index of Zipf terms (df ~ rank^-0.9), one
    position per posting."""
    from orama_core_tpu_torch.index import CommittedStringIndex, TermDict

    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    weights = 1.0 / ranks ** 0.9
    df = np.maximum((weights / weights.sum() * n_docs * avg_postings)
                    .astype(np.int64), 1)
    df = np.minimum(df, n_docs)
    term_starts = np.zeros(n_terms + 1, np.int64)
    np.cumsum(df, out=term_starts[1:])
    p = int(term_starts[-1])
    td = TermDict.__new__(TermDict)
    td.terms = [f"term{t:06d}" for t in range(n_terms)]
    doc_lens = rng.integers(*doc_len_range, n_docs).astype(np.float32)
    return CommittedStringIndex(
        term_dict=td, term_starts=term_starts,
        post_docs=rng.integers(0, n_docs, p).astype(np.int32),
        post_tf=rng.integers(1, 5, p).astype(np.float32),
        pos_starts=np.arange(p + 1, dtype=np.int64),
        positions=rng.integers(0, 100, p).astype(np.int32),
        doc_lens_dense=doc_lens, n_docs_with_field=n_docs,
        total_len=int(doc_lens.sum()),
    )


def unique_postings(s):
    """String index arrays ``s`` with one posting per (term, doc),
    doc-ascending within each term, as an index built from documents
    holds. (synth_string_index draws docs with repeats; the Zipf-head
    dense rows and the span scorer score a repeated posting differently,
    and only the span scorer's route needs the difference gone.)"""
    ts = s["term_starts"]
    n_docs = len(s["doc_lens_dense"])
    tid = np.repeat(np.arange(len(ts) - 1, dtype=np.int64), np.diff(ts))
    keep = np.unique(tid * n_docs + s["post_docs"], return_index=True)[1]
    counts = np.bincount(tid[keep], minlength=len(ts) - 1)
    return dict(s, post_docs=s["post_docs"][keep], post_tf=s["post_tf"][keep],
                positions=s["positions"][keep],
                pos_starts=np.arange(len(keep) + 1, dtype=np.int64),
                term_starts=np.concatenate([[0], np.cumsum(counts)])
                .astype(ts.dtype))


def with_title(arrays, avg_postings=3, seed=5):
    """``arrays`` with a second string field, ``title`` (the same Zipf
    vocabulary, ~3 postings per doc, 2-12 tokens), both fields with
    unique postings: the common title + body shape. Batched fulltext and
    hybrid queries on two string fields take the per-row span scorer
    (``search_fulltext_batch``), not the batched fused program, as the
    reference routes them."""
    n_docs = arrays["doc_count"]
    title = synth_string_index(np.random.default_rng(seed), n_docs, N_TERMS,
                               avg_postings, (2, 12))
    return dict(arrays, collection_id="smoke1m_title",
                fields=arrays["fields"] + [
                    {"field_id": 3, "name": "title", "type": "string"}],
                arrays=dict(arrays["arrays"], **{
                    "string-0": unique_postings(arrays["arrays"]["string-0"]),
                    "string-3": unique_postings(title.to_arrays())}))


def synth_multivec_arrays(n_docs=250_000, max_chunks=7, dim=DIM, seed=3):
    """Committed arrays of a chunked collection, from a seed: each doc has
    1..max_chunks unit vector rows, doc-ascending (the write path's
    layout), for ``fake-base``."""
    from orama_core_tpu_torch.index import CommittedVectorIndex

    rng = np.random.default_rng(seed)
    nch = rng.integers(1, max_chunks + 1, n_docs)
    vec_docs = np.repeat(np.arange(n_docs, dtype=np.int32), nch)
    vecs = rng.standard_normal((len(vec_docs), dim), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return {
        "collection_id": "smoke_mv", "read_api_key": "rk",
        "fields": [{"field_id": 0, "name": "embedding", "type": "embedding",
                    "model": "fake-base"}],
        "arrays": {"vector-0": CommittedVectorIndex(
            dimension=dim, vecs=vecs, vec_docs=vec_docs).to_arrays()},
        "alive": np.ones(n_docs, np.float32),
        "doc_count": n_docs, "max_doc_id": n_docs - 1,
    }


def make_reader(arrays, device: str, vector_index: str = "exact"):
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.carry import reader_from_arrays

    return reader_from_arrays(**arrays, gpu_cfg=GpuConfig(
        device=device, vector_index=vector_index))


def zipf_term(rng, n_words=1, n_terms=N_TERMS) -> str:
    """Query terms drawn as bench.py draws them (Zipf-like head bias)."""
    ids = (rng.pareto(1.2, n_words) * 50).astype(int) % n_terms
    return " ".join(f"term{t:06d}" for t in ids)


# -- checks -------------------------------------------------------------------


def check_hits(got, want, rtol: float, what: str) -> None:
    """Same ranked hits: scores within rtol position by position, and the
    same ids except that docs whose scores tie within rtol may swap
    (order among near-equal floats depends on summation order)."""
    require(len(got) == len(want), f"{what}: {len(got)} hits vs {len(want)}")
    gs = np.asarray([s for _, s in got], np.float64)
    ws = np.asarray([s for _, s in want], np.float64)
    require(bool(np.all(np.isfinite(gs))), f"{what}: non-finite scores")
    require(np.allclose(gs, ws, rtol=rtol, atol=0),
            f"{what}: scores differ\n{gs[:8]}\n{ws[:8]}")
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and abs(ws[j] - ws[i]) <= rtol * abs(ws[i]):
            j += 1
        if j < len(want):  # a tie group cut by the limit may differ
            require({d for d, _ in got[i:j]} == {d for d, _ in want[i:j]},
                    f"{what}: ids differ at ranks {i}..{j - 1}")
        i = j


def kernel_record(name, max_abs_err, ms, plain_ms, bytes_moved, ops,
                  peak_ops, library_ms=None):
    b, by = bound_ms(bytes_moved, ops, peak_ops)
    src, rep = TPU_KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": 0, "max_abs_err": float(max_abs_err), "ms": float(ms),
        "plain_ms": float(plain_ms), "bound_ms": float(b), "bound_by": by,
        "library_ms": library_ms,
    }


def phase_kernels(reader, rng, probe_lib, compare_lib=None):
    """Each kernel against its plain version on the collection's tensors;
    ``probe_lib``: the built K1 probes (build_kernels_and_probes);
    ``compare_lib``: another build of K3 to time beside this one, or
    None."""
    import torch

    from orama_core_tpu_torch.ops import bm25, knn

    cap = reader.capacity
    sf = reader._string[0]
    c = sf.committed
    gi = c.global_info()
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []

    # K1: four consecutive light-term spans (past the dense head rows) of
    # ~1M postings each; one is checked, all four are timed in turn (their
    # ~80 MB exceed the L2, as a stream of different query terms would).
    # The scalars live on the card, as the fused program passes them. The
    # record's plans hold the blocks the spans need; the same spans are
    # also timed with their plans padded to a PLAN_BUCKETS bucket, as the
    # engine builds them.
    from orama_core_tpu_torch.utils import bucket_pad

    d_docs, d_tf, d_ni, d_plens = reader._device.string_arrays(c)
    ts = c.term_starts
    scal = [torch.tensor(x, dtype=torch.float32, device="cuda")
            for x in (1.0, gi.avgdl, float(gi.total_documents))]
    calls, padded, spans_k1, n_posts, n_blocks = [], [], [], [], []
    t0 = 64
    for _ in range(4):
        t1 = int(np.searchsorted(ts, ts[t0] + 1_000_000))
        p_lo, p_len = [int(ts[t0])], [int(ts[t1] - ts[t0])]
        for nb, into in ((bm25.aligned_blocks_needed(p_len), calls),
                         (bucket_pad(bm25.aligned_blocks_needed(p_len),
                                     bm25.PLAN_BUCKETS), padded)):
            plan = [torch.as_tensor(a, device="cuda")
                    for a in bm25.build_block_plan_aligned(p_lo, p_len, nb)]
            into.append(((d_docs, d_tf, d_ni, d_plens, *plan, *scal),
                         dict(n_docs=cap, n_blocks=nb)))
        spans_k1.append((p_lo[0], p_len[0]))
        n_posts.append(p_len[0])
        n_blocks.append(calls[-1][1]["n_blocks"])
        t0 = t1
    err = 0.0
    for args, kw in (calls[0], padded[0]):
        got = bm25.bm25_scores_blocked_aligned(*args, **kw)
        want = bm25.bm25_scores_blocked_aligned_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                f"K1 disagrees with its plain version at {kw}: max err {err}")
        require(int((got > 0).sum()) > 100_000, "K1 scored too few docs")
    # the doc bound: a row half the capacity, so about half of the plan's
    # doc ids lie past it and are dropped, by the kernel as by its twin
    args, kw = calls[0]
    half = dict(kw, n_docs=cap // 2)
    got = bm25.bm25_scores_blocked_aligned(*args, **half)
    want = bm25.bm25_scores_blocked_aligned_plain(*args, **half)
    torch.cuda.synchronize()
    require(got.shape == (cap // 2,) and torch.allclose(
        got, want, rtol=1e-5, atol=1e-6), "K1 wrote past its row or "
            f"disagrees there: max err {(got - want).abs().max().item()}")
    ms = time_ms([lambda a=a, k=k: bm25.bm25_scores_blocked_aligned(*a, **k)
                  for a, k in calls], 40)
    pad_ms = time_ms([lambda a=a, k=k: bm25.bm25_scores_blocked_aligned(
        *a, **k) for a, k in padded], 40)
    pms = time_ms([lambda a=a, k=k: bm25.bm25_scores_blocked_aligned_plain(
        *a, **k) for a, k in calls], 8)
    n_post = float(np.mean(n_posts))
    out.append(kernel_record(
        "bm25_scan", err, ms, pms,
        bytes_moved=n_post * 16 + np.mean(n_blocks) * 12 + cap * 4,
        ops=n_post * 20, peak_ops=F32_FLOPS))
    log(f"K1 ok: {n_posts} postings, err {err:.3g}, {ms:.4f} ms (0.0197 "
        "before the row bound, on an H100 80GB HBM3 at 700 W), doc ids past "
        f"a row dropped; plans "
        f"padded to buckets {[k['n_blocks'] for _a, k in padded]} (from "
        f"{n_blocks} blocks): {pad_ms:.4f} ms")
    probe = k1_probes(probe_lib, calls, spans_k1, d_docs, cap)
    probe.update(k1_ms=ms, k1_padded_ms=pad_ms, postings=n_posts,
                 batch64=k1_batch(reader, rng, scal))
    print(json.dumps({"k1_probe": probe}), flush=True)

    # K2: the padded corpus, n_valid real rows, Q = 8
    vf = reader._vector[1]
    vecs, _docs, _valid = reader._device.vector_arrays(vf.committed)
    n_valid = vf.committed.n_vectors
    qd = unit_queries(rng, 8, vecs.shape[1])
    err, _ = check_k2(vecs, qd, n_valid)
    ms = time_ms(lambda: knn.subblock_max(vecs, qd, 32, n_valid), 20)
    pms = time_ms(lambda: knn.subblock_max_plain(vecs, qd, 32, n_valid), 3)
    d = vecs.shape[1]
    out.append(kernel_record(
        "knn_subblock_max", err, ms, pms,
        *k2_work(vecs.shape[0], n_valid, d, 8), peak_ops=BF16_FLOPS))
    log(f"K2 ok: err {err:.3g}, {ms:.4f} ms")
    # K2 at the registry's wider embedding widths (768: bge-base, 1024:
    # bge-large), whose rows must not outgrow the kernel's shared memory
    for width in (768, 1024):
        vw = torch.randn(262_144, width, generator=gen, device="cuda")
        vw = (vw / vw.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        qw = torch.randn(8, width, generator=gen, device="cuda")
        qw = (qw / qw.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        werr, _ = check_k2(vw, qw, 250_000)
        wms = time_ms(lambda: knn.subblock_max(vw, qw, 32, 250_000), 10)
        log(f"K2 ok at D={width}: 262,144 rows, n_valid 250,000, Q=8, "
            f"err {werr:.3g}, {wms:.4f} ms")
        del vw

    out.append(check_dense_scores(gen))

    # K3: the sub-blocks phase 2 selects (k = 16) at Q = 8 (the record:
    # 128 slots), 64 and 256 (batched serving: 1,024 and 4,096 slots)
    shapes = k3_shapes(vecs, n_valid, gen, compare_lib)
    rec = shapes["slots=128"]
    out.append(kernel_record(
        "knn_rescore", rec["max_abs_err"], rec["ms"], rec["plain_ms"],
        *k3_work(128, 8, d), peak_ops=BF16_FLOPS))
    print(json.dumps({"k3_shapes": shapes}), flush=True)

    # K4: the whole phrase stream, spans of two Zipf-drawn terms in the
    # engine's 4-span bucket (the record); then 32 real spans, the longest
    # phrase a query can ask for
    tw, bits, bounds = reader._device.phrase_stream_arrays(c, cap)
    tids = (rng.pareto(1.2, 2) * 50).astype(int) % N_TERMS
    spans = torch.tensor([[t, t + 1] for t in tids] + [[0, 0]] * 2,
                         dtype=torch.int32, device="cuda")
    tids32 = rng.choice(N_TERMS, 32, replace=False)
    spans32 = torch.tensor([[t, t + 1] for t in tids32], dtype=torch.int32,
                           device="cuda")
    for sp in (spans, spans32):
        a1, s1 = bm25.phrase_counts(bits, tw, bounds, sp, cap)
        a2, s2 = bm25.phrase_counts_plain(bits, tw, bounds, sp, cap)
        torch.cuda.synchronize()
        require(torch.equal(a1, a2) and torch.equal(s1, s2),
                f"K4 counts differ from the plain version at "
                f"{sp.shape[0]} spans")
        require(int(a1.sum()) > 0, "K4 counted nothing")
    a1, _s1 = bm25.phrase_counts(bits, tw, bounds, spans, cap)
    ms = time_ms(lambda: bm25.phrase_counts(bits, tw, bounds, spans, cap), 20)
    ms32 = time_ms(lambda: bm25.phrase_counts(bits, tw, bounds, spans32, cap),
                   20)
    pms = time_ms(lambda: bm25.phrase_counts_plain(bits, tw, bounds, spans,
                                                   cap), 3)
    # bytes it must move: the bits and term id of every position, the doc
    # id of each counted group head only (one per anyorder count), the
    # spans, and the two int32[cap] counters
    pp = bits.numel()
    heads = int(a1.sum())
    out.append(kernel_record(
        "phrase_counts", 0.0, ms, pms,
        bytes_moved=pp * 5 + heads * 4 + spans.numel() * 4 + cap * 8,
        ops=pp * 4 * spans.shape[0], peak_ops=F32_FLOPS))
    log(f"K4 ok: {pp} positions, exact at 4 and 32 spans, {ms:.4f} ms "
        f"(4 spans, 2 real), {ms32:.4f} ms (32 real spans)")
    return out


def k1_batch(reader, rng, scal, b=64, n_plans=4):
    """K1 over a batch's combined plan, as the batched fused program
    builds it (``build_batch_plan_aligned``) for ``b`` Zipf-drawn single
    terms, their Zipf-head parts left to the dense rows. Checked against
    its plain twin (rtol 1e-5) and timed over ``n_plans`` such batches in
    turn, beside the fill of its b x cap scores alone."""
    import torch

    from orama_core_tpu_torch.ops import bm25

    cap = reader.capacity
    c = reader._string[0].committed
    gi = c.global_info()
    cols = reader._device.string_arrays(c)
    _rows, row_by_term = reader._device.dense_term_rows(c, cap, gi.avgdl)
    term_df, ts = c.term_df(), c.term_starts
    plans, posts = [], []
    for _ in range(n_plans):
        tids = (rng.pareto(1.2, b) * 50).astype(int) % N_TERMS
        rows = [bm25.split_spans_dense([(int(t), int(t) + 1)], ts,
                                       row_by_term or {}, term_df,
                                       gi.total_documents)[:2] for t in tids]
        plan = bm25.build_batch_plan_aligned(rows)
        plans.append(([torch.as_tensor(a, device="cuda") for a in plan],
                      dict(n_docs=cap, n_blocks=len(plan[0]), b=b)))
        posts.append(sum(sum(p_len) for _lo, p_len in rows))
    args, kw = plans[0]
    got = bm25.bm25_scores_blocked_aligned_batch(*cols, *args, *scal, **kw)
    want = bm25.bm25_scores_blocked_aligned_batch_plain(*cols, *args, *scal,
                                                        **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
            f"K1 over a B={b} combined plan disagrees: max err {err}")
    require(int((got > 0).sum()) > 0, "K1 batch scored nothing")
    del got, want
    ms = time_ms([lambda a=a, k=k: bm25.bm25_scores_blocked_aligned_batch(
        *cols, *a, *scal, **k) for a, k in plans], 20)
    pms = time_ms([lambda a=a, k=k: bm25.bm25_scores_blocked_aligned_batch_plain(
        *cols, *a, *scal, **k) for a, k in plans], 4)
    fill_ms = time_ms(lambda: torch.zeros(b * cap, dtype=torch.float32,
                                          device="cuda"), 20)
    n_post = float(np.mean(posts))
    blocks = float(np.mean([k["n_blocks"] for _a, k in plans]))
    bound, _by = bound_ms(n_post * 16 + blocks * 16 + b * cap * 4,
                          n_post * 20, F32_FLOPS)
    res = {"rows": b, "postings": posts, "n_blocks": [k["n_blocks"] for
                                                      _a, k in plans],
           "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound,
           "fill_ms": fill_ms, "fill_share": fill_ms / ms}
    log(f"K1 batch ok: {res}")
    return res


def k3_work(nsel, q, d, sub=32):
    """(bytes, operations) K3 must spend: the selected slabs, the queries
    and the ids read once, the sims written once; a multiply-add per slab
    element."""
    return (nsel * sub * d * 2 + q * d * 2 + nsel * 4 + nsel * sub * 4,
            2 * nsel * sub * d)


def k3_shapes(vecs, n_valid, gen, compare_lib, k=16, sub=32):
    """K3 at Q = 8, 64 and 256 (128, 1,024 and 4,096 slots) on the rows
    that K2 and the phase-2 selection pick for random unit queries:
    checked against its plain version (1e-4), then timed over 24 query
    batches' selections in turn (so their slabs are read from memory,
    past the L2), with its bound; and ``compare_lib`` (another build of
    K3 with the same C entry point) on the same selections."""
    import torch

    from orama_core_tpu_torch.ops import _cuda, knn

    d = vecs.shape[1]
    out = {}
    for q in (8, 64, 256):
        sel = []
        for _ in range(24):
            qx = torch.randn(q, d, generator=gen, device="cuda")
            qx = (qx / qx.norm(dim=1, keepdim=True)).to(torch.bfloat16)
            mx, _ = knn.subblock_max(vecs, qx, sub, n_valid)
            sel.append((qx, knn._tiered_subblock_topk(mx, k).reshape(-1)
                        .to(torch.int32)))
            del mx
        qx, ids = sel[0]
        got = knn.rescore_subblocks(vecs, qx, ids, k, sub)
        want = knn.rescore_subblocks_plain(vecs, qx, ids, k, sub)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(err <= 1e-4, f"K3 disagrees at Q={q}: {err}")
        nsel = ids.numel()
        ms = time_ms([lambda q_=q_, i_=i_: knn.rescore_subblocks(
            vecs, q_, i_, k, sub) for q_, i_ in sel], 96)
        pms = time_ms([lambda q_=q_, i_=i_: knn.rescore_subblocks_plain(
            vecs, q_, i_, k, sub) for q_, i_ in sel], 24)
        b, _by = bound_ms(*k3_work(nsel, q, d, sub), BF16_FLOPS)
        rec = {"slots": nsel, "queries": q, "max_abs_err": err, "ms": ms,
               "plain_ms": pms, "bound_ms": b, "share": b / ms}
        if compare_lib is not None:
            outs = [torch.empty(nsel, sub, device="cuda") for _ in sel]

            def other(i):
                q_, i_ = sel[i]
                _cuda.check(compare_lib.knn_rescore(
                    vecs.data_ptr(), q_.data_ptr(), i_.data_ptr(),
                    outs[i].data_ptr(), nsel, d, q, k, sub, _cuda.stream()),
                    "compared K3")

            other(0)
            torch.cuda.synchronize()
            require((outs[0] - want).abs().max().item() <= 1e-4,
                    f"the compared K3 disagrees at Q={q}")
            rec["compare_ms"] = time_ms([lambda i=i: other(i)
                                         for i in range(len(sel))], 96)
        out[f"slots={nsel}"] = rec
        log(f"K3 ok at Q={q}: {rec}")
        del sel, got, want
    return out


def build_compare_k3(src):
    """``--k3-compare DIR``: DIR's ``orama_core_tpu_torch/csrc/
    knn_rescore.cu`` (an earlier commit's K3, the same C entry point)
    built into build/k3_compare/ and loaded."""
    import ctypes

    from orama_core_tpu_torch.ops import _cuda

    cu = os.path.join(src, "orama_core_tpu_torch", "csrc", "knn_rescore.cu")
    require(os.path.exists(cu), f"--k3-compare: no {cu}")
    out = os.path.join(ROOT, "build", "k3_compare")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libknn_rescore.so")
    res = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I",
                          os.path.dirname(cu), "-o", so, cu],
                         capture_output=True, text=True)
    require(res.returncode == 0, f"the compared K3 did not build:\n"
            f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    lib.knn_rescore.argtypes = _cuda.SIGNATURES["knn_rescore"]["knn_rescore"]
    lib.knn_rescore.restype = ctypes.c_int
    return lib


# Measurement probes of K1's parts (not kernels of the port): the K1 design
# of commit 425a76e (one thread per posting, a 1024-thread block per plan
# block) with its atomicAdd replaced by a coalesced store, a bare scatter
# of the same postings' doc ids (atomicAdd of 1.0, no other loads), and
# one grid-wide barrier in a cooperative launch as large as K1's grid.
K1_PROBE_SRC = r"""
#include <cuda_runtime.h>

__global__ void k1_store(const int* docs, const float* tf, const float* ni,
                         const float* lens, const int* blk, const int* lo,
                         const int* hi, float boost, float avgdl, float nfd,
                         float* out) {
  const int b = blockIdx.x;
  const int h = hi[b];
  const int j = lo[b] + threadIdx.x;
  if (j >= h) return;
  const long long p = (long long)blk[b] * 1024 + j;
  const float t = tf[p], n = ni[p];
  const float idf = log1pf(fmaxf((nfd - n + 0.5f) / (n + 0.5f), 0.0f));
  const float den = t + 1.2f * (0.25f + 0.75f * lens[p] / fmaxf(avgdl, 1e-9f));
  // the doc id is still loaded, as the atomic's address was
  out[p] = idf * boost * t * 2.2f / fmaxf(den, 1e-9f) + (docs[p] < 0 ? 1.f : 0.f);
}

__global__ void scatter_ones(const int* docs, long long p0, long long n,
                             float* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(&out[docs[p0 + i]], 1.0f);
}

__global__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (atomicAdd(count, 0u) < target) {
    }
  }
  __syncthreads();
}

extern "C" int probe_k1_store(const void* docs, const void* tf,
                              const void* ni, const void* lens,
                              const void* blk, const void* lo, const void* hi,
                              float boost, float avgdl, float nfd, void* out,
                              int n_blocks, void* stream) {
  k1_store<<<n_blocks, 1024, 0, (cudaStream_t)stream>>>(
      (const int*)docs, (const float*)tf, (const float*)ni,
      (const float*)lens, (const int*)blk, (const int*)lo, (const int*)hi,
      boost, avgdl, nfd, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int probe_scatter(const void* docs, long long p0, long long n,
                             void* out, void* stream) {
  scatter_ones<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)docs, p0, n, (float*)out);
  return (int)cudaGetLastError();
}

// a barrier across SMs x resident 256-thread blocks; `count` only grows
extern "C" int probe_barrier(void* count, void* stream) {
  static unsigned grid = 0, gen = 0;
  if (!grid) {
    int dev = 0, sms = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, grid_barrier, 256, 0);
    grid = (unsigned)(sms * occ);
  }
  ++gen;
  unsigned* c = (unsigned*)count;
  unsigned target = gen * grid;
  void* args[] = {&c, &target};
  return (int)cudaLaunchCooperativeKernel((void*)grid_barrier, grid, 256,
                                          args, 0, (cudaStream_t)stream);
}
"""


def build_kernels_and_probes():
    """Every kernel library (``_cuda.build_all``) and the K1 probes'
    library, one nvcc per source, all started together; returns the
    probes' path."""
    from orama_core_tpu_torch.ops import _cuda

    out = os.path.join(ROOT, "build", "k1_probe")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "k1_probe.cu")
    with open(src, "w", encoding="utf-8") as f:
        f.write(K1_PROBE_SRC)
    lib = os.path.join(out, "libk1_probe.so")
    proc = subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        _cuda.build_all(force=True)
    finally:
        log_out, _ = proc.communicate()
    require(proc.returncode == 0, f"the K1 probes did not build:\n{log_out}")
    return lib


def k1_probes(probe_lib, calls, spans_k1, d_docs, cap):
    """Device ms of K1's parts on the record's four plans, in turn: the
    score vector's fill alone, the earlier K1 design with stores for its
    atomics, a bare scatter of the same doc ids, one grid-wide barrier."""
    import ctypes

    import torch

    from orama_core_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(probe_lib)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.probe_k1_store.argtypes = [P] * 7 + [F] * 3 + [P, I, P]
    lib.probe_scatter.argtypes = [P, L, L, P, P]
    lib.probe_barrier.argtypes = [P, P]
    for fn in (lib.probe_k1_store, lib.probe_scatter, lib.probe_barrier):
        fn.restype = ctypes.c_int
    scratch = torch.empty(d_docs.numel(), dtype=torch.float32, device="cuda")
    sink = torch.zeros(cap, dtype=torch.float32, device="cuda")
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    scal = [float(x) for x in calls[0][0][7:10]]  # read once, not per call

    def store(args, kw):
        _cuda.check(lib.probe_k1_store(
            *[t.data_ptr() for t in args[:7]], *scal, scratch.data_ptr(),
            kw["n_blocks"], _cuda.stream()), "probe_k1_store")

    def scatter(p0, n):
        _cuda.check(lib.probe_scatter(d_docs.data_ptr(), p0, n,
                                      sink.data_ptr(), _cuda.stream()),
                    "probe_scatter")

    res = {
        "memset_ms": time_ms(lambda: torch.zeros(cap, dtype=torch.float32,
                                                 device="cuda"), 40),
        "store_ms": time_ms([lambda a=a, k=k: store(a, k) for a, k in calls],
                            40),
        "scatter_ms": time_ms([lambda p=p, n=n: scatter(p, n)
                               for p, n in spans_k1], 40),
        "barrier_ms": time_ms(lambda: _cuda.check(lib.probe_barrier(
            count.data_ptr(), _cuda.stream()), "probe_barrier"), 40),
    }
    log(f"K1 probes: {res}")
    return res



def phase_kernels_int8_mv(reader8, reader_mv, rng):
    """K5 and K6 against their plain versions on the int8 and chunked
    collections' tensors."""
    import torch

    from orama_core_tpu_torch.ops import knn, quant

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = []
    # K5: the int8 codes of the padded 1M x 384 corpus, Q = 8
    c8 = reader8._vector[1].committed
    codes, scales, _d, _v = reader8._device.vector_int8_arrays(c8)
    n_valid, d = c8.n_vectors, codes.shape[1]
    q = rng.standard_normal((8, d)).astype(np.float32)
    q8, _ = quant.quantize_int8(torch.as_tensor(q, device="cuda"))
    bm, bc = knn.subblock_max_int8(codes, scales, q8, 32, n_valid)
    pm, pc = knn.subblock_max_int8_plain(codes, scales, q8, 32, n_valid)
    torch.cuda.synchronize()
    require(torch.equal(bm, pm) and torch.equal(bc, pc),
            "K5 differs from its plain version (both sum exact integers)")
    ms = time_ms(lambda: knn.subblock_max_int8(codes, scales, q8, 32,
                                               n_valid), 20)
    pms = time_ms(lambda: knn.subblock_max_int8_plain(codes, scales, q8, 32,
                                                      n_valid), 3)
    out.append(kernel_record(
        "knn_subblock_max_int8", 0.0, ms, pms,
        *k5_work(codes.shape[0], n_valid, d, 8), peak_ops=INT8_OPS))
    log(f"K5 ok: {codes.shape[0]} rows, n_valid {n_valid}, exact, "
        f"{ms:.4f} ms")
    for width in (768, 1024):
        vw = torch.randn(262_144, width, generator=gen, device="cuda")
        cw, sw = quant.quantize_int8(vw / vw.norm(dim=1, keepdim=True))
        qw, _ = quant.quantize_int8(
            torch.randn(8, width, generator=gen, device="cuda"))
        a = knn.subblock_max_int8(cw, sw, qw, 32, 250_000)
        b = knn.subblock_max_int8_plain(cw, sw, qw, 32, 250_000)
        torch.cuda.synchronize()
        require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                f"K5 differs from its plain version at D={width}")
        wms = time_ms(lambda: knn.subblock_max_int8(cw, sw, qw, 32, 250_000),
                      10)
        log(f"K5 ok at D={width}: 262,144 rows, n_valid 250,000, Q=8, "
            f"exact, {wms:.4f} ms")
        del vw, cw, a, b

    # K6: the chunked corpus (1-7 rows per doc, m_max = 8), Q = 8
    cm = reader_mv._vector[0].committed
    vecs, row_docs, _v = reader_mv._device.vector_arrays(cm)
    n_valid, d = cm.n_vectors, vecs.shape[1]
    qd = torch.as_tensor(q / np.linalg.norm(q, axis=1, keepdims=True),
                         device="cuda").to(torch.bfloat16)
    err, nbad, ms = check_k6(vecs, row_docs, qd, n_valid, 8)
    pms = time_ms(lambda: knn.subblock_max_mv_plain(
        vecs, row_docs, qd, 32, n_valid, 8), 3)
    out.append(kernel_record(
        "knn_subblock_max_mv", err, ms, pms,
        *k6_work(vecs.shape[0], n_valid, d, 8), peak_ops=BF16_FLOPS))
    log(f"K6 ok: {vecs.shape[0]} rows, n_valid {n_valid}, m_max 8, err "
        f"{err:.3g}, {nbad} counts off at near-zero sims, {ms:.4f} ms")
    # K6 at m_max = 64: 4,000 docs of 1-64 rows (~130k rows)
    nch = rng.integers(1, 65, 4000)
    docs64 = np.repeat(np.arange(4000, dtype=np.int32), nch)
    v64 = torch.zeros(262_144, d, dtype=torch.bfloat16, device="cuda")
    x = torch.randn(len(docs64), d, generator=gen, device="cuda")
    v64[:len(docs64)] = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    rd64 = torch.zeros(262_144, dtype=torch.int32, device="cuda")
    rd64[:len(docs64)] = torch.as_tensor(docs64, device="cuda")
    err64, nbad64, ms64 = check_k6(v64, rd64, qd, len(docs64), 64)
    log(f"K6 ok at m_max=64: {len(docs64)} rows of 4,000 docs, err "
        f"{err64:.3g}, {nbad64} counts off at near-zero sims, {ms64:.4f} ms")
    return out


def dense_scores_work(p, n_docs, d, b):
    """(bytes, operations) the dense scores kernel must spend: the corpus
    rows, their validity, the doc mask and the queries read once, the
    [b, n_docs] scores written once, and a multiply-add per corpus element
    and query."""
    return (p * d * 2 + p * 4 + n_docs * 4 + b * d * 2 + b * n_docs * 4,
            2 * p * d * b)


def check_dense_scores(gen, p=2_866_316, n_docs=2_867_200, d=384, b=16):
    """The batched serving product at the Signal-1M cell's shape (its
    2,866,316 rows in a capacity of 2,867,200 docs, a chunk of 16 queries,
    the identity layout, a mask with dead docs and rows marked invalid):
    the dense scores kernel against its plain twin (within 2e-6 on unit
    rows: the same exact bf16 products summed in another order; exactly
    zero where the row is invalid, the doc masked out or past the corpus),
    both timed."""
    import torch

    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.ops import vector as vops

    vecs = torch.empty(p, d, dtype=torch.bfloat16, device="cuda")
    for lo in range(0, p, 1 << 20):  # unit rows, drawn a slab at a time
        x = torch.randn(min(1 << 20, p - lo), d, generator=gen,
                        device="cuda")
        vecs[lo:lo + x.shape[0]] = (x / x.norm(dim=1, keepdim=True)).to(
            torch.bfloat16)
    valid = (torch.rand(p, generator=gen, device="cuda") >= 0.1).float()
    mask = torch.ones(n_docs, device="cuda")
    mask[::7] = 0
    qf = torch.randn(b, d, generator=gen, device="cuda")
    queries = qf / qf.norm(dim=1, keepdim=True)
    docs = torch.arange(p, dtype=torch.int32, device="cuda")
    args = (vecs, docs, valid, queries, mask)
    launches = _cuda.LAUNCHES["knn_dense_scores"]
    got = vops.brute_force_scores_batch(*args, n_docs=n_docs, identity=True)
    require(_cuda.LAUNCHES["knn_dense_scores"] == launches + 1,
            "the dense scores kernel did not take the cell's layout")
    want = vops.brute_force_scores_batch_plain(*args, n_docs=n_docs,
                                               identity=True)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(err <= 2e-6, f"dense scores disagree with the plain twin: {err}")
    require(bool((got[:, p:] == 0).all()), "dense scores: pad not zero")
    require(bool((got[:, mask == 0] == 0).all()),
            "dense scores: a masked-out doc scored")
    require(bool((got[:, :p][:, valid == 0] == 0).all()),
            "dense scores: an invalid row scored")
    require(int((got > 0).sum()) > b * p // 4, "dense scores: too few > 0")
    del got, want
    ms = time_ms(lambda: vops.brute_force_scores_batch(
        *args, n_docs=n_docs, identity=True), 20)
    pms = time_ms(lambda: vops.brute_force_scores_batch_plain(
        *args, n_docs=n_docs, identity=True), 3)
    rec = kernel_record("knn_dense_scores", err, ms, pms,
                        *dense_scores_work(p, n_docs, d, b),
                        peak_ops=BF16_FLOPS)
    log(f"dense scores ok: {p:,} x {d} in {n_docs:,} docs, B={b}, err "
        f"{err:.3g}, {ms:.4f} ms (bound {rec['bound_ms']:.4f}), plain "
        f"{pms:.4f} ms")
    del vecs
    torch.cuda.empty_cache()
    return rec


def unit_queries(rng, q, d):
    """q unit-norm bf16 queries on the card, from the numpy generator."""
    import torch

    x = rng.standard_normal((q, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.as_tensor(x, device="cuda").to(torch.bfloat16)


def k2_work(n, n_valid, d, q):
    """(bytes, operations) K2 must spend: the live rows and the queries
    read once, both outputs of every sub-block written once, and a
    multiply-add per live element and query."""
    return n_valid * d * 2 + q * d * 2 + (n // 32) * q * 8, 2 * n_valid * d * q


def k5_work(n, n_valid, d, q, sub=32):
    """(bytes, operations) K5 must spend: the live rows' codes and scales
    and the int8 queries read once, both outputs of every sub-block
    written once, and a multiply-add per live code and query."""
    return (n_valid * d + n_valid * 4 + q * d + (n // sub) * q * 8,
            2 * n_valid * d * q)


def k6_work(n, n_valid, d, q):
    """K2's work plus the live rows' 4-byte doc ids."""
    b, ops = k2_work(n, n_valid, d, q)
    return b + n_valid * 4, ops


def check_k2(vecs, qd, n_valid, sub=32, got=None):
    """K2 (its result ``got``, else a launch here) against its plain
    version: max within 1e-4 (f32 sums of exact bf16 products in another
    order), counts equal in every sub-block with no similarity within
    1e-5 of zero. Returns (max abs err, plain max)."""
    import torch

    from orama_core_tpu_torch.ops import knn

    bm, bc = got if got is not None else knn.subblock_max(vecs, qd, sub,
                                                          n_valid)
    pm, pc = knn.subblock_max_plain(vecs, qd, sub, n_valid)
    _sync(vecs.device)
    require(bm.shape == pm.shape and bc.shape == pc.shape,
            f"K2 shapes {tuple(bm.shape)} vs {tuple(pm.shape)}")
    err = (bm - pm).abs().max().item()
    require(err <= 1e-4, f"K2 max disagrees at Q={qd.shape[0]}: {err}")
    sims = vector_sims(vecs, qd, n_valid)
    near0 = torch.zeros(vecs.shape[0], qd.shape[0], dtype=torch.bool,
                        device=vecs.device)
    near0[:n_valid] = sims.abs() < 1e-5
    near0 = near0.reshape(-1, sub, qd.shape[0]).any(dim=1)
    bad = int(((bc != pc) & ~near0).sum())
    require(bad == 0, f"K2 counts disagree at Q={qd.shape[0]} in {bad} "
            "sub-blocks with no near-zero similarity")
    return err, pm


def k5_sweep_corpora(vecs, n_valid):
    """K5's corpora of the Q sweep, (name, codes, scales, n_valid, query
    counts) each: the exact corpus's live bf16 rows quantized (padding
    rows all 0); the bench's 1,000,000 x
    768 corpus (``bench.py``'s, padded to its block) quantized as its int8
    line does; and chunk 0 of ``int8_30m_bench`` at its defaults."""
    import torch

    from orama_core_tpu_torch import bench
    from orama_core_tpu_torch.ops import quant
    from orama_core_tpu_torch.tools import int8_30m_bench as i30
    from orama_core_tpu_torch.utils.benchgen import hashed_unit_corpus

    codes = torch.zeros(vecs.shape, dtype=torch.int8, device=vecs.device)
    scales = torch.zeros(vecs.shape[0], device=vecs.device)
    for lo in range(0, n_valid, 250_000):
        hi = min(lo + 250_000, n_valid)
        codes[lo:hi], scales[lo:hi] = quant.quantize_int8(vecs[lo:hi])
    yield "", codes, scales, n_valid, (1, 8, 64, 256)
    del codes, scales
    n_pad = -(-bench.N // bench.BN) * bench.BN
    codes, scales = quant.quantize_int8(
        hashed_unit_corpus(n_pad, bench.D, 1).to(torch.float32))
    yield f"{bench.N // 1_000_000}Mx{bench.D}/", codes, scales, bench.N, (
        1, 8, 64, 256)
    del codes, scales
    chunk, _ = i30.chunk_rows(30_000_000, 4096)
    codes, scales = i30.gen_chunk(0, chunk, 384, vecs.device)
    yield "int8_30m_chunk/", codes, scales, chunk, (64,)


def phase_q_sweep(vecs, n_valid, mv_vecs, mv_docs, mv_valid, rng):
    """K2 and K6 at Q = 1 (the engine's shape), 8 and 64, and K2 at 256
    (batched serving's largest batch, four 64-query corpus passes): each
    checked against its plain version and timed, with its bound. K2 on
    the padded 1M-row corpus, K6 on the chunked one. Then K5 on
    k5_sweep_corpora's: equal to its plain version bit for bit, timed
    beside its plain version, with its bound."""
    import torch

    from orama_core_tpu_torch.ops import knn, quant

    d = vecs.shape[1]
    rows = {}
    for q in (1, 8, 64, 256):
        qd = unit_queries(rng, q, d)
        err, _ = check_k2(vecs, qd, n_valid)
        ms = time_ms(lambda: knn.subblock_max(vecs, qd, 32, n_valid), 20)
        b, _ = bound_ms(*k2_work(vecs.shape[0], n_valid, d, q), BF16_FLOPS)
        rows[f"knn_subblock_max/Q={q}"] = {
            "ms": ms, "bound_ms": b, "max_abs_err": err}
        log(f"K2 Q={q}: err {err:.3g}, {ms:.4f} ms, bound {b:.4f} ms")
        if q > 64:
            continue  # K6 serves no batch: the chunked index is not batched
        err, nbad, ms = check_k6(mv_vecs, mv_docs, qd, mv_valid, 8)
        b, _ = bound_ms(*k6_work(mv_vecs.shape[0], mv_valid, d, q),
                        BF16_FLOPS)
        rows[f"knn_subblock_max_mv/Q={q}"] = {
            "ms": ms, "bound_ms": b, "max_abs_err": err,
            "counts_off_near_zero": nbad}
        log(f"K6 Q={q}: err {err:.3g}, {ms:.4f} ms, bound {b:.4f} ms")
    for name, codes, scales, live, qs in k5_sweep_corpora(vecs, n_valid):
        n, d = codes.shape
        for q in qs:
            q8, _ = quant.quantize_int8(unit_queries(rng, q, d))
            got = knn.subblock_max_int8(codes, scales, q8, 32, live)
            want = knn.subblock_max_int8_plain(codes, scales, q8, 32, live)
            torch.cuda.synchronize()
            require(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]),
                    f"K5 differs from its plain version ({name}Q={q})")
            del got, want
            ms = time_ms(lambda: knn.subblock_max_int8(codes, scales, q8,
                                                       32, live), 20)
            pms = time_ms(lambda: knn.subblock_max_int8_plain(
                codes, scales, q8, 32, live), 3)
            b, _ = bound_ms(*k5_work(n, live, d, q), INT8_OPS)
            rows[f"knn_subblock_max_int8/{name}Q={q}"] = {
                "ms": ms, "plain_ms": pms, "bound_ms": b, "max_abs_err": 0.0}
            log(f"K5 {name}Q={q}: {n} x {d}, n_valid {live}, exact, "
                f"{ms:.4f} ms (plain {pms:.4f}), bound {b:.4f} ms")
    return rows


def sweep_corpora():
    """The two corpora of phase_q_sweep made on the card from a seed, in
    the device caches' layout: 4,194,304 padded rows of 384-d unit bf16
    vectors, 1,000,000 live; and 999,826 live rows of 250,000 chunked docs
    of 1-7 rows (synth_multivec_arrays' doc layout), ids padded with 0."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    n, d = 4_194_304, DIM

    def unit_rows(live):
        v = torch.zeros(n, d, dtype=torch.bfloat16, device="cuda")
        for lo in range(0, live, 250_000):
            x = torch.randn(min(250_000, live - lo), d, generator=gen,
                            device="cuda")
            v[lo:lo + x.shape[0]] = (x / x.norm(dim=1, keepdim=True)).to(
                torch.bfloat16)
        return v

    nch = np.random.default_rng(3).integers(1, 8, 250_000)
    docs = np.repeat(np.arange(250_000, dtype=np.int32), nch)
    mv_docs = torch.zeros(n, dtype=torch.int32, device="cuda")
    mv_docs[:len(docs)] = torch.as_tensor(docs, device="cuda")
    return unit_rows(1_000_000), 1_000_000, unit_rows(len(docs)), mv_docs, \
        len(docs)


def check_k6(vecs, row_docs, qd, n_valid, m_max):
    """K6 against its plain version: sums within rtol 1e-5 (f32 sums of
    at most m_max non-negative terms, in another order), counts equal in
    every sub-block whose rows and look-back rows hold no similarity
    within 1e-5 of zero (whose sign may differ between the kernel's and
    the matmul's order of summation). Returns (max abs err, counts off,
    kernel ms)."""
    import torch

    from orama_core_tpu_torch.ops import knn

    bm, bc = knn.subblock_max_mv(vecs, row_docs, qd, 32, n_valid, m_max)
    pm, pc = knn.subblock_max_mv_plain(vecs, row_docs, qd, 32, n_valid, m_max)
    torch.cuda.synchronize()
    err = (bm - pm).abs().max().item()
    require(bm.shape == pm.shape and bc.shape == pc.shape,
            f"K6 shapes {tuple(bm.shape)} vs {tuple(pm.shape)}")
    require(torch.allclose(bm, pm, rtol=1e-5, atol=1e-6),
            f"K6 sums disagree at m_max={m_max}, Q={qd.shape[0]}: max err "
            f"{err}")
    sims = vector_sims(vecs, qd, n_valid)
    near = torch.zeros(vecs.shape[0], qd.shape[0], device="cuda")
    near[:n_valid] = (sims.abs() < 1e-5).float()
    # a row's sign reaches the counts of the next m_max - 1 rows
    near = torch.nn.functional.max_pool1d(
        torch.nn.functional.pad(near.T[None], (m_max - 1, 0)), m_max, 1)[0].T
    near = near.reshape(-1, 32, qd.shape[0]).amax(dim=1) > 0
    nbad = int((bc != pc).sum())
    bad = int(((bc != pc) & ~near).sum())
    require(bad == 0, f"K6 counts disagree at Q={qd.shape[0]} in {bad} "
            "sub-blocks with no near-zero similarity")
    require(int(bc.sum()) > 0 and float(bm.max()) > 0, "K6 found nothing")
    ms = time_ms(lambda: knn.subblock_max_mv(vecs, row_docs, qd, 32, n_valid,
                                             m_max), 20)
    return err, nbad, ms


def vector_sims(vecs, qd, n_valid):
    from orama_core_tpu_torch.ops.vector import sims_f32

    return sims_f32(vecs[:n_valid], qd)


MODES = {  # mode: (collection, search mode, query words, extra params)
    "fulltext": ("exact", "fulltext", 1, {}),
    "phrase": ("exact", "fulltext", 2, {}),
    "hybrid_rrf": ("exact", "hybrid", 1, {}),
    "vector": ("exact", "vector", 1, {}),
    "vector_filtered": ("exact", "vector", 1, {
        "where": {"price": {"between": [20, 60]}},
        "facets": {"price": {"ranges": [{"from": 0, "to": 25},
                                        {"from": 25, "to": 50}]}},
    }),
    "vector_int8": ("int8", "vector", 1, {}),
    "hybrid_int8": ("int8", "hybrid", 1, {}),
    "vector_multivec": ("chunked", "vector", 1, {}),
}
EXPECT = {  # kernels each mode must launch
    "fulltext": ("bm25_scan",),
    "phrase": ("bm25_scan", "phrase_counts"),
    "hybrid_rrf": ("bm25_scan",),
    "vector": ("knn_subblock_max", "knn_rescore"),
    "vector_filtered": (),
    "vector_int8": ("knn_subblock_max_int8",),
    "hybrid_int8": ("bm25_scan",),
    "vector_multivec": ("knn_subblock_max_mv",),
}


def phase_engine(readers, rng, n_queries=32):
    """``readers``: collection name -> (card reader, CPU reader)."""
    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    ai = AIService()
    totals = {k: 0 for k in _cuda.LAUNCHES}
    p50 = {}
    for mode, (coll, kind, n_words, extra) in MODES.items():
        reader, cpu_reader = readers[coll]
        bodies = [dict(term=zipf_term(rng, n_words), mode=kind, **extra)
                  for _ in range(n_queries + 4)]
        for body in bodies[:4]:  # first-use allocations
            reader.search(SearchParams.from_json(body), ai)
        _cuda.reset_launches()
        lat = []
        results = []
        for body in bodies[4:]:
            t0 = time.perf_counter()
            res = reader.search(SearchParams.from_json(body), ai)
            lat.append((time.perf_counter() - t0) * 1e3)
            results.append(res)
        counts = dict(_cuda.LAUNCHES)
        for k, v in counts.items():
            totals[k] += v
        for name in EXPECT[mode]:
            require(counts[name] > 0, f"{mode}: {name} was never launched")
        require(sum(1 for r in results if r[1] > 0) >= n_queries // 2,
                f"{mode}: most queries matched nothing")
        for ranked, _n, _f in results:
            scores = [s for _, s in ranked]
            require(all(np.isfinite(scores)), f"{mode}: non-finite score")
            require(scores == sorted(scores, reverse=True),
                    f"{mode}: hits not in descending order")
        # one query per mode against the same collection on the CPU
        p = SearchParams.from_json(bodies[-1])
        got, got_n, got_f = reader.search(p, ai)
        want, want_n, want_f = cpu_reader.search(p, ai)
        check_hits(got, want, 1e-4, f"{mode} vs CPU")
        if kind == "vector" and coll != "int8":
            # a similarity within rounding of zero may change sign with
            # the order of summation: allow that many flips in the count
            require(abs(got_n - want_n) <= 2, f"{mode}: count {got_n} vs {want_n}")
        else:
            require(got_n == want_n, f"{mode}: count {got_n} vs {want_n}")
        require(_facets(got_f) == _facets(want_f), f"{mode}: facets differ")
        p50[mode] = float(np.percentile(lat, 50))
        log(f"{mode}: p50 {p50[mode]:.3f} ms, launches {counts}")
    return p50, totals


BATCH_MODES = {  # mode: (search mode, kernels every batch must launch)
    "vector": ("vector", ("knn_subblock_max", "knn_rescore")),
    "fulltext": ("fulltext", ("bm25_scan",)),
    "hybrid_rrf": ("hybrid", ("bm25_scan", "knn_dense_scores")),
}
BATCH_SIZES = (8, 64, 256)


def phase_batch(reader, cpu_reader, rng, profile=False):
    """Batched serving on the exact collection: ``search_batch`` at B = 8,
    64 and 256 per mode, the launch counts reset before and read after
    each (mode, B). Throughput is every query of a window of back-to-back
    batches over the window's whole wall time; the batch p50 beside it
    is a latency. Every row of the first batch must give the hits of the
    same reader's single-query ``search`` (the count-flip allowance of
    phase_engine for vector rows), and one batch of 8 per mode those of
    the CPU reader. Returns ({mode: {B: metrics}}, launch totals)."""
    import torch

    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    ai = AIService()
    totals = {k: 0 for k in _cuda.LAUNCHES}
    res = {}
    for mode, (kind, expect) in BATCH_MODES.items():
        res[mode] = {}
        for b in BATCH_SIZES:
            n_batches = 32 if b < 256 else 12
            batches = [[SearchParams.from_json(dict(term=zipf_term(rng),
                                                    mode=kind))
                        for _ in range(b)] for _ in range(n_batches + 1)]
            reader.search_batch(batches[0], ai)  # first-use allocations
            torch.cuda.synchronize()
            _cuda.reset_launches()
            lat, outs = [], []
            t_window = time.perf_counter()
            for params in batches[1:]:
                t0 = time.perf_counter()
                outs.append(reader.search_batch(params, ai))
                lat.append(time.perf_counter() - t0)
            window = time.perf_counter() - t_window
            counts = dict(_cuda.LAUNCHES)
            for k, v in counts.items():
                totals[k] += v
            for name in expect:
                require(counts[name] > 0,
                        f"batch {mode} B={b}: {name} was never launched")
            for params, got in zip(batches[1:2], outs[:1]):
                require(len(got) == b, f"batch {mode}: {len(got)} rows")
                for i, (p, (ranked, n)) in enumerate(zip(params, got)):
                    want, want_n, _ = reader.search(p, ai)
                    check_hits(ranked, want, 1e-4,
                               f"batch {mode} B={b} row {i} vs single")
                    # a similarity within rounding of zero may change
                    # sign between the batch's product and the single
                    # query's: allow that many flips where vectors count
                    slack = 2 if kind != "fulltext" else 0
                    require(abs(n - want_n) <= slack,
                            f"batch {mode} B={b} row {i}: count {n} vs "
                            f"{want_n}")
            require(sum(1 for r in outs[0] if r[1] > 0) >= b // 2,
                    f"batch {mode} B={b}: most rows matched nothing")
            row = {"qps": b * n_batches / window, "window_s": window,
                   "batches": n_batches,
                   "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
                   "batch_max_ms": max(lat) * 1e3, "launches": counts}
            if profile:
                row.update(profile_batches(reader, ai, batches[1:3]))
            res[mode][b] = row
            log(f"batch {mode} B={b}: {row}")
        # one batch of 8 against the CPU reader
        params = [SearchParams.from_json(dict(term=zipf_term(rng), mode=kind))
                  for _ in range(8)]
        got = reader.search_batch(params, ai)
        want = cpu_reader.search_batch(params, ai)
        for i, ((g, gn), (w, wn)) in enumerate(zip(got, want)):
            check_hits(g, w, 1e-4, f"batch {mode} row {i} vs CPU")
            require(abs(gn - wn) <= (2 if kind != "fulltext" else 0),
                    f"batch {mode} row {i}: count {gn} vs CPU {wn}")
    return res, totals


def phase_two_fields(reader, rng, b=64, n_batches=4):
    """Fulltext and hybrid RRF on the exact collection with a ``title``
    field beside ``body`` (``with_title``): windows of ``n_batches``
    batches of ``b`` queries through ``search_batch``, which sends two
    string fields to the per-row span scorer, against the same queries
    one by one through ``search`` (the single fused program, K1 per
    field). queries/s over each window's wall time, and the launches of
    each window; every row of the first batch must give its single
    query's hits."""
    import torch

    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    ai = AIService()
    res = {}
    for mode, kind in (("fulltext", "fulltext"), ("hybrid_rrf", "hybrid")):
        batches = [[SearchParams.from_json(dict(term=zipf_term(rng), mode=kind))
                    for _ in range(b)] for _ in range(n_batches + 1)]
        reader.search_batch(batches[0], ai)  # first-use allocations
        for p in batches[0][:4]:
            reader.search(p, ai)
        row = {"rows": b, "batches": n_batches}
        for how in ("batch", "single"):
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            if how == "batch":
                outs = [reader.search_batch(ps, ai) for ps in batches[1:]]
            else:
                singles = [reader.search(p, ai) for ps in batches[1:] for p in ps]
            wall = time.perf_counter() - t0
            row[f"{how}_qps"] = b * n_batches / wall
            row[f"{how}_launches"] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        slack = 2 if kind != "fulltext" else 0
        for i, ((ranked, n), (want, want_n, _)) in enumerate(
                zip(outs[0], singles[:b])):
            check_hits(ranked, want, 1e-4, f"two fields {mode} row {i}")
            require(abs(n - want_n) <= slack,
                    f"two fields {mode} row {i}: count {n} vs {want_n}")
        res[mode] = row
        log(f"two fields {mode} B={b}: {row}")
    return res


def phase_rrf_ranks(n, rng, sizes=(1, 4, 8, 64, 256), k=10, iters=6):
    """The batched RRF's two exact candidate-rank methods, between which
    ``fusion._candidate_ranks`` picks by the row count
    (``_SORT_MAX_ROWS``), on [B, n] scores shaped like the batch phase's
    hybrid rows (a BM25 row matching 0.01-20% of the docs, a dense
    similarity row): each row's stable sort gathered at the 2c candidates
    (``fusion._ranks``) and ``fusion._histogram_ranks``. Both must give
    the same integers. Device ms per (fulltext, vector) pair from
    ``time_ms``; wall ms per pair, host launches included, from the host
    clock around synchronised calls."""
    import torch

    from orama_core_tpu_torch.ops import fusion
    from orama_core_tpu_torch.ops.topk import topk_stable

    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(2**31)))
    c = fusion.rrf_candidate_count(k)
    out = {}
    for b in sizes:
        share = torch.logspace(-4, -0.7, b, device="cuda")[:, None]
        ft = torch.rand(b, n, device="cuda", generator=gen) * 10
        ft = torch.where(torch.rand(b, n, device="cuda", generator=gen) < share,
                         ft, 0.0)
        vec = torch.rand(b, n, device="cuda", generator=gen) * 0.8 - 0.3
        g = torch.cat([topk_stable(ft, c)[1], topk_stable(vec, c)[1]], dim=1)
        methods = {"sort": lambda s: torch.gather(fusion._ranks(s), 1, g),
                   "histogram": lambda s: fusion._histogram_ranks(s, g)}
        for s in (ft, vec):
            require(torch.equal(methods["sort"](s), methods["histogram"](s)),
                    f"rrf ranks B={b}: the two methods differ")
        row = {}
        for name, fn in methods.items():
            def pair(fn=fn):
                return fn(ft), fn(vec)
            row[f"{name}_device_ms"] = time_ms(pair, iters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                pair()
            torch.cuda.synchronize()
            row[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / iters
        out[b] = row
        log(f"rrf ranks B={b}: {row}")
        del ft, vec, g, share
        torch.cuda.empty_cache()
    return out


def profile_batches(reader, ai, batches):
    """Device ms per batch and the device's idle share over ``batches``
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for params in batches:
            reader.search_batch(params, ai)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evts = prof.key_averages()
    busy_us = sum(_device_us(e) for e in evts)
    by_name = {}
    for e in evts:
        if _device_us(e) > 0:
            by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + _device_us(e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    n = len(batches)
    return {"device_ms_per_batch": busy_us / n / 1e3,
            "wall_ms_per_batch_profiled": wall_us / n / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if busy_us else None,
            "top_device_ms_per_batch": {k: v / n / 1e3 for k, v in top}}


def phase_batcher(seed=11, n_threads=24, device="cuda"):
    """The micro-batcher through the normal entry point: ``build_orama``
    on the card with ``query_batching=True`` serves concurrent searches
    from ``n_threads`` threads, which must coalesce (a batch of more than
    one query) and give the hits and counts of unbatched searches."""
    import threading

    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = os.path.join(work, "w")
    cfg.reader_side.data_dir = os.path.join(work, "r")
    cfg.ai.backend = "fake"
    cfg.gpu.query_batching = True
    cfg.gpu.batch_wait_ms = 10.0
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    zipf = 1.0 / np.arange(1, 401) ** 0.8
    zipf /= zipf.sum()
    engine = build_orama(cfg, start_background=False, device=device)
    sizes = []
    try:
        engine.write_side.create_collection("master", "c", read_api_key="r",
                                            write_api_key="w",
                                            embedding_model="fake-base")
        engine.flush()
        # one string field, as the batched fused program serves (a second
        # one sends fulltext batches to the per-mode span scorer)
        docs = [{k: v for k, v in doc.items() if k != "title"}
                for doc in _short_docs(rng, 5000, vocab, zipf)]
        for lo in range(0, len(docs), 500):
            engine.write_side.write("c", docs[lo:lo + 500], "w")
            engine.flush()
        engine.commit()
        side = engine.read_side
        reader = side._reader("c")
        orig = side._batcher._run_batch
        side._batcher._run_batch = lambda key, ps: (sizes.append(len(ps))
                                                   or orig(key, ps))
        bodies = [{"term": f"w{int(t)}", "mode": m}
                  for t, m in zip(rng.integers(0, 60, n_threads),
                                  ("fulltext", "vector", "hybrid") * n_threads)]
        for body in bodies[:3]:  # first-use allocations, outside the check
            side.search("c", SearchParams.from_json(body), "r")
        _cuda.reset_launches()
        sizes.clear()
        outs = {}
        go = threading.Barrier(n_threads)

        def q(i):
            go.wait()
            outs[i] = side.search("c", SearchParams.from_json(bodies[i]), "r")

        threads = [threading.Thread(target=q, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        require(not any(t.is_alive() for t in threads),
                "batcher: a search did not return")
        launches = dict(_cuda.LAUNCHES)
        require(len(outs) == n_threads, "batcher: a search failed")
        require(max(sizes, default=0) > 1,
                f"batcher: no batch of more than one query ({sizes})")
        for k in ("bm25_scan", "knn_subblock_max", "knn_rescore"):
            require(launches[k] > 0, f"batcher: {k} never ran")
        storage = side.doc_storage["c"]
        for i, body in enumerate(bodies):
            ranked, count, _ = reader.search(SearchParams.from_json(body),
                                             side.ai)
            want = [(storage.get(d)["id"], sc) for d, sc in ranked]
            check_hits([(h.id, h.score) for h in outs[i].hits], want, 1e-4,
                       f"batcher {body}")
            slack = 2 if body["mode"] != "fulltext" else 0
            require(abs(outs[i].count - count) <= slack,
                    f"batcher {body}: count {outs[i].count} vs {count}")
    finally:
        engine.close()
        shutil.rmtree(work, ignore_errors=True)
    log(f"batcher: {n_threads} concurrent searches in batches of {sizes}, "
        "hits equal to unbatched searches")
    return {"threads": n_threads, "batch_sizes": sizes, "launches": launches}


def _device_us(evt) -> float:
    """Device time of a kernel event (ops above the kernels are skipped,
    so a kernel is never counted twice)."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_calls(fns, unit="queries") -> dict:
    """Device busy share of the wall time and the ops that take the most
    device and host time, from torch.profiler over the callables ``fns``
    run back to back (after two first-use calls), per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for f in fns[:2]:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in fns:
            f()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evts = prof.key_averages()
    busy_us = sum(_device_us(e) for e in evts)
    by_name = {}
    for e in evts:
        if _device_us(e) > 0:
            by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + _device_us(e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # host side: the torch ops whose own CPU time is largest
    host = sorted(((e.key[:60], e.self_cpu_time_total) for e in evts
                   if _device_us(e) == 0), key=lambda kv: -kv[1])[:6]
    n = len(fns)
    per = unit[:-1] if unit.endswith("s") else unit
    return {
        unit: n,
        f"wall_ms_per_{per}": wall_us / n / 1e3,
        f"device_ms_per_{per}": busy_us / n / 1e3,
        "device_idle_share": (1.0 - busy_us / wall_us) if busy_us else None,
        f"top_device_ms_per_{per}": {
            name: us / n / 1e3 for name, us in top
        },
        f"top_host_self_ms_per_{per}": {
            name: us / n / 1e3 for name, us in host
        },
    }


def profile_window(reader, ai, params) -> dict:
    """profile_calls over ``params`` served back to back by
    ``reader.search``."""
    return profile_calls([lambda p=p: reader.search(p, ai) for p in params])


def phase_profile(readers, rng, n_queries=16):
    """Optional (``--profile``): per mode, ``profile_window`` over a steady
    window of queries. ``readers``: collection name -> card reader."""
    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.types import SearchParams

    ai = AIService()
    for mode, (coll, kind, n_words, extra) in MODES.items():
        params = [SearchParams.from_json(
            dict(term=zipf_term(rng, n_words), mode=kind, **extra))
            for _ in range(n_queries)]
        print(json.dumps(dict({"profile": mode},
                              **profile_window(readers[coll], ai, params))),
              flush=True)


# -- the ANN indexes --------------------------------------------------------

ANN_MODES = ("ivf", "pq", "ivf_pq")
ANN_QUERIES = {  # name: (search mode, extra params, raw query vectors)
    "vector": ("vector", {}, True),
    "hybrid_rrf": ("hybrid", {}, False),
    "vector_filtered": ("vector", {
        "where": {"price": {"between": [20, 60]}},
        "facets": {"price": {"ranges": [{"from": 0, "to": 25},
                                        {"from": 25, "to": 50}]}},
    }, True),
}
ANN_EXPECT = {"hybrid_rrf": ("bm25_scan",)}  # kernels a query mode launches


def clustered_corpus(n, d, n_modes=2000, n_queries=64, seed=1,
                     device="cuda"):
    """``benchmarks/ann_10m_bench.py``'s corpus and queries, made on the
    card from a seed: ``n_modes`` unit modes, each row a mode plus noise
    of norm ~0.25, L2-normalised; queries are corpus rows plus noise of
    norm ~0.05 (near-duplicate retrieval), L2-normalised. Returns host f32
    (rows [n, d], queries [n_queries, d])."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    modes = torch.randn(n_modes, d, generator=g, device=device)
    modes /= modes.norm(dim=1, keepdim=True)
    which = torch.randint(0, n_modes, (n,), generator=g, device=device)
    v = modes[which] + (0.25 / d ** 0.5) * torch.randn(
        n, d, generator=g, device=device)
    v /= v.norm(dim=1, keepdim=True)
    qi = torch.randint(0, n, (n_queries,), generator=g, device=device)
    q = v[qi] + (0.05 / d ** 0.5) * torch.randn(
        n_queries, d, generator=g, device=device)
    q /= q.norm(dim=1, keepdim=True)
    return v.cpu().numpy(), q.cpu().numpy()


def ann_arrays(arrays, vecs, committed=None):
    """``arrays`` (the 1M collection: text, price) with its vectors replaced
    by ``vecs``, or by the arrays of a trained ``committed`` index."""
    from orama_core_tpu_torch.index import CommittedVectorIndex

    if committed is None:
        committed = CommittedVectorIndex(
            dimension=vecs.shape[1], vecs=vecs,
            vec_docs=np.arange(len(vecs), dtype=np.int32))
    return dict(arrays, collection_id="smoke_ann",
                arrays=dict(arrays["arrays"],
                            **{"vector-1": committed.to_arrays()}))


def ann_timings(reader, q, iters=8, profile=False):
    """Device ms of one query's ANN search at the engine's operands, and
    of its ADC scan alone (the candidates' LUT sums; PQ: over every row).
    An IVF-PQ search launches ~100 kernels: ``iters`` stays small enough
    that the timed calls fit the card's launch queue, or the host's
    launch rate is timed instead of the device (``search_ms_20_calls``
    shows it). With ``profile``, the kernels one search runs and their
    device ms, from torch.profiler over 4 searches."""
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    from orama_core_tpu_torch.ops import ivf as ivf_ops
    from orama_core_tpu_torch.ops import pq as pq_ops
    from orama_core_tpu_torch.ops.hybrid import ann_vector_scores

    c = reader._vector[1].committed
    vmode, stat, ann, _ = reader._fused_vector_args(c, 10)
    qd = torch.as_tensor(q, device=reader.device)
    def search():
        return ann_vector_scores(vmode, stat, ann, qd, n_docs=reader.capacity)

    out = {"search_ms": time_ms(search, iters),
           "search_ms_20_calls": time_ms(search, 20)}
    if profile:
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                search()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if _device_us(e) > 0]
        out["kernels_per_search"] = sum(e.count for e in evts) / 4
        out["profiled_device_ms_per_search"] = sum(
            _device_us(e) for e in evts) / 4 / 1e3
    if vmode == "pq":
        codes, books, _v, _d, _valid, rot = ann
        lut = ivf_ops.adc_lut(books, qd[None], rot)
        out["adc_ms"] = time_ms(lambda: pq_ops.adc_scores(codes, lut),
                                iters)
    elif vmode == "ivf_pq":
        codes, books, _v, cents, lists, lens, _d, rot = ann
        _, cand, _ = ivf_ops.probe_clusters(cents, lists, lens, qd[None],
                                            stat[0])
        lut = ivf_ops.adc_lut(books, qd[None], rot)
        out["adc_ms"] = time_ms(lambda: ivf_ops.adc_gathered(
            lut, codes[cand.long()]), iters)
        out["adc_candidates"] = int(cand.shape[1])
    return out


def phase_ann(arrays, rng, profile=False, n_queries=32, device="cuda"):
    """The IVF, PQ and IVF-PQ indexes on the 1M collection with clustered
    vectors: each built on the card by the calls ``commit`` makes
    (``CollectionReader._build_ann``), recall@10 of 64 queries against
    brute force over the same bf16 rows, 32 queries per ANN_QUERIES mode
    through ``search`` (launch counts reset before and read after each),
    one query per mode held against a CPU reader of the same trained
    arrays. Returns ({index: metrics}, launch totals, the trained IVF-PQ
    vector index and the 64 queries, which the mesh phase serves)."""
    import torch

    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.ops.topk import topk_stable
    from orama_core_tpu_torch.ops.vector import sims_f32
    from orama_core_tpu_torch.types import SearchParams

    t0 = time.perf_counter()
    vecs, queries = clustered_corpus(arrays["doc_count"], DIM, device=device)
    rows = torch.as_tensor(vecs, device=device).to(torch.bfloat16)
    _, gt = topk_stable(sims_f32(rows, torch.as_tensor(
        queries, device=device)).T, 10)
    gt = gt.cpu().numpy()
    del rows
    log(f"ann: clustered corpus and ground truth in "
        f"{time.perf_counter() - t0:.1f} s")
    ai = AIService()
    totals = {k: 0 for k in _cuda.LAUNCHES}
    res = {}
    for mode in ANN_MODES:
        reader = make_reader(ann_arrays(arrays, vecs), device, mode)
        c = reader._vector[1].committed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reader._build_ann(c)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        before = torch.cuda.memory_allocated()
        reader._fused_vector_args(c, 10)     # the ANN caches
        torch.cuda.synchronize()
        row = {
            "build_s": build_s,
            "ann_gib": (torch.cuda.memory_allocated() - before) / 2**30,
            "n_clusters": int(c.ivf_lists.shape[0]) if c.has_ivf else None,
            "cap": int(c.ivf_lists.shape[1]) if c.has_ivf else None,
            "nprobe": c.tuned_nprobe, "expand": c.tuned_expand,
            "pq_m": int(c.pq_codes.shape[1]) if c.has_pq else None,
            "rotation": c.pq_rotation is not None,
        }
        reader.warmup()
        require((mode != "pq") == c.has_ivf and (mode != "ivf") == c.has_pq,
                f"ann {mode}: built ivf={c.has_ivf} pq={c.has_pq}")
        hits = []
        for q in queries:
            ranked, _n, _f = reader.search(SearchParams.from_json(
                {"mode": "vector", "vector": q.tolist()}), ai)
            hits.append([d for d, _ in ranked])
        row["recall_at_10"] = float(np.mean(
            [len(set(h) & set(g)) / 10 for h, g in zip(hits, gt)]))
        if mode != "pq":
            require(row["recall_at_10"] >= 0.95,
                    f"ann {mode}: recall@10 {row['recall_at_10']}")
        cpu_reader = make_reader(ann_arrays(arrays, None, c), "cpu", mode)
        row["p50_ms"], row["launches"] = {}, {}
        for name, (kind, extra, raw) in ANN_QUERIES.items():
            bodies = []
            for i in range(n_queries + 4):
                body = dict(mode=kind, **extra)
                if raw:
                    body["vector"] = queries[i % len(queries)].tolist()
                else:
                    body["term"] = zipf_term(rng)
                bodies.append(body)
            for body in bodies[:4]:
                reader.search(SearchParams.from_json(body), ai)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            lat, results = [], []
            for body in bodies[4:]:
                t0 = time.perf_counter()
                results.append(reader.search(SearchParams.from_json(body), ai))
                lat.append((time.perf_counter() - t0) * 1e3)
            counts = dict(_cuda.LAUNCHES)
            for k, v in counts.items():
                totals[k] += v
            for k in ANN_EXPECT.get(name, ()):
                require(counts[k] > 0, f"ann {mode} {name}: {k} never ran")
            require(sum(1 for r in results if r[1] > 0) >= n_queries // 2,
                    f"ann {mode} {name}: most queries matched nothing")
            for ranked, _n, _f in results:
                scores = [s for _, s in ranked]
                require(all(np.isfinite(scores)),
                        f"ann {mode} {name}: non-finite score")
                require(scores == sorted(scores, reverse=True),
                        f"ann {mode} {name}: hits not in descending order")
            p = SearchParams.from_json(bodies[-1])
            got, got_n, got_f = reader.search(p, ai)
            want, want_n, want_f = cpu_reader.search(p, ai)
            check_hits(got, want, 1e-4, f"ann {mode} {name} vs CPU")
            require([d for d, _ in got] == [d for d, _ in want],
                    f"ann {mode} {name}: hit ids differ from the CPU's")
            # a similarity within rounding of zero may change sign
            require(abs(got_n - want_n) <= 2,
                    f"ann {mode} {name}: count {got_n} vs {want_n}")
            require(_facets(got_f) == _facets(want_f),
                    f"ann {mode} {name}: facets differ")
            row["p50_ms"][name] = float(np.percentile(lat, 50))
            row["launches"][name] = {k: v for k, v in counts.items() if v}
            if profile:
                row.setdefault("profile", {})[name] = profile_window(
                    reader, ai, [SearchParams.from_json(b)
                                 for b in bodies[4:20]])
        row.update(ann_timings(reader, queries[0], profile=profile))
        res[mode] = row
        log(f"ann {mode}: {row}")
        if mode == "ivf_pq":
            trained = c
        del reader, cpu_reader, c
        torch.cuda.empty_cache()
    return res, totals, trained, queries


def _facets(f):
    return None if f is None else {k: (v.count, v.values) for k, v in f.items()}


# -- sharded serving over a device mesh, and the multi-slice router ---------------

MESH_SHARDS = 4
MESH_MODES = {  # mode: (collection, search mode, query words, extra params,
    #                    kernels a query launches once per shard)
    "fulltext": ("exact", "fulltext", 1, {}, ("bm25_scan",)),
    "phrase": ("exact", "fulltext", 2, {}, ("bm25_scan", "phrase_counts")),
    "vector": ("exact", "vector", 1, {},
               ("knn_subblock_max", "knn_rescore")),
    "vector_filtered": ("exact", "vector", 1, MODES["vector_filtered"][3], ()),
    "hybrid_rrf": ("exact", "hybrid", 1, {}, ("bm25_scan",)),
    "hybrid_minmax": ("exact", "hybrid", 1, {"fusion": "minmax"},
                      ("bm25_scan",)),
    "vector_multivec": ("chunked", "vector", 1, {}, ("knn_subblock_max_mv",)),
    # raw query vectors (the ANN phase's near-duplicate queries)
    "vector_ivf_pq": ("ivf_pq", "vector", 0, {}, ()),
}


def mesh_reader(arrays, index, devices=None, device="cuda"):
    """A reader of ``arrays`` with ``mesh_shape=(MESH_SHARDS, 1)``; its
    shards on ``devices`` when given (else ``make_mesh``'s blocks over the
    visible cards), its per-shard layouts built (``warmup``)."""
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.carry import reader_from_arrays
    from orama_core_tpu_torch.parallel.mesh import make_mesh

    rd = reader_from_arrays(**arrays, gpu_cfg=GpuConfig(
        device=device, vector_index=index, mesh_shape=(MESH_SHARDS, 1)))
    if devices is not None:
        rd._device.mesh = make_mesh((MESH_SHARDS, 1), devices=devices)
        rd._device.device = rd._device.mesh.root
    rd.warmup()
    return rd


def mesh_mode(mesh, single, bodies, mode, n_queries):
    """One mode's queries on the mesh reader (launch counts reset before,
    read after), then on the single-device reader, each held against the
    other. Returns (p50 sharded, p50 single, launches, ids equal)."""
    import torch

    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    coll, kind, _w, _x, expect = MESH_MODES[mode]
    ai = AIService()
    params = [SearchParams.from_json(b) for b in bodies]
    for p in params[:4]:  # first-use allocations
        mesh.search(p, ai)
        single.search(p, ai)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    lat_m, res_m = [], []
    for p in params[4:]:
        t0 = time.perf_counter()
        res_m.append(mesh.search(p, ai))
        lat_m.append((time.perf_counter() - t0) * 1e3)
    counts = dict(_cuda.LAUNCHES)
    lat_s, res_s = [], []
    for p in params[4:]:
        t0 = time.perf_counter()
        res_s.append(single.search(p, ai))
        lat_s.append((time.perf_counter() - t0) * 1e3)
    for k in expect:
        require(counts[k] >= MESH_SHARDS * n_queries,
                f"mesh {mode}: {k} launched {counts[k]} times for "
                f"{n_queries} queries on {MESH_SHARDS} shards")
    require(sum(1 for r in res_m if r[1] > 0) >= n_queries // 2,
            f"mesh {mode}: most queries matched nothing")
    same_ids = 0
    for (gm, nm, fm), (gs, ns, fs) in zip(res_m, res_s):
        scores = [s for _, s in gm]
        require(all(np.isfinite(scores)), f"mesh {mode}: non-finite score")
        require(scores == sorted(scores, reverse=True),
                f"mesh {mode}: hits not in descending order")
        same_ids += [d for d, _ in gm] == [d for d, _ in gs]
        if coll == "ivf_pq":
            # each shard reranks its own candidates: the union holds the
            # single-device candidate set, so no rank scores lower
            require(len(gm) == len(gs) and all(
                a >= b - 1e-4 * abs(b) for a, b in zip(
                    scores, [s for _, s in gs])),
                f"mesh {mode}: a rank scores below the single-device one")
            continue
        check_hits(gm, gs, 1e-4, f"mesh {mode} vs single device")
        if kind == "vector":
            # a similarity within rounding of zero may change sign with
            # the order of summation: allow that many flips
            require(abs(nm - ns) <= 2, f"mesh {mode}: count {nm} vs {ns}")
            fa, fb = _facets(fm), _facets(fs)
            require((fa is None) == (fb is None) and (fa is None or all(
                abs(fa[k][1][b] - fb[k][1][b]) <= 2 for k in fb
                for b in fb[k][1])), f"mesh {mode}: facets {fa} vs {fb}")
        else:
            require(nm == ns, f"mesh {mode}: count {nm} vs {ns}")
            require(_facets(fm) == _facets(fs), f"mesh {mode}: facets differ")
    return (float(np.percentile(lat_m, 50)), float(np.percentile(lat_s, 50)),
            counts, same_ids)


def mesh_bodies(mode, rng, n, queries):
    _c, kind, n_words, extra, _e = MESH_MODES[mode]
    if n_words == 0:
        return [dict(mode=kind, vector=queries[i % len(queries)].tolist(),
                     **extra) for i in range(n)]
    return [dict(term=zipf_term(rng, n_words), mode=kind, **extra)
            for _ in range(n)]


def phase_mesh(arrays, mv_arrays, ivf_pq, ann_queries, rng, card,
               n_queries=32, profile=False):
    """Sharded serving: ``mesh_shape=(4, 1)`` readers, all four shards on
    card 0, built from the same committed arrays as single-device readers
    (the 1M exact collection, the 250,000-doc chunked one, and the ANN
    phase's trained IVF-PQ index of the clustered vectors); 32 queries per
    MESH_MODES mode on each, held against each other; then (with two or
    more cards) the exact collection with its shards spread over them; then
    the multi-slice router over two engines. Returns the ``{"mesh": ...}``
    record and the phase's launches (of the mesh readers' queries). With
    ``profile``, each mode's mesh queries are also traced
    (``profile_window``)."""
    import torch

    from orama_core_tpu_torch.models.ai_service import AIService
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    on_card0 = ["cuda:0"] * MESH_SHARDS
    vec_only = dict(arrays, collection_id="smoke_ivf_pq",
                    fields=[f for f in arrays["fields"]
                            if f["type"] == "embedding"],
                    arrays={"vector-1": ivf_pq.to_arrays()})
    # one posting per (term, doc), as an index built from documents holds:
    # the single-device reader scores Zipf-head terms from dense rows,
    # which count a repeated posting once, and the mesh path scans
    # postings, as the reference's does
    exact = dict(arrays, arrays=dict(arrays["arrays"], **{
        "string-0": unique_postings(arrays["arrays"]["string-0"])}))
    colls = {"exact": (exact, "exact"), "chunked": (mv_arrays, "exact"),
             "ivf_pq": (vec_only, "ivf_pq")}
    rec = {"shards": MESH_SHARDS, "cards": n_cards, "card": card,
           "queries_per_mode": n_queries, "p50_ms": {}, "launches": {},
           "ids_equal": {}, "gib": {}, "build_s": {}}
    totals = {k: 0 for k in _cuda.LAUNCHES}
    for coll, (arr, index) in colls.items():
        single = make_reader(arr, "cuda", index)
        single.warmup()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        mesh = mesh_reader(arr, index, on_card0)
        torch.cuda.synchronize()
        rec["build_s"][coll] = time.perf_counter() - t0
        rec["gib"][coll] = (torch.cuda.memory_allocated() - before) / 2**30
        require(mesh._device.n_shards == MESH_SHARDS and mesh._device.mesh.shared,
                f"mesh {coll}: not {MESH_SHARDS} shards on one card")
        for mode, (c, *_r) in MESH_MODES.items():
            if c != coll:
                continue
            bodies = mesh_bodies(mode, rng, n_queries + 4, ann_queries)
            require(mesh._use_sharded(SearchParams.from_json(bodies[0])),
                    f"mesh {mode}: not served by the mesh path")
            p_m, p_s, counts, same = mesh_mode(mesh, single, bodies, mode,
                                               n_queries)
            for k, v in counts.items():
                totals[k] += v
            rec["p50_ms"][mode] = {"sharded": p_m, "single": p_s}
            rec["launches"][mode] = {k: v for k, v in counts.items() if v}
            rec["ids_equal"][mode] = same
            if profile:
                rec.setdefault("profile", {})[mode] = profile_window(
                    mesh, AIService(), [SearchParams.from_json(b)
                                        for b in bodies[4:20]])
            log(f"mesh {mode}: p50 {p_m:.3f} ms sharded, {p_s:.3f} single, "
                f"launches {rec['launches'][mode]}, ids equal {same}/"
                f"{n_queries}")
        if coll == "ivf_pq":
            # the union of per-shard candidates is not the single-device
            # set: hold one query's count and hits against the same mesh
            # program on the CPU
            cpu = mesh_reader(arr, index, device="cpu")
            p = SearchParams.from_json(mesh_bodies(
                "vector_ivf_pq", rng, 1, ann_queries)[0])
            got, got_n, _ = mesh.search(p, AIService())
            want, want_n, _ = cpu.search(p, AIService())
            check_hits(got, want, 1e-4, "mesh ivf_pq vs CPU mesh")
            require(abs(got_n - want_n) <= 2,
                    f"mesh ivf_pq: count {got_n} vs CPU {want_n}")
            del cpu
        if coll == "exact" and n_cards >= 2:
            spread = mesh_reader(arr, index)
            require(not spread._device.mesh.shared, "mesh: not spread")
            rec["spread"] = {}
            for mode in ("fulltext", "phrase", "vector", "hybrid_rrf"):
                p_m, p_s, _c, same = mesh_mode(
                    spread, single, mesh_bodies(mode, rng, n_queries + 4,
                                                ann_queries),
                    mode, n_queries)
                rec["spread"][mode] = {"sharded": p_m, "single": p_s,
                                       "ids_equal": same}
            del spread
        del mesh, single
        torch.cuda.empty_cache()
    rec["multislice"] = mesh_multislice()
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec, totals


def mesh_multislice(n_docs=5000, seed=7, device="cuda"):
    """The multi-slice router over two port engines on the card
    (``LocalSlice``), with the ``build_orama`` passes' documents, against
    one engine that holds every document, after ``sync_global_stats``:
    equal top hits and counts, and the merged facets."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.parallel.multislice import (
        LocalSlice, MultiSliceRouter,
    )
    from orama_core_tpu_torch.types import SearchParams

    work = os.path.join(ROOT, "build", "chip_smoke_slices")
    shutil.rmtree(work, ignore_errors=True)

    def engine(name):
        c = OramaxConfig()
        c.writer_side.data_dir = os.path.join(work, name, "w")
        c.reader_side.data_dir = os.path.join(work, name, "r")
        c.ai.backend = "fake"
        return build_orama(c, start_background=False, device=device)

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    zipf = 1.0 / np.arange(1, 401) ** 0.8
    zipf /= zipf.sum()
    docs = _short_docs(rng, n_docs, vocab, zipf)
    slices = [engine("s0"), engine("s1")]
    oracle = engine("all")
    router = MultiSliceRouter([LocalSlice(e) for e in slices])
    try:
        router.create_collection("master", "c", "r", "w",
                                 embedding_model="fake-base")
        oracle.write_side.create_collection(
            "master", "c", read_api_key="r", write_api_key="w",
            embedding_model="fake-base")
        oracle.flush()
        for lo in range(0, n_docs, 500):
            router.write("c", docs[lo:lo + 500], "w")
            router.flush()
            oracle.write_side.write("c", docs[lo:lo + 500], "w")
            oracle.flush()
        router.commit()
        oracle.commit()
        router.sync_global_stats("c", "w")
        per_slice = [e.read_side.count_documents("c") for e in slices]
        require(sum(per_slice) == n_docs and min(per_slice) > 0,
                f"multislice: documents per slice {per_slice}")
        facets = {"price": {"ranges": [{"from": 0, "to": 30},
                                       {"from": 30, "to": 100}]}}
        bodies = [
            {"term": "w3"}, {"term": "w1 w2"}, {"term": "w5", "limit": 20},
            {"term": "w1", "where": {"price": {"gte": 30}}},
            {"term": "w4", "facets": facets},
            {"term": "w4", "mode": "vector"},
            {"term": "w2 w7", "mode": "hybrid"},
        ]
        for body in bodies:
            got = router.search("c", dict(body), "r")
            want = oracle.read_side.search(
                "c", SearchParams.from_json(dict(body)), "r")
            if body.get("mode") == "hybrid":
                # global fusion ranks each slice's top-L components
                # (L = max(4 * limit, 40)): a doc whose other component
                # ranks below L there fuses without it, so only the top
                # hit is held (the router's documented approximation)
                require(got.hits and got.hits[0].id == want.hits[0].id,
                        f"multislice {body}: top hit differs")
            else:
                check_hits([(h.id, h.score) for h in got.hits],
                           [(h.id, h.score) for h in want.hits], 1e-4,
                           f"multislice {body}")
            if body.get("mode") == "vector":
                require(abs(got.count - want.count) <= 2,
                        f"multislice {body}: count {got.count} vs "
                        f"{want.count}")
            else:
                require(got.count == want.count,
                        f"multislice {body}: count {got.count} vs "
                        f"{want.count}")
            require(got.count > 0, f"multislice {body}: no hits")
            require(_facets(got.facets) == _facets(want.facets),
                    f"multislice {body}: facets differ")
    finally:
        router.close()
        for e in slices + [oracle]:
            e.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"docs": n_docs, "slices": 2, "docs_per_slice": per_slice,
           "queries": len(bodies), "wall_s": time.perf_counter() - t0}
    log(f"multislice: {out}")
    return out


def _short_docs(rng, n_docs, vocab, zipf):
    return [{
        "id": str(i),
        "title": " ".join(rng.choice(vocab, 3, p=zipf)),
        "body": " ".join(rng.choice(vocab, int(rng.integers(5, 30)), p=zipf)),
        "price": float(rng.uniform(0, 100)),
    } for i in range(n_docs)]


def _long_docs(rng, n_docs, vocab, zipf):
    """Documents of 30-80 sentences of nine 16-character words (4 tokens
    each, 1,080-2,880 tokens): longer than the embedding model's 512-token
    budget, so the write path splits each into 3-6 chunks, one vector row
    each. The words keep the short vocabulary as prefixes."""
    lvocab = [w + "x" * (16 - len(w)) for w in vocab]
    n_sent = rng.integers(30, 81, n_docs)
    words = rng.choice(len(vocab), (int(n_sent.sum()), 9), p=zipf)
    sents = [" ".join(lvocab[w] for w in row) + "." for row in words]
    bounds = np.concatenate([[0], np.cumsum(n_sent)])
    return [{
        "id": str(i),
        "title": " ".join(rng.choice(vocab, 3, p=zipf)),
        "body": " ".join(sents[bounds[i]:bounds[i + 1]]),
        "price": float(rng.uniform(0, 100)),
    } for i in range(n_docs)]


BUILD_PASSES = {  # name: (vector_index, docs, n_docs, kernels the pass
    # runs, GpuConfig knobs)
    "exact": ("exact", _short_docs, 5000, ("knn_subblock_max",), {}),
    "int8": ("int8", _short_docs, 5000, ("knn_subblock_max_int8",), {}),
    # > 8,192 rows, so a limit-10 query's 16 x 4 candidate sub-blocks of
    # 32 rows (x 4) stay below the corpus and K6 runs, not the dense branch
    "chunked": ("exact", _long_docs, 2600, ("knn_subblock_max_mv",), {}),
    # commit trains IVF lists and residual PQ codes on the card (the
    # threshold lowered below the 5,000 rows) and tunes nprobe and expand
    "ivf_pq": ("ivf_pq", _short_docs, 5000, ("bm25_scan", "phrase_counts"),
               {"ivf_threshold": 1000}),
}


def phase_build_orama(name, seed=7, device="cuda"):
    """The normal entry point on the card against the CPU on one data dir."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    vector_index, make_docs, n_docs, expect, knobs = BUILD_PASSES[name]
    ann = vector_index in ANN_MODES
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)

    def cfg():
        c = OramaxConfig()
        c.writer_side.data_dir = os.path.join(work, "w")
        c.reader_side.data_dir = os.path.join(work, "r")
        c.ai.backend = "fake"
        c.gpu.vector_index = vector_index
        for k, v in knobs.items():
            setattr(c.gpu, k, v)
        return c

    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    zipf = 1.0 / np.arange(1, 401) ** 0.8
    zipf /= zipf.sum()
    docs = make_docs(rng, n_docs, vocab, zipf)
    t0 = time.perf_counter()
    gpu = build_orama(cfg(), start_background=False, device=device)
    gpu.write_side.create_collection("master", "c", read_api_key="r",
                                     write_api_key="w",
                                     embedding_model="fake-base")
    gpu.flush()
    for lo in range(0, len(docs), 500):  # within the embedding queue's bound
        gpu.write_side.write("c", docs[lo:lo + 500], "w")
        gpu.flush()
    gpu.commit()
    cpu = build_orama(cfg(), start_background=False, device="cpu")
    reader = gpu.read_side._reader("c")
    require(reader.device.type == device, "build_orama did not use the card")
    bodies = [
        {"term": "w3"}, {"term": "w1 w2"}, {"term": "w5 w9", "limit": 20},
        {"term": "w4", "mode": "vector"},
        {"term": "w8", "mode": "vector", "where": {"price": {"lt": 50}},
         "facets": {"price": {"ranges": [{"from": 0, "to": 30}]}}},
        {"term": "w2 w7", "mode": "hybrid"},
        {"term": "w6", "mode": "hybrid", "fusion": "minmax"},
        {"term": "w1", "where": {"price": {"gte": 30}}, "limit": 50},
    ]
    committed = next(iter(reader._vector.values())).committed
    fast = reader._vector_fast_field(SearchParams.from_json(bodies[3]))
    if ann:  # the ANN structures serve, trained by commit on the card
        require(fast is None and committed.has_ivf and committed.has_pq
                and committed.tuned_nprobe is not None,
                f"{name}: commit built no IVF-PQ index")
    else:
        require(fast is not None, f"{name}: the fused kNN did not qualify")
    if name == "chunked":
        require(committed.n_vectors >= 4096
                and not committed._single_vec_per_doc,
                f"chunked: {committed.n_vectors} rows of single-vector docs")
    _cuda.reset_launches()
    try:
        for body in bodies:
            g = gpu.read_side.search("c", SearchParams.from_json(body), "r")
            c_ = cpu.read_side.search("c", SearchParams.from_json(body), "r")
            check_hits([(h.id, h.score) for h in g.hits],
                       [(h.id, h.score) for h in c_.hits], 1e-4,
                       f"build_orama {name} {body}")
            if ((body.get("mode") == "vector" and vector_index != "int8")
                    or (body.get("mode") == "hybrid" and ann)):
                require(abs(g.count - c_.count) <= 2, f"{body}: counts")
            else:
                require(g.count == c_.count, f"{body}: counts")
            require(g.count > 0, f"{body}: no hits")
            require(_facets(g.facets) == _facets(c_.facets), f"{body}: facets")
        for k in expect:
            require(_cuda.LAUNCHES[k] > 0, f"build_orama {name}: {k} never ran")
    finally:
        gpu.close()
        cpu.close()
        shutil.rmtree(work, ignore_errors=True)
    log(f"build_orama {name}: {n_docs} docs, {committed.n_vectors} vector "
        f"rows, {len(bodies)} queries equal on cuda and cpu "
        f"({time.perf_counter() - t0:.1f} s)")


# -- the models, the answer engine and the HTTP server --------------------------

SERVE_MODES = {  # mode: (collection, search mode, query words, kernels)
    "fulltext": ("short", "fulltext", 1, ("bm25_scan",)),
    "phrase": ("short", "fulltext", 2, ("bm25_scan", "phrase_counts")),
    "vector": ("short", "vector", 2, ("knn_subblock_max", "knn_rescore")),
    "hybrid_rrf": ("short", "hybrid", 1, ("bm25_scan",)),
    "vector_chunked": ("long", "vector", 2, ("knn_subblock_max_mv",)),
}
# The fused kNN serves a committed field of at least 4,096 rows
# (CollectionReader._vector_fast_field), and K6 a chunked one of more than
# k x 4 x 32 x 4 = 8,192 rows (ops/knn.py's dense cut; a limit of 10 takes
# k = 16): 5,000 short docs (one row each) and 2,000 long ones (3-6 chunk
# rows each, ~9,400 in all).
SERVE_DOCS = {"short": 5000, "long": 2000}


def _http(base, method, path, body=None, bearer=None, timeout=120):
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if bearer:
        headers["Authorization"] = f"Bearer {bearer}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")


def _sse(base, path, body):
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        require(r.headers["Content-Type"].startswith("text/event-stream"),
                f"{path}: not an event stream")
        return [json.loads(line.decode()[6:]) for line in r
                if line.decode().startswith("data: ")]


def _vector_docs(reader):
    """(docs with a vector row, docs with one only in the uncommitted
    window) of the reader's embedding field."""
    vf = next(iter(reader._vector.values()))
    live = {d for d, _ in list(vf.uncommitted.entries)}
    return live | set(vf.committed.vec_docs.tolist()), live


# The hooks step: a dynamic selectEmbeddingProperties hook (a branch, a
# template literal, an array method, a throw) on a jax-minilm collection of
# 5,000 one-row documents, which takes vector queries through the fused kNN
# (CollectionReader._vector_fast_field: at least 4,096 committed rows).
HOOK_NAME = "selectEmbeddingProperties"
HOOK_CODE = """
function selectEmbeddingProperties(doc) {
  if (doc.kind === "faq") {
    return `${doc.title}: ${doc.tags.join(", ")}`;
  }
  if (doc.kind === "bad") {
    throw "vetoed " + doc.id;
  }
  return ["title", "summary"];
}
"""
HOOK_DOCS, HOOK_BAD, HOOK_BATCH = 5000, 16, 500


def _hooked_docs(rng, vocab, zipf, n=HOOK_DOCS, n_bad=HOOK_BAD):
    """About half ``faq`` and half other documents, ``n_bad`` of them
    ``bad`` (spread evenly); ``ref`` is a token unique to each."""
    bad = set(range(7, n, n // n_bad)[:n_bad])
    return [{
        "id": f"h{i}",
        "ref": f"ref{i:05d}",
        "kind": "bad" if i in bad else ("faq" if rng.random() < 0.5
                                        else "other"),
        "title": " ".join(rng.choice(vocab, 3, p=zipf)),
        "summary": " ".join(rng.choice(vocab, int(rng.integers(4, 12)),
                                       p=zipf)),
        "tags": [str(t) for t in rng.choice(vocab, int(rng.integers(1, 4)),
                                            p=zipf)],
        "body": " ".join(rng.choice(vocab, int(rng.integers(5, 30)), p=zipf)),
    } for i in range(n)]


def _embedding_text(doc, override):
    """The write side's own rule (collection_write.embedding_text) on the
    document as the write path stores it; the field has no configured
    sources, so a document without an override embeds every string value
    in document order."""
    from orama_core_tpu_torch.engine.collection_write import (
        embedding_text, flatten_document)

    flat = flatten_document(doc)
    strings = []
    for k, v in flat.items():
        if k == "id":
            continue
        if isinstance(v, str):
            strings.append(v)
        elif isinstance(v, list) and all(isinstance(x, str) for x in v):
            strings.extend(v)
    return embedding_text(flat, override, (), strings)


def _ingest(base, side, cid, docs, n_vec, what):
    """Create ``cid``, insert ``docs`` over HTTP in batches, and wait until
    every document is stored and ``n_vec`` of them have committed vector
    rows. Returns (HTTP send seconds, wall seconds)."""
    t0 = time.perf_counter()
    for lo in range(0, len(docs), HOOK_BATCH):
        st, res = _http(base, "POST", f"/v1/collections/{cid}/insert",
                        docs[lo:lo + HOOK_BATCH], "wk")
        require(st == 200, f"{what}: insert {cid}: {st} {res}")
    t_sent = time.perf_counter() - t0
    deadline = time.perf_counter() + 300
    while True:
        try:
            have, live = _vector_docs(side._reader(cid))
            ready = (len(have) == n_vec and not live
                     and side.count_documents(cid) == len(docs))
        except (KeyError, StopIteration):
            ready = False
        if ready:
            return t_sent, time.perf_counter() - t0
        require(time.perf_counter() < deadline,
                f"{what}: {cid} not searchable after 300 s")
        time.sleep(0.05)


def _stored_vectors(side, cid, uids):
    """The card's stored vector row of each user id (None: no row)."""
    reader = side._reader(cid)
    vf = next(iter(reader._vector.values()))
    vecs, vec_docs, _ = reader._device.vector_arrays(vf.committed)
    docs = vec_docs[:vf.committed.n_vectors].cpu().numpy()
    row_of = {int(d): r for r, d in enumerate(docs)}
    storage = side.doc_storage[cid]
    out = []
    for uid in uids:
        r = row_of.get(storage.doc_id_of(uid))
        out.append(None if r is None else vecs[r].float().cpu().numpy())
    return out


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def serve_hooks(base, orama, cpu, rng, vocab, zipf, n_queries=32):
    """The hooks step, on the serve phase's server: install a dynamic
    hook over HTTP, ingest 5,000 documents through it, check the stored
    vectors against the plain CPU encoder on the text the hook selected,
    the vetoed documents, vector and fulltext queries over HTTP against
    in-process, and the default text after the hook is removed. Returns
    the ``"hooks"`` record and the step's kernel launches."""
    from orama_core_tpu_torch.engine.minijs import MiniJsThrow, run_hook
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.types import SearchParams

    t_step = time.perf_counter()
    side = orama.read_side
    docs = _hooked_docs(rng, vocab, zipf)
    n_bad = sum(d["kind"] == "bad" for d in docs)
    for cid in ("unhooked", "hooked"):
        st, _ = _http(base, "POST", "/v1/collections/create",
                      {"id": cid, "read_api_key": "rk", "write_api_key": "wk",
                       "embeddings": {"model": "jax-minilm"}}, "master")
        require(st == 201, f"hooks: create {cid}: {st}")
    _cuda.reset_launches()
    # the same documents without a hook: every one embeds all its strings
    plain_sent, plain_s = _ingest(base, side, "unhooked", docs, len(docs),
                                  "hooks")
    st, res = _http(base, "POST", "/v1/collections/hooked/hooks/create",
                    {"name": HOOK_NAME, "code": HOOK_CODE}, "wk")
    require(st == 200 and res == {"ok": True},
            f"hooks: create hook: {st} {res}")
    st, res = _http(base, "GET", "/v1/collections/hooked/hooks/list",
                    bearer="wk")
    require(st == 200 and res == {HOOK_NAME: HOOK_CODE},
            f"hooks: list: {st} {res}")
    st, res = _http(base, "GET", f"/v1/hooked/hooks/get?name={HOOK_NAME}",
                    bearer="wk")
    require(st == 200 and res.get("code") == HOOK_CODE,
            f"hooks: get: {st} {res}")

    # a host clock around HooksRuntime.eval as the write path calls it
    hook_s = []
    real_eval = orama.hooks.eval

    def timed_eval(*args):
        t1 = time.perf_counter()
        try:
            return real_eval(*args)
        finally:
            hook_s.append(time.perf_counter() - t1)

    orama.hooks.eval = timed_eval
    try:
        hooked_sent, hooked_s = _ingest(base, side, "hooked", docs,
                                        len(docs) - n_bad, "hooks")
    finally:
        del orama.hooks.eval
    require(len(hook_s) == len(docs),
            f"hooks: eval ran {len(hook_s)} times for {len(docs)} documents")
    rows = {cid: next(iter(side._reader(cid)._vector.values()))
            .committed.n_vectors for cid in ("unhooked", "hooked")}

    # the text the hook selected, by the port's MiniJS on the CPU
    texts = {}
    for d in docs:
        try:
            sel = run_hook(HOOK_CODE, HOOK_NAME, dict(d))
        except MiniJsThrow:
            continue
        texts[d["id"]] = _embedding_text(d, sel)
    require(len(texts) == len(docs) - n_bad,
            f"hooks: {len(docs) - len(texts)} documents vetoed, "
            f"want {n_bad}")
    kinds = {k: sum(d["kind"] == k for d in docs)
             for k in ("faq", "other", "bad")}

    # (a) stored vectors against the plain CPU encoder on those texts
    ids = [str(u) for u in rng.choice(sorted(texts), 64, replace=False)]
    stored = _stored_vectors(side, "hooked", ids)
    require(all(v is not None for v in stored),
            "hooks: a sampled document has no vector row")
    want = cpu.embed(["passage: " + texts[u] for u in ids])
    cos = _cosines(np.stack(stored), want)
    require(float(cos.min()) >= 0.999,
            f"hooks: stored vs CPU encoder cosine {float(cos.min())}")

    # (b) the vetoed documents: stored, fulltext-searchable, no vector row
    bad = [d for d in docs if d["kind"] == "bad"]
    require(all(v is None for v in
                _stored_vectors(side, "hooked", [d["id"] for d in bad])),
            "hooks: a vetoed document has a vector row")
    for d in bad:
        require(side.get_document_by_user_id("hooked", d["id"]) is not None,
                f"hooks: vetoed document {d['id']} not stored")

    # (c) vector queries on the hooked text, (d) fulltext queries: over
    # HTTP and in process, the same hits
    queried = [str(u) for u in rng.choice(sorted(texts), n_queries,
                                          replace=False)]
    bodies = {
        "vector": [({"term": texts[u], "mode": "vector"}, u)
                   for u in queried],
        "fulltext": [({"term": d["ref"], "mode": "fulltext"}, d["id"])
                     for d in bad]
        + [({"term": " ".join(rng.choice(vocab, 2, p=zipf)),
             "mode": "fulltext"}, None)
           for _ in range(n_queries - len(bad))],
    }
    p50 = {}
    for mode, cases in bodies.items():
        lat_http, lat_proc = [], []
        for body, first in cases:
            t1 = time.perf_counter()
            st, res = _http(base, "POST",
                            "/v1/collections/hooked/search?api-key=rk", body)
            lat_http.append((time.perf_counter() - t1) * 1e3)
            require(st == 200, f"hooks {mode} {body}: {st} {res}")
            t1 = time.perf_counter()
            got = side.search("hooked", SearchParams.from_json(body), "rk")
            lat_proc.append((time.perf_counter() - t1) * 1e3)
            check_hits([(h["id"], h["score"]) for h in res["hits"]],
                       [(h.id, h.score) for h in got.hits], 1e-5,
                       f"hooks {mode} HTTP vs in-process {body}")
            require(res["count"] == got.count,
                    f"hooks {mode} {body}: count {res['count']} vs "
                    f"{got.count}")
            if first is not None:
                require(res["hits"] and res["hits"][0]["id"] == first,
                        f"hooks {mode} {body}: first hit "
                        f"{res['hits'][:1]}, want {first}")
        p50[mode] = {"http": float(np.percentile(lat_http, 50)),
                     "in_process": float(np.percentile(lat_proc, 50))}
    launches = dict(_cuda.LAUNCHES)
    # (e) the hooked collection's queries ran K1, K2 and K3
    for name in ("bm25_scan", "knn_subblock_max", "knn_rescore"):
        require(launches[name] > 0, f"hooks: {name} never ran")

    # (f) after the hook is removed, a new document embeds its default text
    st, _ = _http(base, "POST", "/v1/hooked/hooks/remove",
                  {"name": HOOK_NAME}, "wk")
    require(st == 200, f"hooks: remove: {st}")
    st, res = _http(base, "GET", "/v1/hooked/hooks/list", bearer="wk")
    require(st == 200 and res == {}, f"hooks: list after remove: {res}")
    late = dict(docs[1], id="late", ref="ref99999", kind="faq")
    st, res = _http(base, "POST", "/v1/collections/hooked/insert", [late],
                    "wk")
    require(st == 200, f"hooks: insert after remove: {st} {res}")
    deadline = time.perf_counter() + 60
    while True:
        (vec,) = _stored_vectors(side, "hooked", ["late"])
        if vec is not None:
            break
        require(time.perf_counter() < deadline,
                "hooks: the document inserted after remove has no vector")
        time.sleep(0.05)
    late_cos = float(_cosines(
        vec, cpu.embed(["passage: " + _embedding_text(late, None)])[0]))
    require(late_cos >= 0.999,
            f"hooks: default-text vector cosine {late_cos} after remove")

    # the hook alone, outside ingest: one clock around each eval
    st, _ = _http(base, "POST", "/v1/collections/hooked/hooks/create",
                  {"name": HOOK_NAME, "code": HOOK_CODE}, "wk")
    require(st == 200, f"hooks: re-create: {st}")
    alone = []
    for d in docs:
        t1 = time.perf_counter()
        try:
            orama.hooks.eval("hooked", HOOK_NAME, d)
        except RuntimeError:
            pass
        alone.append(time.perf_counter() - t1)
    orama.hooks.delete_hook("hooked", HOOK_NAME)

    rec = {
        "docs": len(docs), "kinds": kinds, "vector_rows": rows,
        "hook_ms_per_doc_in_ingest": 1e3 * sum(hook_s) / len(hook_s),
        "hook_ms_per_doc_p50_in_ingest": 1e3 * float(np.percentile(hook_s,
                                                                   50)),
        "hook_ms_per_doc_alone": 1e3 * sum(alone) / len(alone),
        "ingest": {
            "hooked": {"http_send_s": hooked_sent, "wall_s": hooked_s,
                       "passages_per_s": rows["hooked"] / hooked_s},
            "unhooked": {"http_send_s": plain_sent, "wall_s": plain_s,
                         "passages_per_s": rows["unhooked"] / plain_s},
        },
        "encoder_cpu_cosine_min": float(cos.min()),
        "default_text_cosine_after_remove": late_cos,
        "p50_ms": p50, "launches": launches,
        "wall_s": time.perf_counter() - t_step,
    }
    log(f"serve hooks: {rec}")
    return rec, launches


def serve_http(n_queries=32, seed=17):
    """``python -m orama_core_tpu_torch``'s server in-process on the card:
    ingest over HTTP until every doc is committed with its vectors, then
    each mode's queries over HTTP and in-process (equal hits), the answer
    and planned-answer streams, and the passage embeddings of the card
    against the port's plain CPU encoder on the same parameters."""
    import torch

    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.models.encoder import (
        EncoderEmbedder, HashTokenizer, params_from_numpy)
    from orama_core_tpu_torch.models.llm import ChatLLM
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.server.http import WebServer
    from orama_core_tpu_torch.types import SearchParams

    work = os.path.join(ROOT, "build", "chip_smoke_serve")
    shutil.rmtree(work, ignore_errors=True)
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = os.path.join(work, "w")
    cfg.reader_side.data_dir = os.path.join(work, "r")
    cfg.reader_side.commit_interval_sec = 2.0
    cfg.ai.backend = "jax"
    cfg.ai.embedding_model = "jax-minilm"
    cfg.writer_side.default_embedding_model = "jax-minilm"
    cfg.ai.llm_model = "jax-tiny"
    cfg.gpu.device = "cuda"
    cfg.http.port = 0
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    zipf = 1.0 / np.arange(1, 401) ** 0.8
    zipf /= zipf.sum()
    docs = {"short": _short_docs(rng, SERVE_DOCS["short"], vocab, zipf),
            "long": _long_docs(rng, SERVE_DOCS["long"], vocab, zipf)}
    orama = build_orama(cfg, start_background=True)
    server = WebServer(orama)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    side = orama.read_side
    out = {}
    try:
        t0 = time.perf_counter()
        for cid in docs:
            st, _ = _http(base, "POST", "/v1/collections/create",
                          {"id": cid, "read_api_key": "rk",
                           "write_api_key": "wk",
                           "embeddings": {"model": "jax-minilm"}}, "master")
            require(st == 201, f"serve: create {cid}: {st}")
        for cid, batch in (("short", 500), ("long", 100)):
            for lo in range(0, len(docs[cid]), batch):
                st, res = _http(base, "POST", f"/v1/collections/{cid}/insert",
                                docs[cid][lo:lo + batch], "wk")
                require(st == 200, f"serve: insert {cid}: {st} {res}")
        t_sent = time.perf_counter() - t0
        deadline = time.perf_counter() + 300
        while True:  # every doc searchable: committed with its vector rows
            ready = True
            for cid in docs:
                try:
                    have, live = _vector_docs(side._reader(cid))
                except (KeyError, StopIteration):
                    ready = False
                    break
                ready &= len(have) == len(docs[cid]) and not live
            if ready:
                break
            require(time.perf_counter() < deadline,
                    "serve: documents not searchable after 300 s")
            time.sleep(0.05)
        ingest_s = time.perf_counter() - t0
        rows = {cid: next(iter(side._reader(cid)._vector.values()))
                .committed.n_vectors for cid in docs}
        out["ingest"] = {
            "docs": SERVE_DOCS, "passages": rows, "http_send_s": t_sent,
            "wall_s": ingest_s, "passages_per_s": sum(rows.values()) / ingest_s}
        log(f"serve: ingest {out['ingest']}")

        # no fallback hides the card
        emb = side.ai._embedder("jax-minilm")
        require(isinstance(emb, EncoderEmbedder) and emb.device.type == "cuda"
                and emb.params["tok_emb"].is_cuda,
                f"serve: the encoder is not on the card ({emb!r})")
        require(isinstance(emb.tokenizer, HashTokenizer),
                "serve: jax-minilm lost its tokenizer")

        # queries over HTTP and in-process
        for cid in docs:  # first-use allocations of each branch
            for kind in ("fulltext", "vector", "hybrid"):
                side.search(cid, SearchParams.from_json(
                    {"term": "w1 w2", "mode": kind}), "rk")
        _cuda.reset_launches()
        p50 = {}
        for mode, (cid, kind, n_words, _) in SERVE_MODES.items():
            bodies = [{"term": " ".join(rng.choice(vocab, n_words, p=zipf)),
                       "mode": kind} for _ in range(n_queries)]
            before = dict(_cuda.LAUNCHES)
            lat_http, lat_proc = [], []
            for body in bodies:
                t1 = time.perf_counter()
                st, res = _http(base, "POST",
                                f"/v1/collections/{cid}/search?api-key=rk",
                                body)
                lat_http.append((time.perf_counter() - t1) * 1e3)
                require(st == 200, f"serve {mode} {body}: {st} {res}")
                t1 = time.perf_counter()
                want = side.search(cid, SearchParams.from_json(body), "rk")
                lat_proc.append((time.perf_counter() - t1) * 1e3)
                check_hits([(h["id"], h["score"]) for h in res["hits"]],
                           [(h.id, h.score) for h in want.hits], 1e-5,
                           f"serve {mode} HTTP vs in-process {body}")
                require(res["count"] == want.count,
                        f"serve {mode} {body}: count {res['count']} vs "
                        f"{want.count}")
            got = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
            for name in SERVE_MODES[mode][3]:
                require(got[name] > 0, f"serve {mode}: {name} never ran")
            p50[mode] = {"http": float(np.percentile(lat_http, 50)),
                         "in_process": float(np.percentile(lat_proc, 50))}
            log(f"serve {mode}: p50 {p50[mode]}, launches {got}")
        out["p50_ms"] = p50

        # the answer engine over HTTP, on the port's decoder
        events = _sse(base, "/v1/collections/short/answer?api-key=rk",
                      {"query": "what about w3 and w7?"})
        types = [e["type"] for e in events]
        require(types[:4] == ["acknowledgement", "optimizing-query",
                              "optimized-query", "sources"]
                and set(types[4:]) == {"answer_chunk"}
                and events[-1]["message"]["is_final"] is True
                and all(not e["message"]["is_final"] for e in events[4:-1]),
                f"serve: answer events out of order: {types}")
        require(events[3]["message"]["count"] > 0, "serve: answer found nothing")
        plan = _sse(base, "/v1/collections/short/planned_answer?api-key=rk",
                    {"query": "tell me about w5"})
        actions = [json.loads(e["message"])["action"] for e in plan]
        require(actions[0] == "ACTION_PLAN"
                and "PERFORM_ORAMA_SEARCH" in actions
                and actions[-1] == "GIVE_REPLY",
                f"serve: planned answer actions {actions}")
        llm = side.ai._get_llm()
        require(isinstance(llm, ChatLLM) and llm.device.type == "cuda"
                and llm.params["lm_head"].is_cuda,
                f"serve: the LLM is not on the card ({llm!r})")
        out["launches"] = dict(_cuda.LAUNCHES)
        out["answer_events"] = len(events)
        out["planned_actions"] = actions

        # the card's passage embeddings against the plain CPU encoder
        cpu = EncoderEmbedder("jax-minilm", cfg=emb.cfg,
                              params=params_from_numpy(emb.params, emb.cfg,
                                                       "cpu"),
                              tokenizer=emb.tokenizer, device="cpu")
        texts = ["passage: " + d["title"] + " " + d["body"]
                 for d in docs["short"][:192]]
        texts += ["passage: " + d["body"][:600] for d in docs["long"][:64]]
        a, b = emb.embed(texts), cpu.embed(texts)
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                 * np.linalg.norm(b, axis=-1))
        require(float(cos.min()) >= 0.999,
                f"serve: card vs CPU encoder cosine {float(cos.min())}")
        out["encoder_cpu_cosine_min"] = float(cos.min())

        out["hooks"], hook_launches = serve_hooks(base, orama, cpu, rng,
                                                  vocab, zipf)
        out["hooks"]["card"] = card_line()
        for k, v in hook_launches.items():
            out["launches"][k] += v
        del cpu
    finally:
        server.stop()
        orama.close()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def serve_semantic():
    """tests/assets/tiny-semantic through the port's safetensors reader
    and WordPiece tokenizer on the card: tests/test_semantic_e2e.py's four
    cross-vocabulary queries rank their target first."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.models.encoder import EncoderEmbedder
    from orama_core_tpu_torch.types import SearchParams

    passages = {
        "baking": "Combine the flour, sugar and butter, then leave the tin "
        "in a hot oven for forty minutes.",
        "astronomy": "The telescope's mirror gathers faint light from "
        "galaxies billions of parsecs away.",
        "football": "The striker volleyed the cross into the top corner "
        "just before the final whistle.",
        "medicine": "The physician prescribed antibiotics after the blood "
        "test confirmed a bacterial infection.",
    }
    queries = {
        "baking": "how do I make a cake",
        "astronomy": "observing distant stars at night",
        "football": "an exciting soccer goal",
        "medicine": "treatment for an illness caused by germs",
    }
    work = os.path.join(ROOT, "build", "chip_smoke_semantic")
    shutil.rmtree(work, ignore_errors=True)
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = os.path.join(work, "w")
    cfg.reader_side.data_dir = os.path.join(work, "r")
    cfg.ai.backend = "jax"
    cfg.ai.embedding_model = "bge-small"
    cfg.writer_side.default_embedding_model = "bge-small"
    cfg.ai.embedding_checkpoint_path = os.path.join(
        ROOT, "tests", "assets", "tiny-semantic")
    e = build_orama(cfg, start_background=False, device="cuda")
    try:
        emb = e.read_side.ai._embedder("bge-small")
        require(isinstance(emb, EncoderEmbedder) and emb.device.type == "cuda"
                and emb.cfg.hidden == 96,
                f"semantic: the checkpoint did not load on the card ({emb!r})")
        e.write_side.create_collection("master", "sem", "rk", "wk")
        e.flush()
        docs = [{"id": t, "body": x} for t, x in passages.items()]
        docs += [{"id": f"noise{i}", "body": f"miscellaneous filler entry {i}"}
                 for i in range(20)]
        e.write_side.write("sem", docs, "wk")
        e.commit()
        ranks = {}
        for topic, q in queries.items():
            r = e.read_side.search("sem", SearchParams.from_json(
                {"term": q, "mode": "vector", "limit": 3}), "rk")
            ranks[topic] = [h.id for h in r.hits]
            require(r.hits and r.hits[0].id == topic,
                    f"semantic: {q!r} ranked {ranks[topic]}")
    finally:
        e.close()
        shutil.rmtree(work, ignore_errors=True)
    return {"checkpoint": "tests/assets/tiny-semantic", "top3": ranks}


def encoder_throughput(batch=64, iters=3):
    """Encoder forward at the registry's jax-minilm width (6 layers) and
    BAAI/bge-small-en-v1.5's (12 layers): hidden 384, 12 heads, MLP 1,536,
    vocab 30,522, bf16, seeded random weights made on the card; batches of
    64 x 128 and 64 x 512 real tokens. Device ms by CUDA events; bound =
    bf16 dense FLOPs / 989 TFLOP/s + f32 attention FLOPs / 67 TFLOP/s (the
    logits and the weighted sum; TF32 off)."""
    import dataclasses

    import torch

    from orama_core_tpu_torch.models import encoder as enc

    rows = []
    for name, layers in (("jax-minilm", 6), ("bge-small", 12)):
        cfg = dataclasses.replace(enc.MINILM, layers=layers)
        params = enc.init_params(
            cfg, torch.Generator("cuda").manual_seed(layers), "cuda")
        h, m = cfg.hidden, cfg.mlp
        for length in (128, 512):
            g = torch.Generator("cuda").manual_seed(length)
            ids = torch.randint(1, cfg.vocab_size, (batch, length),
                                generator=g, device="cuda")
            mask = torch.ones(batch, length, device="cuda")
            with torch.inference_mode():
                # few calls: a forward is 100-300 launches, and more queued
                # behind time_ms's spin would time the host's launch rate
                ms = time_ms(lambda: enc.encode(params, cfg, ids, mask), iters)
                out = enc.encode(params, cfg, ids, mask)
            require(bool(torch.isfinite(out).all())
                    and out.shape == (batch, cfg.out_dim),
                    f"encoder {name} x {length}: bad output")
            tokens = batch * length
            dense = 2.0 * tokens * (4 * h * h + 2 * h * m) * layers
            attn = 4.0 * batch * length * length * h * layers
            bound = (dense / BF16_FLOPS + attn / F32_FLOPS) * 1e3
            rows.append({"model": name, "layers": layers, "batch": batch,
                         "tokens": length, "ms": ms,
                         "passages_per_s": batch / ms * 1e3,
                         "bf16_gflop": dense / 1e9, "f32_gflop": attn / 1e9,
                         "bound_ms": bound, "share": bound / ms})
            log(f"encoder {rows[-1]}")
        del params
    torch.cuda.empty_cache()
    return rows


# Qwen/Qwen2.5-3B-Instruct's published config (the reference sidecar's
# answer model), max_len capped at 4,096 as hf_loader caps it
QWEN25_3B = dict(vocab_size=151936, hidden=2048, layers=36, heads=16,
                 kv_heads=2, mlp=11008, max_len=4096, rope_theta=1e6,
                 rms_eps=1e-6)
# f32 cached decode against the f32 full forward at that width: relative
# L2 of the last position's logits (the CPU tests hold 1e-5 at 2 layers)
DECODER_REL_TOL = 1e-4


def qwen_params(layers=None, dtype=None, device="cuda"):
    """(config, seeded parameters on the card) at Qwen2.5-3B's width:
    q/k/v biases, lm_head tied to the embeddings as f32; ``layers`` cuts
    the depth, ``dtype`` the working type (bf16)."""
    import torch

    from orama_core_tpu_torch.models import llm

    conf = dict(QWEN25_3B)
    if layers is not None:
        conf["layers"] = layers
    if dtype is not None:
        conf["dtype"] = dtype
    cfg = llm.LlmConfig(**conf)
    g = torch.Generator(device).manual_seed(0)
    params = llm.init_params(cfg, g, device)
    for layer in params["layers"]:
        for name, width in (("bq", cfg.heads), ("bk", cfg.kv_heads),
                            ("bv", cfg.kv_heads)):
            layer[name] = (torch.randn(width * cfg.head_dim, generator=g,
                                       device=device) * 0.02).to(cfg.dtype)
    params["lm_head"] = None  # free the drawn head before tying it
    params["lm_head"] = params["tok_emb"].float().t().contiguous()
    torch.cuda.synchronize()
    return cfg, params


def decoder_width(prompt=512, new=64):
    """The decoder at Qwen2.5-3B's width, batch 1, seeded bf16 weights
    made on the card (q/k/v biases, lm_head tied to the embeddings as f32):
    prefill ms of a 512-token prompt, decode ms per token over 64 greedy
    tokens through ``generate`` (host clock, synchronised) against the
    bytes one token must read, GiB on the card, and the cached decode's
    logits against a full forward in f32 (tests/test_llm.py's check)."""
    import torch

    from orama_core_tpu_torch.models import llm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    cfg, params = qwen_params()
    hd = cfg.head_dim
    weight_bytes = sum(
        t.numel() * t.element_size() for t in
        [params["tok_emb"], params["out_norm"], params["lm_head"]]
        + [v for layer in params["layers"] for v in layer.values()])
    gen = torch.Generator("cuda").manual_seed(1)
    ids = torch.randint(0, 151643, (1, prompt), generator=gen, device="cuda",
                        dtype=torch.int32)
    plen = torch.tensor([prompt], dtype=torch.int32)
    eos = cfg.vocab_size  # never drawn: every run decodes all its tokens

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = llm.generate(params, cfg, ids, plen, max_new=n, eos_id=eos)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, toks

    run(2)  # first-use allocations
    prefill = min(run(1)[0] for _ in range(3))
    full_ms, toks = run(new + 1)
    decode = (full_ms - prefill) / new
    require(toks.shape == (1, new + 1) and bool((toks < eos).all()),
            "decoder: bad tokens")
    peak_gib = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    # two bounds each. "as computed": the work the port (as the reference)
    # does -- a decode step reads every weight, the f32 lm_head and the
    # whole 4,096-slot cache; prefill takes f32 logits over the whole cache
    # and the f32 lm_head at every prompt position. "needed": the work the
    # answer needs -- a decode step reads the bf16 weights with the head as
    # the bf16 embeddings and the cache's live positions (prompt + new / 2
    # on average over the run); prefill attends the causal prompt pairs and
    # takes the head at the last position only
    emb_bytes = params["tok_emb"].numel() * params["tok_emb"].element_size()
    head_bytes = params["lm_head"].numel() * params["lm_head"].element_size()
    kv_slot_bytes = 2 * cfg.layers * cfg.kv_heads * hd * 2
    decode_bound = ((weight_bytes - emb_bytes + kv_slot_bytes * cfg.max_len)
                    / HBM_BYTES_PER_S * 1e3)
    decode_needed_bound = ((weight_bytes - head_bytes
                            + kv_slot_bytes * (prompt + new / 2))
                           / HBM_BYTES_PER_S * 1e3)
    layer_flops = 2.0 * prompt * cfg.layers * (
        2 * cfg.hidden * cfg.hidden + 2 * cfg.hidden * cfg.kv_heads * hd
        + 3 * cfg.hidden * cfg.mlp)
    attn_flops = 2.0 * prompt * cfg.max_len * cfg.hidden * cfg.layers
    head_flops = 2.0 * prompt * cfg.hidden * cfg.vocab_size
    prefill_bound = ((layer_flops + attn_flops) / BF16_FLOPS
                     + (attn_flops + head_flops) / F32_FLOPS) * 1e3
    causal_flops = 2.0 * (prompt * (prompt + 1) / 2) * cfg.hidden * cfg.layers
    prefill_needed_bound = max(
        ((layer_flops + causal_flops) / BF16_FLOPS
         + (causal_flops + head_flops / prompt) / F32_FLOPS) * 1e3,
        (weight_bytes - head_bytes) / HBM_BYTES_PER_S * 1e3)

    # cached decode's last-position logits against a full forward, both in
    # f32 (TF32 off), so that bf16 rounding cannot hide a cache fault
    f32 = llm.LlmConfig(**{**QWEN25_3B, "dtype": torch.float32})
    exact = llm.params_from_numpy(params, f32, "cuda")
    del params
    torch.cuda.empty_cache()
    with torch.inference_mode():
        cache = llm.make_cache(f32, 1, "cuda")
        pos = torch.arange(prompt, dtype=torch.int32, device="cuda")[None]
        llm.forward(exact, f32, ids, pos, cache, 0)
        step = toks[:, :1]
        cached, _ = llm.forward(exact, f32, step, pos[:, -1:] + 1, cache,
                                prompt)
        seq = torch.cat([ids, step], dim=1)
        full, _ = llm.forward(exact, f32, seq, torch.arange(
            prompt + 1, dtype=torch.int32, device="cuda")[None], None, 0)
    c_, f_ = cached[0, -1], full[0, -1]
    diff = float((c_ - f_).abs().max())
    scale = float(f_.abs().max())
    rel = float(torch.linalg.vector_norm(c_ - f_) / torch.linalg.vector_norm(f_))
    same_argmax = bool(c_.argmax() == f_.argmax())
    require(bool(torch.isfinite(cached).all()) and rel <= DECODER_REL_TOL
            and same_argmax,
            f"decoder: f32 cached vs full logits: relative L2 {rel} (limit "
            f"{DECODER_REL_TOL}), max abs {diff} (scale {scale}), argmax "
            f"equal {same_argmax}")
    del exact, cache, cached, full
    torch.cuda.empty_cache()
    rec = {"config": "Qwen/Qwen2.5-3B-Instruct width", **QWEN25_3B,
           "dtype": "bfloat16", "prompt": prompt, "new_tokens": new,
           "prefill_ms": prefill, "prefill_bound_ms": prefill_bound,
           "prefill_needed_bound_ms": prefill_needed_bound,
           "decode_ms_per_token": decode, "decode_bound_ms": decode_bound,
           "decode_needed_bound_ms": decode_needed_bound,
           "weight_gib": weight_bytes / 2**30, "peak_gib": peak_gib,
           "f32_cached_vs_full_rel_l2": rel,
           "f32_cached_vs_full_max_abs": diff, "logit_scale": scale,
           "argmax_equal": same_argmax}
    log(f"decoder {rec}")
    return rec


# -- tensor parallelism over the mesh's model axis (models/tp.py) -----------

TP_ENCODER_MESHES = ((2, 2), (1, 4))
TP_DECODER_MESHES = ((1, 2), (1, 4))
# The decoder's teacher-forced bound: once the row split rounds one
# partial product differently, every later bf16 rounding of the sharded
# and the single-device runs differs, so they drift apart as two
# independent bf16 evaluations of one function, about sqrt(2) times
# either's distance from the f32 run, whatever the number of extra
# roundings (2 (M - 1) a layer). The bound is twice the single device's
# bf16-against-f32 relative L2 at the same step (a CPU calibration at 4
# and 12 layers of a narrower model measured at most 1.27 times it); a
# wrong split moves the logits by O(1). The sharded code path with one
# shard, mesh (1, 1), is held to 0 exactly: it adds nothing but the
# split's roundings.
TP_NOISE_FACTOR = 2.0


def kernel_launches(fn) -> int:
    """Work items (kernels, copies, fills) one call of ``fn`` puts on the
    card, from torch.profiler's device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA"))


def placed_gib(tree):
    """(GiB of one model shard's split leaves, GiB of the replicated
    leaves) of a tree placed by ``shard_params``."""
    from orama_core_tpu_torch.parallel.mesh import Placed

    split = rep = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack += list(x.values())
        elif isinstance(x, list):
            stack += x
        elif isinstance(x, Placed):
            t = x.parts[0]
            n = t.numel() * t.element_size()
            if x.split:
                split += n // t.shape[0]
            else:
                rep += n
    return split / 2**30, rep / 2**30


def tp_encoder(batch=64, iters=3, device="cuda"):
    """The encoder under ``param_specs`` at jax-minilm's and bge-small's
    widths (encoder_throughput's seeded weights and batches), every model
    shard on this card: bf16 rows against the single device's by cosine
    (>= 0.999, the single-device bf16 tests' bound), f32 at 64 x 128
    within 2e-5 max abs (the reference's TP tolerance), ms and device
    work items per forward beside the single device's, GiB a shard."""
    import dataclasses

    import torch

    from orama_core_tpu_torch.models import encoder as enc
    from orama_core_tpu_torch.parallel.mesh import make_mesh, shard_params

    rows = []
    for name, layers in (("jax-minilm", 6), ("bge-small", 12)):
        cfg = dataclasses.replace(enc.MINILM, layers=layers)
        params = enc.init_params(
            cfg, torch.Generator(device).manual_seed(layers), device)
        placed = {shape: shard_params(make_mesh(shape, device=device),
                                      params, enc.param_specs(cfg))
                  for shape in TP_ENCODER_MESHES}
        for length in (128, 512):
            g = torch.Generator(device).manual_seed(length)
            ids = torch.randint(1, cfg.vocab_size, (batch, length),
                                generator=g, device=device)
            mask = torch.ones(batch, length, device=device)
            with torch.inference_mode():
                single = lambda: enc.encode(params, cfg, ids, mask)  # noqa: E731
                want = single()
                single_ms = time_ms(single, iters)
                single_n = kernel_launches(single)
                for shape, sp in placed.items():
                    tp_fn = lambda sp=sp: enc.encode(sp, cfg, ids, mask)  # noqa: E731
                    got = tp_fn()
                    cos = float(torch.nn.functional.cosine_similarity(
                        got, want, dim=-1).min())
                    require(got.shape == want.shape
                            and bool(torch.isfinite(got).all()) and cos >= 0.999,
                            f"tp encoder {name} x {length} at {shape}: "
                            f"min cosine {cos}")
                    split_gib, rep_gib = placed_gib(sp)
                    rows.append({
                        "model": name, "layers": layers, "batch": batch,
                        "tokens": length, "mesh": list(shape),
                        "units": len(sp["tok_emb"].layout.units),
                        "bf16_min_cosine": cos, "ms": time_ms(tp_fn, iters),
                        "single_ms": single_ms,
                        "launches": kernel_launches(tp_fn),
                        "single_launches": single_n,
                        "shard_split_gib": split_gib,
                        "replicated_gib": rep_gib})
                    log(f"tp encoder {rows[-1]}")
        del params, placed
    # f32 (the reference's TP test's type) at jax-minilm x 128
    cfg = dataclasses.replace(enc.MINILM, dtype=torch.float32)
    params = enc.init_params(cfg, torch.Generator(device).manual_seed(6),
                             device)
    g = torch.Generator(device).manual_seed(128)
    ids = torch.randint(1, cfg.vocab_size, (batch, 128), generator=g,
                        device=device)
    mask = torch.ones(batch, 128, device=device)
    f32 = {}
    with torch.inference_mode():
        want = enc.encode(params, cfg, ids, mask)
        for shape in TP_ENCODER_MESHES:
            sp = shard_params(make_mesh(shape, device=device), params,
                              enc.param_specs(cfg))
            got = enc.encode(sp, cfg, ids, mask)
            f32[str(shape)] = float((got - want).abs().max())
            require(f32[str(shape)] <= 2e-5,
                    f"tp encoder f32 at {shape}: max abs {f32[str(shape)]}")
    del params
    torch.cuda.empty_cache()
    return {"rows": rows, "f32_max_abs": f32}


def _rel_l2(a, b):
    import torch

    return (torch.linalg.vector_norm(a - b, dim=-1)
            / torch.linalg.vector_norm(b, dim=-1))


def teacher_forced(llm, params, cfg, ids, toks, device="cuda"):
    """f32 logits [n, V]: at the prompt's last position, then at each of
    ``toks[:, :n - 1]`` fed one at a time through the cache."""
    import torch

    prompt = ids.shape[1]
    n = toks.shape[1]
    with torch.inference_mode():
        cache = llm.make_cache(cfg, 1, device, params=params)
        pos = torch.arange(prompt, dtype=torch.int32, device=device)[None]
        logits, cache = llm.forward(params, cfg, ids, pos, cache, 0)
        out = [logits[0, -1].float()]
        for i in range(n - 1):
            lg, cache = llm.forward(
                params, cfg, toks[:, i:i + 1],
                torch.tensor([[prompt + i]], dtype=torch.int32,
                             device=device), cache, prompt + i)
            out.append(lg[0, -1].float())
    del cache
    return torch.stack(out)


def tp_decoder(prompt=512, new=64, device="cuda"):
    """The decoder under ``param_specs`` (biases split with their
    columns) at Qwen2.5-3B's width, full depth, every shard on this card.
    Teacher-forced: a 512-token prefill, then the single device's 64
    greedy tokens fed to both; at every step the sharded logits' relative
    L2 against the single device's stays within TP_NOISE_FACTOR times the
    single device's bf16-against-f32 distance, the first token is equal,
    and the (1, 1) control is exact. f32 at 2 layers of the width within
    DECODER_REL_TOL. Greedy-sequence agreement is reported only. Prefill
    and decode ms (host clock), device work items per decode token, GiB a
    shard."""
    import torch

    from orama_core_tpu_torch.models import llm
    from orama_core_tpu_torch.parallel.mesh import make_mesh, shard_params

    torch.cuda.empty_cache()
    cfg, params = qwen_params(device=device)
    specs = llm.param_specs(cfg, with_bias=True)
    gen = torch.Generator(device).manual_seed(1)
    ids = torch.randint(0, 151643, (1, prompt), generator=gen, device=device,
                        dtype=torch.int32)
    plen = torch.tensor([prompt], dtype=torch.int32)
    eos = cfg.vocab_size  # never drawn: every run decodes all its tokens

    def timed(p):
        def run(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = llm.generate(p, cfg, ids, plen, max_new=n, eos_id=eos)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, toks

        run(2)
        prefill = min(run(1)[0] for _ in range(3))
        full_ms, toks = run(new)
        step = llm.make_cache(cfg, 1, device, params=p)
        pos = torch.arange(prompt, dtype=torch.int32, device=device)[None]
        with torch.inference_mode():
            llm.forward(p, cfg, ids, pos, step, 0)
            one = lambda: llm.forward(  # noqa: E731
                p, cfg, toks[:, :1], pos[:, -1:] + 1, step, prompt)
            launches = kernel_launches(one)
        del step
        return {"prefill_ms": prefill,
                "decode_ms_per_token": (full_ms - prefill) / (new - 1),
                "launches_per_token": launches}, toks

    single, toks = timed(params)
    require(toks.shape == (1, new) and bool((toks < eos).all()),
            "tp decoder: bad single-device tokens")
    want = teacher_forced(llm, params, cfg, ids, toks, device)
    f32cfg = llm.LlmConfig(**{**QWEN25_3B, "dtype": torch.float32})
    exact = llm.params_from_numpy(params, f32cfg, device)
    noise = _rel_l2(want, teacher_forced(llm, exact, f32cfg, ids, toks, device))
    del exact
    torch.cuda.empty_cache()
    ctrl = shard_params(make_mesh((1, 1), device=device), params, specs)
    control = float(_rel_l2(teacher_forced(llm, ctrl, cfg, ids, toks, device),
                            want).max())
    del ctrl
    require(control == 0.0, f"tp decoder: the (1, 1) control moved the "
            f"logits by relative L2 {control}")
    top2 = torch.topk(want[0], 2).values
    rec = {"config": "Qwen/Qwen2.5-3B-Instruct width", "layers": cfg.layers,
           "prompt": prompt, "new_tokens": new, "single": single,
           "bf16_vs_f32_rel_l2": {"max": float(noise.max()),
                                  "median": float(noise.median())},
           "control_1x1_rel_l2": control,
           "first_token_margin": float(top2[0] - top2[1]),
           "noise_factor": TP_NOISE_FACTOR, "meshes": {}}
    for shape in TP_DECODER_MESHES:
        sp = shard_params(make_mesh(shape, device=device), params, specs)
        got = teacher_forced(llm, sp, cfg, ids, toks, device)
        rel = _rel_l2(got, want)
        ratio = rel / noise
        first = int(got[0].argmax())
        require(bool(torch.isfinite(got).all())
                and float(ratio.max()) <= TP_NOISE_FACTOR,
                f"tp decoder {shape}: teacher-forced relative L2 "
                f"{rel.tolist()} against the bound {TP_NOISE_FACTOR} x "
                f"{noise.tolist()}")
        require(first == int(toks[0, 0]), f"tp decoder {shape}: first token "
                f"{first} against {int(toks[0, 0])}")
        timing, tp_toks = timed(sp)
        split_gib, rep_gib = placed_gib(sp)
        plan_nkv = llm._plan(sp, cfg).nkv
        cache_gib = (2 * cfg.layers * cfg.max_len * plan_nkv * cfg.head_dim
                     * 2) / 2**30
        rec["meshes"][str(shape)] = {
            **timing, "units": len(sp["tok_emb"].layout.units),
            "rel_l2_max": float(rel.max()),
            "rel_l2_median": float(rel.median()),
            "ratio_to_noise_max": float(ratio.max()),
            "first_token_equal": True,
            "greedy_tokens_equal_single": float(
                (tp_toks == toks).float().mean()),
            "shard_split_gib": split_gib, "replicated_gib": rep_gib,
            "shard_cache_gib": cache_gib}
        log(f"tp decoder {shape} {rec['meshes'][str(shape)]}")
        del sp
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    # f32 at 2 layers of the width: prefill and 8 forced steps
    cfg2, p2 = qwen_params(layers=2, dtype=torch.float32,
                           device=device)
    toks2 = toks[:, :9]
    want2 = teacher_forced(llm, p2, cfg2, ids, toks2, device)
    rec["f32_2_layers_rel_l2"] = {}
    for shape in TP_DECODER_MESHES:
        sp2 = shard_params(make_mesh(shape, device=device), p2,
                           llm.param_specs(cfg2, True))
        got2 = teacher_forced(llm, sp2, cfg2, ids, toks2, device)
        r = float(_rel_l2(got2, want2).max())
        rec["f32_2_layers_rel_l2"][str(shape)] = r
        require(r <= DECODER_REL_TOL, f"tp decoder f32 at {shape}: relative "
                f"L2 {r} (limit {DECODER_REL_TOL})")
    del p2
    torch.cuda.empty_cache()
    return rec


RACE_WORDS = ["solar", "wind", "cake", "qubit", "grid"]
RACE_QUERIES = [{"term": "solar"}, {"term": "wind grid"},
                {"term": "x", "mode": "vector"},
                {"term": "qubit", "mode": "hybrid"},
                ["solar", "qubit", "cake"], ["grid", "wind"]]


def capacity_race(n_base=2000, n_threads=8, per_thread=12, seed=21,
                  device="cuda"):
    """The single-device reader on the card while its capacity grows
    (tests/test_torch_capacity_race.py on the card): 8 threads search
    (fulltext, phrase, vector, hybrid, batches) while a writer adds
    documents past three 8,192-slot capacity buckets and commits after
    each. Every search returns; a search during which no op landed (only
    commits, or nothing) equals a CPU reader that replayed the writes up
    to one of the points it could have pinned its view at; afterwards
    every query equals the CPU reader of the last state. K1 and K4 run on
    the card in the phase."""
    import sys as _sys
    import threading

    import torch

    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import CollectionReader
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.oplog import (CreateFieldOp, IndexEmbeddingOp,
                                            IndexStringOp, InsertDocumentOp)
    from orama_core_tpu_torch.types import (SearchParams, TypedField,
                                            ValueType)

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="race-", dir=os.path.join(ROOT, "build"))

    def doc(i, words):
        return [InsertDocumentOp("c", i, {"id": str(i)}),
                IndexStringOp("c", i, 0, len(words),
                              {w: (p,) for p, w in enumerate(words)}),
                IndexEmbeddingOp("c", i, 1, (tuple(map(
                    float, rng.standard_normal(16))),))]

    events = [("op", CreateFieldOp("c", TypedField(0, "body", ValueType.STRING))),
              ("op", CreateFieldOp("c", TypedField(1, "emb", ValueType.EMBEDDING,
                                                   model="fake-small")))]
    for i in range(n_base):
        events += [("op", o) for o in doc(i, rng.choice(RACE_WORDS, 3))]
    events.append(("commit", None))
    n0 = len(events)
    for r in (1, 2, 3):
        for i in range(8192 * r, 8192 * r + 4):
            events += [("op", o) for o in doc(i, RACE_WORDS)]
        events.append(("commit", None))
    commits = [0]

    def play(reader, evs):
        for kind, op in evs:
            if kind == "op":
                reader.apply(op)
            else:
                commits[0] += 1
                reader.commit(os.path.join(work, str(commits[0])),
                              offset=commits[0])

    def reader_upto(n, device):
        r = CollectionReader("c", "rk", None, GpuConfig(device=device))
        play(r, events[:n])
        return r

    class _AI:
        q = np.random.default_rng(3).standard_normal((1, 16)).astype(
            np.float32)

        def embed_query(self, model, texts):
            return np.repeat(self.q, len(texts), axis=0)

    ai = _AI()

    def search(reader, body):
        if isinstance(body, list):
            return [r for r in reader.search_batch(
                [SearchParams.from_json({"term": t}) for t in body], ai)]
        return [reader.search(SearchParams.from_json(dict(body)), ai)[:2]]

    def same(got, want):
        """The hits of every row equal (check_hits: K1's atomics and the
        card's products sum in another order), counts within 2 (a
        similarity near 0 may change sign)."""
        try:
            require(len(got) == len(want), "race: rows")
            for (g, gn), (w, wn) in zip(got, want):
                check_hits(g, w, 1e-4, "race")
                require(abs(gn - wn) <= 2, "race: count")
        except SmokeFailure:
            return False
        return True

    live = reader_upto(n0, device)
    live.warmup()
    for body in RACE_QUERIES:
        search(live, body)
    torch.cuda.synchronize()
    before = dict(_cuda.LAUNCHES)
    begun, done = [n0], [n0]
    records, errors = [], []

    def searcher(k):
        try:
            for j in range(per_thread):
                body = RACE_QUERIES[(j + k) % len(RACE_QUERIES)]
                b = done[0]
                res = search(live, body)
                records.append((b, begun[0], body, res))
        except Exception as e:  # noqa: BLE001 - a failed search fails the phase
            errors.append(repr(e))

    def writer():
        for i in range(n0, len(events)):
            begun[0] = i + 1
            play(live, events[i:i + 1])
            done[0] = i + 1

    old = _sys.getswitchinterval()
    _sys.setswitchinterval(1e-5)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=searcher, args=(k,))
                   for k in range(n_threads)] + [threading.Thread(target=writer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        _sys.setswitchinterval(old)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _cuda.LAUNCHES[k] - before.get(k, 0) for k in _cuda.LAUNCHES}
    require(not any(t.is_alive() for t in threads), "race: a thread hung")
    require(not errors, f"race: searches failed: {errors[:3]}")
    require(live.capacity == 4 * 8192, f"race: capacity {live.capacity}")
    cpu = {}
    quiet = moved = 0
    for b, a, body, res in records:
        if all(kind == "commit" for kind, _ in events[b:a]):
            quiet += 1
            ok = False
            for j in range(b, a + 1):
                if j not in cpu:
                    cpu[j] = reader_upto(j, "cpu")
                if same(res, search(cpu[j], body)):
                    ok = True
                    break
            require(ok, f"race: {body} read no state in [{b}, {a}]")
        else:
            moved += 1
            for ranked, _n in res:
                docs = [d for d, _ in ranked]
                require(len(set(docs)) == len(docs)
                        and all(0 <= d < live.capacity for d in docs),
                        f"race: {body}: bad hits {docs[:5]}")
    require(quiet > 0, "race: no search ran between two writes")
    last = reader_upto(len(events), "cpu")
    equal = 0
    for body in RACE_QUERIES:
        require(same(search(live, body), search(last, body)),
                f"race: {body} differs from the CPU reader after the writes")
        equal += 1
    cached = {id(f.committed) for t in (live._string, live._vector,
                                         live._number, live._keyword,
                                         live._bool) for f in t.values()}
    stale = [k for k in live._device._keepalive if k not in cached]
    require(not stale, f"race: the device cache keeps {len(stale)} "
            "superseded generations")
    for k in ("bm25_scan", "phrase_counts"):
        require(launches.get(k, 0) > 0, f"race: {k} never ran")
    shutil.rmtree(work, ignore_errors=True)
    rec = {"threads": n_threads, "searches": len(records),
           "searches_without_writes": quiet, "searches_during_writes": moved,
           "capacity": live.capacity, "wall_s": wall,
           "queries_equal_after": equal,
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"race {rec}")
    return rec, launches


def benchgen_check(n=1 << 20, d=384, salt=42, rows=8192,
                   device="cuda"):
    """utils/benchgen.py's corpus at 1M x 384 bf16 on the card, held to
    the CPU's rows in three slices (start, middle, end): bf16 equal but
    for elements one ulp apart (at most 0.1% of them), f32 within 2e-7."""
    import torch

    from orama_core_tpu_torch.utils.benchgen import hashed_unit_corpus

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = hashed_unit_corpus(n, d, salt, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    require(corpus.shape == (n, d) and corpus.dtype == torch.bfloat16,
            "benchgen: bad corpus")
    worst, share, f32_err = 0, 0.0, 0.0
    for r0 in (0, n // 2, n - rows):
        cpu = hashed_unit_corpus(n, d, salt, device="cpu",
                                 rows=(r0, r0 + rows))
        got = corpus[r0:r0 + rows].cpu()
        ulps = (got.view(torch.int16).int() - cpu.view(torch.int16).int()).abs()
        worst = max(worst, int(ulps.max()))
        share = max(share, float((ulps > 0).float().mean()))
        f32 = hashed_unit_corpus(n, d, salt, torch.float32, device,
                                 rows=(r0, r0 + 64)).cpu()
        f32_cpu = hashed_unit_corpus(n, d, salt, torch.float32, "cpu",
                                     rows=(r0, r0 + 64))
        f32_err = max(f32_err, float((f32 - f32_cpu).abs().max()))
    require(worst <= 1 and share <= 1e-3 and f32_err <= 2e-7,
            f"benchgen: card rows differ from the CPU's: {worst} ulp, share "
            f"{share}, f32 {f32_err}")
    del corpus
    torch.cuda.empty_cache()
    rec = {"rows": n, "dim": d, "ms": ms, "max_ulp": worst,
           "ulp_share": share, "f32_max_abs": f32_err}
    log(f"benchgen {rec}")
    return rec


def phase_tp(card):
    """This slice's phase: the tensor-parallel encoder and decoder on the
    card, the single-device capacity race, and the benchmark corpus
    generator. Returns the ``{"tp": ...}`` record and the phase's kernel
    launches (the race's K1 and K4)."""
    t0 = time.perf_counter()
    rec = {"encoder": tp_encoder(), "decoder": tp_decoder()}
    race, launches = capacity_race()
    rec["race"] = race
    rec["benchgen"] = benchgen_check()
    rec["wall_s"] = time.perf_counter() - t0
    return rec, launches


def phase_serve(card):
    """This slice's phase: the server, the semantic checkpoint, encoder
    throughput and the decoder at full width. Returns the ``{"serve": ...}``
    record and the phase's kernel launches."""
    t0 = time.perf_counter()
    rec = serve_http()
    rec["semantic"] = serve_semantic()
    rec["encoder"] = encoder_throughput()
    rec["decoder"] = decoder_width()
    rec["wall_s"] = time.perf_counter() - t0
    return rec, rec["launches"]


TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
TRAIN_MINILM_STEPS = 200
ENGINE_PROBE_DOCS = 4608    # K2 serves vector queries from 4,096 rows
ENGINE_PROBE_QUERIES = 256
ENGINE_PROBE_SEED = 2024    # neither the training stream (0) nor the probe's


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_default(out, device="cuda", steps=700):
    """``tools/train_tiny_encoder`` at the script's defaults (700 steps of
    batch 96, hidden 96, 2 layers, f32, seed 0) on the card: its gate
    (held-out topic accuracy > 0.85) and round trip (cosine > 0.999
    through the port's loader) hold; losses, accuracies, ms a step (CUDA
    events), peak GiB above what was allocated before, and
    ``train_step_profile``'s host and device shares against the bound."""
    import torch

    from orama_core_tpu_torch.tools import train_tiny_encoder as cli

    on_card = torch.device(device).type == "cuda"
    if on_card:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    try:
        rec = cli.run(cli.parse_args(["--out", out, "--device", device,
                                      "--steps", str(steps)]))
    except cli.GateFailure as e:
        raise SmokeFailure(f"train: {e}") from e
    losses = rec["losses"]
    require(losses[-1] < losses[0] and all(np.isfinite(losses)),
            f"train: loss {losses[0]} -> {losses[-1]}")
    require(rec["roundtrip_cosine"] >= 0.999,
            f"train: round trip {rec['roundtrip_cosine']}")
    out_rec = {
        "steps": rec["steps"], "batch": rec["batch"],
        "loss_first": losses[0], "loss_last": losses[-1],
        "topic_acc": rec["probe"]["topic"], "pair_acc": rec["probe"]["pair"],
        "roundtrip_cosine": rec["roundtrip_cosine"],
        "ms_per_step": rec["ms_per_step"], "ms_clock": rec["ms_clock"],
        "train_s": rec["train_s"],
        "peak_gib": ((torch.cuda.max_memory_allocated() - base) / 2**30
                     if on_card else None),
    }
    out_rec.update(train_step_profile(rec["params"], rec["cfg"],
                                      rec["ms_per_step"], rec["batch"],
                                      device))
    log(f"train default {out_rec}")
    return out_rec


def train_card_vs_cpu(device="cuda", widths=((96, 2, 4), (384, 6, 12)),
                      batch=96, steps=3, step_batch=32):
    """At the default width and at jax-minilm's width and depth (f32),
    from the same parameters on the card and on the CPU: one batch's loss
    and gradients, with the CPU parity test's limits (loss relative 1e-5,
    each leaf within 1e-4 of its largest magnitude, the key biases' zero
    gradient below 1e-6 of the largest); then ``steps`` Adam steps, the
    losses within relative 1e-5 and the parameters' spread in units of
    lr held to the card-only test's limits: 99.9% within 2e-3 lr and
    99.99% within 0.05 lr. The largest is recorded, not bounded: Adam
    turns rounding noise in a gradient below its eps into an update of
    up to lr, so a few parameters may part by a good part of lr. The CPU
    is held to the reference at both (tests/test_torch_train_encoder.py,
    tests/test_torch_train_minilm.py), so the card is too."""
    import torch

    from orama_core_tpu_torch.models import encoder as enc
    from orama_core_tpu_torch.models import train_encoder as te

    vocab = te.build_vocab()
    rows = []
    for hidden, layers, heads in widths:
        cfg = te.train_config(len(vocab), hidden=hidden, layers=layers,
                              heads=heads)
        start = enc.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
        data = [x.numpy() for x in te.sample_batch(
            np.random.default_rng(7), te.TrainTokenizer(vocab), batch, "cpu")]
        cpu_loss, cpu_grads = te.loss_and_grads(start, cfg, data, "cpu")
        loss, grads = te.loss_and_grads(start, cfg, data, device)
        err = te.gradient_error(grads, cpu_grads)
        rel = abs(loss - cpu_loss) / abs(cpu_loss)
        require(rel <= 1e-5 and err["leaf"] <= 1e-4
                and err["key_bias"] <= 1e-6,
                f"train: card against CPU at {hidden}: loss {loss} vs "
                f"{cpu_loss}, {err}")
        cpu, cpu_losses = te.train(cfg, steps, step_batch, seed=1,
                                   device="cpu", params=start)
        card, losses = te.train(cfg, steps, step_batch, seed=1,
                                device=device, params=start)
        diff = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                          for a, b in zip(te.leaves(card), te.leaves(cpu))])
        diff = diff.numpy() / te.LR
        loss_err = float(np.max(np.abs(np.subtract(losses, cpu_losses))
                                / np.abs(cpu_losses)))
        q999, q9999 = (float(q) for q in np.quantile(diff, [0.999, 0.9999]))
        require(loss_err <= 1e-5 and q999 <= 2e-3 and q9999 <= 0.05,
                f"train: {steps} Adam steps at {hidden}: losses {losses} vs "
                f"{cpu_losses}, parameters {q999} / {q9999} lr")
        rows.append({"hidden": hidden, "layers": layers, "heads": heads,
                     "loss": loss,
                     "cpu_loss": cpu_loss, "loss_rel_err": rel,
                     "grad_leaf_rel_err": err["leaf"],
                     "key_bias_grad": err["key_bias"], "leaves": len(grads),
                     "adam_steps": steps, "adam_loss_rel_err": loss_err,
                     "param_max_lr": float(diff.max()),
                     "param_q999_lr": q999, "param_q9999_lr": q9999,
                     "params_over_005_lr": int((diff > 0.05).sum()),
                     "params": int(diff.size)})
        log(f"train card vs cpu {rows[-1]}")
    return rows


def train_step_work(cfg, batch, tokens):
    """(f32 FLOPs of one step's two encoder forwards and the logits,
    3 x that for a step with its backward)."""
    h, m, layers = cfg.hidden, cfg.mlp, cfg.layers
    rows = 2 * batch                                # the A and B sides
    dense = 2.0 * rows * tokens * (4 * h * h + 2 * h * m) * layers
    attn = 4.0 * rows * tokens * tokens * h * layers
    fwd = dense + attn + 2.0 * batch * batch * cfg.out_dim
    return fwd, 3.0 * fwd


def train_step_profile(params, cfg, ms, batch=96, device="cuda", steps=5):
    """A training step of ``cfg`` at ``batch`` pairs, taking ``ms`` a step
    (measured over a run): the host's share, unprofiled (sampling the
    batch, of it ``sample_ms``, and enqueueing the step, no sync inside)
    over ``steps`` more steps, the device's busy ms and work items from
    torch.profiler over as many more, and the bound: 3 x the forward's
    f32 FLOPs / 67 TFLOP/s (TF32 off). The steps update ``params``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orama_core_tpu_torch.models import train_encoder as te

    opt = te.make_optimizer(params)
    rng = np.random.default_rng(1)
    tok = te.TrainTokenizer(te.build_vocab())
    te.train_step(params, cfg, opt, te.sample_batch(rng, tok, batch, device))
    _sync(device)
    host_s = sample_s = 0.0
    for _ in range(steps):
        h0 = time.perf_counter()
        data = te.sample_batch(rng, tok, batch, device)
        sample_s += time.perf_counter() - h0
        te.train_step(params, cfg, opt, data)
        host_s += time.perf_counter() - h0
    _sync(device)
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        for _ in range(steps):
            te.train_step(params, cfg, opt,
                          te.sample_batch(rng, tok, batch, device))
        _sync(device)
    items = sum(1 for e in prof.events()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
    busy_us = sum(_device_us(e) for e in prof.key_averages())
    fwd, step_flops = train_step_work(cfg, batch, te.MAX_TOKENS)
    bound = step_flops / F32_FLOPS * 1e3
    return {"host_ms_per_step": host_s * 1e3 / steps,
            "sample_ms_per_step": sample_s * 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "work_items_per_step": items / steps,
            "fwd_gflop": fwd / 1e9, "step_gflop": step_flops / 1e9,
            "bound_ms": bound, "share": bound / ms}


def train_minilm(device="cuda", steps=TRAIN_MINILM_STEPS, batch=96):
    """The trainer at jax-minilm's width (hidden 384, 6 layers, 12 heads,
    MLP 1,536; the script's vocabulary, 64 positions, f32) for ``steps``
    steps of batch 96 through ``train_encoder.train``; ms a step (CUDA
    events around the run), peak GiB above what was allocated before, and
    ``train_step_profile``'s host and device shares against the bound.

    No learning is checked at this width: at lr 2e-3 (tuned for the small
    model) the reference's own step collapses the encoder to uniform
    logits within two steps, and the port's follows it step for step
    (tests/test_torch_train_minilm.py, on the CPU). So the run must show
    that trajectory: a falling loss whose last 20 steps' mean lies within
    1e-3 of ``chance_loss`` (ln of the batch, the loss of uniform logits).
    A trainer that does not step stays at its initial loss, above that.
    The probe accuracy is recorded, not gated."""
    import torch

    from orama_core_tpu_torch.models import encoder as enc
    from orama_core_tpu_torch.models import train_encoder as te

    vocab = te.build_vocab()
    cfg = te.train_config(len(vocab), hidden=enc.MINILM.hidden,
                          layers=enc.MINILM.layers, heads=enc.MINILM.heads)
    require(cfg.mlp == enc.MINILM.mlp, f"train minilm: MLP {cfg.mlp}")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    params, losses = te.train(cfg, steps, batch, seed=0, device=device)
    wall_s = time.perf_counter() - t0
    if on_card:
        ev[1].record()
        ev[1].synchronize()
        ms = ev[0].elapsed_time(ev[1]) / steps
    else:
        ms = wall_s * 1e3 / steps
    chance = float(np.log(batch))
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    require(all(np.isfinite(losses)) and losses[0] > last
            and abs(last - chance) <= 1e-3,
            f"train minilm: loss {losses[0]} -> last 20 {last}, not the "
            f"reference's collapse to {chance}")
    peak = ((torch.cuda.max_memory_allocated() - base) / 2**30
            if on_card else None)
    probe = te.topic_probe(params, cfg)
    rec = {
        "hidden": cfg.hidden, "layers": cfg.layers, "heads": cfg.heads,
        "mlp": cfg.mlp, "batch": batch, "tokens": te.MAX_TOKENS,
        "steps": steps, "loss_first": losses[0], "loss_last": losses[-1],
        "loss_first20": float(first), "loss_last20": float(last),
        "chance_loss": chance, "ms_per_step": ms,
        **train_step_profile(params, cfg, ms, batch, device),
        "peak_gib": peak, "topic_acc": probe["topic"],
        "pair_acc": probe["pair"],
    }
    log(f"train minilm {rec}")
    return rec


# the kernels of the probe's path: name -> (ops module, wrapper, plain twin)
PROBE_TWINS = {
    "bm25_scan": ("bm25", "bm25_scores_blocked_aligned",
                  "bm25_scores_blocked_aligned_plain"),
    "knn_subblock_max": ("knn", "subblock_max", "subblock_max_plain"),
    "knn_rescore": ("knn", "rescore_subblocks", "rescore_subblocks_plain"),
    "phrase_counts": ("bm25", "phrase_counts", "phrase_counts_plain"),
}


class KeptCalls:
    """While ``on``, each PROBE_TWINS wrapper keeps a copy of the
    arguments and of the result of its first ``keep`` calls in each
    ``mode`` (set by the caller): (kernel, mode) -> [(args, kwargs, out)].
    The wrappers launch and count as they would; ``restore`` puts them
    back."""

    def __init__(self, keep=8):
        import torch

        from orama_core_tpu_torch.ops import bm25, knn

        self.keep, self.mode, self.kept, self._saved = keep, None, {}, []
        mods = {"bm25": bm25, "knn": knn}

        def copy(x):
            if isinstance(x, tuple):
                return tuple(copy(v) for v in x)
            return x.clone() if torch.is_tensor(x) else x

        for name, (mod, fn, _plain) in PROBE_TWINS.items():
            orig = getattr(mods[mod], fn)

            def kept_call(*a, _orig=orig, _name=name, **kw):
                calls = self.kept.setdefault((_name, self.mode), [])
                if len(calls) >= self.keep:
                    return _orig(*a, **kw)
                a0, kw0 = copy(a), {k: copy(v) for k, v in kw.items()}
                out = _orig(*a, **kw)
                calls.append((a0, kw0, copy(out)))
                return out

            self._saved.append((mods[mod], fn, orig))
            setattr(mods[mod], fn, kept_call)

    def restore(self):
        for mod, fn, orig in self._saved:
            setattr(mod, fn, orig)

    def check(self):
        """Every kept result against the plain twin on the same arguments
        (on the card): K1 within rtol 1e-5 / atol 1e-6 (sums in another
        order), K2 as ``check_k2`` holds it, K3 within 1e-4, K4 exact.
        Returns kernel -> {"calls", "max_abs_err"}."""
        import torch

        from orama_core_tpu_torch.ops import bm25, knn

        mods = {"bm25": bm25, "knn": knn}
        out = {}
        for (name, mode), calls in sorted(self.kept.items()):
            plain = getattr(mods[PROBE_TWINS[name][0]], PROBE_TWINS[name][2])
            rec = out.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
            for a, kw, got in calls:
                what = f"engine probe {mode}: {name} on the probe's inputs"
                if name == "knn_subblock_max":
                    vecs, qd, sub, n_valid = a
                    err, _ = check_k2(vecs, qd, n_valid, sub, got=got)
                elif name == "phrase_counts":
                    want = plain(*a, **kw)
                    require(all(torch.equal(g, w) for g, w in zip(got, want)),
                            f"{what}: counts differ from the plain version")
                    err = 0.0
                else:
                    want = plain(*a, **kw)
                    err = (got - want).abs().max().item() if got.numel() else 0.0
                    ok = (torch.allclose(got, want, rtol=1e-5, atol=1e-6)
                          if name == "bm25_scan" else err <= 1e-4)
                    require(ok, f"{what}: max err {err}")
                rec["calls"] += 1
                rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
        for name in PROBE_TWINS:
            require(out.get(name, {}).get("calls"),
                    f"engine probe: no {name} call was kept")
        return out


def check_rrf_hits(got, parts, rtol, what):
    """``got``, the top hits of an RRF fusion (score 1 / (61 + rank) summed
    over the parts a doc scores in), against ``parts``, every hit of each
    component as the plain version gives it, where scores within ``rtol``
    of each other may rank in either order: each hit's score lies between
    the least and the most its ranks allow, and no doc left out is sure
    to beat the last hit."""
    lo, hi = {}, {}
    for hits in parts:
        ids = [d for d, sc in hits if sc > 0]
        s = np.asarray([sc for _, sc in hits if sc > 0], np.float64)
        asc = np.sort(s)
        best = len(s) - np.searchsorted(asc, s * (1 + rtol), side="right")
        worst = len(s) - np.searchsorted(asc, s * (1 - rtol), side="left") - 1
        for d, b, w in zip(ids, best, worst):
            lo[d] = lo.get(d, 0.0) + 1.0 / (61 + w)
            hi[d] = hi.get(d, 0.0) + 1.0 / (61 + b)
    for d, sc in got:
        require(d in lo and lo[d] * (1 - 1e-6) <= sc <= hi[d] * (1 + 1e-6),
                f"{what}: doc {d} fused {sc}, its ranks allow "
                f"[{lo.get(d)}, {hi.get(d)}]")
    kept = {d for d, _ in got}
    last = got[-1][1] if got else 0.0
    sure = [d for d in lo if d not in kept and lo[d] > last * (1 + 1e-6)]
    require(not sure, f"{what}: {sure[:3]} must rank above the last hit")


class _Replay:
    """An embedder that returns, for each text, the row another embedder
    gave it (so a second engine indexes and queries the same vectors)."""

    def __init__(self, rows):
        self.rows = rows

    def embed(self, texts):
        return np.stack([self.rows[t] for t in texts])


def _probe_engine(work, ckpt, device, docs):
    """``build_orama`` on ``device`` with ``ai.embedding_checkpoint_path``
    at ``ckpt`` (as tests/test_torch_semantic.py configures it), and the
    ``topics`` collection made; ``docs`` are written, embedded and
    committed by ``_probe_ingest``."""
    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig

    shutil.rmtree(work, ignore_errors=True)
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = os.path.join(work, "w")
    cfg.reader_side.data_dir = os.path.join(work, "r")
    cfg.ai.backend = "jax"
    cfg.ai.embedding_model = "bge-small"
    cfg.writer_side.default_embedding_model = "bge-small"
    cfg.ai.embedding_checkpoint_path = ckpt
    return build_orama(cfg, start_background=False, device=device)


def _probe_ingest(e, docs):
    e.write_side.create_collection("master", "topics", "rk", "wk")
    e.flush()
    for i in range(0, len(docs), 512):
        e.write_side.write("topics", docs[i:i + 512], "wk")
    e.flush()
    e.commit()


def _probe_search(e, term, mode, limit):
    from orama_core_tpu_torch.types import SearchParams

    r = e.read_side.search("topics", SearchParams.from_json(
        {"term": term, "mode": mode, "limit": limit}), "rk")
    return [(h.id, h.score) for h in r.hits], r.count


PROBE_MODES = {"vector": "vector", "hybrid": "hybrid", "phrase": "fulltext"}


def engine_probe(ckpt, device="cuda", n_docs=ENGINE_PROBE_DOCS,
                 n_queries=ENGINE_PROBE_QUERIES, seed=ENGINE_PROBE_SEED,
                 limit=10):
    """The slice's main path: ``build_orama`` with
    ``ai.embedding_checkpoint_path`` at the port-trained checkpoint,
    ``n_docs`` held-out B passages of ``gen_pairs`` ingested, embedded and
    committed on ``device``, then the first ``n_queries`` pairs' A sides
    (their query prefix cut: the engine adds bge-small's own) as vector,
    hybrid RRF and phrase (full-text, every word of the A side) queries
    for the top ``limit``. Topic accuracy@1 (the top hit's topic is the
    query's) is at least 0.85 in each mode, with K1, K2, K3 and K4
    launched. A query's own pair shares no topic word with it, so full
    text finds the topic through the other passages of it.

    Held to the plain versions twice, on the card:
      * each kernel's first 8 calls in each mode (``KeptCalls``) against
        its plain twin on the same arguments;
      * every query against a CPU engine (the plain twins throughout) that
        indexed and queried the rows the card's encoder gave (so only the
        search differs): ``check_hits`` at 1e-4, counts equal (vector and
        hybrid within 2: a similarity within rounding of zero may change
        sign). RRF fuses ranks over the whole corpus, so where two docs of
        a component tie within rounding, anywhere in its list, the card's
        order and the CPU's may differ, and with them the fused scores: a
        hybrid query whose hits differ is held by ``check_rrf_hits`` to
        the CPU engine's full fulltext and vector lists instead.
    Returns (record, launches)."""
    import torch

    from orama_core_tpu_torch.models import train_encoder as te
    from orama_core_tpu_torch.models.encoder import EncoderEmbedder
    from orama_core_tpu_torch.ops import _cuda

    a_rows, b_rows, topics = te.gen_pairs(np.random.default_rng(seed),
                                          te.TOPIC_WORDS, n_docs)
    docs = [{"id": str(i), "body": b} for i, b in enumerate(b_rows)]
    queries = [a[len(te.QUERY_PREFIX):] for a in a_rows[:n_queries]]
    work = os.path.join(TRAIN_DIR, "engine")
    e = _probe_engine(os.path.join(work, "card"), ckpt, device, docs)
    cpu = kept = None
    try:
        emb = e.ai._embedder("bge-small")
        require(isinstance(emb, EncoderEmbedder)
                and emb.device == torch.device(device),
                f"engine probe: the trained checkpoint did not load ({emb!r})")
        rows, embed = {}, emb.embed

        def embed_kept(texts):
            out = embed(texts)
            rows.update(zip(texts, out))
            return out

        emb.embed = embed_kept
        t0 = time.perf_counter()
        _probe_ingest(e, docs)
        _sync(device)
        ingest_s = time.perf_counter() - t0
        vf = next(iter(e.read_side._reader("topics")._vector.values()))
        require(vf.committed.n_vectors == n_docs,
                f"engine probe: {vf.committed.n_vectors} vector rows")
        rec = {"docs": n_docs, "queries": n_queries, "limit": limit,
               "ingest_s": ingest_s}
        got = {}
        kept = KeptCalls()
        _cuda.reset_launches()
        for name, mode in PROBE_MODES.items():
            kept.mode = name
            got[name], lat = [], []
            for q in queries:
                t1 = time.perf_counter()
                got[name].append(_probe_search(e, q, mode, limit))
                lat.append((time.perf_counter() - t1) * 1e3)
            top = np.asarray([int(h[0][0]) if h else -1
                              for h, _n in got[name]])
            rec[name] = {
                "topic_acc": float(np.mean((top >= 0) & (
                    topics[np.maximum(top, 0)] == topics[:n_queries]))),
                "pair_acc": float(np.mean(top == np.arange(n_queries))),
                "p50_ms": float(np.percentile(lat, 50)),
            }
        launches = dict(_cuda.LAUNCHES)
        rec["launches"] = dict(launches)
        kept.restore()
        rec["kernels_vs_plain"] = kept.check()
        # the same collection on the CPU from the card's encoder rows
        t0 = time.perf_counter()
        cpu = _probe_engine(os.path.join(work, "cpu"), ckpt, "cpu", docs)
        cpu.ai._embedders["bge-small"] = _Replay(rows)
        _probe_ingest(cpu, docs)
        tie_reordered = 0
        for name, mode in PROBE_MODES.items():
            for q, (hits, n) in zip(queries, got[name]):
                want, want_n = _probe_search(cpu, q, mode, limit)
                what = f"engine probe {name} {q!r} vs CPU"
                require(abs(n - want_n) <= (0 if name == "phrase" else 2),
                        f"{what}: count {n} vs {want_n}")
                try:
                    check_hits(hits, want, 1e-4, what)
                except SmokeFailure:
                    if name != "hybrid":
                        raise
                    check_rrf_hits(hits, [
                        _probe_search(cpu, q, part, n_docs)[0]
                        for part in ("fulltext", "vector")], 1e-4, what)
                    tie_reordered += 1
        rec["vs_cpu"] = {"queries": 3 * n_queries,
                         "hybrid_tie_reordered": tie_reordered,
                         "s": time.perf_counter() - t0}
    finally:
        if kept is not None:
            kept.restore()
        e.close()
        if cpu is not None:
            cpu.close()
        shutil.rmtree(work, ignore_errors=True)
    for name in PROBE_MODES:
        require(rec[name]["topic_acc"] >= 0.85,
                f"engine probe: {name} topic accuracy {rec[name]['topic_acc']}")
    if torch.device(device).type == "cuda":
        for k in PROBE_TWINS:
            require(launches[k] > 0, f"engine probe: {k} was never launched")
    log(f"train engine probe {rec}")
    return rec, launches


def train_tools(ckpt):
    """The two tools on the card. ``warm_cache`` runs as its own process
    after the kernel libraries are deleted, so it must build all eight;
    then, in this process with the libraries unloaded, the first query of
    a fresh engine loads them as built (no library is rebuilt: their
    files keep their times) and launches K1 and K4. ``prepare_checkpoint``
    validates the port-trained directory with a smoke forward on the card."""
    import contextlib
    import io

    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.tools import prepare_checkpoint
    from orama_core_tpu_torch.types import SearchParams

    names = list(_cuda.SIGNATURES)
    for n in names:
        lib = os.path.join(_cuda.BUILD, f"lib{n}.so")
        if os.path.exists(lib):
            os.remove(lib)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "orama_core_tpu_torch.tools.warm_cache",
         "--docs", "2000"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    require(out.returncode == 0, f"warm_cache failed:\n{out.stderr[-3000:]}")
    warm = json.loads(out.stdout.strip().splitlines()[-1])
    require(sorted(warm["kernels_built"]) == sorted(names)
            and warm["caches"] >= 1, f"warm_cache: {warm}")
    mtimes = {n: os.path.getmtime(os.path.join(_cuda.BUILD, f"lib{n}.so"))
              for n in names}
    with _cuda._lock:
        _cuda._libs.clear()
    work = os.path.join(TRAIN_DIR, "warm_query")
    shutil.rmtree(work, ignore_errors=True)
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = os.path.join(work, "w")
    cfg.reader_side.data_dir = os.path.join(work, "r")
    e = build_orama(cfg, start_background=False, device="cuda")
    try:
        e.write_side.create_collection("master", "c", "rk", "wk")
        e.write_side.write("c", [
            {"id": str(i), "body": f"warm document {i} alpha beta gamma"}
            for i in range(64)], "wk")
        e.flush()
        e.commit()
        _cuda.reset_launches()
        t1 = time.perf_counter()
        r = e.read_side.search("c", SearchParams.from_json(
            {"term": "alpha beta"}), "rk")
        first_query_ms = (time.perf_counter() - t1) * 1e3
        first = dict(_cuda.LAUNCHES)
    finally:
        e.close()
        shutil.rmtree(work, ignore_errors=True)
    rebuilt = [n for n in names if os.path.getmtime(
        os.path.join(_cuda.BUILD, f"lib{n}.so")) != mtimes[n]]
    require(r.count == 64 and first["bm25_scan"] > 0
            and first["phrase_counts"] > 0 and not rebuilt
            and all(_cuda._fresh(n) for n in names),
            f"first query after warm_cache: count {r.count}, launches "
            f"{first}, rebuilt {rebuilt}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = prepare_checkpoint.main([ckpt])
    text = buf.getvalue()
    require(rc == 0 and "smoke forward ok: embedding (1, 96)" in text,
            f"prepare_checkpoint:\n{text}")
    rec = {"warm_cache": {k: warm[k] for k in (
               "kernels_built", "caches", "build_s", "warm_s", "seconds")},
           "warm_cache_wall_s": wall_s, "first_query_ms": first_query_ms,
           "first_query_launches": first, "rebuilt": rebuilt,
           "prepare_checkpoint": text.strip().splitlines()[:3]}
    log(f"train tools {rec}")
    return rec, first


def phase_train(card):
    """This slice's phase: the encoder trained on the card at the script's
    defaults and at jax-minilm's width, the card's gradients against the
    CPU's, the engine served from the port-trained checkpoint (the main
    path: K1-K4 launched), and the warm_cache and prepare_checkpoint
    tools. Returns the ``{"train": ...}`` record and the phase's kernel
    launches."""
    t0 = time.perf_counter()
    ckpt = os.path.join(TRAIN_DIR, "tiny-semantic")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    rec = {"default": train_default(ckpt)}
    rec["card_vs_cpu"] = train_card_vs_cpu()
    rec["minilm"] = train_minilm()
    rec["engine"], launches = engine_probe(ckpt)
    rec["tools"], tool_launches = train_tools(ckpt)
    for k, v in tool_launches.items():
        launches[k] += v
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    rec["wall_s"] = time.perf_counter() - t0
    return rec, launches


# the tune phase's kernels: the probe row whose times (the kernel's, its
# plain version's and the library call's) the kernel's record carries
TUNE_RECORDS = {
    "knn_max_only": "phase1",
    "knn_max_only_edge": "masklast",
    "knn_max_only_qt": "qt",
    "knn_phase1_rows": "mm",
    "bm25_scan_wide": "pl4_4096",
    "bm25_scan_packed": "plp_4096",
    "knn_rescore_b2": "prescore",
}


def _max_err(got, want, atol: float, what: str) -> float:
    """Max abs error of ``got``; fails beyond ``atol``."""
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    require(err <= atol, f"{what} disagrees: max err {err} > {atol}")
    return err


def tune_checks(inp, data):
    """Every probe form at the probes' full shapes against its plain
    version (f32 sums of the same bf16 products in another order): B1's
    max forms and k_mm's rows within 1e-5 (unit-norm rows; sub 32, 64
    and 128; masked everywhere, at the edge, and from qt), B2's K3 on
    qt.T within 1e-4, the scans within rtol 1e-5, atol 1e-6 (adds in any
    order; four planes and packed at 1,024, 4,096 and 8,192; the
    four-plane form at 1,024 also against K1). k_mm's library yardstick,
    which rounds to bf16, must agree within 1% of the largest product;
    its f32-out form, where this torch has it, within 1e-5. Returns the
    errors by row."""
    import torch

    from orama_core_tpu_torch.ops import bm25, knn
    from orama_core_tpu_torch.tools import bm25_scan_bench, knn_tune_bench

    v, q, qt, nv = inp["vecs"], inp["queries"], inp["qt"], inp["n_valid"]
    errs = {}
    for sub in knn.PROBE_SUBS:
        want = knn.subblock_max_only_plain(v, q, sub, nv)
        forms = {"phase1" if sub == 32 else f"sub{sub}":
                 knn.subblock_max_only(v, q, sub, nv)}
        if sub == knn_tune_bench.SUB:
            forms["masklast"] = knn.subblock_max_only(v, q, sub, nv,
                                                      mask="edge")
            forms["qt"] = knn.subblock_max_only_qt(v, qt, sub, nv)
        for name, got in forms.items():
            _sync(v.device)
            errs[name] = _max_err(got, want, 1e-5, f"B1 {name}")
        del want, forms
    bn, sub = knn_tune_bench.BN, knn_tune_bench.SUB
    got = knn.phase1_rows(v, q, bn, sub)
    want = knn.phase1_rows_plain(v, q, bn, sub)
    _sync(v.device)
    require(got.shape == (v.shape[0] // sub, q.shape[0]),
            f"B1 k_mm: shape {got.shape}")
    errs["mm"] = _max_err(got, want, 1e-5, "B1 k_mm")
    lib = knn_tune_bench.mm_library(v, q).reshape(want.shape).float()
    errs["mm_library"] = _max_err(lib, want, 1e-2 * want.abs().max().item(),
                                  "k_mm's library call")
    try:
        lib = knn_tune_bench.mm_library_f32(v, q).reshape(want.shape)
    except (TypeError, RuntimeError, NotImplementedError):
        lib = None  # this torch's bmm has no out_dtype
    if lib is not None:
        errs["mm_library_f32"] = _max_err(lib, want, 1e-5,
                                          "k_mm's f32 library call")
    ids = knn_tune_bench.b2_selection(inp)
    qtt = qt.T.contiguous()
    require(ids.numel() == q.shape[0] * knn_tune_bench.K, "B2's selection")
    got = knn.rescore_subblocks(v, qtt, ids, knn_tune_bench.K, sub)
    want = knn.rescore_subblocks_plain(v, qtt, ids, knn_tune_bench.K, sub)
    _sync(v.device)
    errs["prescore"] = _max_err(got, want, 1e-4, "B2 (K3 on qt.T)")
    del got, want, lib

    dev = v.device
    planes = [torch.as_tensor(data[k], device=dev) for k in
              ("post_docs", "post_tf", "post_ni", "post_lens")]
    packed = torch.as_tensor(data["packed"], device=dev)
    scal = (float(data["boost"]), float(data["avgdl"]), float(data["nfd"]))
    n_docs = data["n_docs"]
    for blk in bm25.SCAN_BLOCKS:
        bi, lo, hi, ni_b = bm25_scan_bench.plans(data, blk)
        plan = [torch.as_tensor(a, device=dev) for a in (bi, lo, hi)]
        ni_i32 = torch.as_tensor(ni_b.astype(np.int32), device=dev)
        wide = bm25.bm25_scan_wide(*planes, *plan, *scal, n_docs, blk)
        pairs = {
            f"pl4_{blk}": (
                wide, bm25.bm25_scan_wide_plain(*planes, *plan, *scal,
                                                n_docs, blk)),
            f"plp_{blk}": (
                bm25.bm25_scan_packed(planes[0], packed, *plan, ni_i32,
                                      *scal, n_docs, blk),
                bm25.bm25_scan_packed_plain(planes[0], packed, *plan, ni_i32,
                                            *scal, n_docs, blk)),
        }
        if blk == bm25.BLOCK:
            pairs["pl4_vs_k1"] = (wide, bm25.bm25_scores_blocked_aligned(
                *planes, *plan, *scal, n_docs, len(bi)))
        for name, (got, want) in pairs.items():
            _sync(v.device)
            errs[name] = (got - want).abs().max().item()
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                    f"B3 {name} disagrees: max err {errs[name]}")
            require(int((got > 0).sum()) > n_docs // 2, f"B3 {name} scored "
                    "too few docs")
    return errs


def tune_shuffled(data):
    """One four-plane B3 call at plan blocks of 4,096 on the bench's data
    with the first plan window's doc ids shuffled (they span two doc
    tiles): the doc-tile check must fail, the kernel repair the call (the
    count rises by exactly one) and the scores match the plain version
    (rtol 1e-5, atol 1e-6). Returns the max abs error."""
    import torch

    from orama_core_tpu_torch.ops import bm25
    from orama_core_tpu_torch.tools import bm25_scan_bench

    blk = 4096
    bi, lo, hi, _ = bm25_scan_bench.plans(data, blk)
    docs = data["post_docs"].copy()
    a, b = int(bi[0]) * blk + int(lo[0]), int(bi[0]) * blk + int(hi[0])
    require(docs[b - 1] >= bm25.SCAN_TILE_DOCS, "B3's first window must "
            "span two doc tiles")
    np.random.default_rng(5).shuffle(docs[a:b])
    planes = [torch.as_tensor(x, device="cuda") for x in (
        docs, data["post_tf"], data["post_ni"], data["post_lens"])]
    plan = [torch.as_tensor(x, device="cuda") for x in (bi, lo, hi)]
    scal = (float(data["boost"]), float(data["avgdl"]), float(data["nfd"]))
    n_docs = data["n_docs"]
    before = bm25.scan_repairs()
    got = bm25.bm25_scan_wide(*planes, *plan, *scal, n_docs, blk)
    want = bm25.bm25_scan_wide_plain(*planes, *plan, *scal, n_docs, blk)
    _sync("cuda")
    repaired = bm25.scan_repairs() - before
    require(repaired == 1, f"B3 on a shuffled window: {repaired} repairs, "
            "expected 1")
    err = (got - want).abs().max().item()
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
            f"B3 on a shuffled window disagrees: max err {err}")
    return err


def phase_tune():
    """This slice's phase: the kernel probes of benchmarks/ on their full
    shapes. The main path is the two probe tools, every row
    (``tools/knn_tune_bench.run``: B1's forms, K2 beside k_mm, B2 through
    K3, the end-to-end rows; ``tools/bm25_scan_bench.run``: K1, its
    four-plane and packed forms, each held to the numpy oracle first),
    with the launch counts reset before and read after; then every form
    against its plain version (``tune_checks``, launches not counted),
    B3's repair count unchanged over all of that, and one B3 call on a
    shuffled window (``tune_shuffled``), repaired.
    k_mm reads its kept rows and writes their products, so it must take at
    least the time those bytes take (``_rows_work``): a faster time would
    mean skipped rows.
    Returns the ``{"tune": ...}`` record, the kernel records of the new
    forms and of B2, and the phase's launches."""
    import torch

    from orama_core_tpu_torch.ops import _cuda, bm25
    from orama_core_tpu_torch.tools import bm25_scan_bench, knn_tune_bench

    t0 = time.perf_counter()
    inp = knn_tune_bench.make_inputs()
    data = bm25_scan_bench.zipf_postings()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    repairs = bm25.scan_repairs()
    _cuda.reset_launches()
    knn_out = knn_tune_bench.run(inp, iters=20)
    bm25_out = bm25_scan_bench.run(data, "cuda", iters=40)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    require(bm25_out["repairs"] == 0, f"B3 repaired {bm25_out['repairs']} "
            "calls on the bench's ascending windows")
    # B2 is K3 at B2's shape: the prescore row's K3 launches are B2's, and
    # K3's own record keeps the end-to-end rows' (other sub-blocks, shapes)
    b2 = knn_out["results"]["prescore"]["launches"].get("knn_rescore", 0)
    launches["knn_rescore_b2"] = b2
    launches["knn_rescore"] -= b2
    for name in (*TUNE_RECORDS, "bm25_scan", "knn_subblock_max"):
        require(launches[name] > 0, f"the probes never launched {name}")
    mm = knn_out["results"]["mm"]
    kept_bytes, _ = knn_tune_bench._rows_work(inp["vecs"].shape[0],
                                              inp["queries"].shape[0])
    kept_ms = kept_bytes / HBM_BYTES_PER_S * 1e3
    require(mm["ms"] >= kept_ms, f"k_mm took {mm['ms']} ms, under its kept "
            f"rows' and products' bytes time {kept_ms} ms: rows were skipped")
    errs = tune_checks(inp, data)
    require(bm25.scan_repairs() == repairs, "B3 repaired a call on the "
            "bench's ascending windows")
    errs["pl4_shuffled"] = tune_shuffled(data)
    rows = {**knn_out["results"], **bm25_out["results"]}
    records = []
    for name, row in TUNE_RECORDS.items():
        r = rows[row]
        src, rep = TPU_KERNELS[name]
        err = (max(errs["phase1"], errs["sub64"], errs["sub128"])
               if name == "knn_max_only" else
               max(errs["pl4_1024"], errs["pl4_4096"], errs["pl4_8192"])
               if name == "bm25_scan_wide" else
               max(errs["plp_1024"], errs["plp_4096"], errs["plp_8192"])
               if name == "bm25_scan_packed" else errs[row])
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": float(err), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    del inp, data
    torch.cuda.empty_cache()
    rec = {"knn_tune": knn_out, "bm25_scan": bm25_out, "max_err": errs,
           "mm_kept_bytes_ms": kept_ms,
           "launches": {k: v for k, v in launches.items() if v},
           "setup_s": setup_s, "wall_s": time.perf_counter() - t0}
    log(f"tune ok: {rec['launches']}, {rec['wall_s']:.1f} s")
    return rec, records, launches


# -- the entry phase: the port's bench, graft entry, start() and tools ----------

# tool: (its metric name, or for engine_bench its first report key; the
# least recall@10 it must reach; the kernels its path must launch). Each
# runs at its defaults: the published widths and depths (pq_100m 100M
# rows, engine_bench 100k documents, the sharded tools 200k rows).
# embed_bench's encoder and pq_100m's ADC and rerank run no hand-written
# kernel; nor does sharded_int8, as its script does: its exact engine
# holds two embedding fields (the collection's own and the bench's), so
# its vector queries take the dense path, and its mesh engine scores
# int8 in plain PyTorch. sharded_ivfpq's exact reader takes the fused
# kNN (K2 + K3); its mesh reader's IVF-PQ scores in plain PyTorch.
ENTRY_TOOLS = {
    "embed_bench": ("embeddings_per_sec_bge_small_seq128", None, ()),
    "int8_30m_bench": ("int8_exact_knn_qps_30Mx384_top10_pallas", None,
                       ("knn_subblock_max_int8",)),
    "pq_100m_bench": ("ivf_pq_rerank_qps_100Mx384_top10", 0.7, ()),
    "engine_bench": ("index_docs_per_sec", None,
                     ("bm25_scan", "phrase_counts", "knn_subblock_max",
                      "knn_rescore")),
    "sharded_int8_bench": ("sharded_int8_recall_at_10_200k_8dev", 0.9, ()),
    "sharded_ivfpq_bench": ("sharded_ivfpq_recall_at_10_200k_8dev", 0.95,
                            ("knn_subblock_max", "knn_rescore")),
}
BENCH_RECALL_MIN = 0.95
SPLIT_ITERS = 20
START_DOCS, START_SEED = 2000, 23


def bench_device_split():
    """Where the bench's steps go: CUDA-event ms (behind a spin) of one
    fused kNN call at 64 and 256 queries and of its K2 alone, and of one
    int8 kNN call at 64 queries and of its K5 alone, on the bench's
    corpus and queries (compare with the bench's host-clock ms a call),
    SPLIT_ITERS calls each; the same for one chunk of ``int8_30m_bench``
    (its ``score_chunk`` at its defaults, and K5 alone); and a
    torch.profiler window of each int8 call (device busy share, top
    device ops), which says what sets the call's pace beside K5."""
    import torch

    from orama_core_tpu_torch import bench
    from orama_core_tpu_torch.ops import knn, quant
    from orama_core_tpu_torch.tools import int8_30m_bench as i30
    from orama_core_tpu_torch.utils.benchgen import hashed_unit_corpus

    n, d, iters = bench.N, bench.D, SPLIT_ITERS
    n_pad = -(-n // bench.BN) * bench.BN
    vecs = hashed_unit_corpus(n_pad, d, 1)
    q = np.random.default_rng(7).standard_normal((bench.QB, d)).astype(
        np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q64 = torch.from_numpy(q).cuda()
    q256 = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (bench.QB_BIG, d))).to("cuda", torch.bfloat16)
    out = {}
    for name, qq in (("q64", q64.to(torch.bfloat16)), ("q256", q256)):
        out[name] = {
            "knn_topk_ms": time_ms(lambda: knn.knn_topk(
                vecs, qq, k=bench.K, block_rows=bench.BN, n_valid=n), iters),
            "k2_ms": time_ms(lambda: knn.subblock_max(vecs, qq, 32, n),
                             iters)}
    codes, scales = quant.quantize_int8(vecs.to(torch.float32))
    q8 = quant.quantize_int8(q64)[0]
    def int8_call():
        return knn.knn_topk_int8(codes, scales, q64, k=bench.K,
                                 block_rows=bench.BN, n_valid=n)

    out["int8_q64"] = {
        "knn_topk_int8_ms": time_ms(int8_call, iters),
        "k5_ms": time_ms(lambda: knn.subblock_max_int8(
            codes, scales, q8, 32, n), iters),
        "profile": profile_calls([int8_call] * iters, "calls")}
    del codes, scales
    block = 4096  # the tool's default
    rows, _ = i30.chunk_rows(30_000_000, block)
    c30, s30 = i30.gen_chunk(0, rows, 384, torch.device("cuda"))
    q30 = i30.make_queries(64, 384, torch.device("cuda"))
    best = (torch.full((64, i30.K), float("-inf"), device="cuda"),
            torch.zeros(64, i30.K, dtype=torch.long, device="cuda"))

    def chunk_call():
        return i30.score_chunk(c30, s30, q30, best, rows, 0, "pallas", block)

    q8_30 = quant.quantize_int8(q30)[0]
    out["int8_30m_chunk"] = {
        "score_chunk_ms": time_ms(chunk_call, iters),
        "k5_ms": time_ms(lambda: knn.subblock_max_int8(
            c30, s30, q8_30, 32, rows), iters),
        "profile": profile_calls([chunk_call] * iters, "calls")}
    return out


def start_over_http():
    """``orama_core_tpu_torch.start()`` in its own process on the card (a
    free port, its own data directory, no commit: the documents serve from
    the write window): 2,000 documents inserted over HTTP, then one
    fulltext query held against an in-process engine fed the same writes.
    The process is killed at the end."""
    import socket
    import urllib.request

    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig
    from orama_core_tpu_torch.types import SearchParams

    rng = np.random.default_rng(START_SEED)
    vocab = [f"w{i}" for i in range(400)]
    zipf = 1.0 / np.arange(1, 401) ** 0.8
    zipf /= zipf.sum()
    docs = _short_docs(rng, START_DOCS, vocab, zipf)
    body = {"term": "w3 w17", "limit": 20}
    work = os.path.join(ROOT, "build", "chip_smoke_start")
    shutil.rmtree(work, ignore_errors=True)
    no_commit = {"commit_interval_sec": 3600.0,
                 "insert_batch_commit_size": 10_000_000}
    cfg = OramaxConfig()
    cfg.writer_side.data_dir = os.path.join(work, "in_process", "w")
    cfg.reader_side.data_dir = os.path.join(work, "in_process", "r")
    for side in (cfg.writer_side, cfg.reader_side):
        for k, v in no_commit.items():
            setattr(side, k, v)
    local = build_orama(cfg, start_background=False, device="cuda")
    local.write_side.create_collection("master", "c", "rk", "wk")
    local.flush()
    for lo in range(0, len(docs), 500):
        local.write_side.write("c", docs[lo:lo + 500], "wk")
    local.flush()
    want = local.read_side.search("c", SearchParams.from_json(body), "rk")
    local.close()

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update({"ORAMAX_http__port": str(port),
                "ORAMAX_gpu__device": "cuda",
                "ORAMAX_writer_side__data_dir": os.path.join(work, "w"),
                "ORAMAX_reader_side__data_dir": os.path.join(work, "r")})
    for side in ("writer_side", "reader_side"):
        for k, v in no_commit.items():
            env[f"ORAMAX_{side}__{k}"] = str(v)
    log_path = os.path.join(work, "start.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "from orama_core_tpu_torch import start; start()"],
            cwd=work, env=env, stdout=logf, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.perf_counter() + 240
        while True:
            require(proc.poll() is None, f"start(): the server exited "
                    f"({proc.returncode}); see {log_path}")
            try:
                with urllib.request.urlopen(base + "/health", timeout=5):
                    break
            except OSError:
                require(time.perf_counter() < deadline,
                        "start(): no /health after 240 s")
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        st, res = _http(base, "POST", "/v1/collections/create",
                        {"id": "c", "read_api_key": "rk",
                         "write_api_key": "wk"}, "master")
        require(st == 201, f"start(): create: {st} {res}")
        for lo in range(0, len(docs), 500):
            while True:
                st, res = _http(base, "POST", "/v1/collections/c/insert",
                                docs[lo:lo + 500], "wk")
                if st == 200:
                    break
                require(time.perf_counter() < deadline,
                        f"start(): insert: {st} {res}")
                time.sleep(0.1)
        while True:
            st, res = _http(base, "POST", "/v1/collections/c/search?api-key=rk",
                            body)
            require(st == 200, f"start(): search: {st} {res}")
            if res["count"] == want.count:
                break
            require(time.perf_counter() < deadline,
                    f"start(): {res['count']} of {want.count} hits after 240 s")
            time.sleep(0.1)
        check_hits([(h["id"], h["score"]) for h in res["hits"]],
                   [(h.id, h.score) for h in want.hits], 1e-5,
                   "start() over HTTP vs in process")
        require(len(want.hits) == 20, f"start(): {len(want.hits)} hits")
    finally:
        proc.kill()
        proc.wait(timeout=60)
    shutil.rmtree(work, ignore_errors=True)
    return {"docs": START_DOCS, "count": want.count, "up_s": up_s,
            "wall_s": time.perf_counter() - t0}


def run_tool(name):
    """One tool's ``main`` at its defaults in this process on the card:
    its JSON line, checked, and the kernel launches of its run, which
    must include those its path is meant to use."""
    import contextlib
    import importlib
    import io

    from orama_core_tpu_torch.ops import _cuda

    tool = importlib.import_module(f"orama_core_tpu_torch.tools.{name}")
    key, least, kernels = ENTRY_TOOLS[name]
    buf = io.StringIO()
    t0 = time.perf_counter()
    _cuda.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = tool.main([])
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    require(rc == 0, f"entry: {name} exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    require(len(lines) == 1, f"entry: {name} printed {lines}")
    row = json.loads(lines[0])
    if "metric" in row:
        require(row["metric"] == key, f"entry: {name}: {row['metric']}")
        values = [row["value"]]
    else:
        require(next(iter(row)) == key, f"entry: {name}: {list(row)}")
        values = list(row.values())
    require(all(np.isfinite(v) and v > 0 for v in values),
            f"entry: {name}: {row}")
    if least is not None:
        recall = row.get("recall_at_10", row["value"])
        require(recall >= least, f"entry: {name}: recall {recall} below "
                f"{least}")
    if "cards" in row:
        require(row["cards"] == 1, f"entry: {name}: {row['cards']} cards")
    for kernel in kernels:
        require(launches.get(kernel, 0) > 0,
                f"entry: {name} never launched {kernel}: {launches}")
    return {"line": row, "launches": launches,
            "wall_s": time.perf_counter() - t0}


def phase_entry(card):
    """This slice's phase: the port's bench at full size (its five lines;
    recall@10 against the f32 exact top-k at least 0.95; K2, K3 and K5
    launched), where its steps' time goes, the graft entry's forward and
    dry run on four positions of card 0, ``start()`` over HTTP, and the
    six BASELINE-config tools. Returns the ``{"entry": ...}`` record and
    the phase's kernel launches."""
    import contextlib
    import io

    import torch

    from orama_core_tpu_torch import bench
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.tools import graft_entry

    t0 = time.perf_counter()
    _cuda.reset_launches()
    lines, details = bench.run(bench.parse_args([]))
    launches = dict(_cuda.LAUNCHES)
    require([r["metric"] for r in lines] == [
        "exact_vector_search_qps_1Mx768_top10", "bm25_seq_p50_1m",
        "hybrid_rrf_seq_p50_1m", "bm25_batched_qps_1m",
        "hybrid_batched_qps_1m"], f"entry: bench lines {lines}")
    require(all(np.isfinite(r["value"]) and r["value"] > 0 for r in lines),
            f"entry: bench values {lines}")
    require(details["recall_at_10"] >= BENCH_RECALL_MIN,
            f"entry: bench recall@10 {details['recall_at_10']}")
    for name in ("knn_subblock_max", "knn_rescore", "knn_subblock_max_int8",
                 "bm25_scan"):
        require(launches[name] > 0, f"entry: the bench never ran {name}")
    rec = {"bench": lines, "bench_details": details,
           "bench_launches": {k: v for k, v in launches.items() if v},
           "bench_wall_s": time.perf_counter() - t0}
    rec["bench_device_split"] = bench_device_split()
    log(f"entry: bench {lines}, {details}, {rec['bench_device_split']}")

    t1 = time.perf_counter()
    _cuda.reset_launches()
    fwd, args = graft_entry.entry("cuda")
    emb = fwd(*args)
    require(tuple(emb.shape) == (8, 256) and bool(torch.isfinite(emb).all()),
            f"entry: the forward gave {tuple(emb.shape)}")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        dry = graft_entry.dryrun_multichip(4, "cuda")
    require(dry["cards"] == 1, f"entry: dry run on {dry['cards']} cards")
    rec["graft"] = {"forward": list(emb.shape), "counts": dry["counts"],
                    "ivf_pq_top": dry["ivf_pq_top"],
                    "said": said.getvalue().strip(),
                    "launches": {k: v for k, v in _cuda.LAUNCHES.items()
                                 if v},
                    "wall_s": time.perf_counter() - t1}
    for k, v in _cuda.LAUNCHES.items():
        launches[k] += v
    rec["start"] = start_over_http()
    log(f"entry: start() {rec['start']}")
    rec["tools"] = {}
    for name in ENTRY_TOOLS:
        rec["tools"][name] = run_tool(name)
        for k, v in rec["tools"][name]["launches"].items():
            launches[k] += v
        log(f"entry: {name} {rec['tools'][name]}")
        torch.cuda.empty_cache()
    rec["launches"] = launches
    rec["wall_s"] = time.perf_counter() - t0
    return rec, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's kernels need the card")
        return 2
    from orama_core_tpu_torch import configure_torch
    from orama_core_tpu_torch.ops import _cuda

    configure_torch()
    card = card_line()
    cap = torch.cuda.get_device_capability()
    log(f"device: {card}, capability {cap}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    require(tuple(cap) == (9, 0), f"needs capability (9, 0), got {cap}")
    t0 = time.perf_counter()
    sweep_only = "--sweep-only" in sys.argv[1:]
    if sweep_only:
        _cuda.build_all(force=True)
    else:
        probe_lib = build_kernels_and_probes()
    log(f"built {len(_cuda.SIGNATURES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    if sweep_only:
        rows = phase_q_sweep(*sweep_corpora(), np.random.default_rng(42))
        print(json.dumps({"q_sweep": rows, "card": card}), flush=True)
        print(json.dumps({"entry_split": bench_device_split(), "card": card}),
              flush=True)
        return 0

    t0 = time.perf_counter()
    arrays = synth_arrays()
    mv_arrays = synth_multivec_arrays()
    log(f"data made in {time.perf_counter() - t0:.1f} s")
    collections = {
        "exact": (arrays, "exact"),
        "int8": (arrays, "int8"),
        "chunked": (mv_arrays, "exact"),
    }
    readers = {}
    for name, (arr, index) in collections.items():
        t0 = time.perf_counter()
        before = torch.cuda.memory_allocated()
        reader = make_reader(arr, "cuda", index)
        reader.warmup()
        torch.cuda.synchronize()
        log(f"{name} collection on the card in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{(torch.cuda.memory_allocated() - before) / 2**30:.2f} GiB")
        readers[name] = reader
    rng = np.random.default_rng(42)
    compare_lib = None
    if "--k3-compare" in sys.argv[1:]:
        compare_lib = build_compare_k3(
            sys.argv[sys.argv.index("--k3-compare") + 1])
    records = phase_kernels(readers["exact"], rng, probe_lib, compare_lib)
    records += phase_kernels_int8_mv(readers["int8"], readers["chunked"], rng)
    for rec in records:
        print(json.dumps(rec), flush=True)
    exact = readers["exact"]._vector[1].committed
    chunked = readers["chunked"]._vector[0].committed
    vecs = readers["exact"]._device.vector_arrays(exact)[0]
    mv_vecs, mv_docs, _ = readers["chunked"]._device.vector_arrays(chunked)
    rows = phase_q_sweep(vecs, exact.n_vectors, mv_vecs, mv_docs,
                         chunked.n_vectors, rng)
    del vecs, mv_vecs, mv_docs
    print(json.dumps({"q_sweep": rows, "card": card}), flush=True)
    pairs = {name: (readers[name], make_reader(arr, "cpu", index))
             for name, (arr, index) in collections.items()}
    p50, launches = phase_engine(pairs, rng)
    batch, batch_launches = phase_batch(*pairs["exact"], rng,
                                        profile="--profile" in sys.argv[1:])
    for k, v in batch_launches.items():
        launches[k] += v
    print(json.dumps({"batch": batch, "card": card}), flush=True)
    del pairs
    titled = make_reader(with_title(arrays), "cuda")
    titled.warmup()
    print(json.dumps({"two_fields": phase_two_fields(titled, rng),
                      "card": card}), flush=True)
    del titled
    print(json.dumps({"rrf_ranks": phase_rrf_ranks(
        readers["exact"].capacity, rng), "card": card}), flush=True)
    if "--profile" in sys.argv[1:]:
        phase_profile(readers, rng)
    del readers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ann, ann_launches, ivf_pq, ann_queries = phase_ann(
        arrays, rng, profile="--profile" in sys.argv[1:])
    for k, v in ann_launches.items():
        launches[k] += v
    print(json.dumps({"ann": ann, "wall_s": time.perf_counter() - t0,
                      "card": card}), flush=True)
    mesh, mesh_launches = phase_mesh(arrays, mv_arrays, ivf_pq, ann_queries,
                                     rng, card,
                                     profile="--profile" in sys.argv[1:])
    for k, v in mesh_launches.items():
        launches[k] += v
    del ivf_pq, mv_arrays
    print(json.dumps({"mesh": mesh, "card": card}), flush=True)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        require(rec["launches"] > 0, f"{rec['name']} never ran on the main path")
    del arrays
    for name in BUILD_PASSES:
        phase_build_orama(name)
    batcher = phase_batcher()
    print(json.dumps({"batcher": batcher, "card": card}), flush=True)
    serve, serve_launches = phase_serve(card)
    for rec in records:
        rec["launches"] += serve_launches[rec["name"]]
    print(json.dumps({"serve": serve, "card": card}), flush=True)
    tp, tp_launches = phase_tp(card)
    for rec in records:
        rec["launches"] += tp_launches.get(rec["name"], 0)
    print(json.dumps({"tp": tp, "card": card}), flush=True)
    train, train_launches = phase_train(card)
    for rec in records:
        rec["launches"] += train_launches.get(rec["name"], 0)
    print(json.dumps({"train": train, "card": card}), flush=True)
    tune, tune_records, tune_launches = phase_tune()
    records += tune_records
    for rec in records:
        rec["launches"] += tune_launches.get(rec["name"], 0)
    print(json.dumps({"tune": tune, "card": card}), flush=True)
    entry, entry_launches = phase_entry(card)
    for rec in records:
        rec["launches"] += entry_launches.get(rec["name"], 0)
    print(json.dumps({"entry": entry, "card": card}), flush=True)
    print(json.dumps({"p50_ms": p50, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"chip_smoke FAILED: {e}")
        sys.exit(1)
