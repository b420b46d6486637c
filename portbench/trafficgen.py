"""The one generator of traffic mixes: a mix file's parameters to requests.

A mix (``portbench/traffic/<name>.json``) names its loop (``loop``: a
module of ``portbench/loops/``), the number of clients and of requests
each client cycles through, and one or more request ``kinds``. A kind
has a ``share`` of the pool, a ``body`` (the search request's JSON
fields, copied into every request of the kind: mode, fusion, limit,
filters), the words a request's text has (``words``: ``min``, ``max``,
``mean``; the count is ``min`` plus a binomial draw with that mean), and
the ``comparison`` (a module of ``portbench/comparisons/``) that holds
its replies to the reference. Words are drawn as ``term%06d`` of
(Pareto(``pareto_shape``) x ``scale``) mod ``vocab_terms``, the
reference's Zipf-like draw (``orama_core_tpu_torch/bench.py:draw_terms``,
vectorised).

Every seed sends the same requests: the mix's pool is drawn from the
mix's own ``pool_seed``, and ``--seed`` orders the pool and deals it to
the clients. So seeds change which client sends what and when, not how
much work the window holds.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

Request = Tuple[int, Dict[str, Any]]  # (kind index, JSON body)


def draw_term_ids(rng: np.random.Generator, n: int, mix: Dict[str, Any]) -> np.ndarray:
    d = mix["term_draw"]
    return (rng.pareto(d["pareto_shape"], n) * d["scale"]).astype(np.int64) % int(
        mix["vocab_terms"])


def word_counts(rng: np.random.Generator, n: int, words: Dict[str, Any]) -> np.ndarray:
    lo, hi, mean = int(words["min"]), int(words["max"]), float(words["mean"])
    if hi == lo:
        return np.full(n, lo, np.int64)
    return lo + rng.binomial(hi - lo, (mean - lo) / (hi - lo), n)


def kind_counts(mix: Dict[str, Any], n: int) -> np.ndarray:
    """Requests of each kind in a pool of ``n``: the shares, rounded so
    that they add up to ``n``."""
    shares = np.asarray([float(k["share"]) for k in mix["kinds"]])
    counts = np.floor(shares / shares.sum() * n).astype(np.int64)
    counts[np.argmax(shares)] += n - int(counts.sum())
    return counts


def requests(mix: Dict[str, Any], seed: int) -> List[List[Request]]:
    """Per client, the (kind, JSON body) of the requests it sends in turn."""
    pool_rng = np.random.default_rng([int(mix["pool_seed"]), 1])
    clients, per = int(mix["clients"]), int(mix["requests_per_client"])
    pool: List[Request] = []
    for k, (kind, n) in enumerate(zip(mix["kinds"], kind_counts(mix, clients * per))):
        counts = word_counts(pool_rng, int(n), kind["words"])
        ids = draw_term_ids(pool_rng, int(counts.sum()), mix)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pool += [(k, dict(kind["body"], term=" ".join(
            f"term{int(t):06d}" for t in ids[starts[i]:starts[i + 1]])))
            for i in range(len(counts))]
    order = np.random.default_rng([int(seed), 1]).permutation(len(pool))
    return [[pool[j] for j in order[c * per:(c + 1) * per]]
            for c in range(clients)]


def kept_offsets(mix: Dict[str, Any], seed: int) -> np.ndarray:
    """Per client, the offset of the requests whose replies are kept for the
    comparison (every ``keep_every``-th from it)."""
    rng = np.random.default_rng([int(seed), 2])
    return rng.integers(0, int(mix["keep_every"]), int(mix["clients"]))
