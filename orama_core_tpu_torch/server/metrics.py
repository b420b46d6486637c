"""Prometheus metrics: counters, gauges, histograms with labels.

Mirrors the reference's metric inventory (`src/metrics.rs:26-252`) and the
text exposition served at ``/metrics`` (`api/mod.rs:54-57`). Implemented
from scratch on the stdlib (no client library in the image).

Port of ``orama_core_tpu/server/metrics.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    def __init__(self, name: str, help_text: str, kind: str) -> None:
        self.name = name
        self.help = help_text
        self.kind = kind
        self._lock = threading.Lock()

    def expose(self) -> List[str]:  # pragma: no cover - overridden
        return []


class Counter(_Metric):
    def __init__(self, name: str, help_text: str = "") -> None:
        super().__init__(name, help_text, "counter")
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def get(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = list(self._values.items()) or [((), 0.0)]
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(labels)} {v}")
        return out


class Gauge(_Metric):
    def __init__(self, name: str, help_text: str = "") -> None:
        super().__init__(name, help_text, "gauge")
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def add(self, delta: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = list(self._values.items()) or [((), 0.0)]
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(labels)} {v}")
        return out


class Histogram(_Metric):
    def __init__(
        self,
        name: str,
        help_text: str = "",
        buckets: Iterable[float] = _DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help_text, "histogram")
        self.buckets = tuple(sorted(buckets))
        self._data: Dict[Tuple[Tuple[str, str], ...], Tuple[List[int], float, int]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts, total, n = self._data.get(
                key, ([0] * len(self.buckets), 0.0, 0)
            )
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._data[key] = (counts, total + value, n + 1)

    def time(self, **labels: str) -> "_Timer":
        return _Timer(self, labels)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            # deep-copy counts under the lock: observe() mutates the lists
            # in place, and a torn scrape (low bucket > +Inf) is a broken
            # histogram to Prometheus
            items = [
                (labels, (list(counts), total, n))
                for labels, (counts, total, n) in self._data.items()
            ]
        for labels, (counts, total, n) in items:
            for b, c in zip(self.buckets, counts):
                lb = labels + (("le", repr(b) if b != int(b) else str(b)),)
                out.append(f"{self.name}_bucket{_fmt_labels(lb)} {c}")
            lb = labels + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(lb)} {n}")
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {total}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {n}")
        return out


class _Timer:
    def __init__(self, hist: Histogram, labels: Dict[str, str]) -> None:
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self.hist.observe(time.perf_counter() - self._t0, **self.labels)
        return False


class Registry:
    def __init__(self) -> None:
        self._metrics: List[_Metric] = []
        self._lock = threading.Lock()

    def register(self, m: _Metric) -> _Metric:
        with self._lock:
            self._metrics.append(m)
        return m

    def expose_text(self) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# Metric inventory (names mirror metrics.rs so the shipped Grafana dashboard
# concepts carry over; the reference's typo'd *_historgram is fixed).
# every ReadSide.search, in process or over HTTP
SEARCH_ELAPSED = REGISTRY.register(
    Histogram("reader_search_elapsed_sec", "search latency")
)
# the micro-batcher (server/batcher.py; no reference counterpart): the
# queries of each batched search, and each query's wait from its enqueue
# to the start of the batch that carries it
BATCH_SIZE = REGISTRY.register(
    Histogram("reader_batch_size", "queries per batched search",
              buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
)
BATCH_QUEUE_WAIT = REGISTRY.register(
    Histogram("reader_batch_queue_wait_sec", "query wait for its batch")
)
EMBED_CALC_ELAPSED = REGISTRY.register(
    Histogram("writer_calc_embed_elapsed_sec", "embedding batch computation")
)
COMMIT_ELAPSED = REGISTRY.register(
    Histogram("commit_elapsed_sec", "commit latency", buckets=(0.01, 0.1, 0.5, 1, 5, 15, 60))
)
ADD_DOCUMENT = REGISTRY.register(
    Counter("writer_add_document_counter", "documents added")
)
COLLECTION_ADDED = REGISTRY.register(
    Counter("reader_collection_added_counter", "collections created on read side")
)
COLLECTION_OPS = REGISTRY.register(
    Counter("reader_collection_op_counter", "ops applied on read side")
)
OPERATION_GAUGE = REGISTRY.register(
    Gauge("operation_gauge", "op channel depth")
)
EMBEDDING_GAUGE = REGISTRY.register(
    Gauge("embedding_request_gauge", "embedding requests queued")
)
PENDING_EMBEDDING_GAUGE = REGISTRY.register(
    Gauge("pending_embedding_request_gauge", "embedding requests in flight")
)
HTTP_REQUESTS = REGISTRY.register(
    Counter("http_requests_total", "http requests by route/status")
)
# serving-path engagement (no reference counterpart): which vector route
# answered — "fast" (fused kNN kernel), "selective" (gather-then-score
# filter), "dense" — so deployments can verify the fast paths engage;
# batched searches count once a batch under "batch_knn_fast",
# "batch_fused_<mode>" and "batch_ann_rows"
VECTOR_PATH = REGISTRY.register(
    Counter("reader_vector_path_total", "vector queries by serving path")
)
