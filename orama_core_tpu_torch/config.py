"""Configuration: YAML file + ``ORAMACORE_``-style env overrides.

Mirrors the reference's config surface (`config.yaml:1-81`,
`bin/oramacore.rs:12-32`, `lib.rs:56-63`) with device-specific additions
(device, dtypes, kernel knobs). Env vars use the prefix
``ORAMAX_`` and ``__``-separated paths, e.g.
``ORAMAX_writer_side__master_api_key=...``.

Port of ``orama_core_tpu/config.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

try:
    import yaml
except Exception:  # pragma: no cover
    yaml = None

ENV_PREFIX = "ORAMAX_"


@dataclasses.dataclass
class HttpConfig:
    host: str = "127.0.0.1"
    port: int = 8080
    allow_cors: bool = True
    with_prometheus: bool = True
    # Load shedding: concurrent heavy requests (search/answer/insert)
    # beyond this get 503 + Retry-After instead of queueing unboundedly.
    max_in_flight: int = 64
    # TCP listen backlog (socketserver defaults to 5, which resets
    # connections under concurrent client bursts instead of queueing
    # them toward the load shedder's clean 503).
    listen_backlog: int = 128
    # SSE answer streams shed from their own pool: they hold a slot for
    # a full LLM generation, so sharing max_in_flight would let a few
    # streams starve every millisecond search.
    max_sse_streams: int = 32
    # Reject request bodies larger than this with 413 before allocating
    # (Content-Length is attacker-controlled).
    max_body_bytes: int = 64 * 1024 * 1024
    # SSE comment-keepalive interval for answer streams (seconds); keeps
    # idle proxies from dropping long-running generations.
    sse_keepalive_sec: float = 15.0


@dataclasses.dataclass
class LogConfig:
    level: str = "info"
    file_path: Optional[str] = None


@dataclasses.dataclass
class WriterSideConfig:
    data_dir: str = "./.data/writer"
    master_api_key: str = "master"
    # Queue capacity of the op log channel (reference: lib.rs:123 => 10_000)
    channel_capacity: int = 10_000
    # Commit after this many ops (reference: insert_batch_commit_size)
    insert_batch_commit_size: int = 5_000
    # Seconds between background commits (reference default 60s)
    commit_interval_sec: float = 60.0
    default_embedding_model: str = "fake-small"
    embedding_queue_limit: int = 10_000
    # Durable op log: append ops to a WAL before the channel so the
    # uncommitted window survives crashes (off = reference semantics)
    wal_enabled: bool = False


@dataclasses.dataclass
class ReaderSideConfig:
    data_dir: str = "./.data/reader"
    insert_batch_commit_size: int = 10_000
    commit_interval_sec: float = 60.0
    # Snapshot GC: generations kept on disk after a pointer swap (the
    # current one plus keep_generations-1 predecessors; older gen-* dirs
    # are pruned). 0 disables pruning.
    keep_generations: int = 2


@dataclasses.dataclass
class AiConfig:
    """Embedding + LLM config (reference `ai_server:` yaml section).

    ``backend``:
      - "fake": deterministic hash-projection embedder (tests/CI; plays the
        role of the reference's in-process fake AI server, test_utils.rs:96-133)
      - "jax": the in-process transformer encoder and LLM decoder
        (models/encoder.py, models/llm.py), on ``gpu.device``; the name is
        the reference's, kept so its configuration files load
    """

    backend: str = "fake"
    embedding_model: str = "fake-small"
    llm_model: str = "fake-llm"
    # sampling temperature for chat decode; 0 = greedy (deterministic).
    # The reference serves temperature=0.1 (service/models.py:100)
    llm_temperature: float = 0.0
    hf_model_path: Optional[str] = None  # load real weights if given
    # Encoder checkpoints: one checkpoint dir, or a dir of per-model subdirs
    # (see scripts/prepare_checkpoint.py). Absent -> pretrained-family models
    # (bge/e5) serve the deterministic lexical fallback (models/lexical.py).
    embedding_checkpoint_path: Optional[str] = None
    max_batch_size: int = 64
    # Remote model backend: when set (host:port), the engine consumes models
    # over gRPC (rpc/client.py) instead of running them in-process —
    # the reference's GPU-sidecar deployment shape (src/ai/mod.rs:42-199).
    remote_url: Optional[str] = None
    # When set, also EXPOSE this process's in-process models over gRPC so
    # remote engines can use this box as a model sidecar (rpc/server.py).
    grpc_port: Optional[int] = None
    # Bind address for that sidecar listener: default loopback; set
    # "0.0.0.0" for the documented remote-sidecar deployment
    grpc_host: str = "127.0.0.1"


@dataclasses.dataclass
class GpuConfig:
    """Device execution knobs: the reference's ``TpuConfig`` with the same
    serving knobs and defaults, plus ``device``. The port runs on one CUDA
    card; ``device="cpu"`` runs every kernel's plain torch version instead
    (the tests do this). ``mesh_shape`` (S, 1) with S >= 2 shards every
    committed structure over S data shards and serves ``search`` through
    the mesh programs (``parallel/``): the shards go onto the visible
    cards in blocks, all of them on one card when there is one (on the
    CPU, all on the CPU), and the kernels launch once per shard. The
    engine does not read the ``model`` axis, as in the reference: it
    serves the models' tensor-parallel layout (``param_specs`` of
    models/encoder.py and models/llm.py, placed by
    ``parallel.mesh.shard_params``)."""

    # "cuda" (one card) or "cpu" (plain torch versions of every kernel)
    device: str = "cuda"
    mesh_shape: Tuple[int, ...] = ()
    mesh_axis_names: Tuple[str, ...] = ("data", "model")
    vector_dtype: str = "bfloat16"
    score_dtype: str = "float32"
    # Pad document capacity to multiples of this (static-shape buckets)
    doc_capacity_step: int = 8192
    # Padding buckets of the committed device arrays
    posting_bucket_steps: Tuple[int, ...] = (1024, 16384, 262144, 4194304)
    budget_bucket_steps: Tuple[int, ...] = (
        1024, 16384, 65536, 262144, 1048576, 4194304,
    )
    # use_pallas, bm25_pallas and phrase_windowed are the reference's
    # kernel-branch knobs, kept so its configs load. They gate nothing:
    # the port always serves unfiltered vector queries with the fused kNN
    # (ops/knn.py: K2 + K3, K5 for int8, K6 for chunked docs), scans
    # postings over the aligned plan (K1) and counts phrases with K4.
    use_pallas: bool = True
    # Vector scoring path: "exact" (bf16 rows), "int8" (the capacity
    # mode: int8 codes + per-row scales, half the bytes of bf16), or the
    # ANN indexes "ivf", "pq" and "ivf_pq" (IVF lists, PQ codes + exact
    # rerank, or both with residual codes), trained at commit on
    # ``device`` once a field holds ``ivf_threshold`` rows (below it the
    # exact rows serve); nprobe and expand are autotuned to
    # ``ivf_autotune_target`` recall@10 unless ``ivf_autotune`` is off
    vector_index: str = "exact"
    # The reference's int8 phase-1 choice ("xla" = its XLA int8 matmul,
    # "pallas" = its in-kernel dot), kept so its configs load. It gates
    # nothing: K5 (csrc/knn_subblock_max_int8.cu) serves both values.
    int8_phase1: str = "xla"
    bm25_pallas: bool = True
    # Dense per-term score rows for Zipf-head terms (ops/bm25.py)
    bm25_dense_terms: int = 16      # max dense rows per field (0 disables)
    bm25_dense_df_ratio: int = 16   # df >= n_docs/ratio qualifies
    phrase_windowed: bool = True
    ivf_threshold: int = 50_000
    ivf_nprobe: int = 16
    ivf_candidate_expand: int = 8
    ivf_autotune: bool = True
    pq_rotation: str = "auto"
    ivf_autotune_target: float = 0.95
    # Selective-filter fast path: when a query's filters match at most
    # this many docs, the vector path scores just those docs' rows
    selective_filter_max: int = 2048
    # Serving micro-batching (server/batcher.py): concurrent searches of
    # one compatibility group coalesce into one search_batch call
    query_batching: bool = False
    batch_max: int = 256
    batch_wait_ms: float = 2.0
    batch_submit_timeout_s: float = 120.0


@dataclasses.dataclass
class OramaxConfig:
    http: HttpConfig = dataclasses.field(default_factory=HttpConfig)
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    writer_side: WriterSideConfig = dataclasses.field(default_factory=WriterSideConfig)
    reader_side: ReaderSideConfig = dataclasses.field(default_factory=ReaderSideConfig)
    ai: AiConfig = dataclasses.field(default_factory=AiConfig)
    gpu: GpuConfig = dataclasses.field(default_factory=GpuConfig)

    @staticmethod
    def load(path: Optional[str] = None, env: Optional[Dict[str, str]] = None) -> "OramaxConfig":
        data: Dict[str, Any] = {}
        path = path or os.environ.get("CONFIG_PATH")
        if path and os.path.exists(path):
            if yaml is None:
                raise RuntimeError("pyyaml unavailable; cannot read config file")
            with open(path, "r", encoding="utf-8") as f:
                data = yaml.safe_load(f) or {}
        env = dict(os.environ if env is None else env)
        for key, value in env.items():
            if not key.startswith(ENV_PREFIX):
                continue
            parts = key[len(ENV_PREFIX):].split("__")
            node = data
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _coerce(value)
        return OramaxConfig.from_dict(data)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "OramaxConfig":
        cfg = OramaxConfig()
        for section_name, section_cls in (
            ("http", HttpConfig),
            ("log", LogConfig),
            ("writer_side", WriterSideConfig),
            ("reader_side", ReaderSideConfig),
            ("ai", AiConfig),
            ("gpu", GpuConfig),
        ):
            section_data = data.get(section_name) or {}
            section = getattr(cfg, section_name)
            for f in dataclasses.fields(section_cls):
                if f.name in section_data:
                    v = section_data[f.name]
                    if isinstance(getattr(section, f.name), tuple) and isinstance(v, list):
                        v = tuple(v)
                    # numeric-LOOKING values targeting str fields stay str:
                    # ORAMAX_writer_side__master_api_key=123456 (or a bare
                    # YAML `master_api_key: 123456`) must compare equal to
                    # the "123456" Bearer header, not fail auth as int
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        ft = str(f.type)
                        if "str" in ft and "int" not in ft and "float" not in ft:
                            v = str(v)
                    setattr(section, f.name, v)
        return cfg


def _coerce(v: str) -> Any:
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v
