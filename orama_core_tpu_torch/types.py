"""Core identifier and document types.

TPU-native counterpart of the reference's `src/types.rs` and
`src/collection_manager/dto.rs` (reference: oramasearch/orama-core).

Design notes (TPU-first):
- `DocumentId` is a *dense* per-collection int32 (0..N). Dense ids are the
  device-array index space: scores, filter bitmaps and facet buckets are all
  arrays indexed by DocumentId, so scatter/gather and segment reductions map
  directly onto XLA/Pallas kernels. (The reference uses a global AtomicU64 —
  `sides/write/mod.rs:248-277` — which would force hash-maps everywhere.)
- `FieldId` is a small int, assigned per collection in registration order
  (mirrors `FieldId(u16)` in the reference).

Port of ``orama_core_tpu/types.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import enum
import re
import secrets
from typing import Any, Dict, List, Optional, Tuple, Union

Number = Union[int, float]

_COLLECTION_ID_RE = re.compile(r"^[A-Za-z0-9_\-\.]{1,128}$")


def new_cuid() -> str:
    """Random unique string id for documents lacking an "id" field.

    Plays the role of cuid2 in the reference (`sides/write/mod.rs:261`).
    """
    return "c" + secrets.token_hex(12)


class ValueType(str, enum.Enum):
    """Scalar field types inferred from documents (dto.rs ValueType)."""

    STRING = "string"
    NUMBER = "number"
    BOOL = "bool"
    EMBEDDING = "embedding"
    ARRAY_STRING = "array_string"
    ARRAY_NUMBER = "array_number"
    ARRAY_BOOL = "array_bool"


class SearchModeKind(str, enum.Enum):
    FULLTEXT = "fulltext"
    VECTOR = "vector"
    HYBRID = "hybrid"


class HybridFusion(str, enum.Enum):
    """Hybrid score fusion strategy.

    The reference implements min-max normalize + sum
    (`sides/read/collection.rs:750-772`). RRF is the default here
    (better rank stability; see BASELINE.md), min-max kept for compat.
    """

    RRF = "rrf"
    MINMAX = "minmax"


@dataclasses.dataclass(frozen=True)
class CollectionId:
    value: str

    def __post_init__(self) -> None:
        if not _COLLECTION_ID_RE.match(self.value):
            raise ValueError(f"invalid collection id: {self.value!r}")

    def __str__(self) -> str:  # pragma: no cover
        return self.value


# Filters ---------------------------------------------------------------------
# JSON shapes mirror the reference (`dto.rs:151-187`, `dto/number.rs:194-206`):
#   {"field": {"eq": 3}} {"field": {"gt": 1}} {"field": {"between": [1, 5]}}
#   {"field": true}

NUMBER_FILTER_OPS = ("eq", "gt", "gte", "lt", "lte", "between")


@dataclasses.dataclass(frozen=True)
class NumberFilter:
    op: str  # one of NUMBER_FILTER_OPS
    value: Union[Number, Tuple[Number, Number]]

    def __post_init__(self) -> None:
        if self.op not in NUMBER_FILTER_OPS:
            raise ValueError(f"unknown number filter op {self.op!r}")
        if self.op == "between":
            if not (isinstance(self.value, (tuple, list)) and len(self.value) == 2):
                raise ValueError("'between' filter takes [low, high]")
            object.__setattr__(self, "value", (self.value[0], self.value[1]))

    @staticmethod
    def from_json(obj: Any) -> "NumberFilter":
        if not isinstance(obj, dict) or len(obj) != 1:
            raise ValueError(f"bad number filter: {obj!r}")
        op, value = next(iter(obj.items()))
        return NumberFilter(op=op, value=value)


@dataclasses.dataclass(frozen=True)
class BoolFilter:
    value: bool


@dataclasses.dataclass(frozen=True)
class StringFilter:
    """Exact-match keyword filter (reference roadmap item, implemented
    here): {"field": "red"}, {"field": {"eq": "red"}},
    {"field": {"in": ["red", "blue"]}}."""

    op: str  # "eq" | "in"
    value: Union[str, Tuple[str, ...]]

    def __post_init__(self) -> None:
        if self.op not in ("eq", "in"):
            raise ValueError(f"unknown string filter op {self.op!r}")
        if self.op == "in":
            if not isinstance(self.value, (tuple, list)):
                raise ValueError("'in' filter takes a list of strings")
            object.__setattr__(self, "value", tuple(str(v) for v in self.value))


Filter = Union[NumberFilter, BoolFilter, StringFilter]


def parse_filter(obj: Any) -> Filter:
    if isinstance(obj, bool):
        return BoolFilter(obj)
    if isinstance(obj, str):
        return StringFilter("eq", obj)
    if isinstance(obj, dict) and len(obj) == 1:
        op, value = next(iter(obj.items()))
        if op == "eq" and isinstance(value, str):
            return StringFilter("eq", value)
        if op == "in" and isinstance(value, (list, tuple)) and all(
            isinstance(v, str) for v in value
        ):
            return StringFilter("in", tuple(value))
    return NumberFilter.from_json(obj)


# Facets ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NumberFacetRange:
    low: Number
    high: Number

    @property
    def key(self) -> str:
        lo = "-inf" if self.low == float("-inf") else _fmt_num(self.low)
        hi = "inf" if self.high == float("inf") else _fmt_num(self.high)
        return f"{lo}-{hi}"


def _fmt_num(v: Number) -> str:
    # Mirrors Rust Display for the facet bucket key "from-to"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


@dataclasses.dataclass(frozen=True)
class NumberFacetDefinition:
    ranges: Tuple[NumberFacetRange, ...]


@dataclasses.dataclass(frozen=True)
class BoolFacetDefinition:
    true: bool = True
    false: bool = True


@dataclasses.dataclass(frozen=True)
class StringFacetDefinition:
    """Term facet over a keyword-indexed string field: top-`limit` exact
    values by matched-doc count ({} or {"limit": N} in the request)."""

    limit: int = 10


FacetDefinition = Union[
    NumberFacetDefinition, BoolFacetDefinition, StringFacetDefinition
]


def parse_facet(obj: Any) -> FacetDefinition:
    if isinstance(obj, dict) and "ranges" in obj:
        rs = obj["ranges"]
        if not isinstance(rs, list):
            raise ValueError('"ranges" must be a list of {from, to} objects')
        ranges = []
        for r in rs:
            if not isinstance(r, dict) or not ({"from", "to"} & set(r)):
                raise ValueError(f"bad facet range: {r!r}")
            # open-ended ranges per the reference's own docs, e.g.
            # {"from": 1000} (search-documents.mdx:112 — its code requires
            # both bounds; implemented here as documented)
            lo, hi = r.get("from", float("-inf")), r.get("to", float("inf"))
            if isinstance(lo, bool) or isinstance(hi, bool) or not (
                isinstance(lo, (int, float)) and isinstance(hi, (int, float))
            ):
                raise ValueError(f"bad facet range bounds: {r!r}")
            ranges.append(NumberFacetRange(low=lo, high=hi))
        return NumberFacetDefinition(ranges=tuple(ranges))
    if isinstance(obj, dict) and ("true" in obj or "false" in obj):
        return BoolFacetDefinition(
            true=bool(obj.get("true", False)), false=bool(obj.get("false", False))
        )
    if isinstance(obj, dict) and set(obj) <= {"limit", "order"}:
        return StringFacetDefinition(limit=int(obj.get("limit", 10)))
    raise ValueError(f"bad facet definition: {obj!r}")


# Search params ---------------------------------------------------------------


@dataclasses.dataclass
class SearchParams:
    """Parsed body of POST /v1/collections/{id}/search (dto.rs:242-261)."""

    term: str = ""
    mode: SearchModeKind = SearchModeKind.FULLTEXT
    limit: int = 10
    # pagination: skip the first `offset` ranked hits (the reference's docs
    # promise this parameter, search-documents.mdx:42; its dto.rs:249 never
    # implemented it — implemented here as documented)
    offset: int = 0
    boost: Dict[str, float] = dataclasses.field(default_factory=dict)
    # None => all string fields; "*" => all; list => specified
    properties: Optional[List[str]] = None
    where: Dict[str, Filter] = dataclasses.field(default_factory=dict)
    facets: Dict[str, FacetDefinition] = dataclasses.field(default_factory=dict)
    fusion: HybridFusion = HybridFusion.RRF
    # raw query embedding for mode=vector — implements the reference's own
    # TODO (dto.rs:196-201: '"vector": [...] ... only "term" for now')
    vector: Optional[List[float]] = None

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "SearchParams":
        # client input: shape-check before attribute access so malformed
        # bodies surface as 400s, never 500s
        if not isinstance(obj, dict):
            raise ValueError("search body must be a JSON object")
        for key, want in (
            ("where", dict), ("facets", dict), ("boost", dict),
        ):
            v = obj.get(key)
            if v is not None and not isinstance(v, want):
                raise ValueError(f'"{key}" must be a JSON object')
        mode_s = obj.get("mode", "fulltext")
        try:
            mode = SearchModeKind(mode_s)
        except ValueError as e:
            raise ValueError(f"unknown search mode {mode_s!r}") from e
        props = obj.get("properties")
        if props == "*":
            props = None
        elif props is not None and not isinstance(props, list):
            raise ValueError("properties must be '*' or a list of field names")
        where = {k: parse_filter(v) for k, v in (obj.get("where") or {}).items()}
        facets = {k: parse_facet(v) for k, v in (obj.get("facets") or {}).items()}
        fusion = HybridFusion(obj.get("fusion", "rrf"))
        limit = int(obj.get("limit", 10))
        if limit <= 0:
            raise ValueError("limit must be positive")
        offset = int(obj.get("offset", 0))
        if offset < 0:
            raise ValueError("offset must be >= 0")
        vector = obj.get("vector")
        if vector is not None:
            if mode != SearchModeKind.VECTOR:
                raise ValueError('"vector" requires {"mode": "vector"}')
            if not isinstance(vector, list) or not vector or not all(
                isinstance(x, (int, float)) and not isinstance(x, bool)
                for x in vector
            ):
                raise ValueError('"vector" must be a non-empty number list')
            vector = [float(x) for x in vector]
        return SearchParams(
            vector=vector,
            term=str(obj.get("term", "")),
            mode=mode,
            limit=limit,
            offset=offset,
            boost={str(k): float(v) for k, v in (obj.get("boost") or {}).items()},
            properties=props,
            where=where,
            facets=facets,
            fusion=fusion,
        )


@dataclasses.dataclass
class SearchResultHit:
    id: str
    score: float
    document: Optional[Dict[str, Any]]

    def to_json(self) -> Dict[str, Any]:
        return {"id": self.id, "score": self.score, "document": self.document}


@dataclasses.dataclass
class FacetResult:
    count: int
    values: Dict[str, int]

    def to_json(self) -> Dict[str, Any]:
        return {"count": self.count, "values": self.values}


@dataclasses.dataclass
class SearchResult:
    hits: List[SearchResultHit]
    count: int
    elapsed_ms: float
    facets: Optional[Dict[str, FacetResult]] = None
    # True when a degraded multi-slice search served from a subset of
    # slices (MultiSliceRouter partial_tolerance); additive wire field
    partial: bool = False

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "hits": [h.to_json() for h in self.hits],
            "count": self.count,
            "elapsed": {"raw": int(self.elapsed_ms * 1e6), "formatted": f"{self.elapsed_ms:.3f}ms"},
        }
        if self.facets is not None:
            out["facets"] = {k: v.to_json() for k, v in self.facets.items()}
        if self.partial:
            out["partial"] = True
        return out


# Typed fields ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TypedField:
    """A registered collection field: (field_id, name, type, params)."""

    field_id: int
    name: str
    type: ValueType
    # for EMBEDDING fields:
    model: Optional[str] = None
    # embedding input spec: list of source properties, "hook", or "all_strings"
    embedding_sources: Optional[Tuple[str, ...]] = None
    locale: str = "en"


class ApiKeyError(PermissionError):
    pass


class CollectionNotFound(KeyError):
    pass


class FieldTypeError(ValueError):
    pass
