"""Multi-slice coordination: scatter-gather over independent engines.

Port of ``orama_core_tpu/parallel/multislice.py`` (host Python, the same
code over the port's engines). The in-mesh path (``sharded_engine``)
shards documents over the devices of one engine; THIS layer shards
documents over slices, where each slice is a whole engine (its own write
side, op log, read side, mesh) and coordination is host-side RPC, the
op-log seam of the single engine stretched across machines (the
reference engine is single-node and has no counterpart).

Design (the standard distributed-search shape, cf. ES/Solr shards):
- documents are routed to a slice by a stable hash of their user id:
  a doc lives on exactly one slice, so merged results never need dedup;
- writes fan out grouped by slice; reads scatter to every slice and
  gather top-`limit` from each, merged by score (O(slices * limit));
- facets merge by summing bucket counts; counts sum.

Semantics note: by default BM25 idf and RRF ranks are slice-local, as
in Elasticsearch's query-then-fetch. ``sync_global_stats`` upgrades BM25
to GLOBAL idf (ES dfs_query_then_fetch; the single engine's semantics) by
exchanging per-term df at commit time; hybrid queries fuse over the
globally merged component rankings (``_search_hybrid_global``).

Transports: LocalSlice (an in-process engine), HttpSlice (the engine's
own HTTP API; stdlib urllib) and GrpcSlice (``parallel/slice_grpc``, one
generic gRPC method carrying the engine's JSON wire shapes; imported only
where it is asked for, since it needs ``grpcio``).
"""

from __future__ import annotations

import hashlib
import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from ..types import FacetResult, SearchParams, SearchResult, SearchResultHit


def _route(doc_id: str, n: int) -> int:
    return int.from_bytes(hashlib.sha1(doc_id.encode()).digest()[:4], "big") % n


class LocalSlice:
    """A slice backed by an in-process engine (an `Orama` instance)."""

    def __init__(self, engine) -> None:
        self.engine = engine

    def create_collection(self, master_key, cid, read_key, write_key, **kw) -> None:
        self.engine.write_side.create_collection(
            master_key, cid, read_api_key=read_key, write_api_key=write_key, **kw
        )
        self.engine.flush()

    def write(self, cid: str, docs: List[dict], write_key: str) -> List[str]:
        ids = self.engine.write_side.write(cid, docs, write_key)
        return ids

    def delete(self, cid: str, ids: Sequence[str], write_key: str) -> int:
        return self.engine.write_side.delete_documents(cid, list(ids), write_key)

    def search(self, cid: str, params_json: Dict[str, Any], read_key: str) -> SearchResult:
        return self.engine.read_side.search(
            cid, SearchParams.from_json(params_json), read_key
        )

    def flush(self) -> None:
        self.engine.flush()

    def commit(self) -> None:
        self.engine.commit()

    def count(self, cid: str) -> int:
        return self.engine.read_side.count_documents(cid)

    def export_term_stats(self, cid: str, write_key: str):
        return self.engine.read_side.export_term_stats(cid)

    def apply_global_stats(self, cid: str, stats, write_key: str) -> None:
        self.engine.read_side.apply_global_stats(cid, stats)


class HttpSlice:
    """A slice behind the engine's HTTP API (server/http.py routes)."""

    def __init__(self, base_url: str, timeout_s: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _post(self, path: str, body: Any, bearer: Optional[str]) -> Any:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode(),
            headers={
                "Content-Type": "application/json",
                **({"Authorization": f"Bearer {bearer}"} if bearer else {}),
            },
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def create_collection(self, master_key, cid, read_key, write_key, **kw) -> None:
        body = {"id": cid, "read_api_key": read_key, "write_api_key": write_key}
        if kw.get("language"):
            body["language"] = kw["language"]
        if kw.get("description"):
            body["description"] = kw["description"]
        if kw.get("embedding_model"):
            body["embeddings"] = {
                "model": kw["embedding_model"],
                "document_fields": list(kw.get("embedding_sources") or []),
            }
        self._post("/v1/collections/create", body, master_key)

    def write(self, cid: str, docs: List[dict], write_key: str) -> List[str]:
        out = self._post(f"/v1/collections/{cid}/insert", docs, write_key)
        return out.get("ids", [])

    def delete(self, cid: str, ids: Sequence[str], write_key: str) -> int:
        out = self._post(f"/v1/collections/{cid}/delete", {"ids": list(ids)}, write_key)
        return out.get("deleted", 0)

    def search(self, cid: str, params_json: Dict[str, Any], read_key: str) -> SearchResult:
        raw = self._post(f"/v1/collections/{cid}/search", params_json, read_key)
        hits = [
            SearchResultHit(id=h["id"], score=h["score"], document=h.get("document"))
            for h in raw.get("hits", [])
        ]
        facets = None
        if raw.get("facets"):
            facets = {
                k: FacetResult(count=v["count"], values=dict(v["values"]))
                for k, v in raw["facets"].items()
            }
        return SearchResult(
            hits=hits,
            count=raw.get("count", len(hits)),
            elapsed_ms=0.0,
            facets=facets,
        )

    def flush(self) -> None:  # HTTP slices flush via their own background loops
        pass

    def commit(self) -> None:
        pass

    def count(self, cid: str, read_key: Optional[str] = None) -> int:
        # no dedicated count route: an empty-term search matches every
        # alive document (the engine's documented match-all semantics)
        return self.search(cid, {"term": "", "limit": 1}, read_key).count

    def _get(self, path: str, bearer: Optional[str]) -> Any:
        req = urllib.request.Request(
            self.base_url + path,
            headers={"Authorization": f"Bearer {bearer}"} if bearer else {},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def export_term_stats(self, cid: str, write_key: str):
        return self._get(f"/v1/collections/{cid}/stats/export", write_key)

    def apply_global_stats(self, cid: str, stats, write_key: str) -> None:
        self._post(f"/v1/collections/{cid}/stats/import", stats, write_key)


class MultiSliceRouter:
    """Scatter-gather coordinator over document-hash-routed slices."""

    def __init__(
        self,
        slices: Sequence[Any],
        max_workers: Optional[int] = None,
        global_fusion: bool = True,
        partial_tolerance: bool = False,
    ) -> None:
        if not slices:
            raise ValueError("need at least one slice")
        self.slices = list(slices)
        # hybrid fan-out is 3 sub-searches per slice in global-fusion
        # mode — size the pool so one query still runs in one round
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or 3 * len(self.slices)
        )
        self.global_fusion = global_fusion
        # ES-style degraded reads: a failed slice drops out of the merge
        # and the result is flagged `partial` instead of erroring the
        # whole query (writes stay fail-fast — losing acks is not an
        # acceptable degradation). Default off: fail-fast.
        self.partial_tolerance = partial_tolerance

    def _gather_search(self, futures):
        """Collect per-slice search futures; under partial_tolerance,
        failed slices are skipped (result flagged partial). All-failed
        still raises the last error."""
        results, failed, last = [], 0, None
        for f in futures:
            try:
                results.append(f.result())
            except Exception as e:  # noqa: BLE001 — transport/slice fault
                if not self.partial_tolerance:
                    raise
                failed += 1
                last = e
        if not results and last is not None:
            raise last
        return results, failed > 0

    # -- admin (broadcast) --------------------------------------------------

    def create_collection(self, master_key, cid, read_key, write_key, **kw) -> None:
        list(
            self._pool.map(
                lambda s: s.create_collection(master_key, cid, read_key, write_key, **kw),
                self.slices,
            )
        )

    def flush(self) -> None:
        list(self._pool.map(lambda s: s.flush(), self.slices))

    def commit(self) -> None:
        list(self._pool.map(lambda s: s.commit(), self.slices))

    # -- writes (routed) ------------------------------------------------------

    def write(self, cid: str, docs: List[dict], write_key: str) -> List[str]:
        """Multi-slice writes require explicit STRING doc ids: a doc's
        slice is a stable hash of its user id, and an id assigned (or
        regenerated) slice-side would not be routable for later
        delete/update calls — a non-string id would be replaced by a
        fresh cuid on the slice, silently diverging from the routing key."""
        n = len(self.slices)
        groups: List[List[dict]] = [[] for _ in range(n)]
        group_idx: List[List[int]] = [[] for _ in range(n)]
        for pos, doc in enumerate(docs):
            did = doc.get("id")
            if not isinstance(did, str) or not did:
                raise ValueError(
                    "multi-slice writes require explicit string doc ids"
                )
            g = _route(did, n)
            groups[g].append(doc)
            group_idx[g].append(pos)
        futures = [
            (group_idx[i], self._pool.submit(
                self.slices[i].write, cid, g, write_key
            ))
            for i, g in enumerate(groups)
            if g
        ]
        # ids align positionally with the INPUT docs, matching the
        # single-engine write() contract
        out: List[Optional[str]] = [None] * len(docs)
        for idxs, f in futures:
            for pos, did in zip(idxs, f.result()):
                out[pos] = did
        return out  # every slot filled: groups partition the docs

    def delete(self, cid: str, ids: Sequence[str], write_key: str) -> int:
        n = len(self.slices)
        groups: List[List[str]] = [[] for _ in range(n)]
        for did in ids:
            groups[_route(str(did), n)].append(str(did))
        futures = [
            self._pool.submit(self.slices[i].delete, cid, g, write_key)
            for i, g in enumerate(groups)
            if g
        ]
        return sum(f.result() for f in futures)

    # -- global statistics (DFS mode) -----------------------------------------

    def sync_global_stats(self, cid: str, write_key: str) -> None:
        """Exchange BM25 statistics across slices so idf is GLOBAL, not
        slice-local (the reference's single-node semantics, vs the default
        ES-style query-then-fetch): export each slice's committed per-term
        df + (n_docs, total_len), merge by sum, import everywhere. Commit-
        static: call after commit(); RRF rank fusion remains slice-local
        (documented approximation — rank exchange would need per-query
        candidate traffic)."""
        all_stats = list(
            self._pool.map(
                lambda s: s.export_term_stats(cid, write_key), self.slices
            )
        )
        merged: Dict[str, Dict[str, Any]] = {}
        for stats in all_stats:
            for field, s in stats.items():
                m = merged.setdefault(
                    field, {"df": {}, "n_docs": 0, "total_len": 0}
                )
                for t, d in zip(s["terms"], s["df"]):
                    m["df"][t] = m["df"].get(t, 0.0) + float(d)
                m["n_docs"] += int(s["n_docs"])
                m["total_len"] += int(s["total_len"])
        payload = {
            field: {
                "terms": list(m["df"].keys()),
                "df": list(m["df"].values()),
                "n_docs": m["n_docs"],
                "total_len": m["total_len"],
            }
            for field, m in merged.items()
        }
        list(
            self._pool.map(
                lambda s: s.apply_global_stats(cid, payload, write_key),
                self.slices,
            )
        )

    # -- reads (scatter-gather) ----------------------------------------------

    def search(self, cid: str, params_json: Dict[str, Any], read_key: str) -> SearchResult:
        if (
            self.global_fusion
            and params_json.get("mode") == "hybrid"
            and len(self.slices) > 1
        ):
            return self._search_hybrid_global(cid, params_json, read_key)
        limit = int(params_json.get("limit", 10))
        offset = int(params_json.get("offset", 0))
        if offset:
            # pagination is a COORDINATOR concern: each slice must return
            # its full top-(offset+limit) so the merged skip is global
            params_json = {
                **params_json, "limit": limit + offset, "offset": 0,
            }
        futures = [
            self._pool.submit(s.search, cid, params_json, read_key)
            for s in self.slices
        ]
        results, partial = self._gather_search(futures)
        # deterministic merge: score desc, user id asc on ties (slices
        # assign their own dense ids, so the user id is the only stable
        # cross-slice tiebreak)
        hits = sorted(
            (h for r in results for h in r.hits),
            key=lambda h: (-h.score, h.id),
        )[offset : offset + limit]
        count = sum(r.count for r in results)
        facets = self._merge_facets(results)
        elapsed = max((r.elapsed_ms for r in results), default=0.0)
        return SearchResult(hits=hits, count=count, elapsed_ms=elapsed,
                            facets=facets, partial=partial)

    @staticmethod
    def _merge_facets(results) -> Optional[Dict[str, FacetResult]]:
        if not any(r.facets for r in results):
            return None
        facets: Dict[str, FacetResult] = {}
        for r in results:
            for name, fr in (r.facets or {}).items():
                cur = facets.get(name)
                if cur is None:
                    facets[name] = FacetResult(count=fr.count, values=dict(fr.values))
                else:
                    for k, v in fr.values.items():
                        cur.values[k] = cur.values.get(k, 0) + v
        # `count` is the number of DISTINCT buckets, not a per-slice
        # additive quantity (number facets report the same ranges on
        # every slice) — recompute it from the merged values
        for fr in facets.values():
            fr.count = len(fr.values)
        return facets

    def _search_hybrid_global(
        self, cid: str, p: Dict[str, Any], read_key: str
    ) -> SearchResult:
        """Hybrid search with GLOBAL fusion ranks (single-engine
        semantics) instead of slice-local RRF.

        Slice-local fusion makes ranks incomparable across slices: rank 1
        on a half-empty slice and rank 1 on a full one fuse identically.
        This path scatters THREE sub-searches per slice in one concurrent
        round — the fulltext component (top-L), the vector component
        (top-L), and the original hybrid with limit=1 (for the exact
        match count and facets, which are additive per slice) — then
        computes fusion over the GLOBALLY merged component rankings, the
        same formula the engine applies on one node (ops/fusion.py:
        rank 0 = best, fused = sum 1/(61+rank); minmax = (ft+vec)/max).

        Exactness: a doc is fetched iff one of its component ranks is
        <= L on its slice; with L = max(4*limit, 40) per component the
        merged ranking agrees with the single-engine oracle unless a
        true top-limit doc ranks below L in BOTH components (the same
        approximation class as ES dfs_query_then_fetch). Component
        scores are merged by value, so BM25 comparability assumes
        ``sync_global_stats`` ran (global idf); without it the merge is
        the usual query-then-fetch approximation. Costs ~2x slice work
        per query — ``global_fusion=False`` restores the single-scatter
        slice-local path."""
        limit = int(p.get("limit", 10))
        offset = int(p.get("offset", 0))
        limit += offset  # pagination applies after the global fusion
        L = max(4 * limit, 40)
        comp = {
            k: v for k, v in p.items()
            if k not in ("mode", "limit", "facets", "fusion", "offset")
        }
        p = {k: v for k, v in p.items() if k != "offset"}
        pf = dict(comp, mode="fulltext", limit=L)
        pv = dict(comp, mode="vector", limit=L)
        ph = dict(p, limit=1)
        futs = [
            (
                self._pool.submit(s.search, cid, pf, read_key),
                self._pool.submit(s.search, cid, pv, read_key),
                self._pool.submit(s.search, cid, ph, read_key),
            )
            for s in self.slices
        ]
        trips, partial = [], False
        for a, b, c in futs:
            try:
                trips.append((a.result(), b.result(), c.result()))
            except Exception:  # noqa: BLE001 — drop the whole slice
                if not self.partial_tolerance:
                    raise
                partial = True
        if not trips:
            raise RuntimeError("all slices failed")
        ft_r = [t[0] for t in trips]
        vec_r = [t[1] for t in trips]
        hyb_r = [t[2] for t in trips]

        def merged(results):
            return sorted(
                (h for r in results for h in r.hits if h.score > 0),
                key=lambda h: (-h.score, h.id),
            )

        ft_rank, vec_rank = merged(ft_r), merged(vec_r)
        by_id: Dict[str, Any] = {}
        scores: Dict[str, float] = {}
        if p.get("fusion", "rrf") == "minmax":
            m = max(
                [h.score for h in ft_rank[:1]]
                + [h.score for h in vec_rank[:1]]
                + [1e-9]
            )
            for h in ft_rank + vec_rank:
                scores[h.id] = scores.get(h.id, 0.0) + h.score / m
                by_id.setdefault(h.id, h)
        else:
            for ranked in (ft_rank, vec_rank):
                for r, h in enumerate(ranked):
                    scores[h.id] = scores.get(h.id, 0.0) + 1.0 / (61.0 + r)
                    by_id.setdefault(h.id, h)
        top = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[offset:limit]
        hits = [
            SearchResultHit(id=i, score=s, document=by_id[i].document)
            for i, s in top
        ]
        return SearchResult(
            hits=hits,
            count=sum(r.count for r in hyb_r),
            elapsed_ms=max(
                (r.elapsed_ms for rs in (ft_r, vec_r, hyb_r) for r in rs),
                default=0.0,
            ),
            facets=self._merge_facets(hyb_r),
            partial=partial,
        )

    def count(self, cid: str, read_key: Optional[str] = None) -> int:
        return sum(
            s.count(cid, read_key)
            if isinstance(s, HttpSlice) else s.count(cid)
            for s in self.slices
        )

    def close(self) -> None:
        self._pool.shutdown(wait=False)
