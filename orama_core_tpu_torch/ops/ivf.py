"""IVF (inverted-file) partitioned ANN search.

Port of ``orama_core_tpu/ops/ivf.py``, which replaces the reference's HNSW
graph (`committed/vector.rs`, hora crate) with matrix products: k-means
centroids cluster the corpus; a query scores the centroid matrix (one
small product), picks ``nprobe`` clusters, and scans only their members
(gathered into a padded [nprobe, cluster_cap, D] block).

The reference computes all of this outside its Pallas kernels, so the
port is plain torch on the device the tensors lie on. Differences of
form, each with the same result:

- Lloyd's centroid sums are an ``index_add_`` of the rows instead of a
  one-hot product (only the order of the f32 sums changes), and every
  [rows, clusters] similarity block is taken a chunk of rows at a time,
  so a 1M-row corpus never holds a [P, C] f32 matrix whole.
- ``kmeans`` draws its initial rows from a CPU ``torch.Generator`` and
  then runs ``kmeans_refine``: the CPU and the card start from the same
  centroids (the reference's ``jax.random.choice`` draws others).
- Every top-k goes through ``topk_stable`` (ties toward the lower
  position, as ``lax.top_k``; masked ``-inf`` entries last).
- The ADC sum of ``ivf_pq_search`` is a LUT gather summed over the
  subspaces, where the reference runs 256 compare-accumulate passes
  (gathers are slow on a TPU): the same sum in another order.
- Query batches are cut into chunks whose gathered candidate blocks stay
  near 1 GiB; each query's result is independent of the others.

bf16 rows are multiplied as the reference does: the query rounded to the
row dtype, both upcast to f32 (exact for bf16), f32 sums. Callers on the
card disable TF32 (``configure_torch``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .topk import topk_stable

_BLOCK = 1 << 28  # elements of one f32 working block (1 GiB)
_QUERY_BYTES = 1 << 30  # candidate working set of one chunk of queries


def _rows_per_block(width: int) -> int:
    return max(1024, _BLOCK // max(int(width), 1))


def _lloyd_step(vecs: torch.Tensor, cents: torch.Tensor,
                spherical: bool) -> torch.Tensor:
    c, d = cents.shape
    sums = torch.zeros(c, d, dtype=torch.float32, device=cents.device)
    counts = torch.zeros(c, dtype=torch.float32, device=cents.device)
    half_sq = None if spherical else 0.5 * torch.sum(cents ** 2, dim=-1)
    step = _rows_per_block(c)
    for lo in range(0, vecs.shape[0], step):
        v = vecs[lo:lo + step].to(torch.float32)
        sims = v @ cents.T                                   # [rows, C]
        if half_sq is not None:
            sims = sims - half_sq[None, :]
        assign = torch.argmax(sims, dim=1)
        sums.index_add_(0, assign, v)
        counts += torch.bincount(assign, minlength=c).to(torch.float32)
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts, min=1.0)[:, None], cents)
    if spherical:
        norm = torch.linalg.norm(new, dim=-1, keepdim=True)
        new = new / torch.clamp(norm, min=1e-9)
    return new


def kmeans_refine(vecs: torch.Tensor, cents: torch.Tensor, iters: int = 3,
                  spherical: bool = True) -> torch.Tensor:
    """Lloyd iterations from GIVEN centroids. ``spherical=True`` (IVF over
    a normalized corpus): assign by max cosine, centroids re-normalized.
    ``spherical=False`` (PQ subspace codebooks): Euclidean assignment
    (argmax v·c - |c|²/2), centroids are plain means. Returns f32[C, D]."""
    cents = cents.to(device=vecs.device, dtype=torch.float32)
    for _ in range(iters):
        cents = _lloyd_step(vecs, cents, spherical)
    return cents


def kmeans(vecs: torch.Tensor, generator: torch.Generator, n_clusters: int,
           iters: int = 10, spherical: bool = True) -> torch.Tensor:
    """Draw ``n_clusters`` rows with the CPU ``generator`` (distinct rows
    when the corpus has enough, with replacement otherwise, as the
    reference's ``replace=p < n_clusters``), then ``kmeans_refine`` from
    them. f32[C, D] on the rows' device."""
    p = vecs.shape[0]
    if p < n_clusters:
        idx = torch.randint(p, (n_clusters,), generator=generator)
    else:
        idx = torch.randperm(p, generator=generator)[:n_clusters]
    cents = vecs[idx.to(vecs.device)].to(torch.float32)
    return kmeans_refine(vecs, cents, iters=iters, spherical=spherical)


def assign_clusters(vecs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """int32[P]: each row's argmax centroid (centroids rounded to the row
    dtype, products in f32)."""
    c = cents.to(vecs.dtype).to(torch.float32)
    out = torch.empty(vecs.shape[0], dtype=torch.int32, device=vecs.device)
    step = _rows_per_block(c.shape[0])
    for lo in range(0, vecs.shape[0], step):
        sims = vecs[lo:lo + step].to(torch.float32) @ c.T
        out[lo:lo + step] = torch.argmax(sims, dim=1).to(torch.int32)
    return out


def assign_clusters_chunked(vecs: torch.Tensor, cents: torch.Tensor,
                            chunk: int = 1_000_000) -> np.ndarray:
    """Host int32[P] of ``assign_clusters``, a chunk of rows at a time."""
    out = np.zeros(vecs.shape[0], dtype=np.int32)
    for i in range(0, vecs.shape[0], chunk):
        out[i:i + chunk] = assign_clusters(vecs[i:i + chunk],
                                           cents).cpu().numpy()
    return out


def split_skewed(
    vecs: torch.Tensor,
    cents: torch.Tensor,
    assign: np.ndarray,
    target: int,
    rng: np.random.Generator,
    rounds: int = 3,
    refine_iters: int = 0,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Bound the largest cluster: the list table pads to the max cluster
    size (no spilling — the residual-ADC invariant), so one giant cluster
    inflates the [Q, nprobe*cap, D] candidate block for every query.
    Each oversized cluster's centroid is replaced by two symmetric
    children straddling it along the direction of a far member, then
    membership is reassigned globally (it must stay the global argmax).
    ``refine_iters`` defaults to 0: Lloyd re-collapses a split isotropic
    cap, while the raw bisector split is balanced by construction. Exact
    duplicates cannot be split: a round that makes no progress stops.
    The host loop is the reference's, draw for draw from ``rng``."""
    v_host = None
    for _ in range(rounds):
        counts = np.bincount(assign, minlength=int(cents.shape[0]))
        big = np.where(counts > target)[0]
        if big.size == 0:
            break
        if v_host is None:
            v_host = vecs.to(torch.float32).cpu().numpy()
        c_host = cents.to(torch.float32).cpu().numpy().copy()
        appended = []
        for ci in big:
            members = np.where(assign == ci)[0]
            sample = members if len(members) <= 4096 else rng.choice(
                members, 4096, replace=False
            )
            sims = v_host[sample] @ c_host[ci]
            m = v_host[sample[int(np.argmin(sims))]]
            delta = m - c_host[ci]
            # symmetric children: the split direction perpendicular to c
            delta = delta - float(delta @ c_host[ci]) * c_host[ci]
            if float(np.linalg.norm(delta)) < 1e-7:
                continue  # exact duplicates: nothing to split
            a = c_host[ci] + 0.5 * delta
            b = c_host[ci] - 0.5 * delta
            a /= max(float(np.linalg.norm(a)), 1e-9)
            b /= max(float(np.linalg.norm(b)), 1e-9)
            c_host[ci] = a
            appended.append(b)
        if not appended:
            break
        cents = torch.as_tensor(
            np.concatenate([c_host, np.stack(appended)]).astype(np.float32),
            device=vecs.device,
        )
        if refine_iters > 0:
            cents = kmeans_refine(vecs, cents, iters=refine_iters)
        new_assign = assign_clusters_chunked(vecs, cents)
        new_counts = np.bincount(new_assign, minlength=int(cents.shape[0]))
        no_progress = new_counts.max() >= counts.max()
        assign = new_assign
        if no_progress:
            break
    return cents, assign


def build_ivf_lists(
    assign: np.ndarray, n_clusters: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host: pack member row-ids per cluster into a padded [C, cap] table.

    cap = the largest cluster size rounded up to 128. Every row sits in
    exactly its argmax cluster — an invariant residual IVF-PQ depends on:
    the ADC score adds the probed cluster's centroid dot. Skew is handled
    upstream by ``split_skewed``, not by spilling."""
    counts = np.bincount(assign, minlength=n_clusters)
    cap = int(counts.max()) if counts.size else 1
    cap = max(int(np.ceil(cap / 128)) * 128, 128)
    lists = np.zeros((n_clusters, cap), dtype=np.int32)
    lens = np.zeros(n_clusters, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(n_clusters))
    ends = np.searchsorted(sorted_assign, np.arange(n_clusters), side="right")
    for c in range(n_clusters):
        members = order[starts[c]:ends[c]]
        lists[c, :len(members)] = members
        lens[c] = len(members)
    return lists, lens, cap


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32[A, B]: ``a`` [A, D] times ``b`` [B, D]^T with ``b`` rounded to
    ``a``'s dtype (the reference's ``cents.T.astype(queries.dtype)``)."""
    return a.to(torch.float32) @ b.to(a.dtype).to(torch.float32).T


def gathered_sims(vecs: torch.Tensor, rows: torch.Tensor,
                  queries: torch.Tensor) -> torch.Tensor:
    """f32[Q, N]: query q against its own rows ``vecs[rows[q]]``, the
    query rounded to the row dtype, products and sums in f32."""
    q = queries.to(vecs.dtype).to(torch.float32)
    return torch.bmm(vecs[rows].to(torch.float32), q[:, :, None])[..., 0]


def probe_clusters(cents, lists, list_lens, queries, nprobe):
    """(probe sims f32[Q, nprobe], candidate rows [Q, nprobe*cap] in the
    lists' dtype, valid bool[Q, nprobe*cap])."""
    q_n = queries.shape[0]
    cap = lists.shape[1]
    csims = dot_f32(queries, cents)                          # [Q, C]
    probe_sims, probe = topk_stable(csims, nprobe)
    cand_flat = lists[probe].reshape(q_n, nprobe * cap)
    pos = torch.arange(cap, device=lists.device)
    valid = (pos[None, None, :] < list_lens[probe][:, :, None]).reshape(
        q_n, nprobe * cap)
    return probe_sims, cand_flat, valid


def _query_chunks(q_n: int, per_query_bytes: int):
    step = max(1, _QUERY_BYTES // max(per_query_bytes, 1))
    return [(lo, min(lo + step, q_n)) for lo in range(0, q_n, step)]


def ivf_search(vecs, cents, lists, list_lens, queries, nprobe: int, k: int):
    """Batched IVF kNN: (scores f32[Q, k], row ids [Q, k] in the lists'
    dtype)."""
    nprobe = min(nprobe, lists.shape[0])
    n = nprobe * lists.shape[1]
    outs = []
    # per query: the gathered rows in their dtype and in f32
    for lo, hi in _query_chunks(queries.shape[0], n * vecs.shape[1] * 6):
        _, cand_flat, valid = probe_clusters(cents, lists, list_lens,
                                             queries[lo:hi], nprobe)
        sims = gathered_sims(vecs, cand_flat.long(), queries[lo:hi])
        sims = sims.masked_fill(~valid, float("-inf"))
        v, i = topk_stable(sims, k)
        outs.append((v, torch.gather(cand_flat, 1, i)))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def adc_lut(codebooks: torch.Tensor, queries: torch.Tensor,
            rotation=None) -> torch.Tensor:
    """f32[Q, M, C]: each query's subspace dot with every code (the ADC
    table); with ``rotation`` the query is taken into the codes' basis
    first."""
    if rotation is not None:
        queries = dot_f32(queries, rotation.T).to(queries.dtype)
    m, c, ds = codebooks.shape
    qsub = queries.to(torch.float32).reshape(queries.shape[0], m, ds)
    return torch.einsum("qmd,mcd->qmc", qsub,
                        codebooks.to(torch.float32))


def adc_gathered(lut: torch.Tensor, codes_rows: torch.Tensor) -> torch.Tensor:
    """f32[Q, N]: sum over m of lut[q, m, codes_rows[q, n, m]], the codes
    of each query's own candidate rows (uint8[Q, N, M])."""
    q_n, n, m = codes_rows.shape
    c = lut.shape[2]
    idx = codes_rows.long() + torch.arange(
        m, device=codes_rows.device) * c                     # [Q, N, M]
    return torch.gather(lut.reshape(q_n, m * c), 1,
                        idx.reshape(q_n, n * m)).reshape(q_n, n, m).sum(-1)


def ivf_pq_search(codes, codebooks, vecs, cents, lists, list_lens, queries,
                  nprobe: int, k: int, expand: int = 10,
                  residual: bool = False, rotation=None):
    """IVF + PQ + exact rerank: probe ``nprobe`` clusters, score their
    members by PQ ADC (M bytes a row instead of 2-4·D), take k·expand
    candidates, rerank those rows exactly. Returns (scores f32[Q, k], row
    ids [Q, k]).

    ``residual=True`` is the FAISS-style variant: codes quantize
    ``v - cents[cluster(v)]`` and the ADC score adds the query-centroid
    dot of the candidate's probed cluster (its probe slot). ``rotation``
    [D, D] is the OPQ basis of the codes: only the ADC table takes the
    rotated query; probe and rerank stay in the raw basis."""
    nprobe = min(nprobe, lists.shape[0])
    cap = lists.shape[1]
    n = nprobe * cap
    m = codebooks.shape[0]
    outs = []
    # per query: the candidates' uint8 codes, their int64 LUT indices
    # and f32 LUT values
    for lo, hi in _query_chunks(queries.shape[0], n * (m * 13 + 16)):
        q = queries[lo:hi]
        probe_sims, cand_flat, valid = probe_clusters(
            cents, lists, list_lens, q, nprobe)
        lut = adc_lut(codebooks, q, rotation)
        # the candidates' codes are gathered once as uint8, then indexed
        adc = adc_gathered(lut, codes[cand_flat.long()])
        if residual:
            # a candidate's cluster is its probe slot: each slot's centroid
            # dot spans its cap columns
            adc = adc + probe_sims[:, :, None].expand(
                -1, -1, cap).reshape(adc.shape)
        adc = adc.masked_fill(~valid, float("-inf"))
        _, ci = topk_stable(adc, min(k * expand, n))
        rows = torch.gather(cand_flat, 1, ci)
        sims = gathered_sims(vecs, rows.long(), q)
        sims = sims.masked_fill(~torch.gather(valid, 1, ci), float("-inf"))
        v, i = topk_stable(sims, k)
        outs.append((v, torch.gather(rows, 1, i)))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def ivf_recall_at_k(vecs_np, cents, lists, lens, queries_np, nprobe,
                    k: int = 10, device="cuda") -> float:
    """Host harness: recall of ``ivf_search`` against exact brute force."""
    put = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    _, ids = ivf_search(put(vecs_np), put(cents), put(lists), put(lens),
                        put(queries_np), nprobe, k)
    exact = np.argsort(-(queries_np @ vecs_np.T), axis=1)[:, :k]
    got = ids.cpu().numpy()
    return float(np.mean(
        [len(set(got[q]) & set(exact[q])) / k for q in range(len(queries_np))]
    ))
