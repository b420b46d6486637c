"""The multi-vector (chunked docs) kNN of the PyTorch port (K6's plain
version on the CPU) against its definition and the JAX package.

K6's table is held against a numpy oracle of the definition (per row the
running relu sum over the earlier rows of its doc, per sub-block its max
and the number of docs whose first positive row lies there), on docs that
cross sub-block and 2048-row block boundaries, with engine-style padding
(pad rows carry doc id 0). ``knn_topk_multivec_with_count`` is held
against the reference's Pallas path (interpret mode): doc ids equal,
values within rtol 1e-4. Its match count is held against the exact count
(docs with a positive row, which the dense path gives): the reference's
phase 1 counts a doc twice when its positive rows straddle a 2048-row
grid block whose first row is not positive, so the reference's count may
exceed the port's by at most the number of docs that straddle a block
boundary."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orama_core_tpu.ops import pallas_knn as ref
from orama_core_tpu_torch.ops import knn as port
from orama_core_tpu_torch.ops.vector import sims_f32


def _chunked(seed, n_docs, m_max, d, block, pad_doc=0, n_valid_all=False):
    rng = np.random.default_rng(seed)
    nch = rng.integers(1, m_max + 1, n_docs)
    docs = np.repeat(np.arange(n_docs, dtype=np.int32), nch)
    n = len(docs)
    n_pad = -(-(n + 1) // block) * block
    vecs = np.zeros((n_pad, d), np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    vecs[:n] = v / np.linalg.norm(v, axis=1, keepdims=True)
    docs_p = np.full(n_pad, pad_doc, np.int32)
    docs_p[:n] = docs
    starts = np.zeros(n_docs + 1, np.int32)
    starts[1:] = np.cumsum(np.bincount(docs, minlength=n_docs))
    return vecs, docs_p, starts, n, rng


def _oracle(sims, docs, n_valid, sub):
    """bmax / bcnt of the definition, one doc run at a time (f64 sums)."""
    n, qn = sims.shape
    seg = np.zeros((n, qn))
    first = np.zeros((n, qn), bool)
    r = 0
    while r < n_valid:
        e = r
        while e < n_valid and docs[e] == docs[r]:
            e += 1
        rel = np.maximum(sims[r:e].astype(np.float64), 0.0)
        seg[r:e] = np.cumsum(rel, axis=0)
        pos = sims[r:e] > 0
        first[r:e] = pos & (np.cumsum(pos, axis=0) == 1)
        r = e
    return (seg.reshape(-1, sub, qn).max(axis=1),
            first.reshape(-1, sub, qn).sum(axis=1))


@pytest.mark.parametrize("m_max,n_docs", [(4, 3000), (8, 1500), (64, 200)])
def test_k6_plain_table_matches_oracle(m_max, n_docs):
    vecs, docs_p, _starts, n, rng = _chunked(m_max, n_docs, m_max, 64, 2048)
    assert n > 2048  # docs cross a 2048-row block boundary
    q = rng.standard_normal((5, 64)).astype(np.float32)
    tv, td, tq = (torch.from_numpy(vecs), torch.from_numpy(docs_p),
                  torch.from_numpy(q))
    bmax, bcnt = port.subblock_max_mv(tv, td, tq, 32, n, m_max)
    sims = sims_f32(tv, tq).numpy()
    want_max, want_cnt = _oracle(sims, docs_p, n, 32)
    np.testing.assert_allclose(bmax.numpy(), want_max, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(bcnt.numpy(), want_cnt)
    # padded sub-blocks: max 0, count 0 (padding scores 0)
    tail = -(-n // 32)
    assert (bmax.numpy()[tail:] == 0).all() and (bcnt.numpy()[tail:] == 0).all()
    # the count is exactly the docs with a positive row
    for j in range(5):
        assert int(bcnt[:, j].sum()) == len(np.unique(docs_p[:n][sims[:n, j] > 0]))


def _exact_counts(vecs, docs, n_valid, queries):
    sims = vecs[:n_valid] @ queries.T
    return np.asarray([len(np.unique(docs[:n_valid][sims[:, j] > 0]))
                       for j in range(len(queries))])


def _straddlers(docs, n_valid, block):
    b = np.arange(block, n_valid, block)
    return int(np.sum(docs[b] == docs[b - 1]))


def _compare(vecs, docs_p, starts, queries, n_valid, n_docs, k, bn, m_max):
    rv, rd, rc = ref.knn_topk_multivec_with_count(
        jnp.asarray(vecs), jnp.asarray(docs_p), jnp.asarray(starts),
        jnp.asarray(queries), k=k, block_rows=bn, m_max=m_max,
        n_valid=n_valid, n_docs=n_docs, interpret=True)
    pv, pd, pc = port.knn_topk_multivec_with_count(
        torch.from_numpy(vecs), torch.from_numpy(docs_p),
        torch.from_numpy(starts), torch.from_numpy(queries), k=k,
        block_rows=bn, m_max=m_max, n_valid=n_valid, n_docs=n_docs)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-4,
                               atol=1e-6)
    exact = _exact_counts(vecs, docs_p, n_valid, queries)
    np.testing.assert_array_equal(pc.numpy(), exact)
    extra = np.asarray(rc) - exact
    assert (extra >= 0).all() and (extra <= _straddlers(docs_p, n_valid, bn)).all()
    return pv.numpy(), pd.numpy()


def test_multivec_matches_reference_adversarial_doc():
    """tests/test_pallas_knn.py:198: a doc of 4 medium chunks whose sum
    beats every single stronger row ranks first."""
    rng = np.random.default_rng(23)
    d = 64
    docs, vecs = [], []
    for i in range(2500):
        nch = 1 + (i % 4)
        v = rng.standard_normal((nch, d)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        vecs.append(v)
        docs += [i] * nch
    q0 = rng.standard_normal(d).astype(np.float32)
    q0 /= np.linalg.norm(q0)
    spread = 0.55 * q0 + 0.85 * rng.standard_normal((4, d)).astype(np.float32)
    spread /= np.linalg.norm(spread, axis=1, keepdims=True)
    vecs[103] = spread.astype(np.float32)
    vecs = np.concatenate(vecs)
    docs = np.array(docs, np.int32)
    n = len(docs)
    p_l = ((n + 511) // 512) * 512
    vecs = np.concatenate([vecs, np.zeros((p_l - n, d), np.float32)])
    docs_p = np.concatenate([docs, np.full(p_l - n, 2499, np.int32)])
    starts = np.zeros(2501, np.int32)
    starts[1:] = np.cumsum(np.bincount(docs, minlength=2500))
    queries = np.stack([q0] + [
        x / np.linalg.norm(x)
        for x in rng.standard_normal((3, d)).astype(np.float32)
    ]).astype(np.float32)
    _v, dk = _compare(vecs, docs_p, starts, queries, p_l, 2500, 10, 512, 4)
    assert dk[0, 0] == 103


@pytest.mark.parametrize("m_max,n_docs,bn", [(8, 4000, 2048), (4, 2500, 512),
                                             (64, 300, 2048)])
def test_multivec_matches_reference_engine_layout(m_max, n_docs, bn):
    """The engine's layout: pad rows carry doc 0, n_valid = real rows."""
    vecs, docs_p, starts, n, rng = _chunked(m_max + 100, n_docs, m_max, 64, bn)
    q = rng.standard_normal((3, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _compare(vecs, docs_p, starts, q, n, n_docs, 10, bn, m_max)


def test_multivec_small_corpus_dense_branch():
    vecs, docs_p, starts, n, rng = _chunked(5, 300, 4, 32, 512)
    assert 10 * 4 * 32 * 4 >= n  # the dense segment-sum branch
    q = rng.standard_normal((2, 32)).astype(np.float32)
    _compare(vecs, docs_p, starts, q, n, 300, 10, 512, 4)
