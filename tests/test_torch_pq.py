"""ops/pq.py of the PyTorch port against the JAX package's ops/pq.py on the
CPU, at small sizes (a few thousand rows, D = 32-64, M <= 8).

On the same inputs: ``pq_encode`` gives equal codes for the same
codebooks; ``pq_reconstruct`` and ``residuals`` agree within 1e-6;
``opq_rotation`` is orthonormal within 1e-5 with per-subspace projectors
``R_b R_bᵀ`` within 1e-4 of the reference's (an eigenvector is fixed only
up to its sign); ``choose_rotation`` makes the reference's decision on the
corpora of tests/test_vector_modes.py; ``pq_topk`` and ``pq_topk_rerank``
on the reference's trained arrays give equal ids, scores within 1e-5
relative (f32) or 2e-3 absolute (bf16 rows). The port's own training is
held by quality, with the reference tests' recall bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orama_core_tpu.index.vector_index import CommittedVectorIndex as RefIndex
from orama_core_tpu.ops import ivf as ref_ivf
from orama_core_tpu.ops import pq as ref
from orama_core_tpu_torch.index.vector_index import (
    CommittedVectorIndex as PortIndex,
)
from orama_core_tpu_torch.ops import ivf as port_ivf
from orama_core_tpu_torch.ops import pq as port


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _clustered(p=2000, d=64, n_modes=40, n_q=16, seed=0):
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((n_modes, d)).astype(np.float32)
    v = _unit(modes[rng.integers(0, n_modes, p)]
              + 0.15 * rng.standard_normal((p, d)))
    q = _unit(v[rng.integers(0, p, n_q)] + 0.05 * rng.standard_normal((n_q, d)))
    return v, q


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _recall(got, gt):
    k = gt.shape[1]
    return float(np.mean([len(set(got[i]) & set(gt[i])) / k
                          for i in range(len(gt))]))


def _ref_books(v, m, n_codes=64, iters=6, seed=0):
    return np.asarray(ref.pq_train(jnp.asarray(v), jax.random.PRNGKey(seed),
                                   m=m, n_codes=n_codes, iters=iters))


# -- functions against the reference on the same inputs ----------------------


@pytest.mark.parametrize("m", [4, 8])
def test_pq_encode_and_reconstruct_match_reference(m):
    v, _ = _clustered(3000, 32, seed=1)
    books = _ref_books(v, m)
    want = np.asarray(ref.pq_encode(jnp.asarray(v), jnp.asarray(books)))
    got = port.pq_encode(_t(v), _t(books))
    assert got.dtype == torch.uint8 and got.shape == (3000, m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        port.pq_reconstruct(got, _t(books)).numpy(),
        np.asarray(ref.pq_reconstruct(jnp.asarray(want), jnp.asarray(books))),
        atol=1e-6)


def test_residuals_match_reference():
    v, _ = _clustered(2000, 32, seed=2)
    cents = v[:16]
    assign = ref_ivf.assign_clusters_chunked(jnp.asarray(v),
                                             jnp.asarray(cents))
    want = np.asarray(ref.residuals(jnp.asarray(v), jnp.asarray(cents),
                                    jnp.asarray(assign)))
    got = port.residuals(_t(v), _t(cents), _t(assign))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _projectors(r, m):
    ds = r.shape[0] // m
    return [r[:, b * ds:(b + 1) * ds] @ r[:, b * ds:(b + 1) * ds].T
            for b in range(m)]


@pytest.mark.parametrize("m", [4, 8])
def test_opq_rotation_matches_reference(m):
    rng = np.random.default_rng(5)
    decay = (0.9 ** np.arange(32)).astype(np.float32) * 3.0
    vecs = (rng.standard_normal((2000, 32)) * decay).astype(np.float32)
    want = ref.opq_rotation(jnp.asarray(vecs), m=m)
    got = port.opq_rotation(_t(vecs), m=m)
    assert got.shape == (32, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got @ got.T, np.eye(32), atol=1e-5)
    for pg, pw in zip(_projectors(got, m), _projectors(want, m)):
        np.testing.assert_allclose(pg, pw, atol=1e-4)


def _corpus_correlated():
    """tests/test_vector_modes.py's corpus A: a decaying spectrum mixed by
    a random orthonormal matrix (the PCA basis loses)."""
    rng = np.random.default_rng(9)
    n, d = 12_000, 64
    decay = (0.97 ** np.arange(d)).astype(np.float32) * 3.0
    mix, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    z = rng.standard_normal((n, d)).astype(np.float32)
    return _unit((z * decay[None, :]) @ mix.astype(np.float32))


def _corpus_lexical():
    """tests/test_vector_modes.py's corpus B: lexical-embedder vectors
    (the rotation helps)."""
    from orama_core_tpu.models.lexical import LexicalEmbedder

    topics = ["solar energy", "bread baking", "tpu kernels",
              "ocean biology", "violin music", "alpine skiing"]
    texts = [f"{topics[i % 6]} document number {i} with extra "
             f"{topics[(i // 6) % 6]} words" for i in range(4000)]
    return np.asarray(LexicalEmbedder(64).embed(texts), np.float32)


@pytest.mark.parametrize("corpus", ["correlated", "lexical"])
def test_choose_rotation_same_decision(corpus):
    v = _corpus_correlated() if corpus == "correlated" else _corpus_lexical()
    want = ref.choose_rotation(jnp.asarray(v), 8, jax.random.PRNGKey(0))
    got = port.choose_rotation(_t(v), 8, seed=0)
    assert (got is None) == (want is None)
    assert (got is None) == (corpus == "correlated")
    if got is not None:
        np.testing.assert_allclose(got @ got.T, np.eye(64), atol=1e-5)


@pytest.mark.parametrize("rotate", [False, True])
def test_pq_topk_on_reference_arrays(rotate):
    v, q = _clustered(2500, 32, seed=3)
    idx = RefIndex(dimension=32, vecs=v,
                   vec_docs=np.arange(len(v), dtype=np.int32))
    idx.build_pq(rotate=rotate)
    pidx = PortIndex.from_arrays(idx.to_arrays())
    assert (pidx.pq_rotation is not None) == rotate and not pidx.pq_residual
    valid = np.ones(len(v), np.float32)
    valid[[5, 17]] = 0.0                           # masked rows rank last
    rot_j = None if idx.pq_rotation is None else jnp.asarray(idx.pq_rotation)
    rot_t = None if pidx.pq_rotation is None else _t(pidx.pq_rotation)
    want_s, want_i = ref.pq_topk(
        jnp.asarray(idx.pq_codes), jnp.asarray(idx.pq_codebooks),
        jnp.asarray(valid), jnp.asarray(q), k=20, rotation=rot_j)
    got_s, got_i = port.pq_topk(
        _t(pidx.pq_codes), _t(pidx.pq_codebooks), _t(valid), _t(q), k=20,
        rotation=rot_t)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pq_topk_rerank_on_reference_arrays(dtype):
    v, q = _clustered(2500, 32, seed=4)
    idx = RefIndex(dimension=32, vecs=v,
                   vec_docs=np.arange(len(v), dtype=np.int32))
    idx.build_pq(rotate=True)
    pidx = PortIndex.from_arrays(idx.to_arrays())
    valid = np.ones(len(v), np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want_s, want_i = ref.pq_topk_rerank(
        jnp.asarray(idx.pq_codes), jnp.asarray(idx.pq_codebooks),
        jnp.asarray(v, jdt), jnp.asarray(valid), jnp.asarray(q), k=10,
        expand=8, rotation=jnp.asarray(idx.pq_rotation))
    got_s, got_i = port.pq_topk_rerank(
        _t(pidx.pq_codes), _t(pidx.pq_codebooks),
        _t(pidx.vecs, getattr(torch, dtype)), _t(valid), _t(q), k=10,
        expand=8, rotation=_t(pidx.pq_rotation))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    tol = {"rtol": 1e-5} if dtype == "float32" else {"atol": 2e-3}
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)


def test_equal_codes_tie_toward_the_lower_row():
    """Rows with equal codes have exactly equal ADC scores; the top-k keeps
    them in row order, as lax.top_k does."""
    v, q = _clustered(400, 32, seed=5)
    books = _ref_books(v, 4, n_codes=16)
    codes = np.array(ref.pq_encode(jnp.asarray(v), jnp.asarray(books)))
    codes[100:110] = codes[3]                      # ten copies of row 3
    valid = np.ones(400, np.float32)
    want_s, want_i = ref.pq_topk(jnp.asarray(codes), jnp.asarray(books),
                                 jnp.asarray(valid), jnp.asarray(q[:4]), k=40)
    got_s, got_i = port.pq_topk(_t(codes), _t(books), _t(valid), _t(q[:4]),
                                k=40)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)


def test_pq_compression_ratio():
    assert port.pq_compression_ratio(768, 96) == 32.0


# -- the port's own training, by quality --------------------------------------


def test_pq_train_roundtrip_and_topk():
    """tests/test_ann.py's bars: raw ADC recall@10 >= 0.15 (~40x chance),
    ADC candidates + exact rerank >= 0.9."""
    v, q = _clustered(2000)
    books = port.pq_train(_t(v), torch.Generator().manual_seed(0), m=16,
                          n_codes=64, iters=6)
    assert books.shape == (16, 64, 4) and books.dtype == torch.float32
    codes = port.pq_encode(_t(v), books)
    assert codes.shape == (2000, 16) and codes.dtype == torch.uint8
    valid = torch.ones(2000)
    gt = np.argsort(-(q @ v.T), axis=1)[:, :10]
    _, ids = port.pq_topk(codes, books, valid, _t(q), k=10)
    assert _recall(ids.numpy(), gt) >= 0.15
    _, ids_rr = port.pq_topk_rerank(codes, books, _t(v), valid, _t(q), k=10,
                                    expand=10)
    assert _recall(ids_rr.numpy(), gt) >= 0.9


def test_residual_pq_beats_flat_at_dense_clusters():
    """tests/test_vector_modes.py's dense-cluster corpus on the port's own
    k-means and PQ: residual IVF-PQ >= 0.9 and beats flat by > 0.1."""
    rng = np.random.default_rng(1)
    n, d, n_modes, n_q, k = 30_000, 96, 8, 24, 10
    modes = _unit(rng.standard_normal((n_modes, d)))
    vecs = modes[rng.integers(0, n_modes, n)] + 0.25 / np.sqrt(d) * \
        rng.standard_normal((n, d)).astype(np.float32)
    vecs = _unit(vecs)
    bases = vecs[-n_q:].copy()
    for j in range(n_q):
        blk = bases[j] + 0.12 / np.sqrt(d) * rng.standard_normal(
            (10, d)).astype(np.float32)
        vecs[j * 10:(j + 1) * 10] = _unit(blk)
    q = _unit(bases + 0.05 / np.sqrt(d) * rng.standard_normal((n_q, d)))
    gt = np.argsort(-(q @ vecs.T), axis=1)[:, :k]
    v = _t(vecs)
    cents = port_ivf.kmeans(v, torch.Generator().manual_seed(0), 16, iters=8)
    assign = port_ivf.assign_clusters_chunked(v, cents)
    lists, lens, _ = port_ivf.build_ivf_lists(assign, 16)

    def recall(residual):
        train = port.residuals(v, cents, _t(assign)) if residual else v
        books = port.pq_train(train, torch.Generator().manual_seed(1),
                              m=d // 8)
        codes = port.pq_encode(train, books)
        _, ids = port_ivf.ivf_pq_search(
            codes, books, v, cents, _t(lists), _t(lens), _t(q), nprobe=8,
            k=k, expand=30, residual=residual)
        return _recall(ids.numpy(), gt)

    r_flat, r_res = recall(False), recall(True)
    assert r_res >= 0.9, (r_flat, r_res)
    assert r_res > r_flat + 0.1, (r_flat, r_res)


def test_ivf_pq_build_autotune_and_recall():
    """tests/test_vector_modes.py's IVF-PQ bar on the port's own index builds:
    recall@10 >= 0.95 on fresh queries at the tuned nprobe and expand,
    residual codes, and the tuned values round-trip the arrays."""
    rng = np.random.default_rng(0)
    n, d = 20_000, 64
    cents = _unit(rng.standard_normal((50, d)))
    vecs = _unit(cents[rng.integers(0, 50, n)]
                 + 0.15 * rng.standard_normal((n, d)))
    idx = PortIndex(dimension=d, vecs=vecs,
                    vec_docs=np.arange(n, dtype=np.int32))
    idx.build_ivf(device="cpu")
    idx.build_pq(device="cpu")
    assert idx.pq_residual and idx.pq_codes.dtype == np.uint8
    assert idx.pq_codebooks.shape == (8, 256, 8)
    tuned = idx.tune_nprobe(k=10, target_recall=0.95, n_sample=64,
                            device="cpu")
    assert tuned is not None and tuned >= 1
    q = _unit(vecs[rng.choice(n, 32, replace=False)]
              + 0.05 * rng.standard_normal((32, d)))
    gt = np.argsort(-(q @ vecs.T), axis=1)[:, :10]
    _, ids = port_ivf.ivf_pq_search(
        _t(idx.pq_codes), _t(idx.pq_codebooks), _t(vecs), _t(idx.ivf_cents),
        _t(idx.ivf_lists), _t(idx.ivf_lens), _t(q), nprobe=tuned, k=10,
        expand=idx.tuned_expand, residual=True,
        rotation=None if idx.pq_rotation is None else _t(idx.pq_rotation))
    assert _recall(ids.numpy(), gt) >= 0.95
    again = PortIndex.from_arrays(idx.to_arrays())
    assert (again.tuned_nprobe, again.tuned_expand) == (tuned,
                                                        idx.tuned_expand)
    assert again.pq_residual


def test_build_pq_rotation_forced_and_persisted():
    rng = np.random.default_rng(5)
    vecs = _unit(rng.standard_normal((2000, 32)))
    idx = PortIndex(dimension=32, vecs=vecs,
                    vec_docs=np.arange(2000, dtype=np.int32))
    idx.build_pq(m=4, rotate=True, device="cpu")
    assert idx.pq_rotation is not None
    np.testing.assert_allclose(idx.pq_rotation @ idx.pq_rotation.T,
                               np.eye(32), atol=1e-5)
    again = PortIndex.from_arrays(idx.to_arrays())
    np.testing.assert_array_equal(again.pq_rotation, idx.pq_rotation)
    np.testing.assert_array_equal(again.pq_codes, idx.pq_codes)
    idx.build_pq(m=4, rotate=False, device="cpu")
    assert idx.pq_rotation is None and idx.pq_codes.shape == (2000, 4)
