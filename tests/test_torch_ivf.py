"""ops/ivf.py of the PyTorch port against the JAX package's ops/ivf.py on
the CPU, at small sizes (a few thousand rows, D = 32-64).

Functions are held against the reference on the same inputs: Lloyd steps
from the same centroids (assignments equal, centroids within 1e-5), the
list packing (equal), the skew split with the same rng (equal
assignments, centroids within 1e-5), and the searches on the reference's
own trained arrays (``CommittedVectorIndex.build_*().to_arrays()``, loaded
by the port's ``from_arrays``): equal ids on tie-free inputs, scores
within 1e-5 relative for f32 rows and 2e-3 absolute for bf16 rows.

Initial centroids cannot match (the reference draws them with
``jax.random``), so the port's own index builds are held by quality, as
tests/test_ann.py holds the reference's: clusters separate data, every
row sits in its argmax list, recall against brute force."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orama_core_tpu.index.vector_index import CommittedVectorIndex as RefIndex
from orama_core_tpu.ops import ivf as ref
from orama_core_tpu_torch.index.vector_index import (
    CommittedVectorIndex as PortIndex,
)
from orama_core_tpu_torch.ops import ivf as port


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _clustered(p=4000, d=64, n_modes=40, n_q=16, seed=0):
    """tests/test_ann.py's Gaussian-mixture corpus and near-duplicate
    queries."""
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((n_modes, d)).astype(np.float32)
    which = rng.integers(0, n_modes, p)
    v = _unit(modes[which] + 0.15 * rng.standard_normal((p, d)))
    qi = rng.integers(0, p, n_q)
    q = _unit(v[qi] + 0.05 * rng.standard_normal((n_q, d)))
    return v, q


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _recall(got, gt):
    k = gt.shape[1]
    return float(np.mean([len(set(got[i]) & set(gt[i])) / k
                          for i in range(len(gt))]))


# -- functions against the reference on the same inputs ----------------------


@pytest.mark.parametrize("spherical", [True, False])
def test_kmeans_refine_matches_reference(spherical):
    v, _ = _clustered(3000, 32, seed=1)
    rng = np.random.default_rng(2)
    init = v[rng.choice(len(v), 24, replace=False)].copy()
    if not spherical:
        init *= 0.7                                  # Euclidean codebooks
    want = np.asarray(ref.kmeans_refine(jnp.asarray(v), jnp.asarray(init),
                                        iters=4, spherical=spherical))
    got = port.kmeans_refine(_t(v), _t(init), iters=4, spherical=spherical)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the next assignment from either set of centroids is the same
    np.testing.assert_array_equal(
        port.assign_clusters(_t(v), got).numpy(),
        np.asarray(ref.assign_clusters(jnp.asarray(v), jnp.asarray(want))))


@pytest.mark.parametrize("chunk", [1_000_000, 700])
def test_assign_clusters_matches_reference(chunk):
    v, _ = _clustered(2500, 48, seed=3)
    cents = v[:20]
    want = ref.assign_clusters_chunked(jnp.asarray(v), jnp.asarray(cents),
                                       chunk=chunk)
    got = port.assign_clusters_chunked(_t(v), _t(cents), chunk=chunk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_build_ivf_lists_matches_reference():
    rng = np.random.default_rng(4)
    assign = np.concatenate([np.zeros(300, np.int32),
                             rng.integers(0, 9, 700).astype(np.int32)])
    rng.shuffle(assign)
    want = ref.build_ivf_lists(assign, 10)          # cluster 9 stays empty
    got = port.build_ivf_lists(assign, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def _skewed_inputs():
    """tests/test_ann.py's giant blob: centroid 0 owns 3,000 of 4,000 rows."""
    rng = np.random.default_rng(5)
    d, p_blob, p_rest = 32, 3000, 1000
    blob_c = rng.standard_normal(d).astype(np.float32)
    blob = blob_c[None, :] + 0.05 * rng.standard_normal((p_blob, d))
    rest = rng.standard_normal((p_rest, d)).astype(np.float32)
    v = _unit(np.concatenate([blob, rest]))
    cents = np.concatenate([_unit(blob_c[None, :]), _unit(rest[:7])])
    return v, cents.astype(np.float32), 4 * len(v) // 8, {}


def _duplicate_inputs():
    rng = np.random.default_rng(2)
    dup = rng.standard_normal(16).astype(np.float32)
    v = _unit(np.concatenate([np.tile(dup, (500, 1)),
                              rng.standard_normal((100, 16))]))
    return v, np.concatenate([v[:1], v[500:503]]), 100, {"rounds": 5}


@pytest.mark.parametrize("case", ["skewed", "duplicates", "refine"])
def test_split_skewed_matches_reference(case):
    v, cents, target, kw = (_duplicate_inputs() if case == "duplicates"
                            else _skewed_inputs())
    if case == "refine":
        kw = {"refine_iters": 2}
    assign = ref.assign_clusters_chunked(jnp.asarray(v), jnp.asarray(cents))
    want_c, want_a = ref.split_skewed(
        jnp.asarray(v), jnp.asarray(cents), assign.copy(), target=target,
        rng=np.random.default_rng(1), **kw)
    got_c, got_a = port.split_skewed(
        _t(v), _t(cents), assign.copy(), target=target,
        rng=np.random.default_rng(1), **kw)
    np.testing.assert_array_equal(got_a, np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)
    if case == "skewed":
        assert got_c.shape[0] > 8


def _ref_trained(v, pq: bool, seed=0):
    """The reference's trained IVF (and residual PQ) arrays, loaded by the
    port's ``from_arrays``."""
    idx = RefIndex(dimension=v.shape[1], vecs=v,
                   vec_docs=np.arange(len(v), dtype=np.int32))
    idx.build_ivf(seed=seed)
    if pq:
        idx.build_pq(rotate=True, seed=seed)
    return idx, PortIndex.from_arrays(idx.to_arrays())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_search_on_reference_arrays(dtype):
    v, q = _clustered(3000, 64, n_q=12, seed=6)
    ref_idx, pidx = _ref_trained(v, pq=False)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want_s, want_i = ref.ivf_search(
        jnp.asarray(v, jdt), jnp.asarray(ref_idx.ivf_cents),
        jnp.asarray(ref_idx.ivf_lists), jnp.asarray(ref_idx.ivf_lens),
        jnp.asarray(q), nprobe=4, k=10)
    got_s, got_i = port.ivf_search(
        _t(pidx.vecs, tdt), _t(pidx.ivf_cents), _t(pidx.ivf_lists),
        _t(pidx.ivf_lens), _t(q), nprobe=4, k=10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if dtype == "float32":
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   atol=2e-3)


@pytest.mark.parametrize("residual,rotate", [(True, True), (False, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_pq_search_on_reference_arrays(residual, rotate, dtype):
    from orama_core_tpu.ops import pq as ref_pq

    v, q = _clustered(3000, 32, n_q=12, seed=7)
    ref_idx, pidx = _ref_trained(v, pq=True)
    if not residual:
        # flat codes over the same lists: the non-residual ADC branch
        books = ref_pq.pq_train(jnp.asarray(v), jax.random.PRNGKey(3), m=4,
                                n_codes=64, iters=4)
        codes, books = np.asarray(ref_pq.pq_encode(jnp.asarray(v), books)), \
            np.asarray(books)
    else:
        codes, books = ref_idx.pq_codes, ref_idx.pq_codebooks
    rot = ref_idx.pq_rotation if rotate else None
    assert (rot is not None) == rotate
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want_s, want_i = ref.ivf_pq_search(
        jnp.asarray(codes), jnp.asarray(books), jnp.asarray(v, jdt),
        jnp.asarray(ref_idx.ivf_cents), jnp.asarray(ref_idx.ivf_lists),
        jnp.asarray(ref_idx.ivf_lens), jnp.asarray(q), nprobe=4, k=10,
        expand=5, residual=residual,
        rotation=None if rot is None else jnp.asarray(rot))
    got_s, got_i = port.ivf_pq_search(
        _t(codes), _t(books), _t(pidx.vecs, getattr(torch, dtype)),
        _t(pidx.ivf_cents), _t(pidx.ivf_lists), _t(pidx.ivf_lens), _t(q),
        nprobe=4, k=10, expand=5, residual=residual,
        rotation=None if rot is None else _t(rot))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    tol = {"rtol": 1e-5} if dtype == "float32" else {"atol": 2e-3}
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)


def test_query_chunks_do_not_change_results(monkeypatch):
    """Cutting a query batch into chunks (the 1 GiB working-set bound)
    gives each query the result it gets in the whole batch: the same ids,
    scores within f32 rounding (a batched product may sum in another
    order)."""
    v, q = _clustered(2000, 32, n_q=9, seed=8)
    _, pidx = _ref_trained(v, pq=True)
    args = (_t(pidx.pq_codes), _t(pidx.pq_codebooks), _t(v),
            _t(pidx.ivf_cents), _t(pidx.ivf_lists), _t(pidx.ivf_lens), _t(q))
    whole = port.ivf_pq_search(*args, nprobe=3, k=10, expand=4,
                               residual=True)
    flat = port.ivf_search(_t(v), *args[3:], nprobe=3, k=10)
    monkeypatch.setattr(port, "_QUERY_BYTES", 1)     # one query per chunk
    for want, got in ((whole, port.ivf_pq_search(
            *args, nprobe=3, k=10, expand=4, residual=True)),
            (flat, port.ivf_search(_t(v), *args[3:], nprobe=3, k=10))):
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                   rtol=1e-6)


def test_masked_slots_rank_last():
    """A probe that holds fewer members than k fills with -inf, after
    every real candidate (lax.top_k's order)."""
    v, q = _clustered(600, 32, n_q=3, seed=9)
    cents = v[:2]
    lists, lens, _ = port.build_ivf_lists(
        port.assign_clusters_chunked(_t(v), _t(cents)), 2)
    s, i = port.ivf_search(_t(v), _t(cents), _t(lists), _t(lens), _t(q),
                           nprobe=1, k=lists.shape[1])
    s = s.numpy()
    for row in range(3):
        n_real = int(np.isfinite(s[row]).sum())
        assert np.all(np.isneginf(s[row, n_real:]))
        assert np.all(np.diff(s[row, :n_real]) <= 0)


# -- the port's own index builds, by quality ---------------------------------


def test_kmeans_clusters_separate_data():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((200, 16)) * 0.05 + np.eye(16)[0]
    b = rng.standard_normal((200, 16)) * 0.05 + np.eye(16)[1]
    v = _unit(np.concatenate([a, b]))
    cents = port.kmeans(_t(v), torch.Generator().manual_seed(0), 2, iters=8)
    assign = port.assign_clusters(_t(v), cents).numpy()
    assert len(set(assign[:200])) == 1 and len(set(assign[200:])) == 1
    assert assign[0] != assign[250]


def test_kmeans_draws_from_the_generator():
    v, _ = _clustered(1000, 32, seed=2)
    c1 = port.kmeans(_t(v), torch.Generator().manual_seed(3), 8, iters=2)
    c2 = port.kmeans(_t(v), torch.Generator().manual_seed(3), 8, iters=2)
    c3 = port.kmeans(_t(v), torch.Generator().manual_seed(4), 8, iters=2)
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())
    assert not np.array_equal(c1.numpy(), c3.numpy())
    # more clusters than rows: drawn with replacement
    few = port.kmeans(_t(v[:5]), torch.Generator().manual_seed(0), 8,
                      iters=1)
    assert few.shape == (8, 32) and bool(torch.isfinite(few).all())


def test_ivf_search_recall():
    v, q = _clustered()
    cents = port.kmeans(_t(v), torch.Generator().manual_seed(0), 32,
                        iters=10)
    assign = port.assign_clusters_chunked(_t(v), cents)
    lists, lens, _ = port.build_ivf_lists(assign, 32)
    assert port.ivf_recall_at_k(v, cents, lists, lens, q, nprobe=8,
                                device="cpu") >= 0.95
    assert port.ivf_recall_at_k(v, cents, lists, lens, q, nprobe=2,
                                device="cpu") >= 0.5


def test_split_skewed_bounds_giant_cluster():
    v, cents, target, _ = _skewed_inputs()
    assign = port.assign_clusters_chunked(_t(v), _t(cents))
    assert np.bincount(assign, minlength=8).max() >= 3000
    c2, a2 = port.split_skewed(_t(v), _t(cents), assign, target=target,
                               rng=np.random.default_rng(1))
    counts = np.bincount(a2, minlength=int(c2.shape[0]))
    assert int(c2.shape[0]) > 8 and counts.max() <= target
    am = (v @ c2.numpy().T).argmax(axis=1)
    np.testing.assert_array_equal(am, a2)


def test_build_ivf_every_row_in_its_argmax_list():
    v, _ = _clustered(3000, 32, seed=10)
    idx = PortIndex(dimension=32, vecs=v,
                    vec_docs=np.arange(3000, dtype=np.int32))
    idx.build_ivf(device="cpu")
    am = (v @ idx.ivf_cents.T).argmax(axis=1)
    seen = np.zeros(3000, bool)
    for c in range(idx.ivf_lists.shape[0]):
        rows = idx.ivf_lists[c, :idx.ivf_lens[c]]
        assert np.all(am[rows] == c)
        seen[rows] = True
    assert seen.all()
    assert idx.ivf_lists.shape[1] % 128 == 0
    assert idx.ivf_cents.dtype == np.float32 and idx.ivf_lists.dtype == np.int32


def test_build_ivf_and_autotune_reach_target():
    """``tune_nprobe`` on the port's own IVF: the tuned nprobe is the first
    power of two whose recall@10 on the tuner's sample (perturbed corpus
    rows, drawn as the reference draws them) reaches the target, and the
    tuned values persist through the arrays."""
    rng = np.random.default_rng(0)
    n, d = 12_000, 64
    modes = _unit(rng.standard_normal((50, d)))
    vecs = _unit(modes[rng.integers(0, 50, n)]
                 + 0.15 * rng.standard_normal((n, d)))
    idx = PortIndex(dimension=d, vecs=vecs,
                    vec_docs=np.arange(n, dtype=np.int32))
    idx.build_ivf(device="cpu")
    tuned = idx.tune_nprobe(k=10, target_recall=0.95, n_sample=64,
                            device="cpu")
    assert tuned is not None and tuned == idx.tuned_nprobe
    srng = np.random.default_rng(7)
    rows = srng.choice(n, size=64, replace=False)
    q = vecs[rows] + 0.05 * srng.standard_normal((64, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.argsort(-(q @ vecs.T), axis=1)[:, :10]

    def recall(nprobe):
        _, ids = port.ivf_search(_t(vecs), _t(idx.ivf_cents),
                                 _t(idx.ivf_lists), _t(idx.ivf_lens), _t(q),
                                 nprobe=nprobe, k=10)
        return _recall(ids.numpy(), gt)

    assert recall(tuned) >= 0.95
    if tuned > 1:
        assert recall(tuned // 2) < 0.95
    again = PortIndex.from_arrays(idx.to_arrays())
    assert again.tuned_nprobe == tuned and again.has_ivf
    np.testing.assert_array_equal(again.ivf_lists, idx.ivf_lists)
