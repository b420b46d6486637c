"""ops/knn.py of the PyTorch port (the K2 + K3 path, run through the
plain torch versions of its kernels on the CPU) against the JAX package's
ops/pallas_knn.py run in Pallas interpret mode, on the parametrised shapes
of tests/test_pallas_knn.py. Data is continuous random normal, so it is
tie-free: ids must be equal, values within 1e-5, counts equal."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orama_core_tpu.ops import pallas_knn as ref
from orama_core_tpu_torch.ops import knn as port


def _compare(vecs, queries, k, bn, sub, n_valid=-1):
    rv, ri, rc = ref.knn_topk_with_count(
        jnp.asarray(vecs), jnp.asarray(queries), k=k, block_rows=bn,
        sub_rows=sub, interpret=True, n_valid=n_valid,
    )
    pv, pi, pc = port.knn_topk_with_count(
        torch.from_numpy(vecs), torch.from_numpy(queries), k=k,
        block_rows=bn, sub_rows=sub, n_valid=n_valid,
    )
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    pv2, pi2 = port.knn_topk(
        torch.from_numpy(vecs), torch.from_numpy(queries), k=k,
        block_rows=bn, sub_rows=sub, n_valid=n_valid,
    )
    np.testing.assert_array_equal(pi2.numpy(), pi.numpy())
    return pv.numpy(), pi.numpy()


@pytest.mark.parametrize(
    "n,d,q,k,bn,sub",
    [
        (8192, 128, 8, 4, 512, 128),   # K2 + K3 path
        (4096, 64, 16, 3, 256, 128),   # K2 + K3, smaller blocks
        (1024, 128, 8, 10, 256, 256),  # dense small-corpus branch
    ],
)
def test_knn_matches_reference(n, d, q, k, bn, sub):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    _compare(vecs, queries, k, bn, sub)


def test_knn_padding_mask_matches_reference():
    rng = np.random.default_rng(7)
    n_valid, n_pad, d, q, k = 5000, 8192, 64, 4, 5
    vecs = np.full((n_pad, d), 10.0, np.float32)  # poisoned padding
    vecs[:n_valid] = rng.standard_normal((n_valid, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    _v, ids = _compare(vecs, queries, k, 512, 128, n_valid=n_valid)
    assert (ids < n_valid).all()


def test_knn_descending_order_matches_reference():
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((4096, 32)).astype(np.float32)
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    v, _ = _compare(vecs, queries, 8, 256, 128)
    assert (np.diff(v, axis=1) <= 1e-6).all()


def test_knn_with_count_matches_reference():
    rng = np.random.default_rng(11)
    n_valid, n, d, q, k = 7000, 8192, 64, 8, 5
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs[n_valid:] = 50.0  # poisoned padding: must not count or rank
    queries = rng.standard_normal((q, d)).astype(np.float32)
    _compare(vecs, queries, k, 512, 64, n_valid=n_valid)


def test_knn_bf16_corpus_matches_reference():
    """The engine's layout: a bf16 corpus and bf16 queries, sub = 32."""
    rng = np.random.default_rng(13)
    n, d, q, k = 8192, 128, 4, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    rv, ri, rc = ref.knn_topk_with_count(
        jnp.asarray(vecs, jnp.bfloat16), jnp.asarray(queries, jnp.bfloat16),
        k=k, block_rows=2048, interpret=True, n_valid=8000,
    )
    pv, pi, pc = port.knn_topk_with_count(
        torch.from_numpy(vecs).to(torch.bfloat16),
        torch.from_numpy(queries).to(torch.bfloat16), k=k, block_rows=2048,
        n_valid=8000,
    )
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))


def test_tiered_subblock_topk_exact():
    """The port's recursive block-max selection returns exactly the value
    set of a plain top-k, and the reference's ids on tie-free tables
    (tests/test_pallas_knn.py:252, including its duplicated row)."""
    rng = np.random.default_rng(31)
    for n, qn, k in ((1000, 8, 10), (4096, 16, 5), (513, 8, 12),
                     (129, 8, 3), (40960, 8, 17)):
        x = rng.standard_normal((n, qn)).astype(np.float32)
        x[n // 3] = x[n // 2]
        ids = port._tiered_subblock_topk(torch.from_numpy(x), k).numpy()
        vals = np.sort(x, axis=0)[::-1][: min(k, n)]
        for q in range(qn):
            got = np.sort(x[ids[q], q])[::-1]
            np.testing.assert_array_equal(got, vals[:, q])
        y = rng.standard_normal((n, qn)).astype(np.float32)  # tie-free
        np.testing.assert_array_equal(
            port._tiered_subblock_topk(torch.from_numpy(y), k).numpy(),
            np.asarray(ref._tiered_subblock_topk(jnp.asarray(y), k)),
        )


def test_topk_stable_breaks_ties_toward_lower_index():
    import jax

    from orama_core_tpu_torch.ops.topk import topk_stable

    rng = np.random.default_rng(2)
    x = rng.integers(0, 5, (3, 200)).astype(np.float32)  # many ties
    for k in (1, 7, 50, 200):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = topk_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))

