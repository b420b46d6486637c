"""The int8 kNN of the PyTorch port (K5's plain version on the CPU)
against the JAX package: K5's phase-1 table equals a numpy int64 oracle
and the reference's Pallas kernel (interpret mode) exactly, and
``knn_topk_int8`` / ``knn_topk_int8_with_count`` match the reference's
Pallas path (interpret mode) and its XLA phase-1 variant
``knn_topk_int8_xla_with_count``: ids equal on tie-free inputs, values
within rtol 1e-6, counts equal. The entry points' width (64 queries, and
65 and 256, which take more than one of K5's query passes) is held at a
small corpus."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from orama_core_tpu.ops import pallas_knn as ref
from orama_core_tpu.ops import quant as ref_quant
from orama_core_tpu_torch.ops import knn as port
from orama_core_tpu_torch.ops import quant as port_quant


def _corpus(seed, n, d, q):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    codes, scales = ref_quant.quantize_int8(jnp.asarray(vecs))
    return codes, scales, queries


@pytest.mark.parametrize("n_valid,sub", [(8192, 32), (6001, 32), (5000, 64)])
def test_k5_plain_table_matches_int64_oracle(n_valid, sub):
    codes, scales, queries = _corpus(1, 8192, 384, 8)
    c = np.array(codes)
    s = np.array(scales)
    q8, _ = port_quant.quantize_int8(torch.from_numpy(queries))
    bmax, bcnt = port.subblock_max_int8(
        torch.from_numpy(c), torch.from_numpy(s), q8, sub, n_valid)
    acc = c.astype(np.int64) @ q8.numpy().astype(np.int64).T     # exact
    sims = acc.astype(np.float32) * s[:, None]                   # one rounding
    sims[n_valid:] = port.NEG
    s3 = sims.reshape(-1, sub, 8)
    np.testing.assert_array_equal(bmax.numpy(), s3.max(axis=1))
    np.testing.assert_array_equal(bcnt.numpy(), (s3 > 0).sum(axis=1))
    assert (bmax.numpy()[-(-n_valid // sub):] == port.NEG).all()


def _port_int8(codes, scales, queries, **kw):
    return port.knn_topk_int8_with_count(
        torch.from_numpy(np.array(codes)),
        torch.from_numpy(np.array(scales)), torch.from_numpy(queries), **kw)


@pytest.mark.parametrize(
    "n,d,q,k,bn,sub,n_valid",
    [
        (8192, 64, 8, 4, 512, 128, -1),     # test_pallas_knn.py:62
        (8192, 64, 8, 5, 512, 64, 7000),    # test_pallas_knn.py:124
        (8192, 128, 3, 16, 2048, 32, 8000),  # the engine's block and sub
        (2048, 64, 4, 10, 512, 128, 2000),  # small-corpus dense branch
    ],
)
def test_knn_int8_matches_reference(n, d, q, k, bn, sub, n_valid):
    codes, scales, queries = _corpus(n + d, n, d, q)
    rv, ri, rc = ref.knn_topk_int8_with_count(
        codes, scales, jnp.asarray(queries), k=k, block_rows=bn,
        sub_rows=sub, interpret=True, n_valid=n_valid)
    pv, pi, pc = _port_int8(codes, scales, queries, k=k, block_rows=bn,
                            sub_rows=sub, n_valid=n_valid)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    ov, oi = ref.knn_topk_int8(codes, scales, jnp.asarray(queries), k=k,
                               block_rows=bn, sub_rows=sub, interpret=True,
                               n_valid=n_valid)
    tv, ti = port.knn_topk_int8(
        torch.from_numpy(np.array(codes)),
        torch.from_numpy(np.array(scales)), torch.from_numpy(queries), k=k,
        block_rows=bn, sub_rows=sub, n_valid=n_valid)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(oi))
    np.testing.assert_allclose(tv.numpy(), np.asarray(ov), rtol=1e-6)


@pytest.mark.parametrize("n_valid", [7900, 8192])
def test_knn_int8_matches_reference_xla_phase1(n_valid):
    """test_pallas_knn.py:273's shape: the reference's XLA phase-1 variant
    (int8_phase1="xla") gives the same hits as the port's K5 path."""
    codes, scales, queries = _corpus(23, 8192, 64, 8)
    xv, xi, xc = ref.knn_topk_int8_xla_with_count(
        codes, scales, jnp.asarray(queries), k=5, n_valid=n_valid,
        chunk_rows=4096)
    pv, pi, pc = _port_int8(codes, scales, queries, k=5, block_rows=2048,
                            n_valid=n_valid)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(xi))
    np.testing.assert_allclose(pv.numpy(), np.asarray(xv), rtol=1e-6)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(xc))
    assert (pi.numpy() < n_valid).all()


def _reference_table(codes, scales, q8, sub, n_valid, block_rows=2048):
    """(bmax, bcnt) of the reference's ``_subblock_max_int8_kernel`` in
    interpret mode, launched as ``knn_topk_int8_with_count`` launches it
    (pallas_knn.py:948), on the same int8 queries."""
    n, d = codes.shape
    qn = q8.shape[0]
    kernel = functools.partial(ref._subblock_max_int8_kernel, sub=sub,
                               n_valid=n_valid)

    def kernel2(q_ref, v_ref, s_ref, out_ref, cnt_out_ref):
        kernel(q_ref, v_ref, s_ref, out_ref, cnt_ref=cnt_out_ref)

    spec = pl.BlockSpec((block_rows // sub, qn), lambda i: (i, 0))
    bmax, bcnt = pl.pallas_call(
        kernel2,
        grid=(n // block_rows,),
        in_specs=[pl.BlockSpec((qn, d), lambda i: (0, 0)),
                  pl.BlockSpec((block_rows, d), lambda i: (i, 0)),
                  pl.BlockSpec((block_rows, 1), lambda i: (i, 0))],
        out_specs=[spec, spec],
        out_shape=[jax.ShapeDtypeStruct((n // sub, qn), jnp.float32)] * 2,
        interpret=True,
    )(jnp.asarray(q8), codes, scales[:, None])
    return np.asarray(bmax), np.asarray(bcnt).astype(np.int32)


# the entry points' 64 queries (bench.py, int8_30m_bench), one more than a
# 64-query pass, and 256; each width's sub-block size with a partial n_valid
ENTRY_WIDTHS = [(64, 128, 32, 7001), (65, 128, 32, 7001), (256, 128, 32, 7001),
                (64, 64, 64, 6000), (65, 64, 64, 6000), (256, 64, 64, 6000)]


@pytest.mark.parametrize("q,d,sub,n_valid", ENTRY_WIDTHS)
def test_k5_plain_table_matches_reference_kernel(q, d, sub, n_valid):
    """K5's plain table equals the reference kernel's bit for bit: exact
    int32 sums, one f32 multiply by the row scale, the same masking."""
    codes, scales, queries = _corpus(q + d + sub, 8192, d, q)
    q8, _ = port_quant.quantize_int8(torch.from_numpy(queries))
    bmax, bcnt = port.subblock_max_int8(
        torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scales)),
        q8, sub, n_valid)
    rmax, rcnt = _reference_table(codes, scales, q8.numpy(), sub, n_valid)
    np.testing.assert_array_equal(bmax.numpy(), rmax)
    np.testing.assert_array_equal(bcnt.numpy(), rcnt)


@pytest.mark.parametrize("q,d,sub,n_valid", ENTRY_WIDTHS)
def test_knn_int8_matches_reference_at_entry_widths(q, d, sub, n_valid):
    """``knn_topk_int8_with_count`` / ``knn_topk_int8`` at the entry
    points' query counts against the reference's Pallas path."""
    codes, scales, queries = _corpus(2 * q + d + sub, 8192, d, q)
    kw = dict(k=10, block_rows=2048, sub_rows=sub, n_valid=n_valid)
    rv, ri, rc = ref.knn_topk_int8_with_count(
        codes, scales, jnp.asarray(queries), interpret=True, **kw)
    pv, pi, pc = _port_int8(codes, scales, queries, **kw)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    ov, oi = ref.knn_topk_int8(codes, scales, jnp.asarray(queries),
                               interpret=True, **kw)
    tv, ti = port.knn_topk_int8(
        torch.from_numpy(np.array(codes)),
        torch.from_numpy(np.array(scales)), torch.from_numpy(queries), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(oi))
    np.testing.assert_allclose(tv.numpy(), np.asarray(ov), rtol=1e-6)
