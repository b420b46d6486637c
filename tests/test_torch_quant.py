"""ops/quant.py of the PyTorch port against the JAX package's
ops/quant.py: the int8 codes and scales are equal bit for bit, the dense
int8 scorer agrees at rtol 1e-6 with the same positive count, and the
integer product helper is exact on both of its routes."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orama_core_tpu.ops import quant as ref
from orama_core_tpu_torch.ops import quant as port


def _unit_rows(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("d", [128, 384, 1024])
def test_quantize_matches_reference_bit_for_bit(d):
    rng = np.random.default_rng(d)
    v = _unit_rows(rng, 3000, d)
    v[7] = 0.0                                   # all-zero row: scale 1e-9/127
    v[8] *= 40.0                                 # an unnormalised row
    rc, rs = ref.quantize_int8(jnp.asarray(v))
    pc, ps = port.quantize_int8(torch.from_numpy(v))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(ps.numpy().view(np.int32),
                                  np.asarray(rs).view(np.int32))
    assert pc.dtype == torch.int8 and int(pc[7].abs().sum()) == 0
    np.testing.assert_array_equal(
        port.dequantize_int8(pc, ps).numpy(),
        np.asarray(ref.dequantize_int8(rc, rs)))


@pytest.mark.parametrize("p,d", [(5000, 384), (12, 64), (600, 100)])
def test_int8_matmul_exact(p, d):
    """Both routes (the int8 GEMM and the f32 one for tiny corpora or odd
    widths) give the exact integer product."""
    rng = np.random.default_rng(p)
    codes = rng.integers(-127, 128, (p, d)).astype(np.int8)
    q8 = rng.integers(-127, 128, (3, d)).astype(np.int8)
    got = port.int8_matmul(torch.from_numpy(codes), torch.from_numpy(q8))
    want = codes.astype(np.int64) @ q8.astype(np.int64).T
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    rows = rng.integers(0, p, (3, 40))
    gd = port.int8_gather_dot(torch.from_numpy(codes), torch.from_numpy(q8),
                              torch.from_numpy(rows))
    np.testing.assert_array_equal(
        gd.numpy(), np.einsum("qd,qcd->qc", q8.astype(np.int64),
                              codes[rows].astype(np.int64)))


def test_f32_route_refuses_inexact_widths():
    codes = torch.zeros(4, 1048, dtype=torch.int8)
    with pytest.raises(ValueError, match="exact"):
        port.int8_matmul(codes, torch.zeros(1, 1048, dtype=torch.int8))


@pytest.mark.parametrize("multi", [False, True])
def test_int8_brute_force_scores_match_reference(multi):
    rng = np.random.default_rng(3)
    p, d, n_docs = 4096, 384, 5000
    v = _unit_rows(rng, p, d)
    docs = (np.arange(p) // 3 if multi else np.arange(p)).astype(np.int32)
    valid = np.ones(p, np.float32)
    valid[-50:] = 0.0
    mask = (rng.random(n_docs) > 0.2).astype(np.float32)
    q = _unit_rows(rng, 1, d)[0]
    rc, rs = ref.quantize_int8(jnp.asarray(v))
    want = np.asarray(ref.int8_brute_force_scores(
        rc, rs, jnp.asarray(docs), jnp.asarray(valid), jnp.asarray(q),
        jnp.asarray(mask), n_docs=n_docs))
    pc, ps = port.quantize_int8(torch.from_numpy(v))
    got = port.int8_brute_force_scores(
        pc, ps, torch.from_numpy(docs), torch.from_numpy(valid),
        torch.from_numpy(q), torch.from_numpy(mask), n_docs=n_docs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert int((got > 0).sum()) == int((want > 0).sum()) > 0


def test_int8_topk_sims_match_reference():
    rng = np.random.default_rng(4)
    v = _unit_rows(rng, 3000, 128)
    valid = np.ones(3000, np.float32)
    valid[::7] = 0.0
    qs = rng.standard_normal((5, 128)).astype(np.float32)
    rc, rs = ref.quantize_int8(jnp.asarray(v))
    rv, ri = ref.int8_topk_sims(rc, rs, jnp.asarray(valid), jnp.asarray(qs),
                                k=9)
    pc, ps = port.quantize_int8(torch.from_numpy(v))
    pv, pi = port.int8_topk_sims(pc, ps, torch.from_numpy(valid),
                                 torch.from_numpy(qs), k=9)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6)
