"""The port's synthetic corpus against the reference's
(orama_core_tpu/utils/benchgen.py:20-36).

f32 rows agree within 2e-7: the hash, the four uniforms and their sum
are the same operations in the same order, and only the norm's sum runs
in another order. bf16 rows are equal but for elements one bf16 ulp
apart, where that difference moved the f32 value across a rounding
boundary; the share of such elements is bounded. Past 2^32 elements the
flat index wraps; those rows are made as a slice and held to the
reference's formula written out in numpy uint32, which is itself held to
the reference at a small shape."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orama_core_tpu.utils.benchgen import hashed_unit_corpus as ref_corpus
from orama_core_tpu_torch.utils.benchgen import hashed_unit_corpus

SHAPES = [(1, 8, 0), (33, 384, 7), (512, 384, 12345), (64, 768, 2**32 - 1),
          (100, 130, 3)]


def _numpy_rows(rows, d, salt):
    """The reference's formula in numpy uint32 (wrapping) for the given
    row indices: f32 [len(rows), d]."""
    with np.errstate(over="ignore"):
        idx = (np.asarray(rows, np.uint32)[:, None] * np.uint32(d)
               + np.arange(d, dtype=np.uint32)[None, :])
        v = np.zeros(idx.shape, np.float32)
        for s in (1, 2, 3, 4):
            x = idx * np.uint32(2654435761) + np.uint32(salt) * np.uint32(s)
            x = x ^ (x >> np.uint32(15))
            x = x * np.uint32(2246822519)
            x = x ^ (x >> np.uint32(13))
            x = x * np.uint32(3266489917)
            x = x ^ (x >> np.uint32(16))
            v = v + x.astype(np.float32) * np.float32(1.0 / 4294967296.0)
    v = v - np.float32(2.0)
    n = np.sqrt(np.sum(v * v, -1, keepdims=True))
    return v / np.maximum(n, np.float32(1e-9))


@pytest.mark.parametrize("n,d,salt", SHAPES)
def test_f32_rows_match_reference(n, d, salt):
    want = np.asarray(ref_corpus(n, d, jnp.uint32(salt), jnp.float32))
    got = hashed_unit_corpus(n, d, salt, torch.float32, device="cpu").numpy()
    assert got.shape == (n, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    np.testing.assert_allclose(_numpy_rows(np.arange(n), d, salt), want,
                               rtol=0, atol=2e-7)


@pytest.mark.parametrize("n,d,salt", SHAPES)
def test_bf16_rows_match_reference(n, d, salt):
    """Bit-equal but for elements one ulp apart, at most 0.1% of them
    (2e-5 or less at these shapes)."""
    want = torch.from_numpy(np.asarray(
        ref_corpus(n, d, jnp.uint32(salt), jnp.bfloat16)).astype(np.float32))
    got = hashed_unit_corpus(n, d, salt, device="cpu")
    assert got.dtype == torch.bfloat16
    bits_w = want.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    bits_g = got.view(torch.int16).to(torch.int32)
    ulps = (bits_w - bits_g).abs()
    assert int(ulps.max()) <= 1
    assert float((ulps > 0).float().mean()) <= 1e-3


def test_rows_slice_equals_whole():
    whole = hashed_unit_corpus(300, 96, 5, torch.float32, device="cpu")
    part = hashed_unit_corpus(300, 96, 5, torch.float32, device="cpu",
                              rows=(117, 250))
    assert torch.equal(part, whole[117:250])
    with pytest.raises(ValueError):
        hashed_unit_corpus(300, 96, 5, device="cpu", rows=(250, 301))


def test_flat_index_wraps_past_2_32():
    """n_pad * d = 2^33 (8,388,608 rows of 1,024): rows whose flat index
    passes 2^32 (and the rows around the wrap) match the uint32 formula,
    so row 4,194,304 repeats row 0's hash inputs."""
    n, d, salt = 1 << 23, 1024, 77
    rows = [0, 1, (1 << 22) - 1, 1 << 22, (1 << 22) + 1, n - 1]
    for r in rows:
        got = hashed_unit_corpus(n, d, salt, torch.float32, device="cpu",
                                 rows=(r, r + 1)).numpy()
        np.testing.assert_allclose(got, _numpy_rows([r], d, salt), rtol=0,
                                   atol=2e-7)
    wrap = hashed_unit_corpus(n, d, salt, torch.float32, device="cpu",
                              rows=(1 << 22, (1 << 22) + 1))
    first = hashed_unit_corpus(n, d, salt, torch.float32, device="cpu",
                               rows=(0, 1))
    assert torch.equal(wrap, first)
