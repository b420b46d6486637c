"""The port's hand-written kernels on the card against their plain torch
versions. This file imports only torch, numpy and the port, so it runs on
a machine with a card and no JAX (the repository's conftest imports JAX,
hence ``--noconftest`` there):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Every test is marked ``gpu`` and skips without a CUDA card: the kernels
have no CPU mode. Beyond the engine's shapes (``chip_smoke.py``), these
probe the edges of K2's and K6's streaming design (csrc/knn_stream.cuh):
query counts that pad (1, 3, 9) or take two corpus passes (65), widths
that are not a multiple of the 64-column box (136), n_valid that is not a
multiple of 32 or 64, a corpus whose last tile holds 32 rows, sub-blocks
of 96 rows (tiles of 64 straddle them), and multi-vector docs of up to 64
rows that straddle the boundaries of the blocks' row ranges (at these
sizes every block of the persistent grid walks a range of 2-3 tiles)."""

import numpy as np
import pytest
import torch

from orama_core_tpu_torch.ops import knn as port


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _bf16(rng, shape, scale=1.0, device="cuda"):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.tensor(x, dtype=torch.bfloat16, device=device)


def _near_zero(vecs, q, n_valid, sub, reach=1):
    """bool[N/sub, Q]: sub-blocks where a row, or one of the ``reach - 1``
    rows before it, has a similarity within 1e-5 of zero, whose sign may
    differ between the kernel's and the matmul's order of summation."""
    from orama_core_tpu_torch.ops.vector import sims_f32

    n = vecs.shape[0]
    near = torch.zeros(n, q.shape[0], device=vecs.device)
    near[:n_valid] = (sims_f32(vecs[:n_valid], q).abs() < 1e-5).float()
    if reach > 1:
        near = torch.nn.functional.max_pool1d(
            torch.nn.functional.pad(near.T[None], (reach - 1, 0)), reach,
            1)[0].T
    return near.reshape(n // sub, sub, -1).amax(dim=1) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [384, 768, 1024])
def test_kernels_match_plain_on_card(d):
    """K2/K3/K5/K6 on the card against their plain versions at the
    registry's embedding widths (chip_smoke.py checks them at the engine's
    real shapes)."""
    _need_card()
    rng = np.random.default_rng(5)
    v = torch.tensor(rng.standard_normal((65536, d)) / np.sqrt(d),
                     dtype=torch.bfloat16, device="cuda")
    q = torch.tensor(rng.standard_normal((8, d)), dtype=torch.bfloat16,
                     device="cuda")
    bm, bc = port.subblock_max(v, q, 32, 60000)
    pm, pc = port.subblock_max_plain(v, q, 32, 60000)
    torch.testing.assert_close(bm, pm, rtol=0, atol=1e-4)
    ids = port._tiered_subblock_topk(pm, 10).reshape(-1)
    torch.testing.assert_close(
        port.rescore_subblocks(v, q, ids, 10, 32),
        port.rescore_subblocks_plain(v, q, ids, 10, 32), rtol=0, atol=1e-4,
    )
    # K5: exact integer sums and one f32 multiply, so exactly equal
    from orama_core_tpu_torch.ops import quant

    codes, scales = quant.quantize_int8(v.to(torch.float32))
    q8, _ = quant.quantize_int8(q.to(torch.float32))
    got = port.subblock_max_int8(codes, scales, q8, 32, 60000)
    want = port.subblock_max_int8_plain(codes, scales, q8, 32, 60000)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # K6: 1-7 chunk rows per doc, m_max = 8, engine padding (doc 0)
    nch = rng.integers(1, 8, 16000)
    docs = np.repeat(np.arange(16000, dtype=np.int32), nch)[:60000]
    row_docs = np.zeros(65536, np.int32)
    row_docs[:len(docs)] = docs
    rd = torch.tensor(row_docs, device="cuda")
    got = port.subblock_max_mv(v, rd, q, 32, len(docs), 8)
    want = port.subblock_max_mv_plain(v, rd, q, 32, len(docs), 8)
    # f32 sums of at most 8 non-negative terms in another order
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    # a count may differ only where a sim within rounding of 0 changes sign
    assert int((got[1] != want[1]).sum()) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 3, 8, 9, 64, 65])
@pytest.mark.parametrize("d", [136, 384, 1024])
def test_k2_stream_edges_on_card(d, q):
    """K2 against its plain version: max within 1e-4 (f32 sums of exact
    bf16 products in another order), counts equal in every sub-block
    without a near-zero similarity. Padding rows hold 10.0, so a row past
    n_valid that leaked into a max or a count would show."""
    _need_card()
    rng = np.random.default_rng(17)
    for n, sub, n_valid in ((19232, 32, 19219),   # 32-row tail, odd live
                            (19232, 32, 19232),   # every row live
                            (19296, 96, 19246),   # sub-blocks of 96 rows
                            (4096, 32, 0)):       # nothing live
        v = _bf16(rng, (n, d), 1.0 / np.sqrt(d))
        v[n_valid:] = 10.0
        qs = _bf16(rng, (q, d))
        bm, bc = port.subblock_max(v, qs, sub, n_valid)
        pm, pc = port.subblock_max_plain(v, qs, sub, n_valid)
        assert bm.shape == (n // sub, q) and bc.shape == (n // sub, q)
        torch.testing.assert_close(bm, pm, rtol=0, atol=1e-4)
        bad = (bc != pc) & ~_near_zero(v, qs, n_valid, sub)
        assert int(bad.sum()) == 0, (n, sub, n_valid)


def _mv_corpus(rng, n, n_valid, m_max, d):
    """Doc-ascending rows, each doc 1..m_max rows, rows past n_valid
    padded with doc 0 and 10.0 (the engine pads ids with 0)."""
    nch = rng.integers(1, m_max + 1, n_valid)
    docs = np.repeat(np.arange(n_valid, dtype=np.int32), nch)[:n_valid]
    row_docs = np.zeros(n, np.int32)
    row_docs[:n_valid] = docs
    v = _bf16(rng, (n, d), 1.0 / np.sqrt(d))
    v[n_valid:] = 10.0
    return v, torch.tensor(row_docs, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 3, 8, 9, 64, 65])
@pytest.mark.parametrize("m_max", [8, 64])
@pytest.mark.parametrize("d", [136, 384])
def test_k6_stream_edges_on_card(d, m_max, q):
    """K6 against its plain version: sums within rtol 1e-5 (f32 sums of at
    most m_max non-negative terms in another order), counts equal in every
    sub-block whose rows and the m_max - 1 rows before each hold no
    similarity within 1e-5 of zero. Docs of up to 64 rows straddle the
    persistent blocks' range boundaries, which the look-back tile and the
    in-block carry must stitch."""
    _need_card()
    rng = np.random.default_rng(23)
    for n, sub, n_valid in ((65568, 32, 65501),   # 32-row tail tile
                            (19296, 96, 19250)):  # sub-blocks of 96 rows
        v, rd = _mv_corpus(rng, n, n_valid, m_max, d)
        qs = _bf16(rng, (q, d))
        bm, bc = port.subblock_max_mv(v, rd, qs, sub, n_valid, m_max)
        pm, pc = port.subblock_max_mv_plain(v, rd, qs, sub, n_valid, m_max)
        assert bm.shape == (n // sub, q) and bc.shape == (n // sub, q)
        torch.testing.assert_close(bm, pm, rtol=1e-5, atol=1e-6)
        bad = (bc != pc) & ~_near_zero(v, qs, n_valid, sub, m_max)
        assert int(bad.sum()) == 0, (n, sub, n_valid)
        assert int(bc.sum()) > 0 and float(bm.max()) > 0


@pytest.mark.gpu
def test_k2_k6_raise_on_what_they_do_not_take():
    """A CUDA tensor reaches the kernel or an exception, never a plain
    fallback."""
    _need_card()
    rng = np.random.default_rng(3)
    v = _bf16(rng, (4096, 64))
    q = _bf16(rng, (2, 64))
    rd = torch.zeros(4096, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        port.subblock_max(v[:, :60].contiguous(), q[:, :60].contiguous(), 32,
                          4096)
    with pytest.raises(ValueError):
        port.subblock_max_mv(v, rd, q, 32, 4096, 65)
    with pytest.raises(TypeError):
        port.subblock_max(v.float(), q, 32, 4096)
