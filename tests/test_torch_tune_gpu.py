"""The kernel probes' forms on the card against their plain torch
versions: B1's max forms (csrc/knn_phase1_variants.cu: masked everywhere
or at the edge, queries [Q, D] or qt [D, Q], sub 32, 64 and 128), its
bare product rows, and B3's four-plane (at 1,024 also against K1) and
packed scans (csrc/bm25_scan_variants.cu). This file imports only torch, numpy and
the port, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tune_gpu.py -q

Every test is marked ``gpu`` and skips without a CUDA card: the kernels
have no CPU mode. The shapes probe the streaming core's edges as
tests/test_torch_kernels_gpu.py does for K2: query counts that pad (1,
9) or take several corpus passes (65, 256), a width that is not a
multiple of the 64-column box (136), n_valid inside a tile, padding rows
of 10.0 that would show if a masked row leaked into a max."""

import numpy as np
import pytest
import torch

from orama_core_tpu_torch.ops import bm25
from orama_core_tpu_torch.ops import knn as port
from orama_core_tpu_torch.tools import bm25_scan_bench


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _bf16(rng, shape, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.tensor(x, dtype=torch.bfloat16, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 9, 65, 256])
@pytest.mark.parametrize("d", [136, 768])
def test_max_forms_match_plain_on_card(d, q):
    """Every max form at sub 32, 64 and 128 within 1e-4 of the plain
    version (f32 sums of exact bf16 products in another order); the edge
    form and the qt form equal the masked form's result."""
    _need_card()
    rng = np.random.default_rng(23)
    n = 8192
    for n_valid in (8192, 7000, 6999, 0):
        v = _bf16(rng, (n, d), 1.0 / np.sqrt(d))
        v[n_valid:] = 10.0
        qs = _bf16(rng, (q, d))
        qt = qs.T.contiguous()
        for sub in port.PROBE_SUBS:
            want = port.subblock_max_only_plain(v, qs, sub, n_valid)
            for got in (port.subblock_max_only(v, qs, sub, n_valid),
                        port.subblock_max_only(v, qs, sub, n_valid, "edge"),
                        port.subblock_max_only_qt(v, qt, sub, n_valid)):
                assert got.shape == (n // sub, q)
                torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 9, 65, 256])
@pytest.mark.parametrize("bn,sub", [(1024, 32), (2048, 32), (2048, 16),
                                    (1024, 8)])
def test_phase1_rows_match_plain_on_card(bn, sub, q):
    """k_mm's kept rows (bn / sub of every bn-row block: fewer than one
    tile, one tile, or several) within 1e-4 of the plain version."""
    _need_card()
    rng = np.random.default_rng(29)
    d = 768
    v = _bf16(rng, (4 * bn, d), 1.0 / np.sqrt(d))
    qs = _bf16(rng, (q, d))
    got = port.phase1_rows(v, qs, bn, sub)
    want = port.phase1_rows_plain(v, qs, bn, sub)
    assert got.shape == (4 * bn // sub, q)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_max_only_refuses_an_unknown_mask():
    """The mask is checked on the CPU too, where the plain version runs."""
    v = torch.zeros(4096, 64)
    q = torch.zeros(8, 64)
    with pytest.raises(ValueError):
        port.subblock_max_only(v, q, 32, 4096, mask="last")


def _postings(rng, n_docs, n_post, block):
    """Sorted random doc sets per term (tf 1-5, lengths 8-99 and, every
    97th and 101st posting, 40,000 and 65,535: lengths of 2^15 or more set
    the packed word's sign bit), padded to a multiple of ``block``; a few
    doc ids past n_docs, which must be dropped."""
    dfs = [n_post // 2, n_post // 4, n_post // 8, 7, 1]
    docs, lo, ln = [], [], []
    off = 0
    for df in dfs:
        docs.append(np.sort(rng.choice(n_docs + 64, df, replace=False)))
        lo.append(off)
        ln.append(df)
        off += df
    p = -(-off // block) * block
    pd = np.zeros(p, np.int32)
    pd[:off] = np.concatenate(docs)
    tf = np.zeros(p, np.float32)
    tf[:off] = rng.integers(1, 6, off)
    lens = np.ones(p, np.float32)
    lens[:off] = rng.integers(8, 100, off)
    lens[:off:97] = 40_000
    lens[:off:101] = 65_535
    ni = np.ones(p, np.float32)
    ni[:off] = np.repeat(np.asarray(dfs, np.float32), dfs)
    return pd, tf, ni, lens, lo, ln, [float(x) for x in dfs]


@pytest.mark.gpu
@pytest.mark.parametrize("block", bm25.SCAN_BLOCKS)
def test_scan_forms_match_plain_on_card(block):
    """B3's four-plane and packed scans against their plain versions
    (rtol 1e-5, atol 1e-6: atomics add in another order), on a plan with
    pad blocks after the real ones, a term of one posting, a term inside
    one chunk, and doc ids past the row."""
    _need_card()
    rng = np.random.default_rng(31)
    n_docs = 60_000
    pd, tf, ni, lens, lo, ln, p_ni = _postings(rng, n_docs, 50_000, block)
    nb = sum(-(-x // block) + 1 for x in ln)
    bi, lo_o, hi_o, ni_b = bm25_scan_bench.plan_aligned(lo, ln, p_ni, block,
                                                        nb)
    cu = [torch.tensor(a, device="cuda") for a in (pd, tf, ni, lens)]
    plan = [torch.tensor(a, device="cuda") for a in (bi, lo_o, hi_o)]
    packed = bm25.pack_tf_lens(cu[1], cu[3])
    assert int((packed < 0).sum()) > 0  # the kernel must shift logically
    ni_i32 = torch.tensor(ni_b.astype(np.int32), device="cuda")
    scal = (1.3, 50.0, float(n_docs))
    got = bm25.bm25_scan_wide(*cu, *plan, *scal, n_docs, block)
    want = bm25.bm25_scan_wide_plain(*cu, *plan, *scal, n_docs, block)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if block == bm25.BLOCK:  # the template at K1's block is K1's function
        k1 = bm25.bm25_scores_blocked_aligned(*cu, *plan, *scal, n_docs, nb)
        torch.testing.assert_close(got, k1, rtol=1e-5, atol=1e-6)
    got = bm25.bm25_scan_packed(cu[0], packed, *plan, ni_i32, *scal, n_docs,
                                block)
    want = bm25.bm25_scan_packed_plain(cu[0], packed, *plan, ni_i32, *scal,
                                       n_docs, block)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert int((got > 0).sum()) > 10_000


@pytest.mark.gpu
def test_packed_kernel_unpacks_with_a_logical_shift_on_card():
    """The packed kernel on words whose sign bit is set (lens 40,000 and
    65,535) against BM25's contribution computed from the unpacked
    planes: an arithmetic shift would read a negative length."""
    _need_card()
    tf = torch.tensor([1.0, 5.0, 3.0], device="cuda")
    lens = torch.tensor([40000.0, 65535.0, 9.0], device="cuda")
    packed = bm25.pack_tf_lens(tf, lens)
    assert int(packed[0]) < 0 and int(packed[1]) < 0
    docs = torch.zeros(1024, dtype=torch.int32, device="cuda")
    docs[:3] = torch.arange(3, dtype=torch.int32, device="cuda")
    plane = torch.zeros(1024, dtype=torch.int32, device="cuda")
    plane[:3] = packed
    plan = [torch.tensor([x], dtype=torch.int32, device="cuda")
            for x in (0, 0, 3)]
    ni_b = torch.tensor([10], dtype=torch.int32, device="cuda")
    got = bm25.bm25_scan_packed(docs, plane, *plan, ni_b, 1.0, 50.0, 1000.0,
                                3, 1024)
    want = bm25._bm25_contrib(tf, torch.full_like(tf, 10.0), lens,
                              torch.tensor(1.0), torch.tensor(50.0),
                              torch.tensor(1000.0))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
