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
sizes every block of the persistent grid walks a range of 2-3 tiles).
K5 runs on the same core over int8 codes and is held to its plain
version bit for bit at 1-256 queries (one, two and more passes of 64 or
128), widths of one box of 128 codes or less (16, 48) to past the
f32-exact 1,040 (1,056), sub-blocks of 32-128 rows, codes and queries at
+-127 up to D = 16,384, and every raise path.
The K4 cases probe its doc ownership (empty docs at the start, inside
and at the end of the stream, one doc longer than many blocks' shares,
fewer positions than blocks, no positions at all) with 4, 16 or 32
spans; the K1 cases its plan walk (edges inside plan blocks, a single
posting, one block, repeated docs, a padded bucket, pads only) and a
batch's combined plan with row ids (one row, empty rows, pads only); the
K3 cases its slab ring (one, odd and all of Q x k slots for Q up to 256,
the corpus's last sub-block, sub = 8, 16, 32, widths whose rows are not
16 bytes, half-slab pieces at D = 2048, an unaligned corpus view). The
dense scores cases (``-k dense``) hold the batched serving product
(csrc/knn_dense_scores.cu) to its plain twin at 1-256 queries, widths 384
and 768, corpora shorter and longer than the doc range, and the engine's
layout, and its refusal of inputs the kernel cannot read."""

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


def _int8(rng, shape, device="cuda"):
    return torch.tensor(rng.integers(-127, 128, shape, dtype=np.int8),
                        device=device)


def _k5_equal(codes, scales, q8, sub, n_valid):
    """K5 and its plain version on the same inputs: both outputs equal
    (exact s32 sums, one conversion and one f32 multiply each)."""
    bm, bc = port.subblock_max_int8(codes, scales, q8, sub, n_valid)
    pm, pc = port.subblock_max_int8_plain(codes, scales, q8, sub, n_valid)
    n, q = codes.shape[0], q8.shape[0]
    assert bm.shape == (n // sub, q) and bc.shape == (n // sub, q)
    assert torch.equal(bm, pm) and torch.equal(bc, pc), (n, sub, n_valid)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 3, 8, 9, 64, 65, 128, 256])
@pytest.mark.parametrize("d", [16, 48, 384, 768, 1024, 1056])
def test_k5_stream_edges_on_card(d, q):
    """K5 against its plain version bit for bit: n_valid inside the first
    64-row tile, odd, and on a sub-block boundary; corpora whose rows are
    not a multiple of 64; sub-blocks of 32, 64, 96 (tiles straddle them)
    and 128 rows; nothing live. Padding rows hold codes of 127 with a
    large scale, so a row past n_valid that leaked would show."""
    _need_card()
    rng = np.random.default_rng(29)
    for n, sub, n_valid in ((4096, 32, 37),       # inside the first tile
                            (19232, 32, 19219),   # 32-row tail, odd live
                            (19296, 96, 19200),   # on a 96-row boundary
                            (19328, 64, 12345),   # odd live
                            (19200, 128, 12800),  # on a 128-row boundary
                            (4096, 32, 0)):       # nothing live
        codes = _int8(rng, (n, d))
        codes[n_valid:] = 127
        scales = torch.tensor(rng.uniform(1e-3, 2e-2, n).astype(np.float32),
                              device="cuda")
        scales[n_valid:] = 1e3
        _k5_equal(codes, scales, _int8(rng, (q, d)), sub, n_valid)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 64, 65])
@pytest.mark.parametrize("d", [8192, 16384])
def test_k5_full_scale_codes_on_card(d, q):
    """Codes and queries at +-127: at D = 8,192 and 16,384 the sums reach
    1.3e8 and 2.6e8, far past f32's exact integers, so the kernel's and
    the plain version's single conversion of each must round alike."""
    _need_card()
    rng = np.random.default_rng(31)
    n = 4096
    codes = torch.tensor(np.where(rng.random((n, d)) < 0.9, 127, -127)
                         .astype(np.int8), device="cuda")
    q8 = torch.tensor(np.where(rng.random((q, d)) < 0.9, 127, -127)
                      .astype(np.int8), device="cuda")
    scales = torch.tensor(rng.uniform(1e-3, 2e-2, n).astype(np.float32),
                          device="cuda")
    _k5_equal(codes, scales, q8, 32, 4001)
    _k5_equal(codes, scales, -q8, 64, n)  # every sim negative


@pytest.mark.gpu
def test_k5_raises_on_what_it_does_not_take():
    """A CUDA tensor reaches K5 or an exception, never a plain fallback."""
    _need_card()
    rng = np.random.default_rng(37)
    codes = _int8(rng, (4096, 64))
    scales = torch.ones(4096, device="cuda")
    q8 = _int8(rng, (2, 64))
    with pytest.raises(TypeError):  # not int8 codes
        port.subblock_max_int8(codes.float(), scales, q8, 32, 4096)
    with pytest.raises(TypeError):  # not f32 scales
        port.subblock_max_int8(codes, scales.double(), q8, 32, 4096)
    with pytest.raises(TypeError):  # not int8 queries
        port.subblock_max_int8(codes, scales, q8.float(), 32, 4096)
    with pytest.raises(ValueError):  # not contiguous
        port.subblock_max_int8(codes[:, ::2], scales, q8[:, ::2], 32, 4096)
    with pytest.raises(ValueError):  # widths disagree
        port.subblock_max_int8(codes, scales, q8[:, :48].contiguous(), 32,
                               4096)
    with pytest.raises(ValueError):  # one scale short
        port.subblock_max_int8(codes, scales[:-1], q8, 32, 4096)
    with pytest.raises(ValueError):  # D % 16 != 0
        port.subblock_max_int8(codes[:, :40].contiguous(), scales,
                               q8[:, :40].contiguous(), 32, 4096)
    wide = _int8(rng, (64, 16400))
    with pytest.raises(ValueError):  # D past the core's limit
        port.subblock_max_int8(wide, torch.ones(64, device="cuda"),
                               _int8(rng, (1, 16400)), 32, 64)
    with pytest.raises(ValueError):  # sub % 32 != 0
        port.subblock_max_int8(codes, scales, q8, 16, 4096)
    with pytest.raises(ValueError):  # N % sub != 0
        port.subblock_max_int8(codes[:4064], scales[:4064], q8, 64, 4064)
    flat = torch.empty(4096 * 64 + 16, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # codes not 16-byte aligned
        port.subblock_max_int8(flat[1:1 + 4096 * 64].view(4096, 64), scales,
                               q8, 32, 4096)
    flat_q = torch.empty(2 * 64 + 16, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # queries not 16-byte aligned
        port.subblock_max_int8(codes, scales,
                               flat_q[8:8 + 2 * 64].view(2, 64), 32, 4096)


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


def _phrase_stream(rng, lens, vocab=5000, pad=3000):
    """A (doc, pos)-sorted phrase stream on the card, as the device cache
    holds it: doc d has lens[d] entries whose positions step by 0 (the
    second member of a (doc, pos) group; groups have at most two), 1 or 2,
    term ids below ``vocab``, then ``pad`` padding entries (PAD_DOC).
    Returns (bits, terms, bounds int32[n_docs + 1])."""
    from orama_core_tpu_torch.ops import bm25

    lens = np.asarray(lens, np.int64)
    P = int(lens.sum())
    bounds = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    docs = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    steps = rng.choice([0, 1, 1, 2], P)
    zero = steps == 0
    steps[1:][zero[1:] & zero[:-1]] = 1          # no group of three
    steps[bounds[:-1][lens > 0]] = 0             # each doc starts at 0
    cs = np.cumsum(steps)
    pos = (cs - np.repeat(cs[bounds[:-1][lens > 0]], lens[lens > 0])).astype(
        np.int32)
    d = np.concatenate([docs, np.full(pad, bm25.PAD_DOC, np.int32)])
    p = np.concatenate([pos, np.zeros(pad, np.int32)])
    t = np.concatenate([rng.integers(0, vocab, P).astype(np.int32),
                        np.zeros(pad, np.int32)])
    dt, pt = torch.tensor(d, device="cuda"), torch.tensor(p, device="cuda")
    return (bm25.phrase_static_bits(dt, pt), torch.tensor(t, device="cuda"),
            torch.tensor(bounds.astype(np.int32), device="cuda"))


def _phrase_lens(case, rng):
    if case == "gaps":      # empty doc 0, empty docs inside, 3,000 at the end
        lens = rng.integers(1, 40, 120_000)
        lens[0] = 0
        lens[rng.choice(120_000, 5000, replace=False)] = 0
        lens[-3000:] = 0
    elif case == "long_doc":  # one doc longer than many blocks' shares
        lens = np.ones(200_000, np.int64)
        lens[77_777] = 300_000
    elif case == "long_docs":  # docs of 500-9,000: groups straddle tiles
        lens = rng.integers(500, 9000, 600)
    elif case == "tiny":    # fewer positions than blocks
        lens = np.asarray([3, 0, 5, 1, 2])
    else:                   # "empty": no positions at all
        lens = np.zeros(1000, np.int64)
    return lens


def _phrase_spans(rng, n, vocab=5000):
    """n spans: a third empty (lo >= hi), the second overlapping the first,
    one touching the first's end."""
    lo = rng.integers(0, vocab, n)
    hi = lo + rng.integers(1, 80, n)
    empty = rng.random(n) < 0.33
    hi[empty] = lo[empty] - rng.integers(0, 3, int(empty.sum()))
    lo[0], hi[0] = 100, 400
    lo[1], hi[1] = 350, 500
    lo[2], hi[2] = 500, 520
    lo[3], hi[3] = 9, 9
    return torch.tensor(np.stack([lo, hi], 1).astype(np.int32), device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_spans", [4, 16, 32])
@pytest.mark.parametrize("case", ["gaps", "long_doc", "long_docs", "tiny",
                                  "empty"])
def test_k4_owns_whole_docs_on_card(case, n_spans):
    """K4 against its plain version (the cumsum form), exactly: docs with
    no positions (doc 0, inside the stream, a run up to n_docs), one doc
    longer than a block's share of the stream, (doc, pos) groups of two
    and adjacent positions across the kernel's 4096-position tiles, a
    padded stream tail, and 4, 16 or 32 spans with empty and overlapping
    ones among them."""
    _need_card()
    from orama_core_tpu_torch.ops import bm25

    rng = np.random.default_rng(31)
    bits, terms, bounds = _phrase_stream(rng, _phrase_lens(case, rng))
    n_docs = bounds.shape[0] - 1
    spans = _phrase_spans(rng, n_spans)
    a, s = bm25.phrase_counts(bits, terms, bounds, spans, n_docs)
    pa, ps = bm25.phrase_counts_plain(bits, terms, bounds, spans, n_docs)
    torch.cuda.synchronize()
    assert a.dtype == torch.int32 and a.shape == (n_docs,)
    assert torch.equal(a, pa) and torch.equal(s, ps), (
        int((a != pa).sum()), int((s != ps).sum()))
    if case not in ("empty", "tiny"):
        assert int(pa.sum()) > 0 and int(ps.sum()) > 0


@pytest.mark.gpu
def test_k4_raises_on_what_it_does_not_take():
    _need_card()
    from orama_core_tpu_torch.ops import bm25

    rng = np.random.default_rng(2)
    bits, terms, bounds = _phrase_stream(rng, rng.integers(1, 9, 100))
    spans = _phrase_spans(rng, 4)
    with pytest.raises(ValueError):
        bm25.phrase_counts(bits, terms, bounds, _phrase_spans(rng, 33), 100)
    with pytest.raises(ValueError):
        bm25.phrase_counts(bits, terms, bounds[:-1], spans, 100)
    with pytest.raises(TypeError):
        bm25.phrase_counts(bits, terms, bounds.long(), spans, 100)


def _k1_corpus(rng, n_docs=50_000, n_post=1_200_128):
    """Posting columns on the card (a BLOCK multiple); postings
    [600000, 605000) repeat the docs of [0, 5000)."""
    docs = rng.integers(0, n_docs, n_post).astype(np.int32)
    docs[600_000:605_000] = docs[:5000]
    cols = (docs, rng.integers(1, 5, n_post).astype(np.float32),
            rng.uniform(1, 3000, n_post).astype(np.float32),
            rng.uniform(5, 300, n_post).astype(np.float32))
    return [torch.tensor(c, device="cuda") for c in cols]


K1_PLANS = {  # name: (p_lo, p_len, n_blocks or None for the bucket)
    "inside": ([1500, 3000], [300, 2000], None),
    "single": ([7777], [1], None),
    "one_block": ([2048], [1024], 1),
    "same_docs": ([0, 600_000], [5000, 5000], None),
    "padded": ([10_000], [1100 * 1024 - 500], None),  # 1,101 in 2,048
    "pads_only": ([], [], 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("plan", list(K1_PLANS))
def test_k1_walks_plan_chunks_on_card(plan):
    """K1 against its plain version within rtol 1e-5, atol 1e-6 (f32 adds
    in another order): spans that start and end inside plan blocks, a
    single posting, a one-block plan, spans over the same docs, a plan
    padded to its PLAN_BUCKETS bucket as the engine builds it, and a plan
    of pad blocks only (zeros). The scalars go once as Python numbers and
    once as 0-d tensors on the card."""
    _need_card()
    from orama_core_tpu_torch.ops import bm25
    from orama_core_tpu_torch.utils import bucket_pad

    rng = np.random.default_rng(41)
    cols = _k1_corpus(rng)
    p_lo, p_len, nb = K1_PLANS[plan]
    if nb is None:
        nb = bucket_pad(max(bm25.aligned_blocks_needed(p_len), 1),
                        bm25.PLAN_BUCKETS)
    planned = [torch.tensor(a, device="cuda")
               for a in bm25.build_block_plan_aligned(p_lo, p_len, nb)]
    if plan == "padded":
        assert nb == 2048 and int((planned[2] > 0).sum()) == 1101
    for scalars in ((1.3, 42.0, 50_000.0),
                    tuple(torch.tensor(x, device="cuda")
                          for x in (1.3, 42.0, 50_000.0))):
        got = bm25.bm25_scores_blocked_aligned(
            *cols, *planned, *scalars, n_docs=50_000, n_blocks=nb)
        want = bm25.bm25_scores_blocked_aligned_plain(
            *cols, *planned, *scalars, n_docs=50_000, n_blocks=nb)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        if plan == "pads_only":
            assert not got.any()
        else:
            assert int((got > 0).sum()) >= min(sum(p_len), 100)


def _k1_batch_plan(rows):
    """The engine's combined aligned plan of a batch as int32 tensors on
    the card, and its length."""
    from orama_core_tpu_torch.ops import bm25

    plan = bm25.build_batch_plan_aligned(rows)
    return [torch.tensor(a, device="cuda") for a in plan], len(plan[0])


K1_BATCHES = {  # name: rows of (p_lo, p_len); empty rows hold no blocks
    "one_row": [([1500, 3000], [300, 2000])],
    "rows": [([7777], [1]), ([], []), ([0, 600_000], [5000, 5000]),
             ([10_000], [40_000]), ([], []), ([2048], [1024])] * 3,
    "pad_rows_around_one": [([], []), ([], []), ([123_456], [9_999]),
                            ([], [])],
    "pads_only": [([], [])] * 3,
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(K1_BATCHES))
def test_k1_row_ids_on_card(case):
    """K1 over a batch's combined plan (row ids) against its plain twin
    within rtol 1e-5, atol 1e-6, and each row against the single-row
    kernel on its own plan: one row alone, 18 rows with empty rows among
    them, one real row among empty ones, empty rows only (zeros)."""
    _need_card()
    from orama_core_tpu_torch.ops import bm25

    rng = np.random.default_rng(43)
    cols = _k1_corpus(rng)
    rows = K1_BATCHES[case]
    plan, nb = _k1_batch_plan(rows)
    b = len(rows)
    scal = (1.3, 42.0, 50_000.0)
    got = bm25.bm25_scores_blocked_aligned_batch(
        *cols, *plan, *scal, n_docs=50_000, n_blocks=nb, b=b)
    want = bm25.bm25_scores_blocked_aligned_batch_plain(
        *cols, *plan, *scal, n_docs=50_000, n_blocks=nb, b=b)
    torch.cuda.synchronize()
    assert got.shape == (b, 50_000)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for r, (p_lo, p_len) in enumerate(rows):
        if not p_len:
            assert not got[r].any()
            continue
        one, one_nb = _k1_batch_plan([(p_lo, p_len)])
        single = bm25.bm25_scores_blocked_aligned(
            *cols, *one[:3], *scal, n_docs=50_000, n_blocks=one_nb)
        torch.testing.assert_close(got[r], single, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_k1_drops_doc_ids_outside_the_row_on_card():
    """K1 drops a doc id outside [0, n_docs) (past the row, at its end,
    negative, the int32 extremes) as its plain twin does, in one row and
    in a batch's rows, within rtol 1e-5, atol 1e-6; the doc ids past the
    row are real postings, so a kernel that wrote them would also touch
    the next row of the batch."""
    _need_card()
    from orama_core_tpu_torch.ops import bm25

    rng = np.random.default_rng(47)
    cols = _k1_corpus(rng)
    bad = torch.tensor([50_000, 50_001, 50_000 + 4096, -1, 2**31 - 1,
                        -(2**31)], dtype=torch.int32, device="cuda")
    cols[0][1500:1500 + 6] = bad
    cols[0][3100:3100 + 6] = bad
    p_lo, p_len = [1500, 3000], [300, 2000]
    nb = bm25.PLAN_BUCKETS[0]
    planned = [torch.tensor(a, device="cuda")
               for a in bm25.build_block_plan_aligned(p_lo, p_len, nb)]
    scal = (1.3, 42.0, 50_000.0)
    got = bm25.bm25_scores_blocked_aligned(
        *cols, *planned, *scal, n_docs=50_000, n_blocks=nb)
    want = bm25.bm25_scores_blocked_aligned_plain(
        *cols, *planned, *scal, n_docs=50_000, n_blocks=nb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    rows = [([1500], [300]), ([3000], [2000]), ([], [])]
    plan, nbb = _k1_batch_plan(rows)
    got_b = bm25.bm25_scores_blocked_aligned_batch(
        *cols, *plan, *scal, n_docs=50_000, n_blocks=nbb, b=3)
    want_b = bm25.bm25_scores_blocked_aligned_batch_plain(
        *cols, *plan, *scal, n_docs=50_000, n_blocks=nbb, b=3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_b, want_b, rtol=1e-5, atol=1e-6)
    assert not got_b[2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("sub", [8, 16, 32])
@pytest.mark.parametrize("d", [130, 384, 768, 1024, 2048])
def test_k3_rescore_edges_on_card(d, sub):
    """K3 against its plain version within 1e-4 (f32 sums of exact bf16
    products in another order) at Q = 1, 3, 64 and 256 with k = 16: one
    slot, an odd slot count and every slot, the corpus's last sub-block
    always among them. D = 130 takes the 4-byte copies (rows not 16-byte
    wide); D = 2048 at sub = 32 streams half-slabs (a whole slab and its
    query leave no room for two stages)."""
    _need_card()
    rng = np.random.default_rng(d + sub)
    nsub, k = 1024, 16
    v = _bf16(rng, (nsub * sub, d), 1.0 / np.sqrt(d))
    for qn in (1, 3, 64, 256):
        q = _bf16(rng, (qn, d))
        for nsel in (1, qn * k - 3 if qn * k > 3 else 1, qn * k):
            ids = torch.tensor(rng.integers(0, nsub, nsel), dtype=torch.int32,
                               device="cuda")
            ids[-1] = nsub - 1
            got = port.rescore_subblocks(v, q, ids, k, sub)
            want = port.rescore_subblocks_plain(v, q, ids, k, sub)
            torch.cuda.synchronize()
            assert got.shape == (nsel, sub)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_k3_takes_unaligned_rows_and_raises_on_what_it_does_not_take():
    """A corpus view that starts 4 but not 16 bytes aligned takes the
    4-byte copies, with the same results; odd or too wide dimensions, and
    queries of another width, raise."""
    _need_card()
    rng = np.random.default_rng(8)
    d, sub, k = 384, 32, 16
    flat = _bf16(rng, (4096 * d + 2,), 1.0 / np.sqrt(d))
    v = flat[2:].view(4096, d)
    assert v.data_ptr() % 16 and not v.data_ptr() % 4
    q = _bf16(rng, (5, d))
    ids = torch.tensor(rng.integers(0, 4096 // sub, 5 * k), dtype=torch.int32,
                       device="cuda")
    torch.testing.assert_close(port.rescore_subblocks(v, q, ids, k, sub),
                               port.rescore_subblocks_plain(v, q, ids, k, sub),
                               rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        port.rescore_subblocks(_bf16(rng, (64, 7)), _bf16(rng, (1, 7)),
                               ids[:1], 1, 8)
    with pytest.raises(ValueError):
        port.rescore_subblocks(_bf16(rng, (32, 30_000)),
                               _bf16(rng, (1, 30_000)), ids[:1] * 0, 1, 8)
    with pytest.raises(ValueError):
        port.rescore_subblocks(v.contiguous(), q[:, :256].contiguous(), ids,
                               k, sub)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ann_ops_on_card_match_cpu(dtype):
    """The ANN searches and a Lloyd step (plain torch: no kernel of their
    own) give on the card what they give on the CPU on the same inputs:
    the same ids, scores within f32 summation order."""
    _need_card()
    from orama_core_tpu_torch.ops import ivf, pq

    rng = np.random.default_rng(11)
    n, d = 20_000, 64
    modes = rng.standard_normal((40, d)).astype(np.float32)
    v = modes[rng.integers(0, 40, n)] + 0.15 * rng.standard_normal((n, d))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    q = v[rng.integers(0, n, 8)] + 0.05 * rng.standard_normal((8, d))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    vc, qc = torch.from_numpy(v), torch.from_numpy(q)
    dt = getattr(torch, dtype)

    cents = ivf.kmeans_refine(vc, vc[:64], iters=1)
    torch.testing.assert_close(
        ivf.kmeans_refine(vc.cuda(), vc[:64].cuda(), iters=1).cpu(), cents,
        rtol=0, atol=1e-5)
    assign = ivf.assign_clusters_chunked(vc, cents)
    lists, lens, _ = ivf.build_ivf_lists(assign, 64)
    res = pq.residuals(vc, cents, torch.from_numpy(assign))
    rot = torch.from_numpy(pq.opq_rotation(res, 8))
    books = pq.pq_train(res @ rot, torch.Generator().manual_seed(0), m=8,
                        n_codes=64, iters=3)
    codes = pq.pq_encode(res @ rot, books)
    assert (pq.pq_encode((res @ rot).cuda(), books.cuda()).cpu()
            == codes).float().mean() > 0.999
    args = [codes, books, vc.to(dt), cents, torch.from_numpy(lists),
            torch.from_numpy(lens), qc]
    want = ivf.ivf_pq_search(*args, nprobe=8, k=10, expand=8, residual=True,
                             rotation=rot)
    got = ivf.ivf_pq_search(*[a.cuda() for a in args], nprobe=8, k=10,
                            expand=8, residual=True, rotation=rot.cuda())
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-6)
    valid = torch.ones(n)
    want = pq.pq_topk(codes, books, valid, qc, 50, rotation=rot)
    got = pq.pq_topk(codes.cuda(), books.cuda(), valid.cuda(), qc.cuda(), 50,
                     rotation=rot.cuda())
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-6)


# -- the mesh programs: K1, K2 + K3, K4 and K6 once per shard -----------------


def _mesh_inputs(mesh, device, seed=41):
    """Per-shard layouts, on ``mesh``, of one seeded string index and of a
    single- and a multi-vector index, from the port's own device cache
    (``_DeviceCache`` over ``mesh``): 4 shards whose vector rows pad to
    3,072 (a multiple of 1,024, not of 2,048), so K2 and K6 tile them with
    1,024-row blocks."""
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import _DeviceCache
    from orama_core_tpu_torch.index import (
        CommittedStringIndex, CommittedVectorIndex, UncommittedStringIndex,
    )

    rng = np.random.default_rng(seed)
    S, local_cap, d = len(mesh.data_devices), 2500, 384
    cache = _DeviceCache(GpuConfig(device=device, mesh_shape=(S, 1),
                                   posting_bucket_steps=(1024, 3072, 16384)))
    cache.mesh = mesh
    cache.device = mesh.root
    unc = UncommittedStringIndex()
    for doc in range(S * local_cap - 7):
        n = int(rng.integers(3, 40))
        terms = {}
        for pos, w in enumerate(rng.zipf(1.3, n) % 300):
            terms.setdefault(f"t{w:03d}", []).append(pos)
        unc.insert(doc, n, {t: tuple(p) for t, p in terms.items()})
    sidx = CommittedStringIndex.empty().merge(unc, S * local_cap, set())
    single = CommittedVectorIndex(
        dimension=d, vecs=rng.standard_normal((S * local_cap, d)).astype(
            np.float32), vec_docs=np.arange(S * local_cap, dtype=np.int32))
    n_docs_mv = S * 1000  # 2-3 rows a doc: ~2,500 rows a shard
    nch = rng.integers(2, 4, n_docs_mv)
    mv_docs = np.repeat(np.arange(n_docs_mv, dtype=np.int32), nch)
    multi = CommittedVectorIndex(
        dimension=d, vecs=rng.standard_normal((len(mv_docs), d)).astype(
            np.float32), vec_docs=mv_docs)
    return cache, sidx, single, multi, local_cap, rng


def _mesh_run(mesh, device):
    """Every per-shard kernel program of the mesh path on ``mesh``: the
    outputs (on the host) and the launches they made."""
    from orama_core_tpu_torch.ops import _cuda, bm25
    from orama_core_tpu_torch.parallel import sharded_engine as se

    cache, sidx, single, multi, local_cap, rng = _mesh_inputs(mesh, device)
    S = len(mesh.data_devices)
    out = {}
    _cuda.reset_launches()
    d_docs, d_tf, d_ni, d_plens, ts_sh = cache.sharded_string_arrays(
        sidx, local_cap)
    spans = [sidx.term_dict.prefix_range(t) for t in ("t001", "t002", "t01")]
    nb = bm25.PLAN_BUCKETS[2]
    plans = np.stack([np.stack(bm25.build_block_plan_aligned(
        [int(ts_sh[s, lo]) for lo, hi in spans],
        [int(ts_sh[s, hi] - ts_sh[s, lo]) for lo, hi in spans], nb))
        for s in range(S)])
    mask = cache._alloc((local_cap,), torch.float32, 1.0)
    out["k1"] = se.blocked_bm25(mesh, d_docs, d_tf, d_ni, d_plens, plans,
                                1.3, 20.0, float(S * local_cap), mask,
                                local_cap, nb, True).to_host()
    terms, bits, bounds = cache.sharded_phrase_stream(sidx, local_cap)
    spans_a = np.zeros((4, 2), np.int32)
    spans_a[:len(spans)] = spans
    out["k4"] = se.blocked_phrase_boost(mesh, terms, bits, bounds, spans_a,
                                        2.0, local_cap).to_host()
    q = rng.standard_normal(384).astype(np.float32)
    q /= np.linalg.norm(q)
    # k x 4 sub-blocks of 32 rows (x 4 for K6's over-fetch) stay below
    # the shard's 3,072 rows, so the kernels run, not the dense branch
    for name, idx, cap, k, multivec in (("k2k3", single, local_cap, 10, False),
                                        ("k6", multi, 1000, 5, True)):
        vecs, rowdocs, _ = cache.sharded_vector_arrays(idx, cap)
        rs = cache.sharded_vector_rowstarts(idx, cap) if multivec else None
        p_l = int(vecs.shape[0])
        assert p_l == 3072
        vals, gids, count = se.vector_topk_fast(
            mesh, vecs, rowdocs, rs, q, cap, k, 1024, 4, p_l, multivec)
        out[name] = (vals.cpu().numpy(), gids.cpu().numpy(), int(count))
    if device == "cuda":
        torch.cuda.synchronize()
    return out, dict(_cuda.LAUNCHES)


def _check_mesh_against_cpu(mesh):
    from orama_core_tpu_torch.parallel.mesh import make_mesh

    S = len(mesh.data_devices)
    got, launches = _mesh_run(mesh, "cuda")
    want, _ = _mesh_run(make_mesh((S, 1), device="cpu"), "cpu")
    # K1 sums with atomics (another order of addition)
    np.testing.assert_allclose(got["k1"], want["k1"], rtol=1e-5, atol=1e-6)
    assert np.count_nonzero(want["k1"]) > 100
    np.testing.assert_array_equal(got["k4"], want["k4"])
    assert np.count_nonzero(want["k4"] > 2.0) > 0
    for name in ("k2k3", "k6"):
        np.testing.assert_array_equal(got[name][1], want[name][1])
        np.testing.assert_allclose(got[name][0], want[name][0], rtol=0,
                                   atol=1e-4)
        # a sim within rounding of zero may change sign
        assert abs(got[name][2] - want[name][2]) <= 2
    # one launch per shard of each kernel, none of any other (the probe
    # forms included)
    from orama_core_tpu_torch.ops import _cuda

    assert launches == {**{k: 0 for k in _cuda.LAUNCHES},
                        "bm25_scan": S, "knn_subblock_max": S,
                        "knn_rescore": S, "phrase_counts": S,
                        "knn_subblock_max_int8": 0,
                        "knn_subblock_max_mv": S}, launches


@pytest.mark.gpu
def test_mesh_kernels_per_shard_on_one_card():
    """Four shards on card 0: K1, K4, K2 + K3 and K6 launch once per shard
    through the mesh programs (``parallel/sharded_engine.py``) and give
    what the same programs give on the CPU's plain versions, on shards
    whose vector rows are not a multiple of 2,048."""
    _need_card()
    from orama_core_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((4, 1), devices=["cuda:0"] * 4)
    assert mesh.shared
    _check_mesh_against_cpu(mesh)


@pytest.mark.gpu
def test_mesh_launches_on_each_shards_card():
    """Shards spread over two cards: each shard's kernels run under its
    own card (``mesh.on_device``: the wrappers launch on the current
    device's stream and read its attributes), and the results equal the
    CPU's. Needs two cards; skips on one."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from orama_core_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((4, 1), device="cuda")
    assert [d.index for d in mesh.data_devices] == [
        s * torch.cuda.device_count() // 4 for s in range(4)]
    assert not mesh.shared
    _check_mesh_against_cpu(mesh)


# -- the dense scores kernel (csrc/knn_dense_scores.cu) ----------------------

DENSE_LAYOUTS = {
    # corpus rows (not a multiple of 64) below n_docs: the kernel writes
    # the pad; above it: the kernel reads only the first n_docs rows
    "pad": (20_011, 20_500),
    "slice": (20_011, 19_950),
}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(DENSE_LAYOUTS))
@pytest.mark.parametrize("b", [1, 8, 16, 64, 65, 256])
@pytest.mark.parametrize("d", [384, 768])
def test_dense_scores_match_plain_on_card(d, b, layout):
    """The batched serving product on the kernel against its plain twin
    on the card: unit rows and queries, so f32 sums of the same exact bf16
    products in another order differ by at most 2e-6; exact zeros where
    the row is invalid, the doc masked out, the similarity clearly
    negative, or the doc past the corpus; one launch a call."""
    _need_card()
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.ops import vector as vops

    p, n_docs = DENSE_LAYOUTS[layout]
    rng = np.random.default_rng(d + b)
    v = rng.standard_normal((p, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    vecs = torch.tensor(v, device="cuda").to(torch.bfloat16)
    valid = torch.tensor((rng.random(p) > 0.1).astype(np.float32),
                         device="cuda")
    mask = torch.tensor((rng.random(n_docs) > 0.1).astype(np.float32),
                        device="cuda")
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    queries = torch.tensor(q, device="cuda")
    docs = torch.arange(p, dtype=torch.int32, device="cuda")
    before = _cuda.LAUNCHES["knn_dense_scores"]
    got = vops.brute_force_scores_batch(vecs, docs, valid, queries, mask,
                                        n_docs=n_docs, identity=True)
    assert _cuda.LAUNCHES["knn_dense_scores"] == before + 1
    want = vops.brute_force_scores_batch_plain(vecs, docs, valid, queries,
                                               mask, n_docs=n_docs,
                                               identity=True)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, n_docs)
    assert (got - want).abs().max().item() <= 2e-6
    m = min(p, n_docs)
    sims = vops.sims_f32(vecs[:m], queries).T                # [b, m]
    zero = torch.zeros(b, n_docs, dtype=torch.bool, device="cuda")
    zero[:, :m] = (sims < -1e-5) | (valid[:m] == 0)[None, :]
    zero[:, m:] = True
    zero |= (mask == 0)[None, :]
    assert bool((got[zero] == 0).all())
    assert int((got > 0).sum()) > b * n_docs // 4


@pytest.mark.gpu
def test_dense_scores_engine_layout_on_card():
    """The engine's layout: the corpus a prefix view of its bucket-padded
    rows, the queries a view into the staged f32 upload (any offset), the
    mask the alive mask times a filter; against the plain twin."""
    _need_card()
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.ops import vector as vops

    rng = np.random.default_rng(9)
    p, p_pad, n_docs, d, b = 30_001, 32_768, 30_720, 384, 16
    v = rng.standard_normal((p_pad, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    padded = torch.tensor(v, device="cuda").to(torch.bfloat16)
    padded[p:] = 0
    vecs, valid = padded[:p], torch.ones(p_pad, device="cuda")[:p]
    alive = torch.ones(n_docs, device="cuda")
    alive[::7] = 0
    price = torch.tensor(rng.random(n_docs).astype(np.float32), device="cuda")
    mask = alive * (price < 0.5).to(torch.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    flts = torch.tensor(np.concatenate([[1.0, 2.0, 3.0], q.ravel()])
                        .astype(np.float32), device="cuda")
    queries = flts[3:].reshape(b, d)
    docs = torch.arange(p, dtype=torch.int32, device="cuda")
    before = _cuda.LAUNCHES["knn_dense_scores"]
    got = vops.brute_force_scores_batch(vecs, docs, valid, queries, mask,
                                        n_docs=n_docs, identity=True)
    want = vops.brute_force_scores_batch_plain(vecs, docs, valid, queries,
                                               mask, n_docs=n_docs,
                                               identity=True)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["knn_dense_scores"] == before + 1
    assert (got - want).abs().max().item() <= 2e-6
    assert bool((got[:, p:] == 0).all())
    # non-identity rows and f32 corpora (whose queries are not rounded to
    # bf16) stay on the torch code
    for corpus, identity in ((vecs.float(), True), (vecs, False)):
        args = (corpus, docs, valid, queries, mask)
        out = vops.brute_force_scores_batch(*args, n_docs=n_docs,
                                            identity=identity)
        plain = vops.brute_force_scores_batch_plain(*args, n_docs=n_docs,
                                                    identity=identity)
        assert torch.equal(out, plain)
    assert _cuda.LAUNCHES["knn_dense_scores"] == before + 1


DENSE_UNREADABLE = {  # a bf16 identity corpus on the card the kernel
    # cannot read: brute_force_scores_batch raises, as K2 does
    "d_not_multiple_of_8": lambda v, valid, mask: (
        torch.zeros(v.shape[0], 380, dtype=torch.bfloat16, device="cuda"),
        valid, mask),
    "misaligned_view": lambda v, valid, mask: (
        torch.zeros(v.numel() + 1, dtype=torch.bfloat16,
                    device="cuda")[1:].view(v.shape), valid, mask),
    "f64_mask": lambda v, valid, mask: (v, valid, mask.double()),
    "mask_of_other_length": lambda v, valid, mask: (v, valid, mask[:-1]),
    "valid_of_other_length": lambda v, valid, mask: (v, valid[:-1], mask),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(DENSE_UNREADABLE))
def test_dense_scores_refuse_unreadable_inputs_on_card(case):
    """No torch fallback on the card: each input the kernel cannot read
    raises ValueError and launches nothing, and the inputs it is edited
    from go through the kernel."""
    _need_card()
    from orama_core_tpu_torch.ops import _cuda
    from orama_core_tpu_torch.ops import vector as vops

    p, n_docs, d, b = 1_000, 1_024, 384, 4
    vecs = torch.zeros(p, d, dtype=torch.bfloat16, device="cuda")
    valid = torch.ones(p, device="cuda")
    mask = torch.ones(n_docs, device="cuda")
    queries = torch.ones(b, d, device="cuda")
    docs = torch.arange(p, dtype=torch.int32, device="cuda")
    before = _cuda.LAUNCHES["knn_dense_scores"]
    vops.brute_force_scores_batch(vecs, docs, valid, queries, mask,
                                  n_docs=n_docs, identity=True)
    assert _cuda.LAUNCHES["knn_dense_scores"] == before + 1
    v2, valid2, mask2 = DENSE_UNREADABLE[case](vecs, valid, mask)
    with pytest.raises(ValueError):
        vops.brute_force_scores_batch(v2, docs, valid2,
                                      queries[:, :v2.shape[1]], mask2,
                                      n_docs=n_docs, identity=True)
    assert _cuda.LAUNCHES["knn_dense_scores"] == before + 1
