"""The kernel probes' forms on the card against their plain torch
versions: B1's max forms (csrc/knn_phase1_variants.cu on the one-pass core
csrc/knn_wide.cuh: masked everywhere or at the edge, queries [Q, D] or qt
[D, Q], sub 32, 64 and 128), its bare product rows, and B3's four-plane
(at 1,024 also against K1) and packed scans
(csrc/bm25_scan_variants.cu on the doc-tile core csrc/bm25_tiles.cuh:
rows not a multiple of a tile, shorter than one, of one doc; a tile with
no posting over stale NaN memory; windows inside one tile and across
many; repeated ids; ids outside the row; shuffled windows, which the
kernel repairs and counts). This file imports only torch, numpy and
the port, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tune_gpu.py -q

Every test is marked ``gpu`` and skips without a CUDA card: the kernels
have no CPU mode. The shapes probe the one-pass core's edges: query
counts below one pass width (1, 9), at and between the widths (65, 128,
200, 256) and past one 256-query pass (300); a width that is not a
multiple of the 64-column box (136); corpora whose rows are not a
multiple of the 128-row tile; n_valid at 0, inside a tile, on a tile
edge and at N; padding rows of 10.0 that would show if a masked row
leaked into a max; kept-row counts under one 64-row box (16, 32), one
box (64) and two (128)."""

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


_N_FOR_SUB = {32: 8160, 64: 8128, 128: 8064}  # rows: no multiple of a tile
_TILE = 128


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 9, 65, 128, 200, 256, 300])
@pytest.mark.parametrize("d", [136, 768])
def test_max_forms_match_plain_on_card(d, q):
    """Every max form at sub 32, 64 and 128 within 1e-4 of the plain
    version (f32 sums of exact bf16 products in another order), with
    n_valid at N, inside a tile, on a tile edge and at 0; the edge form
    and the qt form equal the masked form's result."""
    _need_card()
    rng = np.random.default_rng(23)
    for sub in port.PROBE_SUBS:
        n = _N_FOR_SUB[sub]
        for n_valid in (n, 7000, 54 * _TILE, 0):
            v = _bf16(rng, (n, d), 1.0 / np.sqrt(d))
            v[n_valid:] = 10.0
            qs = _bf16(rng, (q, d))
            qt = qs.T.contiguous()
            want = port.subblock_max_only_plain(v, qs, sub, n_valid)
            for got in (port.subblock_max_only(v, qs, sub, n_valid),
                        port.subblock_max_only(v, qs, sub, n_valid, "edge"),
                        port.subblock_max_only_qt(v, qt, sub, n_valid)):
                assert got.shape == (n // sub, q)
                torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 9, 65, 256, 300])
@pytest.mark.parametrize("bn,sub", [(1024, 32), (2048, 32), (2048, 16),
                                    (1024, 8), (1024, 64)])
def test_phase1_rows_match_plain_on_card(bn, sub, q):
    """k_mm's kept rows (keep = bn / sub of every bn-row block: 16 and 32,
    under one 64-row box; 64, one box; 128, two) within 1e-4 of the plain
    version."""
    _need_card()
    rng = np.random.default_rng(29)
    d = 768
    v = _bf16(rng, (4 * bn, d), 1.0 / np.sqrt(d))
    qs = _bf16(rng, (q, d))
    got = port.phase1_rows(v, qs, bn, sub)
    want = port.phase1_rows_plain(v, qs, bn, sub)
    assert got.shape == (4 * bn // sub, q)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_probe_forms_on_two_corpora_in_turn_on_card():
    """The max forms and k_mm on corpus A, then B (another shape), then A
    again, each against its plain version: the cached corpus tensor maps
    (2-D for the max forms, 3-D over the kept rows for k_mm) must follow
    the corpus."""
    _need_card()
    rng = np.random.default_rng(37)
    d, bn, sub = 768, 1024, 32
    corpora = {n: _bf16(rng, (n, d), 1.0 / np.sqrt(d)) for n in (4096, 8192)}
    qs = _bf16(rng, (40, d))
    qt = qs.T.contiguous()
    for n in (4096, 8192, 4096):
        v = corpora[n]
        want = port.subblock_max_only_plain(v, qs, sub, n - 100)
        for got in (port.subblock_max_only(v, qs, sub, n - 100),
                    port.subblock_max_only_qt(v, qt, sub, n - 100)):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        torch.testing.assert_close(port.phase1_rows(v, qs, bn, sub),
                                   port.phase1_rows_plain(v, qs, bn, sub),
                                   rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_max_forms_take_widths_past_k2s_limit_on_card():
    """The one-pass core streams its queries beside the corpus, so a width
    past K2's shared-memory limit (8,192) runs, against the plain
    version."""
    _need_card()
    rng = np.random.default_rng(41)
    d = port._STREAM_MAX_D + 64
    v = _bf16(rng, (1024, d), 1.0 / np.sqrt(d))
    qs = _bf16(rng, (9, d))
    want = port.subblock_max_only_plain(v, qs, 64, 1000)
    torch.testing.assert_close(port.subblock_max_only(v, qs, 64, 1000),
                               want, rtol=0, atol=1e-4)
    torch.testing.assert_close(
        port.subblock_max_only_qt(v, qs.T.contiguous(), 64, 1000), want,
        rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bn,sub", [(3072, 32), (1536, 32), (1024, 3)])
def test_phase1_rows_refuses_kept_rows_a_box_would_split_on_card(bn, sub):
    """k_mm's 64-row boxes must hold 64 consecutive kept rows: keep = bn /
    sub a multiple of 64 or a divisor of 64 (96, 48 and a bn that sub does
    not divide are refused before any launch)."""
    _need_card()
    v = torch.zeros(2 * bn, 64, dtype=torch.bfloat16, device="cuda")
    qs = torch.zeros(8, 64, dtype=torch.bfloat16, device="cuda")
    before = port._cuda.LAUNCHES["knn_phase1_rows"]
    with pytest.raises(ValueError):
        port.phase1_rows(v, qs, bn, sub)
    assert port._cuda.LAUNCHES["knn_phase1_rows"] == before


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


_T = bm25.SCAN_TILE_DOCS


def _tile_case(case, rng):
    """(n_docs, terms): each term a list of doc ids, ascending unless the
    case is "shuffled"."""
    def pick(lo, hi, k):
        return sorted(rng.choice(np.arange(lo, hi), k, replace=False))
    if case == "ragged":      # n_docs not a multiple of a tile
        n = 3 * _T + 77
        return n, [pick(0, n, k) for k in (12_000, 3000, 700, 5)]
    if case == "short":       # one tile, cut at n_docs
        return 5000, [pick(0, 5000, 2500), pick(0, 5000, 300), [4999]]
    if case == "one_doc":
        return 1, [[-2, 0, 0, 1, 7], [0]]
    if case == "empty_tile":  # tile 2 has no posting
        n = 4 * _T
        ids = np.concatenate([np.arange(0, 2 * _T), np.arange(3 * _T, n)])
        return n, [sorted(rng.choice(ids, 9000, replace=False))]
    if case == "inside":      # every window inside one tile
        return 4 * _T, [pick(_T + 10, _T + 500, 300)]
    if case == "across":      # windows across many tiles
        n = 20 * _T
        return n, [pick(0, n, 3000), pick(0, n, 40)]
    if case == "repeats":     # an id more than once in a window
        n = 2 * _T + 5
        return n, [sorted(rng.integers(0, n, 9000)),
                   sorted(rng.integers(0, 300, 2000))]
    if case == "outside":     # ids below 0 and of n_docs or more
        n = 2 * _T + 9
        return n, [sorted(np.concatenate([
            rng.integers(-100, 0, 50), rng.choice(n, 5000, replace=False),
            rng.integers(n, n + 2 * _T, 60)]))]
    assert case == "shuffled"
    n = 3 * _T + 5
    return n, [list(rng.permutation(pick(0, n, 9000))), pick(0, n, 500)]


def _tile_inputs(terms, block, rng):
    """Planes on the card (docs, tf, ni, lens; packed), the aligned plan
    with its pads, and ni per plan block, from the terms' doc lists."""
    flat = np.concatenate([np.asarray(t, np.int64) for t in terms])
    p = max(-(-len(flat) // block) * block, block)
    pd = np.zeros(p, np.int32)
    pd[:len(flat)] = flat
    tf = np.zeros(p, np.float32)
    tf[:len(flat)] = rng.integers(1, 6, len(flat))
    lens = np.ones(p, np.float32)
    lens[:len(flat)] = rng.integers(8, 100, len(flat))
    dfs = [float(len(t)) for t in terms]
    ni = np.ones(p, np.float32)
    ni[:len(flat)] = np.repeat(dfs, [len(t) for t in terms])
    lo = np.cumsum([0] + [len(t) for t in terms[:-1]]).tolist()
    ln = [len(t) for t in terms]
    nb = sum(-(-x // block) + 1 for x in ln)
    bi, lo_o, hi_o, ni_b = bm25_scan_bench.plan_aligned(lo, ln, dfs, block,
                                                        nb)
    cu = [torch.tensor(a, device="cuda") for a in (pd, tf, ni, lens)]
    plan = [torch.tensor(a, device="cuda") for a in (bi, lo_o, hi_o)]
    ni_i32 = torch.tensor(ni_b.astype(np.int32), device="cuda")
    return cu, bm25.pack_tf_lens(cu[1], cu[3]), plan, ni_i32


def _stale_nan(n):
    """Leave a NaN-filled block of n floats in the cache allocator, where
    the wrapper's torch.empty row will find it."""
    x = torch.full((n,), float("nan"), device="cuda")
    ptr = x.data_ptr()
    del x
    y = torch.empty(n, device="cuda")
    assert y.data_ptr() == ptr and bool(torch.isnan(y).all())
    del y
    x = torch.full((n,), float("nan"), device="cuda")
    del x


_TILE_CASES = ("ragged", "short", "one_doc", "empty_tile", "inside",
               "across", "repeats", "outside", "shuffled")


@pytest.mark.gpu
@pytest.mark.parametrize("block", bm25.SCAN_BLOCKS)
@pytest.mark.parametrize("case", _TILE_CASES)
def test_scan_tiles_match_plain_on_card(case, block):
    """Both forms on the doc-tile core against their plain versions (rtol
    1e-5, atol 1e-6: shared adds run in any order), each call into a row
    of stale NaNs; a doc with no posting scores exactly 0. The repair
    count rises by one a call exactly where the plain model of the
    partition says the check fails: on shuffled windows, and nowhere
    else."""
    _need_card()
    rng = np.random.default_rng(43)
    n_docs, terms = _tile_case(case, rng)
    cu, packed, plan, ni_i32 = _tile_inputs(terms, block, rng)
    _, ok = bm25.scan_tile_runs(cu[0].cpu(), *[p.cpu() for p in plan],
                                n_docs, block)
    assert ok == (case != "shuffled")
    scal = (1.3, 50.0, float(n_docs))
    calls = {
        "wide": (lambda: bm25.bm25_scan_wide(*cu, *plan, *scal, n_docs,
                                             block),
                 bm25.bm25_scan_wide_plain(*cu, *plan, *scal, n_docs, block)),
        "packed": (lambda: bm25.bm25_scan_packed(
            cu[0], packed, *plan, ni_i32, *scal, n_docs, block),
            bm25.bm25_scan_packed_plain(cu[0], packed, *plan, ni_i32, *scal,
                                        n_docs, block)),
    }
    for name, (call, want) in calls.items():
        _stale_nan(n_docs)
        before = bm25.scan_repairs()
        got = call()
        torch.cuda.synchronize()
        assert bm25.scan_repairs() - before == (0 if ok else 1), name
        assert not bool(torch.isnan(got).any()), name
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        if case == "empty_tile":
            assert bool((got[2 * _T:3 * _T] == 0).all()), name
        assert bool((got[want == 0] == 0).all()), name


@pytest.mark.gpu
@pytest.mark.parametrize("block", bm25.SCAN_BLOCKS)
def test_scan_with_an_empty_plan_writes_zeros_on_card(block):
    """No plan block, or only pads: the row comes from torch.empty, so the
    kernel must still run and write every score, all 0."""
    _need_card()
    n_docs = 3 * _T + 11
    docs = torch.zeros(block, dtype=torch.int32, device="cuda")
    ones = torch.ones(block, device="cuda")
    for n_blocks in (0, 2):
        plan = [torch.zeros(n_blocks, dtype=torch.int32, device="cuda")
                for _ in range(3)]
        ni_b = torch.zeros(n_blocks, dtype=torch.int32, device="cuda")
        for call in (
                lambda: bm25.bm25_scan_wide(docs, ones, ones, ones, *plan,
                                            1.0, 50.0, 9.0, n_docs, block),
                lambda: bm25.bm25_scan_packed(
                    docs, bm25.pack_tf_lens(ones, ones), *plan, ni_b, 1.0,
                    50.0, 9.0, n_docs, block)):
            _stale_nan(n_docs)
            got = call()
            assert bool((got == 0).all())
