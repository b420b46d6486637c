"""The doc-tile partition of B3's kernel (``csrc/bm25_tiles.cuh``), through
its plain model ``ops.bm25.scan_tile_runs`` on the CPU: on every plan
whose windows ascend the check passes and the tiles' runs cover each
window exactly once, in order; on any plan, ascending or shuffled, with
repeated ids and ids outside [0, n_docs), the check fails whenever
summing by runs would differ from the reference's segment sum. Each
posting weighs its own index + 1 (float64), so sums are exact and any
posting lost or added twice shows. Tile sizes run from 1 doc up."""

import os
import re

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from orama_core_tpu_torch.ops import _cuda
from orama_core_tpu_torch.ops import bm25
from orama_core_tpu_torch.tools import bm25_scan_bench

TILES = (1, 2, 3, 5, 8, 32, 33, 64, 1024)
BLOCKS = (4, 8, 32)
SETTINGS = settings(max_examples=80, deadline=None, derandomize=True,
                    database=None)


@st.composite
def plans(draw, ascending: bool):
    """(docs int32[P], plan (block_idx, lo_off, hi_off), n_docs, block,
    tile): 1-5 terms of 1-60 postings over ids in [-3, n_docs + 3),
    repeats allowed, each term sorted when ``ascending``."""
    n_docs = draw(st.integers(1, 300))
    block = draw(st.sampled_from(BLOCKS))
    tile = draw(st.sampled_from(TILES))
    terms = draw(st.lists(st.lists(st.integers(-3, n_docs + 2), min_size=1,
                                   max_size=60), min_size=1, max_size=5))
    if ascending:
        terms = [sorted(t) for t in terms]
    flat = [d for t in terms for d in t]
    p_pad = -(-len(flat) // block) * block
    docs = np.zeros(p_pad, np.int32)
    docs[:len(flat)] = flat
    p_lo = np.cumsum([0] + [len(t) for t in terms[:-1]]).tolist()
    p_len = [len(t) for t in terms]
    nb = sum(-(-n // block) + 1 for n in p_len)
    bi, lo, hi, _ = bm25_scan_bench.plan_aligned(
        p_lo, p_len, [1.0] * len(terms), block, nb)
    plan = tuple(torch.from_numpy(a) for a in (bi, lo, hi))
    return torch.from_numpy(docs), plan, n_docs, block, tile


def _segment_sum(docs, plan, n_docs, block):
    """The reference: each window's postings, weight index + 1, summed
    per doc; ids outside [0, n_docs) dropped."""
    out = np.zeros(n_docs, np.float64)
    for b, lo, hi in zip(*(p.tolist() for p in plan)):
        for p in range(b * block + lo, b * block + hi):
            d = int(docs[p])
            if 0 <= d < n_docs:
                out[d] += p + 1
    return out


def _by_runs(docs, runs, n_docs, tile):
    """What the kernel adds: tile t adds a posting of its runs only to a
    doc of its own tile."""
    out = np.zeros(n_docs, np.float64)
    for t, tile_runs in enumerate(runs):
        for _i, s, e in tile_runs:
            for p in range(s, e):
                d = int(docs[p])
                if t * tile <= d < min((t + 1) * tile, n_docs):
                    out[d] += p + 1
    return out


@SETTINGS
@given(plans(ascending=True))
def test_ascending_plans_pass_and_runs_cover_each_window(case):
    docs, plan, n_docs, block, tile = case
    runs, ok = bm25.scan_tile_runs(docs, *plan, n_docs, block, tile)
    assert ok
    assert len(runs) == -(-n_docs // tile)
    for i, (b, lo, hi) in enumerate(zip(*(p.tolist() for p in plan))):
        if hi <= 0:
            break
        mine = [(s, e) for tile_runs in runs for j, s, e in tile_runs
                if j == i]
        # tile order is run order: the runs chain from lo to hi
        assert mine[0][0] == b * block + lo and mine[-1][1] == b * block + hi
        assert all(e0 == s1 for (_, e0), (s1, _) in zip(mine, mine[1:]))
    np.testing.assert_array_equal(_by_runs(docs, runs, n_docs, tile),
                                  _segment_sum(docs, plan, n_docs, block))


@SETTINGS
@given(st.booleans().flatmap(lambda asc: plans(ascending=asc)))
def test_check_fails_whenever_runs_would_differ(case):
    docs, plan, n_docs, block, tile = case
    runs, ok = bm25.scan_tile_runs(docs, *plan, n_docs, block, tile)
    same = np.array_equal(_by_runs(docs, runs, n_docs, tile),
                          _segment_sum(docs, plan, n_docs, block))
    assert ok <= same  # a passing check implies the reference's sums


def test_a_shuffled_window_across_tiles_fails_the_check():
    """One window over 40 docs, shuffled, in tiles of 8: its runs miss
    and double postings, and the check says so."""
    docs = torch.tensor(np.random.default_rng(3).permutation(40),
                        dtype=torch.int32)
    plan = tuple(torch.tensor([x], dtype=torch.int32) for x in (0, 0, 40))
    runs, ok = bm25.scan_tile_runs(docs, *plan, 40, 40, 8)
    assert not ok
    assert not np.array_equal(_by_runs(docs, runs, 40, 8),
                              _segment_sum(docs, plan, 40, 40))


@SETTINGS
@given(st.lists(st.integers(-50, 50), min_size=2, max_size=3000),
       st.integers(-60, 60))
def test_tile_bound_is_lower_bound_on_an_ascending_window(ids, key):
    docs = torch.tensor(sorted(ids), dtype=torch.int32)
    got = bm25._tile_bound(docs, 0, len(ids), key)
    assert got == int(np.searchsorted(np.asarray(sorted(ids)), key, "left"))


def test_tile_size_is_the_kernels():
    """The model's default tile is the kernel's compile-time kTileDocs."""
    path = os.path.join(_cuda.CSRC, "bm25_tiles.cuh")
    text = open(path, encoding="utf-8").read()
    found = re.findall(r"constexpr int kTileDocs = (\d+);", text)
    assert found == [str(bm25.SCAN_TILE_DOCS)]


def test_no_repairs_on_the_cpu():
    """The plain versions run on the CPU: nothing is ever repaired."""
    assert bm25.scan_repairs("cpu") == 0
