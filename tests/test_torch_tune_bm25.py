"""B3 of the kernel probes (ops/bm25.py's ``bm25_scan_wide`` and
``bm25_scan_packed``, run through their plain torch versions on the CPU)
against ``benchmarks/bm25_scan_bench.py``'s Pallas scans, loaded by path
and run with ``pallas_call`` patched to interpret mode: ``mk_pallas4``
and ``mk_pallas_packed`` at plan blocks of 1,024 and 4,096 over a few
thousand postings. The port's ``plan_aligned`` and Zipf generator
(``tools/bm25_scan_bench.py``) give arrays equal to the bench's. f32
scores within rtol 1e-5, atol 1e-6 (segment sums in another order)."""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from orama_core_tpu_torch.ops import bm25 as port
from orama_core_tpu_torch.tools import bm25_scan_bench as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
POSTINGS, DOCS = 6000, 20_000


@pytest.fixture(scope="module")
def bench():
    """benchmarks/bm25_scan_bench.py as a module (its main() never runs)."""
    path = os.path.join(ROOT, "benchmarks", "bm25_scan_bench.py")
    spec = importlib.util.spec_from_file_location("_bm25_scan_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_generator(postings, n_docs):
    """The bench's data, as its main() makes it (:276-317)."""
    rng = np.random.default_rng(0)
    dfs = []
    df = max(postings // 2, 1)
    while sum(dfs) + df // 2 < postings and df >= 1024:
        dfs.append(df)
        df //= 2
    lens_by_doc = rng.integers(8, 100, n_docs).astype(np.int32)
    docs_l, tf_l, ni_l, lens_l = [], [], [], []
    p_lo, p_len, p_ni = [], [], []
    off = 0
    for df in dfs:
        ids = np.sort(rng.permutation(n_docs)[:df]).astype(np.int32)
        tf = rng.integers(1, 6, df).astype(np.int32)
        docs_l.append(ids)
        tf_l.append(tf)
        ni_l.append(np.full(df, df, np.float32))
        lens_l.append(lens_by_doc[ids].astype(np.float32))
        p_lo.append(off)
        p_len.append(df)
        p_ni.append(float(df))
        off += df
    big_block = 8192
    p_total = off
    p_pad = -(-p_total // big_block) * big_block
    post_docs = np.zeros(p_pad, np.int32)
    post_tf = np.zeros(p_pad, np.float32)
    post_ni = np.ones(p_pad, np.float32)
    post_lens = np.ones(p_pad, np.float32)
    post_docs[:p_total] = np.concatenate(docs_l)
    post_tf[:p_total] = np.concatenate(tf_l).astype(np.float32)
    post_ni[:p_total] = np.concatenate(ni_l)
    post_lens[:p_total] = np.concatenate(lens_l)
    packed_np = (
        post_tf.astype(np.int64).astype(np.uint32)
        | (post_lens.astype(np.int64).astype(np.uint32) << np.uint32(16))
    ).astype(np.int32)
    return dict(dfs=dfs, p_lo=p_lo, p_len=p_len, p_ni=p_ni,
                post_docs=post_docs, post_tf=post_tf, post_ni=post_ni,
                post_lens=post_lens, packed=packed_np,
                avgdl=np.float32(lens_by_doc.mean()))


@pytest.fixture(scope="module")
def data():
    return tool.zipf_postings(POSTINGS, DOCS)


@pytest.mark.parametrize("postings,n_docs", [(6000, 20_000),
                                             (1_000_000, 1_048_576)])
def test_generator_equals_the_benchs(postings, n_docs):
    got = tool.zipf_postings(postings, n_docs)
    want = _bench_generator(postings, n_docs)
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            assert got[key].dtype == val.dtype, key
            np.testing.assert_array_equal(got[key], val, err_msg=key)
        else:
            assert got[key] == val, key


@pytest.mark.parametrize("block", port.SCAN_BLOCKS)
def test_plan_equals_the_benchs(bench, data, block):
    nb = sum((ln + block - 1) // block + 1 for ln in data["p_len"])
    got = tool.plan_aligned(data["p_lo"], data["p_len"], data["p_ni"], block,
                            nb)
    want = bench.plan_aligned(data["p_lo"], data["p_len"], data["p_ni"],
                              block, nb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # real blocks first, then the zero tails that end a kernel's walk
    hi = got[2]
    real = int(np.count_nonzero(hi))
    assert real < nb and (hi[:real] > 0).all() and (hi[real:] == 0).all()
    # and the bench's budget can cut nothing
    assert tool.plans(data, block)[2].tolist() == hi.tolist()


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call the bench makes runs in interpret mode."""
    monkeypatch.setattr(jpl, "pallas_call", functools.partial(
        jpl.pallas_call, interpret=True))


def _plan(data, block):
    bi, lo, hi, ni_b = tool.plans(data, block)
    return bi, lo, hi, ni_b, len(bi)


def _scalars(data):
    return 1.0, float(data["avgdl"]), float(data["nfd"])


@pytest.mark.parametrize("block", [1024, 4096])
def test_scan_wide_matches_mk_pallas4(bench, data, interpret, block):
    bi, lo, hi, _ni, nb = _plan(data, block)
    boost, avgdl, nfd = _scalars(data)
    want = bench.mk_pallas4(block)(
        jnp.asarray(data["post_docs"]), jnp.asarray(data["post_tf"]),
        jnp.asarray(data["post_ni"]), jnp.asarray(data["post_lens"]),
        jnp.asarray(bi), jnp.asarray(lo), jnp.asarray(hi),
        jnp.float32(boost), jnp.float32(avgdl), jnp.float32(nfd),
        n_docs=DOCS, n_blocks=nb)
    t = {k: torch.from_numpy(data[k]) for k in
         ("post_docs", "post_tf", "post_ni", "post_lens")}
    got = port.bm25_scan_wide(
        t["post_docs"], t["post_tf"], t["post_ni"], t["post_lens"],
        torch.from_numpy(bi), torch.from_numpy(lo), torch.from_numpy(hi),
        boost, avgdl, nfd, DOCS, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert int((got > 0).sum()) > 2000


@pytest.mark.parametrize("block", [1024, 4096])
def test_scan_packed_matches_mk_pallas_packed(bench, data, interpret, block):
    bi, lo, hi, ni_b, nb = _plan(data, block)
    ni_i32 = ni_b.astype(np.int32)        # as the bench passes it (:440)
    boost, avgdl, nfd = _scalars(data)
    want = bench.mk_pallas_packed(block)(
        jnp.asarray(data["post_docs"]), jnp.asarray(data["packed"]),
        jnp.asarray(bi), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(ni_i32), jnp.float32(boost), jnp.float32(avgdl),
        jnp.float32(nfd), n_docs=DOCS, n_blocks=nb)
    packed = torch.from_numpy(data["packed"])
    got = port.bm25_scan_packed(
        torch.from_numpy(data["post_docs"]), packed, torch.from_numpy(bi),
        torch.from_numpy(lo), torch.from_numpy(hi),
        torch.from_numpy(ni_i32), boost, avgdl, nfd, DOCS, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # the port's packer gives the bench's plane
    assert torch.equal(port.pack_tf_lens(
        torch.from_numpy(data["post_tf"]), torch.from_numpy(
            data["post_lens"])), packed)


def test_packed_plane_unpacks_with_a_logical_shift():
    """A lens of 2^15 or more sets the int32's sign bit: the plain
    version's arithmetic shift must be masked back to the logical one."""
    tf = torch.tensor([1.0, 5.0, 3.0])
    lens = torch.tensor([40000.0, 65535.0, 9.0])
    packed = port.pack_tf_lens(tf, lens)
    assert int(packed[0]) < 0 and int(packed[1]) < 0
    docs = torch.tensor([0, 1, 2] + [0] * 1021, dtype=torch.int32)
    plane = torch.zeros(1024, dtype=torch.int32)
    plane[:3] = packed
    plan = [torch.tensor([x], dtype=torch.int32) for x in (0, 0, 3)]
    got = port.bm25_scan_packed(docs, plane, *plan,
                                torch.tensor([10], dtype=torch.int32),
                                1.0, 50.0, 1000.0, 3, 1024)
    want = port._bm25_contrib(tf, torch.full((3,), 10.0), lens,
                              torch.tensor(1.0), torch.tensor(50.0),
                              torch.tensor(1000.0))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_tool_validates_and_times_every_row_on_the_cpu(data):
    """tools/bm25_scan_bench.py on the CPU: every scan row (K1 among them)
    held to the numpy oracle (its relative error recorded) and timed with
    its plain version, host times; no row has a library call."""
    out = tool.run(data, "cpu", iters=1)
    assert out["clock"] == "host" and out["postings"] == sum(data["dfs"])
    rows = {"segsum", "k1_1024"} | {f"{f}_{b}" for f in ("pl4", "plp")
                                    for b in port.SCAN_BLOCKS}
    assert set(out["results"]) == rows
    for name, rec in out["results"].items():
        assert rec["share"] is None and rec["ms"] > 0
        assert rec["library_ms"] is None
        if name != "segsum":
            assert rec["rel_err"] <= tool.REL_TOL and rec["plain_ms"] > 0
