"""ops/bm25.py of the PyTorch port against the JAX package: the K1 posting
scan and the K4 phrase counts (their plain torch versions, as the CPU runs
them), the host helpers, the phrase stream layout and the dense head-term
rows. Inputs are made with numpy from a seed and fed to both packages."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from orama_core_tpu.ops import bm25 as ref
from orama_core_tpu_torch.ops import bm25 as port


def T(a):
    return torch.from_numpy(np.array(a))


def _scan_corpus():
    # the shapes of tests/test_pallas_knn.py::test_bm25_pallas_block_gather
    rng = np.random.default_rng(0)
    cap, p = 4096, 8192
    docs = rng.integers(0, cap, p).astype(np.int32)
    tf = rng.uniform(1, 4, p).astype(np.float32)
    ni = rng.uniform(1, 300, p).astype(np.float32)
    plens = rng.uniform(5, 60, p).astype(np.float32)
    spans = [(3, 700), (1000, 1537), (2048, 2560), (5000, 5003)]
    return cap, docs, tf, ni, plens, [a for a, _ in spans], [b - a for a, b in spans]


def test_k1_plain_matches_pallas_interpret():
    cap, docs, tf, ni, plens, p_lo, p_len = _scan_corpus()
    nb = 64
    sb, lo, hi = ref.build_block_plan_aligned(p_lo, p_len, nb)
    want = np.asarray(ref.bm25_scores_blocked_pallas(
        jnp.asarray(docs), jnp.asarray(tf), jnp.asarray(ni),
        jnp.asarray(plens), jnp.asarray(sb), jnp.asarray(lo),
        jnp.asarray(hi), jnp.float32(1.3), jnp.float32(30.0),
        jnp.float32(10000.0), n_docs=cap, n_blocks=nb, interpret=True,
    ))
    # the wrapper takes the plain version for CPU tensors
    got = port.bm25_scores_blocked_aligned(
        T(docs), T(tf), T(ni), T(plens), T(sb), T(lo), T(hi), 1.3, 30.0,
        10000.0, n_docs=cap, n_blocks=nb,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got > 0).sum() > 1000


def test_k1_drops_doc_ids_outside_the_row():
    """A posting whose doc id lies outside [0, n_docs) adds nothing, as
    the reference's segment_sum drops it (held against its Pallas kernel
    in interpret mode); in a batch the id is bounded by its own row, and
    each row equals the single-row scan of its plan."""
    cap, docs, tf, ni, plens, p_lo, p_len = _scan_corpus()
    docs = docs.copy()
    docs[[3, 4, 700, 1000, 1536, 2100]] = [cap, cap + 5, -1, 2**31 - 1,
                                           -(2**31), cap]
    nb = 64
    sb, lo, hi = ref.build_block_plan_aligned(p_lo, p_len, nb)
    want = np.asarray(ref.bm25_scores_blocked_pallas(
        jnp.asarray(docs), jnp.asarray(tf), jnp.asarray(ni),
        jnp.asarray(plens), jnp.asarray(sb), jnp.asarray(lo),
        jnp.asarray(hi), jnp.float32(1.3), jnp.float32(30.0),
        jnp.float32(10000.0), n_docs=cap, n_blocks=nb, interpret=True,
    ))
    got = port.bm25_scores_blocked_aligned(
        T(docs), T(tf), T(ni), T(plens), T(sb), T(lo), T(hi), 1.3, 30.0,
        10000.0, n_docs=cap, n_blocks=nb,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rows = [(p_lo[:2], p_len[:2]), (p_lo[2:], p_len[2:])]
    plan = port.build_batch_plan_aligned(rows)
    batch = port.bm25_scores_blocked_aligned_batch(
        T(docs), T(tf), T(ni), T(plens), *[T(a) for a in plan], 1.3, 30.0,
        10000.0, n_docs=cap, n_blocks=len(plan[0]), b=2,
    ).numpy()
    for r, (lo_r, len_r) in enumerate(rows):
        nb_r = 32
        one = port.bm25_scores_blocked_aligned(
            T(docs), T(tf), T(ni), T(plens),
            *[T(a) for a in port.build_block_plan_aligned(lo_r, len_r, nb_r)],
            1.3, 30.0, 10000.0, n_docs=cap, n_blocks=nb_r,
        ).numpy()
        np.testing.assert_allclose(batch[r], one, rtol=0, atol=1e-5)


def test_unaligned_blocked_scan_matches():
    cap, docs, tf, ni, plens, p_lo, p_len = _scan_corpus()
    # +BLOCK tail as the device cache pads
    pad = lambda a: np.concatenate([a, np.zeros(1024, a.dtype)])  # noqa: E731
    docs, tf, ni, plens = pad(docs), pad(tf), pad(ni), pad(plens)
    nb = 16
    bs, bv = ref.build_block_plan(p_lo, p_len, nb)
    want = np.asarray(ref.bm25_scores_blocked(
        jnp.asarray(docs), jnp.asarray(tf), jnp.asarray(ni),
        jnp.asarray(plens), jnp.asarray(bs), jnp.asarray(bv),
        jnp.float32(2.0), jnp.float32(25.0), jnp.float32(9000.0),
        n_docs=cap, n_blocks=nb,
    ))
    got = port.bm25_scores_blocked(
        T(docs), T(tf), T(ni), T(plens), T(bs), T(bv), 2.0, 25.0, 9000.0,
        n_docs=cap, n_blocks=nb,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_host_helpers_equal():
    rng = np.random.default_rng(4)
    p_lo = [int(x) for x in rng.integers(0, 50_000, 12)]
    p_len = [int(x) for x in rng.integers(0, 5000, 12)]
    assert port.PLAN_BUCKETS == ref.PLAN_BUCKETS
    assert port.BLOCK == ref.BLOCK and port.PAD_DOC == ref.PAD_DOC
    assert port.aligned_blocks_needed(p_len) == ref.aligned_blocks_needed(p_len)
    for nb in (16, 64, 256):
        for a, b in zip(port.build_block_plan(p_lo, p_len, nb),
                        ref.build_block_plan(p_lo, p_len, nb)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(port.build_block_plan_aligned(p_lo, p_len, nb),
                        ref.build_block_plan_aligned(p_lo, p_len, nb)):
            np.testing.assert_array_equal(a, b)
    ni = rng.integers(1, 900, 20)
    np.testing.assert_array_equal(port.idf_from_counts(ni, 1000),
                                  ref.idf_from_counts(ni, 1000))
    sel_p = port.pad_dense_sel([3, 1, 4], [0.5, 0.25, 2.0])
    sel_r = ref.pad_dense_sel([3, 1, 4], [0.5, 0.25, 2.0])
    for a, b in zip(sel_p, sel_r):
        np.testing.assert_array_equal(a, b)
    # window meta over a doc-sorted stream (regular and degenerate)
    for lens in (rng.integers(3, 12, 800), np.ones(6000, np.int64)):
        bounds = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=bounds[1:])
        pp = int(bounds[-1])
        pp_pad = -(-pp // 16384) * 16384
        mp = port.phrase_window_meta(bounds, pp, pp_pad)
        mr = ref.phrase_window_meta(bounds, pp, pp_pad)
        assert (mp is None) == (mr is None)
        if mp is not None:
            np.testing.assert_array_equal(mp[0], mr[0])
            assert mp[1:] == mr[1:]


def _dense_fixture():
    rng = np.random.default_rng(3)
    n_docs, n_terms = 64, 12
    post, term_starts = [], [0]
    for t in range(n_terms):
        docs = (np.arange(n_docs) if t == 0 else np.sort(
            rng.choice(n_docs, size=int(rng.integers(2, 7)), replace=False)))
        for d in docs:
            post.append((d, float(rng.integers(1, 4))))
        term_starts.append(len(post))
    term_starts = np.asarray(term_starts, np.int64)
    post_docs = np.asarray([p[0] for p in post], np.int32)
    post_tf = np.asarray([p[1] for p in post], np.float32)
    doc_lens = rng.integers(4, 30, size=n_docs).astype(np.float32)
    return n_docs, term_starts, post_docs, post_tf, doc_lens


def test_dense_rows_match():
    n_docs, ts, pd, ptf, lens = _dense_fixture()
    avgdl = float(lens.mean())
    bp = port.build_dense_term_rows(ts, pd, ptf, lens, cap=n_docs,
                                    avgdl=avgdl, budget=4, df_ratio=2)
    br = ref.build_dense_term_rows(ts, pd, ptf, lens, cap=n_docs,
                                   avgdl=avgdl, budget=4, df_ratio=2)
    np.testing.assert_array_equal(bp[0], br[0])
    assert bp[1] == br[1]
    df = np.diff(ts).astype(np.float64)
    spans = [(0, 2), (5, 8)]
    sp = port.split_spans_dense(spans, ts, bp[1], df, float(n_docs))
    sr = ref.split_spans_dense(spans, ts, br[1], df, float(n_docs))
    assert sp == sr
    sel, w = port.pad_dense_sel(sp[2], sp[3])
    got = port.dense_rows_contrib(T(bp[0]), T(sel), T(w), 1.7).numpy()
    want = np.asarray(ref.dense_rows_contrib(
        jnp.asarray(br[0]), jnp.asarray(sel), jnp.asarray(w), jnp.float32(1.7)
    ))
    np.testing.assert_allclose(got, want, rtol=2e-6)


def _phrase_corpus(seed, lo_len, hi_len, n_docs):
    """The corpora of tests/test_ops.py::test_phrase_windowed_matches_docmajor
    (unsorted input: both packages sort it)."""
    rng = np.random.default_rng(seed)
    entries = []
    for d in range(n_docs):
        for p in range(int(rng.integers(lo_len, hi_len + 1))):
            entries.append((d, p, int(rng.integers(0, 12))))
            if rng.random() < 0.4:
                entries.append((d, p, int(rng.integers(12, 25))))
    if seed == 3:
        for p in range(5000):  # one giant doc spanning several blocks
            entries.append((n_docs, p, int(rng.integers(0, 25))))
        n_docs += 1
    return _pack_phrase(entries, n_docs, rng)


def _phrase_corpus_gaps(seed=5, n_docs=700):
    """Docs with no positions: doc 0, every 7th doc from 3, a run of 40 in
    the middle and the last 60 up to ``n_docs``."""
    rng = np.random.default_rng(seed)
    empty = ({0} | set(range(3, n_docs, 7)) | set(range(300, 340))
             | set(range(n_docs - 60, n_docs)))
    entries = []
    for d in range(n_docs):
        if d in empty:
            continue
        for p in range(int(rng.integers(3, 13))):
            entries.append((d, p, int(rng.integers(0, 12))))
            if rng.random() < 0.4:
                entries.append((d, p, int(rng.integers(12, 25))))
    return _pack_phrase(entries, n_docs, rng)


def _pack_phrase(entries, n_docs, rng):
    rng.shuffle(entries)
    e = np.asarray(entries, np.int64)
    pp = len(e)
    pp_pad = -(-pp // 16384) * 16384
    d_col = np.full(pp_pad, ref.PAD_DOC, np.int32)
    p_col = np.zeros(pp_pad, np.int32)
    t_col = np.zeros(pp_pad, np.int32)
    d_col[:pp], p_col[:pp], t_col[:pp] = e[:, 0], e[:, 1], e[:, 2]
    counts = np.bincount(e[:, 0], minlength=n_docs)
    bounds = np.zeros(n_docs + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    return n_docs, d_col, p_col, t_col, bounds, pp, pp_pad


PHRASE_CASES = [(1, 3, 12, 800), (2, 2, 6, 1200), (3, 40, 90, 120)]


@pytest.mark.parametrize("seed,lo_len,hi_len,n_docs", PHRASE_CASES)
def test_phrase_stream_sort_and_bits_equal(seed, lo_len, hi_len, n_docs):
    _n, d_col, p_col, t_col, *_ = _phrase_corpus(seed, lo_len, hi_len, n_docs)
    rd, rp, rt = jax.lax.sort(
        (jnp.asarray(d_col), jnp.asarray(p_col), jnp.asarray(t_col)),
        num_keys=2,
    )
    pd, pp_, pt = port.sort_phrase_stream(T(d_col), T(p_col), T(t_col))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pp_.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(
        port.phrase_static_bits(pd, pp_).numpy(),
        np.asarray(ref.phrase_static_bits(rd, rp)),
    )


@pytest.mark.parametrize("seed,lo_len,hi_len,n_docs", PHRASE_CASES)
def test_k4_plain_matches_reference_exactly(seed, lo_len, hi_len, n_docs):
    n_docs, d_col, p_col, t_col, bounds, pp, pp_pad = _phrase_corpus(
        seed, lo_len, hi_len, n_docs)
    rd, rp, rt = jax.lax.sort(
        (jnp.asarray(d_col), jnp.asarray(p_col), jnp.asarray(t_col)),
        num_keys=2,
    )
    spans = np.zeros((4, 2), np.int32)
    spans[0], spans[1], spans[2] = (2, 5), (7, 8), (13, 16)
    w_base, W, wsub = ref.phrase_window_meta(bounds, pp, pp_pad)
    bits_r = ref.phrase_static_bits(rd, rp)
    want_win = np.asarray(ref.phrase_boost_docmajor_windowed(
        rd, rp, rt, jnp.asarray(w_base), jnp.asarray(spans), jnp.float32(2.0),
        n_docs=n_docs, W=W, wsub=wsub, interpret=True, bits=bits_r,
    ))
    want_dm = np.asarray(ref.phrase_boost_docmajor(
        rd, rp, rt, jnp.asarray(bounds, jnp.int32), jnp.asarray(spans),
        jnp.float32(2.0), n_docs=n_docs,
    ))
    pd, pp_, pt = T(np.asarray(rd)), T(np.asarray(rp)), T(np.asarray(rt))
    got_win = port.phrase_boost_docmajor_windowed(
        pd, pp_, pt, T(w_base), T(spans), 2.0, n_docs=n_docs, W=W,
        wsub=wsub, bits=port.phrase_static_bits(pd, pp_),
    ).numpy()
    got_nobits = port.phrase_boost_docmajor_windowed(
        pd, pp_, pt, T(w_base), T(spans), 2.0, n_docs=n_docs, W=W, wsub=wsub,
    ).numpy()
    got_dm = port.phrase_boost_docmajor(
        pd, pp_, pt, T(bounds.astype(np.int32)), T(spans), 2.0, n_docs=n_docs,
    ).numpy()
    # integer counts in f32: bit-identical, no tolerance
    np.testing.assert_array_equal(got_win, want_win)
    np.testing.assert_array_equal(got_nobits, want_win)
    np.testing.assert_array_equal(got_dm, want_dm)
    assert (got_win > 2.0).sum() > 0


@pytest.mark.parametrize("case", PHRASE_CASES + ["gaps"],
                         ids=["c1", "c2", "giant_doc", "gaps"])
def test_k4_bounds_counts_match_reference_exactly(case):
    """K4's counting contract: the per-doc CSR bounds of the stream in,
    (anyorder, seq) int32 out. The plain version against the reference's
    cumsum form (phrase_boost_docmajor), its windowed form in interpret
    mode where the corpus admits windows, and the reference's own flags
    summed between the bounds; empty and overlapping spans among the
    query's, and (in ``gaps``) docs with no positions at doc 0, inside the
    stream and up to n_docs. Counts are exact."""
    if case == "gaps":
        n_docs, d_col, p_col, t_col, bounds, pp, pp_pad = _phrase_corpus_gaps()
    else:
        n_docs, d_col, p_col, t_col, bounds, pp, pp_pad = _phrase_corpus(
            *case)
    rd, rp, rt = jax.lax.sort(
        (jnp.asarray(d_col), jnp.asarray(p_col), jnp.asarray(t_col)),
        num_keys=2,
    )
    spans = np.asarray([[2, 5], [4, 8], [0, 0], [13, 16]], np.int32)
    b32 = bounds.astype(np.int32)
    bits_r = ref.phrase_static_bits(rd, rp)
    want = np.asarray(ref.phrase_boost_docmajor(
        rd, rp, rt, jnp.asarray(b32), jnp.asarray(spans), jnp.float32(2.0),
        n_docs=n_docs,
    ))
    pd, pp_, pt = T(np.asarray(rd)), T(np.asarray(rp)), T(np.asarray(rt))
    bits = port.phrase_static_bits(pd, pp_)
    np.testing.assert_array_equal(
        port.stream_doc_bounds(pd, n_docs).numpy(), b32)
    a, s = port.phrase_counts_plain(bits, pt, T(b32), T(spans), n_docs)
    assert a.dtype == torch.int32 and a.shape == (n_docs,)
    assert s.dtype == torch.int32 and s.shape == (n_docs,)
    anyc, seqc = ref._phrase_group_flags_bits(bits_r, rt, jnp.asarray(spans))
    for got, flags in ((a, anyc), (s, seqc)):
        cs = np.concatenate([[0], np.cumsum(np.asarray(flags, np.int64))])
        np.testing.assert_array_equal(got.numpy(), cs[bounds[1:]]
                                      - cs[bounds[:-1]])
    np.testing.assert_array_equal(port._boost_from_counts(a, s, 2.0).numpy(),
                                  want)
    # the windowed entry point with the bounds given, and derived
    for given in (T(b32), None):
        got = port.phrase_boost_docmajor_windowed(
            pd, pp_, pt, None, T(spans), 2.0, n_docs=n_docs, W=0, wsub=0,
            bits=bits, bounds=given,
        ).numpy()
        np.testing.assert_array_equal(got, want)
    meta = ref.phrase_window_meta(bounds, pp, pp_pad)
    if meta is not None:
        w_base, W, wsub = meta
        want_win = np.asarray(ref.phrase_boost_docmajor_windowed(
            rd, rp, rt, jnp.asarray(w_base), jnp.asarray(spans),
            jnp.float32(2.0), n_docs=n_docs, W=W, wsub=wsub, interpret=True,
            bits=bits_r,
        ))
        np.testing.assert_array_equal(want_win, want)
    assert int(a.sum()) > 0 and int(s.sum()) > 0
    if case == "gaps":
        empty = np.diff(bounds) == 0
        assert empty[0] and empty[-60:].all() and empty[300:340].all()
        assert not a.numpy()[empty].any() and not s.numpy()[empty].any()


def test_phrase_stream_cache_bounds_match_bincount():
    """The device cache's K4 input: the sorted stream's term ids and bits,
    and per-doc bounds built on the device from the sorted doc column,
    equal to the reference's host form np.cumsum(np.bincount(...)) at the
    capacity the engine asks for (equal to, and above, the docs the field
    holds); the doc column itself is not kept."""
    from orama_core_tpu_torch.config import GpuConfig
    from orama_core_tpu_torch.engine.collection_read import _DeviceCache
    from orama_core_tpu_torch.index import CommittedStringIndex, TermDict

    rng = np.random.default_rng(11)
    n_docs, n_terms = 90, 15
    never = set(range(0, 90, 9)) | set(range(40, 50)) | set(range(80, 90))
    pool = np.asarray([d for d in range(n_docs) if d not in never])
    term_starts, post_docs, pos_starts, positions = [0], [], [0], []
    for _t in range(n_terms):
        ds = np.sort(rng.choice(pool, int(rng.integers(1, 30)), replace=False))
        for d in ds:
            post_docs.append(d)
            ps = np.sort(rng.choice(20, int(rng.integers(1, 4)), replace=False))
            positions += ps.tolist()
            pos_starts.append(len(positions))
        term_starts.append(len(post_docs))
    s = CommittedStringIndex(
        term_dict=TermDict([f"t{i:03d}" for i in range(n_terms)]),
        term_starts=np.asarray(term_starts, np.int64),
        post_docs=np.asarray(post_docs, np.int32),
        post_tf=np.ones(len(post_docs), np.float32),
        pos_starts=np.asarray(pos_starts, np.int64),
        positions=np.asarray(positions, np.int32),
        doc_lens_dense=np.ones(n_docs, np.float32),
        n_docs_with_field=n_docs, total_len=len(positions),
    )
    cache = _DeviceCache(GpuConfig(device="cpu"))
    pos_doc = np.repeat(s.post_docs, np.diff(s.pos_starts))
    held = int(pos_doc.max()) + 1
    assert held < n_docs  # the last docs hold no positions
    for cap in (held, n_docs, 128):
        terms, bits, bounds = cache.phrase_stream_arrays(s, cap)
        want = np.zeros(cap + 1, np.int64)
        np.cumsum(np.bincount(pos_doc, minlength=cap)[:cap], out=want[1:])
        assert bounds.dtype == torch.int32
        np.testing.assert_array_equal(bounds.numpy(), want)
    # terms and bits are those of the (doc, pos)-sorted stream
    pp = len(positions)
    pp_pad = terms.shape[0]
    d_col = np.full(pp_pad, port.PAD_DOC, np.int32)
    p_col = np.zeros(pp_pad, np.int32)
    t_col = np.zeros(pp_pad, np.int32)
    d_col[:pp], p_col[:pp] = pos_doc, s.positions
    t_col[:pp] = np.repeat(np.repeat(np.arange(n_terms), np.diff(term_starts)),
                           np.diff(s.pos_starts))
    sd, sp, st = port.sort_phrase_stream(T(d_col), T(p_col), T(t_col))
    np.testing.assert_array_equal(terms.numpy(), st.numpy())
    np.testing.assert_array_equal(bits.numpy(),
                                  port.phrase_static_bits(sd, sp).numpy())
    kept = cache._store[(id(s), "phrase")]
    assert len(kept) == 3 and not any(
        t.dtype == torch.int32 and t.shape[0] == pp_pad and torch.equal(t, sd)
        for t in kept)
    # one bounds variant per capacity is kept
    assert [k for k in cache._store if isinstance(k[1], tuple)
            and k[1][0] == "phrase_bounds"] == [(id(s), ("phrase_bounds", 128))]


def test_scalars_stay_python_numbers():
    """The K1 and K4 wrappers take a Python number as a number (a kernel
    argument, or a scalar operand of torch.where) and a 0-d tensor as a
    tensor, with the same result."""
    from orama_core_tpu_torch.ops import _cuda

    assert _cuda.scalar_arg(1.25, "cpu") == (None, None, 1.25)
    t, p, v = _cuda.scalar_arg(torch.tensor(2.5, dtype=torch.float64), "cpu")
    assert t.dtype == torch.float32 and t.dim() == 0 and p == t.data_ptr()
    assert v == 0.0 and float(t) == 2.5
    a = torch.tensor([0, 3, 1, 0], dtype=torch.int32)
    s = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    for ub in (1.3, 0.1, 7.0):
        got = port._boost_from_counts(a, s, ub)
        want = port._boost_from_counts(a, s, torch.tensor(ub))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_k4_degenerate_corpus_matches_docmajor():
    """One-token docs: the reference's windowed layout refuses the corpus
    (meta None, tests/test_ops.py:349) and serves it with the cumsum
    version; the port's K4 needs no windows and must give the same."""
    n_docs = 6000
    rng = np.random.default_rng(9)
    d_col = np.full(16384, ref.PAD_DOC, np.int32)
    d_col[:n_docs] = np.arange(n_docs)
    p_col = np.zeros(16384, np.int32)
    t_col = np.zeros(16384, np.int32)
    t_col[:n_docs] = rng.integers(0, 20, n_docs)
    bounds = np.arange(n_docs + 1, dtype=np.int64)
    assert ref.phrase_window_meta(bounds, n_docs, 16384) is None
    spans = np.asarray([[0, 3], [5, 6], [0, 0], [0, 0]], np.int32)
    want = np.asarray(ref.phrase_boost_docmajor(
        jnp.asarray(d_col), jnp.asarray(p_col), jnp.asarray(t_col),
        jnp.asarray(bounds, jnp.int32), jnp.asarray(spans), jnp.float32(1.0),
        n_docs=n_docs,
    ))
    got = port.phrase_boost_docmajor_windowed(
        T(d_col), T(p_col), T(t_col), T(np.zeros(1, np.int32)), T(spans),
        1.0, n_docs=n_docs, W=0, wsub=0,
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_span_path_and_phrase_by_doc_match():
    """The multi-dispatch span scorer (bm25_scores_from_spans, with and
    without its phrase boost) against the reference."""
    rng = np.random.default_rng(21)
    n_docs, n_terms = 300, 40
    term_starts = [0]
    docs, tfs, pos_starts, positions = [], [], [0], []
    for t in range(n_terms):
        ds = np.sort(rng.choice(n_docs, int(rng.integers(1, 60)), replace=False))
        for d in ds:
            docs.append(d)
            ps = np.sort(rng.choice(30, int(rng.integers(1, 4)), replace=False))
            tfs.append(float(len(ps)))
            positions += ps.tolist()
            pos_starts.append(len(positions))
        term_starts.append(len(docs))
    P, PP = len(docs), len(positions)
    post_docs = np.asarray(docs, np.int32)
    post_tf = np.asarray(tfs, np.float32)
    ni = np.repeat(np.diff(term_starts), np.diff(term_starts)).astype(np.float32)
    lens = rng.uniform(5, 40, P).astype(np.float32)
    ts = np.asarray(term_starts, np.int32)
    pst = np.asarray(pos_starts, np.int32)
    pos = np.asarray(positions, np.int32)
    spans = np.asarray([[3, 5], [9, 10], [20, 24]], np.int32)
    mask = (rng.random(n_docs) > 0.2).astype(np.float32)
    for phrase in (False, True):
        kw = dict(n_docs=n_docs, g_budget=4096, pp_budget=8192, phrase=phrase)
        want = np.asarray(ref.bm25_scores_from_spans(
            jnp.asarray(ts), jnp.asarray(post_docs), jnp.asarray(post_tf),
            jnp.asarray(ni), jnp.asarray(lens), jnp.asarray(pst),
            jnp.asarray(pos), jnp.asarray(spans), jnp.float32(1.5),
            jnp.asarray(mask), jnp.float32(20.0), jnp.float32(n_docs), **kw,
        ))
        got = port.bm25_scores_from_spans(
            T(ts), T(post_docs), T(post_tf), T(ni), T(lens), T(pst), T(pos),
            T(spans), 1.5, T(mask), 20.0, float(n_docs), **kw,
        ).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert (got > 0).sum() > 10
    assert P < 4096 and PP < 8192
