"""B1 and B2 of the kNN probes (ops/knn.py's probe forms, run through
their plain torch versions on the CPU) against the Pallas bodies they
port, run in Pallas interpret mode: the JAX package's
``_subblock_max_kernel`` (B1's k_base) at sub 32, 64 and 128 through
``benchmarks/knn_tune_bench.py``'s ``run_phase1`` specs, the bench's other
B1 bodies (k_mm, k_qt, k_masklast, k_rmax), which live only inside its
``main()`` and are spelled here as it spells them (:109-165), and B2:
K3's plain version on qt.T against the JAX package's
``_pallas_rescore_subblocks`` and the bench's ``pallas_rescore`` kern
(:350-393). Small shapes: BN 1,024, 2,500 valid rows of 3,072, D 128, Q
16. f32 results within rtol 1e-5, atol 1e-6 (the same bf16 products,
summed in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from orama_core_tpu.ops import pallas_knn as ref
from orama_core_tpu_torch.ops import knn as port
from orama_core_tpu_torch.tools import knn_tune_bench

BN, N, N_PAD, D, QB = 1024, 2500, 3072, 128, 16
NEG = -3.0e38
RTOL, ATOL = 1e-5, 1e-6


def _data(seed=0):
    """bf16 corpus and queries, the same values in torch and in JAX."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N_PAD, D)).astype(np.float32) / np.sqrt(D)
    q = rng.standard_normal((QB, D)).astype(np.float32)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    jv = jnp.asarray(tv.to(torch.float32).numpy(), jnp.bfloat16)
    jq = jnp.asarray(tq.to(torch.float32).numpy(), jnp.bfloat16)
    return tv, tq, jv, jq


def _run_phase1(kernel, v, qq, subr):
    """``benchmarks/knn_tune_bench.py:167-181``, in interpret mode."""
    nblocks = v.shape[0] // BN
    return pl.pallas_call(
        kernel,
        grid=(nblocks,),
        in_specs=[
            pl.BlockSpec(qq.shape, lambda i: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((BN, D), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((BN // subr, QB), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((v.shape[0] // subr, QB), jnp.float32),
        interpret=True,
    )(qq, v)


def _bench_bodies(sub, nblocks):
    """The bench's kernel bodies (:109-165) over this file's BN, N and QB
    (the bench's globals), ``sub`` being its SUB."""

    def mk_max(s_in, subr):
        return jnp.concatenate(
            [jnp.max(s_in[c * subr:(c + 1) * subr, :], 0, keepdims=True)
             for c in range(BN // subr)], 0)

    def k_mm(q_ref, v_ref, out_ref):
        sims = jax.lax.dot_general(
            v_ref[:], q_ref[:], dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        out_ref[:] = sims[:BN // sub, :]

    def k_qt(qt_ref, v_ref, out_ref):
        step = pl.program_id(0)
        sims = jax.lax.dot_general(
            v_ref[:], qt_ref[:], dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        row = jax.lax.broadcasted_iota(jnp.int32, sims.shape, 0) + step * BN
        out_ref[:] = mk_max(jnp.where(row < N, sims, NEG), sub)

    def k_masklast(q_ref, v_ref, out_ref):
        step = pl.program_id(0)
        sims = jax.lax.dot_general(
            v_ref[:], q_ref[:], dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)

        def masked():
            row = jax.lax.broadcasted_iota(
                jnp.int32, sims.shape, 0) + step * BN
            return jnp.where(row < N, sims, NEG)

        out_ref[:] = mk_max(
            jax.lax.cond(step == nblocks - 1, masked, lambda: sims), sub)

    def k_rmax(q_ref, v_ref, out_ref):
        step = pl.program_id(0)
        sims = jax.lax.dot_general(
            v_ref[:], q_ref[:], dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        row = jax.lax.broadcasted_iota(jnp.int32, sims.shape, 0) + step * BN
        s = jnp.where(row < N, sims, NEG)
        out_ref[:] = jnp.max(s.reshape(BN // sub, sub, QB), axis=1)

    return {"k_mm": k_mm, "k_qt": k_qt, "k_masklast": k_masklast,
            "k_rmax": k_rmax}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("sub", port.PROBE_SUBS)
def test_max_only_matches_subblock_max_kernel(sub):
    """k_base / k_sub64 / k_sub128: the JAX package's K2 body without its
    count, against the port's max form (and its edge form)."""
    tv, tq, jv, jq = _data()
    kern = functools.partial(ref._subblock_max_kernel, sub=sub, n_valid=N)
    want = _run_phase1(kern, jv, jq, sub)
    _close(port.subblock_max_only(tv, tq, sub, N), want)
    _close(port.subblock_max_only(tv, tq, sub, N, mask="edge"), want)
    assert (np.asarray(want)[-((N_PAD - N) // sub):] == NEG).all()


@pytest.mark.parametrize("sub", [32, 64])
@pytest.mark.parametrize("body", ["k_qt", "k_masklast", "k_rmax"])
def test_bench_max_bodies_match_port(body, sub):
    """k_qt (queries as [D, Q]), k_masklast (all padding lies in the last
    block here: 3,072 - 2,500 < 1,024) and k_rmax."""
    tv, tq, jv, jq = _data(1)
    kern = _bench_bodies(sub, N_PAD // BN)[body]
    if body == "k_qt":
        want = _run_phase1(kern, jv, jq.T, sub)
        got = port.subblock_max_only_qt(tv, tq.T.contiguous(), sub, N)
    else:
        want = _run_phase1(kern, jv, jq, sub)
        got = port.subblock_max_only(
            tv, tq, sub, N, mask="edge" if body == "k_masklast" else "all")
    _close(got, want)


@pytest.mark.parametrize("sub", [32, 64])
def test_phase1_rows_matches_k_mm(sub):
    """k_mm: the first BN / sub rows' products of every block, unmasked
    (the padding rows of the last block included)."""
    tv, tq, jv, jq = _data(2)
    want = _run_phase1(_bench_bodies(sub, N_PAD // BN)["k_mm"], jv, jq, sub)
    got = port.phase1_rows(tv, tq, BN, sub)
    assert got.shape == (N_PAD // sub, QB)
    _close(got, want)
    # the library yardstick computes the same products, rounded to bf16
    lib = knn_tune_bench.mm_library(tv, tq, BN, sub)
    assert lib.shape == (N_PAD // BN, BN // sub, QB)
    np.testing.assert_allclose(lib.reshape(-1, QB).float().numpy(),
                               np.asarray(want), rtol=1e-2, atol=1e-2)


K, SUB, PACK = 4, 32, 8


def _b2_pallas_rescore(v, qt_arr, sub_ids_flat, k, sub):
    """``benchmarks/knn_tune_bench.py:350-393`` (B2), in interpret mode."""
    nsel = sub_ids_flat.shape[0]
    assert nsel % PACK == 0

    def kern(sb_ref, qt_ref, *refs):
        v_refs, out_ref = refs[:PACK], refs[PACK]
        g0 = pl.program_id(0) * PACK
        rows = []
        for j in range(PACK):
            sims_t = jax.lax.dot_general(
                qt_ref[:], v_refs[j][:],
                dimension_numbers=(((0,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)   # [Q, sub]
            owner = (g0 + j) // k
            oh = (jax.lax.broadcasted_iota(jnp.int32, (1, QB), 1)
                  == owner).astype(jnp.float32)
            rows.append(jax.lax.dot_general(
                oh, sims_t,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32))  # [1, sub]
        out_ref[:] = jnp.concatenate(rows, axis=0)    # [PACK, sub]

    def mk_vspec(j):
        return pl.BlockSpec(
            (sub, D), lambda i, sb, j=j: (sb[i * PACK + j], 0))

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(nsel // PACK,),
        in_specs=[pl.BlockSpec((D, QB), lambda i, sb: (0, 0))]
        + [mk_vspec(j) for j in range(PACK)],
        out_specs=pl.BlockSpec((PACK, sub), lambda i, sb: (i, 0)),
    )
    return pl.pallas_call(
        kern,
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((nsel, sub), jnp.float32),
        interpret=True,
    )(sub_ids_flat, qt_arr, *([v] * PACK))


def test_b2_rescore_on_qt_matches_both_pallas_forms():
    """B2: K3's plain version on qt.T against the bench's pallas_rescore
    and the JAX package's _pallas_rescore_subblocks, on slots that select
    the corpus's last sub-block and repeat sub-blocks across queries."""
    tv, tq, jv, jq = _data(3)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, N_PAD // SUB, QB * K).astype(np.int32)
    ids[-1] = N_PAD // SUB - 1
    ids[K:2 * K] = ids[:K]
    qt = tq.T.contiguous()                                   # [D, Q]
    jqt = jq.T
    got = port.rescore_subblocks(tv, qt.T, torch.from_numpy(ids), K, SUB)
    _close(got, _b2_pallas_rescore(jv, jqt, jnp.asarray(ids), K, SUB))
    _close(got, ref._pallas_rescore_subblocks(jv, jqt, jnp.asarray(ids), K,
                                              SUB, interpret=True))


def test_tool_rows_run_on_the_cpu():
    """tools/knn_tune_bench.py end to end on the CPU at a small corpus:
    every row runs through the plain versions, and the full rows' top-k
    equals the dense top-k of the same corpus."""
    inp = knn_tune_bench.make_inputs(n=5000, q=8, device="cpu")
    out = knn_tune_bench.run(inp, iters=1)
    assert out["clock"] == "host" and out["card"] == "cpu"
    assert set(out["results"]) == set(knn_tune_bench.ROWS)
    assert all(r["share"] is None for r in out["results"].values())
    assert out["launches"] == {}
    assert all(r["launches"] == {} for r in out["results"].values())
    # k_mm alone has a one-call library equivalent; every kernel row has
    # a plain version
    assert [k for k, r in out["results"].items()
            if r["library_ms"] is not None] == ["mm"]
    for row in ("phase1", "masklast", "qt", "sub64", "sub128", "mm", "k2",
                "prescore"):
        assert out["results"][row]["plain_ms"] > 0, row
    v, q, nv = inp["vecs"], inp["queries"], inp["n_valid"]
    sims = port.sims_f32(v[:nv], q).T
    want = torch.topk(sims, knn_tune_bench.K).values
    for sub in (32, 64, 128):
        vals, ids = knn_tune_bench.full_with(inp, sub, lambda: q)
        torch.testing.assert_close(vals, want, rtol=0, atol=1e-5)
        assert (ids < nv).all()
