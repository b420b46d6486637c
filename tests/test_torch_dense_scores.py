"""The batched serving product's routing and its plain twin, on the CPU.

``ops/vector.brute_force_scores_batch`` takes the dense scores kernel
(csrc/knn_dense_scores.cu) for a bf16 corpus on the card in the identity
layout, and its torch code, the plain twin, for every other corpus. Here
the twin is held to a direct NumPy computation of
``max(q_bf16 . v_bf16, 0) * valid * mask`` (summed per doc where a doc
has several rows), the kernel's wrapper to each input it must refuse,
and the routing to the corpora that have no kernel. The kernel itself is held to the twin on the card
(``tests/test_torch_kernels_gpu.py``, ``-k dense``)."""

import os
import re

import numpy as np
import pytest
import torch

from orama_core_tpu_torch.ops import _cuda
from orama_core_tpu_torch.ops import vector as vops
from orama_core_tpu_torch.utils import tracing

D = 64


def _corpus(rng, p, d=D, dtype=torch.bfloat16):
    v = rng.standard_normal((p, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return torch.tensor(v).to(dtype)


def _zeros_in(rng, n, share=0.2):
    """f32[n] of ones with about ``share`` of it zero."""
    return torch.tensor((rng.random(n) >= share).astype(np.float32))


def _numpy_scores(vecs, vec_docs, valid, queries, mask, n_docs, identity):
    """float64 [B, n_docs]: the reference's arithmetic on the bf16 values
    (queries rounded to bf16 as the corpus is), in NumPy."""
    v = vecs.to(torch.float64).numpy()
    q = queries.to(torch.bfloat16).to(torch.float64).numpy()
    s = np.maximum(q @ v.T, 0.0) * valid.numpy()[None, :].astype(np.float64)
    out = np.zeros((q.shape[0], n_docs))
    if identity:
        m = min(v.shape[0], n_docs)
        out[:, :m] = s[:, :m]
    else:
        for row in range(q.shape[0]):
            np.add.at(out[row], vec_docs.numpy().astype(np.int64), s[row])
    return out * mask.numpy()[None, :]


LAYOUTS = {
    # identity, rows, n_docs: a pad past the corpus, a corpus cut to n_docs
    "pad": (True, 300, 347),
    "slice": (True, 410, 347),
    # 347 docs of one to three rows each, in doc order
    "multi": (False, None, 347),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("b", [1, 16, 65])
def test_plain_twin_against_numpy(layout, b):
    identity, p, n_docs = LAYOUTS[layout]
    rng = np.random.default_rng(b * 7 + len(layout))
    if identity:
        vec_docs = torch.arange(p, dtype=torch.int32)
    else:
        vec_docs = torch.tensor(np.sort(np.concatenate(
            [np.arange(n_docs), rng.integers(0, n_docs, 250)])),
            dtype=torch.int32)
        p = vec_docs.shape[0]
    vecs = _corpus(rng, p)
    valid = _zeros_in(rng, p)
    mask = _zeros_in(rng, n_docs)
    queries = torch.tensor(rng.standard_normal((b, D)).astype(np.float32))
    queries /= queries.norm(dim=1, keepdim=True)
    got = vops.brute_force_scores_batch(vecs, vec_docs, valid, queries, mask,
                                        n_docs=n_docs, identity=identity)
    want = _numpy_scores(vecs, vec_docs, valid, queries, mask, n_docs,
                         identity)
    assert got.dtype == torch.float32 and got.shape == (b, n_docs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)
    # exact zeros wherever the mask, the row's validity, the clamp or the
    # pad zero a score
    g = got.numpy()
    assert (g[:, mask.numpy() == 0] == 0).all()
    assert (g[want == 0] == 0).all()
    if identity:
        m = min(p, n_docs)
        assert (g[:, :m][:, valid.numpy()[:m] == 0] == 0).all()
        assert (g[:, m:] == 0).all()
    assert (g > 0).sum() > b * n_docs // 5   # the positives are there


def _eligible(rng, p=96, d=D, n_docs=128):
    """Inputs the kernel reads (on a CUDA device)."""
    return dict(vecs=_corpus(rng, p, d), vec_valid=torch.ones(p),
                filter_mask=torch.ones(n_docs), n_docs=n_docs)


def _misaligned(rng, p=96, d=D):
    flat = _corpus(rng, p * d + 1, 1).reshape(-1)
    v = flat[1:].view(p, d)       # 2 bytes past a 16-byte boundary
    assert v.is_contiguous() and v.data_ptr() % 16
    return v


UNREADABLE = {  # case: (edit of the eligible inputs, what the error names)
    "d_not_multiple_of_8": (lambda rng, kw: kw.update(
        vecs=_corpus(rng, 96, 60)), "D % 8"),
    "d_too_wide": (lambda rng, kw: kw.update(
        vecs=_corpus(rng, 2, vops._STREAM_MAX_D + 8), vec_valid=torch.ones(2)),
        "D <="),
    "misaligned_view": (lambda rng, kw: kw.update(vecs=_misaligned(rng)),
                        "16-byte aligned"),
    "strided_corpus": (lambda rng, kw: kw.update(
        vecs=_corpus(rng, 96, 2 * D)[:, :D]), "contiguous bf16"),
    "f64_mask": (lambda rng, kw: kw.update(
        filter_mask=kw["filter_mask"].double()), "filter_mask"),
    "mask_of_other_length": (lambda rng, kw: kw.update(
        filter_mask=torch.ones(kw["n_docs"] + 1)), "filter_mask"),
    "valid_of_other_length": (lambda rng, kw: kw.update(
        vec_valid=torch.ones(95)), "vec_valid"),
    "off_the_card": (lambda rng, kw: None, "card"),
}


@pytest.mark.parametrize("case", sorted(UNREADABLE))
def test_dense_scores_refuses_inputs_it_cannot_read(case):
    """The kernel's wrapper raises, as K2's does, on each input the kernel
    cannot read; on a corpus otherwise fit for it, these are the errors
    ``brute_force_scores_batch`` raises on the card (no torch fallback).
    The layout rules come before the device rule, so on the CPU each case
    names its own fault, and inputs fit for the kernel name the device
    alone (``off_the_card``, the positive control)."""
    rng = np.random.default_rng(1)
    kw = _eligible(rng)
    edit, names = UNREADABLE[case]
    edit(rng, kw)
    queries = torch.tensor(rng.standard_normal((4, kw["vecs"].shape[1]))
                           .astype(np.float32))
    before = _cuda.LAUNCHES["knn_dense_scores"]
    with pytest.raises(ValueError, match=re.escape(names)):
        vops.dense_scores(kw["vecs"], kw["vec_valid"], queries,
                          kw["filter_mask"], kw["n_docs"])
    assert _cuda.LAUNCHES["knn_dense_scores"] == before


NO_KERNEL = {  # corpora the kernel is not for: (edit, identity)
    "cpu_bf16_identity": (lambda rng, kw: None, True),
    "f32_corpus": (lambda rng, kw: kw.update(vecs=kw["vecs"].float()), True),
    "non_identity": (lambda rng, kw: None, False),
    "empty_corpus": (lambda rng, kw: kw.update(
        vecs=kw["vecs"][:0], vec_valid=kw["vec_valid"][:0]), True),
}


@pytest.mark.parametrize("case", sorted(NO_KERNEL))
def test_corpora_without_a_kernel_take_the_torch_path(case):
    """CPU tensors, f32 corpora, several rows a doc and an empty corpus
    have no kernel: ``brute_force_scores_batch`` is the plain twin there,
    launches nothing, and names the torch route on the open span."""
    rng = np.random.default_rng(1)
    kw = _eligible(rng)
    edit, identity = NO_KERNEL[case]
    edit(rng, kw)
    p = kw["vecs"].shape[0]
    queries = torch.tensor(rng.standard_normal((4, D)).astype(np.float32))
    docs = torch.arange(p, dtype=torch.int32) % kw["n_docs"]
    args = (kw["vecs"], docs, kw["vec_valid"], queries, kw["filter_mask"])
    before = _cuda.LAUNCHES["knn_dense_scores"]
    tracing.enable()
    try:
        with tracing.span("outer"):
            got = vops.brute_force_scores_batch(*args, n_docs=kw["n_docs"],
                                                identity=identity)
        (rec,) = [s for s in tracing.spans() if s["name"] == "outer"]
    finally:
        tracing.disable()
    want = vops.brute_force_scores_batch_plain(*args, n_docs=kw["n_docs"],
                                               identity=identity)
    assert torch.equal(got, want)
    assert rec["fields"]["route"] == "torch"
    assert _cuda.LAUNCHES["knn_dense_scores"] == before


def test_routes_to_the_kernel_on_a_card_corpus(monkeypatch):
    """A bf16 identity corpus on the card goes to ``dense_scores`` with no
    check of its layout on the way (``dense_scores`` raises where it cannot
    read it), and the batched fused program's ``fused.vector`` span names
    the route. The card stood in for by a CPU corpus that reports
    ``is_cuda``, the kernel by the plain twin."""
    from orama_core_tpu_torch.ops import hybrid

    rng = np.random.default_rng(2)
    kw = _eligible(rng)
    calls = []

    def fake_kernel(vecs, vec_valid, queries, filter_mask, n_docs):
        calls.append(queries.shape[0])
        return vops.brute_force_scores_batch_plain(
            vecs, None, vec_valid, queries, filter_mask, n_docs, True)

    class CardCorpus(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    b, n_docs = 3, kw["n_docs"]
    queries = rng.standard_normal((b, D)).astype(np.float32)
    flts = torch.tensor(np.concatenate([[1.0, 1.0, 1.0], queries.ravel()])
                        .astype(np.float32))
    z = torch.zeros(1)

    def fused(vecs):
        tracing.enable()
        try:
            vals, ids, counts = hybrid.hybrid_fused_topk_batch(
                torch.zeros(1, dtype=torch.int32), flts, z, z, z, z, z,
                vecs, torch.arange(96, dtype=torch.int32),
                kw["vec_valid"], kw["filter_mask"], None, None, None,
                n_docs=n_docs, k=8, fusion="rrf", nf="none", masked=False,
                mode="vector", n_blocks=1, b=b, qdim=D, dense=False,
                vec_identity=True)
            (sp,) = [s for s in tracing.spans() if s["name"] == "fused.vector"]
        finally:
            tracing.disable()
        return (vals, ids, counts), sp["fields"]["route"]

    torch_out, route = fused(kw["vecs"])
    assert route == "torch" and not calls
    monkeypatch.setattr(vops, "dense_scores", fake_kernel)
    kernel_out, route = fused(kw["vecs"].as_subclass(CardCorpus))
    assert route == "kernel" and calls == [b]
    for a, w in zip(kernel_out, torch_out):
        assert torch.equal(torch.as_tensor(a), w)


def test_dense_scores_kernel_is_registered_on_the_streaming_core():
    """The kernel's library is built by ``build_all`` (every SIGNATURES
    entry; tests/test_torch_cuda_build.py checks its source and entry
    point), counted in LAUNCHES, and runs on the streaming core of K2."""
    assert "knn_dense_scores" in _cuda.SIGNATURES
    assert "knn_dense_scores" in _cuda.LAUNCHES
    text = open(os.path.join(_cuda.CSRC, "knn_dense_scores.cu"),
                encoding="utf-8").read()
    assert '#include "knn_stream.cuh"' in text
    assert len(_cuda.SIGNATURES["knn_dense_scores"]["knn_dense_scores"]) == 10
