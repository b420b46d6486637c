"""A run whose served path is broken underneath comes out not correct:
an answer altered where it is produced, and half of a batch answered
with the other half's replies."""

import pytest
import torch

from portbench.tests.small import run_small

CELLS = ["signal1m.rrf_batched", "msmarco_exact.vector_batched"]


def _alter_fused(monkeypatch):
    from orama_core_tpu_torch.ops import hybrid

    inner = hybrid.rrf_fuse_topk_batch

    def altered(*a, **k):
        vals, ids, counts = inner(*a, **k)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % a[0].shape[1]
        return vals, ids, counts

    monkeypatch.setattr(hybrid, "rrf_fuse_topk_batch", altered)


def _alter_knn(monkeypatch):
    from orama_core_tpu_torch.ops import knn

    inner = knn.knn_topk_with_count

    def altered(*a, **k):
        vals, ids, count = inner(*a, **k)
        return vals, torch.flip(ids, dims=[1]), count

    monkeypatch.setattr(knn, "knn_topk_with_count", altered)


def _alter_count(monkeypatch):
    from orama_core_tpu_torch.engine.collection_read import CollectionReader

    inner = CollectionReader.search_batch

    def altered(self, params_list, ai):
        return [(r, c + c // 2 + 1) for r, c in inner(self, params_list, ai)]

    monkeypatch.setattr(CollectionReader, "search_batch", altered)


def _half_batch(monkeypatch):
    from orama_core_tpu_torch.engine.collection_read import CollectionReader

    inner = CollectionReader.search_batch

    def half(self, params_list, ai):
        h = max(1, len(params_list) // 2)
        out = inner(self, params_list[:h], ai)
        return (out + out)[:len(params_list)]

    monkeypatch.setattr(CollectionReader, "search_batch", half)


@pytest.mark.parametrize("fault,name", [
    (_alter_fused, CELLS[0]), (_alter_knn, CELLS[1]),
    (_alter_count, CELLS[0]), (_alter_count, CELLS[1]),
    (_half_batch, CELLS[0]), (_half_batch, CELLS[1]),
])
def test_a_broken_path_is_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    out = run_small(name, clients=16)
    assert out["correct"] is False, out["checks"]
