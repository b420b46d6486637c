"""The reference agrees with the port at a small size on the CPU."""

import numpy as np
import pytest

from portbench.reference import search as ref
from portbench.tests.small import run_small

WORKLOADS = ["signal1m.rrf_batched", "msmarco_exact.vector_batched"]


def test_frozen_embedder_is_fake_base():
    from orama_core_tpu_torch.models.ai_service import AIService

    texts = ["term000001 term000002", "Term000003", "", "term000004 term000004"]
    want = AIService(device="cpu").embed_query("fake-base", texts)
    got = ref.HashEmbedder(384).embed(texts)
    np.testing.assert_array_equal(got, want)


def test_term_ids_read_the_vocabulary_words():
    assert ref.term_ids("term000010 term000010 Term000007 word", 50) == [10, 7]
    assert ref.term_ids("term000060", 50) == []


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_served_replies_match_the_reference(name, seed):
    out = run_small(name, seed=seed)
    assert out["failed"] == 0 and out["attempted"] > 0
    for k in ("hit_dev", "count_dev"):
        value, limit = out["checks"][k]
        assert value <= limit, (k, value, limit)
    assert out["correct"] is True
