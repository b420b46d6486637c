"""The control, the program's own int8 vector index in place of the exact
bf16 one, comes out not correct at a size a test run holds. At the cells'
own size it is run on the card by ``python3 -m portbench.readings
--index int8`` (PERF.md gives those readings and the limits)."""

import pytest

from portbench.tests.small import run_small


@pytest.mark.parametrize("name", ["signal1m.rrf_batched",
                                  "msmarco_exact.vector_batched"])
def test_the_int8_control_is_not_correct(name):
    out = run_small(name, serving={"vector_index": "int8"}, n_docs=50_000)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["hit_dev"][0] > out["checks"]["hit_dev"][1]
