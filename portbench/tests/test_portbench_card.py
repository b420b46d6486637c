"""On a card: one short run of each cell through the command line, correct,
with its result line last on stdout. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(card, name):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          name, "--seed", "2147483659", "--seconds", "3",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
