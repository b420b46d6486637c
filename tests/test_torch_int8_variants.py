"""tools/knn_int8_variants.py on the CPU: every variant's edits still find
the text they replace in csrc/ (so the tool breaks here, not on the card,
when K5's sources move on), and the tool refuses to run without a card."""

import os

import pytest
import torch

from orama_core_tpu_torch.ops import _cuda
from orama_core_tpu_torch.tools import knn_int8_variants as kiv
from orama_core_tpu_torch.tools import knn_wide_variants as kwv


@pytest.mark.parametrize("name", sorted(kiv.VARIANTS))
def test_int8_variant_edits_apply_to_the_sources(tmp_path, name):
    src = kwv.prepare(name, str(tmp_path), kiv.VARIANTS)
    changed = []
    for fn in sorted(os.listdir(_cuda.CSRC)):
        with open(os.path.join(_cuda.CSRC, fn), encoding="utf-8") as f:
            ours = f.read()
        with open(os.path.join(src, fn), encoding="utf-8") as f:
            theirs = f.read()
        if ours != theirs:
            changed.append(fn)
    assert changed == sorted({e[0] for e in kiv.VARIANTS[name]})


def test_int8_variants_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is checked without a card")
    assert kiv.main(["--iters", "1"]) == 2
