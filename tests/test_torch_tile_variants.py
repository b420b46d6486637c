"""tools/bm25_tile_variants.py on the CPU: every variant's edits still
find the text they replace in csrc/ (so the tool breaks here, not on the
card, when the kernels' sources move on), the sweep's variants set the
tile and the block width they name, and the tool refuses to run without
a card."""

import os
import re

import pytest
import torch

from orama_core_tpu_torch.ops import _cuda
from orama_core_tpu_torch.tools import bm25_tile_variants as btv


@pytest.mark.parametrize("name", sorted(btv.VARIANTS))
def test_tile_variant_edits_apply_to_the_sources(tmp_path, name):
    src = btv.prepare(name, str(tmp_path))
    changed = []
    for fn in sorted(os.listdir(_cuda.CSRC)):
        with open(os.path.join(_cuda.CSRC, fn), encoding="utf-8") as f:
            ours = f.read()
        with open(os.path.join(src, fn), encoding="utf-8") as f:
            theirs = f.read()
        if ours != theirs:
            changed.append(fn)
    want = sorted({e[0] for e in btv.VARIANTS[name]})
    # a sweep point equal to the header's own constants changes nothing
    assert changed == want or (name.startswith("t") and changed == [])
    m = re.fullmatch(r"t(\d+)_w(\d+)", name)
    if m:
        with open(os.path.join(src, btv._HDR), encoding="utf-8") as f:
            text = f.read()
        assert f"constexpr int kTileDocs = {m.group(1)};" in text
        assert f"constexpr int kThreads = {m.group(2)};" in text


def test_tile_variant_edits_refuse_sources_that_moved_on(tmp_path,
                                                         monkeypatch):
    monkeypatch.setitem(btv.VARIANTS, "gone", [
        (btv._HDR, "text no source holds", "")])
    with pytest.raises(RuntimeError):
        btv.prepare("gone", str(tmp_path))


def test_tile_variants_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is checked without a card")
    assert btv.main(["--iters", "1"]) == 2
