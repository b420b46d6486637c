"""The port's kernel build rules (ops/_cuda.py), on the CPU: no nvcc is
needed to check when a library is stale or what each source includes."""

import os
import re

from orama_core_tpu_torch.ops import _cuda


def _touch(path, t):
    with open(path, "a"):
        pass
    os.utime(path, (t, t))


def test_fresh_follows_the_source_and_every_shared_header(tmp_path):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()

    def fresh():
        return _cuda._fresh("k", str(csrc), str(build))

    _touch(csrc / "k.cu", 100)
    _touch(csrc / "core.cuh", 100)
    assert not fresh()                       # never built
    _touch(build / "libk.so", 200)
    assert fresh()
    _touch(csrc / "core.cuh", 300)           # a shared header changed
    assert not fresh()
    _touch(build / "libk.so", 400)
    assert fresh()
    _touch(csrc / "k.cu", 500)               # its own source changed
    assert not fresh()
    _touch(build / "libk.so", 600)
    _touch(csrc / "other.cu", 900)           # another kernel's source
    assert fresh()
    _touch(csrc / "new.cuh", 700)            # a header added later
    assert not fresh()


def test_every_kernel_source_and_its_includes_exist():
    """Each library named in SIGNATURES has its csrc/<name>.cu, and every
    quoted include of a source is a header in csrc/ (so _fresh sees it)."""
    headers = {f for f in os.listdir(_cuda.CSRC) if f.endswith(".cuh")}
    assert "knn_stream.cuh" in headers
    for name in _cuda.SIGNATURES:
        src = os.path.join(_cuda.CSRC, f"{name}.cu")
        assert os.path.exists(src), src
        text = open(src, encoding="utf-8").read()
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            assert inc in headers, (name, inc)


def test_k2_and_k6_share_the_streaming_core():
    for name in ("knn_subblock_max", "knn_subblock_max_mv"):
        text = open(os.path.join(_cuda.CSRC, f"{name}.cu"),
                    encoding="utf-8").read()
        assert '#include "knn_stream.cuh"' in text
        assert f'extern "C" int {name}(' in text
