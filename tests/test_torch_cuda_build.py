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
    assert {"knn_stream.cuh", "bm25_tiles.cuh"} <= headers
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


def test_every_entry_point_is_exported_by_its_source():
    """Each function SIGNATURES binds is a plain-C entry point of its
    library's source, the probe forms' included (B1 on the one-pass core,
    itself on the streaming core's wrappers; B3 on the doc-tile core, which
    repairs through K1's loop)."""
    for name, fns in _cuda.SIGNATURES.items():
        text = open(os.path.join(_cuda.CSRC, f"{name}.cu"),
                    encoding="utf-8").read()
        for fn in fns:
            assert re.search(rf'extern "C" int {fn}\(', text), (name, fn)
    text = open(os.path.join(_cuda.CSRC, "knn_phase1_variants.cu"),
                encoding="utf-8").read()
    assert '#include "knn_wide.cuh"' in text
    text = open(os.path.join(_cuda.CSRC, "knn_wide.cuh"),
                encoding="utf-8").read()
    assert '#include "knn_stream.cuh"' in text
    for src in ("bm25_scan.cu", "bm25_scan_variants.cu"):
        text = open(os.path.join(_cuda.CSRC, src), encoding="utf-8").read()
        assert '#include "bm25_scan.cuh"' in text, src
    # B3 on the doc-tile core, whose repair path is K1's loop: the core
    # comes after K1's header
    text = open(os.path.join(_cuda.CSRC, "bm25_scan_variants.cu"),
                encoding="utf-8").read()
    assert (0 <= text.index('#include "bm25_scan.cuh"')
            < text.index('#include "bm25_tiles.cuh"'))
    text = open(os.path.join(_cuda.CSRC, "bm25_tiles.cuh"),
                encoding="utf-8").read()
    assert "bm25scan::scan<kBlock, kPacked, false>" in text
    for name in ("knn_max_only", "knn_max_only_edge", "knn_max_only_qt",
                 "knn_phase1_rows", "bm25_scan_wide", "bm25_scan_packed"):
        assert name in _cuda.LAUNCHES


def test_sass_diff_reads_instruction_lines_and_finds_csrc(tmp_path):
    """tools/sass_diff.py keeps only cuobjdump's instruction lines (no
    addresses, no encodings) and takes a checkout or its csrc/."""
    from orama_core_tpu_torch.tools import sass_diff

    dump = (
        "\tcode for sm_90a\n"
        "        Function : _Z3fooPf\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
        "                     /* 0x00000a00ff017b82 */\n"
        "                                                              "
        "                     /* 0x000fe20000000800 */\n"
        "        /*0010*/                   EXIT ;"
        "                                     /* 0x000000000000794d */\n")
    lines = [m.group(1) for m in map(sass_diff._INSTR.match,
                                     dump.splitlines()) if m]
    assert lines == ["LDC R1, c[0x0][0x28]", "EXIT"]
    inner = tmp_path / "orama_core_tpu_torch" / "csrc"
    inner.mkdir(parents=True)
    assert sass_diff._csrc(str(tmp_path)) == str(inner)
    assert sass_diff._csrc(str(inner)) == str(inner)
    assert set(sass_diff.SOURCES) <= set(_cuda.SIGNATURES)
    # every kernel that shares a header with a probe form is compared
    assert {"knn_subblock_max", "knn_subblock_max_mv",
            "bm25_scan"} <= set(sass_diff.SOURCES)
