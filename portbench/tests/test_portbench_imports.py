"""No module that a run loads is the JAX package or JAX itself, and the
reference loads nothing of the program."""

import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "orama_core_tpu"}

RUN = """
import sys
from portbench import run
from portbench.tests.small import run_small
for name in {names!r}:
    run_small(name, traced=True)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _top_level(stdout):
    return set(eval(stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = [w["name"] for w in spec.load_benchmark()["workloads"]]
    out = subprocess.run([sys.executable, "-c", RUN.format(names=names)],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = _top_level(out.stdout)
    assert "orama_core_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\nimport portbench.reference.search\n"
            "import portbench.compare\n"
            "import portbench.comparisons.rrf_topk\n"
            "import portbench.comparisons.vector_topk\n"
            "import portbench.comparisons.bm25_topk\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert not _top_level(out.stdout) & (FORBIDDEN | {"orama_core_tpu_torch"})


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "signal1m.rrf_batched", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
