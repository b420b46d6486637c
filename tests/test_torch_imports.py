"""The PyTorch port stands alone: no module of ``orama_core_tpu_torch``
imports JAX or the JAX package, by source and at run time."""

import ast
import os
import subprocess
import sys

PKG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "orama_core_tpu_torch")


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_import_in_sources():
    bad = []
    n_files = 0
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            n_files += 1
            path = os.path.join(root, name)
            for mod in _imported_modules(path):
                top = mod.split(".")[0]
                if top in ("jax", "jaxlib") or top == "orama_core_tpu":
                    bad.append((path, mod))
    assert n_files > 30
    assert not bad, bad


def test_build_orama_on_cpu_loads_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from orama_core_tpu_torch import build_orama\n"
        "from orama_core_tpu_torch.types import SearchParams\n"
        "e = build_orama(start_background=False, device='cpu')\n"
        "e.write_side.create_collection('master', 'c', 'r', 'w')\n"
        "e.flush()\n"
        "e.write_side.write('c', [{'id': '1', 'body': 'hello world'}], 'w')\n"
        "e.commit()\n"
        "r = e.read_side.search('c', SearchParams.from_json({'term': 'hello'}), 'r')\n"
        "assert r.count == 1, r\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orama_core_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG) + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_ann_commit_on_cpu_loads_no_jax(tmp_path):
    """The IVF-PQ index builds and searches (ops/ivf.py, ops/pq.py) run
    through a commit and a search without JAX in the process."""
    code = (
        "import sys\n"
        "from orama_core_tpu_torch import build_orama\n"
        "from orama_core_tpu_torch.config import OramaxConfig\n"
        "from orama_core_tpu_torch.types import SearchParams\n"
        "cfg = OramaxConfig()\n"
        "cfg.writer_side.data_dir = 'w'; cfg.reader_side.data_dir = 'r'\n"
        "cfg.ai.backend = 'fake'\n"
        "cfg.gpu.vector_index = 'ivf_pq'; cfg.gpu.ivf_threshold = 1\n"
        "e = build_orama(cfg, start_background=False, device='cpu')\n"
        "e.write_side.create_collection('master', 'c', 'r', 'w')\n"
        "e.flush()\n"
        "e.write_side.write('c', [{'id': str(i), 'body': f'doc {i} word{i % 7}'}"
        " for i in range(64)], 'w')\n"
        "e.commit()\n"
        "c = next(iter(e.read_side._reader('c')._vector.values())).committed\n"
        "assert c.has_ivf and c.has_pq, c\n"
        "r = e.read_side.search('c', SearchParams.from_json("
        "{'term': 'word3', 'mode': 'hybrid'}), 'r')\n"
        "assert r.count > 0, r\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orama_core_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG) + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
