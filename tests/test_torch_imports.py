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


def test_entry_point_and_server_on_cpu_load_no_jax(tmp_path):
    """``python -m orama_core_tpu_torch --help`` and the entry point's
    server, started on the CPU with ``ai.backend = "jax"`` (the port's
    encoder and decoder), answer without JAX in the process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG) + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "orama_core_tpu_torch", "--help"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--config" in out.stdout and "orama_core_tpu_torch" in out.stdout

    code = (
        "import json, os, socket, sys, threading, time, urllib.request\n"
        "from orama_core_tpu_torch.__main__ import main\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0))\n"
        "port = s.getsockname()[1]; s.close()\n"
        "threading.Thread(target=main, args=(['--port', str(port)],),\n"
        "                 daemon=True).start()\n"
        "base = f'http://127.0.0.1:{port}'\n"
        "def req(path, body=None, bearer=None):\n"
        "    h = {'Content-Type': 'application/json'}\n"
        "    if bearer: h['Authorization'] = 'Bearer ' + bearer\n"
        "    data = json.dumps(body).encode() if body is not None else None\n"
        "    r = urllib.request.Request(base + path, data=data, headers=h,\n"
        "                               method='POST' if data else 'GET')\n"
        "    with urllib.request.urlopen(r, timeout=60) as f:\n"
        "        return f.status, f.read()\n"
        "for _ in range(600):\n"
        "    try:\n"
        "        assert req('/health')[0] == 200; break\n"
        "    except OSError:\n"
        "        time.sleep(0.1)\n"
        "req('/v1/collections/create', {'id': 'c', 'read_api_key': 'r',\n"
        "    'write_api_key': 'w'}, 'master')\n"
        "for _ in range(600):\n"
        "    try:\n"
        "        req('/v1/collections/c/insert', [{'id': '1', 'body': 'hello "
        "world'}], 'w'); break\n"
        "    except urllib.error.HTTPError:\n"
        "        time.sleep(0.1)\n"
        "for _ in range(600):\n"
        "    st, raw = req('/v1/collections/c/search?api-key=r',\n"
        "                  {'term': 'hello', 'mode': 'vector'})\n"
        "    if json.loads(raw)['count'] == 1: break\n"
        "    time.sleep(0.1)\n"
        "assert json.loads(raw)['count'] == 1, raw\n"
        "assert req('/health/ai')[0] == 200\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orama_core_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', flush=True)\n"
        "os._exit(0)\n"
    )
    env.update({
        "ORAMAX_gpu__device": "cpu",
        "ORAMAX_ai__backend": "jax",
        "ORAMAX_ai__embedding_model": "jax-minilm",
        "ORAMAX_writer_side__default_embedding_model": "jax-minilm",
        "ORAMAX_ai__llm_model": "jax-tiny",
        "ORAMAX_writer_side__data_dir": str(tmp_path / "w"),
        "ORAMAX_reader_side__data_dir": str(tmp_path / "r"),
    })
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
