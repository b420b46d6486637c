"""The PyTorch port stands alone: no module of ``orama_core_tpu_torch``
imports JAX, the JAX package or the JAX benchmarks (``benchmarks/``), by
source and at run time."""

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
                if top in ("jax", "jaxlib", "orama_core_tpu", "benchmarks"):
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


def test_main_path_loads_no_grpc(tmp_path):
    """The card's machine has neither ``grpc`` nor ``protobuf``: a hooked
    write, a commit and a search through ``build_orama(device="cpu")``
    leave neither in the process (``rpc`` loads only for
    ``ai.remote_url`` or ``ai.grpc_port``)."""
    code = (
        "import sys\n"
        "from orama_core_tpu_torch import build_orama\n"
        "from orama_core_tpu_torch.types import SearchParams\n"
        "e = build_orama(start_background=False, device='cpu')\n"
        "e.write_side.create_collection('master', 'c', 'r', 'w')\n"
        "e.flush()\n"
        "e.hooks.insert_hook('c', 'selectEmbeddingProperties',\n"
        "    'function selectEmbeddingProperties(doc) {'\n"
        "    ' return doc.kind === \"t\" ? [\"title\"] : `${doc.body}`; }')\n"
        "e.write_side.write('c', [{'id': '1', 'kind': 't', 'title': 'hello',"
        " 'body': 'world'}, {'id': '2', 'body': 'hello there'}], 'w')\n"
        "e.commit()\n"
        "r = e.read_side.search('c', SearchParams.from_json("
        "{'term': 'hello', 'mode': 'hybrid'}), 'r')\n"
        "assert r.count == 2, r\n"
        "e.close()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'grpc'\n"
        "       or m.startswith('google.protobuf')]\n"
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


def test_remote_backend_without_grpc_names_the_package(tmp_path, monkeypatch):
    """Where ``grpc`` is missing, ``ai.remote_url`` raises the ImportError,
    naming the package; the engine never serves its in-process models in
    place of the configured remote backend."""
    import pytest

    from orama_core_tpu_torch import build_orama
    from orama_core_tpu_torch.config import OramaxConfig

    for name in list(sys.modules):
        if name.startswith("orama_core_tpu_torch.rpc"):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "grpc", None)
    for key in ("remote_url", "grpc_port"):
        cfg = OramaxConfig()
        cfg.writer_side.data_dir = str(tmp_path / key / "w")
        cfg.reader_side.data_dir = str(tmp_path / key / "r")
        setattr(cfg.ai, key, "127.0.0.1:1" if key == "remote_url" else 0)
        with pytest.raises(ImportError, match="grpc"):
            build_orama(cfg, start_background=False, device="cpu")


def test_parallel_imports_no_jax():
    """``parallel/`` (mesh, sharded programs, multi-slice router) names no
    JAX module in its sources, and importing it loads none; the gRPC slice
    transport is the one module of it that needs ``grpc``."""
    par = os.path.join(PKG, "parallel")
    names = sorted(n for n in os.listdir(par) if n.endswith(".py"))
    assert {"mesh.py", "sharded_engine.py", "sharded_search.py",
            "multislice.py", "slice_grpc.py"} <= set(names)
    for name in names:
        mods = {m.split(".")[0] for m in _imported_modules(
            os.path.join(par, name))}
        assert not mods & {"jax", "jaxlib", "orama_core_tpu"}, (name, mods)
        assert ("grpc" in mods) == (name == "slice_grpc.py"), (name, mods)
    code = (
        "import sys\n"
        "import orama_core_tpu_torch.parallel.mesh\n"
        "import orama_core_tpu_torch.parallel.sharded_engine\n"
        "import orama_core_tpu_torch.parallel.sharded_search\n"
        "import orama_core_tpu_torch.parallel.multislice\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orama_core_tpu', 'grpc')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG) + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_mesh_search_loads_no_grpc_or_jax(tmp_path):
    """A mesh engine (``mesh_shape=(4, 1)``, four shards on the CPU)
    commits and serves fulltext, phrase, vector, filtered + faceted and
    hybrid queries through the mesh path without ``grpc``,
    ``google.protobuf`` or JAX in the process: the card's machine has
    neither of the first two."""
    code = (
        "import sys\n"
        "from orama_core_tpu_torch import build_orama\n"
        "from orama_core_tpu_torch.config import OramaxConfig\n"
        "from orama_core_tpu_torch.types import SearchParams\n"
        "cfg = OramaxConfig()\n"
        "cfg.writer_side.data_dir = 'w'; cfg.reader_side.data_dir = 'r'\n"
        "cfg.gpu.mesh_shape = (4, 1)\n"
        "e = build_orama(cfg, start_background=False, device='cpu')\n"
        "e.write_side.create_collection('master', 'c', 'r', 'w')\n"
        "e.flush()\n"
        "e.write_side.write('c', [{'id': str(i), 'body': f'doc {i} word{i % 7}"
        " hello world', 'n': i} for i in range(40)], 'w')\n"
        "e.commit()\n"
        "rd = e.read_side._reader('c')\n"
        "for body in ({'term': 'hello'}, {'term': 'hello world'},\n"
        "             {'term': 'word3', 'mode': 'vector'},\n"
        "             {'term': 'word3', 'mode': 'vector', 'where': {'n': {'gte': 5}},\n"
        "              'facets': {'n': {'ranges': [{'from': 0, 'to': 20}]}}},\n"
        "             {'term': 'word3', 'mode': 'hybrid'}):\n"
        "    p = SearchParams.from_json(body)\n"
        "    assert rd._use_sharded(p), body\n"
        "    r = e.read_side.search('c', p, 'r')\n"
        "    assert r.count > 0, (body, r)\n"
        "e.close()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('grpc', 'jax',"
        " 'jaxlib', 'orama_core_tpu') or m.startswith('google.protobuf')]\n"
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


def test_tp_models_and_benchgen_load_no_jax(tmp_path):
    """The tensor-parallel encoder and decoder (models/tp.py over
    parallel/mesh.shard_params) and utils/benchgen.py run without JAX in
    the process."""
    code = (
        "import sys, torch\n"
        "from orama_core_tpu_torch.models import encoder as enc, llm\n"
        "from orama_core_tpu_torch.parallel.mesh import make_mesh, shard_params\n"
        "from orama_core_tpu_torch.utils.benchgen import hashed_unit_corpus\n"
        "cfg = enc.EncoderConfig(vocab_size=64, hidden=32, layers=1, heads=4,"
        " mlp=64, max_len=8, out_dim=32)\n"
        "p = shard_params(make_mesh((2, 2), device='cpu'),"
        " enc.init_params(cfg, device='cpu'), enc.param_specs(cfg))\n"
        "assert enc.encode(p, cfg, torch.ones(2, 8, dtype=torch.long),"
        " torch.ones(2, 8)).shape == (2, 32)\n"
        "lc = llm.LlmConfig(vocab_size=64, hidden=32, layers=1, heads=4,"
        " kv_heads=2, mlp=64, max_len=16)\n"
        "lp = shard_params(make_mesh((1, 4), device='cpu'),"
        " llm.init_params(lc, device='cpu'), llm.param_specs(lc))\n"
        "out = llm.generate(lp, lc, torch.ones(1, 4, dtype=torch.long),"
        " torch.tensor([4]), 3, eos_id=63)\n"
        "assert out.shape == (1, 3)\n"
        "assert hashed_unit_corpus(4, 8, 1, device='cpu').shape == (4, 8)\n"
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


TRAINING_AND_TOOLS = ("models/train_encoder.py", "tools", "examples")


def test_training_tools_and_examples_load_no_jax(tmp_path):
    """The trainer, the checkpoint writer, ``tools/`` (the kernel probes
    ``knn_tune_bench`` and ``bm25_scan_bench`` among them) and
    ``examples/`` name neither JAX, the JAX package, ``benchmarks/``,
    ``safetensors`` nor ``transformers`` in their sources (the card's
    machine has neither of the last two), and training, export,
    ``prepare_checkpoint``, ``warm_cache``, both probes and an example run
    on the CPU without any of them in the process."""
    files = []
    for rel in TRAINING_AND_TOOLS:
        path = os.path.join(PKG, rel)
        files += [path] if path.endswith(".py") else [
            os.path.join(path, n) for n in sorted(os.listdir(path))
            if n.endswith(".py")]
    assert len(files) >= 9
    for probe in ("knn_tune_bench.py", "bm25_scan_bench.py"):
        assert os.path.join(PKG, "tools", probe) in files
    for path in files:
        mods = {m.split(".")[0] for m in _imported_modules(path)}
        assert not mods & {"jax", "jaxlib", "orama_core_tpu", "benchmarks",
                           "safetensors", "transformers"}, (path, mods)
    code = (
        "import sys\n"
        "from orama_core_tpu_torch.tools import train_tiny_encoder, "
        "prepare_checkpoint, warm_cache\n"
        "from orama_core_tpu_torch.examples import quickstart, serving, "
        "multilingual\n"
        "assert train_tiny_encoder.main(['--device', 'cpu', '--steps', '40',"
        " '--hidden', '32', '--layers', '1', '--batch', '32',"
        " '--out', 'ck']) == 0\n"
        "assert prepare_checkpoint.main(['ck', '--device', 'cpu']) == 0\n"
        "assert warm_cache.main(['--device', 'cpu', '--docs', '50']) == 0\n"
        "assert quickstart.main(device='cpu', workdir='qs')[0][1]\n"
        "from orama_core_tpu_torch.tools import knn_tune_bench, "
        "bm25_scan_bench\n"
        "assert knn_tune_bench.main(['--device', 'cpu', '--n', '3000',"
        " '--q', '8', '--iters', '1', '--rows', 'phase1,mm,fulltier']) == 0\n"
        "assert bm25_scan_bench.main(['--device', 'cpu', '--postings',"
        " '5000', '--docs', '8000', '--iters', '1']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orama_core_tpu', 'benchmarks', 'safetensors',"
        " 'transformers')]\n"
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


def test_bench_and_entry_point_tools_load_no_jax(tmp_path):
    """``bench``, ``tools/graft_entry`` and the six BASELINE-config tools
    import on the CPU without JAX, the JAX package or ``benchmarks/`` in
    the process."""
    code = (
        "import sys\n"
        "from orama_core_tpu_torch import bench, start\n"
        "from orama_core_tpu_torch.tools import graft_entry, synthetic, "
        "engine_bench, embed_bench, int8_30m_bench, pq_100m_bench, "
        "sharded_int8_bench, sharded_ivfpq_bench\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orama_core_tpu', 'benchmarks')]\n"
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
