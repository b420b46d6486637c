"""The port's tools and examples against the reference's scripts and
examples: ``tools/prepare_checkpoint`` prints what
``scripts/prepare_checkpoint.py`` prints for the same checkpoint (the
committed encoder asset, and a seeded two-layer Qwen2-schema decoder
written here), ``tools/warm_cache`` warms the device caches of the
script's collection, and each ``examples/*.py`` of the port returns the
hits the reference's example prints, on the CPU. Scores print rounded to
3 places; hits of equal printed score form a tie group, compared as a
set, and the groups in order."""

import ast
import json
import os
import re
import runpy
import tempfile

import numpy as np
import torch

from orama_core_tpu_torch.models.hf_loader import write_safetensors
from orama_core_tpu_torch.tools import prepare_checkpoint, warm_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "tests", "assets", "tiny-semantic")


def _script(name):
    return runpy.run_path(os.path.join(ROOT, "scripts", name))


def _tie_groups(hits):
    """[(id, score)] -> [(score, {ids})] over runs of equal score."""
    groups = []
    for hid, score in hits:
        if groups and groups[-1][0] == score:
            groups[-1][1].add(hid)
        else:
            groups.append((score, {hid}))
    return groups


def _same_hits(got, want):
    g, w = _tie_groups(got), _tie_groups(want)
    assert [ids for _, ids in g] == [ids for _, ids in w], (got, want)
    np.testing.assert_allclose([s for s, _ in g], [s for s, _ in w],
                               atol=1.5e-3)


def test_prepare_checkpoint_prints_what_the_script_prints(capsys):
    assert prepare_checkpoint.main([ASSET, "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert _script("prepare_checkpoint.py")["main"](ASSET) == 0
    ref = capsys.readouterr().out
    assert "smoke forward ok: embedding (1, 96), L2 norm 1.0000" in port
    assert port == ref


def _qwen2_checkpoint(path, seed=0):
    """A seeded Qwen2-schema decoder (q/k/v biases, no lm_head: tied to
    the embeddings) in HF's layout."""
    rng = np.random.default_rng(seed)
    h, mlp, v, kv = 32, 64, 64, 16  # 4 heads of 8, 2 KV heads

    def t(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.05).astype(np.float32))

    sd = {"model.embed_tokens.weight": t(v, h), "model.norm.weight": t(h)}
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": t(h),
            p + "post_attention_layernorm.weight": t(h),
            p + "self_attn.q_proj.weight": t(h, h),
            p + "self_attn.q_proj.bias": t(h),
            p + "self_attn.k_proj.weight": t(kv, h),
            p + "self_attn.k_proj.bias": t(kv),
            p + "self_attn.v_proj.weight": t(kv, h),
            p + "self_attn.v_proj.bias": t(kv),
            p + "self_attn.o_proj.weight": t(h, h),
            p + "mlp.gate_proj.weight": t(mlp, h),
            p + "mlp.up_proj.weight": t(mlp, h),
            p + "mlp.down_proj.weight": t(h, mlp),
        })
    os.makedirs(path)
    write_safetensors(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen2ForCausalLM"], "vocab_size": v,
                   "hidden_size": h, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "intermediate_size": mlp, "max_position_embeddings": 128,
                   "rope_theta": 10000.0, "rms_norm_eps": 1e-6}, f)


def test_prepare_checkpoint_decoder_prints_what_the_script_prints(
        tmp_path, capsys):
    ckpt = str(tmp_path / "qwen-tiny")
    _qwen2_checkpoint(ckpt)
    assert prepare_checkpoint.main([ckpt, "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert _script("prepare_checkpoint.py")["main"](ckpt) == 0
    ref = capsys.readouterr().out
    assert "loaded decoder: hidden=32 layers=2 heads=4/2 vocab=64" in port
    assert "smoke forward ok: logits (1, 8, 64)" in port
    assert port == ref


def test_prepare_checkpoint_refuses_a_directory_without_config(
        tmp_path, capsys):
    assert prepare_checkpoint.main([str(tmp_path), "--device", "cpu"]) == 1
    assert capsys.readouterr().out.startswith("FAIL: no config.json")


def test_warm_cache_on_cpu_warms_the_collection(capsys):
    assert warm_cache.main(["--device", "cpu", "--docs", "200"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["docs"] == 200
    assert rec["caches"] >= 1
    assert rec["kernels_built"] == [] and rec["kernels_loaded"] == []


def _run_reference_example(name, tmp_path, monkeypatch, capsys):
    """examples/<name>.py of the reference, run as a script; returns its
    standard output. Its temporary directories go under ``tmp_path``."""
    made = iter(range(100))
    monkeypatch.setattr(tempfile, "mkdtemp", lambda *a, **k: str(
        tmp_path.joinpath(f"ref{next(made)}")))
    runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_returns_the_reference_hits(tmp_path, monkeypatch, capsys):
    from orama_core_tpu_torch.examples import quickstart

    got = quickstart.main(device="cpu", workdir=str(tmp_path / "port"))
    capsys.readouterr()
    out = _run_reference_example("quickstart", tmp_path, monkeypatch, capsys)
    lines = [ln for ln in out.splitlines() if " -> " in ln]
    assert len(lines) == len(got) == 4
    for (body, hits, facets), line in zip(got, lines):
        m = re.match(r"^(.*) -> (\[.*?\]) ?(.*)$", line)
        assert ast.literal_eval(m.group(1)) == body
        _same_hits(hits, ast.literal_eval(m.group(2)))
        assert facets == (ast.literal_eval(m.group(3)) if m.group(3) else "")


def test_serving_returns_the_reference_hits(tmp_path, monkeypatch, capsys):
    from orama_core_tpu_torch.examples import serving

    got = serving.main(device="cpu", workdir=str(tmp_path / "port"))
    capsys.readouterr()
    out = _run_reference_example("serving", tmp_path, monkeypatch, capsys)
    want = {}
    for line in out.splitlines():
        key, _, value = line.partition(": ")
        want[key] = ast.literal_eval(value)
    assert got["batched"] == want["batched vector results"]
    _same_hits(got["filtered_hybrid"], want["filtered hybrid"])
    assert got["raw_vector"] == want["raw-vector query"] == ["p0"]


def test_multilingual_returns_the_reference_hits(tmp_path, monkeypatch,
                                                 capsys):
    from orama_core_tpu_torch.examples import multilingual

    got = multilingual.main(device="cpu", workdir=str(tmp_path / "port"))
    capsys.readouterr()
    out = _run_reference_example("multilingual", tmp_path, monkeypatch,
                                 capsys)
    want = []
    for line in out.splitlines():
        m = re.match(r"^\[(\w+)\]\s+(.*) -> (\d+) hits (\[.*\])$", line)
        if m:
            want.append((m.group(1), ast.literal_eval(m.group(2)),
                         int(m.group(3)), ast.literal_eval(m.group(4))))
    assert "committed-path expansion OK" in out
    assert got == want and len(got) == 4
