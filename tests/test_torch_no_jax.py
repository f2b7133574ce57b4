"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the chip probes import JAX or the reference
package; its entry points refuse to run quietly on the CPU; its configs
are the reference's."""
import ast
import dataclasses
import pathlib

import pytest
import torch

from repro.config import get_config as jax_get_config
from repro_torch.config import get_config
from repro_torch.serving.engine import ServingEngine

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / name for name in ("chip_smoke.py", "chip_probe_attention.py",
                              "chip_probe_grouped.py", "chip_probe_qmatmul.py",
                              "chip_probe_cross_source.py", "chip_probe_calib.py")]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_engine_without_a_device_refuses_to_run_on_the_cpu(monkeypatch):
    from repro_torch.config import reduce_config
    from repro_torch.models.transformer import init_params
    cfg = reduce_config(get_config("qwen2.5-3b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())


def test_trainer_and_train_launcher_without_a_device_refuse_to_run_on_the_cpu(monkeypatch):
    from repro_torch.config import ShapeSpec, reduce_config
    from repro_torch.launch import train as launch_train
    from repro_torch.training.trainer import Trainer
    cfg = reduce_config(get_config("qwen2.5-3b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, ShapeSpec("smoke", "train", 16, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2.5-3b", "--reduced", "--steps", "1"])
    # more ranks than torchrun started are refused, and a mesh that is not
    # a DeviceMesh
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                           "--devices", "2"])
    with pytest.raises(TypeError, match="mesh"):
        Trainer(cfg, ShapeSpec("smoke", "train", 16, 4), object(), device="cpu")


def test_train_launcher_runs_its_steps_on_the_cpu():
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "qwen2.5-3b", "--reduced", "--device", "cpu", "--steps", "3"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=qwen2.5-3b" in out.stdout and "device=cpu" in out.stdout
    assert "step     0 loss=" in out.stdout
    assert "done: 3 steps" in out.stdout


def _same_fields(arch):
    port, ref = get_config(arch), jax_get_config(arch)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_qwen_config_equals_the_reference_field_by_field():
    _same_fields("qwen2.5-3b")


def test_registry_names_the_reference_archs():
    """Every arch the reference registers is registered by the port, the
    cross-attention stacks (whisper, the vision stack) among them."""
    from repro.config import _REGISTRY as REF_REGISTRY
    from repro_torch.config import _REGISTRY
    get_config("qwen2.5-3b"), jax_get_config("qwen2.5-3b")
    assert set(_REGISTRY) == set(REF_REGISTRY)
    assert {"whisper-large-v3", "llama-3.2-vision-90b"} <= set(_REGISTRY)


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-27b", "minitron-8b",
                                  "qwen3-moe-30b-a3b", "mamba2-130m", "recurrentgemma-9b",
                                  "deepseek-v2-236b", "whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_zoo_config_equals_the_reference_field_by_field(arch):
    _same_fields(arch)
    assert get_config(arch).layer_kinds == jax_get_config(arch).layer_kinds


# the paper's Table 3 (``configs/paper_models.py``)
PAPER_ARCHS = ("bert-base", "bert-large", "bart-base", "bart-large", "gpt-j", "llama2-7b")


@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_paper_config_equals_the_reference_field_by_field(arch):
    from repro.config import PAPER_ARCHS as REF_PAPER_ARCHS
    assert set(PAPER_ARCHS) == set(REF_PAPER_ARCHS)
    _same_fields(arch)
    port, ref = get_config(arch), jax_get_config(arch)
    assert port.layer_kinds == ref.layer_kinds
    assert port.encoder_layer_kinds == ref.encoder_layer_kinds


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-9b", "qwen3-moe-30b-a3b",
                                  "mamba2-130m", "recurrentgemma-9b", "deepseek-v2-236b",
                                  "whisper-large-v3", "llama-3.2-vision-90b",
                                  *PAPER_ARCHS])
def test_reduced_config_equals_the_reference_field_by_field(arch):
    """``reduce_config`` cuts as the reference's does: for qwen3-moe-30b-a3b
    8 experts, top-2, d_ff_expert 32, first_k_dense at most 1; for
    deepseek-v2-236b's MLA latent 32, query rank 48, RoPE dims 8; for the
    paper's models a 64-row position table and two encoder layers where
    they have them; mamba2-130m keeps no KV heads and no ``d_ff`` (2 SSD
    layers of state 16, head dim 16, chunk 8), recurrentgemma-9b a full
    period and its remainder layer (4 layers, 4/1 heads, LRU width 64,
    window 16)."""
    from repro.config import reduce_config as jax_reduce_config
    from repro_torch.config import reduce_config
    port, ref = reduce_config(get_config(arch)), jax_reduce_config(jax_get_config(arch))
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.moe_layer_mask() == ref.moe_layer_mask()
    assert port.is_moe == ref.is_moe == (arch in ("qwen3-moe-30b-a3b", "deepseek-v2-236b"))
    assert port.is_mla == ref.is_mla == (arch == "deepseek-v2-236b")
    assert port.encoder_layer_kinds == ref.encoder_layer_kinds
    assert port.layer_kinds == ref.layer_kinds
    if arch == "mamba2-130m":
        assert (port.n_layers, port.d_model, port.n_kv_heads, port.d_ff) == (2, 64, 0, 0)
        assert (port.ssm_state, port.ssm_head_dim, port.ssm_chunk) == (16, 16, 8)
    if arch == "recurrentgemma-9b":
        assert (port.n_layers, port.n_heads, port.n_kv_heads, port.lru_width,
                port.window) == (4, 4, 1, 64, 16)
    if arch == "deepseek-v2-236b":
        assert (port.kv_lora_rank, port.q_lora_rank, port.rope_head_dim, port.v_head_dim,
                port.first_k_dense) == (32, 48, 8, 16, 1)
    if arch in ("whisper-large-v3", "llama-3.2-vision-90b", "bart-base", "bart-large"):
        # the cross source cut to 16 entries, the encoder to two layers
        assert port.n_frontend_tokens == ref.n_frontend_tokens == 16
        assert port.n_encoder_layers == (0 if arch.startswith("llama") else 2)
    if arch in PAPER_ARCHS:
        for seq_len in (16, 32, 100):
            a, b = reduce_config(get_config(arch), seq_len=seq_len), \
                jax_reduce_config(jax_get_config(arch), seq_len=seq_len)
            assert (a.max_abs_positions, a.n_encoder_layers) == \
                (b.max_abs_positions, b.n_encoder_layers)


@pytest.mark.parametrize("change", [dict(n_kv_heads=0, d_ff=0), dict(n_kv_heads=3),
                                    dict(n_kv_heads=0, n_heads=0, head_dim=16)])
def test_reduce_config_keeps_no_kv_heads_and_no_mlp(change):
    """``reduce_config`` of a stack without KV heads (an SSM stack) keeps
    none, and one without an MLP no ``d_ff``, as the reference's does (the
    port's divided by zero there); a KV-head count that does not divide the
    4 reduced heads falls back to 2."""
    from repro.config import reduce_config as jax_reduce_config
    from repro_torch.config import reduce_config
    port = reduce_config(dataclasses.replace(get_config("qwen2.5-3b"), **change))
    ref = jax_reduce_config(dataclasses.replace(jax_get_config("qwen2.5-3b"), **change))
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
