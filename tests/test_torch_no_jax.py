"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package; its entry points
refuse to run quietly on the CPU; its configs are the reference's."""
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
    [REPO / "chip_smoke.py"]


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


def _same_fields(arch):
    port, ref = get_config(arch), jax_get_config(arch)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_qwen_config_equals_the_reference_field_by_field():
    _same_fields("qwen2.5-3b")


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-27b", "minitron-8b"])
def test_zoo_config_equals_the_reference_field_by_field(arch):
    _same_fields(arch)
