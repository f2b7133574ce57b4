"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), on the CPU.

- ``model_flops_for``, the train cells' gradient accumulation and the
  skipped cells' reasons equal the reference's for every assigned config,
  shape and mesh.
- One cell end to end through the CLI on the 16×16 mesh of a fake group
  of 256 ranks (the reference's slow ``test_dryrun_one_cell_end_to_end``:
  mamba2-130m train_4k), into ``tmp_path``, never ``experiments/dryrun/``.
- A reduced train cell on a 2×2 fake mesh: the arguments a rank holds equal
  XLA's ``argument_size_in_bytes`` for the reference's cell on 4 forced
  host devices (a subprocess: the device count is fixed at JAX's import).

The reference's module forces 512 host devices through ``XLA_FLAGS`` when
it is imported; the test puts the variable back, so that no later
subprocess of this worker inherits it.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.config import SHAPES as JAX_SHAPES
from repro.config import get_config as jax_get_config
from repro.roofline.analysis import RooflineReport as JaxRooflineReport
from repro_torch.config import ASSIGNED_ARCHS, SHAPES, ShapeSpec, get_config, reduce_config
from repro_torch.launch import dryrun as D
from repro_torch.roofline import H100

REPO = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _reference_accum(ref, arch, shape, mesh_shape):
    """The reference's ``run_cell`` choice, line for line."""
    accum = ref.TRAIN_ACCUM.get(arch, 1) if shape.kind == "train" else 1
    dp_size = mesh_shape["data"] * mesh_shape.get("pod", 1)
    while accum > 1 and (shape.global_batch // accum) % dp_size:
        accum //= 2
    return accum


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_accum_and_skips_equal_the_reference(arch, reference_dryrun, tmp_path,
                                                         monkeypatch):
    ref = reference_dryrun
    assert D.TRAIN_ACCUM == ref.TRAIN_ACCUM
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    monkeypatch.setattr(D, "OUT_DIR", str(tmp_path))
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        assert D.model_flops_for(cfg, shape) == ref.model_flops_for(jcfg, jshape)
        for mesh_kind, mesh_shape in MESHES.items():
            assert D.train_accum(arch, shape, mesh_shape) == \
                _reference_accum(ref, arch, jshape, mesh_shape)
            ok, reason = jcfg.supports(jshape)
            if not ok:
                rec = D.run_cell(arch, name, mesh_kind, force=True)
                assert (rec["status"], rec["reason"]) == ("skipped", reason)


def test_dryrun_one_cell_end_to_end(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the cheapest assigned
    cell writes an ``ok`` record with the reference's keys."""
    env = dict(os.environ, REPRO_TORCH_DRYRUN_DIR=str(tmp_path),
               PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-130m",
         "--shape", "train_4k", "--mesh", "single", "--force"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=900)
    assert r.returncode == 0 and " OK " in r.stdout, (r.stdout, r.stderr[-4000:])
    assert not (REPO / "experiments" / "dryrun").exists()
    rec = json.loads((tmp_path / "mamba2-130m__train_4k__single.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256 and rec["accum"] == 1
    assert {"arch", "shape", "mesh", "status", "ts", "n_devices", "accum", "memory",
            "roofline", "t_trace_s"} <= set(rec)
    assert set(rec["roofline"]) == {f.name for f in dataclasses.fields(JaxRooflineReport)}
    mem = rec["memory"]
    assert mem["live_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 - mem["alias_bytes"] + mem["temp_bytes"])
    assert mem["fits_h100"] == (mem["live_bytes"] <= H100.hbm_bytes)
    roof = rec["roofline"]
    assert roof["hlo_flops_per_dev"] > 0 and roof["hbm_bytes_per_dev"] > 0
    assert roof["wire_bytes_per_dev"] > 0          # a 16×16 mesh moves bytes
    assert roof["model_flops"] == D.model_flops_for(get_config("mamba2-130m"),
                                                    SHAPES["train_4k"])


_REFERENCE_ARGUMENTS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh
from repro.config import ShapeSpec, get_config, reduce_config
from repro.launch.steps import build_cell
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
jfn, args, _ = build_cell(reduce_config(get_config(sys.argv[1])),
                          ShapeSpec("t", "train", 32, 4), mesh)
print(jfn.lower(*args).compile().memory_analysis().argument_size_in_bytes)
"""


def test_argument_bytes_equal_xla_on_a_2x2_mesh():
    """Reduced qwen2.5-3b train (every sharded dim divides the axes: KV
    heads 2, d_ff 96, vocab 256 over ``model`` 2, batch 4 over ``data`` 2):
    the parameters, AdamW's moments, its count and the batch a rank holds
    are XLA's per-device argument bytes."""
    arch = "qwen2.5-3b"
    r = subprocess.run([sys.executable, "-c", _REFERENCE_ARGUMENTS, arch],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-4000:]
    want = int(r.stdout.split()[-1])
    from repro_torch.launch.mesh import small_mesh
    with D.fake_group(4):
        cost = D.trace_cell(reduce_config(get_config(arch)), ShapeSpec("t", "train", 32, 4),
                            small_mesh(2, 2, device_type="cpu"))
    assert cost.argument_bytes == want
    # the update writes the parameters and moments in place, and they come
    # back: all but AdamW's count (int32) and a rank's 2 rows of 32 tokens
    assert cost.argument_bytes - cost.alias_bytes == 4 + 2 * 32 * 4


def test_decode_traces_with_kv_heads_that_do_not_divide_the_model_axis():
    """Reduced qwen2.5-3b's decode (4 query heads over 2 KV heads) on a
    1x4 fake mesh: 2 KV heads do not divide ``model`` 4, so the plan keeps
    them whole, and the K/V projections, column-sharded by their weights,
    are brought to that role before their heads are split out (DTensor
    splits a sharded dim only evenly)."""
    from repro_torch.launch.mesh import small_mesh
    cfg = reduce_config(get_config("qwen2.5-3b"))
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)
    with D.fake_group(4):
        cost = D.trace_cell(cfg, ShapeSpec("d", "decode", 64, 8),
                            small_mesh(1, 4, device_type="cpu"))
    assert cost.flops > 0 and cost.n_ops > 0


def test_accum_cuts_a_batch_sharded_over_two_axes():
    """Reduced qwen2.5-3b's train step with ``accum`` 2 on a 2x2 fake mesh
    whose two axes (``pod``, ``data``) both shard the batch, 8 rows: the
    contiguous micro-batches of 4 rows (the reference's reshape) cannot be
    cut from a dim sharded 4 ways into (2, 4), so the step moves the
    batch's shards to its sequence dim first."""
    from repro_torch.launch.mesh import _mesh
    cfg = reduce_config(get_config("qwen2.5-3b"))
    with D.fake_group(4):
        mesh = _mesh((2, 2, 1), ("pod", "data", "model"), range(4), "cpu")
        cost = D.trace_cell(cfg, ShapeSpec("t", "train", 32, 8), mesh, accum=2)
    assert cost.flops > 0 and cost.n_ops > 0


_REFERENCE_FLOPS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh
from repro.config import ShapeSpec, get_config, reduce_config
from repro.launch.steps import build_cell
from repro.roofline.hlo import analyze_hlo_text
out = {}
for arch in sys.argv[1].split(","):
    for m in json.loads(sys.argv[2]):
        mesh = Mesh(np.asarray(jax.devices()).reshape(*m), ("data", "model"))
        jfn, args, _ = build_cell(reduce_config(get_config(arch)),
                                  ShapeSpec("t", "train", 128, 4), mesh)
        out[f"{arch} {m[0]}x{m[1]}"] = analyze_hlo_text(jfn.lower(*args).compile().as_text()).flops
print(json.dumps(out))
"""

RANK_ARCHS = ("qwen2.5-3b", "gemma2-9b", "qwen3-moe-30b-a3b")
RANK_MESHES = ((2, 2), (1, 4))


@pytest.fixture(scope="module")
def reference_rank_flops():
    """The reference's per-device FLOPs (its compiled HLO walked) of every
    case below: one subprocess on 4 forced host devices, one JAX import."""
    r = subprocess.run([sys.executable, "-c", _REFERENCE_FLOPS, ",".join(RANK_ARCHS),
                        json.dumps(RANK_MESHES)],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.split("\n")[-2])


@pytest.mark.parametrize("mesh_shape", RANK_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_rank_flops_equal_the_reference_on_multi_rank_meshes(arch, mesh_shape,
                                                             reference_rank_flops):
    """A reduced train step (S 128, B 4) on 2x2 and 1x4 fake meshes: each
    rank counts the FLOPs of the reference's partitioned HLO, within 2%
    for the dense stacks and :data:`MOE_REMAT_TOL` for the MoE.  A rank
    attends only its own rows of a sequence-split q, forms only its own
    vocab columns of the logits and the loss, and dispatches only its own
    GShard groups; a step that computed any of these whole on every
    ``model`` rank would count up to 2.3x the reference's here."""
    from repro_torch.launch.mesh import small_mesh
    from test_torch_roofline import MOE_REMAT_TOL, WHOLE_STEP_TOL
    cfg = reduce_config(get_config(arch))
    with D.fake_group(4):
        got = D.trace_cell(cfg, ShapeSpec("t", "train", 128, 4),
                           small_mesh(*mesh_shape, device_type="cpu")).flops
    want = reference_rank_flops[f"{arch} {mesh_shape[0]}x{mesh_shape[1]}"]
    tol = MOE_REMAT_TOL if cfg.is_moe else WHOLE_STEP_TOL
    assert abs(got - want) <= tol * want, (arch, mesh_shape, got, want, got / want)
