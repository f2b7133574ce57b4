"""Multi-pod dry run (counterpart of the reference's ``launch/dryrun.py``).

For every (architecture × input shape × mesh) cell: run the cell's step
(``steps.build_cell``, ``impl="ref"`` as the reference's) once on fake
tensors (``FakeTensorMode``: shapes and dtypes, no memory, no values)
placed on the 16×16 single-pod mesh or the 2×16×16 multi-pod mesh of a
fake process group, count what it dispatches on one rank
(:func:`repro_torch.roofline.dispatch.analyze_step`), record its memory
(proves fit on one H100) and derive the three roofline terms.

Where the reference forces 512 host devices at import, the port opens a
fake process group of 256 or 512 ranks in :func:`run_cell` (``"fake"``
backend, a ``FakeStore``: collectives return at once and move nothing)
and closes it after each mesh; importing this module touches no process
group.

Results stream to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``REPRO_TORCH_DRYRUN_DIR`` overrides it), so reruns are incremental.  Never
``experiments/dryrun/``: the reference's records live there, and its tests
check that matrix's completeness.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --force
"""
import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.config import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell, place_args
from repro_torch.models.transformer import count_params
from repro_torch.roofline.analysis import H100, roofline_terms
from repro_torch.roofline.dispatch import analyze_step
from repro_torch.tree import tree_map

OUT_DIR = os.environ.get(
    "REPRO_TORCH_DRYRUN_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "experiments", "dryrun_torch"))

# grad-accumulation per arch for the train_4k cell (the reference's)
TRAIN_ACCUM = {
    "deepseek-v2-236b": 16,
    "llama-3.2-vision-90b": 16,
    "gemma3-27b": 8,
    "whisper-large-v3": 4,
    "gemma2-9b": 2,
    "recurrentgemma-9b": 2,
    "minitron-8b": 2,
    "qwen3-moe-30b-a3b": 2,
}


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active per trained token; 2·N_active per inferred
    token (fwd only), × tokens processed in the step."""
    n_active = count_params(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def train_accum(arch: str, shape, mesh_shape: dict) -> int:
    """The cell's gradient accumulation, halved until its micro-batches
    still divide the data axes."""
    accum = TRAIN_ACCUM.get(arch, 1) if shape.kind == "train" else 1
    dp_size = mesh_shape["data"] * mesh_shape.get("pod", 1)
    while accum > 1 and (shape.global_batch // accum) % dp_size:
        accum //= 2
    return accum


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_tree(tree):
    """Meta tensors of a tree as fake CPU tensors (under the active
    ``FakeTensorMode``)."""
    if isinstance(tree, dict):
        return {k: _fake_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_fake_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="cpu")
    return tree


@contextlib.contextmanager
def _strided_offsets_unfaked():
    """DTensor's ``_StridedShard.local_shard_size_and_offset`` (a dim
    sharded over two mesh axes at once: an einsum flattening a batch dim
    over ``data`` with a head dim over ``model``) computes a shard's
    offsets with ``torch.arange(...).tolist()``, which a ``FakeTensorMode``
    refuses as data-dependent: run it outside the fake mode.  It reads
    sizes only, never the step's tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as P
    cls = getattr(P, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def unfaked(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)
    cls.local_shard_size_and_offset = unfaked
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


@contextlib.contextmanager
def _alltoall_as_on_a_card():
    """DTensor moves a shard from one tensor dim to another (``Shard(a)``
    -> ``Shard(b)`` on one mesh dim) by an all-to-all on a card, but on a
    CPU mesh by gathering the whole dim and keeping a chunk, which a rank
    of the card never holds: run it as the card's all-to-all where the dim
    divides evenly, so that the cell counts the card's step."""
    from torch.distributed.tensor import placement_types as P
    orig = getattr(P, "shard_dim_alltoall", None)
    if orig is None:
        raise RuntimeError("this torch's DTensor has no placement_types.shard_dim_alltoall: "
                           "the dry run cannot count a shard moved between tensor dims as "
                           "the card's all-to-all")

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed import _functional_collectives as funcol
        n = mesh.size(mesh_dim)
        if x.shape[shard_dim] % n:
            return orig(x, gather_dim, shard_dim, mesh, mesh_dim)
        # part j of shard_dim to rank j; the parts received joined along
        # gather_dim in rank order
        parts = x.movedim(shard_dim, 0)
        parts = parts.reshape(n, parts.shape[0] // n, *parts.shape[1:]).contiguous()
        got = funcol.wait_tensor(funcol.all_to_all_single(
            parts.flatten(0, 1), None, None, mesh.get_group(mesh_dim)))
        got = got.reshape(parts.shape).movedim(1, shard_dim + 1)     # (rank, *x's dims)
        return torch.cat(got.unbind(0), dim=gather_dim)
    P.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        P.shard_dim_alltoall = orig


def trace_cell(cfg, shape, mesh, *, accum: int = 1, record_ops: bool = False,
               remat: bool = True):
    """The cell's step run once on fake CPU tensors placed on ``mesh`` (a
    DeviceMesh over a fake or real group): its per-rank
    :class:`~repro_torch.roofline.dispatch.StepCost`.  A train step's
    parameters take gradients (``remat``: each layer recomputed in the
    backward pass, the default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, args, _ = build_cell(cfg, shape, mesh, accum=accum, impl="ref", remat=remat)
    with FakeTensorMode(), _strided_offsets_unfaked(), _alltoall_as_on_a_card():
        args = _fake_tree(args)
        if shape.kind == "train":
            args[0] = tree_map(lambda t: t.requires_grad_(True), args[0])
        placed = place_args(cfg, shape, mesh, *args)
        return analyze_step(fn, *placed, num_devices=mesh.size(), record_ops=record_ops)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             save_ops: bool = False, force: bool = False) -> dict:
    os.makedirs(OUT_DIR, exist_ok=True)
    out_path = os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "ok", "ts": time.time()}

    ok, reason = cfg.supports(shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        _save(out_path, rec)
        return rec

    multi = mesh_kind == "multi"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        n_dev = mesh.size()
        accum = train_accum(arch, shape, dict(zip(mesh.mesh_dim_names, mesh.shape)))
        try:
            t0 = time.time()
            cost = trace_cell(cfg, shape, mesh, accum=accum, record_ops=save_ops)
            t_trace = time.time() - t0
            mem = {
                "argument_bytes": cost.argument_bytes,
                "output_bytes": cost.output_bytes,
                "temp_bytes": cost.temp_bytes,
                "alias_bytes": cost.alias_bytes,
            }
            mem["live_bytes"] = (cost.argument_bytes + cost.output_bytes
                                 - cost.alias_bytes + cost.temp_bytes)
            mem["fits_h100"] = bool(mem["live_bytes"] <= H100.hbm_bytes)
            mem["largest_tensors"] = cost.largest_tensors[:10]
            rep = roofline_terms(
                cost, arch=arch, shape=shape_name, mesh_name=mesh_kind,
                n_devices=n_dev, model_flops=model_flops_for(cfg, shape))
            rec.update(
                t_trace_s=round(t_trace, 2), n_devices=n_dev, accum=accum,
                memory=mem, n_ops=cost.n_ops, collective_bytes=cost.collective_bytes,
                roofline=dataclasses.asdict(rep),
            )
            if save_ops:
                ops_path = out_path.replace(".json", ".ops.txt")
                with open(ops_path, "w") as f:
                    f.writelines(f"{name}\t{flops:.0f}\t{nbytes:.0f}\n"
                                 for name, flops, nbytes in cost.ops)
                rec["ops_path"] = ops_path
        except Exception as e:  # a failing cell is a bug in our sharding
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    _save(out_path, rec)
    return rec


def _save(path, rec):
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f, indent=1, default=str)
    os.replace(path + ".tmp", path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="", help="single arch (default: all)")
    ap.add_argument("--shape", default="", help="single shape (default: all)")
    ap.add_argument("--mesh", default="", choices=["", "single", "multi"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-ops", action="store_true",
                    help="write the counted ops beside the record (.ops.txt)")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    n_bad = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind,
                               save_ops=args.save_ops, force=args.force)
                status = rec["status"]
                if status == "ok":
                    r = rec["roofline"]
                    mem = rec["memory"]
                    print(f"{arch:22s} {shape:12s} {mesh_kind:6s} OK "
                          f"trace={rec['t_trace_s']:7.1f}s "
                          f"live={mem['live_bytes']/2**30:6.2f}GiB "
                          f"fits={mem['fits_h100']} "
                          f"terms(c/m/n)={r['compute_s']:.3e}/"
                          f"{r['memory_s']:.3e}/{r['collective_s']:.3e}s "
                          f"bound={r['bottleneck']}", flush=True)
                elif status == "skipped":
                    print(f"{arch:22s} {shape:12s} {mesh_kind:6s} SKIP "
                          f"({rec['reason']})", flush=True)
                else:
                    n_bad += 1
                    print(f"{arch:22s} {shape:12s} {mesh_kind:6s} ERROR "
                          f"{rec['error']}", flush=True)
    raise SystemExit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
