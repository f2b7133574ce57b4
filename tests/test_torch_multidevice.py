"""The port's sharded plane on several ranks: each test spawns its ranks
(``torch.multiprocessing``, gloo on the CPU, a ``FileStore`` under the
test's ``tmp_path``, so that parallel test workers never share a port),
at most four, and joins them within a time limit.  Each is the port's
counterpart of one of the reference's ``tests/test_multidevice.py``:
a sharded train step equal to the single-device one, an elastic re-mesh
equal to an uninterrupted run, the ring collective matmuls, int8
compressed gradients, the sharded slot pool serving the unsharded
engine's streams, and a snapshot restored on another mesh.  Asserts run in
the ranks; a failing rank fails the test with its traceback."""
import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.config import ShapeSpec, get_config, reduce_config

JOIN_S = 240
BF16_LOGIT_TOL = 1e-2


def _entry(rank, world, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world: int, fn, *args):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; fail on any rank's
    error or after ``JOIN_S`` seconds (the ranks are then terminated)."""
    ctx = mp.start_processes(_entry, args=(world, str(tmp_path / "store"), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"{fn.__name__} did not finish in {JOIN_S} s")


def _f32_loss():
    """Both steps in f32 (the tolerance is f32's): loss_fn's compute dtype
    patched, as the port's train-parity tests patch it."""
    from repro_torch.models import transformer as T
    T.loss_fn = functools.partial(T.loss_fn, compute_dtype=torch.float32)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_step_worker(rank, arch, mostly_sharded=True):
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.launch.steps import build_cell, make_train_step, place_args
    from repro_torch.models import transformer as T
    from repro_torch.parallel.api import AbstractMesh, Plan
    from repro_torch.training.optimizer import adamw_init
    _f32_loss()
    cfg = reduce_config(get_config(arch))
    shape = ShapeSpec("t", "train", 32, 4)
    mesh = small_mesh(2, 2, device_type="cpu")
    fn, (pspecs, ospecs, bspecs), plan = build_cell(cfg, shape, mesh)
    assert all(t.is_meta for t in (pspecs["embed"]["tok"], ospecs["m"]["embed"]["tok"],
                                   bspecs["tokens"]))
    assert plan.name == f"{cfg.name}:t:train"

    def fresh():
        p = T.trainable(T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                      dtype=torch.float32))
        return p, adamw_init(p)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                                     generator=torch.Generator().manual_seed(1))}
    p, o, b = place_args(cfg, shape, mesh, *fresh(), batch)
    # the single-device step under a plan of the mesh's shape with no roles:
    # its MoE layers take gshard in groups of the model axis, as the mesh's
    single = make_train_step(cfg, Plan(AbstractMesh((2, 2), ("data", "model")), {}))
    p1, o1 = fresh()
    for step in range(2):          # the second loss reads the first update
        p, o, m = fn(p, o, b)
        p1, o1, m1 = single(p1, o1, batch)
        for k in ("loss", "gnorm"):
            assert _rel(m[k], m1[k]) < 1e-5, (step, k, m[k], m1[k])
    # moments stay sharded like their parameters (ZeRO)
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(p)
    assert all(m.placements == x.placements and v.placements == x.placements
               for x, m, v in zip(leaves, tree_leaves(o["m"]), tree_leaves(o["v"])))
    if mostly_sharded:
        assert sum(any(pl.is_shard() for pl in x.placements) for x in leaves) > \
            len(leaves) // 2


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-9b", "qwen3-moe-30b-a3b",
                                  "deepseek-v2-236b"])
def test_sharded_train_step_matches_single_device(tmp_path, arch):
    """``build_cell``'s train step on a 2x2 mesh (FSDP over ``data``,
    tensor and sequence parallel over ``model``, experts over ``model``)
    gives the single-device step's loss and gradient norm, two steps
    running, in f32; the MoE stacks' (gshard) against the single device
    under a role-less plan of the same shape."""
    _spawn(tmp_path, 4, _train_step_worker, arch)


def test_sharded_ssm_train_step_matches_single_device(tmp_path):
    """mamba2-130m's train step on the 2x2 mesh, its SSD scan on each
    rank's batch rows (``ssm._planned_scan``), gives the single-device
    step's loss and gradient norm, two steps running, in f32 (most of its
    leaves are vectors the plan leaves whole)."""
    _spawn(tmp_path, 4, _train_step_worker, "mamba2-130m", False)


def _remesh_worker(rank, path):
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig
    _f32_loss()
    cfg = reduce_config(get_config("qwen2.5-3b"))
    shape = ShapeSpec("t", "train", 16, 8)
    opt = OptConfig(lr=5e-3, warmup_steps=0, total_steps=50)
    big = small_mesh(2, 2, device_type="cpu")
    a = Trainer(cfg, shape, big, opt_cfg=opt, tcfg=TrainerConfig(ckpt_dir=str(path / "a")))
    a.run(2)
    a.save()
    small = small_mesh(1, 2, device_type="cpu")   # every rank builds it; 2 and 3 leave
    a.remesh(small)
    b = Trainer(cfg, shape, big, opt_cfg=opt, tcfg=TrainerConfig())
    b.run(4)
    if not a.in_mesh():
        assert rank >= 2
        return
    a.run(2)
    assert a.step == 4
    la = [m["loss"] for m in a.metrics_log]
    lb = [m["loss"] for m in b.metrics_log]
    assert max(_rel(x, y) for x, y in zip(la, lb)) < 1e-5, (la, lb)
    # the checkpoint of the 2x2 run restores on the 1x2 mesh
    c = Trainer(cfg, shape, small, opt_cfg=opt, tcfg=TrainerConfig(ckpt_dir=str(path / "a")))
    assert c.step == 2
    c.run(2)
    lc = [m["loss"] for m in c.metrics_log]
    assert max(_rel(x, y) for x, y in zip(lc, lb[2:])) < 1e-5, (lc, lb)


def test_elastic_remesh_matches_unremeshed(tmp_path):
    """Two steps on a 2x2 mesh, ``remesh`` onto 1x2, two more: the losses
    of an uninterrupted 2x2 run (the reference's 8 -> 4 test at half the
    ranks); the 2x2 run's checkpoint resumes on 1x2 to the same losses."""
    _spawn(tmp_path, 4, _remesh_worker, tmp_path)


def _compression_worker(rank):
    from repro_torch.data.pipeline import DataConfig, LMDataPipeline
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.launch.steps import place_args
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.api import activate_plan, full
    from repro_torch.training.compression import compress_decompress
    from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_unflatten
    cfg = reduce_config(get_config("qwen2.5-3b"))
    shape = ShapeSpec("t", "train", 16, 8)
    mesh = small_mesh(2, 1, device_type="cpu")
    plan, _ = SH.build_plan(cfg, shape, mesh, mode="train")
    params = T.trainable(T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                       dtype=torch.float32))
    params, opt = place_args(cfg, shape, mesh, params, adamw_init(params))
    ocfg = OptConfig(lr=5e-3, warmup_steps=0, total_steps=60)
    pipe = LMDataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8))
    err, losses = None, []
    for step in range(15):
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in pipe.global_batch_at(step).items()}
        (batch,) = place_args(cfg, shape, mesh, batch)
        with activate_plan(plan):
            loss, _ = T.loss_fn(params, cfg, batch)
            g = torch.autograd.grad(loss, tree_leaves(params))
        g = tree_unflatten(params, [x.redistribute(p.device_mesh, p.placements)
                                    for x, p in zip(g, tree_leaves(params))])
        g, err = compress_decompress(g, err)     # int8 + error feedback, shard by shard
        params, opt, _ = adamw_update(g, opt, params, ocfg)
        losses.append(float(full(loss)))
    assert sum(losses[-3:]) < sum(losses[:3]) - 0.05, losses


def test_grad_compression_data_axis(tmp_path):
    """int8-compressed gradients (error feedback) of a model sharded over
    two data ranks still train: the loss falls."""
    _spawn(tmp_path, 2, _compression_worker)


# ---------------------------------------------------------------------------
# the ring collective matmuls
# ---------------------------------------------------------------------------

def _overlap_worker(rank):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.parallel import overlap as O
    mesh = small_mesh(1, 4, device_type="cpu")
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(64, 32, generator=g), torch.randn(32, 48, generator=g)
    x2, w2 = torch.randn(64, 128, generator=g), torch.randn(128, 48, generator=g)
    sent = []
    real = dist.batch_isend_irecv
    O.dist.batch_isend_irecv = lambda ops: sent.append(len(ops)) or real(ops)

    def put(t, *pl):
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    y = O.allgather_matmul(put(x, Replicate(), Shard(0)), put(w, Replicate(), Replicate()),
                           mesh)
    assert y.placements == (Replicate(), Replicate())
    err = float((y.to_local() - O.allgather_matmul_ref(x, w)).abs().max())
    assert err < 1e-4, err
    assert sent == [2, 2, 2]            # a ring: G - 1 transfers, a send and a receive each
    y2 = O.reduce_scatter_matmul(put(x2, Replicate(), Shard(1)), put(w2, Replicate(), Shard(0)),
                                 mesh)
    assert y2.placements == (Replicate(), Shard(0))
    err2 = float((y2.full_tensor() - O.reduce_scatter_matmul_ref(x2, w2)).abs().max())
    assert err2 < 1e-4, err2
    assert sent == [2] * 6


def test_overlap_collective_matmul(tmp_path):
    """``allgather_matmul`` and ``reduce_scatter_matmul`` on a 1x4 mesh
    equal their oracles, through a ring of point-to-point transfers."""
    _spawn(tmp_path, 4, _overlap_worker)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SERVE = dict(max_batch=2, kv_len=48, max_new_tokens=5, prefill_chunk=16)
PROMPTS = [4, 7, 23, 10]     # 23 > prefill_chunk: a chunked continuation too


def _margin(params, cfg, prompt, out, t):
    """The unsharded model's top-1 minus top-2 logit margin for token ``t``
    of a stream (bf16 compute, the engine's)."""
    from repro_torch.models import transformer as T
    seq = torch.from_numpy(np.concatenate([prompt, np.asarray(out[:t], np.int32)])[None])
    logits, _ = T.prefill(params, cfg, seq.to(torch.int32), impl="ref")
    top = torch.sort(logits[0].float()).values[-2:]
    return float(top[1] - top[0])


def _same_streams(params, cfg, prompts, a, b, quant_bits=0):
    """Equal streams, or streams parting first at a near-tie."""
    from repro_torch.models import transformer as T
    from repro_torch.quant.core import quantize_params
    mparams = params if not quant_bits else T.Transformer(cfg, quantize_params(params,
                                                                               quant_bits))
    for prompt, x, y in zip(prompts, a, b):
        assert len(x) == len(y)
        diverged = [t for t in range(len(x)) if x[t] != y[t]]
        if diverged:
            t = diverged[0]
            margin = _margin(mparams, cfg, prompt, x, t)
            assert margin < 2 * BF16_LOGIT_TOL, (t, x, y, margin)


def _engine(cfg, params, mesh, **kw):
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    return ServingEngine(cfg, params, EngineConfig(**SERVE, **kw), device="cpu", mesh=mesh)


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=n) for n in PROMPTS]


def _drain(eng, prompts):
    for p in prompts:
        eng.submit(p)
    eng.run_until_drained()
    return [r.output for r in sorted(eng.finished, key=lambda r: r.uid)]


def _serving_worker(rank, arch, dtype, kw):
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.models import transformer as T
    cfg = reduce_config(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=getattr(torch, dtype))
    prompts = _prompts(cfg)
    mesh = small_mesh(1, 2, device_type="cpu")
    sharded = _engine(cfg, params, mesh, **kw)
    # the pool is sharded: its KV heads over model
    k = sharded.pool.cache["stack"][0]["u0"]["attn"]
    leaf = k["k"] if "k" in k else k["k_q"]
    assert leaf.placements[1].is_shard(3), leaf.placements
    b = _drain(sharded, prompts)
    plain = _engine(cfg, params, None, **kw)
    a = _drain(plain, prompts)
    _same_streams(params, cfg, prompts, a, b, kw.get("weight_bits", 0))
    assert sharded.stats()["finished"] == len(prompts)
    assert sharded.host_transfers == plain.host_transfers


@pytest.mark.parametrize("arch,dtype,kw", [
    ("qwen2.5-3b", "float32", {}),
    ("gemma2-9b", "bfloat16", {}),
    ("qwen2.5-3b", "float32", dict(weight_bits=8, kv_bits=8)),
], ids=["qwen-f32", "gemma2-rings", "qwen-w8kv8"])
def test_sharded_slot_pool_serving_matches_single_device(tmp_path, arch, dtype, kw):
    """``ServingEngine(mesh=)`` on a 1x2 mesh (KV heads and weights over
    ``model``) serves the unsharded engine's streams, up to near-ties,
    with the same host transfers: reduced qwen2.5-3b in f32 (the
    reference's case), gemma2-9b (local rings, softcaps) and w8kv8."""
    _spawn(tmp_path, 2, _serving_worker, arch, dtype, kw)


def _restore_worker(rank, path):
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serving.checkpoint import EngineCheckpointer
    from repro_torch.serving.engine import ServingEngine
    cfg = reduce_config(get_config("qwen2.5-3b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
    prompts = _prompts(cfg)
    wide, tall = small_mesh(1, 2, device_type="cpu"), small_mesh(2, 1, device_type="cpu")
    full_run = _drain(_engine(cfg, params, wide), prompts)
    eng = _engine(cfg, params, wide)
    ck = EngineCheckpointer(eng, str(path / "ckpt"))
    for p in prompts:
        ck.submit(p)
    for _ in range(4):
        eng.step()
    ck.save()
    dist.barrier()                       # the first rank has written it
    for mesh in (tall, None):            # another mesh, and none at all
        back = ServingEngine.restore(cfg, params, str(path / "ckpt"), device="cpu",
                                     mesh=mesh)
        back.run_until_drained()
        got = [r.output for r in sorted(back.finished, key=lambda r: r.uid)]
        _same_streams(params, cfg, prompts, full_run, got)


def test_restore_across_meshes(tmp_path):
    """A snapshot taken mid-drain on a 1x2 mesh restores on 2x1 and with
    no mesh, and each drains to the uninterrupted run's streams."""
    _spawn(tmp_path, 2, _restore_worker, tmp_path)


# ---------------------------------------------------------------------------
# speculative decoding under a mesh
# ---------------------------------------------------------------------------

SPEC_CASES = {"self": dict(spec_draft_bits=0), "self-w8": dict(spec_draft_bits=8),
              "model": dict(spec_draft="model")}

# The reference's spec engine under a forced 2-device mesh, in a process of
# its own (the host device count is fixed at JAX's import): reduced
# qwen2.5-3b (PRNGKey 0) and a 1-layer draft (PRNGKey 1), f32; it writes
# both parameter trees for the port's ranks and its streams.
_REFERENCE_SPEC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses, itertools, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.config import get_config, reduce_config
from repro.models import transformer as T
from repro.serving.engine import EngineConfig, ServingEngine
params_path, out_path = sys.argv[1:3]
cfg = reduce_config(get_config("qwen2.5-3b"))
dcfg = dataclasses.replace(cfg, n_layers=1, name=cfg.name + "-draft")
params = T.init_params(cfg, jax.random.PRNGKey(0), param_dtype=jnp.float32)
dparams = T.init_params(dcfg, jax.random.PRNGKey(1), param_dtype=jnp.float32)
with open(params_path, "wb") as f:
    pickle.dump((jax.device_get(params), jax.device_get(dparams)), f)
streams = []
for shape, kw in itertools.product(((1, 2), (2, 1)), (
        dict(spec_draft_bits=0), dict(spec_draft_bits=8), dict(spec_draft="model"))):
    mesh = Mesh(np.asarray(jax.devices()).reshape(shape), ("data", "model"))
    eng = ServingEngine(cfg, params, EngineConfig(max_batch=2, kv_len=48, max_new_tokens=5,
                                                  prefill_chunk=16, spec_k=4, **kw),
                        mesh=mesh, draft=(dcfg, dparams) if "spec_draft" in kw else None)
    rng = np.random.default_rng(0)
    for n in (4, 7, 23, 10):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n))
    eng.run_until_drained()
    streams.append([r.output for r in sorted(eng.finished, key=lambda r: r.uid)])
np.save(out_path, np.asarray(streams, np.int32))
"""


def _spec_models(params_path):
    """The reference's trees (:data:`_REFERENCE_SPEC`) as the port's f32
    parameters: (cfg, params, (draft cfg, draft params))."""
    import dataclasses
    import pickle

    from repro_torch.convert import params_from_jax
    cfg = reduce_config(get_config("qwen2.5-3b"))
    dcfg = dataclasses.replace(cfg, n_layers=1, name=cfg.name + "-draft")
    with open(params_path, "rb") as f:
        tree, dtree = pickle.load(f)
    return (cfg, params_from_jax(tree, cfg, device="cpu", dtype=torch.float32),
            (dcfg, params_from_jax(dtree, dcfg, device="cpu", dtype=torch.float32)))


def _spec_drain(cfg, params, draft, mesh, case):
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    kw = SPEC_CASES[case]
    eng = ServingEngine(cfg, params, EngineConfig(**SERVE, spec_k=4, **kw), device="cpu",
                        mesh=mesh, draft=draft if kw.get("spec_draft") == "model" else None)
    return eng, _drain(eng, _prompts(cfg))


def _spec_worker(rank, params_path, out_path):
    import itertools

    from repro_torch.launch.mesh import small_mesh
    cfg, params, draft = _spec_models(params_path)
    meshes = small_mesh(1, 2, device_type="cpu"), small_mesh(2, 1, device_type="cpu")
    streams = []
    for mesh, case in itertools.product(meshes, SPEC_CASES):
        sharded, got = _spec_drain(cfg, params, draft, mesh, case)
        if case == "model":
            # the draft pool is placed as the target pool
            d = sharded.pool.draft_cache["stack"][0]["u0"]["attn"]["k"]
            t = sharded.pool.cache["stack"][0]["u0"]["attn"]["k"]
            assert tuple(d.placements) == tuple(t.placements), (d.placements, t.placements)
        plain, want = _spec_drain(cfg, params, draft, None, case)
        assert got == want, (case, got, want)
        for key in ("spec_steps", "spec_drafted", "spec_accepted", "spec_committed",
                    "host_transfers", "decode_steps"):
            assert getattr(sharded, key) == getattr(plain, key), (case, key)
        assert sharded.stats()["finished"] == len(PROMPTS)
        streams.append(got)
    if rank == 0:
        np.save(out_path, np.asarray(streams, np.int32))


def test_spec_decoding_under_mesh(tmp_path):
    """``ServingEngine(mesh=, spec_k=4)``, greedy, f32, on a 1x2 mesh (KV
    heads over ``model``) and a 2x1 mesh (slots over ``data``), each with
    a lossless self-draft, an 8-bit self-draft and a 1-layer draft
    model: the streams, the speculative counters and the host transfers
    equal the mesh-less spec engine's bit for bit, and the streams equal
    the reference's spec engine under a forced 2-device mesh up to
    near-ties (the target model's margin: it decides what a greedy stream
    commits)."""
    import os
    import subprocess
    import sys
    params_path, ref = tmp_path / "params.pkl", tmp_path / "ref.npy"
    subprocess.run([sys.executable, "-c", _REFERENCE_SPEC, str(params_path), str(ref)], check=True, timeout=JOIN_S,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    out = tmp_path / "port.npy"
    _spawn(tmp_path, 2, _spec_worker, str(params_path), str(out))
    cfg, params, _ = _spec_models(params_path)
    for want, got in zip(np.load(ref), np.load(out)):
        _same_streams(params, cfg, _prompts(cfg), [list(x) for x in want],
                      [list(x) for x in got])
