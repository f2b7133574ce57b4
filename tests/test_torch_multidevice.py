"""The port's sharded plane on several ranks: each test spawns its ranks
(``torch.multiprocessing``, gloo on the CPU, a ``FileStore`` under the
test's ``tmp_path``, so that parallel test workers never share a port),
at most four, and joins them within a time limit.  Each is the port's
counterpart of one of the reference's ``tests/test_multidevice.py``:
a sharded train step equal to the single-device one, an elastic re-mesh
equal to an uninterrupted run, the ring collective matmuls, int8
compressed gradients, the sharded slot pool serving the unsharded
engine's streams, and a snapshot restored on another mesh.  Asserts run in
the ranks; a failing rank fails the test with its traceback.  Cases of one
world size that need no state of their own share a spawn (a module-scoped
fixture runs them one after another, :func:`_run_cases`): a spawn and its
first DTensor calls cost several seconds, most of such a case's time."""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
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


def _spawn(tmp_path, world: int, fn, *args, join_s: float = JOIN_S):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; fail on any rank's
    error or after ``join_s`` seconds (the ranks are then terminated)."""
    ctx = mp.start_processes(_entry, args=(world, str(tmp_path / "store"), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + join_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"{fn.__name__} did not finish in {join_s} s")


def _cases_worker(rank, cases, done):
    for name, (fn, args) in cases.items():
        globals()[fn](rank, *args)
        if rank == 0:
            with open(done, "a") as f:
                f.write(name + "\n")


def _run_cases(tmp_path, cases: dict) -> list:
    """Run ``cases`` (name -> (the name of a worker of this module, its
    arguments after the rank)) one after another in one spawn of 4 ranks,
    ``JOIN_S`` seconds a case: the names of those that ran to their end
    on every rank.  A rank's failure fails the spawn, and every case of
    the group with it."""
    done = tmp_path / "done"
    _spawn(tmp_path, 4, _cases_worker, cases, str(done), join_s=JOIN_S * len(cases))
    return done.read_text().split("\n")


def _f32_loss():
    """Both steps in f32 (the tolerance is f32's): loss_fn's compute dtype
    patched, as the port's train-parity tests patch it."""
    from repro_torch.models import transformer as T
    if not isinstance(T.loss_fn, functools.partial):
        T.loss_fn = functools.partial(T.loss_fn, compute_dtype=torch.float32)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_step_worker(rank, arch, mostly_sharded=True, mesh_shape=(2, 2), kv_heads=None):
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.launch.steps import build_cell, make_train_step, place_args
    from repro_torch.models import transformer as T
    from repro_torch.parallel.api import AbstractMesh, Plan
    from repro_torch.training.optimizer import adamw_init
    _f32_loss()
    cfg = reduce_config(get_config(arch))
    if kv_heads is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv_heads)
    shape = ShapeSpec("t", "train", 32, 4)
    mesh = small_mesh(*mesh_shape, device_type="cpu")
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
    single = make_train_step(cfg, Plan(AbstractMesh(mesh_shape, ("data", "model")), {}))
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


SHARDED_TRAIN_ARCHS = ["qwen2.5-3b", "gemma2-9b", "qwen3-moe-30b-a3b", "deepseek-v2-236b"]
# the train steps' cases, one spawn of 4 ranks (:func:`_run_cases`)
TRAIN_CASES = {
    **{f"2x2 {arch}": ("_train_step_worker", (arch,)) for arch in SHARDED_TRAIN_ARCHS},
    **{f"1x4 gemma2-9b kv{h}": ("_train_step_worker", ("gemma2-9b", True, (1, 4), h))
       for h in (4, 2)},
    "2x2 mamba2-130m": ("_train_step_worker", ("mamba2-130m", False)),
}


@pytest.fixture(scope="module")
def train_steps(tmp_path_factory):
    return _run_cases(tmp_path_factory.mktemp("train_steps"), TRAIN_CASES)


@pytest.mark.parametrize("arch", SHARDED_TRAIN_ARCHS)
def test_sharded_train_step_matches_single_device(train_steps, arch):
    """``build_cell``'s train step on a 2x2 mesh (FSDP over ``data``,
    tensor and sequence parallel over ``model``, experts over ``model``)
    gives the single-device step's loss and gradient norm, two steps
    running, in f32; the MoE stacks' (gshard) against the single device
    under a role-less plan of the same shape."""
    assert f"2x2 {arch}" in train_steps


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_sequence_split_train_step_matches_single_device(train_steps, kv_heads):
    """Reduced gemma2-9b's train step on a 1x4 mesh at S 32: the residual
    is split into 8-token shards over ``model``, so its window-16 local
    layers, attention softcap and final softcap cross shard boundaries.
    With 4 KV heads attention is head-parallel; with 2 (full gemma2-9b's
    two query heads a KV head) the plan splits q's rows over the sequence
    and each rank attends its own rows at their true positions
    (``flash_attention.ops._planned_rows``).  The logits and the loss stay
    split over the vocab.  Loss and gradient norm equal the single-device
    step's, two steps running, in f32."""
    assert f"1x4 gemma2-9b kv{kv_heads}" in train_steps


# The reference's loss and gradients of reduced gemma2-9b (n_kv_heads
# given) under its own 1x4 train plan, in f32, on 4 forced host devices:
# one subprocess, one JAX import, for every case below.
_REFERENCE_GRADS = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.ckpt import flatten_tree
from repro.config import ShapeSpec, get_config, reduce_config
from repro.models import transformer as T
from repro.parallel import sharding as SH
from repro.parallel.api import activate_plan
mesh = Mesh(np.asarray(jax.devices()).reshape(1, 4), ("data", "model"))
out = {}
for kv in map(int, sys.argv[1].split(",")):
    cfg = dataclasses.replace(reduce_config(get_config("gemma2-9b")), n_kv_heads=kv)
    plan, ctx = SH.build_plan(cfg, ShapeSpec("t", "train", 32, 4), mesh, mode="train")
    params = jax.device_get(T.init_params(cfg, jax.random.PRNGKey(0)))
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
             .astype(np.int32)}
    def loss_f(p, b):
        with activate_plan(plan):
            return T.loss_fn(p, cfg, b, impl="ref", compute_dtype=jnp.float32, remat=True)
    shard = (SH.params_shardings(params, ctx), SH.batch_shardings(batch, ctx))
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_f, has_aux=True),
                               in_shardings=shard)(params, batch)
    out[kv] = dict(params=params, batch=batch, loss=float(loss),
                   grads=flatten_tree(jax.device_get(grads)))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""
SEQ_SPLIT_KV = (4, 2)


@pytest.fixture(scope="module")
def reference_seq_split_grads(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "grads.pkl"
    r = subprocess.run([sys.executable, "-c", _REFERENCE_GRADS,
                        ",".join(map(str, SEQ_SPLIT_KV)), str(path)],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-4000:]
    return path


def _reference_grads_worker(rank, path, kv_heads):
    from repro_torch.ckpt import flatten_tree
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.launch.steps import build_cell, place_args
    from repro_torch.models import transformer as T
    from repro_torch.parallel.api import activate_plan, full
    from repro_torch.tree import tree_leaves, tree_unflatten
    with open(path, "rb") as f:
        ref = pickle.load(f)[kv_heads]
    cfg = dataclasses.replace(reduce_config(get_config("gemma2-9b")), n_kv_heads=kv_heads)
    shape = ShapeSpec("t", "train", 32, 4)
    mesh = small_mesh(1, 4, device_type="cpu")
    _, _, plan = build_cell(cfg, shape, mesh)
    params = T.trainable(params_from_jax(ref["params"], cfg, device="cpu",
                                         dtype=torch.float32))
    params, batch = place_args(cfg, shape, mesh, params,
                               {k: torch.from_numpy(v) for k, v in ref["batch"].items()})
    leaves = tree_leaves(params)
    with activate_plan(plan):
        loss, _ = T.loss_fn(params, cfg, batch, compute_dtype=torch.float32, remat=True)
        grads = torch.autograd.grad(loss, leaves)
    got = flatten_tree(tree_unflatten(params, [full(g).numpy() for g in grads]))
    want = ref["grads"]
    assert _rel(float(full(loss.detach())), ref["loss"]) <= 1e-5, (float(full(loss)), ref["loss"])
    assert set(got) == set(want)
    # train parity's f32 bound: each leaf within 1e-4 of its scale
    for key, w in want.items():
        err, scale = float(np.abs(got[key] - w).max()), float(np.abs(w).max())
        assert err <= 1e-4 * scale, (key, err, scale)


@pytest.mark.parametrize("kv_heads", SEQ_SPLIT_KV)
def test_sequence_split_train_grads_match_the_reference(tmp_path, kv_heads,
                                                         reference_seq_split_grads):
    """The case above held to the reference's own sharded step: the same
    parameters and batch, the reference's loss and gradients under its 1x4
    train plan (its Megatron-SP attention, vocab-split logits and loss)
    against the port's under its plan, every leaf within train parity's
    f32 bound (1e-4 of the leaf's scale), the loss within 1e-5.  This
    holds the sequence-split attention's backward (dK/dV as partial sums)
    and the vocab-parallel NLL's ``softmax - onehot`` leaf by leaf."""
    _spawn(tmp_path, 4, _reference_grads_worker, str(reference_seq_split_grads), kv_heads)


def test_sharded_ssm_train_step_matches_single_device(train_steps):
    """mamba2-130m's train step on the 2x2 mesh, its SSD scan on each
    rank's batch rows and its own chunks of the sequence, the chunk states
    gathered for the inter-chunk recurrence (``ssm._planned_scan``), gives
    the single-device
    step's loss and gradient norm, two steps running, in f32 (most of its
    leaves are vectors the plan leaves whole)."""
    assert "2x2 mamba2-130m" in train_steps


def _recurrent_prefill_case(rank, arch):
    from repro_torch.models import transformer as T
    prefill = T.prefill
    T.prefill = functools.partial(prefill, compute_dtype=torch.float32)
    try:
        _recurrent_prefill(arch)
    finally:
        T.prefill = prefill


def _recurrent_prefill(arch):
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.launch.steps import build_cell, place_args
    from repro_torch.models import transformer as T
    from repro_torch.parallel.api import full
    cfg = reduce_config(get_config(arch))
    shape = ShapeSpec("p", "prefill", 64, 2)
    mesh = small_mesh(1, 4, device_type="cpu")
    fn, _, plan = build_cell(cfg, shape, mesh)
    assert plan.spec("residual")[1] == "model"            # the sequence split 4 ways
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    p, b = place_args(cfg, shape, mesh, params, {"tokens": tokens})
    logits, cache = fn(p, b)
    want, want_cache = T.prefill(params, cfg, tokens, kv_cap=64)
    assert torch.allclose(full(logits), want, atol=1e-5, rtol=1e-5)
    for (path, got), (_, leaf) in zip(_leaves(cache), _leaves(want_cache)):
        assert torch.allclose(full(got).float(), leaf.float(), atol=1e-5, rtol=1e-5), path


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _leaves(t, f"{path}/{i}")]
    return [(path, tree)]


# the sequence-split routes' cases on 1x4, one spawn of 4 ranks (:func:`_run_cases`)
SPLIT_ROUTE_CASES = {
    "prefill mamba2-130m": ("_recurrent_prefill_case", ("mamba2-130m",)),
    "prefill recurrentgemma-9b": ("_recurrent_prefill_case", ("recurrentgemma-9b",)),
    "prefill serving": ("_serving_worker", ("qwen2.5-3b", "float32", {}, 4)),
    "split-kv decode fp": ("_split_kv_case", (0, 100.0)),
    "split-kv decode kv8": ("_split_kv_case", (8, 100.0)),
}


@pytest.fixture(scope="module")
def split_routes(tmp_path_factory):
    return _run_cases(tmp_path_factory.mktemp("split_routes"), SPLIT_ROUTE_CASES)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_sequence_split_recurrent_prefill_matches_single_device(split_routes, arch):
    """A prefill step of the recurrent kinds on a 1x4 mesh, in f32: the
    plan splits the stream's 64 tokens 4 ways, and each rank runs the
    causal conv (``ssm.planned_conv``: the 3 inputs before its part from
    the rank before it) and the scan (mamba2's chunks, ``ssd_scan``'s
    ``split``; the RG-LRU's ``linear_scan``'s ``split``) on its own part.
    The logits and every cache leaf (the conv and recurrent states, the
    local layers' rings) are the single-device prefill's."""
    assert f"prefill {arch}" in split_routes


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


def _serving_worker(rank, arch, dtype, kw, model=2):
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.models import transformer as T
    cfg = reduce_config(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=getattr(torch, dtype))
    prompts = _prompts(cfg)
    mesh = small_mesh(1, model, device_type="cpu")
    sharded = _engine(cfg, params, mesh, **kw)
    # the pool is sharded: its KV heads over model where they divide it,
    # else its sequence
    k = sharded.pool.cache["stack"][0]["u0"]["attn"]
    leaf = k["k"] if "k" in k else k["k_q"]
    assert leaf.placements[1].is_shard(3 if cfg.n_kv_heads % model == 0 else 2), \
        leaf.placements
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


def test_sequence_split_prefill_serving_matches_single_device(split_routes):
    """Reduced qwen2.5-3b (2 KV heads) on a 1x4 mesh: its heads do not
    divide ``model``, so the prefill plan splits q's rows over the
    sequence with K/V replicated, each rank's rows going to the prefill
    kernel at their offset (``flash_attention.ops._planned_rows``), and the
    decode plan keeps the pool split along its entries
    (``ops._planned_split_kv``).  The engine serves the unsharded engine's
    streams, with the same host transfers."""
    assert "prefill serving" in split_routes


def _split_kv_case(rank, kv_bits, q_gain):
    from repro_torch.kernels.flash_attention import ops
    routed = []
    split_kv = ops._planned_split_kv
    ops._planned_split_kv = lambda *a: routed.append(a[2].shape) or split_kv(*a)
    try:
        _split_kv_serving(kv_bits, q_gain, routed)
    finally:
        ops._planned_split_kv = split_kv


def _split_kv_serving(kv_bits, q_gain, routed):
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.models import transformer as T
    cfg = reduce_config(get_config("qwen2.5-3b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
    with torch.no_grad():                # scores past 88, where exp overflows f32
        for name in ("wq", "bq"):
            params["stack"][0]["u0"]["attn"][name].mul_(q_gain)
    prompts = _prompts(cfg)
    sharded = _engine(cfg, params, small_mesh(1, 4, device_type="cpu"), kv_bits=kv_bits)
    pool = sharded.pool.cache["stack"][0]["u0"]["attn"]
    for leaf in ("k_q", "k_s", "v_q", "v_s") if kv_bits else ("k", "v"):
        assert pool[leaf].placements[1].is_shard(2), (leaf, pool[leaf].placements)
    got = _drain(sharded, prompts)
    plain = _engine(cfg, params, None, kv_bits=kv_bits)
    want = _drain(plain, prompts)
    _same_streams(params, cfg, prompts, want, got)
    assert sharded.host_transfers == plain.host_transfers
    # every decode step's layers attended the split pool (its whole 48
    # entries, each rank its 12), never a gathered copy
    assert routed and all(shape[1] == SERVE["kv_len"] for shape in routed), routed
    assert len(routed) >= sharded.stats()["decode_steps"] * cfg.n_layers


@pytest.mark.parametrize("kv", ["fp", "kv8"])
def test_sequence_split_kv_decode_serving_matches_single_device(split_routes, kv):
    """Reduced qwen2.5-3b on a 1x4 mesh, fp and at ``kv_bits=8``: the pool
    (its code and scale planes too) is split along its entries, and every
    decode step attends it split, each rank its own entries, the ranks'
    rows merged by their log-sum-exp (``ops._planned_split_kv``).  Its
    queries are scaled up so that the scores pass 88, where a merge
    without its max overflows (queries x100).  The engine serves the
    unsharded engine's streams, with the same host transfers."""
    assert f"split-kv decode {kv}" in split_routes


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
