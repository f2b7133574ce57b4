"""The port's roofline plane (``repro_torch.roofline``) and the config's
counting against the live reference, on the CPU.

- The config: parameter counts, active counts, ``supports`` and
  ``flops_per_token`` equal the reference's for every registered config
  and every assigned shape (the counterpart of ``tests/test_archs.py``'s
  registry checks), and the count equals the numel of the port's own
  reduced parameters.
- The roofline arithmetic: the reference's HLO costs of
  ``tests/test_roofline.py``'s hand-written modules fed to the port's
  ``roofline_terms`` give the reference's report field for field.
- The counting: a matmul, a loop of matmuls and the collectives of a fake
  process group of 256 ranks count what the reference's HLO walk counts
  for the same work, and a matmul's bytes agree with the traffic model as
  the reference's pin says.
- Whole steps: the counted FLOPs of reduced train, prefill and decode
  steps against the reference's HLO walk of the same cells, compiled.
- The memory tracker on a hand-built sequence.

A test that opens a process group opens a fake one in-process and destroys
it before it returns (``fake_group``); none is left behind in a worker.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as JAX_SHAPES
from repro.config import ShapeSpec as JaxShapeSpec
from repro.config import flops_per_token as jax_flops_per_token
from repro.config import get_config as jax_get_config
from repro.config import list_archs as jax_list_archs
from repro.config import reduce_config as jax_reduce_config
from repro.roofline.analysis import roofline_terms as jax_roofline_terms
from repro.roofline.hlo import analyze_hlo_text
from repro_torch.config import (ASSIGNED_ARCHS, PAPER_ARCHS, SHAPES, ShapeSpec,
                                flops_per_token, get_config, list_archs, reduce_config)
from repro_torch.launch.dryrun import fake_group, trace_cell
from repro_torch.models import transformer as T
from repro_torch.roofline import H100, V5E, analyze_step, roofline_terms
from repro_torch.roofline.dispatch import COLLECTIVES
from test_roofline import HLO_COLLECTIVES, HLO_DOT, HLO_WHILE, _dot_hlo

ALL_ARCHS = list_archs()


# ---------------------------------------------------------------------------
# the config's counting and supports
# ---------------------------------------------------------------------------

def test_registry_equals_the_reference():
    assert list_archs() == jax_list_archs()
    assert list_archs(assigned_only=True) == jax_list_archs(assigned_only=True)
    assert len(ALL_ARCHS) == 16
    assert set(ASSIGNED_ARCHS) | set(PAPER_ARCHS) == set(ALL_ARCHS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_and_supports_equal_the_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert flops_per_token(cfg) == jax_flops_per_token(ref)
    assert (cfg.attn_free, cfg.subquadratic, cfg.has_bounded_state_layers) == \
        (ref.attn_free, ref.subquadratic, ref.has_bounded_state_layers)
    for name, shape in SHAPES.items():
        assert cfg.supports(shape) == ref.supports(JAX_SHAPES[name]), name
    # the count is the port's own tree: its reduced parameters' numel
    small = reduce_config(cfg)
    params = T.init_params(small, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
    assert small.param_count() == sum(p.numel() for p in params.parameters())
    assert small.param_count() == jax_reduce_config(ref).param_count()
    assert small.active_param_count() == jax_reduce_config(ref).active_param_count()


# ---------------------------------------------------------------------------
# the roofline arithmetic on the reference's own costs
# ---------------------------------------------------------------------------

HLO_MEMORY_BOUND = """
HloModule t

ENTRY %main (p: f32[4096,4096]) -> f32[4096,4096] {
  %p = f32[4096,4096]{1,0} parameter(0)
  ROOT %f = f32[4096,4096]{1,0} fusion(%p), kind=kLoop, calls=%fc
}
"""


@pytest.mark.parametrize("hlo,n_dev", [(HLO_DOT, 4), (HLO_WHILE, 1),
                                       (HLO_COLLECTIVES, 256), (HLO_MEMORY_BOUND, 1)],
                         ids=["dot", "while", "collectives", "memory"])
def test_roofline_terms_equal_the_reference(hlo, n_dev):
    """``roofline_terms`` on the reference's ``HloCost`` (a cost record
    with the fields the port's ``StepCost`` has) at the v5e constants is
    the reference's report, field for field; at the H100's, the same
    arithmetic."""
    cost = analyze_hlo_text(hlo, num_devices=n_dev)
    kw = dict(arch="x", shape="y", mesh_name="single", n_devices=n_dev, model_flops=1e9)
    got = dataclasses.asdict(roofline_terms(cost, hw=V5E, **kw))
    assert got == dataclasses.asdict(jax_roofline_terms(hlo, **kw))
    h = roofline_terms(cost, **kw)
    assert h.compute_s == cost.flops / H100.peak_flops
    assert h.memory_s == cost.bytes_hbm / H100.hbm_bw
    assert h.step_s == max(h.compute_s, h.memory_s, h.collective_s)


# ---------------------------------------------------------------------------
# counting primitives against the reference's HLO walk
# ---------------------------------------------------------------------------

def test_matmul_flops_and_bytes():
    a, b = torch.randn(128, 256), torch.randn(256, 512)
    cost = analyze_step(torch.matmul, a, b)
    ref = analyze_hlo_text(HLO_DOT)
    assert cost.flops == ref.flops
    assert cost.bytes_hbm == ref.bytes_hbm          # operands + result, f32
    assert cost.n_ops == 1


def test_loop_counts_every_iteration():
    """Eager dispatch runs each iteration: 12 matmuls count the 12 trips
    the reference reads off its while loop."""
    def loop(m):
        for _ in range(12):
            m = m @ m
        return m
    cost = analyze_step(loop, torch.randn(64, 64))
    ref = analyze_hlo_text(HLO_WHILE)
    assert cost.flops == ref.flops
    assert cost.n_ops == 12 and ref.n_while == 1


def test_views_and_metadata_count_nothing():
    x = torch.randn(64, 32)

    def views(x):
        return x.t().reshape(32, 64)[:, :8].unsqueeze(0).expand(4, 32, 8)
    cost = analyze_step(views, x)
    assert cost.flops == 0 and cost.bytes_hbm == 0


def test_gather_and_indexed_write_count_their_rows():
    """A gather reads the rows it takes, an indexed write in place writes
    the rows it writes: not the whole table."""
    table, idx = torch.randn(1000, 64), torch.tensor([3, 7])
    cost = analyze_step(lambda t, i: t[i], table, idx)
    assert cost.bytes_hbm == idx.numel() * 8 + 2 * (2 * 64 * 4)
    vals = torch.randn(2, 64)

    def put(t, i, v):
        t[i] = v
        return t
    cost = analyze_step(put, table, idx, vals)
    assert cost.bytes_hbm == idx.numel() * 8 + 2 * vals.numel() * 4


def test_unknown_op_raises():
    lib = torch.library.Library("roofline_test", "DEF")
    lib.define("twice(Tensor x) -> Tensor")
    lib.impl("twice", lambda x: x * 2, "CPU")
    with pytest.raises(NotImplementedError, match="cannot classify"):
        analyze_step(torch.ops.roofline_test.twice, torch.randn(4))


@pytest.fixture
def fake_256():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with fake_group(256):
        yield dist
    assert not dist.is_initialized()


def test_collective_wire_bytes_equal_the_reference(fake_256):
    """On a fake group of 256 ranks: an all-gather and a reduce-scatter
    over groups of 4, an all-reduce over all 256 and a send/recv pair (the
    counterpart of ``collective-permute``), as ``HLO_COLLECTIVES`` has
    them: the reference's wire bytes, kind by kind, exactly; the
    functional collectives (DTensor's) the same as the ``c10d`` ones."""
    import torch.distributed._functional_collectives as funcol
    dist = fake_256
    g4 = dist.new_group(list(range(4)))
    p = torch.zeros(64, 1024, dtype=torch.bfloat16)

    def c10d_step(p):
        out = torch.empty(256, 1024, dtype=p.dtype)
        dist.all_gather_into_tensor(out, p, group=g4)
        dist.all_reduce(p)
        rs = torch.empty(16, 1024, dtype=p.dtype)
        dist.reduce_scatter_tensor(rs, p, group=g4)
        got = torch.empty_like(p)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, p, 1),
                                         dist.P2POp(dist.irecv, got, 1)]):
            w.wait()
        return got

    def functional_step(p):
        funcol.all_gather_tensor(p, 0, g4).wait()
        funcol.all_reduce(p, "sum", dist.group.WORLD).wait()
        return funcol.reduce_scatter_tensor(p, "sum", 0, g4).wait()

    ref = analyze_hlo_text(HLO_COLLECTIVES, num_devices=256).collective_bytes
    cost = analyze_step(c10d_step, p, num_devices=256)
    assert cost.collective_bytes == ref
    assert set(cost.collective_bytes) <= set(COLLECTIVES)
    fcost = analyze_step(functional_step, p, num_devices=256)
    assert fcost.collective_bytes == {k: v for k, v in ref.items()
                                      if k != "collective-permute"}
    # all-to-all: the input's bytes times (g - 1) / g
    a2a = analyze_step(lambda p: funcol.all_to_all_single(p, None, None, g4).wait(), p,
                       num_devices=256)
    assert a2a.collective_bytes == {"all-to-all": p.numel() * 2 * 3 / 4}
    with pytest.raises(ValueError, match="over 256 ranks"):
        analyze_step(lambda p: dist.all_reduce(p), p, num_devices=4)


@pytest.mark.parametrize("arch", ["bert-base", "gemma2-9b"])
def test_dispatch_bytes_agree_with_traffic_phase_bytes(arch):
    """The port's copy of the reference's pin: the counted bytes of the
    dots the kqv and score phases model (``f16[N,D] @ f16[D,(1+2f)D]``,
    the ``[D,D]`` out-projection) agree with ``traffic.phase_bytes``
    within 2%, and equal the reference's walked bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.traffic import Workload, phase_bytes, transformer_phases
    N = 64
    w = Workload.from_config(get_config(arch), seq_len=N)
    D = w.d_model
    fused = round((1 + 2 * w.n_kv_heads / w.n_heads) * D)
    phases = {p.name: p for p in transformer_phases(w)}
    for name, (k_dim, n_dim) in (("kqv", (D, fused)), ("score", (D, D))):
        with FakeTensorMode():
            x = torch.empty(N, k_dim, dtype=torch.float16)
            wt = torch.empty(k_dim, n_dim, dtype=torch.float16)
            walked = analyze_step(torch.matmul, x, wt).bytes_hbm
        modeled = phase_bytes(phases[name])
        assert walked == analyze_hlo_text(_dot_hlo(N, k_dim, n_dim)).bytes_hbm
        assert abs(walked - modeled) <= 0.02 * modeled, (arch, name, walked, modeled)


# ---------------------------------------------------------------------------
# whole steps against the reference's compiled HLO
# ---------------------------------------------------------------------------

STEP_SHAPES = {"train": (32, 2), "prefill": (32, 2), "decode": (64, 2)}
WHOLE_STEP_TOL = 0.02
# A MoE train step under remat: torch.utils.checkpoint recomputes each
# layer's whole forward in the backward pass, where XLA's dead-code
# elimination drops the recomputed einsums (the GShard combine among them)
# whose outputs no gradient reads.  Measured: +3.05% on qwen3-moe, +2.30%
# on deepseek-v2 (reduced, S 32, B 2); without remat the gap is the
# router product alone (test below).
MOE_REMAT_TOL = 0.035


def _reference_flops(arch, kind, *, remat=True):
    """The reference's HLO walk of its cell on a one-device mesh (its
    ``build_cell``; the train step rebuilt where ``remat`` is off)."""
    from jax.sharding import Mesh

    from repro.launch import steps as JST
    from repro.parallel import sharding as JSH
    from repro.training.optimizer import adamw_init
    S, B = STEP_SHAPES[kind]
    cfg, shape = jax_reduce_config(jax_get_config(arch)), JaxShapeSpec("t", kind, S, B)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    if remat:
        jfn, args, _ = JST.build_cell(cfg, shape, mesh)
    else:
        plan, _ = JSH.build_plan(cfg, shape, mesh, mode="train")
        jfn = jax.jit(JST.make_train_step(cfg, plan, remat=False))
        p = JST.params_specs(cfg, jnp.float32)
        args = (p, jax.eval_shape(adamw_init, p), JST.batch_specs(cfg, shape))
    return analyze_hlo_text(jfn.lower(*args).compile().as_text()).flops


def _port_flops(arch, kind, *, remat=True):
    """The port's counted FLOPs of the same cell on a one-rank mesh of a
    fake group: a plan active, as the reference's ``build_cell`` keeps one
    on its one-device mesh (the MoE layer takes the planned paths)."""
    from repro_torch.launch.mesh import small_mesh
    S, B = STEP_SHAPES[kind]
    cfg, shape = reduce_config(get_config(arch)), ShapeSpec("t", kind, S, B)
    with fake_group(1):
        return trace_cell(cfg, shape, small_mesh(1, 1, device_type="cpu"), remat=remat).flops


@pytest.mark.parametrize("kind", list(STEP_SHAPES))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_step_flops_equal_the_reference_hlo(arch, kind):
    """The counted FLOPs of a reduced step (one device) against the
    reference's HLO walk of the same cell: within 2% (the dense stack and
    every serving step count the same FLOPs exactly), and a MoE train
    step within :data:`MOE_REMAT_TOL` (its remat, above)."""
    ref, got = _reference_flops(arch, kind), _port_flops(arch, kind)
    tol = MOE_REMAT_TOL if kind == "train" and get_config(arch).is_moe else WHOLE_STEP_TOL
    assert abs(got - ref) <= tol * ref, (arch, kind, got, ref, got / ref)
    assert got >= ref                      # the port never counts less


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_moe_train_gap_without_remat_is_the_router_product(arch):
    """Without remat a MoE train step's gap is one router product a MoE
    layer (``2 * B * S * D * E``): the aux loss's second ``x @ router``,
    which XLA merges with the gate's (CSE) and the port computes again."""
    cfg = reduce_config(get_config(arch))
    S, B = STEP_SHAPES["train"]
    router = 2.0 * B * S * cfg.d_model * cfg.n_experts
    n_moe = sum(cfg.moe_layer_mask())
    gap = _port_flops(arch, "train", remat=False) - _reference_flops(arch, "train",
                                                                     remat=False)
    assert gap == n_moe * router


# ---------------------------------------------------------------------------
# the memory tracker
# ---------------------------------------------------------------------------

def test_memory_tracker_on_a_known_sequence():
    """Allocate, free, allocate, update in place: the peak, the outputs
    and the alias bytes (an output that is an argument updated in place)
    are known."""
    n = 1024 * 4                                   # bytes of one f32 (1024,)

    def seq(x):
        y = x * 2                                  # live: x, y
        z = y + 1                                  # live: x, y, z (peak 3n)
        del y                                      # live: x, z
        w = z * 3                                  # live: x, z, w (3n again)
        del z
        w.add_(1)                                  # in place: nothing new
        x.mul_(2)                                  # the argument, in place
        return w, x
    cost = analyze_step(seq, torch.randn(1024))
    assert cost.argument_bytes == n
    assert cost.peak_bytes == 3 * n
    assert cost.output_bytes == 2 * n
    assert cost.alias_bytes == n
    assert cost.temp_bytes == 3 * n - (n + 2 * n - n)
    assert [t[0] for t in cost.largest_tensors] == [n, n, n]
