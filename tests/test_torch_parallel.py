"""The port's parallel plane as data (``repro_torch.parallel.sharding``,
``repro_torch.launch.mesh``) against the reference's.

Every plan is built on an abstract mesh on both sides (no devices, no
process group): the reference's on ``jax.sharding.AbstractMesh``, the
port's on its own ``AbstractMesh``.  For every registered config, each of
the four ``SHAPES`` plans and the serving decode and prefill plans, on
five meshes, the port's roles, the spec of every leaf of the port's
parameter tree (``param_spec``), of its slot pool's leaves at fp,
``kv_bits`` 8 and 4 (``cache_shardings``) and of its batch
(``batch_shardings``) must equal the reference's ``PartitionSpec``s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as P

import repro.configs  # noqa: F401  (registers every config)
from repro.config import SHAPES as JSHAPES
from repro.config import _REGISTRY as REF_REGISTRY
from repro.config import get_config as jax_get_config
from repro.launch import mesh as JM
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro.parallel import sharding as JSH
from repro_torch.config import SHAPES, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.api import AbstractMesh

ARCHS = sorted(REF_REGISTRY)
MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PLANS = (*SHAPES, "serving_decode", "serving_prefill")
# the serving plans' pool and packed stream
MAX_BATCH, KV_LEN, CHUNK = 8, 4096, 128


def _ref_path(kp) -> str:
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) if hasattr(p, "idx")
                    else str(p) for p in kp)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    return JST.params_specs(jax_get_config(arch), jnp.float32)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return T.init_params(get_config(arch), None, device="meta", dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _ref_cache_shapes(arch, batch, seq, kv_bits):
    cfg = jax_get_config(arch)
    return jax.eval_shape(lambda: JT.init_cache(cfg, batch, seq, dtype=jnp.bfloat16,
                                                kv_bits=kv_bits))


def _plans(arch, plan, shape):
    """(reference (plan, ctx), port (plan, ctx)) of one plan on one mesh."""
    sizes, names = MESHES[shape]
    jmesh, mesh = JAbstractMesh(sizes, names), AbstractMesh(sizes, names)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if plan == "serving_decode":
        return (JSH.serving_decode_plan(jcfg, jmesh, max_batch=MAX_BATCH, kv_len=KV_LEN),
                SH.serving_decode_plan(cfg, mesh, max_batch=MAX_BATCH, kv_len=KV_LEN))
    if plan == "serving_prefill":
        return (JSH.serving_prefill_plan(jcfg, jmesh, prefill_chunk=CHUNK),
                SH.serving_prefill_plan(cfg, mesh, prefill_chunk=CHUNK))
    return (JSH.build_plan(jcfg, JSHAPES[plan], jmesh, mode=JSHAPES[plan].kind),
            SH.build_plan(cfg, SHAPES[plan], mesh, mode=SHAPES[plan].kind))


def _flat_ref(shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    return {_ref_path(kp): s.spec for kp, s in flat}


def _same(port: dict, ref: dict, what: str):
    assert set(port) == set(ref), (what, sorted(set(port) ^ set(ref))[:8])
    bad = [(k, port[k], ref[k]) for k in sorted(ref) if P(*port[k]) != ref[k]]
    assert not bad, (what, bad[:8])


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_tables_equal_the_reference(arch, plan, shape):
    (jplan, jctx), (pplan, pctx) = _plans(arch, plan, shape)
    assert pplan.name == jplan.name
    assert (pctx.fsdp, tuple(pctx.dp), pctx.seq_axis) == (jctx.fsdp, tuple(jctx.dp),
                                                          jctx.seq_axis)
    _same(pplan.roles, jplan.roles, "roles")

    _same(SH.params_shardings(_port_params(arch), pctx),
          _flat_ref(JSH.params_shardings(_ref_param_shapes(arch), jctx)), "params")

    B, S = pctx.shape.global_batch, pctx.shape.seq_len
    if plan == "serving_prefill":
        B, S = MAX_BATCH, KV_LEN            # the pool is the decode plan's
    cfg = get_config(arch)
    for kv_bits in (0, 8, 4):
        try:
            ref = _ref_cache_shapes(arch, B, S, kv_bits)
        except Exception as e:              # a stack the pool cannot hold
            with pytest.raises(type(e)):
                T.init_cache(cfg, B, S, device="meta", kv_bits=kv_bits)
            continue
        port = T.init_cache(cfg, B, S, device="meta", kv_bits=kv_bits)
        _same(dict(SH.spec_items(SH.cache_shardings(port, pctx))),
              _flat_ref(JSH.cache_shardings(ref, jctx)), f"cache kv_bits={kv_bits}")

    jshape = jctx.shape
    _same(SH.batch_shardings(ST.batch_specs(cfg, pctx.shape), pctx),
          _flat_ref(JSH.batch_shardings(JST.batch_specs(jax_get_config(arch), jshape), jctx)),
          "batch")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_the_reference(arch):
    """``_serving_fsdp`` reads it: the port counts its meta tree."""
    assert get_config(arch).param_count() == jax_get_config(arch).param_count()


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16), (4, 8)])
@pytest.mark.parametrize("curve", ["boustrophedon", "hilbert", "onion"])
def test_sfc_device_order_equals_the_reference(shape, curve):
    try:
        ref = JM.sfc_device_order(shape, curve)
    except Exception as e:
        with pytest.raises(type(e)):
            M.sfc_device_order(shape, curve)
        return
    port = M.sfc_device_order(shape, curve)
    np.testing.assert_array_equal(port, ref)
    assert sorted(port.tolist()) == list(range(int(np.prod(shape))))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_without_enough_ranks_raises(multi_pod):
    """As the reference's without 256 (512) devices: here no process group
    is initialised at all."""
    with pytest.raises(RuntimeError, match="production mesh needs"):
        M.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match="production mesh needs"):
        JM.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match="mesh needs 4 ranks"):
        M.small_mesh(2, 2, device_type="cpu")


def test_axis_tuples_become_shards_in_mesh_order():
    """An axis tuple on one tensor dim shards it over each named mesh dim,
    major to minor in mesh-dim order (the PartitionSpec's order); axes
    named out of that order are refused."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel.api import placements

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert placements((("pod", "data"), None, "model"), Mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements((None, None), Mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), Mesh)


def test_quant_planes_shard_their_contraction_rows_together():
    """A quantised weight's planes follow its weight's spec; the K rows of
    codes and grouped scales are sharded on both or on neither, and a
    per-channel scale row is replicated."""
    mesh = AbstractMesh((1, 2), ("data", "model"))
    q, s1, sg = (torch.empty(s, device="meta") for s in ((64, 96), (1, 96), (3, 96)))
    assert SH.quant_plane_specs((None, "model"), q, s1, mesh) == ((None, "model"),
                                                                   (None, "model"))
    assert SH.quant_plane_specs(("model", None), q, s1, mesh) == (("model", None),
                                                                   (None, None))
    # 3 scale groups do not split over 2 ranks: neither plane splits K
    assert SH.quant_plane_specs(("model", None), q, sg, mesh) == ((None, None),
                                                                   (None, None))


# ---------------------------------------------------------------------------
# the MoE's gshard layer against the reference's
# ---------------------------------------------------------------------------

GSHARD_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-236b")
GSHARD_F32_TOL = 1e-5
GSHARD_BF16_TOL = 1e-2


@functools.lru_cache(maxsize=None)
def _moe_layers(arch):
    """Reduced ``arch`` in both packages and the first MoE layer's subtree
    of one set of weights (f32, the reference's draw): (cfg_j, cfg_t,
    layer_j, layer_t)."""
    from repro.config import reduce_config as jax_reduce_config
    from repro_torch.config import reduce_config
    from repro_torch.convert import params_from_jax
    cfg_j = jax_reduce_config(jax_get_config(arch))
    cfg_t = reduce_config(get_config(arch))
    params_j = JT.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    params_t = params_from_jax(jax.device_get(params_j), cfg_t, device="cpu",
                               dtype=torch.float32)
    g = next(i for i, s in enumerate(params_j["stack"]) if "moe" in s["u0"])
    layer_j = jax.tree_util.tree_map(lambda a: a[0], params_j["stack"][g]["u0"]["moe"])
    return cfg_j, cfg_t, layer_j, T._layer(params_t["stack"][g]["u0"]["moe"], 0)


def _role_less(G):
    """A role-less plan on a (1, G) mesh in each package: every constrain a
    no-op, the model axis G wide."""
    from repro.parallel.api import Plan as JPlan
    from repro_torch.parallel.api import Plan
    names = ("data", "model")
    return JPlan(JAbstractMesh((1, G), names), roles={}), Plan(AbstractMesh((1, G), names), {})


def _routed(cfg_t, layer_t, seed, shape):
    """Numpy x of ``shape`` and the port's routing of it (gates, expert ids)."""
    from repro_torch.models import moe as MT
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    gates, idx = MT.route(layer_t, torch.from_numpy(x), cfg_t)
    return x, gates.numpy(), idx.numpy()


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("arch", GSHARD_ARCHS)
def test_apply_gshard_matches_the_reference(arch, G):
    """``_apply_gshard`` on the same x, gates and expert ids as the
    reference's, f32, at G = 1 (no plan) and G = 2 (a role-less plan on a
    (1, 2) mesh), at the config's own ``capacity_factor``: some pairs
    overflow their group's capacity and drop, so the rank, capacity and
    keep logic decides the output.  Then ``apply_moe`` in prefill under
    the plan (shared experts included): gshard in both packages."""
    from repro.models import moe as MJ
    from repro.parallel.api import activate_plan as jax_activate_plan
    from repro_torch.models import moe as MT
    from repro_torch.parallel.api import activate_plan
    cfg_j, cfg_t, p_j, p_t = _moe_layers(arch)
    B, S = 2, 16
    x, gates, idx = _routed(cfg_t, p_t, 4, (B, S, cfg_t.d_model))
    Sg = S // G
    per_expert = np.stack([np.bincount(idx.reshape(B, G, Sg * cfg_t.top_k)[b, g],
                                       minlength=cfg_t.n_experts)
                           for b in range(B) for g in range(G)])
    assert (per_expert > MT._capacity(Sg, cfg_t)).any(), "no pair drops: nothing is tested"
    jplan, plan = (None, None) if G == 1 else _role_less(G)
    with jax_activate_plan(jplan):
        want = np.asarray(MJ._apply_gshard(p_j, jnp.asarray(x), jnp.asarray(gates),
                                           jnp.asarray(idx), cfg_j))
    with activate_plan(plan):
        got = MT._apply_gshard(p_t, torch.from_numpy(x), torch.from_numpy(gates),
                               torch.from_numpy(idx), cfg_t).numpy()
    np.testing.assert_allclose(got, want, atol=GSHARD_F32_TOL, rtol=0)
    # the drops show: the dropless layer's output is another
    dropless = MT._apply_dropless(p_t, torch.from_numpy(x), torch.from_numpy(gates),
                                  torch.from_numpy(idx), cfg_t).numpy()
    assert np.abs(dropless - want).max() > 100 * GSHARD_F32_TOL

    jplan, plan = _role_less(G)
    with jax_activate_plan(jplan):
        want = np.asarray(MJ.apply_moe(p_j, jnp.asarray(x), cfg_j, mode="prefill"))
    with activate_plan(plan):
        got = MT.apply_moe(p_t, torch.from_numpy(x), cfg_t, mode="prefill").numpy()
    np.testing.assert_allclose(got, want, atol=GSHARD_F32_TOL, rtol=0)


@pytest.mark.parametrize("arch", GSHARD_ARCHS)
def test_bf16_gshard_parts_from_f32_as_the_reference_does(arch):
    """With nothing dropped (``capacity_factor`` E / k) gshard computes the
    dropless layer's function.  In bf16, on the same bf16-exact x and the
    same routing, each package's gshard and dropless layers part from
    their f32 outputs by rounding alone; the port's bf16 gshard is held to
    the bf16 bound of its f32 output and of the reference's bf16 gshard,
    and parts from f32 by no more than twice what the reference's gshard
    or the port's own dropless layer do."""
    import dataclasses
    from repro.models import moe as MJ
    from repro_torch.models import moe as MT
    cfg_j, cfg_t, p_j, p_t = _moe_layers(arch)
    cfg_j = dataclasses.replace(cfg_j, capacity_factor=cfg_j.n_experts / cfg_j.top_k)
    cfg_t = dataclasses.replace(cfg_t, capacity_factor=cfg_t.n_experts / cfg_t.top_k)
    x, gates, idx = _routed(cfg_t, p_t, 5, (4, 32, cfg_t.d_model))
    x = torch.from_numpy(x).bfloat16().float().numpy()          # bf16-exact
    gates = torch.from_numpy(gates).bfloat16()
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)
    tbf = lambda t: t.bfloat16() if t.is_floating_point() else t
    p_j16 = jax.tree_util.tree_map(jbf, p_j)
    p_t16 = {k: (tbf(v) if isinstance(v, torch.Tensor) else
                 {kk: tbf(vv) for kk, vv in v.items()}) for k, v in p_t.items()}
    out = {}
    for name, fn in (("gshard", "_apply_gshard"), ("dropless", "_apply_dropless")):
        args32 = (jnp.asarray(x), jnp.asarray(gates.float().numpy()), jnp.asarray(idx))
        args16 = (jbf(x), jbf(gates.float().numpy()), jnp.asarray(idx))
        out[f"ref {name} f32"] = np.asarray(getattr(MJ, fn)(p_j, *args32, cfg_j))
        out[f"ref {name} bf16"] = np.asarray(
            getattr(MJ, fn)(p_j16, *args16, cfg_j).astype(jnp.float32))
        t = (torch.from_numpy(x), gates.float(), torch.from_numpy(idx))
        out[f"port {name} f32"] = getattr(MT, fn)(p_t, *t, cfg_t).numpy()
        out[f"port {name} bf16"] = getattr(MT, fn)(
            p_t16, t[0].bfloat16(), gates, t[2], cfg_t).float().numpy()
    f32 = out["ref dropless f32"]
    scale = max(1.0, float(np.abs(f32).max()))
    d = {k: float(np.abs(v - f32).max()) for k, v in out.items()}
    print(f"gshard bf16 witness arch={arch} scale={scale:.4f} max_abs_from_ref_dropless_f32="
          + ", ".join(f"{k}: {v:.3e}" for k, v in d.items()))
    for k in ("ref gshard f32", "port gshard f32", "port dropless f32"):
        assert d[k] <= GSHARD_F32_TOL * scale, (k, d[k])
    assert d["port gshard bf16"] <= GSHARD_BF16_TOL * scale
    assert float(np.abs(out["port gshard bf16"] - out["ref gshard bf16"]).max()) <= \
        GSHARD_BF16_TOL * scale
    assert d["port gshard bf16"] <= 2 * max(d["ref gshard bf16"], d["port dropless bf16"])
