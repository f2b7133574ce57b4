"""Dispatch layer for quantised dense compute (counterpart of the
reference's ``quant/ops.py``).

``qdense`` is the one matmul entry point of the model's dense
projections: an fp weight runs exactly the pre-quantisation ``x @
w.to(dt)``; a :class:`~repro_torch.quant.core.QuantTensor` runs the fused
dequant-matmul.

Unlike the reference, whose ``qdense`` picks its own route (the Pallas
kernel on a TPU, dequantise-then-matmul elsewhere), the port threads the
model's ``impl`` through: ``impl="flash"`` is the card's path (the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor), and
``impl="ref"`` is the reference's fallback, ``x @ dequantize(qt)`` cast to
x's dtype — so a model run with ``impl="ref"`` is a full oracle run.

Under a plan (:mod:`repro_torch.parallel`) x and the weight are DTensors
and ``qdense`` runs through ``local_map``: each rank multiplies its own
shards, fp or through the dequant-matmul kernel, at placements chosen per
mesh dim from x's and the weight's (:func:`dense_placements`): a
column-sharded weight gives column-sharded outputs, a row-sharded one
partial sums (summed where a later op needs the whole value), and a
weight sharded on a mesh dim that x's batch or sequence already uses is
gathered there (the FSDP weight gather).  ``constraint`` names a role
whose presence in the plan gathers the weight whole (the reference's
``weight_full``, its prefill projections).
"""
from __future__ import annotations

import torch

from repro_torch.parallel.api import (current_plan, even, local_call, planned_mesh, replicated,
                                      to_placements)
from repro_torch.quant.core import QuantTensor, dequantize
from repro_torch.quant.kernel import quant_matmul_fwd


def quant_matmul(x: torch.Tensor, qt: QuantTensor, *, impl: str = "flash"):
    """x (..., K) · dequant(qt (K, N)) -> (..., N), dtype follows x."""
    if impl == "ref":
        return x @ dequantize(qt).to(x.dtype)
    if impl != "flash":
        raise ValueError(f"unknown quant_matmul impl {impl!r}")
    lead, K = x.shape[:-1], x.shape[-1]
    out = quant_matmul_fwd(x.reshape(-1, K).contiguous(), qt.q, qt.scale,
                           bits=qt.bits, group=qt.group)
    return out.reshape(lead + (out.shape[-1],))


def qdense(x: torch.Tensor, w, dt=None, constraint: str | None = None, *,
           impl: str = "flash"):
    """Dense projection that takes an fp weight or a QuantTensor."""
    planes = (w.q, w.scale) if isinstance(w, QuantTensor) else (w,)
    mesh = planned_mesh("qdense", x, *planes)
    if mesh is not None:
        return _planned(mesh, x, w, dt, constraint, impl)
    if isinstance(w, QuantTensor):
        return quant_matmul(x, w, impl=impl)
    return x @ w.to(dt if dt is not None else x.dtype)


def dense_placements(x_pl, w_pl, ndim: int, k_ok):
    """(x's, the weight's, the output's) placements of a planned ``x (...,
    K) @ W (K, N)``, per mesh dim from x's and W's own: x partial → summed
    first; x replicated: W's K shard slices x (partial output), its N
    shard shards the output's last dim; x sharded on a batch or sequence
    dim: W gathered, the output sharded as x; x sharded on K: W sliced to
    match (partial output) where ``k_ok(i)`` says its K rows split on mesh
    dim ``i``, else x gathered; x on K against W on N: x gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = ndim - 1
    R = Replicate()
    xs, ws, outs = [], [], []
    for i, (xp, wp) in enumerate(zip(x_pl, w_pl)):
        if xp.is_partial():
            xp = R
        if xp.is_shard() and xp.dim != last:           # batch / sequence
            xs.append(xp), ws.append(R), outs.append(Shard(xp.dim))
        elif xp.is_shard() and not wp.is_shard(1) and k_ok(i):   # x on K
            xs.append(xp), ws.append(Shard(0)), outs.append(Partial())
        elif wp.is_shard(0) and k_ok(i):               # W on K, x replicated
            xs.append(Shard(last)), ws.append(wp), outs.append(Partial())
        elif wp.is_shard(1):                            # W on N
            xs.append(R), ws.append(wp), outs.append(Shard(last))
        else:
            xs.append(R), ws.append(R), outs.append(R)
    return tuple(xs), tuple(ws), tuple(outs)


def dense_grad_placements(x_in, w_in, ndim: int) -> tuple:
    """How the local gradients of a planned dense product are placed: x's
    is a partial sum on a mesh dim where W's columns are split and x is
    whole, W's on one where x's rows are split and W is whole; else each
    as its input."""
    from torch.distributed.tensor import Partial
    xg = tuple(Partial() if xp.is_replicate() and wp.is_shard(1) else xp
               for xp, wp in zip(x_in, w_in))
    wg = tuple(Partial() if wp.is_replicate() and xp.is_shard() and xp.dim != ndim - 1
               else wp for xp, wp in zip(x_in, w_in))
    return xg, wg


def _planned(mesh, x, w, dt, constraint, impl):
    """:func:`qdense` on each rank's local shards (:func:`dense_placements`);
    a quantised weight's scales follow its codes (a per-channel scale row
    is never split)."""
    from torch.distributed.tensor import Replicate
    quant = isinstance(w, QuantTensor)
    x = replicated(x, mesh)
    x = to_placements(x, mesh, even(x.placements, x.shape, mesh))
    if quant:
        w = QuantTensor(replicated(w.q, mesh), replicated(w.scale, mesh), w.bits, w.group)
    else:
        w = replicated(w, mesh)
    plane = w.q if quant else w
    whole = constraint is not None and current_plan().spec(constraint) is not None
    w_pl = (Replicate(),) * mesh.ndim if whole else tuple(plane.placements)

    def k_ok(i):
        n = mesh.size(i)
        if not quant:
            return plane.shape[-2] % n == 0
        return w.q.shape[-2] % n == 0 and (w.scale.shape[-2] == 1
                                           or w.scale.shape[-2] % n == 0)
    x_in, w_in, out = dense_placements(x.placements, w_pl, x.dim(), k_ok)
    if not quant:
        def local(xl, wl):
            return xl @ wl.to(dt if dt is not None else xl.dtype)
        return local_call(local, (x, w), (x_in, w_in), out, mesh,
                          grad_placements=dense_grad_placements(x_in, w_in, x.dim()))
    s_in = tuple(Replicate() if p.is_shard(0) and w.scale.shape[-2] == 1 else p for p in w_in)

    def local_q(xl, ql, sl):
        return quant_matmul(xl, QuantTensor(ql, sl, w.bits, w.group), impl=impl)
    return local_call(local_q, (x, w.q, w.scale), (x_in, w_in, s_in), out, mesh)
