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
"""
from __future__ import annotations

import torch

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


def qdense(x: torch.Tensor, w, dt=None, *, impl: str = "flash"):
    """Dense projection that takes an fp weight or a QuantTensor."""
    if isinstance(w, QuantTensor):
        return quant_matmul(x, w, impl=impl)
    return x @ w.to(dt if dt is not None else x.dtype)
