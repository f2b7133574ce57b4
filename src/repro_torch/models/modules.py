"""Shared building blocks: rmsnorm, activations, RoPE, the dense MLP
(gated or plain) and the init helpers (counterpart of the reference's
``models/modules.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant.ops import qdense

# ---------------------------------------------------------------------------
# init helpers — the reference's distributions: truncated normal on
# [-2, 2] scaled by 1/sqrt(fan_in) (dense) or by 0.02 (embeddings).  A
# stacked (repeats, K, N) weight draws each layer from the same law.
# ---------------------------------------------------------------------------

def _trunc_normal(shape, generator, std):
    """Drawn on the generator's device; with no generator, a shape-only
    tensor on the meta device."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std)


def dense_init(generator, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[-2]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return _trunc_normal(shape, generator, std).to(device=device, dtype=dtype)


def embed_init(generator, shape, dtype, device):
    return _trunc_normal(shape, generator, 0.02).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# norms (always computed in f32)
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    """``scale`` stores (scale - 1), as the reference does."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def init_norm(shape, device):
    return {"scale": torch.zeros(shape, dtype=torch.float32, device=device)}  # scale - 1


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions, dim: int, theta: float):
    """positions (...,) int -> cos/sin of shape (..., dim//2), f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = theta ** -exps
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    cos, sin = rope_angles(positions, hd, theta)   # (B, S, hd/2)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN): gated (act(x W_gate) * x W_up) or plain (act(x W_up))
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg, *, repeats, dtype, device):
    """The reference creates these in f32 and casts them at use; the port
    stores them in the compute dtype — the same numbers at half the memory."""
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.glu:
        p["w_gate"] = dense_init(generator, (repeats, d, f), dtype, device)
    p["w_up"] = dense_init(generator, (repeats, d, f), dtype, device)
    p["w_down"] = dense_init(generator, (repeats, f, d), dtype, device, fan_in=f)
    return p


def apply_mlp(p, x, cfg, impl: str = "flash"):
    """Each projection through ``qdense``: fp or a quantised weight."""
    act = activation(cfg.act)
    dt = x.dtype
    if cfg.glu:
        h = act(qdense(x, p["w_gate"], dt, impl=impl)) * qdense(x, p["w_up"], dt, impl=impl)
    else:
        h = act(qdense(x, p["w_up"], dt, impl=impl))
    return qdense(h, p["w_down"], dt, impl=impl)
