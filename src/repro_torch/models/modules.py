"""Shared building blocks: norms (RMSNorm, LayerNorm), activations, RoPE,
the dense MLP (gated or plain, with or without biases) and the init
helpers (counterpart of the reference's ``models/modules.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.api import constrain
from repro_torch.quant.ops import qdense

# ---------------------------------------------------------------------------
# init helpers — the reference's distributions: truncated normal on
# [-2, 2] scaled by 1/sqrt(fan_in) (dense) or by 0.02 (embeddings).  A
# stacked (repeats, ...) weight draws each layer from the same law.
# ---------------------------------------------------------------------------

# a leaf with more elements is drawn one repeat at a time (see _trunc_normal)
WHOLE_DRAW_MAX = 2 ** 31


def _trunc_normal(shape, generator, std, dtype, device):
    """Drawn in f32 on the generator's device, stored in ``dtype`` on
    ``device``; with no generator, a shape-only tensor on the meta device.

    A leaf of at most ``WHOLE_DRAW_MAX`` elements is drawn whole.  A larger
    one (a stacked expert bank: 48 x 128 x 2048 x 768 at qwen3-moe-30b-a3b,
    38.7 GB of f32) is drawn one repeat at a time into the ``dtype`` tensor,
    so that no f32 temporary holds more than one repeat.  Every leaf of the
    dense models is below the limit, so their draws are the whole-leaf
    draws they always were."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")

    def draw(s):
        t = torch.empty(s, dtype=torch.float32, device=generator.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.mul_(std).to(device=device, dtype=dtype)

    if math.prod(shape) <= WHOLE_DRAW_MAX:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    for r in range(shape[0]):
        out[r] = draw(shape[1:])
    return out


def dense_init(generator, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[-2]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return _trunc_normal(shape, generator, std, dtype, device)


def embed_init(generator, shape, dtype, device):
    return _trunc_normal(shape, generator, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms (always computed in f32)
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    """``scale`` stores (scale - 1), as the reference does."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def init_norm(cfg, shape, device):
    """LayerNorm stores its scale (ones) and a bias; RMSNorm stores
    (scale - 1)."""
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, **f32), "bias": torch.zeros(shape, **f32)}
    return {"scale": torch.zeros(shape, **f32)}


def apply_norm(p, x):
    if "bias" in p:
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


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


def sinusoidal_positions(positions, dim: int):
    """Absolute sinusoidal embedding (..., dim) f32, the reference's stub
    for a stack without RoPE and without a position table (mamba2)."""
    half = dim // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * (math.log(10_000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (dense FFN): gated (act(x W_gate) * x W_up) or plain (act(x W_up))
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg, *, repeats, dtype, device):
    """The reference creates the weights in f32 and casts them at use; the
    port stores them in the compute dtype — the same numbers at half the
    memory.  With ``mlp_bias``, biases ``b_up`` and ``b_down`` (f32 zeros,
    cast at use)."""
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.glu:
        p["w_gate"] = dense_init(generator, (repeats, d, f), dtype, device)
    p["w_up"] = dense_init(generator, (repeats, d, f), dtype, device)
    p["w_down"] = dense_init(generator, (repeats, f, d), dtype, device, fan_in=f)
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros((repeats, f), dtype=torch.float32, device=device)
        p["b_down"] = torch.zeros((repeats, d), dtype=torch.float32, device=device)
    return p


def apply_mlp(p, x, cfg, impl: str = "flash"):
    """Each projection through ``qdense``: fp or a quantised weight.  The
    plain MLP adds ``b_up`` before the activation; ``b_down`` follows the
    down projection."""
    act = activation(cfg.act)
    dt = x.dtype
    if cfg.glu:
        h = act(qdense(x, p["w_gate"], dt, impl=impl)) * qdense(x, p["w_up"], dt, impl=impl)
    else:
        h = qdense(x, p["w_up"], dt, impl=impl)
        if "b_up" in p:
            h = h + p["b_up"].to(dt)
        h = act(h)
    h = constrain(h, "act_ff")
    y = qdense(h, p["w_down"], dt, impl=impl)
    if "b_down" in p:
        y = y + p["b_down"].to(dt)
    return y
