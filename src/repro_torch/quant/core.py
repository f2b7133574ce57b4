"""Quantisation plane: int8 / packed-int4 weights and quantised KV rows
(counterpart of the reference's ``quant/core.py``).

- **weights** — weight-only symmetric quantisation to int8 or packed int4
  with per-output-channel scales (optionally per ``group`` rows of the
  contraction dim), held as a :class:`QuantTensor`;
- **KV rows** — per-(token, head) symmetric scales, quantised when a row is
  committed to the slot pool and dequantised on read;
- **crossbar tiles** — :func:`quantize_weights`, the 128×128
  per-crossbar-tile int8 quantiser of the PIM-MVM kernel.

The arithmetic follows the reference op for op — a division by the
expanded scale (never a multiply by its reciprocal), round half to even,
clip, the ``1e-12`` scale floor — so codes and scales come out bit-exact
on the same f32 input.

Packed int4 stores two codes per int8 byte as *adjacent pairs* along the
packing axis: code ``2i`` in the low nibble, ``2i+1`` in the high nibble.
"""
from __future__ import annotations

import dataclasses

import torch

XBAR = 128          # crossbar dimension (pim_mvm contract)
QMAX = {8: 127, 4: 7}
WEIGHT_BITS = (0, 4, 8)   # 0 = native fp
KV_BITS = (0, 4, 8)

# parameter keys eligible for weight-only quantisation: the dense
# projection matmuls.  Norms, biases and embeddings stay fp.
QUANT_PARAM_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"})


# ---------------------------------------------------------------------------
# int4 packing
# ---------------------------------------------------------------------------

def pack_int4(codes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int4 codes (int8 values in [-8, 7]) two per byte along ``axis``
    as adjacent pairs: byte ``i`` holds code ``2i`` (low nibble) and code
    ``2i+1`` (high nibble).  The axis length must be even."""
    c = codes.movedim(axis, -1)
    if c.shape[-1] % 2:
        raise ValueError(f"pack axis length {c.shape[-1]} must be even")
    lo, hi = c[..., 0::2], c[..., 1::2]
    packed = (lo & 0x0F) | (hi << 4)
    return packed.to(torch.int8).movedim(-1, axis)


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: sign-extending nibble unpack."""
    p = packed.movedim(axis, -1)
    lo = (p << 4) >> 4                                  # arithmetic: sign-ext
    hi = p >> 4
    c = torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (p.shape[-1] * 2,))
    return c.to(torch.int8).movedim(-1, axis)


# ---------------------------------------------------------------------------
# weight-only quantisation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantTensor:
    """A quantised (..., K, N) weight matrix.

    ``q``     — int8 codes; for ``bits=4`` two codes per byte packed along
                the contraction axis (shape (..., K/2, N));
    ``scale`` — f32 scales, (..., 1, N) per channel or (..., K/group, N);
    ``bits``  — 8 or 4;
    ``group`` — rows of K per scale group (0 = one scale per column).
    """
    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    group: int = 0

    @property
    def k_dim(self) -> int:
        """Original contraction length K (codes are packed for int4)."""
        return self.q.shape[-2] * (2 if self.bits == 4 else 1)

    def __getitem__(self, r) -> "QuantTensor":
        """Codes and scales of repeat ``r`` of a stacked weight, together."""
        return QuantTensor(self.q[r], self.scale[r], self.bits, self.group)


def quantize(w: torch.Tensor, bits: int = 8, *, group: int = 0) -> QuantTensor:
    """Symmetric weight-only quantisation of a (..., K, N) matrix.

    One scale per output channel (column of N), or per ``group`` rows of K
    per channel when ``group`` divides K.  ``bits=4`` packs the codes along
    K (which must be even)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    K = w.shape[-2]
    if group and K % group:
        raise ValueError(f"group {group} must divide K {K}")
    if bits == 4 and K % 2:
        raise ValueError(f"int4 packing needs even K, got {K}")
    qmax = QMAX[bits]
    wf = w.float()
    if group:
        g = wf.reshape(wf.shape[:-2] + (K // group, group, wf.shape[-1]))
        scale = g.abs().amax(dim=-2) / qmax                  # (..., K/g, N)
        scale = torch.clamp_min(scale, 1e-12)
        expand = scale.repeat_interleave(group, dim=-2)
    else:
        scale = wf.abs().amax(dim=-2, keepdim=True) / qmax
        scale = torch.clamp_min(scale, 1e-12)                # (..., 1, N)
        expand = scale
    codes = torch.clamp(torch.round(wf / expand), -qmax, qmax).to(torch.int8)
    if bits == 4:
        codes = pack_int4(codes, axis=-2)
    return QuantTensor(codes, scale, bits=bits, group=group)


def dequantize(qt: QuantTensor) -> torch.Tensor:
    """(..., K, N) f32 reconstruction of a :class:`QuantTensor`."""
    codes = unpack_int4(qt.q, axis=-2) if qt.bits == 4 else qt.q
    scale = qt.scale.repeat_interleave(qt.group, dim=-2) if qt.group else qt.scale
    return codes.float() * scale


def _quantize_leaf(name, leaf, bits, group):
    """The reference's eligibility rule for one leaf: a floating 2-D or
    stacked 3-D projection weight whose K suits ``bits``/``group``."""
    if name not in QUANT_PARAM_KEYS or not isinstance(leaf, torch.Tensor) \
            or leaf.dim() not in (2, 3) or not leaf.is_floating_point():
        return leaf
    K = leaf.shape[-2]
    g = group if (group and K % group == 0) else 0
    if bits == 4 and K % 2:
        return leaf
    return quantize(leaf, bits, group=g)


def _map_tree(fn, tree, name=""):
    """``fn(key, leaf)`` over the leaves of a nested dict/list tree, where
    ``key`` is the dict key the leaf sits under; the same nesting comes
    back as plain dicts and lists.  The port's parameter module nests the
    same way (its dicts have ``items()``, its lists iterate) and walks as
    its tree does."""
    if hasattr(tree, "items"):
        return {k: _map_tree(fn, t, k) for k, t in tree.items()}
    if isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        return [_map_tree(fn, t, name) for t in tree]
    return fn(name, tree)


def quantize_params(params, bits: int, *, group: int = 0):
    """Weight-only quantisation of a parameter tree (nested dicts and
    lists, or the parameter module built from one).

    Returns the tree with every dense projection leaf
    (``QUANT_PARAM_KEYS``) as a :class:`QuantTensor` and everything else
    shared with ``params`` untouched; ``Transformer(cfg, tree)`` holds it.
    Leaves whose contraction dim does not suit ``bits``/``group`` (odd K
    at int4, a K that ``group`` does not divide) stay fp, as in the
    reference."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    with torch.no_grad():
        return _map_tree(lambda k, leaf: _quantize_leaf(k, leaf, bits, group), params)


def fake_quantize_params(params, bits: int, *, group: int = 0):
    """Quantise-dequantise round trip of :func:`quantize_params`: the tree
    of the same weights the quantised path computes with, as f32 leaves."""
    return _map_tree(lambda _, leaf: dequantize(leaf) if isinstance(leaf, QuantTensor)
                     else leaf, quantize_params(params, bits, group=group))


# ---------------------------------------------------------------------------
# crossbar-tile quantisation (PIM-MVM contract)
# ---------------------------------------------------------------------------

def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> (int8 values, (K/128, N/128) f32 per-tile scales).

    Symmetric per-crossbar-tile quantisation: each 128×128 tile gets one
    scale = max|w|/127, the granularity a bit-sliced crossbar imposes."""
    K, N = w.shape
    if K % XBAR or N % XBAR:
        raise ValueError(f"weights {(K, N)} must tile {XBAR}x{XBAR} crossbars")
    t = w.float().reshape(K // XBAR, XBAR, N // XBAR, XBAR)
    t = t.permute(0, 2, 1, 3)                        # (Kt, Nt, 128, 128)
    scales = t.abs().amax(dim=(2, 3)) / 127.0
    scales = torch.clamp_min(scales, 1e-12)
    q = torch.round(t / scales[:, :, None, None]).to(torch.int8)
    q = q.permute(0, 2, 1, 3).reshape(K, N)
    return q, scales


# ---------------------------------------------------------------------------
# KV-row quantisation (slot-pool caches)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantise KV rows (..., hd) with one symmetric scale per row.  Returns
    ``(codes, scale)``: codes (..., hd) int8, packed to (..., hd/2) for
    ``bits=4``; all-zero rows get the floor scale and zero codes, so
    dequantisation reproduces exact zeros."""
    if bits not in (4, 8):
        raise ValueError(f"kv bits must be 4 or 8, got {bits}")
    qmax = QMAX[bits]
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / qmax, 1e-12)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
    codes = codes.to(torch.int8)
    if bits == 4:
        codes = pack_int4(codes, axis=-1)
    return codes, scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: (..., hd) f32."""
    c = unpack_int4(codes, axis=-1) if bits == 4 else codes
    return c.float() * scale[..., None]


def quantize_kv_cache(cache: dict, bits: int) -> dict:
    """Quantise a freshly prefilled fp KV cache ``{"k", "v", "pos"}`` into
    the quantised slot-pool layout ``{"k_q", "k_s", "v_q", "v_s", "pos"}``."""
    k_q, k_s = quantize_kv(cache["k"], bits)
    v_q, v_s = quantize_kv(cache["v"], bits)
    return {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s, "pos": cache["pos"]}


def kv_cache_bits(cache: dict, head_dim: int) -> int:
    """Bit width of a quantised slot-pool cache, from the packed head dim
    (int4 halves it)."""
    return 4 if cache["k_q"].shape[-1] != head_dim else 8
