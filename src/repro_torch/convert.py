"""Carry the reference's parameters over to the port.

:func:`params_from_jax` takes the reference's parameter tree
(``repro.models.transformer.init_params``, or that tree after the
reference's ``quantize_params``) already turned into numpy arrays by the
caller (``jax.device_get``), so this module imports no JAX.  A quantised
leaf of the reference is recognised by its ``q``/``scale``/``bits``/
``group`` attributes, and its code and scale planes are taken unchanged.
Weights and the embedding are stored in ``dtype``; biases and norm scales
stay f32 and are cast at use, as in the reference.  The reference keeps
its MLP weights in f32 whatever its ``param_dtype`` and casts them at use;
storing them in ``dtype`` gives the same numbers at half the memory.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.quant.core import QuantTensor, quantize_params

# leaves that stay f32 (cast at use): biases and (scale - 1) norm vectors,
# the per-head q/k norms among them
_F32_LEAVES = ("bq", "bk", "bv", "scale", "q_norm", "k_norm")


def _is_quant(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("q", "scale", "bits", "group"))


def _quant_leaves(tree):
    if isinstance(tree, dict):
        return [q for t in tree.values() for q in _quant_leaves(t)]
    if isinstance(tree, (list, tuple)):
        return [q for t in tree for q in _quant_leaves(t)]
    return [tree] if _is_quant(tree) else []


def _convert(tree, name, device, dtype):
    if _is_quant(tree):
        return QuantTensor(
            torch.from_numpy(np.array(tree.q, dtype=np.int8)).to(device),
            torch.from_numpy(np.array(tree.scale, dtype=np.float32)).to(device),
            int(tree.bits), int(tree.group))
    if isinstance(tree, dict):
        return {k: _convert(t, k, device, dtype) for k, t in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(t, name, device, dtype) for t in tree]
    arr = np.array(tree, dtype=np.float32)
    return torch.from_numpy(arr).to(
        device=device, dtype=torch.float32 if name in _F32_LEAVES else dtype)


def params_from_jax(tree, cfg: ModelConfig, device=None,
                    dtype=torch.bfloat16) -> Transformer:
    """The port's parameters holding the values of the reference's tree.
    Raises if the tree's names or shapes differ from the port's own (for a
    quantised tree: from what the port's ``quantize_params`` builds, code
    and scale buffers included)."""
    device = resolve_device(device)
    params = Transformer(cfg, _convert(tree, "", device, dtype))
    ref = init_params(cfg, None, device="meta", dtype=dtype)
    quant = _quant_leaves(tree)
    if quant:
        ref = Transformer(cfg, quantize_params(ref, int(quant[0].bits),
                                               group=max(int(q.group) for q in quant)))

    def shapes(m):
        return {n: tuple(t.shape) for n, t in
                (*m.named_parameters(), *m.named_buffers())}
    want, got = shapes(ref), shapes(params)
    if got != want:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"extra {sorted(set(got) - set(want))}, shapes "
                         f"{[(n, got[n], want[n]) for n in want if n in got and got[n] != want[n]]}")
    return params
