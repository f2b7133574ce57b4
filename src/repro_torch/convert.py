"""Carry the reference's parameters over to the port.

:func:`params_from_jax` takes the reference's parameter tree
(``repro.models.transformer.init_params``) already turned into numpy
arrays by the caller (``jax.device_get``), so this module imports no JAX.
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

# leaves that stay f32 (cast at use): biases and (scale - 1) norm vectors
_F32_LEAVES = ("bq", "bk", "bv", "scale")


def _convert(tree, name, device, dtype):
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
    Raises if the tree's names or shapes differ from the port's own."""
    device = resolve_device(device)
    params = Transformer(cfg, _convert(tree, "", device, dtype))
    want = {n: tuple(p.shape) for n, p in
            init_params(cfg, None, device="meta", dtype=dtype).named_parameters()}
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    if got != want:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"extra {sorted(set(got) - set(want))}, shapes "
                         f"{[(n, got[n], want[n]) for n in want if n in got and got[n] != want[n]]}")
    return params
