"""Gradient compression for the data-parallel all-reduce (counterpart of the
reference's ``training/compression.py``).

int8 block quantisation with **error feedback** (the residual carried to
the next step): each leaf, flattened and padded to blocks of ``BLOCK``
values, keeps one f32 scale a block (its largest magnitude / 127) and
int8 codes ``round(x / scale)``.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the codes and scales equal the reference's bit for
bit.  The round trip returns the dequantised values, what the receiving
side of the all-reduce would see, so a train step can be held end to end
on one device.  A sharded gradient (a DTensor) is coded shard by shard:
what each rank would send.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel.api import is_dtensor
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BLOCK = 256  # quantisation block (per-block scale -> 1/256 relative error)


def _quant_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf -> (int8 blocks (n_blocks, BLOCK), f32 scales (n_blocks, 1))."""
    flat = g.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # divided by a tensor: a card multiplies by the reciprocal of a Python
    # scalar divisor, which can land one bit off the reference's division
    scale = amax / amax.new_full((), 127.0)
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compress_decompress(grads: Any, err: Optional[Any] = None):
    """Quantise ``grads`` to int8 with error feedback: (grads', err').

    ``err`` is the residual tree of the previous step (None on the first).
    ``grads'`` are the dequantised values in each leaf's dtype, ``err'``
    the f32 residuals ``grads + err - grads'``."""
    def one(g, e):
        if is_dtensor(g):
            from torch.distributed.tensor import DTensor
            outs = one(g.to_local(), None if e is None else e.to_local())
            return tuple(DTensor.from_local(o, g.device_mesh, g.placements, run_check=False,
                                            shape=g.shape, stride=g.stride()) for o in outs)
        g32 = g.float()
        if e is not None:
            g32 = g32 + e
        q, scale = _quant_leaf(g32)
        deq = _dequant_leaf(q, scale, g32.shape)
        return deq.to(g.dtype), g32 - deq

    flat_e = [None] * len(tree_leaves(grads)) if err is None else tree_leaves(err)
    outs = [one(g, e) for g, e in zip(tree_leaves(grads), flat_e)]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def init_error(grads_shape: Any):
    """f32 zero residuals shaped like ``grads_shape``'s leaves (tensors),
    on their devices."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=torch.float32, device=s.device),
                    grads_shape)


def compressed_bytes(tree) -> int:
    """Wire footprint of the compressed representation (int8 + scales)."""
    total = 0
    for leaf in tree_leaves(tree):
        n = leaf.numel()
        blocks = -(-n // BLOCK)
        total += n + 4 * blocks
    return total
