"""AdamW with decoupled weight decay, global-norm clipping and the
warmup-cosine schedule (counterpart of the reference's
``training/optimizer.py``).

Trees are nested dicts and lists of tensors (:mod:`repro_torch.tree`),
walked in the reference's leaf order.  The moments are f32 and the count
int32 whatever the parameters' dtype; the schedule, the clip and the bias
corrections are f32 device scalars, so a step reads nothing on the host.
A step is two calls: :func:`adamw_prepare` reads the gradients and
:func:`adamw_apply_` writes the state in place; :func:`adamw_update` is
the reference's functional step over fresh copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.parallel.api import full, is_dtensor
from repro_torch.tree import tree_leaves, tree_map

# the update works a leaf in pieces of at most this many elements along its
# leading axis, so that its f32 temporaries stay near 1 GB whatever the
# leaf (qwen2.5-3b's stacked w_up is 812 M elements)
UPDATE_PIECE = 2 ** 28


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a device scalar), in f32: a linear
    warmup, then a cosine from ``lr`` down to a tenth of it."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params) -> dict[str, Any]:
    """f32 zero moments shaped like ``params`` and an int32 zero count, on
    the parameters' device."""
    def zeros(p):
        if is_dtensor(p):                    # sharded like its parameter (ZeRO)
            return torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, the leaves summed in
    the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def adamw_prepare(grads, opt_state, cfg: OptConfig) -> dict[str, torch.Tensor]:
    """What a step reads before it writes (device scalars): the new count,
    the learning rate at it, the raw ``gnorm``, the clip's scale
    ``min(1, clip_norm / (gnorm + 1e-9))`` and the f32 bias corrections."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    return {"count": count, "lr": schedule(cfg, count), "gnorm": gnorm,
            "scale": torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0),
            "bc1": 1.0 - cfg.b1 ** count.float(), "bc2": 1.0 - cfg.b2 ** count.float()}


def _update_leaf(p, g, m, v, prep, cfg: OptConfig):
    """Writes one leaf's AdamW step into ``p``, ``m`` and ``v``, a piece at
    a time along the leading axis (the step is elementwise)."""
    b1, b2 = cfg.b1, cfg.b2
    pieces = max(1, -(-p.numel() // UPDATE_PIECE)) if p.dim() else 1
    for pp, gg, mm, vv in zip(*(torch.tensor_split(t, pieces) if p.dim() else (t,)
                                for t in (p, g, m, v))):
        gg = gg.float() * prep["scale"]
        mm.copy_(b1 * mm + (1 - b1) * gg)
        vv.copy_(b2 * vv + (1 - b2) * torch.square(gg))
        step = (mm / prep["bc1"]) / (torch.sqrt(vv / prep["bc2"]) + cfg.eps)
        step = step + cfg.weight_decay * pp.float()
        pp.copy_((pp.float() - prep["lr"] * step).to(pp.dtype))


def adamw_apply_(grads, opt_state, params, cfg: OptConfig, prep) -> dict[str, Any]:
    """Writes the step that :func:`adamw_prepare` read into ``params`` and
    the moments of ``opt_state`` (the trainer's way: one copy of the state
    on the card), leaf by leaf; returns the new optimizer state, whose
    count is ``prep``'s.  A fault partway leaves some leaves written.
    Sharded leaves (DTensors: a parameter, its gradient and its moments
    placed alike) are updated shard by shard, the step being elementwise."""
    with torch.no_grad():
        local = {k: full(v) for k, v in prep.items()}
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
            if is_dtensor(p):
                _update_leaf(*(t.to_local() for t in (p, g, m, v)), local, cfg)
            else:
                _update_leaf(p, g, m, v, prep, cfg)
    return {"m": opt_state["m"], "v": opt_state["v"], "count": prep["count"]}


def adamw_update(grads, opt_state, params, cfg: OptConfig):
    """One AdamW step as the reference's: (params', opt_state', {"gnorm",
    "lr"}) as new tensors, the inputs left as they were.

    The gradients are clipped to ``clip_norm`` (``gnorm`` reported raw),
    the moments updated in f32, the step bias-corrected in f32 and weight
    decay applied to every leaf.  The parameters keep their dtype and
    ``requires_grad``."""
    def fresh(t):
        return t.detach().clone().requires_grad_(t.requires_grad)
    prep = adamw_prepare(grads, opt_state, cfg)
    new_p = tree_map(fresh, params)
    new_o = adamw_apply_(grads, {"m": tree_map(fresh, opt_state["m"]),
                                 "v": tree_map(fresh, opt_state["v"])}, new_p, cfg, prep)
    return new_p, new_o, {"gnorm": prep["gnorm"], "lr": prep["lr"]}
