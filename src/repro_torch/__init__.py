"""PyTorch + CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``src/repro/`` module by module.  It imports ``torch``
and never ``jax`` or ``repro``: the JAX package is the reference the port
is tested against, not a dependency.  Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"`` (see :func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card.  Without a card and without an explicit CPU request
    this raises — the port never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda")
