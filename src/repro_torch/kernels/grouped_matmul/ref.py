"""Plain-PyTorch version of the grouped matmul (the port's counterpart of
``jax.lax.ragged_dot`` as the reference's dropless MoE layer calls it:
``repro/models/moe.py::_apply_dropless``).

Rows are sorted by group: row ``i`` of ``x`` belongs to group ``e`` when
``offsets[e] <= i < offsets[e + 1]``, and ``y[i] = x[i] @ w[e]``.  The
offsets stay on the device and nothing here reads them back: each group's
product is computed over every row and kept where the row is the group's,
so the function runs inside the engine's captured decode step (and under
the CPU tests' host-read guard) like the kernel it stands beside.
"""
from __future__ import annotations

import torch


def group_ids(offsets, T: int):
    """The group of each of ``T`` rows, (T,) int: ``e`` for rows in
    ``[offsets[e], offsets[e + 1])``, ``E`` for rows past ``offsets[E]``."""
    rows = torch.arange(T, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets, rows, right=True) - 1


def grouped_matmul_ref(x, w, offsets):
    """x (T, K) sorted by group, w (E, K, N), offsets (E + 1,) int32 ->
    y (T, N) in x's dtype: f32 products and sums, one rounding.  Rows past
    ``offsets[E]`` give zeros."""
    T, E = x.shape[0], w.shape[0]
    gid = group_ids(offsets, T)[:, None]
    xf = x.float()
    y = torch.zeros((T, w.shape[2]), dtype=torch.float32, device=x.device)
    for e in range(E):
        y = torch.where(gid == e, xf @ w[e].float(), y)
    return y.to(x.dtype)
