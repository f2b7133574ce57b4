"""Plain-PyTorch versions of the MoE layer's expert path: the grouped
matmul (the port's counterpart of ``jax.lax.ragged_dot`` as the
reference's dropless MoE layer calls it:
``repro/models/moe.py::_apply_dropless``), the fused gate/up product and
the combine.

Rows are sorted by group: row ``i`` of ``x`` belongs to group ``e`` when
``offsets[e] <= i < offsets[e + 1]``, and ``y[i] = x[i] @ w[e]``.  The
offsets stay on the device and nothing here reads them back: each group's
product is computed over every row and kept where the row is the group's,
so the functions run inside the engine's captured decode step (and under
the CPU tests' host-read guard) like the kernels they stand beside.  Each
composes the torch ops of the chain its kernel replaces, in that chain's
order, so its bits are the chain's.
"""
from __future__ import annotations

import torch


def group_ids(offsets, T: int):
    """The group of each of ``T`` rows, (T,) int: ``e`` for rows in
    ``[offsets[e], offsets[e + 1])``, ``E`` for rows past ``offsets[E]``."""
    rows = torch.arange(T, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets, rows, right=True) - 1


def grouped_matmul_ref(x, w, offsets, scale=None):
    """x (T, K) sorted by group, w (E, K, N), offsets (E + 1,) int32 ->
    y (T, N) in x's dtype: f32 products and sums, one rounding; with
    ``scale`` (T,) each row then times its scale, rounded again.  Rows past
    ``offsets[E]`` give zeros."""
    T, E = x.shape[0], w.shape[0]
    gid = group_ids(offsets, T)[:, None]
    xf = x.float()
    y = torch.zeros((T, w.shape[2]), dtype=torch.float32, device=x.device)
    for e in range(E):
        y = torch.where(gid == e, xf @ w[e].float(), y)
    y = y.to(x.dtype)
    return y if scale is None else y * scale[:, None]


def grouped_gate_up_ref(x, rows, w_gate, w_up, offsets, act: str):
    """``act(x[rows] @ w_gate[e]) * (x[rows] @ w_up[e])`` over the sorted
    rows: x (T_tok, K), rows (T,) the token of each sorted row, the banks
    (E, K, N) -> (T, N), each product rounded to x's dtype first, then the
    activation (``models/modules.py::activation``), then the multiply."""
    from repro_torch.models.modules import activation   # models imports this module
    xs = x[rows]
    return activation(act)(grouped_matmul_ref(xs, w_gate, offsets)) * \
        grouped_matmul_ref(xs, w_up, offsets)


def combine_ref(ys, order, k: int):
    """Each token's ``k`` rows of ``ys`` (T * k, D), sorted by expert, summed
    in ascending expert id, rounding to ys's dtype after each add: the
    order in which the reference's scatter-add over the stably sorted
    pairs sums them.  ``order`` (T * k,) is the sort: sorted row ``i``
    holds pair ``order[i]`` = token * k + j."""
    # each pair's place in the sorted rows; a token's k places, ascending,
    # are its experts in ascending id
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), dtype=order.dtype, device=order.device))
    places = torch.sort(inv.reshape(-1, k), dim=1).values
    y = ys[places[:, 0]]
    for j in range(1, k):
        y = y + ys[places[:, j]]
    return y
