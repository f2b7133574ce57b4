"""Dispatch wrappers for the MoE layer's expert path.  They route by
device only: the kernel on a CUDA tensor, its plain version on a CPU
tensor.  The reference's ``jax.lax.ragged_dot`` takes no ``impl``, and
neither do these."""
from __future__ import annotations

from repro_torch.kernels.grouped_matmul.kernel import (combine_fwd, grouped_gate_up_fwd,
                                                       grouped_matmul_fwd)


def grouped_matmul(x, w, offsets, scale=None):
    """x (T, K) sorted by group, w (E, K, N), offsets (E + 1,) int32 ->
    (T, N): ``y[i] = x[i] @ w[e]`` for the rows of group ``e``, times
    ``scale[i]`` when given."""
    return grouped_matmul_fwd(x, w, offsets, scale)


def grouped_gate_up(x, rows, w_gate, w_up, offsets, act: str):
    """``act(x[rows] @ w_gate[e]) * (x[rows] @ w_up[e])`` over the sorted
    rows of each group ``e`` -> (len(rows), N)."""
    return grouped_gate_up_fwd(x, rows, w_gate, w_up, offsets, act)


def combine(ys, order, k: int):
    """Each token's ``k`` sorted rows of ``ys`` summed in ascending expert
    id -> (len(ys) / k, D)."""
    return combine_fwd(ys, order, k)
