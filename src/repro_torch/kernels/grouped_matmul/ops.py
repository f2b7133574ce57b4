"""Dispatch wrapper for the grouped matmul.  It routes by device only:
the kernel on a CUDA tensor, its plain version on a CPU tensor.  The
reference's ``jax.lax.ragged_dot`` takes no ``impl``, and neither does
this."""
from __future__ import annotations

from repro_torch.kernels.grouped_matmul.kernel import grouped_matmul_fwd


def grouped_matmul(x, w, offsets):
    """x (T, K) sorted by group, w (E, K, N), offsets (E + 1,) int32 ->
    (T, N): ``y[i] = x[i] @ w[e]`` for the rows of group ``e``."""
    return grouped_matmul_fwd(x, w, offsets)
