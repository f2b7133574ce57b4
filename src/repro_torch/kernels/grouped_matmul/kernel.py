"""Grouped matmul over rows sorted by group, the port's own kernel for
the dropless MoE layer's three expert products (``jax.lax.ragged_dot`` in
the reference, an XLA op, not a Pallas kernel).

:func:`grouped_matmul_fwd` is the wrapper of the CUDA kernels in
``kernels/csrc/grouped_matmul.cu`` (the note there says what bounds them
and how they are laid out).  On a CUDA tensor it launches a kernel or
raises; on a CPU tensor it runs :func:`grouped_matmul_plain`, the plain
PyTorch version (f32 products and sums, one rounding).  The group offsets
stay on the device: a launch reads nothing back, so the engine's captured
decode step holds it.

The source has two designs, tensor cores (bf16 with K and N multiples of
8 and 16-byte aligned rows) and CUDA cores (f32, or bf16 otherwise):
:func:`plan` picks one, and :data:`kernel_launches` counts the launches of
each (design, dtype).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.common import DTYPE_CODES
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P,) * 4 + (_I,) * 3 + (_L,) + (_I,) * 2 + (_P,)
DESIGNS = ("cuda_core", "tensor_core")   # by the code grouped_matmul.cu reads

Kernel = collections.namedtuple("Kernel", "design dtype")

# launches of each Kernel
kernel_launches: collections.Counter = collections.Counter()

# the plain version: f32 products and sums, one rounding
grouped_matmul_plain = grouped_matmul_ref


def plan(x, w, y) -> str:
    """The design a call runs: tensor cores for bf16 with K and N
    multiples of 8, 16-byte aligned operands and an x row stride that is a
    multiple of 8, else CUDA cores."""
    K, N = w.shape[1], w.shape[2]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, y)) and x.stride(0) % 8 == 0
    if x.dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned:
        return "tensor_core"
    return "cuda_core"


def _check(x, w, offsets):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] \
            or tuple(offsets.shape) != (w.shape[0] + 1,):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and offsets "
                         f"{tuple(offsets.shape)} must be (T, K), (E, K, N) and (E + 1,)")
    if offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be int32, got {offsets.dtype}")


def grouped_matmul_fwd(x, w, offsets):
    """y[i] = x[i] @ w[e] for the rows ``[offsets[e], offsets[e + 1])`` of
    group ``e``: x (T, K) sorted by group, w (E, K, N), offsets (E + 1,)
    int32, nondecreasing, ``offsets[0] = 0`` and ``offsets[E] = T`` (every
    row in a group: the kernel writes no other) -> (T, N) in x's dtype."""
    _check(x, w, offsets)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"the grouped matmul runs on CUDA or CPU tensors, got {x.device}")
    for t in (w, offsets):
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x and w must share a dtype in {list(DTYPE_CODES)}, got "
                         f"{x.dtype}/{w.dtype}")
    if x.stride(-1) != 1 or not w.is_contiguous() or not offsets.is_contiguous():
        raise ValueError("x needs a contiguous last dim; w and offsets must be contiguous")
    T, (E, K, N) = x.shape[0], w.shape
    y = torch.empty((T, N), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    design = plan(x, w, y)
    fn = build.bind("grouped_matmul", "repro_grouped_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), y.data_ptr(), E, K, N,
             x.stride(0), DTYPE_CODES[x.dtype], DESIGNS.index(design),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"grouped matmul kernel launch failed: cudaError {err}")
    kernel_launches[Kernel(design, str(x.dtype))] += 1
    grouped_matmul_fwd.launches += 1
    return y


grouped_matmul_fwd.launches = 0
