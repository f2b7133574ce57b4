"""Fused dequantise-matmul over weight-only quantised matrices (counterpart
of the reference's ``quant/kernel.py::quant_matmul_pallas``).

:func:`quant_matmul_fwd` is the wrapper of the CUDA kernel in
``kernels/csrc/qmatmul.cu`` (the note there says what bounds it and how it
is laid out).  On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs :func:`quant_matmul_plain`, the plain PyTorch version with
the same numerics: weights dequantised in f32, f32 products and sums, one
rounding to x's dtype.  Unlike the TPU kernel, the CUDA kernel masks
ragged edges, so every shape runs it.

:func:`launch_dequant_matmul` is shared with the crossbar wrapper
(:mod:`repro_torch.kernels.pim_mvm.kernel`): both TPU kernels are one
CUDA source whose scale layout is a parameter.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.common import DTYPE_CODES
from repro_torch.quant.core import QuantTensor, dequantize

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P,) * 5 + (_I,) * 3 + (_L,) + (_I,) * 6 + (_P,)


def quant_matmul_plain(x, q, scale, *, bits: int, group: int = 0):
    """The plain PyTorch version of the dequant-matmul kernel."""
    w = dequantize(QuantTensor(q, scale, bits, group))
    return (x.float() @ w).to(x.dtype)


def check_cuda_operands(x, q, scale):
    """Device, dtype and layout checks shared by the dequant-matmul
    wrappers."""
    if x.device.type != "cuda":
        raise ValueError(f"dequant-matmul kernels run on CUDA or CPU tensors, got {x.device}")
    for t in (q, scale):
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be one of {list(DTYPE_CODES)}, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"codes must be int8 and scales f32, got {q.dtype}/{scale.dtype}")
    if x.stride(-1) != 1 or not q.is_contiguous() or not scale.is_contiguous():
        raise ValueError("x needs a contiguous last dim; codes and scales must be contiguous")


def launch_dequant_matmul(x, q, scale, *, bits: int, group_rows: int, tile: bool):
    """Launch ``kernels/csrc/qmatmul.cu`` on checked CUDA operands:
    x (M, K) · dequant(q, scale) -> (M, N) in x's dtype."""
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    k_split = build.bind("qmatmul", "repro_dequant_matmul_k_split", (_I,) * 4)(M, K, N, sms)
    splits = math.ceil(K / k_split)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) \
        if splits > 1 else None
    fn = build.bind("qmatmul", "repro_dequant_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), M, K, N, x.stride(0), bits,
             group_rows, int(tile), k_split, splits, DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dequant-matmul kernel launch failed: cudaError {err}")
    return out


def quant_matmul_fwd(x, q, scale, *, bits: int, group: int = 0):
    """x (M, K) · dequant(q, scale) -> (M, N); output dtype follows x.

    ``q`` is (K, N) int8 or (K/2, N) packed int4; ``scale`` (1, N) f32 per
    channel or (K/group, N) per group."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    pack = 2 if bits == 4 else 1
    M, K = x.shape
    Kq, N = q.shape
    rows = K // group if group else 1
    if Kq * pack != K or tuple(scale.shape) != (rows, N) or (group and K % group):
        raise ValueError(f"codes {tuple(q.shape)} / scales {tuple(scale.shape)} do not "
                         f"match K={K} at {bits} bits, group {group}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, scale, bits=bits, group=group)
    check_cuda_operands(x, q, scale)
    out = launch_dequant_matmul(x, q, scale, bits=bits, group_rows=group or K,
                                tile=False)
    quant_matmul_fwd.launches += 1
    return out


quant_matmul_fwd.launches = 0
