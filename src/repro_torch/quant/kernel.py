"""Fused dequantise-matmul over weight-only quantised matrices (counterpart
of the reference's ``quant/kernel.py::quant_matmul_pallas``).

:func:`quant_matmul_fwd` is the wrapper of the CUDA kernels in
``kernels/csrc/qmatmul.cu`` (the note there says what bounds them and how
they are laid out).  On a CUDA tensor it launches a kernel or raises; on a
CPU tensor it runs :func:`quant_matmul_plain`, the plain PyTorch version
with the same numerics: weights dequantised in f32, f32 products and
sums, one rounding to x's dtype.  Unlike the TPU kernel, the CUDA kernels
mask ragged edges, so every shape runs them.

The source has two designs, tensor cores (bf16 x) and CUDA cores (f32 x,
or a group that is not a multiple of 16).  :func:`plan` asks the source
which one a call takes, with its tile and K split, and
:data:`kernel_launches` counts the launches of each of its kernels.

:func:`launch_dequant_matmul` is shared with the crossbar wrapper
(:mod:`repro_torch.kernels.pim_mvm.kernel`): both TPU kernels are one
CUDA source whose scale layout is a parameter.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.common import DTYPE_CODES
from repro_torch.kernels.scratch import sm_count, split_tickets
from repro_torch.quant.core import QuantTensor, dequantize

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P,) * 6 + (_I,) * 3 + (_L,) + (_I,) * 5 + (_P,)
DESIGNS = ("cuda_core", "tensor_core")   # by the code qmatmul.cu's plan reports

Plan = collections.namedtuple("Plan", "design bm bn bk k_split splits tiles")
# one kernel of qmatmul.cu: its design and tile rows, the code bits, the
# scale layout ("channel", "group" or "tile"), x's dtype, and whether K is
# split (the same-launch reduction runs)
Kernel = collections.namedtuple("Kernel", "design bm bits scales dtype split")

# launches of each Kernel, through either wrapper
kernel_launches: collections.Counter = collections.Counter()


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


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, *, bits: int, group_rows: int, tile: bool,
         dtype: torch.dtype, sms: int) -> Plan:
    """What ``qmatmul.cu`` runs for one call (``repro_dequant_matmul_plan``):
    its design (``DESIGNS``), tile, K step and K split, and the output
    tiles that the split's tickets count."""
    out = (_I * 7)()
    err = build.bind("qmatmul", "repro_dequant_matmul_plan", (_I,) * 8 + (_P,))(
        M, K, N, bits, group_rows, int(tile), DTYPE_CODES[dtype], sms, ctypes.addressof(out))
    if err:
        raise ValueError(f"dequant-matmul cannot run ({M}, {K}, {N}) at {bits} bits, "
                         f"group rows {group_rows}, tile {tile}: cudaError {err}")
    p = Plan(*out)
    return p._replace(design=DESIGNS[p.design])


def launch_dequant_matmul(x, q, scale, *, bits: int, group_rows: int, tile: bool):
    """Launch ``kernels/csrc/qmatmul.cu`` on checked CUDA operands:
    x (M, K) · dequant(q, scale) -> (M, N) in x's dtype."""
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    sms = sm_count(x.device)
    p = plan(M, K, N, bits=bits, group_rows=group_rows, tile=tile, dtype=x.dtype, sms=sms)
    stream = torch.cuda.current_stream(x.device)
    ws = tickets = None
    if p.splits > 1:
        ws = torch.empty((p.splits, M, N), dtype=torch.float32, device=x.device)
        tickets = split_tickets(x.device, stream, p.tiles)
    fn = build.bind("qmatmul", "repro_dequant_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(),
             None if tickets is None else tickets.data_ptr(), M, K, N, x.stride(0), bits,
             group_rows, int(tile), DTYPE_CODES[x.dtype], sms, stream.cuda_stream)
    if err:
        raise RuntimeError(f"dequant-matmul kernel launch failed: cudaError {err}")
    scales = "tile" if tile else "group" if group_rows < K else "channel"
    kernel_launches[Kernel(p.design, p.bm, bits, scales, str(x.dtype), p.splits > 1)] += 1
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
