"""The MoE layer's expert path over rows sorted by group: the grouped
matmul (the port's own kernel for ``jax.lax.ragged_dot`` in the
reference's dropless MoE layer, an XLA op, not a Pallas kernel), the fused
gate/up product and the combine.

Three wrappers of the CUDA kernels in ``kernels/csrc/grouped_matmul.cu``
(the note there says what bounds them and how they are laid out):

- :func:`grouped_matmul_fwd` ``(x, w, offsets, scale=None)``: the product,
  with an optional row scale (the gate) after its first rounding;
- :func:`grouped_gate_up_fwd` ``(x, rows, w_gate, w_up, offsets, act)``:
  ``act(x[rows] @ w_gate) * (x[rows] @ w_up)``, the rows gathered inside
  the kernel's loads;
- :func:`combine_fwd` ``(ys, order, k)``: each token's ``k`` rows summed in
  ascending expert id, the inverse permutation found in the kernel.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its plain version (``ref.py``: the torch ops of the chain it replaces,
in that order).  The group offsets stay on the device: a launch reads
nothing back, so the engine's captured decode step holds it.

The products have two designs, TMA-fed persistent blocks on tensor cores
and a CUDA-core loop: :func:`plan` picks one by the rule it returns with
it, and :data:`kernel_launches` counts the launches of each kernel
(:class:`Kernel`: op, design, dtype; the combine is op ``combine``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.common import DTYPE_CODES
from repro_torch.kernels.grouped_matmul.ref import (combine_ref, grouped_gate_up_ref,
                                                    grouped_matmul_ref)
from repro_torch.kernels.scratch import sm_count
from repro_torch.parallel.api import refuse_dtensor

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MATMUL_ARGTYPES = (_P,) * 7 + (_I,) * 3 + (_L,) + (_I,) * 5 + (_P,)
_COMBINE_ARGTYPES = (_P,) * 3 + (_I,) * 7 + (_P,)
# by the codes grouped_matmul.cu reads
DESIGNS = ("cuda_core", "tma")
OPS = ("product", "scaled", "gate_up")
ACTS = ("none", "silu", "gelu", "relu2")
TILE = 64                  # the TMA design's box: 64 K rows x 64 columns
TMA_MAX_EXPERTS = 512      # the work list's scan in shared memory
COMBINE_THREADS = 128

Kernel = collections.namedtuple("Kernel", "op design dtype")
Plan = collections.namedtuple("Plan", "design rule")

# launches of each Kernel
kernel_launches: collections.Counter = collections.Counter()

# the plain versions
grouped_matmul_plain = grouped_matmul_ref
grouped_gate_up_plain = grouped_gate_up_ref
combine_plain = combine_ref


def plan(x, w, y, *more) -> Plan:
    """The design a product runs, and the rule that sent it there: TMA for
    bf16 with K and N multiples of 8 (16-byte strides) and at least one
    64 x 64 box, at most 512 experts, x, the banks (``w`` and ``more``)
    and y 16-byte aligned and an x row stride that is a multiple of 8; CUDA
    cores for everything else."""
    E, K, N = w.shape
    if x.dtype != torch.bfloat16:
        return Plan("cuda_core", f"{x.dtype}: TMA takes bf16")
    if K % 8 or N % 8:
        return Plan("cuda_core", f"K {K} or N {N} not a multiple of 8")
    if K < TILE or N < TILE:
        return Plan("cuda_core", f"K {K} or N {N} below the {TILE} x {TILE} box")
    if E > TMA_MAX_EXPERTS:
        return Plan("cuda_core", f"{E} experts, above {TMA_MAX_EXPERTS}")
    if any(t.data_ptr() % 16 for t in (x, w, y, *more)) or x.stride(0) % 8:
        return Plan("cuda_core", "an operand not 16-byte aligned")
    return Plan("tma", "bf16, K and N multiples of 8 and >= 64, aligned")


def _check(x, w, offsets):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] \
            or tuple(offsets.shape) != (w.shape[0] + 1,):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and offsets "
                         f"{tuple(offsets.shape)} must be (T, K), (E, K, N) and (E + 1,)")
    if offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be int32, got {offsets.dtype}")


def _check_cuda(x, *others):
    if x.device.type != "cuda":
        raise ValueError(f"the grouped matmul runs on CUDA or CPU tensors, got {x.device}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"the dtype must be one of {list(DTYPE_CODES)}, got {x.dtype}")


def _launch(op, act, x, rows, w0, w1, offsets, scale, y, x_sm):
    E, K, N = w0.shape
    design = plan(x, w0, y, *(() if w1 is None else (w1,))).design
    fn = build.bind("grouped_matmul", "repro_grouped_matmul", _MATMUL_ARGTYPES)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = fn(x.data_ptr(), ptr(rows), w0.data_ptr(), ptr(w1), offsets.data_ptr(), ptr(scale),
             y.data_ptr(), E, K, N, x_sm, DTYPE_CODES[x.dtype], DESIGNS.index(design),
             OPS.index(op), ACTS.index(act), sm_count(x.device),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"grouped matmul kernel launch failed: cudaError {err}")
    kernel_launches[Kernel(op if op != "gate_up" else f"gate_up/{act}", design,
                           str(x.dtype))] += 1


def grouped_matmul_fwd(x, w, offsets, scale=None):
    """y[i] = x[i] @ w[e] for the rows ``[offsets[e], offsets[e + 1])`` of
    group ``e``: x (T, K) sorted by group, w (E, K, N), offsets (E + 1,)
    int32, nondecreasing, ``offsets[0] = 0`` and ``offsets[E] = T`` (every
    row in a group: the kernel writes no other) -> (T, N) in x's dtype.
    With ``scale`` (T,) in x's dtype, ``y[i] = round(round(y[i]) *
    scale[i])`` (the MoE layer's gate)."""
    refuse_dtensor("grouped_matmul_fwd", x, w, offsets, scale)
    _check(x, w, offsets)
    if scale is not None and (scale.dim() != 1 or scale.shape[0] != x.shape[0]):
        raise ValueError(f"scale {tuple(scale.shape)} must be ({x.shape[0]},)")
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, offsets, scale)
    _check_cuda(x, w, offsets, *(() if scale is None else (scale,)))
    if w.dtype != x.dtype or (scale is not None and scale.dtype != x.dtype):
        raise ValueError(f"x, w and scale must share a dtype, got {x.dtype}/{w.dtype}"
                         + ("" if scale is None else f"/{scale.dtype}"))
    if x.stride(-1) != 1 or not w.is_contiguous() or not offsets.is_contiguous() \
            or (scale is not None and not scale.is_contiguous()):
        raise ValueError("x needs a contiguous last dim; w, offsets and scale must be "
                         "contiguous")
    y = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    _launch("product" if scale is None else "scaled", "none", x, None, w, None, offsets,
            scale, y, x.stride(0))
    grouped_matmul_fwd.launches += 1
    return y


def grouped_gate_up_fwd(x, rows, w_gate, w_up, offsets, act: str):
    """h[i] = act(x[rows[i]] @ w_gate[e]) * (x[rows[i]] @ w_up[e]) for the
    sorted rows i of group ``e``: x (T_tok, K) by token, rows (T,) int64
    the token of each sorted row, w_gate and w_up (E, K, N), offsets as
    :func:`grouped_matmul_fwd`'s -> (T, N) in x's dtype.  Each product is
    rounded to x's dtype, the activation (``silu``, ``gelu`` with tanh,
    ``relu2``: ``models/modules.py::activation``) taken in f32 on the
    rounded gate and rounded, then the multiply rounded."""
    refuse_dtensor("grouped_gate_up_fwd", x, rows, w_gate, w_up, offsets)
    _check(x, w_gate, offsets)
    if tuple(w_up.shape) != tuple(w_gate.shape):
        raise ValueError(f"w_gate {tuple(w_gate.shape)} and w_up {tuple(w_up.shape)} differ")
    if rows.dim() != 1 or rows.dtype != torch.int64:
        raise ValueError(f"rows must be 1-D int64, got {tuple(rows.shape)} {rows.dtype}")
    if x.device.type == "cpu":
        return grouped_gate_up_plain(x, rows, w_gate, w_up, offsets, act)
    if act not in ACTS[1:]:
        raise ValueError(f"unknown activation {act!r}")
    _check_cuda(x, rows, w_gate, w_up, offsets)
    if w_gate.dtype != x.dtype or w_up.dtype != x.dtype:
        raise ValueError(f"x and the banks must share a dtype, got {x.dtype}/"
                         f"{w_gate.dtype}/{w_up.dtype}")
    if x.stride(-1) != 1 or not all(t.is_contiguous() for t in (rows, w_gate, w_up, offsets)):
        raise ValueError("x needs a contiguous last dim; rows, the banks and offsets "
                         "must be contiguous")
    y = torch.empty((rows.shape[0], w_gate.shape[2]), dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0:
        return y
    _launch("gate_up", act, x, rows, w_gate, w_up, offsets, None, y, x.stride(0))
    grouped_gate_up_fwd.launches += 1
    return y


def combine_fwd(ys, order, k: int):
    """out[t] = the ``k`` rows of token ``t`` in ``ys`` (T * k, D), sorted by
    expert, summed in ascending expert id and rounded to ys's dtype after
    each add; ``order`` (T * k,) int64 is the stable sort of the pairs
    (sorted row ``i`` holds pair ``order[i]`` = token * k + j) -> (T, D)."""
    refuse_dtensor("combine_fwd", ys, order)
    if ys.dim() != 2 or order.dim() != 1 or order.shape[0] != ys.shape[0] or k < 1 \
            or ys.shape[0] % k:
        raise ValueError(f"ys {tuple(ys.shape)} and order {tuple(order.shape)} must be "
                         f"(T * k, D) and (T * k,) with k = {k}")
    if order.dtype != torch.int64:
        raise ValueError(f"order must be int64, got {order.dtype}")
    if ys.device.type == "cpu":
        return combine_plain(ys, order, k)
    _check_cuda(ys, order)
    if not ys.is_contiguous() or not order.is_contiguous():
        raise ValueError("ys and order must be contiguous")
    n_tok, D = ys.shape[0] // k, ys.shape[1]
    out = torch.empty((n_tok, D), dtype=ys.dtype, device=ys.device)
    if n_tok == 0:
        return out
    per = 16 // ys.element_size()
    vec = D % per == 0 and ys.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    slices = -(-D // (COMBINE_THREADS * (per if vec else 1)))
    per_block = min(max(1, -(-n_tok * slices // (2 * sm_count(ys.device)))),
                    max(1, 12288 // k))
    fn = build.bind("grouped_matmul", "repro_grouped_combine", _COMBINE_ARGTYPES)
    err = fn(ys.data_ptr(), order.data_ptr(), out.data_ptr(), n_tok, k, D,
             DTYPE_CODES[ys.dtype], per_block, slices, int(vec),
             torch.cuda.current_stream(ys.device).cuda_stream)
    if err:
        raise RuntimeError(f"combine kernel launch failed: cudaError {err}")
    kernel_launches[Kernel("combine", "vec16" if vec else "scalar", str(ys.dtype))] += 1
    combine_fwd.launches += 1
    return out


grouped_matmul_fwd.launches = 0
grouped_gate_up_fwd.launches = 0
combine_fwd.launches = 0
