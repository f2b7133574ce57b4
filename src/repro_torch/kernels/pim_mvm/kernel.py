"""Weight-stationary quantised MVM, the ReRAM-crossbar analogue
(counterpart of the reference's ``kernels/pim_mvm/kernel.py::
pim_mvm_pallas``): x (M, K) · dequant(wq (K, N) int8, scales (K/128,
N/128)), one f32 scale per 128×128 crossbar tile, f32 accumulation.

:func:`pim_mvm_fwd` is the second wrapper of the dequant-matmul kernel in
``kernels/csrc/qmatmul.cu``, with its per-tile scale layout; the
serving projections use the first (:mod:`repro_torch.quant.kernel`).  On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`pim_mvm_plain`.
"""
from __future__ import annotations

from repro_torch.kernels.pim_mvm.ref import XBAR, pim_mvm_ref
from repro_torch.parallel.api import refuse_dtensor
from repro_torch.quant.kernel import check_cuda_operands, launch_dequant_matmul

# the plain version: f32 dequantise, f32 matmul, one cast — the oracle's
# arithmetic exactly
pim_mvm_plain = pim_mvm_ref


def pim_mvm_fwd(x, wq, scales):
    """x (M, K) · dequant(wq (K, N) int8, scales (K/128, N/128)) -> (M, N)
    in x's dtype.  K and N must tile 128×128 crossbars."""
    refuse_dtensor("pim_mvm_fwd", x, wq, scales)
    M, K = x.shape
    K2, N = wq.shape
    if K != K2 or K % XBAR or N % XBAR or tuple(scales.shape) != (K // XBAR, N // XBAR):
        raise ValueError(f"x {tuple(x.shape)}, weights {tuple(wq.shape)} and scales "
                         f"{tuple(scales.shape)} must tile {XBAR}x{XBAR} crossbars")
    if x.device.type == "cpu":
        return pim_mvm_plain(x, wq, scales)
    check_cuda_operands(x, wq, scales)
    out = launch_dequant_matmul(x, wq, scales, bits=8, group_rows=XBAR, tile=True)
    pim_mvm_fwd.launches += 1
    return out


pim_mvm_fwd.launches = 0
