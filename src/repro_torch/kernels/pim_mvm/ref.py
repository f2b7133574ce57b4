"""Plain-PyTorch oracle for the quantised weight-stationary MVM
(counterpart of the reference's ``kernels/pim_mvm/ref.py``)."""
from __future__ import annotations

import torch

XBAR = 128


def dequantize_ref(wq, scales):
    """(K, N) int8 + (K/128, N/128) f32 tile scales -> (K, N) f32."""
    full = scales.repeat_interleave(XBAR, dim=0).repeat_interleave(XBAR, dim=1)
    return wq.float() * full


def pim_mvm_ref(x, wq, scales):
    w = dequantize_ref(wq, scales)
    return (x.float() @ w).to(x.dtype)
