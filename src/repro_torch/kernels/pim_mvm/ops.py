"""Dispatch wrapper for the PIM-MVM kernel (counterpart of the reference's
``kernels/pim_mvm/ops.py``).

``quantize_weights`` — programming the crossbars, done once per static
weight matrix — lives in :mod:`repro_torch.quant.core` and is re-exported
here; ``pim_mvm`` is the streaming execute step.
"""
from __future__ import annotations

from repro_torch.kernels.pim_mvm.kernel import XBAR, pim_mvm_fwd  # noqa: F401
from repro_torch.kernels.pim_mvm.ref import pim_mvm_ref
from repro_torch.quant.core import quantize_weights  # noqa: F401  (re-export)


def pim_mvm(x, wq, scales, *, impl: str = "flash"):
    """Quantised weight-stationary matmul.

    impl: ``flash`` (the CUDA kernel on a CUDA tensor, its plain version on
    a CPU tensor) | ``ref`` (the oracle)."""
    if impl == "ref":
        return pim_mvm_ref(x, wq, scales)
    if impl == "flash":
        return pim_mvm_fwd(x, wq, scales)
    raise ValueError(f"unknown impl {impl!r}")
