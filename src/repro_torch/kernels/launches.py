"""The kernel wrappers' launch counters, read and moved together.

Each wrapper counts its launches on the host: ``<wrapper>.launches``, and
a ``collections.Counter`` by kernel (``kernel_launches`` of the prefill
and the dequant-matmul, ``kernel_launches`` and ``quant_kernel_launches``
of the decodes).  A CUDA graph launches its kernels without running the
wrappers, so whoever replays one adds what its capture counted
(:func:`since` before the capture, :func:`add` at each replay), and takes
the capture's own counts back out (:func:`restore`): a capture launches
nothing.
"""
from __future__ import annotations

import collections

Launches = collections.namedtuple("Launches", "calls kernels")


def wrappers() -> dict:
    """Every kernel wrapper of the port, by the name of its kernel's
    record in ``chip_smoke.py``."""
    from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd,
                                                            flash_decode_quant_fwd)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.pim_mvm.kernel import pim_mvm_fwd
    from repro_torch.quant.kernel import quant_matmul_fwd
    return {"flash_decode": flash_decode_fwd, "flash_prefill": flash_attention_fwd,
            "flash_decode_quant": flash_decode_quant_fwd,
            "quant_matmul": quant_matmul_fwd, "pim_mvm": pim_mvm_fwd}


def counters() -> dict:
    """The per-kernel launch counters of qmatmul.cu, prefill.cu, decode.cu
    and decode_quant.cu."""
    from repro_torch.kernels.flash_attention.decode import kernel_launches as decode
    from repro_torch.kernels.flash_attention.decode import quant_kernel_launches
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill
    from repro_torch.quant.kernel import kernel_launches as qmatmul
    return {"qmatmul": qmatmul, "prefill": prefill, "decode": decode,
            "decode_quant": quant_kernel_launches}


def snapshot() -> Launches:
    return Launches({n: f.launches for n, f in wrappers().items()},
                    {n: c.copy() for n, c in counters().items()})


def since(before: Launches) -> Launches:
    """What was counted after ``before`` was taken."""
    now = snapshot()
    return Launches({n: now.calls[n] - before.calls[n] for n in now.calls},
                    {n: now.kernels[n] - before.kernels[n] for n in now.kernels})


def restore(state: Launches) -> None:
    for n, f in wrappers().items():
        f.launches = state.calls[n]
    for n, c in counters().items():
        c.clear()
        c.update(state.kernels[n])


def add(delta: Launches) -> None:
    for n, f in wrappers().items():
        f.launches += delta.calls[n]
    for n, c in counters().items():
        c.update(delta.kernels[n])
