"""Three-term roofline of one step (counterpart of the reference's
``roofline/analysis.py``).

    compute    = FLOPs       / peak_FLOP/s
    memory     = HBM bytes   / HBM_bw
    collective = wire_bytes  / link_bw

per device, from a :class:`~repro_torch.roofline.dispatch.StepCost` (what
the step dispatched, counted by :func:`~repro_torch.roofline.dispatch.
analyze_step`) where the reference reads its optimized HLO.  The
arithmetic is the reference's.  The hardware defaults to one H100
(:data:`H100`); the reference's TPU v5e (:data:`V5E`) stays for comparing
the two packages on the same costs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline.dispatch import StepCost


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float        # bf16 FLOP/s per chip
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link per chip (~busiest-link model)
    hbm_bytes: float         # capacity per chip


V5E = HwSpec(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
             hbm_bytes=16 << 30)

# One NVIDIA H100 SXM5 80GB: dense bf16 peak and HBM rate from NVIDIA's
# data sheet (at the 700 W power limit); NVLink 4 moves 900 GB/s both ways
# together, 450 GB/s each way; the capacity is
# torch.cuda.get_device_properties(0).total_memory as an
# "NVIDIA H100 80GB HBM3, 700.00 W" card reports it (torch 2.11, CUDA 12.8).
H100 = HwSpec(name="h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
              hbm_bytes=85017493504)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_dev: float
    hbm_bytes_per_dev: float
    wire_bytes_per_dev: float
    model_flops: float            # 6·N_active·D tokens (train) / fwd analogue
    useful_ratio: float           # model_flops / (hlo_flops × devices)
    bottleneck: str = ""
    step_s: float = 0.0           # max of the three terms (no-overlap bound)
    roofline_frac: float = 0.0    # compute_s / step_s (1.0 = compute-bound)

    def finalize(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        self.step_s = max(terms.values())
        self.roofline_frac = (self.compute_s / self.step_s) if self.step_s else 0.0
        return self


def roofline_terms(cost: StepCost, *, arch: str, shape: str, mesh_name: str,
                   n_devices: int, model_flops: float,
                   hw: HwSpec = H100) -> RooflineReport:
    """The three terms of a step's per-device ``cost``; the field names
    keep the reference's (``hlo_flops_per_dev`` is the counted FLOPs)."""
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        compute_s=cost.flops / hw.peak_flops,
        memory_s=cost.bytes_hbm / hw.hbm_bw,
        collective_s=cost.total_collective_bytes / hw.ici_bw,
        hlo_flops_per_dev=cost.flops,
        hbm_bytes_per_dev=cost.bytes_hbm,
        wire_bytes_per_dev=cost.total_collective_bytes,
        model_flops=model_flops,
        useful_ratio=(model_flops / (cost.flops * n_devices)
                      if cost.flops else 0.0),
    )
    return rep.finalize()
