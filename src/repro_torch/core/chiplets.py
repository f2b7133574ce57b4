"""Chiplet device models — paper Table 1 / §4.1.1.

All throughput/energy constants carry their Table-1 (or cited-source)
provenance in comments.  Exactly two free calibration scalars exist in the
whole Plane-B model — ``sm_efficiency`` and ``reram_fill`` — fitted once to
the two Table-4 anchors (see core/simulator.py) and then held fixed for
every figure.
"""
from __future__ import annotations

import dataclasses
from enum import Enum


class ChipletType(str, Enum):
    SM = "SM"
    MC = "MC"
    DRAM = "DRAM"
    RERAM = "ReRAM"
    HOST = "HOST"      # baseline architectures use host chiplets (HAIMA §4.2)
    SRAM = "SRAM"      # HAIMA hybrid plane
    ACU = "ACU"        # TransPIM auxiliary compute units


@dataclasses.dataclass(frozen=True)
class SMChiplet:
    """Volta-class SM chiplet: 10 tensor cores, 1530 MHz (Table 1)."""
    # V100: 640 tensor cores over 80 SMs -> 125 TFLOP/s fp16 => one
    # 10-tensor-core SM chiplet ~ 1.95 TFLOP/s peak [43].
    peak_flops: float = 1.95e12
    sram_bytes: float = (64 + 96) * 1024      # 64KB regfile + 96KB L1
    power_w: float = 3.5                      # Volta SM power share @1530MHz
    area_mm2: float = 7.5


@dataclasses.dataclass(frozen=True)
class MCChiplet:
    """Memory-controller chiplet: 512KB L2, DFI/PHY to one HBM channel."""
    l2_bytes: float = 512 * 1024
    power_w: float = 0.8
    area_mm2: float = 3.2                     # Table 1
    # DFI interface bandwidth matches the HBM channel it fronts.


@dataclasses.dataclass(frozen=True)
class DRAMChiplet:
    """One HBM2 channel: 2GB, 16 banks, 128-bit TSV bus (Table 1/[26])."""
    capacity_bytes: float = 2 << 30
    bw: float = 32e9                          # 256-bit stack / 2 channels [26]
    energy_pj_per_bit: float = 3.9            # HBM2 access energy (VAMPIRE)
    idle_power_w: float = 0.25
    max_temp_c: float = 95.0                  # corruption threshold (§4.3)


@dataclasses.dataclass(frozen=True)
class ReRAMChiplet:
    """ISAAC-style: 16 tiles; tile = 96 crossbars of 128×128, 2-bit cells,
    96 8-bit ADCs, 0.34 W, 0.37 mm² @32 nm (Table 1 [66])."""
    tiles: int = 16
    crossbars_per_tile: int = 96
    xbar_rows: int = 128
    xbar_cols: int = 128
    cell_bits: int = 2
    # one crossbar MVM (128×128 MACs) per 100 ns read cycle [66]
    xbar_ops_per_s: float = 2 * 128 * 128 / 100e-9
    tile_power_w: float = 0.34
    area_mm2_per_tile: float = 0.37
    write_endurance: float = 1e8              # NVM endurance bound [28]
    write_energy_pj_per_bit: float = 2.5

    @property
    def peak_flops(self) -> float:
        return self.tiles * self.crossbars_per_tile * self.xbar_ops_per_s

    @property
    def power_w(self) -> float:
        return self.tiles * self.tile_power_w

    @property
    def weight_capacity_bytes(self) -> float:
        cells = (self.tiles * self.crossbars_per_tile
                 * self.xbar_rows * self.xbar_cols)
        return cells * self.cell_bits / 8


@dataclasses.dataclass(frozen=True)
class NoILink:
    """Interposer link: 1.55 mm / cycle @ 1.2 GHz, GRS @ 32 nm ([7][11])."""
    freq_hz: float = 1.2e9
    width_bits: int = 256
    hop_mm: float = 1.55
    energy_pj_per_bit: float = 1.17           # Nvidia GRS [51]
    router_pj_per_bit: float = 0.52

    @property
    def bw(self) -> float:                    # bytes/s
        return self.freq_hz * self.width_bits / 8


@dataclasses.dataclass(frozen=True)
class HostLink:
    """Host/off-interposer access used by HAIMA/TransPIM softmax paths."""
    bw: float = 16e9                          # PCIe4-ish
    latency_s: float = 2e-6


@dataclasses.dataclass(frozen=True)
class Calibration:
    """The ONLY free scalars in Plane B (fit in simulator.calibrate())."""
    sm_efficiency: float = 0.28               # achieved/peak on attention MVMs
    reram_fill: float = 0.32                  # ReRAM pipeline fill/utilisation


SM = SMChiplet()
MC = MCChiplet()
DRAM = DRAMChiplet()
RERAM = ReRAMChiplet()
LINK = NoILink()
HOST_LINK = HostLink()

# Dimensional-utilisation saturation points (structural constants, not
# fitted — see simulator.py): achieved/peak grows ~linearly with the
# stationary operand dim until these saturate.
SM_SAT_DIM = 4096       # Volta tensor-pipeline depth × MMA tile width
RERAM_SAT_DIM = 16384   # 128 crossbar columns × 128-wide tile groups

# Table 2: resource allocation per system size
SYSTEM_ALLOC = {
    36: {"SM": 20, "MC": 4, "DRAM": 4, "ReRAM": 8},
    64: {"SM": 36, "MC": 6, "DRAM": 6, "ReRAM": 16},
    100: {"SM": 64, "MC": 8, "DRAM": 8, "ReRAM": 20},
}

# HBM2 tiers per system size (§4.1.1)
HBM_TIERS = {36: 2, 64: 3, 100: 4}
