"""Thermal + ReRAM-noise models for 3D-HI (paper §4.3, eqs 16-19).

Vertical heat flow (eq. 16): T(n,k) = Σᵢ₌₁ᵏ (Pₙᵢ Σⱼ₌₁ⁱ Rⱼ) + R_b Σᵢ Pₙᵢ
Horizontal spread (eq. 17): ΔT(k) = maxₙ T(n,k) − minₙ T(n,k)
Combined objective (eq. 18): T(λ) = max T(n,k) · max ΔT(k)
ReRAM thermal noise (eq. 19): σ = √(4 G k_B T_ReRAM F) / V

The 3D-HI MOO (eq. 20) adds T(λ) and Noise(λ) to the (μ, σ) utilisation
objectives.  The same column model quantifies why the original HAIMA /
TransPIM 3-D stacks exceed DRAM's 95 °C ceiling (Fig. 11): eight 3.138 W
compute units per bank on a 53.15 mm² HBM die.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import chiplets as C
from repro_torch.core.placement import Placement

AMBIENT_C = 45.0
R_VERT = 0.18        # K/W per tier (TSV stack, [59])
R_BASE = 0.35        # K/W heat-sink/base resistance
K_B = 1.380649e-23
RERAM_G = 1.0 / 20e3  # ~20 kΩ LRS conductance
RERAM_V = 0.3
RERAM_F = 0.5e9


@dataclasses.dataclass
class ThermalReport:
    peak_c: float
    delta_c: float
    objective: float          # eq. 18
    per_tier_peak: list
    reram_noise_sigma: float  # eq. 19
    dram_feasible: bool       # < 95 °C


def _power_of(t: str) -> float:
    return {
        "SM": C.SM.power_w, "MC": C.MC.power_w, "ReRAM": C.RERAM.power_w,
        "DRAM": 1.1, "SRAM": 1.2, "ACU": 0.9, "HOST": 6.0,
    }.get(t, 0.5)


def stack_columns(tiers: list[list[str]]) -> np.ndarray:
    """tiers: list (bottom→top, index 1 = closest to sink) of per-column
    chiplet types; returns power matrix P[n, i]."""
    n_cols = max(len(t) for t in tiers)
    P = np.zeros((n_cols, len(tiers)))
    for i, tier in enumerate(tiers):
        for n, t in enumerate(tier):
            P[n, i] = _power_of(t)
    return P


def thermal_eval(tiers: list[list[str]]) -> ThermalReport:
    P = stack_columns(tiers)                      # (n_cols, n_tiers)
    n_cols, n_tiers = P.shape
    T = np.zeros_like(P)
    for k in range(n_tiers):
        for n in range(n_cols):
            # eq. 16: vertical column model
            acc = 0.0
            for i in range(k + 1):
                acc += P[n, i] * (R_VERT * (i + 1))
            acc += R_BASE * P[n, : k + 1].sum()
            # horizontal coupling: neighbours' mean power leaks in
            lateral = 0.12 * (P[:, k].mean())
            T[n, k] = AMBIENT_C + acc + lateral
    per_tier_peak = T.max(axis=0)
    delta = T.max(axis=0) - T.min(axis=0)         # eq. 17
    peak = float(T.max())
    objective = peak * float(delta.max())         # eq. 18
    # ReRAM noise at the hottest ReRAM tier (eq. 19)
    reram_T = AMBIENT_C + 273.15
    for i, tier in enumerate(tiers):
        if any(t == "ReRAM" for t in tier):
            reram_T = max(reram_T, float(T[:, i].max()) + 273.15)
    sigma = math.sqrt(4 * RERAM_G * K_B * reram_T * RERAM_F) / RERAM_V
    return ThermalReport(peak, float(delta.max()), objective,
                         per_tier_peak.tolist(), sigma, peak < C.DRAM.max_temp_c)


def tiers_from_placement(p: Placement, n_tiers: int = 2) -> list[list[str]]:
    """Split a 2.5D placement into vertical tiers for 3D-HI: SM-MC tiers and
    ReRAM tiers may not share a tier (technology constraint, §4.3)."""
    cmos = [t for t in p.types if t in ("SM", "MC", "DRAM", "HOST", "ACU", "SRAM")]
    reram = [t for t in p.types if t == "ReRAM"]
    tiers: list[list[str]] = [[] for _ in range(n_tiers)]
    for i, t in enumerate(cmos):
        tiers[i % max(n_tiers - 1, 1)].append(t)
    tiers[-1] = reram or ["ReRAM"]
    return tiers


def hbm_pim_stack_report(n_tiers: int = 8, units_per_bank: int = 8,
                         unit_w: float = 3.138, banks: int = 16,
                         die_mm2: float = 53.15,
                         concurrent_frac: float = 0.125) -> ThermalReport:
    """Fig-11 baseline check: original HAIMA/TransPIM 3-D HBM-PIM stacks.
    Eight 3.138 W units/bank drives power density an order of magnitude
    past a GPU's; the column model puts the stack far above 95 °C.
    ``concurrent_frac``: fraction of banks concurrently active (cf. the
    simulator's ``orig_bank_cap``)."""
    per_die_w = units_per_bank * unit_w * banks * concurrent_frac
    tiers = [["PIMDIE"] * 4 for _ in range(n_tiers)]
    P = np.full((4, n_tiers), per_die_w / 4)
    T = np.zeros_like(P)
    for k in range(n_tiers):
        for n in range(P.shape[0]):
            acc = sum(P[n, i] * (R_VERT * (i + 1)) for i in range(k + 1))
            acc += R_BASE * P[n, : k + 1].sum()
            T[n, k] = AMBIENT_C + acc
    peak = float(T.max())
    delta = float((T.max(0) - T.min(0)).max())
    sigma = math.sqrt(4 * RERAM_G * K_B * (peak + 273.15) * RERAM_F) / RERAM_V
    return ThermalReport(peak, delta, peak * max(delta, 1e-9),
                         T.max(0).tolist(), sigma, peak < C.DRAM.max_temp_c)


def baseline_stack_report(kind: str) -> ThermalReport:
    """Fig-11 steady-state temperature of the original 3-D baselines.

    HAIMA: up to eight 3.138 W compute units per bank on a 53.15 mm² HBM2
    die; TransPIM: 8 HBM stacks with in-bank logic, thermal resistance
    growing up the stack (§4.3).  Paper: ≥120 °C, max 131 °C.
    """
    if kind == "haima":
        # 8 units/bank, 4-of-16 banks concurrent (= simulator orig_bank_cap)
        return hbm_pim_stack_report(n_tiers=4, units_per_bank=8,
                                    concurrent_frac=0.25)
    if kind == "transpim":
        return hbm_pim_stack_report(n_tiers=8, units_per_bank=6,
                                    concurrent_frac=0.125)
    raise ValueError(f"unknown baseline {kind!r}")


def hi3d_stack_report(n_chiplets: int, n_tiers: int = 2) -> ThermalReport:
    """3D-HI thermal report from the Table-2 allocation placed on tiers
    (SM-MC tiers below, ReRAM tier on top — §4.3 technology constraint)."""
    from repro_torch.core.placement import initial_placement

    return thermal_eval(tiers_from_placement(
        initial_placement(n_chiplets), n_tiers))


def noise_objective(report: ThermalReport) -> float:
    return report.reram_noise_sigma


def moo_objectives_3d(p: Placement, noi_mu: float, noi_sigma: float,
                      n_tiers: int = 2) -> tuple:
    """Eq. 20: (μ, σ, T(λ), Noise(λ))."""
    th = thermal_eval(tiers_from_placement(p, n_tiers))
    return (noi_mu, noi_sigma, th.objective, th.reram_noise_sigma)
