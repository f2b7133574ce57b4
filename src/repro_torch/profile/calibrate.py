"""Map fitted kernel rates onto Plane-B rate constants — behind an
explicit opt-in (counterpart of the reference's ``profile/calibrate.py``,
its code with only the imports changed).

``measured_calib(table)`` returns a ``simulator.Calib`` whose
``sm_efficiency`` / ``reram_fill`` come from *measured* effective rates
instead of the Table-4 anchor fit.  Nothing uses it unless you pass it:
``simulate_generation(..., calib=measured_calib(table))`` /
``cosim_mix(..., calib=)`` — the default ``CALIB`` path stays
bit-identical (the anchor-calibration contract in ``core/README.md`` is
untouched; this module only *constructs* an alternative ``Calib``).

What is mapped, what stays analytical
-------------------------------------
- ``sm_efficiency``  <- measured attention FLOP rate (segmented-prefill
  fit, falling back to decode attention) over the allocated SM peak.
- ``reram_fill``     <- measured fused dequant-matmul FLOP rate (the
  weight-stationary regime ReRAM models) over the allocated ReRAM peak.
- Everything else — NoI wire/hop model, DRAM bandwidth, link energies,
  the HAIMA/TransPIM baseline constants — stays analytical.  The
  profiler measures this host's kernels; it has nothing to say about
  the paper's fabric.

``phase_error_report`` quantifies the gap per phase: the analytical
charge for the fitted phase's median grid point vs the measured cost
model's prediction, next to the fit's own held-out residual (the error
bar).  On the CPU the absolute gap is enormous by construction — the
plain versions are not a 27-TFLOP SM plane — which is exactly what the
report is for: the co-sim headline carries the measured residual as its
error bar, and the analytical-vs-measured column says how far the
hand-set constants sit from *this* backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import chiplets as C
from repro_torch.core import simulator
from repro_torch.core.simulator import CALIB, Calib
from repro_torch.profile.costmodel import CalibrationTable, PhaseFit

__all__ = ["PLANE_MAP", "measured_calib", "phase_error_report",
           "error_bar_rel"]

# which Plane-B compute/transfer plane each fitted phase class maps onto
PLANE_MAP = {
    "prefill_attn": "sm",
    "decode_attn": "sm",
    "decode_attn_kv8": "sm",
    "decode_attn_kv4": "sm",
    "dequant_matmul": "reram",
    "executor_step": "dram",
}

# preference order for the rate that calibrates each efficiency scalar
_SM_KINDS = ("prefill_attn", "decode_attn")
_RERAM_KINDS = ("dequant_matmul",)


def _geomean(vals: list[float]) -> float:
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def _plane_flops_rate(fits: dict[str, PhaseFit], kinds) -> Optional[float]:
    rates = [fits[k].flops_rate for k in kinds
             if k in fits and fits[k].flops_rate > 0]
    return _geomean(rates) if rates else None


def measured_calib(table: CalibrationTable, *, n_chiplets: int = 64,
                   base: Calib = CALIB) -> Calib:
    """A ``Calib`` whose efficiency scalars are measured, not anchored.

    Missing phase classes keep ``base``'s value for their scalar (a table
    with only attention fits still calibrates ``sm_efficiency``).  The
    result is clamped to (0, 1]: an efficiency is achieved/peak by
    definition.  Opt-in only — callers must pass it as ``calib=``.
    """
    alloc = simulator._alloc(n_chiplets)
    kw = {}
    sm = _plane_flops_rate(table.fits, _SM_KINDS)
    if sm is not None:
        peak = alloc["SM"] * C.SM.peak_flops
        kw["sm_efficiency"] = min(max(sm / peak, 1e-12), 1.0)
    rer = _plane_flops_rate(table.fits, _RERAM_KINDS)
    if rer is not None:
        peak = alloc["ReRAM"] * C.RERAM.peak_flops
        kw["reram_fill"] = min(max(rer / peak, 1e-12), 1.0)
    return dataclasses.replace(base, **kw)


def _analytical_seconds(fit: PhaseFit, *, alloc: dict, calib: Calib,
                        d_model: int) -> float:
    """Plane B's charge for the fit's median grid point, on the plane
    the phase class maps to (compute planes charge FLOPs, the executor
    step charges its fabric bytes against DRAM bandwidth)."""
    plane = PLANE_MAP.get(fit.kind, "sm")
    if plane == "dram":
        bytes_term = (fit.ref_term if fit.term == "bytes"
                      else fit.ref_term * fit.flops_per_unit)
        return bytes_term / (alloc["DRAM"] * C.DRAM.bw)
    flops = fit.ref_term * fit.flops_per_unit
    if plane == "reram":
        return flops / (alloc["ReRAM"] * C.RERAM.peak_flops
                        * calib.reram_fill)
    rate = (alloc["SM"] * C.SM.peak_flops * calib.sm_efficiency
            * min(1.0, d_model / C.SM_SAT_DIM))
    return flops / rate


def phase_error_report(table: CalibrationTable, *, n_chiplets: int = 64,
                       d_model: int = 64, calib: Calib = CALIB) -> dict:
    """Per-phase analytical-vs-measured comparison.

    For every fitted phase class: the measured model's prediction at its
    median grid point, the analytical charge for the same byte/FLOP
    terms, their log10 ratio (measured/analytical), and the fit's
    held-out residual — the error bar a calibrated claim carries.
    """
    alloc = simulator._alloc(n_chiplets)
    report = {}
    for kind, fit in sorted(table.fits.items()):
        measured = fit.predict(fit.ref_term)
        analytical = _analytical_seconds(fit, alloc=alloc, calib=calib,
                                         d_model=d_model)
        report[kind] = {
            "plane": PLANE_MAP.get(kind, "sm"),
            "term": fit.term,
            "ref_term": fit.ref_term,
            "measured_s": measured,
            "fit_rel_err_at_ref": (abs(measured - fit.ref_seconds)
                                   / max(fit.ref_seconds, 1e-30)),
            "analytical_s": analytical,
            "log10_measured_over_analytical": (
                math.log10(measured / analytical)
                if measured > 0 and analytical > 0 else None),
            "intercept_s": fit.intercept_s,
            "rate": fit.rate,
            "rate_ci95_rel": fit.rate_ci95_rel,
            "heldout_max_rel_err": fit.heldout_max_rel_err,
            "heldout_mean_rel_err": fit.heldout_mean_rel_err,
            "n_train": fit.n_train,
            "n_heldout": fit.n_heldout,
        }
    return report


def error_bar_rel(table: CalibrationTable) -> float:
    """Worst held-out relative residual across the table's fits — the ±
    on every co-sim headline replayed through this calibration."""
    return table.error_bar_rel
