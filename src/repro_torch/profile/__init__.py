"""Measured-cost calibration plane: profile-and-replay (counterpart of
the reference's ``profile/``).

``bench``     — deterministic micro-timer for the port's CUDA kernels and
                the engine's captured decode step (first-call/steady-state
                split, injectable clock; ``device="cpu"`` times the plain
                PyTorch versions, and without a card nothing runs unless
                the CPU is asked for).
``costmodel`` — affine least-squares fits of phase time in the
                ``core.traffic`` byte/FLOP terms, with held-out residuals
                and confidence intervals in a versioned
                ``CalibrationTable`` (the reference's JSON schema).
``calibrate`` — maps fitted rates onto ``simulator.Calib`` rate constants
                behind an explicit ``calib=`` opt-in, and reports
                analytical-vs-measured error per phase.

The default analytical path is untouched: nothing here runs unless a
caller times kernels and passes the resulting ``Calib`` explicitly.
"""
from repro_torch.profile.bench import (Sample, Timing, executor_samples,
                                       interpret_default, kernel_samples,
                                       measure)
from repro_torch.profile.calibrate import (error_bar_rel, measured_calib,
                                           phase_error_report)
from repro_torch.profile.costmodel import (CALIBRATION_VERSION,
                                           CalibrationTable, PhaseFit,
                                           build_table, fit_phase,
                                           fit_samples)

__all__ = [
    "Sample", "Timing", "measure", "interpret_default",
    "kernel_samples", "executor_samples",
    "CALIBRATION_VERSION", "PhaseFit", "CalibrationTable",
    "fit_phase", "fit_samples", "build_table",
    "measured_calib", "phase_error_report", "error_bar_rel",
]
