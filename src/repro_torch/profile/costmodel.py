"""Affine cost models fitted to measured kernel/phase times (counterpart
of the reference's ``profile/costmodel.py``: the same fits and the same
JSON schema, so a table written by either package loads in the other).

Each phase class (``Sample.kind``) gets a least-squares fit of

    time_s  =  intercept_s  +  term / rate

in one of the ``core.traffic`` regressors (``bytes_term`` or
``flops_term``): the intercept is the launch/dispatch overhead, the
slope's reciprocal is the *effective rate* (bytes/s or FLOP/s) — exactly
the shape of Plane B's analytical phase charges, so fitted rates drop
into ``simulator.Calib`` without unit gymnastics (``profile.calibrate``).

Residual discipline
-------------------
The grid is split deterministically (every third point by term
magnitude is held out), the model is fitted on the rest, and the
held-out relative errors are recorded on the fit.  Those residuals are
the *error bars* every calibrated co-sim claim carries — a
``CalibrationTable`` whose fits have large held-out error is reporting
its own untrustworthiness, not hiding it.  ``rate_ci95_rel`` is the
standard OLS 95% half-width on the slope, relative to the slope.

Tables are versioned (``CALIBRATION_VERSION``); loading a table written
by a different schema version raises instead of silently re-interpreting
stale rates.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.profile.bench import Sample

__all__ = [
    "CALIBRATION_VERSION", "DEFAULT_TERMS", "PhaseFit", "CalibrationTable",
    "fit_phase", "fit_samples", "build_table",
]

CALIBRATION_VERSION = 1

# primary regressor per phase class: the memory-streaming kinds fit
# against bytes (effective bandwidth), the compute-bound prefill kind
# against FLOPs (effective flop rate)
DEFAULT_TERMS = {
    "decode_attn": "bytes",
    "decode_attn_kv8": "bytes",
    "decode_attn_kv4": "bytes",
    "prefill_attn": "flops",
    "dequant_matmul": "bytes",
    "executor_step": "bytes",
}


@dataclasses.dataclass(frozen=True)
class PhaseFit:
    """One phase class's affine cost model + its residual pedigree."""
    kind: str
    term: str                 # "bytes" | "flops" — the fitted regressor
    intercept_s: float        # launch overhead (clamped at >= 0)
    rate: float               # effective rate: term units per second
    rate_ci95_rel: Optional[float]   # 95% CI half-width / rate (n>2 only)
    r2: float
    n_train: int
    n_heldout: int
    heldout_max_rel_err: float   # max |pred - t| / t over held-out points
    heldout_mean_rel_err: float  # (falls back to train residuals, n_heldout=0)
    flops_per_unit: float     # mean FLOPs per term unit (rate conversion)
    ref_term: float           # median grid point, for the error report
    ref_seconds: float        # its measured steady-state time

    def predict(self, term_value: float) -> float:
        return self.intercept_s + term_value / self.rate

    @property
    def flops_rate(self) -> float:
        """Effective FLOP/s implied by the fit (identity when
        ``term == "flops"``)."""
        return self.rate * self.flops_per_unit

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "PhaseFit":
        return cls(**d)


def _term_value(s: Sample, term: str) -> float:
    if term == "bytes":
        return s.bytes_term
    if term == "flops":
        return s.flops_term
    raise ValueError(f"unknown regressor {term!r} (want 'bytes' or 'flops')")


def _ols(xs: Sequence[float], ys: Sequence[float]):
    """Plain OLS y = a + s*x.  Returns (a, s, r2, slope_stderr)."""
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    if sxx <= 0.0:
        return my, 0.0, 0.0, None
    s = sxy / sxx
    a = my - s * mx
    rss = sum((y - (a + s * x)) ** 2 for x, y in zip(xs, ys))
    tss = sum((y - my) ** 2 for y in ys)
    r2 = 1.0 - rss / tss if tss > 0 else 1.0
    stderr = (rss / (n - 2) / sxx) ** 0.5 if n > 2 else None
    return a, s, r2, stderr


def fit_phase(samples: Sequence[Sample], *, term: Optional[str] = None,
              holdout_every: int = 3) -> PhaseFit:
    """Fit one phase class; every ``holdout_every``-th point (by term
    magnitude, deterministic) is held out for the residual report.

    Degenerate grids (slope <= 0 from timing noise at tiny scales) fall
    back to the through-origin aggregate rate with intercept 0 — flagged
    by ``r2`` and the residuals, never by a crash.
    """
    if not samples:
        raise ValueError("fit_phase needs at least one sample")
    kinds = {s.kind for s in samples}
    if len(kinds) != 1:
        raise ValueError(f"fit_phase got mixed kinds {sorted(kinds)}")
    kind = samples[0].kind
    term = term or DEFAULT_TERMS.get(kind, "bytes")

    ordered = sorted(samples, key=lambda s: (_term_value(s, term), s.seconds))
    if len(ordered) >= 2 * holdout_every:
        held = [s for i, s in enumerate(ordered) if i % holdout_every == 1]
        train = [s for i, s in enumerate(ordered) if i % holdout_every != 1]
    else:
        held, train = [], list(ordered)

    xs = [_term_value(s, term) for s in train]
    ys = [s.seconds for s in train]
    if len(train) >= 2:
        a, slope, r2, stderr = _ols(xs, ys)
    else:
        a, slope, r2, stderr = 0.0, ys[0] / max(xs[0], 1e-30), 1.0, None
    if a < 0.0:
        # a negative launch overhead is unphysical (noise tilted the
        # line): refit through the origin rather than clamp-and-keep a
        # slope that no longer minimises anything
        sxx = sum(x * x for x in xs)
        slope = (sum(x * y for x, y in zip(xs, ys)) / sxx) if sxx else 0.0
        a = 0.0
        my = sum(ys) / len(ys)
        tss = sum((y - my) ** 2 for y in ys)
        rss = sum((y - slope * x) ** 2 for x, y in zip(xs, ys))
        r2 = 1.0 - rss / tss if tss > 0 else 1.0
        stderr = ((rss / (len(xs) - 1) / sxx) ** 0.5
                  if len(xs) > 1 and sxx else None)
    if slope <= 0.0:
        if a > 0.0:
            # latency-floor regime (times flat across the grid — e.g. a
            # tiny executor step that vectorises away the batch): keep
            # the intercept as the floor and make the slope's largest
            # contribution 1% of it, i.e. an effectively infinite rate
            # that still serialises as a finite float
            slope = 0.01 * a / max(max(xs), 1e-30)
            stderr = None
        else:                              # noise floor: aggregate rate
            slope = sum(ys) / max(sum(xs), 1e-30)
            a, r2, stderr = 0.0, 0.0, None
    rate = 1.0 / slope
    ci = (1.96 * stderr / slope) if stderr is not None and slope > 0 else None

    def rel_errs(pts):
        return [abs(a + _term_value(s, term) * slope - s.seconds)
                / max(s.seconds, 1e-30) for s in pts]

    resid = rel_errs(held) if held else rel_errs(train)
    fpu = (sum(s.flops_term for s in ordered)
           / max(sum(_term_value(s, term) for s in ordered), 1e-30))
    ref = ordered[len(ordered) // 2]
    return PhaseFit(
        kind=kind, term=term, intercept_s=a, rate=rate,
        rate_ci95_rel=ci, r2=r2,
        n_train=len(train), n_heldout=len(held),
        heldout_max_rel_err=max(resid) if resid else 0.0,
        heldout_mean_rel_err=(sum(resid) / len(resid)) if resid else 0.0,
        flops_per_unit=fpu,
        ref_term=_term_value(ref, term), ref_seconds=ref.seconds)


def fit_samples(samples: Sequence[Sample], *,
                terms: Optional[dict] = None,
                holdout_every: int = 3) -> dict[str, PhaseFit]:
    """Group samples by kind and fit each phase class."""
    terms = terms or DEFAULT_TERMS
    by_kind: dict[str, list[Sample]] = {}
    for s in samples:
        by_kind.setdefault(s.kind, []).append(s)
    return {k: fit_phase(v, term=terms.get(k), holdout_every=holdout_every)
            for k, v in sorted(by_kind.items())}


@dataclasses.dataclass
class CalibrationTable:
    """Versioned, serializable bundle of fitted phase cost models."""
    backend: str
    interpret: bool
    fits: dict[str, PhaseFit]
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = CALIBRATION_VERSION

    @property
    def error_bar_rel(self) -> float:
        """The calibration error bar: worst held-out relative residual
        across all fitted phases — the ± attached to every co-sim
        headline replayed through this table."""
        if not self.fits:
            return 0.0
        return max(f.heldout_max_rel_err for f in self.fits.values())

    def to_json(self) -> dict:
        return {"version": self.version, "backend": self.backend,
                "interpret": self.interpret, "meta": dict(self.meta),
                "fits": {k: f.to_json() for k, f in self.fits.items()}}

    @classmethod
    def from_json(cls, d: dict) -> "CalibrationTable":
        ver = d.get("version")
        if ver != CALIBRATION_VERSION:
            raise ValueError(
                f"CalibrationTable version {ver!r} != supported "
                f"{CALIBRATION_VERSION} — re-run the profiler instead of "
                "re-interpreting stale rates")
        return cls(backend=d["backend"], interpret=bool(d["interpret"]),
                   fits={k: PhaseFit.from_json(f)
                         for k, f in d["fits"].items()},
                   meta=dict(d.get("meta", {})))

    def save(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


def build_table(samples: Sequence[Sample], *, backend: Optional[str] = None,
                interpret: Optional[bool] = None, meta: Optional[dict] = None,
                holdout_every: int = 3) -> CalibrationTable:
    """Fit every phase class in ``samples`` into a fresh table.

    ``backend`` is the type of the device the samples ran on: ``"cuda"``
    for the card (the default: without a card this raises), ``"cpu"``
    where the plain versions ran; ``interpret`` defaults to whether that
    is the CPU."""
    backend = backend if backend is not None else resolve_device(None).type
    return CalibrationTable(
        backend=backend,
        interpret=backend == "cpu" if interpret is None else interpret,
        fits=fit_samples(samples, holdout_every=holdout_every),
        meta=dict(meta or {}))
