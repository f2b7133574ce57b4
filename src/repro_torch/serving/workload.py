"""Arrival-process generators for request-level serving experiments
(counterpart of the reference's ``serving/workload.py``, numpy only: the
same seed gives the same arrivals and prompts).

A workload is a list of :class:`Arrival` records — (due time, prompt,
budget, priority) — consumed by ``ServingFrontend.play``.  Three arrival
processes are provided:

- :func:`poisson_arrivals` — memoryless open-loop traffic at a given
  offered load (requests/s), the usual way to trace a capacity curve;
- :func:`bursty_arrivals` — Poisson bursts of back-to-back arrivals
  (same mean rate, heavier tail) to probe scheduler behaviour under
  transient overload;
- :func:`trace_arrivals` — replay recorded arrival times verbatim.

Prompts come from :func:`synthetic_prompts`, which can share a common
prefix across requests (``shared_prefix``) the way production traffic
shares system prompts — the packed prefill re-processes it per request
today, so the shared fraction is also the headroom a future prefix
cache would reclaim.  Everything here is numpy-only and deterministic
under a seeded generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of a workload: due ``t`` seconds after play starts."""
    t: float
    prompt: np.ndarray
    max_new_tokens: Optional[int] = None
    priority: int = 0


def poisson_arrivals(rate_rps: float, n: int,
                     rng: np.random.Generator) -> list[float]:
    """``n`` arrival times of a Poisson process at ``rate_rps`` req/s
    (i.i.d. exponential inter-arrival gaps), ascending from t=0."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return list(np.cumsum(gaps))


def bursty_arrivals(rate_rps: float, n: int, rng: np.random.Generator,
                    *, burst: int = 4) -> list[float]:
    """``n`` arrival times in Poisson bursts: groups of ``burst``
    simultaneous arrivals whose group process runs at ``rate_rps /
    burst``, so the mean offered load matches :func:`poisson_arrivals`
    at the same rate while the instantaneous load is far spikier."""
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    n_groups = -(-n // burst)
    starts = poisson_arrivals(rate_rps / burst, n_groups, rng)
    times = [t for t in starts for _ in range(burst)]
    return times[:n]


def trace_arrivals(times: Sequence[float]) -> list[float]:
    """Validate and adopt recorded arrival times (seconds, ascending)."""
    out = [float(t) for t in times]
    if not out:
        raise ValueError("trace must hold at least one arrival")
    if any(t < 0 for t in out) or any(b < a for a, b in zip(out, out[1:])):
        raise ValueError("trace times must be non-negative and ascending")
    return out


def synthetic_prompts(n: int, rng: np.random.Generator, *,
                      min_len: int = 4, max_len: int = 24,
                      vocab: int = 256,
                      shared_prefix: int = 0) -> list[np.ndarray]:
    """``n`` random int32 prompts with lengths uniform in
    [min_len, max_len]; the first ``shared_prefix`` tokens are common to
    every prompt (system-prompt sharing)."""
    if not 0 < min_len <= max_len:
        raise ValueError(f"need 0 < min_len <= max_len, got "
                         f"[{min_len}, {max_len}]")
    if shared_prefix >= min_len:
        raise ValueError(f"shared_prefix ({shared_prefix}) must leave at "
                         f"least one unique token (min_len {min_len})")
    prefix = rng.integers(0, vocab, size=shared_prefix)
    out = []
    for _ in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        body = rng.integers(0, vocab, size=length - shared_prefix)
        out.append(np.concatenate([prefix, body]).astype(np.int32))
    return out


def make_workload(n: int, rate_rps: float, *, seed: int = 0,
                  kind: str = "poisson", burst: int = 4,
                  trace: Optional[Sequence[float]] = None,
                  hi_fraction: float = 0.0, hi_priority: int = 1,
                  min_len: int = 4, max_len: int = 24, vocab: int = 256,
                  shared_prefix: int = 0,
                  max_new_tokens: Optional[int] = None) -> list[Arrival]:
    """Build a complete workload: arrival process x synthetic prompts x
    a two-class priority mix (a ``hi_fraction`` of requests at
    ``hi_priority``, the rest at 0 — interactive vs batch traffic)."""
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        times = poisson_arrivals(rate_rps, n, rng)
    elif kind == "bursty":
        times = bursty_arrivals(rate_rps, n, rng, burst=burst)
    elif kind == "trace":
        times = trace_arrivals(trace if trace is not None else [])
        if len(times) < n:
            raise ValueError(f"trace holds {len(times)} arrivals, need {n}")
        times = times[:n]
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    prompts = synthetic_prompts(n, rng, min_len=min_len, max_len=max_len,
                                vocab=vocab, shared_prefix=shared_prefix)
    hi = rng.random(n) < hi_fraction
    return [Arrival(t=times[i], prompt=prompts[i],
                    max_new_tokens=max_new_tokens,
                    priority=hi_priority if hi[i] else 0)
            for i in range(n)]
