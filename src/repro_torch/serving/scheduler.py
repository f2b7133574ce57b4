"""Admission + slot policy layer (counterpart of the reference's
``serving/scheduler.py``): who is admitted next, and whether prefill may
preempt decode this iteration.

Framework-free: a scheduler sees only host-side request bookkeeping
(uids, priorities, timestamps, token counts) and returns decisions.  The
engine consults it at two seams:

1. **selection** — ``select(queue, now)`` returns the *index* into the
   admission queue of the next request to admit (``None`` = admit nothing
   this iteration);
2. **preemption gating** — ``allow_prefill(decoding, now)`` is asked before
   any prefill work when slots are actively decoding.  The engine never
   gates an idle pool.

``FifoScheduler`` is the default: strict FIFO, prefill always allowed.
``SloScheduler`` adds priority classes with per-class TTFT/TPOT targets,
least-slack-first ordering, aging (starvation-freeness), and slack-gated
prefill preemption of decode.  Both carry their adaptive state in
``state_dict`` / ``load_state_dict`` (what a snapshot of the engine saves).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Scheduler(Protocol):
    """The policy contract the engine drives (see module docstring).

    ``queue`` and ``decoding`` entries are ``Request``-shaped: the policy
    may read ``uid``, ``priority``, ``t_enqueue``, ``t_first_token`` and
    ``output`` — nothing else, and it must mutate nothing."""

    def select(self, queue: Sequence, now: float) -> Optional[int]:
        """Index into ``queue`` of the next request to admit, or None."""
        ...

    def allow_prefill(self, decoding: Sequence, now: float) -> bool:
        """May prefill preempt the ``decoding`` slots this iteration?"""
        ...

    def observe_prefill(self, dt_s: float) -> None:
        """Measured wall time of one admission/chunk burst."""
        ...


class FifoScheduler:
    """Strict FIFO admission, prefill always allowed."""

    def select(self, queue: Sequence, now: float) -> Optional[int]:
        return 0 if queue else None

    def allow_prefill(self, decoding: Sequence, now: float) -> bool:
        return True

    def observe_prefill(self, dt_s: float) -> None:
        pass

    # FIFO carries no adaptive state
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class SloClass:
    """Service targets of one priority class (``inf`` = no target)."""
    ttft_ms: float = math.inf     # queue + first-token deadline
    tpot_ms: float = math.inf     # per-token cadence once decoding

    @property
    def ttft_s(self) -> float:
        return self.ttft_ms / 1e3

    @property
    def tpot_s(self) -> float:
        return self.tpot_ms / 1e3


class SloScheduler:
    """SLO-aware admission: priority classes, least-TTFT-slack-first
    ordering, aging, and slack-gated prefill preemption of decode.

    **Selection.**  Requests order by *effective priority* (the submitted
    ``priority`` plus one level per ``aging_s`` seconds waited, so no
    class starves forever), then by TTFT slack (``t_enqueue +
    ttft_target - now``, most overdue first), then by uid (FIFO within a
    class).

    **Preemption gating.**  A prefill burst stalls every decoding slot for
    about one chunk; ``allow_prefill`` permits it only when the tightest
    decoding slot can absorb the estimated stall without missing its TPOT
    cadence: slot ``i``'s next token is due at ``t_first_token + n_emitted
    x tpot_s`` and the stall estimate is an EWMA of measured admission
    bursts (``observe_prefill``).  After ``max_defer`` consecutive
    deferrals prefill runs anyway: admission is throttled, never starved.
    """

    def __init__(self, classes: Optional[dict[int, SloClass]] = None,
                 *, default: SloClass = SloClass(), aging_s: float = 0.0,
                 max_defer: int = 8, ewma: float = 0.5):
        if max_defer < 1:
            raise ValueError(f"max_defer must be >= 1, got {max_defer}")
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self.classes = dict(classes or {})
        self.default = default
        self.aging_s = aging_s
        self.max_defer = max_defer
        self.ewma = ewma
        self._stall_est_s = 0.0       # EWMA of measured admission bursts
        self._defers = 0              # consecutive gated iterations

    def class_of(self, priority: int) -> SloClass:
        return self.classes.get(priority, self.default)

    # -- selection ---------------------------------------------------------
    def _rank(self, req, now: float):
        wait = now - req.t_enqueue
        eff = req.priority
        if self.aging_s > 0 and wait > 0:
            eff += int(wait / self.aging_s)
        slack = req.t_enqueue + self.class_of(req.priority).ttft_s - now
        return (-eff, slack, req.uid)

    def select(self, queue: Sequence, now: float) -> Optional[int]:
        if not queue:
            return None
        return min(range(len(queue)), key=lambda i: self._rank(queue[i], now))

    # -- preemption gating -------------------------------------------------
    def _decode_slack_s(self, decoding: Sequence, now: float) -> float:
        """Seconds until the tightest decoding slot misses its TPOT cadence
        (inf when no decoding slot carries a TPOT target)."""
        slack = math.inf
        for req in decoding:
            tpot = self.class_of(req.priority).tpot_s
            if math.isinf(tpot):
                continue
            due = req.t_first_token + len(req.output) * tpot
            slack = min(slack, due - now)
        return slack

    def allow_prefill(self, decoding: Sequence, now: float) -> bool:
        if self._decode_slack_s(decoding, now) >= self._stall_est_s:
            self._defers = 0
            return True
        self._defers += 1
        if self._defers >= self.max_defer:   # bounded deferral
            self._defers = 0
            return True
        return False

    def observe_prefill(self, dt_s: float) -> None:
        if self._stall_est_s <= 0.0:
            self._stall_est_s = dt_s
        else:
            self._stall_est_s += self.ewma * (dt_s - self._stall_est_s)

    # -- snapshot state ------------------------------------------------------
    def state_dict(self) -> dict:
        """The adaptive state a crash would lose: the EWMA stall estimate and
        the deferral counter decide which iteration admits next.  (Aging
        needs none: it derives from each request's ``t_enqueue``.)"""
        return {"stall_est_s": self._stall_est_s, "defers": self._defers}

    def load_state_dict(self, state: dict) -> None:
        self._stall_est_s = float(state.get("stall_est_s", 0.0))
        self._defers = int(state.get("defers", 0))
