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
"""
from __future__ import annotations

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
