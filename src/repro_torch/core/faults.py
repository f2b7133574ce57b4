"""Fault injection for the chiplet fabric: link/router/chiplet failures,
bandwidth derating, and deterministic seeded scenario sampling.

Chiplet platforms are exactly where faults live: interposer link defects,
router wear-out, and ReRAM endurance limits mean a NoI tuned only for the
fault-free case can degrade catastrophically when a single link drops.
This module defines the fault *vocabulary* the rest of Plane B speaks:

- :class:`FaultScenario` — one concrete failure set (links down, chiplets
  down, links bandwidth-derated).  Frozen/hashable so scenario lists can
  be cached and compared.
- :class:`FaultModel` — a distribution over scenarios with deterministic
  seeded sampling (``sample_scenarios``) and the exhaustive single-fault
  enumerations the resilience benchmarks sweep
  (``all_link_scenarios``).  Sampling is a pure function of
  (placement link set, seed), so the same design always sees the same
  scenario set — MOO archives stay comparable across evaluations.
- :class:`DisconnectedFabric` — the explicit error raised when a faulted
  fabric cannot route a required flow (``core.noi.evaluate_noi`` returns
  a ``NoIEval`` with ``disconnected=True``; the simulators raise this
  instead of reporting a bogus finite time).
- ``endurance_link_weights`` — the optional wear-driven failure
  distribution: per-link failure weight proportional to the byte-hops the
  *measured* traffic pushes through the link, with links touching the
  ReRAM macro up-weighted by the §4.4 endurance argument (dynamic-operand
  rewrites are what exhausts ReRAM cells — see
  ``baselines.retransformer_endurance`` / ``benchmarks.sec44_endurance``).

Routing semantics (implemented in ``core/noi.py``): a failed link is
removed from the graph; a failed chiplet (router-down == chiplet-down at
the NoI level) loses *all* its links and is dropped from the role map, so
its traffic share redistributes over the surviving same-role chiplets; a
derated link keeps routing but serialises at ``bw_factor`` of the nominal
link bandwidth.  Shortest surviving paths are recomputed per scenario.
"""
from __future__ import annotations

import dataclasses
import random
from itertools import combinations
from typing import Iterable, Optional, Sequence


class DisconnectedFabric(RuntimeError):
    """A fault scenario left the fabric unable to route required traffic.

    Raised by the simulators (``simulate_generation`` & friends) when the
    surviving link graph cannot carry a phase's flows; ``evaluate_noi``
    itself reports it as ``NoIEval.disconnected`` so MOO archives can
    reject the design without exception plumbing."""


def _norm_link(link) -> tuple:
    a, b = link
    return (min(int(a), int(b)), max(int(a), int(b)))


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One concrete failure set applied to a Placement.

    ``derated_links`` maps link → bandwidth factor in (0, 1]; failed
    links/chiplets are removed from routing entirely.  The empty scenario
    (``FaultScenario()``) is the fault-free fabric and evaluates
    bit-identically to no scenario at all."""
    failed_links: frozenset = frozenset()
    failed_chiplets: frozenset = frozenset()
    derated_links: tuple = ()           # sorted ((a, b), factor) pairs
    label: str = ""

    @classmethod
    def make(cls, failed_links: Iterable = (), failed_chiplets: Iterable = (),
             derated_links: Optional[dict] = None,
             label: str = "") -> "FaultScenario":
        der = tuple(sorted((_norm_link(l), float(f))
                           for l, f in (derated_links or {}).items()))
        for _, f in der:
            if not (0.0 < f <= 1.0):
                raise ValueError(f"bandwidth derate factor must be in (0, 1], got {f}")
        return cls(frozenset(_norm_link(l) for l in failed_links),
                   frozenset(int(c) for c in failed_chiplets), der, label)

    @property
    def is_nominal(self) -> bool:
        return not (self.failed_links or self.failed_chiplets
                    or self.derated_links)

    def surviving_links(self, links: Iterable) -> set:
        """Links of a placement that survive this scenario."""
        down = self.failed_chiplets
        return {l for l in (_norm_link(x) for x in links)
                if l not in self.failed_links
                and l[0] not in down and l[1] not in down}

    def derate_of(self, link) -> float:
        link = _norm_link(link)
        for l, f in self.derated_links:
            if l == link:
                return f
        return 1.0


NOMINAL = FaultScenario(label="nominal")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """A seeded distribution over fault scenarios.

    ``k_links`` / ``k_chiplets`` are the number of simultaneous failures
    per sampled scenario; ``bw_derate`` < 1 additionally derates
    ``k_derated`` surviving links to that bandwidth factor (0 disables).
    ``link_weights`` (optional, aligned with ``sorted(placement.links)``)
    biases which links fail — e.g. the endurance-driven wear weights from
    ``endurance_link_weights``.  Sampling is deterministic in
    (link set, seed): the same design always draws the same scenarios."""
    k_links: int = 1
    k_chiplets: int = 0
    k_derated: int = 0
    bw_derate: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.k_links < 0 or self.k_chiplets < 0 or self.k_derated < 0:
            raise ValueError("fault counts must be >= 0")
        if not (0.0 < self.bw_derate <= 1.0):
            raise ValueError(f"bw_derate must be in (0, 1], got {self.bw_derate}")

    def _rng_for(self, links: Sequence[tuple]) -> random.Random:
        # deterministic in the link *set* (int tuples hash stably), the
        # seed, and nothing else — scenario draws are reproducible per
        # design across processes
        key = (self.seed, tuple(sorted(links)))
        return random.Random(repr(key))

    def sample_scenarios(self, placement, n_scenarios: int,
                         link_weights: Optional[Sequence[float]] = None,
                         ) -> list[FaultScenario]:
        """Draw ``n_scenarios`` deterministic scenarios for a placement.

        Each scenario fails ``k_links`` distinct links (weighted by
        ``link_weights`` when given), ``k_chiplets`` distinct chiplets,
        and derates ``k_derated`` further links to ``bw_derate``.
        Duplicate draws are kept (they are what the distribution says);
        an empty fabric or k larger than the link count yields the
        all-links-failed scenario."""
        links = sorted(_norm_link(l) for l in placement.links)
        rng = self._rng_for(links)
        if link_weights is not None and len(link_weights) != len(links):
            raise ValueError(
                f"link_weights length {len(link_weights)} != "
                f"{len(links)} links")
        out = []
        n_cells = placement.n
        for s in range(n_scenarios):
            failed = self._draw_links(rng, links, self.k_links, link_weights)
            chips = (rng.sample(range(n_cells),
                                min(self.k_chiplets, n_cells))
                     if self.k_chiplets else [])
            derated = {}
            if self.k_derated and self.bw_derate < 1.0:
                alive = [l for l in links if l not in failed]
                for l in self._draw_links(rng, alive,
                                          min(self.k_derated, len(alive)),
                                          None):
                    derated[l] = self.bw_derate
            out.append(FaultScenario.make(failed, chips, derated,
                                          label=f"sample{s}"))
        return out

    @staticmethod
    def _draw_links(rng: random.Random, links: Sequence[tuple], k: int,
                    weights: Optional[Sequence[float]]) -> set:
        k = min(k, len(links))
        if k <= 0 or not links:
            return set()
        if weights is None:
            return set(rng.sample(list(links), k))
        # weighted sampling without replacement (small k, small fabrics)
        pool = list(links)
        w = [max(float(x), 0.0) for x in weights]
        chosen: set = set()
        for _ in range(k):
            total = sum(w)
            if total <= 0.0:
                chosen.update(rng.sample(pool, k - len(chosen)))
                break
            r = rng.random() * total
            acc = 0.0
            idx = len(pool) - 1
            for i, wi in enumerate(w):
                acc += wi
                if r <= acc:
                    idx = i
                    break
            chosen.add(pool.pop(idx))
            w.pop(idx)
        return chosen


def all_link_scenarios(placement, k: int = 1,
                       max_scenarios: int = 0) -> list[FaultScenario]:
    """Exhaustive k-link-failure scenarios of a placement (every size-k
    subset of its links).  ``max_scenarios`` > 0 caps the enumeration
    (deterministically: lexicographic order over the sorted link list) so
    k=2 sweeps on dense fabrics stay bounded."""
    links = sorted(_norm_link(l) for l in placement.links)
    out = []
    for combo in combinations(links, min(k, len(links))):
        out.append(FaultScenario.make(combo, label="+".join(map(str, combo))))
        if max_scenarios and len(out) >= max_scenarios:
            break
    return out


def all_chiplet_scenarios(placement, k: int = 1,
                          max_scenarios: int = 0) -> list[FaultScenario]:
    """Exhaustive k-chiplet-loss scenarios of a placement (every size-k
    subset of its cells) — the MTTR sweeps' ground truth: each scenario
    drops the chiplets from the role map (traffic redistributes over the
    surviving same-role members; wiping a whole role disconnects) and
    removes their links.  ``max_scenarios`` > 0 caps the enumeration
    deterministically (lexicographic cell order)."""
    out = []
    for combo in combinations(range(placement.n), min(k, placement.n)):
        out.append(FaultScenario.make(
            failed_chiplets=combo,
            label="chip" + "+".join(map(str, combo))))
        if max_scenarios and len(out) >= max_scenarios:
            break
    return out


def endurance_link_weights(placement, phases,
                           reram_wear_factor: float = 4.0) -> list[float]:
    """Per-link failure weights driven by measured traffic wear (§4.4).

    Weight of each link (aligned with ``sorted(placement.links)``) is the
    repeat-weighted bytes the phase list pushes through it — switching
    activity is what wears interposer links and router buffers — with
    links incident to ReRAM chiplets multiplied by ``reram_wear_factor``:
    the endurance-limited macro (``RERAM.write_endurance``,
    ``baselines.retransformer_endurance``) makes wear accumulated at its
    boundary disproportionately likely to surface as a failure.  A
    uniform floor keeps never-used links sampleable (defects do not care
    about traffic)."""
    from repro_torch.core.noi import evaluate_noi

    ev = evaluate_noi(placement, phases)
    links = sorted(_norm_link(l) for l in placement.links)
    if ev.disconnected or not ev.per_phase_link_bytes:
        return [1.0] * len(links)
    per_link = [0.0] * len(links)
    for ph, u in zip(phases, ev.per_phase_link_bytes):
        for i, b in enumerate(u):
            per_link[i] += float(b) * ph.repeat
    total = sum(per_link)
    if total <= 0.0:
        return [1.0] * len(links)
    rerams = set(placement.roles().get("ReRAM", []))
    floor = 0.05 * total / max(len(links), 1)
    out = []
    for link, b in zip(links, per_link):
        w = b + floor
        if link[0] in rerams or link[1] in rerams:
            w *= reram_wear_factor
        out.append(w)
    return out
