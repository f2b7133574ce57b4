"""TPU adaptation of the paper's mapping methodology (DESIGN.md §3).

Two transfers of the paper's ideas to the homogeneous TPU mesh:

1. **SFC device ordering** (paper §3.2 → torus ICI): quantify the hop cost
   of ring collectives for different logical→physical device orderings of
   the 16×16 pod, exactly as the paper scores chiplet placements by NoI
   hop counts.  ``ring_hop_cost`` is used by launch/mesh.py's
   ``sfc_order`` option and reported in EXPERIMENTS.md.

2. **MappingSearch** (paper §3.3 → sharding space): the paper MOOs chiplet
   placement under fixed workload traffic; with fixed hardware we search
   *workload placements* (sharding-plan knobs) scoring candidates by the
   three-term roofline from the compiled HLO — same MOO-STAGE machinery,
   congestion-style objectives (collective seconds ≈ μ·link-utilisation).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import numpy as np

from repro_torch.core.sfc import CURVES, curve_positions


# ---------------------------------------------------------------------------
# 1. SFC ordering of the TPU torus
# ---------------------------------------------------------------------------

def _torus_hops(a: tuple, b: tuple, w: int, h: int) -> int:
    dx = abs(a[0] - b[0])
    dy = abs(a[1] - b[1])
    return min(dx, w - dx) + min(dy, h - dy)


def ring_hop_cost(order_name: str, w: int = 16, h: int = 16,
                  axis: str = "model") -> dict:
    """Physical ICI hops used by a ring collective over one mesh axis when
    logical devices are enumerated along the given curve.

    Returns per-step hop stats — a ring all-gather/reduce-scatter moves
    data along consecutive logical devices, so consecutive-pair distance on
    the physical torus is the congestion metric (cf. paper eq. 11-13)."""
    pos = curve_positions(order_name, w, h)          # logical id -> (x, y)
    # the "model" axis = contiguous runs of 16 logical ids (row-major mesh)
    hops = []
    if axis == "model":
        for row in range(h):
            ids = range(row * w, (row + 1) * w)
            ring = list(ids) + [row * w]
            for a, b in zip(ring[:-1], ring[1:]):
                hops.append(_torus_hops(tuple(pos[a]), tuple(pos[b]), w, h))
    else:  # data axis: stride-w rings
        for col in range(w):
            ids = [r * w + col for r in range(h)]
            ring = ids + [ids[0]]
            for a, b in zip(ring[:-1], ring[1:]):
                hops.append(_torus_hops(tuple(pos[a]), tuple(pos[b]), w, h))
    hops = np.asarray(hops)
    return {"curve": order_name, "axis": axis, "mean_hops": float(hops.mean()),
            "max_hops": int(hops.max()), "total_hops": int(hops.sum())}


def compare_device_orders(w: int = 16, h: int = 16) -> list[dict]:
    out = []
    for name in CURVES:
        for axis in ("model", "data"):
            out.append(ring_hop_cost(name, w, h, axis))
    return out


# ---------------------------------------------------------------------------
# 2. MappingSearch over sharding-plan knobs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MappingKnobs:
    """The discrete sharding/layout design space (λ for the TPU plane)."""
    seq_shard: bool = True          # SP residual stream over `model`
    heads_policy: str = "auto"      # auto | heads | seq
    accum: int = 1                  # grad-accumulation microbatches
    remat_policy: str = "none"      # none | dots
    moe_dispatch: str = "gather"    # gather | a2a  (hillclimb lever)

    def neighbors(self) -> list["MappingKnobs"]:
        out = []
        for f, vals in [("seq_shard", (True, False)),
                        ("heads_policy", ("auto", "heads", "seq")),
                        ("accum", (1, 2, 4)),
                        ("remat_policy", ("none", "dots")),
                        ("moe_dispatch", ("gather", "a2a"))]:
            for v in vals:
                if getattr(self, f) != v:
                    out.append(dataclasses.replace(self, **{f: v}))
        return out


@dataclasses.dataclass
class MappingResult:
    knobs: MappingKnobs
    objectives: tuple           # (step_s, collective_s, live_bytes)
    report: Optional[object] = None


def mapping_search(evaluate: Callable[[MappingKnobs], tuple], *,
                   start: MappingKnobs = MappingKnobs(),
                   budget: int = 12) -> list[MappingResult]:
    """Greedy Pareto local search over the knob space (the base search of
    MOO-STAGE; the space is small enough that the surrogate meta-search is
    unnecessary — noted difference from Plane B)."""
    from repro_torch.core.moo import dominates

    seen = {start: evaluate(start)}
    frontier = [start]
    evals = 1
    while frontier and evals < budget:
        cur = frontier.pop(0)
        for cand in cur.neighbors():
            if cand in seen or evals >= budget:
                continue
            seen[cand] = evaluate(cand)
            evals += 1
            if dominates(seen[cand], seen[cur]):
                frontier.append(cand)
    results = [MappingResult(k, o) for k, o in seen.items()]
    pareto = [r for r in results
              if not any(dominates(o.objectives, r.objectives)
                         for o in results if o is not r)]
    return sorted(pareto, key=lambda r: r.objectives[0])
