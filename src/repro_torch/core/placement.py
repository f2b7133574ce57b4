"""NoI design variables λ = (λc, λl): chiplet placement + link graph (§3.3).

Constraints (paper): (1) the NoI connects all chiplets (no islands);
(2) link count ≤ the 2-D mesh budget.  Moves used by every MOO solver:
swap two chiplet positions, remove a link, add a (short-range) link.
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import deque

import numpy as np

from repro_torch.core.chiplets import SYSTEM_ALLOC
from repro_torch.core.sfc import curve_positions


@dataclasses.dataclass
class Placement:
    """λc: grid of chiplet types + role id lists; λl: set of links."""
    grid_w: int
    grid_h: int
    types: list[str]                  # per cell: "SM"|"MC"|"DRAM"|"ReRAM"|...
    links: set                        # {(a, b)} a<b cell ids
    reram_order: list[int]            # SFC order of the ReRAM macro (dataflow)

    @property
    def n(self) -> int:
        return self.grid_w * self.grid_h

    def roles(self) -> dict[str, list[int]]:
        out: dict[str, list[int]] = {}
        for i, t in enumerate(self.types):
            out.setdefault(t, []).append(i)
        if self.reram_order:
            out["ReRAM"] = list(self.reram_order)
        return out

    def xy(self, i: int) -> tuple[int, int]:
        return i % self.grid_w, i // self.grid_w

    def copy(self) -> "Placement":
        return Placement(self.grid_w, self.grid_h, list(self.types),
                         set(self.links), list(self.reram_order))

    def connected(self) -> bool:
        if not self.links:
            return self.n == 1
        adj: dict[int, list[int]] = {}
        for a, b in self.links:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        seen = {0}
        q = deque([0])
        while q:
            u = q.popleft()
            for v in adj.get(u, ()):  # noqa: B905
                if v not in seen:
                    seen.add(v)
                    q.append(v)
        return len(seen) == self.n


def mesh_links(w: int, h: int) -> set:
    links = set()
    for y in range(h):
        for x in range(w):
            i = y * w + x
            if x + 1 < w:
                links.add((i, i + 1))
            if y + 1 < h:
                links.add((i, i + w))
    return links


def grid_for(n_chiplets: int) -> tuple[int, int]:
    w = int(math.isqrt(n_chiplets))
    while n_chiplets % w:
        w -= 1
    return max(w, n_chiplets // w), min(w, n_chiplets // w)


def initial_placement(n_chiplets: int, *, curve: str = "boustrophedon",
                      extra: dict | None = None,
                      seed: int = 0) -> Placement:
    """2.5D-HI seed design: ReRAM macro laid along an SFC, MC/DRAM pairs
    adjacent, SM clusters blocked around their MC (§3.2 placement logic)."""
    alloc = dict(SYSTEM_ALLOC.get(n_chiplets) or {})
    if not alloc:
        raise ValueError(f"no Table-2 allocation for {n_chiplets} chiplets")
    if extra:
        alloc.update(extra)
    w, h = grid_for(n_chiplets)
    pos_order = [int(y * w + x) for x, y in curve_positions(curve, w, h)]

    types = ["SM"] * (w * h)
    # walk the SFC: first the ReRAM macro (contiguous), then MC+DRAM pairs,
    # SMs fill the rest
    cursor = 0
    reram_cells = []
    for _ in range(alloc["ReRAM"]):
        reram_cells.append(pos_order[cursor])
        cursor += 1
    mc_cells, dram_cells = [], []
    for _ in range(alloc["MC"]):
        mc_cells.append(pos_order[cursor]); cursor += 1
        dram_cells.append(pos_order[cursor]); cursor += 1
    for c in reram_cells:
        types[c] = "ReRAM"
    for c in mc_cells:
        types[c] = "MC"
    for c in dram_cells:
        types[c] = "DRAM"
    return Placement(w, h, types, mesh_links(w, h), reram_cells)


def random_placement(n_chiplets: int, rng: random.Random,
                     extra: dict | None = None) -> Placement:
    p = initial_placement(n_chiplets, extra=extra)
    cells = list(range(p.n))
    rng.shuffle(cells)
    old_types = list(p.types)
    order = sorted(range(p.n))
    for new_cell, old_cell in zip(cells, order):
        p.types[new_cell] = old_types[old_cell]
    p.reram_order = [c for c in cells if p.types[c] == "ReRAM"]
    return p


# ---------------------------------------------------------------------------
# neighbourhood moves (shared by local search / AMOSA / NSGA-II mutation)
# ---------------------------------------------------------------------------

def neighbors(p: Placement, rng: random.Random, k: int = 8) -> list[Placement]:
    out = []
    mesh_budget = len(mesh_links(p.grid_w, p.grid_h))
    for _ in range(k):
        q = p.copy()
        move = rng.random()
        if move < 0.5:  # swap two chiplets
            a, b = rng.sample(range(q.n), 2)
            q.types[a], q.types[b] = q.types[b], q.types[a]
            remap = {a: b, b: a}
            q.reram_order = [remap.get(c, c) for c in q.reram_order]
        elif move < 0.75 and len(q.links) > q.n - 1:  # drop a link
            q.links.discard(rng.choice(sorted(q.links)))
            if not q.connected():
                continue
        else:  # add a short-range link under the mesh budget
            if len(q.links) >= mesh_budget:
                continue
            a = rng.randrange(q.n)
            ax, ay = q.xy(a)
            bx = min(max(ax + rng.randint(-2, 2), 0), q.grid_w - 1)
            by = min(max(ay + rng.randint(-2, 2), 0), q.grid_h - 1)
            b = by * q.grid_w + bx
            if a != b:
                q.links.add((min(a, b), max(a, b)))
        out.append(q)
    return out


def design_features(p: Placement) -> np.ndarray:
    """Summary features for the MOO-STAGE surrogate (core/rf.py)."""
    roles = p.roles()
    xy = np.array([p.xy(i) for i in range(p.n)], float)

    def centroid(ids):
        return xy[ids].mean(axis=0) if ids else np.zeros(2)

    def mean_dist(src, dst):
        if not src or not dst:
            return 0.0
        a, b = xy[src], xy[dst]
        return float(np.abs(a[:, None, :] - b[None, :, :]).sum(-1).mean())

    rer = roles.get("ReRAM", [])
    contig = 0.0
    if len(rer) > 1:
        pts = xy[rer]
        contig = float(np.abs(np.diff(pts, axis=0)).sum(1).mean())
    feats = [
        mean_dist(roles.get("SM", []), roles.get("MC", [])),
        mean_dist(roles.get("MC", []), roles.get("DRAM", [])),
        mean_dist(roles.get("MC", []), rer[:1]),
        contig,
        len(p.links) / max(len(mesh_links(p.grid_w, p.grid_h)), 1),
        float(np.linalg.norm(centroid(roles.get("SM", []))
                             - centroid(roles.get("MC", [])))),
        float(np.linalg.norm(centroid(rer) - centroid(roles.get("MC", []))))
        if rer else 0.0,
        float(len(rer)),
    ]
    return np.asarray(feats, dtype=np.float64)
