"""Multi-objective optimisation of the NoI design (§3.3).

Implements the paper's solver — **MOO-STAGE** (learned evaluation function
over local-search trajectories, random-forest surrogate, Pareto-hypervolume
objective [10][39]) — plus the reference solvers it is compared against in
the cited literature: AMOSA-style archived simulated annealing [40] and an
NSGA-II-style evolutionary loop [42].  All share the same move set
(core/placement.neighbors) and objective evaluator, so benchmark
comparisons are solver-only.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.placement import Placement, design_features, neighbors, random_placement
from repro_torch.core.rf import RandomForest


# ---------------------------------------------------------------------------
# Pareto utilities (minimisation)
# ---------------------------------------------------------------------------

def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


def pareto_front(points: list) -> list[int]:
    """Indices of non-dominated points."""
    idx = []
    for i, p in enumerate(points):
        if not any(dominates(q, p) for j, q in enumerate(points) if j != i):
            idx.append(i)
    return idx


def hypervolume(points: np.ndarray, ref: np.ndarray, n_mc: int = 4096,
                seed: int = 0) -> float:
    """Pareto-hypervolume (PHV), minimisation, w.r.t. reference point.

    Exact sweep in 2-D; Monte-Carlo for ≥3 objectives (the paper's 3D-HI
    MOO has 4)."""
    pts = np.asarray([p for p in points if np.all(p <= ref)], float)
    if len(pts) == 0:
        return 0.0
    d = pts.shape[1]
    if d == 2:
        # sweep left→right; each non-dominated point adds a rectangle
        pts = pts[np.argsort(pts[:, 0])]
        hv = 0.0
        cur_y = ref[1]
        for x, y in pts:
            if y < cur_y:
                hv += (ref[0] - x) * (cur_y - y)
                cur_y = y
        return float(hv)
    rng = np.random.default_rng(seed)
    lo = pts.min(axis=0)
    samples = lo + rng.random((n_mc, d)) * (ref - lo)
    dominated = np.zeros(n_mc, bool)
    for p in pts:
        dominated |= np.all(samples >= p, axis=1)
    vol = np.prod(ref - lo)
    return float(dominated.mean() * vol)


@dataclasses.dataclass
class Archive:
    """Pareto archive of (design, objectives)."""
    designs: list = dataclasses.field(default_factory=list)
    objs: list = dataclasses.field(default_factory=list)

    def add(self, d, o) -> bool:
        o = tuple(float(x) for x in o)
        if any(not np.isfinite(x) for x in o):
            return False
        if any(dominates(e, o) for e in self.objs):
            return False
        keep = [i for i, e in enumerate(self.objs) if not dominates(o, e)]
        self.designs = [self.designs[i] for i in keep] + [d]
        self.objs = [self.objs[i] for i in keep] + [o]
        return True

    def phv(self, ref) -> float:
        if not self.objs:
            return 0.0
        return hypervolume(np.asarray(self.objs), np.asarray(ref, float))


# ---------------------------------------------------------------------------
# greedy Pareto local search (the "base search" in MOO-STAGE)
# ---------------------------------------------------------------------------

def local_search(start: Placement, objective_fn: Callable, archive: Archive,
                 rng: random.Random, max_steps: int = 40,
                 trajectory: list | None = None) -> Placement:
    cur = start
    cur_obj = objective_fn(cur)
    archive.add(cur, cur_obj)
    if trajectory is not None:
        trajectory.append((cur, cur_obj))
    for _ in range(max_steps):
        improved = False
        for cand in neighbors(cur, rng):
            o = objective_fn(cand)
            archive.add(cand, o)
            if trajectory is not None:
                trajectory.append((cand, o))
            if dominates(o, cur_obj):
                cur, cur_obj = cand, o
                improved = True
                break
        if not improved:
            break
    return cur


# ---------------------------------------------------------------------------
# MOO-STAGE (paper §3.3, [39])
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MooStageResult:
    archive: Archive
    phv_history: list
    n_evals: int


def moo_stage(n_chiplets: int, objective_fn: Callable, ref_point,
              *, iterations: int = 6, seed: int = 0,
              meta_candidates: int = 24, extra_alloc: dict | None = None,
              ls_steps: int = 30) -> MooStageResult:
    """Iterate: (1) pick a start state by maximising the learned PHV
    predictor over candidate starts (meta search); (2) run greedy Pareto
    local search (base search); (3) add (trajectory design → resulting PHV)
    regression examples and refit the random forest."""
    rng = random.Random(seed)
    archive = Archive()
    surrogate = RandomForest(seed=seed)
    X_train: list[np.ndarray] = []
    y_train: list[float] = []
    phv_hist = []
    n_evals = 0

    for it in range(iterations):
        cands = [random_placement(n_chiplets, rng, extra=extra_alloc)
                 for _ in range(meta_candidates)]
        if X_train:
            feats = np.stack([design_features(c) for c in cands])
            scores = surrogate.predict(feats)
            start = cands[int(np.argmax(scores))]
        else:
            start = cands[0]

        traj: list = []
        local_search(start, objective_fn, archive, rng, max_steps=ls_steps,
                     trajectory=traj)
        n_evals += len(traj)
        phv = archive.phv(ref_point)
        phv_hist.append(phv)
        for d, _ in traj:
            X_train.append(design_features(d))
            y_train.append(phv)
        surrogate.fit(np.stack(X_train), np.asarray(y_train))
    return MooStageResult(archive, phv_hist, n_evals)


# ---------------------------------------------------------------------------
# AMOSA-style archived simulated annealing [40]
# ---------------------------------------------------------------------------

def amosa(n_chiplets: int, objective_fn: Callable, ref_point, *,
          steps: int = 200, t0: float = 1.0, cooling: float = 0.97,
          seed: int = 0, extra_alloc: dict | None = None) -> MooStageResult:
    rng = random.Random(seed)
    archive = Archive()
    cur = random_placement(n_chiplets, rng, extra=extra_alloc)
    cur_obj = objective_fn(cur)
    archive.add(cur, cur_obj)
    T = t0
    phv_hist = []
    scale = np.asarray(ref_point, float)
    for s in range(steps):
        cand = neighbors(cur, rng, k=1)
        if not cand:
            continue
        cand = cand[0]
        o = objective_fn(cand)
        archive.add(cand, o)
        delta = float(np.mean((np.asarray(o) - np.asarray(cur_obj)) / scale))
        if delta <= 0 or rng.random() < np.exp(-delta / max(T, 1e-9)):
            cur, cur_obj = cand, o
        T *= cooling
        if (s + 1) % 25 == 0:
            phv_hist.append(archive.phv(ref_point))
    return MooStageResult(archive, phv_hist, steps)


# ---------------------------------------------------------------------------
# NSGA-II-style evolutionary loop [42]
# ---------------------------------------------------------------------------

def _crowding(objs: np.ndarray) -> np.ndarray:
    n, m = objs.shape
    dist = np.zeros(n)
    for k in range(m):
        order = np.argsort(objs[:, k])
        dist[order[0]] = dist[order[-1]] = np.inf
        rng_ = objs[order[-1], k] - objs[order[0], k] or 1.0
        for i in range(1, n - 1):
            dist[order[i]] += (objs[order[i + 1], k] - objs[order[i - 1], k]) / rng_
    return dist


def nsga2(n_chiplets: int, objective_fn: Callable, ref_point, *,
          pop: int = 16, generations: int = 12, seed: int = 0,
          extra_alloc: dict | None = None) -> MooStageResult:
    rng = random.Random(seed)
    archive = Archive()
    population = [random_placement(n_chiplets, rng, extra=extra_alloc)
                  for _ in range(pop)]
    objs = [objective_fn(p) for p in population]
    for p, o in zip(population, objs):
        archive.add(p, o)
    phv_hist = []
    n_evals = pop
    for g in range(generations):
        children = []
        for p in population:
            children += neighbors(p, rng, k=1)
        c_objs = [objective_fn(c) for c in children]
        n_evals += len(children)
        for c, o in zip(children, c_objs):
            archive.add(c, o)
        allp = population + children
        allo = objs + c_objs
        # non-dominated sort (two fronts suffice at this pop size)
        front = pareto_front(allo)
        rest = [i for i in range(len(allp)) if i not in front]
        chosen = list(front)[:pop]
        if len(chosen) < pop and rest:
            ro = np.asarray([allo[i] for i in rest])
            cd = _crowding(ro)
            order = np.argsort(-cd)
            chosen += [rest[i] for i in order[:pop - len(chosen)]]
        population = [allp[i] for i in chosen]
        objs = [allo[i] for i in chosen]
        phv_hist.append(archive.phv(ref_point))
    return MooStageResult(archive, phv_hist, n_evals)
