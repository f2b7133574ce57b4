"""NoI evaluation: routing, link utilisation u_k, μ(λ), σ(λ) (eqs 11-15).

Routing is shortest-path (BFS) over the candidate link graph — the paper's
NoI routers are a hierarchical wormhole fabric; at the utilisation-
objective level only the path→link incidence q_ijk matters (eq. 11).

Fault semantics (``scenario=`` — see ``core/faults.py``): a failed link is
removed from the routing graph; a failed chiplet loses all its links *and*
is dropped from the role map, so its traffic share redistributes over the
surviving same-role chiplets; a bandwidth-derated link keeps routing but
serialises slower (``NoIEval.link_bw_scale`` → ``noi_phase_time``).  When
the surviving graph cannot carry a required flow — or a whole role is
wiped out — the result is an explicit ``disconnected`` ``NoIEval`` (all
metrics inf), never a bogus finite time.  ``scenario=None`` (or the
nominal scenario) is bit-identical to the pre-fault evaluator.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.chiplets import LINK
from repro_torch.core.placement import Placement
from repro_torch.core.traffic import Phase, phase_traffic_matrix


def _paths(p: Placement, links=None) -> dict:
    """All-pairs BFS parents over ``links`` (default: every placement
    link): returns hop-path cache {src: parents array}."""
    adj: dict[int, list[int]] = {i: [] for i in range(p.n)}
    for a, b in (p.links if links is None else links):
        adj[a].append(b)
        adj[b].append(a)
    out = {}
    for s in range(p.n):
        par = np.full(p.n, -1, np.int32)
        par[s] = s
        q = deque([s])
        while q:
            u = q.popleft()
            for v in adj[u]:
                if par[v] < 0:
                    par[v] = u
                    q.append(v)
        out[s] = par
    return out


@dataclasses.dataclass
class NoIEval:
    mu: float                 # eq. 14 (time-avg of eq. 12)
    sigma: float              # eq. 15 (time-avg of eq. 13)
    max_util: float
    total_byte_hops: float
    mean_hops: float
    per_phase_link_bytes: list
    disconnected: bool = False       # no surviving route for some flow
    # per-link bandwidth factors aligned with per_phase_link_bytes columns
    # (sorted placement links); None = nominal bandwidth everywhere
    link_bw_scale: Optional[np.ndarray] = None


def _disconnected() -> NoIEval:
    return NoIEval(np.inf, np.inf, np.inf, np.inf, np.inf, [],
                   disconnected=True)


def evaluate_noi(p: Placement, phases: list[Phase],
                 roles_override: dict | None = None,
                 scenario=None) -> NoIEval:
    """Evaluate a placement's NoI under the phase traffic, optionally
    degraded by a ``core.faults.FaultScenario`` (failed links/chiplets
    removed from routing and roles, derated links slowed).  Statistics
    (μ, σ, max) run over the *surviving* links only."""
    if scenario is not None and scenario.is_nominal:
        scenario = None
    links = sorted(p.links)
    if scenario is None:
        if not p.connected():
            return _disconnected()
        alive_links = links
        roles = roles_override if roles_override is not None else p.roles()
        alive_mask = None
        bw_scale = None
    else:
        alive = scenario.surviving_links(links)
        alive_links = [l for l in links if l in alive]
        roles = dict(roles_override if roles_override is not None
                     else p.roles())
        if scenario.failed_chiplets:
            down = scenario.failed_chiplets
            for name, ids in list(roles.items()):
                kept = [i for i in ids if i not in down]
                if not kept:
                    # a whole role wiped out: no surviving chiplet can
                    # source/sink that traffic class
                    return _disconnected()
                roles[name] = kept
        alive_mask = np.array([l in alive for l in links], bool)
        if not alive_mask.any() and p.n > 1:
            return _disconnected()
        bw_scale = None
        if scenario.derated_links:
            bw_scale = np.ones(len(links))
            for l, f in scenario.derated_links:
                if l in alive:
                    bw_scale[links.index(l)] = f

    parents = _paths(p, links=alive_links) if scenario is not None \
        else _paths(p)
    link_idx = {l: i for i, l in enumerate(links)}

    mus, sigmas, weights, per_phase = [], [], [], []
    total_byte_hops = 0.0
    total_hops = 0
    n_flows = 0
    max_util = 0.0

    for ph in phases:
        F = phase_traffic_matrix(ph, roles, p.n)
        # u = per-link bytes for ONE execution of the phase (one timestamp
        # of eq. 12/13).  Repeats weight the time-average (eqs 14-15) — a
        # phase that runs k times contributes k identical timestamps — and
        # scale the energy byte-hops, but NOT the per-execution link time.
        u = np.zeros(len(links))
        for (i, j), bytes_ in F.items():
            par = parents[i]
            if par[j] < 0:
                return _disconnected()
            # walk j -> i collecting links (q_ijk in eq. 11)
            cur = j
            hops = 0
            while cur != i:
                prev = int(par[cur])
                u[link_idx[(min(cur, prev), max(cur, prev))]] += bytes_
                cur = prev
                hops += 1
            total_byte_hops += bytes_ * hops * ph.repeat
            total_hops += hops
            n_flows += 1
        us = u if alive_mask is None else u[alive_mask]
        # degenerate fabrics (single chiplet: no links at all) carry no
        # inter-chiplet traffic — their link stats are exactly zero, not
        # a NaN from an empty-array mean
        mus.append(float(us.mean()) if len(us) else 0.0)
        sigmas.append(float(us.std()) if len(us) else 0.0)
        weights.append(float(ph.repeat))
        max_util = max(max_util, float(us.max()) if len(us) else 0.0)
        per_phase.append(u)

    wsum = sum(weights) or 1.0
    return NoIEval(
        mu=float(np.dot(mus, weights) / wsum) if mus else 0.0,
        sigma=float(np.dot(sigmas, weights) / wsum) if sigmas else 0.0,
        max_util=max_util, total_byte_hops=total_byte_hops,
        mean_hops=total_hops / max(n_flows, 1),
        per_phase_link_bytes=per_phase,
        link_bw_scale=bw_scale)


def noi_phase_time(link_bytes: np.ndarray, bw_scale=None) -> float:
    """Serialisation time of a phase on the NoI: the busiest link bounds
    throughput (wormhole, all flows concurrent).  ``bw_scale`` (per-link
    bandwidth factors, e.g. ``NoIEval.link_bw_scale`` of a derated fault
    scenario) slows the affected links; None is the nominal fabric."""
    if len(link_bytes) == 0:
        return 0.0
    if bw_scale is None:
        return float(link_bytes.max()) / LINK.bw
    return float(np.max(np.asarray(link_bytes)
                        / (LINK.bw * np.asarray(bw_scale))))


def noi_energy(eval_: NoIEval) -> float:
    """Link + router traversal energy for the whole workload (J)."""
    pj_per_bit = LINK.energy_pj_per_bit + LINK.router_pj_per_bit
    return eval_.total_byte_hops * 8 * pj_per_bit * 1e-12


def mesh_baseline_eval(n_chiplets: int, phases, n_samples: int = 5,
                       scenario=None) -> NoIEval:
    """Reference 2-D mesh NoI (paper Fig-4 normaliser): full mesh links with
    *placement-unaware* (shuffled) chiplet assignment, averaged over a few
    draws — the "standard multi-hop regular topology" the paper argues
    against (§3.2).  A fault ``scenario`` degrades every draw; if any draw
    disconnects, the baseline is reported disconnected (explicitly — no
    NaN from averaging infs)."""
    import random

    from repro_torch.core.placement import random_placement

    evs = [evaluate_noi(random_placement(n_chiplets, random.Random(s)),
                        phases, scenario=scenario)
           for s in range(n_samples)]
    if any(e.disconnected for e in evs):
        return _disconnected()
    mu = float(np.mean([e.mu for e in evs]))
    sigma = float(np.mean([e.sigma for e in evs]))
    return NoIEval(mu=mu, sigma=sigma,
                   max_util=float(np.mean([e.max_util for e in evs])),
                   total_byte_hops=float(np.mean([e.total_byte_hops for e in evs])),
                   mean_hops=float(np.mean([e.mean_hops for e in evs])),
                   per_phase_link_bytes=[])
