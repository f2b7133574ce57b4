"""Plane-A ↔ Plane-B co-simulation bridge.

The serving engine (`repro_torch.serving.engine`) runs real prefill+decode
schedules on the card; the analytical simulator (`core/simulator`) evaluates
chiplet architectures.  This module closes the loop:

1. **measure** — ``mix_from_stats`` turns ``ServingEngine.stats()`` into a
   :class:`EpisodeMix`: the batch mix of (prompt_len, gen_len) episodes the
   engine actually served, plus its chunked-prefill schedule, its
   measured per-step active-slot histogram and its decode-stall bound;
2. **replay** — ``cosim_mix`` replays that mix through
   ``simulate_generation`` for every architecture, on the *full* model
   config (the engine typically serves a ``reduce_config`` shrink of it),
   with decode batched at the measured slot-pool occupancy
   (``EpisodeMix.effective_batch``), reporting TTFT, decode tok/s and
   energy/token per architecture — directly comparable to the engine's
   continuous-batching tok/s, not a single stream;
3. **design** — ``generation_phases`` expands the mix into a decode-heavy
   phase list whose repeats weight prefill vs decode by their measured
   token counts — decode batch-amortised, prefill split at the measured
   chunked-prefill interleave granularity — and ``generation_objective``
   feeds it to the existing MOO solvers (`core/moo`) — so NoI
   placement/link search optimises for the traffic a *generation*
   workload actually produces (KV-cache reads dominating), not a single
   fixed-length forward pass.

The single-pass calibration contract is untouched: everything here is
built from ``prefill_phases`` / ``decode_step_phases`` on top of the
anchored single-pass models.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.config import ModelConfig, get_config
from repro_torch.core.noi import (NoIEval, evaluate_noi, mesh_baseline_eval,
                            noi_phase_time)
from repro_torch.core.simulator import (CALIB, Calib, _decode_positions,
                                  simulate_generation)
from repro_torch.core.traffic import (Phase, Workload, decode_step_phases,
                                prefill_phases, spec_decode_step_phases,
                                spec_tokens_per_step)

ARCHS = ("2.5D-HI", "HAIMA_chiplet", "TransPIM_chiplet")


@dataclasses.dataclass(frozen=True)
class Episode:
    """One served request class: prompt_len tokens in, gen_len tokens out."""
    prompt_len: int
    gen_len: int
    count: int = 1


@dataclasses.dataclass
class EpisodeMix:
    """The measured workload of a serving run (the Plane-A ground truth)."""
    episodes: list[Episode]
    prefill_chunk: int = 0        # engine chunked-prefill budget (tokens)
    max_batch: int = 0            # engine slot-pool size
    # {n_active_slots: decode iterations at that occupancy} — the measured
    # slot-pool utilisation (ServingEngine.stats()["active_slots_hist"])
    active_hist: dict = dataclasses.field(default_factory=dict)
    max_stall_tokens: int = 0     # max prefill tokens between decode steps
    weight_bits: int = 16         # measured serving precision (16 = fp) —
    kv_bits: int = 16             #   scales the Plane-B weight/KV byte terms
    # speculative decoding — measured from the engine's spec counters
    # (all zero when speculation was off, leaving the mix bit-identical
    # to the pre-speculation model)
    spec_k: int = 0               # draft depth per speculative step
    spec_acceptance: float = 0.0  # measured per-draft acceptance rate
    spec_tokens: float = 0.0      # measured E[committed tokens]/slot-step
    spec_draft_bits: int = 0      # self-draft precision (0 = serving bits)
    # measured wall clock from the engine tracer (EngineConfig(trace=))
    # — all zero when tracing was off, leaving the mix
    # bit-identical to the untraced model
    measured_step_s: float = 0.0     # mean decode-iteration wall time
    measured_prefill_s: float = 0.0  # total admission wall time
    measured_d2h_s: float = 0.0      # total device→host fetch wall time

    @property
    def expected_tokens_per_step(self) -> float:
        """Tokens one slot commits per decode iteration: the measured
        speculative yield when the engine recorded one, the analytic
        ``spec_tokens_per_step`` curve as fallback, 1.0 without
        speculation."""
        if self.spec_k <= 0:
            return 1.0
        if self.spec_tokens > 0:
            return min(float(self.spec_tokens), self.spec_k + 1.0)
        return spec_tokens_per_step(self.spec_k, self.spec_acceptance)

    @property
    def requests(self) -> int:
        return sum(e.count for e in self.episodes)

    @property
    def prefill_tokens(self) -> int:
        return sum(e.prompt_len * e.count for e in self.episodes)

    @property
    def decode_tokens(self) -> int:
        return sum(max(e.gen_len - 1, 0) * e.count for e in self.episodes)

    @property
    def mean_active_slots(self) -> float:
        """Decode-iteration-weighted mean slot-pool occupancy (0 when no
        histogram was recorded).  Zero-active iterations (a chunked decode
        scan outliving its slots) count toward the denominator — the mean
        is exactly the tokens the engine got per decode iteration paid."""
        total = sum(self.active_hist.values())
        if not total:
            return 0.0
        return sum(int(k) * c for k, c in self.active_hist.items()) / total

    @property
    def effective_batch(self) -> int:
        """The decode batch the Plane-B replay should run at: the measured
        mean occupancy when a histogram was recorded, else the slot-pool
        size (an upper bound), else single-stream."""
        m = self.mean_active_slots
        if m > 0:
            return max(1, round(m))
        return max(1, self.max_batch)


def mix_from_stats(stats: dict) -> EpisodeMix:
    """Build the episode mix from ``ServingEngine.stats()``.

    Requires the per-request ``prompt_lens``/``gen_lens`` lists the engine
    records for finished requests and a positive ``max_batch`` slot-pool
    size; identical (prompt, gen) pairs collapse into one weighted
    episode."""
    if not stats.get("finished"):
        raise ValueError("engine stats carry no finished requests")
    plens = stats.get("prompt_lens")
    glens = stats.get("gen_lens")
    if not plens or not glens or len(plens) != len(glens):
        raise ValueError("stats missing per-request prompt_lens/gen_lens")
    max_batch = int(stats.get("max_batch", 0))
    if max_batch <= 0:
        # a 0-slot pool cannot have served the finished requests — the
        # stats are inconsistent/truncated, not a degenerate-but-valid mix
        raise ValueError(
            "stats carry no slot-pool size (max_batch <= 0); the engine "
            "that served this mix must report its pool via stats()")
    counts: dict[tuple[int, int], int] = {}
    for p, g in zip(plens, glens):
        counts[(int(p), int(g))] = counts.get((int(p), int(g)), 0) + 1
    episodes = [Episode(p, g, c) for (p, g), c in sorted(counts.items())]
    hist = {int(k): int(v)
            for k, v in (stats.get("active_slots_hist") or {}).items()}
    return EpisodeMix(episodes,
                      prefill_chunk=int(stats.get("prefill_chunk", 0)),
                      max_batch=max_batch,
                      active_hist=hist,
                      max_stall_tokens=int(stats.get("max_stall_tokens", 0)),
                      weight_bits=int(stats.get("weight_bits", 16)),
                      kv_bits=int(stats.get("kv_bits", 16)),
                      # spec keys exist only when the engine ran with
                      # spec_k > 0 (stats dormancy contract); rate/yield
                      # may be None when nothing was drafted yet
                      spec_k=int(stats.get("spec_k", 0) or 0),
                      spec_acceptance=float(stats.get("spec_acceptance")
                                            or 0.0),
                      spec_tokens=float(stats.get("spec_tokens_per_step")
                                        or 0.0),
                      spec_draft_bits=int(stats.get("spec_draft_bits", 0)
                                          or 0),
                      # trace keys exist only when the engine ran with
                      # EngineConfig(trace=True) (same dormancy contract)
                      measured_step_s=float(stats.get("trace_decode_step_s")
                                            or 0.0),
                      measured_prefill_s=float(stats.get("trace_prefill_s")
                                               or 0.0),
                      measured_d2h_s=float(stats.get("trace_d2h_s") or 0.0))


def _resolve(cfg) -> ModelConfig:
    return get_config(cfg) if isinstance(cfg, str) else cfg


def workload_for(cfg, episode: Episode,
                 mix: Optional[EpisodeMix] = None) -> Workload:
    """Plane-B workload for one episode of a (full-size) model config; a
    ``mix`` carries the measured serving precision into the byte terms."""
    return Workload.from_config(
        _resolve(cfg), seq_len=episode.prompt_len,
        weight_bits=mix.weight_bits if mix else 16,
        kv_bits=mix.kv_bits if mix else 16)


# ---------------------------------------------------------------------------
# replay: measured mix → per-architecture generation metrics
# ---------------------------------------------------------------------------

def cosim_mix(cfg, mix: EpisodeMix, n_chiplets: int,
              archs: Sequence[str] = ARCHS, *,
              calib: Calib = CALIB, batch: Optional[int] = None) -> dict:
    """Replay a measured episode mix through every architecture.

    ``batch`` is the decode batch each episode's steps run at; it defaults
    to the mix's measured ``effective_batch`` (mean active slots from the
    engine's histogram, falling back to the slot-pool size), so the
    replayed Plane-B throughput models the continuous-batching regime the
    engine actually drove — pass ``batch=1`` for the single-stream view.

    Returns ``{arch: {ttft_s, decode_step_s, tokens_per_s,
    energy_per_token_j, prefill_bytes, decode_bytes, decode_traffic_frac,
    batch}}`` with request-count-weighted means; ``tokens_per_s`` counts
    all ``batch`` concurrent streams (episodes overlap in the pool, so the
    wall-clock per episode shrinks by the batch)."""
    cfg = _resolve(cfg)
    if batch is None:
        batch = mix.effective_batch
    out: dict[str, dict] = {}
    for arch in archs:
        ttft = step = energy = toks = lat = pre_b = dec_b = 0.0
        n = 0
        for ep in mix.episodes:
            w = workload_for(cfg, ep, mix)
            g = simulate_generation(w, n_chiplets, ep.prompt_len, ep.gen_len,
                                    arch=arch, calib=calib, batch=batch)
            n += ep.count
            ttft += g.ttft_s * ep.count
            step += g.decode_step_s * ep.count
            energy += g.energy_j * ep.count
            toks += g.gen_len * ep.count
            lat += g.latency_s * ep.count
            pre_b += g.prefill_bytes * ep.count
            dec_b += g.decode_bytes * ep.count
        out[arch] = {
            "ttft_s": ttft / n,
            "decode_step_s": step / n,
            "tokens_per_s": toks * batch / max(lat, 1e-30),
            "energy_per_token_j": energy / max(toks, 1),
            "prefill_bytes": pre_b,
            "decode_bytes": dec_b,
            "decode_traffic_frac": dec_b / max(pre_b + dec_b, 1e-30),
            "batch": batch,
        }
    return out


def cosim_from_engine(engine, cfg=None, n_chiplets: int = 64,
                      archs: Sequence[str] = ARCHS, *,
                      calib: Calib = CALIB,
                      batch: Optional[int] = None) -> dict:
    """End-to-end bridge: measured engine run → Plane-B evaluation.

    ``cfg`` defaults to the engine's own (usually reduced) config; pass the
    full-size config to project the measured schedule onto the real model
    dims.  Decode runs batched at the engine's measured slot-pool
    occupancy unless ``batch`` overrides it."""
    mix = mix_from_stats(engine.stats())
    cfg = _resolve(cfg) if cfg is not None else engine.cfg
    spec = {}
    if mix.spec_k:
        spec = {"spec_k": mix.spec_k,
                "spec_acceptance": mix.spec_acceptance,
                "spec_tokens_per_step": mix.expected_tokens_per_step,
                "spec_draft_bits": mix.spec_draft_bits}
    measured = {}
    if mix.measured_step_s > 0:
        # the engine ran with the tracer on: carry the measured step
        # times next to the measured mix, so every simulated
        # decode_step_s has its Plane-A wall-clock counterpart in the
        # same record (keys absent when tracing was off — dormancy)
        measured = {"measured_step_s": mix.measured_step_s,
                    "measured_prefill_s": mix.measured_prefill_s,
                    "measured_d2h_s": mix.measured_d2h_s}
    return {"mix": {"requests": mix.requests,
                    "prefill_tokens": mix.prefill_tokens,
                    "decode_tokens": mix.decode_tokens,
                    "prefill_chunk": mix.prefill_chunk,
                    "max_batch": mix.max_batch,
                    "weight_bits": mix.weight_bits,
                    "kv_bits": mix.kv_bits,
                    "max_stall_tokens": mix.max_stall_tokens,
                    "mean_active_slots": mix.mean_active_slots,
                    "effective_batch": mix.effective_batch,
                    "active_slots_hist": dict(mix.active_hist),
                    **spec,
                    **measured,
                    "episodes": [dataclasses.asdict(e) for e in mix.episodes]},
            "archs": cosim_mix(cfg, mix, n_chiplets, archs, calib=calib,
                               batch=batch)}


# ---------------------------------------------------------------------------
# design: generation traffic → MOO/placement objective
# ---------------------------------------------------------------------------

def _scale_phase(p: Phase, scale: float, repeat: int) -> Phase:
    """Copy of ``p`` with every compute/traffic term scaled and the repeat
    replaced (``scale=1.0`` is exact — multiplying by 1.0 changes no
    float).  Iterates the dataclass fields so a term added to ``Phase``
    later is scaled too instead of silently reset."""
    scaled = {f.name: getattr(p, f.name) * scale
              for f in dataclasses.fields(p)
              if f.name not in ("name", "repeat")}
    return dataclasses.replace(p, repeat=repeat, **scaled)


def _interleave_chunks(mix: EpisodeMix, prompt_len: int) -> int:
    """Chunked-prefill interleave factor for one episode: how many
    bounded bursts its prompt ingest is split into.

    The engine's chunked-prefill scheduler never stalls decode for more
    than its measured ``max_stall_tokens`` burst (falling back to the
    configured ``prefill_chunk`` budget), so a ``prompt_len`` ingest
    reaches the fabric as ``ceil(prompt_len / bound)`` chunk executions
    interleaved with decode steps — same total bytes, chunk-sized
    per-execution link loads.  The NoI time-average (eqs 14-15) then
    weights prefill at the granularity the interconnect actually sees."""
    bound = mix.max_stall_tokens or mix.prefill_chunk
    if bound <= 0 or prompt_len <= bound:
        return 1
    return -(-prompt_len // bound)


def generation_phases(cfg, mix: EpisodeMix, *, samples: int = 1,
                      batch: Optional[int] = None) -> list[Phase]:
    """Phase list of a whole generation episode mix, for NoI evaluation.

    Prefill phases keep their per-layer repeats, split into the mix's
    chunked-prefill interleave granularity (``_interleave_chunks``: the
    measured stall bound caps each burst, repeats scale up so total bytes
    are unchanged).  Decode phases (evaluated at ``samples`` KV positions
    per episode) get their repeats scaled by the number of decode steps
    they represent and run at the mix's measured decode batch: each
    timestamp is one token's 1/batch share of a batched step, so the
    weight streams are batch-amortised exactly as the engine amortises
    them.  ``evaluate_noi``'s repeat-weighted time-average (eqs 14-15)
    then sees prefill and decode in their measured proportions —
    decode-heavy mixes dominate the objective exactly as they dominate
    the real fabric."""
    cfg = _resolve(cfg)
    if batch is None:
        batch = mix.effective_batch
    phases: list[Phase] = []
    for ep in mix.episodes:
        w = workload_for(cfg, ep, mix)
        n_chunks = _interleave_chunks(mix, ep.prompt_len)
        for p in prefill_phases(w):
            phases.append(_scale_phase(p, 1.0 / n_chunks,
                                       p.repeat * n_chunks * ep.count))
        steps = max(ep.gen_len - 1, 0)
        if not steps:
            continue
        positions = _decode_positions(ep.prompt_len, ep.gen_len, samples)
        # partition the decode steps across the sampled positions exactly,
        # so the repeat-weighted decode/prefill ratio matches the mix
        base, rem = divmod(steps, len(positions))
        for i, pos in enumerate(positions):
            per_pos = base + (1 if i < rem else 0)
            if mix.spec_k > 0:
                # speculative serving: each committed token carries a
                # 1/(batch * E[tokens/step]) share of one draft+verify
                # step — the weight stream amortises over both the batch
                # and the accepted draft run
                step_phases = spec_decode_step_phases(
                    w, pos, batch, spec_k=mix.spec_k,
                    draft_w=_draft_workload(w, mix))
                share = 1.0 / (batch * mix.expected_tokens_per_step)
            else:
                step_phases = decode_step_phases(w, pos, batch)
                share = 1.0 / batch
            for p in step_phases:
                phases.append(_scale_phase(p, share,
                                           p.repeat * per_pos * ep.count))
    return phases


def _draft_workload(w: Workload, mix: EpisodeMix) -> Workload:
    """Draft-pass workload of a self-speculating mix: the target dims at
    the measured draft precision (``spec_draft_bits=0`` means the draft
    ran at serving precision — the workload itself).  Draft-*model*
    speculation replays at the same dims (conservative upper bound); pass
    an explicit ``draft_w`` to ``spec_decode_step_phases`` directly for
    the small-model accounting."""
    if mix.spec_draft_bits in (4, 8):
        return dataclasses.replace(w, weight_bits=mix.spec_draft_bits)
    return w


def generation_objective(cfg, mix: EpisodeMix, n_chiplets: int,
                         *, samples: int = 1,
                         mesh_ev: Optional[NoIEval] = None,
                         batch: Optional[int] = None,
                         ) -> tuple[Callable, NoIEval, list[Phase]]:
    """(objective_fn, mesh_ev, phases): the paper's 2-objective NoI metric
    (μ, σ normalised to the placement-unaware 2-D mesh) over the measured
    generation traffic — batched decode, chunk-interleaved prefill.
    Drop-in for `core/moo` solvers."""
    phases = generation_phases(cfg, mix, samples=samples, batch=batch)
    mesh_ev = mesh_ev or mesh_baseline_eval(n_chiplets, phases)

    def objective(p):
        ev = evaluate_noi(p, phases)
        return (ev.mu / mesh_ev.mu, ev.sigma / mesh_ev.sigma)

    return objective, mesh_ev, phases


# ---------------------------------------------------------------------------
# resilience: fault-tolerance-aware NoI objective (worst-case degradation)
# ---------------------------------------------------------------------------

def scenario_mu(p, phases: list[Phase], scenario=None,
                mesh_mu: float = 1.0) -> float:
    """μ of a placement under one fault scenario, normalised by the mesh
    baseline; inf when the degraded fabric cannot route (an explicit
    sentinel the MOO archive rejects — never NaN)."""
    ev = evaluate_noi(p, phases, scenario=scenario)
    if ev.disconnected:
        return float("inf")
    return ev.mu / mesh_mu


def fabric_time(p, phases: list[Phase], scenario=None) -> float:
    """Repeat-weighted NoI service time of a phase list: Σ repeat ×
    bottleneck-link serialisation (``noi_phase_time`` — the max-loaded
    link is what the simulators\' phase latencies build on, so this is
    the fabric-side latency proxy, where μ is a fabric-health mean that
    one link failure barely moves).  inf when the scenario disconnects a
    required flow — never NaN."""
    ev = evaluate_noi(p, phases, scenario=scenario)
    if ev.disconnected:
        return float("inf")
    return float(sum(ph.repeat * noi_phase_time(u, ev.link_bw_scale)
                     for ph, u in zip(phases, ev.per_phase_link_bytes)))


def degradation_under_faults(p, phases: list[Phase], scenarios) -> dict:
    """Score a placement\'s fabric service time over a fault-scenario list.

    Returns ``{nominal_t, expected_t, worst_t, worst_label,
    n_disconnected, n_scenarios}`` (seconds, unnormalised).  Disconnecting
    scenarios make ``expected_t``/``worst_t`` inf and are counted —
    callers decide whether a disconnectable design is admissible."""
    nominal_t = fabric_time(p, phases)
    ts, n_disc, worst_label = [], 0, ""
    worst = -float("inf")
    for sc in scenarios:
        t = fabric_time(p, phases, sc)
        ts.append(t)
        if t == float("inf"):
            n_disc += 1
        if t > worst:
            worst = t
            worst_label = getattr(sc, "label", "")
    if not ts:
        ts, worst = [nominal_t], nominal_t
    return {"nominal_t": nominal_t,
            "expected_t": float(sum(ts) / len(ts)),
            "worst_t": float(worst),
            "worst_label": worst_label,
            "n_disconnected": n_disc,
            "n_scenarios": len(scenarios)}


def resilience_objective(cfg, mix: EpisodeMix, n_chiplets: int, *,
                         fault_model=None, n_scenarios: int = 8,
                         samples: int = 1,
                         batch: Optional[int] = None,
                         endurance_weighted: bool = False,
                         ) -> tuple[Callable, float, list[Phase]]:
    """(objective_fn, seed_time, phases): fault-tolerance-aware NoI metric.

    The two objectives trade *expected* against *worst-case* fabric
    service time over a deterministic per-design k-failure scenario set
    (nominal is always scenario 0, so fault-free latency keeps pulling
    the expected term): ``(mean T_norm, max T_norm)``, both normalised by
    the dataflow-aware seed placement\'s nominal time (``seed_time``).
    Service time — not μ — is the degradation metric because the
    simulators\' phase latencies serialise on the *bottleneck* link: a
    failure that dumps a hot link\'s traffic onto one surviving path
    inflates it sharply, while the μ mean barely moves.  A design any
    sampled scenario disconnects scores inf and is rejected by the MOO
    archive — surviving the k-failure set is a hard constraint, the
    residual slowdown is what the search trades against nominal speed.

    ``fault_model`` defaults to single-link failures
    (``FaultModel(k_links=1)``); ``endurance_weighted`` biases which links
    fail by the wear the measured traffic accumulates
    (``faults.endurance_link_weights`` — ReRAM-incident links fail more).
    Scenario sampling is a pure function of (link set, model seed), so
    re-evaluating a placement is reproducible and archive-stable."""
    from repro_torch.core.faults import FaultModel, endurance_link_weights
    from repro_torch.core.placement import initial_placement

    fault_model = fault_model or FaultModel(k_links=1)
    phases = generation_phases(cfg, mix, samples=samples, batch=batch)
    seed_time = fabric_time(initial_placement(n_chiplets), phases)

    def objective(p):
        weights = (endurance_link_weights(p, phases)
                   if endurance_weighted else None)
        scenarios = fault_model.sample_scenarios(p, n_scenarios,
                                                 link_weights=weights)
        ts = [fabric_time(p, phases)] + [fabric_time(p, phases, sc)
                                         for sc in scenarios]
        if any(t == float("inf") for t in ts):
            return (float("inf"), float("inf"))
        return (sum(ts) / len(ts) / seed_time, max(ts) / seed_time)

    return objective, seed_time, phases


def _lost_dram_frac(p, scenario) -> float:
    """Share of the slot-pool KV orphaned by a scenario: dead DRAM role
    members over the DRAM role size (0 for link-only faults)."""
    if scenario is None or not scenario.failed_chiplets:
        return 0.0
    drams = p.roles().get("DRAM", [])
    if not drams:
        return 0.0
    dead = sum(1 for c in drams if c in scenario.failed_chiplets)
    return dead / len(drams)


def _pool_depth(mix: EpisodeMix) -> tuple[Episode, int]:
    """(dominant episode, mid-generation KV depth) — the pool state a
    recovery event re-materialises.  Recovery can strike at any decode
    iteration, so each slot is priced at its episode's expected depth
    (prompt + half the generated tokens), request-count weighted."""
    ep = max(mix.episodes, key=lambda e: e.count)
    tot = sum((e.prompt_len + max(e.gen_len - 1, 0) // 2) * e.count
              for e in mix.episodes)
    return ep, max(1, round(tot / max(mix.requests, 1)))


def recovery_time(p, cfg, mix: EpisodeMix, scenario=None, *,
                  batch: Optional[int] = None) -> float:
    """One-time fabric service time of recovering from ``scenario``:
    KV-shard migration off the failed chiplet(s) plus the checkpoint
    restore read (``traffic.recovery_phases``), routed and serialised on
    the *degraded* fabric (failed chiplets' traffic redistributes over
    surviving role members; disconnection ⇒ inf).  0 for the nominal
    fabric — nothing to recover from."""
    from repro_torch.core.traffic import recovery_phases

    if scenario is None or scenario.is_nominal:
        return 0.0
    cfg = _resolve(cfg)
    if batch is None:
        batch = mix.effective_batch
    ep, depth = _pool_depth(mix)
    w = workload_for(cfg, ep, mix)
    phases = recovery_phases(w, depth, batch,
                             lost_frac=_lost_dram_frac(p, scenario))
    return fabric_time(p, phases, scenario)


def mttr_resilience_objective(cfg, mix: EpisodeMix, n_chiplets: int, *,
                              fault_model=None, n_scenarios: int = 8,
                              samples: int = 1,
                              batch: Optional[int] = None,
                              ckpt_every: int = 32,
                              mttr_weight: float = 1.0,
                              ) -> tuple[Callable, float, list[Phase]]:
    """MTTR-aware extension of :func:`resilience_objective`.

    Steady-state service now carries the amortised checkpoint write-back
    stream (``traffic.checkpoint_phases`` at ``ckpt_every`` — crash
    safety is not free even when nothing fails), and the worst-case
    objective prices the *recovery* a scenario forces on top of its
    degraded service: ``(mean T_service, max (T_service + mttr_weight ×
    T_recovery))``, both normalised by the seed placement's nominal
    service time.  ``fault_model`` defaults to single-chiplet losses
    (``FaultModel(k_links=0, k_chiplets=1)`` — the KV-orphaning event);
    a scenario that disconnects service *or* recovery scores inf, so
    surviving the loss **and** being able to re-shard off it are both
    hard constraints the search trades against nominal speed.
    ``ckpt_every <= 0`` drops the write-back stream (recovery still
    priced — the checkpoint lives off-fabric)."""
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.placement import initial_placement
    from repro_torch.core.traffic import checkpoint_phases

    fault_model = fault_model or FaultModel(k_links=0, k_chiplets=1)
    if batch is None:
        batch = mix.effective_batch
    phases = generation_phases(cfg, mix, samples=samples, batch=batch)
    if ckpt_every > 0:
        ep, depth = _pool_depth(mix)
        w = workload_for(_resolve(cfg), ep, mix)
        # same per-token 1/batch amortisation as the decode phases: the
        # write-back repeats once per generated token's share of a step
        for p in checkpoint_phases(w, depth, batch, every=ckpt_every):
            phases.append(_scale_phase(p, 1.0 / batch,
                                       p.repeat * max(mix.decode_tokens, 1)))
    seed_time = fabric_time(initial_placement(n_chiplets), phases)

    def objective(p):
        scenarios = fault_model.sample_scenarios(p, n_scenarios)
        t_nom = fabric_time(p, phases)
        service, totals = [t_nom], [t_nom]
        for sc in scenarios:
            t = fabric_time(p, phases, sc)
            r = recovery_time(p, cfg, mix, sc, batch=batch)
            service.append(t)
            totals.append(t + mttr_weight * r)
        if any(t == float("inf") for t in totals):
            return (float("inf"), float("inf"))
        return (sum(service) / len(service) / seed_time,
                max(totals) / seed_time)

    return objective, seed_time, phases


def seeded_noi_search(objective: Callable, n_chiplets: int, *,
                      iterations: int = 3, ls_steps: int = 12,
                      seed: int = 0):
    """MOO-STAGE over any (μ, σ) NoI objective, seeded (like
    `examples/noi_design.py`) with a local search from the dataflow-aware
    initial placement.  The one search recipe every NoI comparison runs,
    so search budgets stay identical across objectives.  Returns the
    MooStageResult."""
    import random

    from repro_torch.core.moo import local_search, moo_stage
    from repro_torch.core.placement import initial_placement

    res = moo_stage(n_chiplets, objective, (2.0, 2.0),
                    iterations=iterations, ls_steps=ls_steps, seed=seed)
    local_search(initial_placement(n_chiplets), objective, res.archive,
                 random.Random(seed), max_steps=ls_steps)
    return res


def optimize_generation_noi(cfg, mix: EpisodeMix, n_chiplets: int, *,
                            iterations: int = 3, ls_steps: int = 12,
                            seed: int = 0, samples: int = 1,
                            batch: Optional[int] = None):
    """Decode-aware NoI design search: `seeded_noi_search` over the
    generation traffic.  Returns (MooStageResult, mesh_ev)."""
    objective, mesh_ev, _ = generation_objective(cfg, mix, n_chiplets,
                                                 samples=samples, batch=batch)
    res = seeded_noi_search(objective, n_chiplets, iterations=iterations,
                            ls_steps=ls_steps, seed=seed)
    return res, mesh_ev
