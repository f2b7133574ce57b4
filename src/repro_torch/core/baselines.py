"""Baseline architectures (§2, §4.2): HAIMA_chiplet, TransPIM_chiplet, the
original (non-chiplet) HAIMA/TransPIM, and the ReTransformer endurance
analysis (§4.4).

Execution models follow the paper's descriptions:

- **HAIMA_chiplet** [3]: SRAM chiplets compute score (eqs 5-6), DRAM-PIM
  chiplets compute self-attention projections + FF; host chiplets do the
  arithmetic (softmax) → per-layer host round-trips; disintegrated banks
  cause frequent SRAM↔DRAM exchange and contention.
- **TransPIM_chiplet** [2]: all kernels bit-serial row-parallel in DRAM-PIM;
  ACUs do vector reduction + softmax; token-sharing ring broadcast among
  memory chiplets carries activations (simple dataflow, lower energy, but
  per-kernel latency overhead from ACU hand-offs).
- **Originals**: monolithic 3-D PIM stacks whose concurrent bank activation
  is thermally capped (§4.3) — modelled as a fraction of banks active.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import chiplets as C
from repro_torch.core.noi import evaluate_noi, noi_energy, noi_phase_time
from repro_torch.core.placement import Placement, grid_for, initial_placement, mesh_links
from repro_torch.core.simulator import (Calib, CALIB, GenResult, SimResult,
                                  _decode_positions, _energy)
from repro_torch.core.traffic import (BYTES, Phase, Workload, decode_step_phases,
                                kv_cache_bytes_per_layer, total_traffic_bytes,
                                transformer_phases)


def _baseline_placement(n_chiplets: int, kinds: dict) -> Placement:
    """Mesh-linked placement with the baseline's own chiplet mix, placed by
    the same MOO seed layout (iso-chiplet comparison, §4.1.1)."""
    w, h = grid_for(n_chiplets)
    types = []
    for t, cnt in kinds.items():
        types += [t] * cnt
    types += ["DRAM"] * (w * h - len(types))
    return Placement(w, h, types[: w * h], mesh_links(w, h),
                     [i for i, t in enumerate(types[: w * h]) if t == "ReRAM"])


# ---------------------------------------------------------------------------
# HAIMA_chiplet
# ---------------------------------------------------------------------------

def _dim_util(dim: int, exponent: float = 1.0) -> float:
    """Structural dimensional-utilisation curve (same family as 2.5D-HI's,
    see simulator.py): achieved/peak grows with the stationary operand dim
    until the compute saturates.

    ``exponent`` encodes *how parallelism scales with model size* per
    architecture (§4.2):
      - 1.0 — row-width utilisation only (SM/SRAM pipelines; TransPIM's
        token-sharding spreads work by tokens, so weight size buys nothing);
      - 1.5 — HAIMA's DRAM-PIM bank-level parallelism: concurrently
        activated banks grow with the weight footprint (∝ D·F) *and*
        per-bank row utilisation grows with row width (∝ D) — the paper's
        "HAIMA maximizes throughput by activating multiple banks in
        parallel".
    """
    return min(1.0, (dim / C.SM_SAT_DIM) ** exponent)


def _phase_dim(name: str, w: Workload) -> int:
    """Governing parallelism dim per phase for *in-memory* compute.

    Bit-serial row-parallel PIM parallelism is set by the stationary
    matrix's ROW width — d_model for every transformer kernel (FC1 rows =
    D, FC2 activations re-written per token).  This is the structural
    asymmetry behind the paper's Fig-8 "gain is maximum for the FF layer":
    2.5D-HI's ReRAM macro scales with the full F width via weight
    duplication (simulator.py uses d_ff there), while the baselines' PIM
    banks stay row-bound at D ≪ F.
    """
    return w.d_model


# Dynamic-operand write penalty (the paper's central thesis, §3.1/§4.4):
# compute-in-memory arrays must WRITE per-token operands (Q, K, V, score
# rows) into the array before each MVM — bit-(de)serialisation of 16-bit
# dynamic operands costs ~an order of magnitude over weight-stationary
# operation.  2.5D-HI avoids this entirely by running dynamic kernels on
# SM chiplets with fused score+softmax.
DYNAMIC_WRITE_PENALTY = 8.0

# Milder factor for kernels whose *outputs* (not stationary operands) are
# dynamic intermediates that must be written back into banks before the
# next in-memory kernel (TransPIM's K/Q/V → score hand-off): the write-back
# work is ~a quarter of the MAC work at fp16 into bit-serial banks.
KQV_WRITEBACK = 1.25


def _haima_env(n_chiplets: int, calib: Calib, chiplet: bool) -> dict:
    """Chiplet mix, placement and effective rates of the HAIMA_chiplet plane
    (shared between the single-pass and decode-step models)."""
    n_sram = max(n_chiplets // 6, 2)
    n_host = max(n_chiplets // 18, 1)
    n_dram = n_chiplets - n_sram - n_host
    pl = _baseline_placement(n_chiplets,
                             {"SRAM": n_sram, "HOST": n_host, "DRAM": n_dram})
    # DRAM-PIM effective rate: banks × bit-serial MAC rate × calibrated eff.
    bank_rate = 32e9                      # ops/s per chiplet's PIM banks
    cap = 1.0 if chiplet else calib.orig_bank_cap
    return {
        "n_sram": n_sram, "n_host": n_host, "n_dram": n_dram, "pl": pl,
        "pim_rate0": n_dram * bank_rate * 64 * calib.haima_eff * cap,
        "sram_rate0": n_sram * 2.0e12 * calib.haima_eff * 24,
        "alloc": {"SRAM": n_sram, "HOST": n_host, "DRAM": n_dram},
    }


def simulate_haima_chiplet(w: Workload, n_chiplets: int, *,
                           calib: Calib = CALIB,
                           chiplet: bool = True, scenario=None) -> SimResult:
    env = _haima_env(n_chiplets, calib, chiplet)
    n_dram, pl = env["n_dram"], env["pl"]

    # score/softmax spill: the N²·h attention matrix leaves the SRAM plane
    # for the host (softmax) and back (§4.2 — "repeated data exchange with
    # the host"; 2.5D-HI avoids this via fused score+softmax on SMs).
    score_spill = 2.0 * w.seq_len * w.seq_len * w.n_heads * BYTES

    phases = transformer_phases(w)
    # HAIMA adds host round-trips for softmax/arithmetic on every layer and
    # SRAM↔DRAM exchange for the score operands
    for p in phases:
        if p.name == "score":
            p.host_bytes = 2 * w.seq_len * w.d_model * BYTES + score_spill
            p.sm_mc_bytes *= 2.0          # contention paths (§4.2)
        if p.name == "embed":
            # token vectors leave the banks for the compute plane (2.5D-HI
            # keeps this on the contiguous ReRAM macro instead)
            p.sm_mc_bytes += w.seq_len * w.d_model * BYTES
    noi_t_list, ev = _phase_noi_times_baseline(pl, phases, scenario)
    noi_by = {p.name: t for p, t in zip(phases, noi_t_list)}

    pim_rate0, sram_rate0 = env["pim_rate0"], env["sram_rate0"]

    def host_time(p):
        return (p.host_bytes / C.HOST_LINK.bw
                + (2 * C.HOST_LINK.latency_s if p.host_bytes else 0.0))

    by = {p.name: p for p in phases}

    def t_of(p, rate0, *, exponent=1.5, dyn=1.0):
        rate = rate0 * _dim_util(_phase_dim(p.name, w), exponent) / dyn
        return max((p.sm_flops + p.reram_flops) / rate, noi_by[p.name],
                   p.dram_bytes / (n_dram * C.DRAM.bw)) + host_time(p)

    # weight-stationary kernels on DRAM-PIM: bank-parallelism exponent
    # (fitted to the Table-4 GPT-J anchor — HAIMA activates more banks as
    # the weight footprint grows); score on the SRAM plane: linear
    # row-width util × dynamic-write penalty
    e = calib.haima_scale_exp
    t_embed = t_of(by["embed"], pim_rate0, exponent=e)
    t_kqv = t_of(by["kqv"], pim_rate0, exponent=e)
    t_score = t_of(by["score"], sram_rate0, exponent=1.0,
                   dyn=DYNAMIC_WRITE_PENALTY)
    t_ff = t_of(by["ff"], pim_rate0, exponent=e)
    t_cross = t_of(by["cross"], pim_rate0, exponent=e) if "cross" in by else 0.0
    t_head = t_of(by["lm_head"], pim_rate0, exponent=e)

    k = w.n_layers
    total = t_embed + k * (t_kqv + t_score + t_ff) + t_head  # serialized
    if "cross" in by:
        total += by["cross"].repeat * t_cross

    per_kernel = {"embed": t_embed, "kqv": t_kqv * k, "score": t_score * k,
                  "ff": t_ff * k, "lm_head": t_head}
    times = {"embed": t_embed, "kqv": t_kqv, "score": t_score, "ff": t_ff,
             "lm_head": t_head}
    if "cross" in by:
        times["cross"] = t_cross
        per_kernel["cross"] = t_cross * by["cross"].repeat
    alloc = env["alloc"]
    # per-phase active units: score on the SRAM plane + host softmax; the
    # weight-stationary kernels on DRAM-PIM banks
    busy = {n: ({"SRAM", "HOST"} if n == "score" else {"DRAM"})
            for n in times}
    energy = _energy(phases, times, alloc, ev, busy) * 1.35  # contention (§4.2)
    name = "HAIMA_chiplet" if chiplet else "HAIMA"
    if not chiplet:
        energy *= 1.15
    return SimResult(name, w.name, n_chiplets, w.seq_len, total, energy,
                     per_kernel, ev)


# ---------------------------------------------------------------------------
# TransPIM_chiplet
# ---------------------------------------------------------------------------

ACU_LATENCY = 1.2e-6                 # per-kernel ACU hand-off (§2)
ACU_BW = 25e9                        # ACU vector-unit stream bandwidth


def _transpim_env(n_chiplets: int, calib: Calib, chiplet: bool) -> dict:
    """Chiplet mix, placement and effective rates of the TransPIM_chiplet
    plane (shared between the single-pass and decode-step models)."""
    n_acu = max(n_chiplets // 9, 1)
    n_dram = n_chiplets - n_acu
    pl = _baseline_placement(n_chiplets, {"ACU": n_acu, "DRAM": n_dram})
    bank_rate = 32e9
    cap = 1.0 if chiplet else calib.orig_bank_cap
    return {
        "n_acu": n_acu, "n_dram": n_dram, "pl": pl,
        "pim_rate0": n_dram * bank_rate * 64 * calib.transpim_eff * cap,
        "alloc": {"ACU": n_acu, "DRAM": n_dram},
    }


def simulate_transpim_chiplet(w: Workload, n_chiplets: int, *,
                              calib: Calib = CALIB,
                              chiplet: bool = True,
                              scenario=None) -> SimResult:
    env = _transpim_env(n_chiplets, calib, chiplet)
    n_acu, n_dram, pl = env["n_acu"], env["n_dram"], env["pl"]

    phases = transformer_phases(w)
    ring_bytes = w.seq_len * w.d_model * BYTES
    # softmax runs on the ACUs: the N²·h score matrix crosses bank→ACU→bank
    # (TransPIM "suffers from latency overhead at each kernel" §2)
    acu_spill = 2.0 * w.seq_len * w.seq_len * w.n_heads * BYTES
    for p in phases:
        if p.name in ("kqv", "score"):
            # token-sharing ring broadcast among memory chiplets
            p.sm_mc_bytes += ring_bytes
        if p.name == "score":
            p.sm_mc_bytes += acu_spill
        if p.name == "embed":
            p.sm_mc_bytes += w.seq_len * w.d_model * BYTES
    noi_t_list, ev = _phase_noi_times_baseline(pl, phases, scenario)
    noi_by = {p.name: t for p, t in zip(phases, noi_t_list)}

    pim_rate0 = env["pim_rate0"]
    acu_latency, acu_bw = ACU_LATENCY, ACU_BW

    by = {p.name: p for p in phases}

    def t_of(p):
        # token-sharding parallelism is ~width-linear (fitted exponent —
        # sub-linear: ring-broadcast overheads grow with row width); score
        # pays the bit-serial dynamic-operand write penalty in-bank; kqv
        # pays a milder write-back factor (K/Q/V are dynamic intermediates
        # bit-serially written into banks for the score phase)
        dyn = 1.0
        if p.name == "score":
            dyn = DYNAMIC_WRITE_PENALTY
        elif p.name == "kqv":
            dyn = KQV_WRITEBACK
        rate = (pim_rate0
                * _dim_util(_phase_dim(p.name, w), calib.transpim_scale_exp)
                / dyn)
        spill_t = (acu_spill / (n_acu * acu_bw)) if p.name == "score" else 0.0
        return (max((p.sm_flops + p.reram_flops) / rate, noi_by[p.name],
                    p.dram_bytes / (n_dram * C.DRAM.bw)) + acu_latency
                + spill_t)

    t = {n: t_of(p) for n, p in by.items()}
    k = w.n_layers
    total = t["embed"] + k * (t["kqv"] + t["score"] + t["ff"]) + t["lm_head"]
    if "cross" in by:
        total += by["cross"].repeat * t["cross"]

    per_kernel = {"embed": t["embed"], "kqv": t["kqv"] * k,
                  "score": t["score"] * k, "ff": t["ff"] * k,
                  "lm_head": t["lm_head"]}
    alloc = env["alloc"]
    busy = {n: ({"ACU", "DRAM"} if n == "score" else {"DRAM"}) for n in t}
    energy = _energy(phases, t, alloc, ev, busy)
    name = "TransPIM_chiplet" if chiplet else "TransPIM"
    if not chiplet:
        energy *= 1.15
    return SimResult(name, w.name, n_chiplets, w.seq_len, total, energy,
                     per_kernel, ev)


def _phase_noi_times_baseline(pl, phases, scenario=None):
    """Baseline NoI evaluation with role aliasing: the traffic model speaks
    SM/MC/DRAM/ReRAM; in the baselines the compute plane is SRAM (HAIMA) or
    the ACUs (TransPIM) and the DRAM-PIM banks are both memory and compute —
    a subset of banks act as the 'MC' heads the many-to-few traffic hits."""
    from repro_torch.core.faults import DisconnectedFabric

    roles = pl.roles()
    aliased = dict(roles)
    aliased["SM"] = roles.get("SRAM", []) + roles.get("ACU", [])
    drams = roles.get("DRAM", [])
    aliased["MC"] = drams[: max(len(drams) // 8, 1)]
    ev = evaluate_noi(pl, phases, roles_override=aliased, scenario=scenario)
    if ev.disconnected:
        raise DisconnectedFabric(
            f"fault scenario {getattr(scenario, 'label', scenario)!r} leaves "
            f"the baseline fabric unable to route required traffic")
    times = ([noi_phase_time(u, ev.link_bw_scale)
              for u in ev.per_phase_link_bytes]
             or [0.0] * len(phases))
    return times, ev


# ---------------------------------------------------------------------------
# generation episodes on the baselines
# ---------------------------------------------------------------------------
#
# Both baselines keep the KV cache inside the DRAM-PIM banks where it was
# computed, so prefill write-back is an intra-bank commit (DRAM access
# energy + bank-bandwidth time, no NoI crossing).  Every decode step still
# has to move the cached K/V to wherever score runs: HAIMA streams it to
# the SRAM plane (and round-trips the softmax through the host), TransPIM
# ring-broadcasts the token state and spills the score row through the
# ACUs — the per-kernel hand-off latencies the paper calls out (§2) are
# paid per generated token, per layer.

def _haima_decode_step(w: Workload, env: dict, kv_pos: int, calib: Calib,
                       batch: int = 1, scenario=None):
    phases = decode_step_phases(w, kv_pos, batch)
    # per-slot 1×P score rows, ×2 ways; the host round-trip latency itself
    # is paid once per step — the batch amortises it
    score_spill = 2.0 * kv_pos * w.n_heads * BYTES * batch
    for p in phases:
        if p.name == "score_dec":
            p.host_bytes = batch * 2 * w.d_model * BYTES + score_spill
            p.sm_mc_bytes *= 2.0          # contention paths (§4.2); the
            # cached K/V itself crosses the DRAM↔SRAM boundary via dram_bytes
        if p.name == "embed_dec":
            p.sm_mc_bytes += batch * w.d_model * BYTES
    noi_t, ev = _phase_noi_times_baseline(env["pl"], phases, scenario)
    noi_by = {p.name: t for p, t in zip(phases, noi_t)}
    by = {p.name: p for p in phases}

    def host_time(p):
        return (p.host_bytes / C.HOST_LINK.bw
                + (2 * C.HOST_LINK.latency_s if p.host_bytes else 0.0))

    def t_of(p, rate0, *, exponent=1.5, dyn=1.0):
        rate = rate0 * _dim_util(_phase_dim(p.name, w), exponent) / dyn
        return max((p.sm_flops + p.reram_flops) / rate, noi_by[p.name],
                   p.dram_bytes / (env["n_dram"] * C.DRAM.bw)) + host_time(p)

    e = calib.haima_scale_exp
    t = {"embed_dec": t_of(by["embed_dec"], env["pim_rate0"], exponent=e),
         "kqv_dec": t_of(by["kqv_dec"], env["pim_rate0"], exponent=e),
         "score_dec": t_of(by["score_dec"], env["sram_rate0"], exponent=1.0,
                           dyn=DYNAMIC_WRITE_PENALTY),
         "ff_dec": t_of(by["ff_dec"], env["pim_rate0"], exponent=e),
         "lm_head_dec": t_of(by["lm_head_dec"], env["pim_rate0"], exponent=e)}
    if "cross_dec" in by:
        t["cross_dec"] = t_of(by["cross_dec"], env["pim_rate0"], exponent=e)
    k = max(w.n_dec_layers, 1)
    per_layer = t["kqv_dec"] + t["score_dec"] + t["ff_dec"] \
        + t.get("cross_dec", 0.0)
    step = t["embed_dec"] + k * per_layer + t["lm_head_dec"]   # serialized
    busy = {n: ({"SRAM", "HOST"} if n == "score_dec" else {"DRAM"})
            for n in t}
    energy = _energy(phases, t, env["alloc"], ev, busy) * 1.35  # contention
    return step, energy, ev


def _transpim_decode_step(w: Workload, env: dict, kv_pos: int, calib: Calib,
                          batch: int = 1, scenario=None):
    phases = decode_step_phases(w, kv_pos, batch)
    # per-slot token-state broadcast and score-row spill; the per-kernel
    # ACU hand-off latency is paid once per step (batch-amortised)
    ring_bytes = w.d_model * BYTES * batch           # 1 token per slot
    acu_spill = 2.0 * kv_pos * w.n_heads * BYTES * batch  # 1×P rows via ACUs
    for p in phases:
        if p.name in ("kqv_dec", "score_dec"):
            p.sm_mc_bytes += ring_bytes
        if p.name == "score_dec":
            p.sm_mc_bytes += acu_spill
        if p.name == "embed_dec":
            p.sm_mc_bytes += batch * w.d_model * BYTES
    noi_t, ev = _phase_noi_times_baseline(env["pl"], phases, scenario)
    noi_by = {p.name: t for p, t in zip(phases, noi_t)}
    by = {p.name: p for p in phases}

    def t_of(p):
        dyn = 1.0
        if p.name == "score_dec":
            dyn = DYNAMIC_WRITE_PENALTY
        elif p.name == "kqv_dec":
            dyn = KQV_WRITEBACK
        rate = (env["pim_rate0"]
                * _dim_util(_phase_dim(p.name, w), calib.transpim_scale_exp)
                / dyn)
        spill_t = (acu_spill / (env["n_acu"] * ACU_BW)
                   if p.name == "score_dec" else 0.0)
        return (max((p.sm_flops + p.reram_flops) / rate, noi_by[p.name],
                    p.dram_bytes / (env["n_dram"] * C.DRAM.bw)) + ACU_LATENCY
                + spill_t)

    t = {n: t_of(p) for n, p in by.items()}
    k = max(w.n_dec_layers, 1)
    per_layer = t["kqv_dec"] + t["score_dec"] + t["ff_dec"] \
        + t.get("cross_dec", 0.0)
    step = t["embed_dec"] + k * per_layer + t["lm_head_dec"]
    busy = {n: ({"ACU", "DRAM"} if n == "score_dec" else {"DRAM"}) for n in t}
    energy = _energy(phases, t, env["alloc"], ev, busy)
    return step, energy, ev


def _baseline_generation(arch: str, w: Workload, n_chiplets: int,
                         prompt_len: int, gen_len: int, *, calib: Calib,
                         samples: int, prefill_fn, env: dict,
                         step_fn, batch: int = 1,
                         scenario=None) -> GenResult:
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    w = dataclasses.replace(w, seq_len=prompt_len)
    prefill = prefill_fn(w, n_chiplets, calib=calib, scenario=scenario)
    # intra-bank KV commit: bank-bandwidth time + DRAM access energy
    kv_bytes = kv_cache_bytes_per_layer(w, prompt_len) * max(w.n_dec_layers, 1)
    t_kv = kv_bytes / (env["n_dram"] * C.DRAM.bw)
    kv_energy = kv_bytes * 8 * C.DRAM.energy_pj_per_bit * 1e-12
    ttft = prefill.latency_s + t_kv

    steps = max(gen_len - 1, 0)
    step_t, step_e, ev = [], [], None
    for pos in _decode_positions(prompt_len, gen_len, samples):
        t, e, ev = step_fn(w, env, pos, calib, batch, scenario)
        step_t.append(t)
        step_e.append(e)
    decode_step = sum(step_t) / len(step_t)
    # per-episode shares of the batched step (see simulator.GenResult)
    decode_energy = steps * sum(step_e) / len(step_e) / batch
    mid = _decode_positions(prompt_len, gen_len, 1)[0]
    return GenResult(
        arch=arch, workload=w.name, n_chiplets=n_chiplets,
        prompt_len=prompt_len, gen_len=gen_len, ttft_s=ttft,
        decode_step_s=decode_step, latency_s=ttft + steps * decode_step,
        energy_j=prefill.energy_j + kv_energy + decode_energy,
        # the intra-bank KV commit never crosses the fabric, so prefill
        # traffic is the plain forward pass (unlike 2.5D-HI's kv_write)
        prefill_bytes=total_traffic_bytes(transformer_phases(w)),
        decode_bytes=(steps
                      * total_traffic_bytes(decode_step_phases(w, mid, batch))
                      / batch),
        prefill=prefill, noi=ev, batch=batch)


def simulate_generation_haima(w: Workload, n_chiplets: int, prompt_len: int,
                              gen_len: int, *, calib: Calib = CALIB,
                              samples: int = 4, batch: int = 1,
                              scenario=None) -> GenResult:
    env = _haima_env(n_chiplets, calib, chiplet=True)
    return _baseline_generation(
        "HAIMA_chiplet", w, n_chiplets, prompt_len, gen_len, calib=calib,
        samples=samples, prefill_fn=simulate_haima_chiplet, env=env,
        step_fn=_haima_decode_step, batch=batch, scenario=scenario)


def simulate_generation_transpim(w: Workload, n_chiplets: int,
                                 prompt_len: int, gen_len: int, *,
                                 calib: Calib = CALIB,
                                 samples: int = 4, batch: int = 1,
                                 scenario=None) -> GenResult:
    env = _transpim_env(n_chiplets, calib, chiplet=True)
    return _baseline_generation(
        "TransPIM_chiplet", w, n_chiplets, prompt_len, gen_len, calib=calib,
        samples=samples, prefill_fn=simulate_transpim_chiplet, env=env,
        step_fn=_transpim_decode_step, batch=batch, scenario=scenario)


# ---------------------------------------------------------------------------
# ReTransformer endurance analysis (§4.4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EnduranceReport:
    writes_per_cell_per_token: float
    writes_per_encoder: float
    days_to_failure_at_1khz: float
    feasible: bool


def retransformer_endurance(w: Workload) -> EnduranceReport:
    """Quantifies §4.4: KQV intermediates rewrite ReRAM cells ~1e7×/token;
    at N=4096 a single encoder reaches ~1e10 writes — far past the ~1e8
    endurance bound [28]."""
    from repro_torch.core.traffic import rewrites_per_token

    per_tok = rewrites_per_token(w)
    per_encoder = per_tok * w.seq_len
    # token rate 1 kHz: lifetime until endurance bound
    seconds = C.RERAM.write_endurance / max(per_tok, 1e-9) / 1e3
    return EnduranceReport(
        writes_per_cell_per_token=per_tok,
        writes_per_encoder=per_encoder,
        days_to_failure_at_1khz=seconds * 1e3 / 86_400,
        feasible=per_encoder < C.RERAM.write_endurance)
