"""Analytical latency/energy/EDP simulator for the chiplet architectures (§4).

Execution model (2.5D-HI, §4.2): attention phases run on the SM cluster fed
by MC/DRAM; feed-forward runs on the ReRAM macro; MHA of layer l overlaps
FF of layer l-1 ("the SMs efficiently accelerate MHA computation, and the
ReRAM layer computes the FF layer in parallel"); GPT-J's parallel
formulation (eq. 9) overlaps them within one layer.  Phase times are
max(compute, DRAM streaming, busiest-NoI-link serialisation); energies are
unit busy-power × time + byte-hop NoI energy + DRAM access energy.

Calibration: exactly two scalars for 2.5D-HI (sm_efficiency, reram_fill)
fitted to its two Table-4 anchors (BERT-Base/36 = 50 ms, GPT-J/100 =
143 ms), and two scalars per baseline (throughput eff + bank-parallelism
scale exponent) fitted to that baseline's own Table-4 row (340/975 ms
HAIMA, 210/1435 ms TransPIM); every other figure must *emerge*.  Fitted
values and residuals are reported in EXPERIMENTS.md §Paper-validation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import chiplets as C
from repro_torch.core.faults import DisconnectedFabric
from repro_torch.core.noi import NoIEval, evaluate_noi, noi_energy, noi_phase_time
from repro_torch.core.placement import Placement, initial_placement
from repro_torch.core.traffic import (Phase, Workload, decode_step_phases,
                                prefill_phases, total_traffic_bytes,
                                transformer_phases)


@dataclasses.dataclass
class SimResult:
    arch: str
    workload: str
    n_chiplets: int
    seq_len: int
    latency_s: float
    energy_j: float
    per_kernel_s: dict
    noi: Optional[NoIEval] = None

    @property
    def edp(self) -> float:
        return self.latency_s * self.energy_j


@dataclasses.dataclass
class Calib:
    # Fitted by calibrate() to the Table-4 anchors (python -m repro_torch.core.simulator);
    # residuals reported in EXPERIMENTS.md §Paper-validation.
    sm_efficiency: float = 0.011923    # fitted: 2.5D-HI anchors (50ms/143ms)
    reram_fill: float = 0.00029342     # fitted: 2.5D-HI anchors
    haima_eff: float = 0.0048701      # fitted to HAIMA_chiplet GPT-J anchor
    transpim_eff: float = 0.0045998   # fitted to TransPIM_chiplet GPT-J anchor
    # bank-parallelism scale exponents (dim-util curve shape), fitted to the
    # Table-4 GPT-J/100-chiplet row (975 ms / 1435 ms)
    haima_scale_exp: float = 1.2838
    transpim_scale_exp: float = 0.7141
    # originals: thermally-capped fraction of banks concurrently active
    orig_bank_cap: float = 0.25        # 4-of-16 banks (§4.3 thermal argument)


CALIB = Calib()


def _alloc(n_chiplets: int) -> dict:
    return dict(C.SYSTEM_ALLOC[n_chiplets])


def _phase_noi_times(placement: Placement, phases: list[Phase],
                     scenario=None) -> tuple[list[float], NoIEval]:
    ev = evaluate_noi(placement, phases, scenario=scenario)
    if ev.disconnected:
        raise DisconnectedFabric(
            f"fault scenario {getattr(scenario, 'label', scenario)!r} leaves "
            f"the fabric unable to route required traffic")
    times = []
    for u in ev.per_phase_link_bytes:
        times.append(noi_phase_time(u, ev.link_bw_scale))
    if not times:
        times = [0.0] * len(phases)
    return times, ev


def _energy(phases, times_by_phase, alloc, noi_ev, busy: dict) -> float:
    """busy: phase-name -> set of busy unit types."""
    e = 0.0
    # background term integrates over the *executed* runtime: each phase
    # runs ph.repeat times (summing one execution per phase under-counted
    # the idle-DRAM window by ~n_layers×)
    total_t = sum(times_by_phase.get(ph.name, 0.0) * ph.repeat
                  for ph in phases)
    unit_power = {
        "SM": alloc.get("SM", 0) * C.SM.power_w,
        "MC": alloc.get("MC", 0) * C.MC.power_w,
        "ReRAM": alloc.get("ReRAM", 0) * C.RERAM.power_w,
        "SRAM": alloc.get("SRAM", 0) * 1.2,
        "ACU": alloc.get("ACU", 0) * 0.9,
        "HOST": alloc.get("HOST", 0) * 6.0,
        # DRAM-PIM chiplet actively computing (Aquabolt-XL-class in-bank
        # logic [26]) — distinct from the idle/background term below.
        "DRAM": alloc.get("DRAM", 0) * 1.3,
    }
    for ph in phases:
        t = times_by_phase.get(ph.name, 0.0) * ph.repeat
        # sorted: busy sets are string sets, whose iteration order is
        # hash-randomised per process — summing in a fixed order keeps the
        # energy bit-identical across runs (the regression pins rely on it)
        for unit in sorted(busy.get(ph.name, ())):  # busy power
            e += unit_power.get(unit, 0.0) * t
        e += (ph.dram_bytes * ph.repeat) * 8 * C.DRAM.energy_pj_per_bit * 1e-12
    e += alloc.get("DRAM", 0) * C.DRAM.idle_power_w * total_t  # DRAM background
    if noi_ev is not None:
        e += noi_energy(noi_ev)
    return e


# ---------------------------------------------------------------------------
# 2.5D-HI
# ---------------------------------------------------------------------------

def simulate_2p5d_hi(w: Workload, n_chiplets: int, *,
                     placement: Optional[Placement] = None,
                     calib: Calib = CALIB, scenario=None) -> SimResult:
    alloc = _alloc(n_chiplets)
    placement = placement or initial_placement(n_chiplets)
    phases = transformer_phases(w)
    by_name = {p.name: p for p in phases}
    noi_t, ev = _phase_noi_times(placement, phases, scenario)
    noi_by = {p.name: t for p, t in zip(phases, noi_t)}

    dram_bw = alloc["DRAM"] * C.DRAM.bw

    # Dimensional utilisation (structural, NOT fitted): achieved fraction of
    # peak grows ~linearly with the stationary operand dimension until the
    # pipeline saturates — fill/drain overhead of the tensor-core pipeline
    # (SM) and of crossbar column groups (ReRAM) is amortised over the
    # contracted dim.  Saturation points: 4096 (SM, Volta pipeline depth ×
    # MMA tile) and 16384 (ReRAM, 128 crossbar columns × 128-wide tiles).
    # The paper's own Table-4 anchors imply this (~1% util @ d=768 vs ~4%
    # @ d=4096); the two calib scalars set the *level*, this sets the shape.
    def sm_rate(dim):
        return (alloc["SM"] * C.SM.peak_flops * calib.sm_efficiency
                * min(1.0, dim / C.SM_SAT_DIM))

    def rer_rate(dim):
        # Weight duplication (§4.1.1) keeps the macro full regardless of
        # the stationary matrix's width: copies of the weights are
        # parallelised across idle crossbars ("prevents any
        # underutilization of ReRAM chiplets"), so — unlike the SM plane —
        # ReRAM throughput is dim-independent; ``reram_fill`` captures the
        # pipeline fill/drain share alone.
        del dim
        return alloc["ReRAM"] * C.RERAM.peak_flops * calib.reram_fill

    def t_attn(name, dim=w.d_model):
        p = by_name[name]
        return max(p.sm_flops / sm_rate(dim),
                   p.dram_bytes / dram_bw,
                   noi_by[name])

    def t_reram(name, dim):
        p = by_name[name]
        return max(p.reram_flops / rer_rate(dim), noi_by[name])

    t_embed = t_reram("embed", w.d_model)
    stage_attn = t_attn("kqv") + t_attn("score")
    if "cross" in by_name:
        stage_attn += t_attn("cross") * by_name["cross"].repeat / max(w.n_layers, 1)
    stage_ff = t_reram("ff", w.d_ff)
    t_head = t_reram("lm_head", min(w.vocab, C.RERAM_SAT_DIM))

    k = w.n_layers
    if w.parallel_mha_ff:  # eq. 9: overlap within the layer
        total = t_embed + k * max(stage_attn, stage_ff) + t_head
    else:  # software pipeline: FF(l-1) under MHA(l)
        total = (t_embed + stage_attn + (k - 1) * max(stage_attn, stage_ff)
                 + stage_ff + t_head)

    per_kernel = {"embed": t_embed, "kqv": t_attn("kqv") * k,
                  "score": t_attn("score") * k, "ff": stage_ff * k,
                  "lm_head": t_head}
    times = {"embed": t_embed, "kqv": t_attn("kqv"), "score": t_attn("score"),
             "ff": stage_ff, "lm_head": t_head}
    if "cross" in by_name:
        times["cross"] = t_attn("cross")
        per_kernel["cross"] = t_attn("cross") * by_name["cross"].repeat
    busy = {"embed": {"ReRAM"}, "kqv": {"SM", "MC"}, "score": {"SM", "MC"},
            "cross": {"SM", "MC"}, "ff": {"ReRAM", "MC"}, "lm_head": {"ReRAM"}}
    energy = _energy(phases, times, alloc, ev, busy)
    return SimResult("2.5D-HI", w.name, n_chiplets, w.seq_len, total, energy,
                     per_kernel, ev)


# ---------------------------------------------------------------------------
# generation episodes (prefill + autoregressive decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GenResult:
    """One generation episode: prefill a prompt, decode ``gen_len`` tokens.

    The first token is sampled from the prefill logits (standard serving
    convention), so TTFT = prefill latency (+ KV-cache write-back) and the
    remaining ``gen_len - 1`` tokens run the decode step.

    ``batch`` models the continuous-batching regime: ``batch`` concurrent
    episodes of the same shape share every decode step (weights stream
    once per step, KV reads sum over the slots).  ``decode_step_s`` is the
    *batched* step latency; per-episode quantities (``latency_s``,
    ``energy_j``, ``prefill_bytes``/``decode_bytes``) are one episode's
    share, so they stay comparable across batch sizes, while
    ``tokens_per_s``/``decode_tok_s`` report system throughput over all
    ``batch`` streams."""
    arch: str
    workload: str
    n_chiplets: int
    prompt_len: int
    gen_len: int
    ttft_s: float
    decode_step_s: float          # mean batched decode-step latency
    latency_s: float              # full episode wall time
    energy_j: float               # per-episode energy (share of the batch)
    prefill_bytes: float          # fabric bytes injected during prefill
    decode_bytes: float           # per-episode decode fabric bytes (share)
    prefill: Optional[SimResult] = None
    noi: Optional[NoIEval] = None  # decode-step NoI at the mid position
    batch: int = 1                # concurrent episodes per decode step

    @property
    def tokens_per_s(self) -> float:
        """System generation throughput: all ``batch`` streams together."""
        return self.batch * self.gen_len / max(self.latency_s, 1e-30)

    @property
    def decode_tok_s(self) -> float:
        """Steady-state decode throughput (ignoring TTFT): the batched
        step emits one token per active slot."""
        return self.batch / max(self.decode_step_s, 1e-30)

    @property
    def energy_per_token_j(self) -> float:
        return self.energy_j / max(self.gen_len, 1)


def _decode_positions(prompt_len: int, gen_len: int, samples: int) -> list[int]:
    """KV positions at which to evaluate the decode step.  Decode runs
    ``gen_len - 1`` steps at positions ``prompt_len … prompt_len+gen_len-2``;
    phase costs are linear in position, so a few samples averaged across the
    range reconstruct the episode sum (max() of linear terms makes this an
    approximation only when the binding bottleneck flips mid-episode)."""
    steps = max(gen_len - 1, 1)
    lo, hi = prompt_len, prompt_len + steps - 1
    n = min(samples, steps)
    if n <= 1:
        return [(lo + hi) // 2]
    return [round(lo + (hi - lo) * i / (n - 1)) for i in range(n)]


_DECODE_BUSY = {"embed_dec": {"ReRAM"}, "kqv_dec": {"SM", "MC"},
                "score_dec": {"SM", "MC"}, "cross_dec": {"SM", "MC"},
                "ff_dec": {"ReRAM", "MC"}, "lm_head_dec": {"ReRAM"}}


def _hi_decode_step(w: Workload, alloc: dict, placement: Placement,
                    kv_pos: int, calib: Calib, batch: int = 1,
                    scenario=None):
    """(step_time_s, step_energy_j, NoIEval) of one 2.5D-HI decode step
    over ``batch`` active slots.

    Same execution model as the single pass (SM attention fed by MC/DRAM,
    FF on the ReRAM macro, layer-l MHA over layer-(l-1) FF pipelining) at
    N=1 per slot, with the KV-cache reads bounding the score phase; the
    weight streams are shared across the batch."""
    phases = decode_step_phases(w, kv_pos, batch)
    noi_t, ev = _phase_noi_times(placement, phases, scenario)
    noi_by = {p.name: t for p, t in zip(phases, noi_t)}
    by = {p.name: p for p in phases}
    dram_bw = alloc["DRAM"] * C.DRAM.bw

    def sm_rate(dim):
        return (alloc["SM"] * C.SM.peak_flops * calib.sm_efficiency
                * min(1.0, dim / C.SM_SAT_DIM))

    def rer_rate():
        return alloc["ReRAM"] * C.RERAM.peak_flops * calib.reram_fill

    def t_attn(name):
        p = by[name]
        return max(p.sm_flops / sm_rate(w.d_model),
                   p.dram_bytes / dram_bw, noi_by[name])

    def t_reram(name):
        p = by[name]
        return max(p.reram_flops / rer_rate(), noi_by[name])

    times = {"embed_dec": t_reram("embed_dec"), "kqv_dec": t_attn("kqv_dec"),
             "score_dec": t_attn("score_dec"), "ff_dec": t_reram("ff_dec"),
             "lm_head_dec": t_reram("lm_head_dec")}
    stage_attn = times["kqv_dec"] + times["score_dec"]
    if "cross_dec" in by:
        times["cross_dec"] = t_attn("cross_dec")
        stage_attn += times["cross_dec"]
    stage_ff = times["ff_dec"]
    k = max(w.n_dec_layers, 1)
    if w.parallel_mha_ff:
        step = (times["embed_dec"] + k * max(stage_attn, stage_ff)
                + times["lm_head_dec"])
    else:
        step = (times["embed_dec"] + stage_attn
                + (k - 1) * max(stage_attn, stage_ff) + stage_ff
                + times["lm_head_dec"])
    energy = _energy(phases, times, alloc, ev, _DECODE_BUSY)
    return step, energy, ev


def simulate_generation(w: Workload, n_chiplets: int, prompt_len: int,
                        gen_len: int, *, arch: str = "2.5D-HI",
                        placement: Optional[Placement] = None,
                        calib: Calib = CALIB, samples: int = 4,
                        batch: int = 1, scenario=None) -> GenResult:
    """Full generation episode on any of the three architectures.

    TTFT is the calibrated single-pass latency over the prompt plus the
    explicit KV-cache write-back; decode is evaluated at ``samples`` KV
    positions across the episode and averaged (costs are linear in
    position).  ``batch`` runs the decode steps in the continuous-batching
    regime: ``batch`` concurrent same-shape episodes share every step
    (weights stream once per step); ``batch=1`` reproduces the
    single-stream episode bit-identically.  ``scenario`` (a
    ``core.faults.FaultScenario``) degrades the NoI for the whole episode;
    raises ``DisconnectedFabric`` when the surviving fabric cannot route
    the required traffic."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if arch != "2.5D-HI":
        from repro_torch.core import baselines as B  # local import (module cycle)
        fn = {"HAIMA_chiplet": B.simulate_generation_haima,
              "TransPIM_chiplet": B.simulate_generation_transpim}[arch]
        return fn(w, n_chiplets, prompt_len, gen_len, calib=calib,
                  samples=samples, batch=batch, scenario=scenario)

    w = dataclasses.replace(w, seq_len=prompt_len)
    alloc = _alloc(n_chiplets)
    placement = placement or initial_placement(n_chiplets)
    prefill = simulate_2p5d_hi(w, n_chiplets, placement=placement,
                               calib=calib, scenario=scenario)

    # KV write-back rides on top of the calibrated single pass: per-layer
    # commit of the prompt's K/V (or the cross-KV projection) to DRAM
    pre_phases = prefill_phases(w)
    kv_phase = pre_phases[-1]
    kv_noi, kv_ev = _phase_noi_times(placement, [kv_phase], scenario)
    t_kv = max(kv_phase.dram_bytes / (alloc["DRAM"] * C.DRAM.bw), kv_noi[0])
    kv_energy = _energy([kv_phase], {"kv_write": t_kv}, alloc, kv_ev,
                        {"kv_write": {"MC"}})
    ttft = prefill.latency_s + t_kv * kv_phase.repeat

    steps = max(gen_len - 1, 0)
    step_t, step_e, ev = [], [], None
    for pos in _decode_positions(prompt_len, gen_len, samples):
        t, e, ev = _hi_decode_step(w, alloc, placement, pos, calib, batch,
                                   scenario)
        step_t.append(t)
        step_e.append(e)
    decode_step = sum(step_t) / len(step_t)
    # per-episode shares: the batched step's energy/traffic serve `batch`
    # concurrent streams (x / 1 is exact, so batch=1 is bit-identical)
    decode_energy = steps * sum(step_e) / len(step_e) / batch

    mid = _decode_positions(prompt_len, gen_len, 1)[0]
    decode_bytes = (steps * total_traffic_bytes(decode_step_phases(w, mid,
                                                                   batch))
                    / batch)
    return GenResult(
        arch="2.5D-HI", workload=w.name, n_chiplets=n_chiplets,
        prompt_len=prompt_len, gen_len=gen_len, ttft_s=ttft,
        decode_step_s=decode_step, latency_s=ttft + steps * decode_step,
        energy_j=prefill.energy_j + kv_energy + decode_energy,
        prefill_bytes=total_traffic_bytes(pre_phases),
        decode_bytes=decode_bytes, prefill=prefill, noi=ev, batch=batch)


# ---------------------------------------------------------------------------
# calibration (§4 Table-4 anchors; see DESIGN.md §6)
# ---------------------------------------------------------------------------

# Table 4 anchors (ms): the ONLY numbers any free scalar is fitted to.
ANCHORS = {
    "2.5D-HI": (("bert-base", 64, 36, 50.0), ("gpt-j", 64, 100, 143.0)),
    "HAIMA_chiplet": (("bert-base", 64, 36, 340.0),
                      ("gpt-j", 64, 100, 975.0)),
    "TransPIM_chiplet": (("bert-base", 64, 36, 210.0),
                         ("gpt-j", 64, 100, 1435.0)),
}


def _hi_residual(calib: Calib, workloads: dict) -> float:
    r = 0.0
    for arch, n, chips, target_ms in ANCHORS["2.5D-HI"]:
        res = simulate_2p5d_hi(workloads[(arch, n)], chips, calib=calib)
        r += math.log(res.latency_s * 1e3 / target_ms) ** 2
    return r


def calibrate(verbose: bool = False) -> Calib:
    """Fit the free scalars to the Table-4 anchors.

    2.5D-HI: 2 scalars (sm_efficiency, reram_fill) ↔ 2 anchors —
    coarse→fine log-grid search.  Each baseline: 1 throughput scalar ↔ its
    own 36-chiplet anchor — log-bisection (latency is monotone in the
    scalar).  Everything else in Plane B stays at its Table-1 value.
    """
    from repro_torch.config import get_config

    workloads = {(a, n): Workload.from_config(get_config(a), seq_len=n)
                 for a, n, _, _ in (ANCHORS["2.5D-HI"]
                                    + ANCHORS["HAIMA_chiplet"]
                                    + ANCHORS["TransPIM_chiplet"])}

    # --- 2.5D-HI: 2-D log-grid, 3 refinement rounds ----------------------
    lo = (math.log(1e-4), math.log(1e-4))
    hi = (math.log(1.0), math.log(1.0))
    best = (float("inf"), None)
    for _round in range(4):
        g0 = [lo[0] + (hi[0] - lo[0]) * i / 23 for i in range(24)]
        g1 = [lo[1] + (hi[1] - lo[1]) * i / 23 for i in range(24)]
        for a in g0:
            for b in g1:
                c = dataclasses.replace(CALIB, sm_efficiency=math.exp(a),
                                        reram_fill=math.exp(b))
                r = _hi_residual(c, workloads)
                if r < best[0]:
                    best = (r, (a, b))
        (a, b) = best[1]
        da = (hi[0] - lo[0]) / 23
        db = (hi[1] - lo[1]) / 23
        lo, hi = (a - da, b - db), (a + da, b + db)
    sm_eff, fill = math.exp(best[1][0]), math.exp(best[1][1])

    # --- baselines: 2 scalars ↔ 2 anchors each ----------------------------
    # The GPT-J anchor pins the throughput eff (its kqv/ff dims saturate the
    # util curve, so the exponent is inert there); the BERT anchor then pins
    # the bank-parallelism scale exponent.
    def fit_baseline(sim_fn, eff_field: str, exp_field: str, anchors):
        bert_anchor, gptj_anchor = anchors

        def latency_ms(eff, exp, anchor):
            arch, n, chips, _ = anchor
            c = dataclasses.replace(CALIB, **{eff_field: eff, exp_field: exp})
            return sim_fn(workloads[(arch, n)], chips, calib=c).latency_s * 1e3

        lo_e, hi_e = 1e-6, 1.0            # eff ↔ GPT-J (decreasing)
        for _ in range(60):
            mid = math.sqrt(lo_e * hi_e)
            if latency_ms(mid, 1.0, gptj_anchor) > gptj_anchor[3]:
                lo_e = mid
            else:
                hi_e = mid
        eff = math.sqrt(lo_e * hi_e)

        lo_x, hi_x = 0.2, 4.0             # exp ↔ BERT (increasing)
        for _ in range(60):
            mid = 0.5 * (lo_x + hi_x)
            if latency_ms(eff, mid, bert_anchor) < bert_anchor[3]:
                lo_x = mid
            else:
                hi_x = mid
        return eff, 0.5 * (lo_x + hi_x)

    from repro_torch.core import baselines as B  # local import (module cycle)
    haima_eff, haima_exp = fit_baseline(
        B.simulate_haima_chiplet, "haima_eff", "haima_scale_exp",
        ANCHORS["HAIMA_chiplet"])
    transpim_eff, transpim_exp = fit_baseline(
        B.simulate_transpim_chiplet, "transpim_eff", "transpim_scale_exp",
        ANCHORS["TransPIM_chiplet"])

    fitted = Calib(sm_efficiency=sm_eff, reram_fill=fill,
                   haima_eff=haima_eff, transpim_eff=transpim_eff,
                   haima_scale_exp=haima_exp, transpim_scale_exp=transpim_exp,
                   orig_bank_cap=CALIB.orig_bank_cap)
    if verbose:
        print(f"fitted: sm_efficiency={sm_eff:.5g} reram_fill={fill:.5g} "
              f"haima_eff={haima_eff:.5g} haima_scale_exp={haima_exp:.4f} "
              f"transpim_eff={transpim_eff:.5g} "
              f"transpim_scale_exp={transpim_exp:.4f}")
        for arch, n, chips, target in ANCHORS["2.5D-HI"]:
            res = simulate_2p5d_hi(workloads[(arch, n)], chips, calib=fitted)
            print(f"  2.5D-HI {arch} n={n} {chips}c: {res.latency_s*1e3:.1f} ms "
                  f"(anchor {target})")
        for name, fn in (("HAIMA_chiplet", B.simulate_haima_chiplet),
                         ("TransPIM_chiplet", B.simulate_transpim_chiplet)):
            for arch, n, chips, target in ANCHORS[name]:
                res = fn(workloads[(arch, n)], chips, calib=fitted)
                print(f"  {name} {arch} n={n} {chips}c: "
                      f"{res.latency_s*1e3:.1f} ms (anchor {target})")
    return fitted


if __name__ == "__main__":
    calibrate(verbose=True)
