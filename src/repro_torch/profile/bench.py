"""Deterministic kernel/phase micro-timer — the Plane-A side of the
measured-cost calibration plane (counterpart of the reference's
``profile/bench.py``).

Methodology
-----------
Every timed case is a zero-argument callable.  It runs ``warmup`` calls
first — the first call's wall time (the kernel library's load, first
allocations) is reported separately as ``compile_s`` — then ``repeat``
steady-state calls, each ended by ``torch.cuda.synchronize`` when its
output lies on a card, so asynchronous launches cannot leak device work
out of the timed region.  The statistic handed to the cost-model fit is
the steady-state *minimum*: timing noise on a shared machine is strictly
additive, so min-of-k is the stable estimator.

The clock and the synchronisation are injectable (``clock=``,
``sync=``), so tests drive the timer with a fake clock and assert the
bookkeeping deterministically.  On the card the cases launch the port's
CUDA kernels (``decode.cu``, ``decode_quant.cu``, ``prefill.cu``,
``qmatmul.cu``) and the engine's captured decode step; with
``device="cpu"`` the kernel wrappers run their plain PyTorch versions
and the engine its eager step — rates fitted there calibrate the plain
versions, not a device.  Without a card and without an explicit CPU
device the samplers raise.

Every :class:`Sample` carries the ``core.traffic`` byte/FLOP terms of
its invocation next to the measured seconds, so ``profile.costmodel``
can fit time as an affine model *in the analytical regressors* — the
whole point of the calibration plane is that Plane B and the fits share
one vocabulary of terms.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.config import get_config, reduce_config
from repro_torch.core import traffic
from repro_torch.core.traffic import Workload

__all__ = [
    "Timing", "Sample", "measure", "interpret_default",
    "kernel_samples", "executor_samples", "kernel_case",
]


def interpret_default(device=None) -> bool:
    """Whether the plain PyTorch versions run in place of the CUDA kernels:
    only on an explicit CPU ``device``.  ``None`` is the card, and without
    one this raises."""
    return resolve_device(device).type == "cpu"


def _sync(x):
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _config(arch: str, reduce: bool):
    cfg = get_config(arch)
    return reduce_config(cfg) if reduce else cfg


@dataclasses.dataclass(frozen=True)
class Timing:
    """One timed case: first-call cost split from steady state."""
    compile_s: float              # first call (kernel load, allocations)
    times_s: tuple[float, ...]    # steady-state calls, in order

    @property
    def best_s(self) -> float:
        return min(self.times_s)

    @property
    def median_s(self) -> float:
        ts = sorted(self.times_s)
        return ts[len(ts) // 2]


def measure(fn: Callable[[], object], *, warmup: int = 1, repeat: int = 3,
            clock: Callable[[], float] = time.perf_counter,
            sync: Optional[Callable] = _sync) -> Timing:
    """Time ``fn`` with the warmup/steady-state split described above."""
    if warmup < 1 or repeat < 1:
        raise ValueError("measure needs warmup >= 1 and repeat >= 1")
    compile_s = 0.0
    for i in range(warmup):
        t0 = clock()
        out = fn()
        if sync is not None:
            sync(out)
        dt = clock() - t0
        if i == 0:
            compile_s = dt
    times = []
    for _ in range(repeat):
        t0 = clock()
        out = fn()
        if sync is not None:
            sync(out)
        times.append(clock() - t0)
    return Timing(compile_s=compile_s, times_s=tuple(times))


@dataclasses.dataclass(frozen=True)
class Sample:
    """One timed grid point with its analytical regressors.

    ``bytes_term``/``flops_term`` are computed from the *same*
    ``core.traffic`` formulas Plane B charges for the matching phase, so
    a fit against them yields directly comparable effective rates.
    """
    kind: str          # phase class ("decode_attn", "prefill_attn", ...)
    arch: str
    params: dict       # grid point (batch, kv len, seq, dims, ...)
    bytes_term: float
    flops_term: float
    seconds: float     # steady-state best
    compile_s: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Sample":
        return cls(**d)


# ---------------------------------------------------------------------------
# kernel grid: decode attention (fp / kv8 / kv4), segmented prefill,
# fused dequant-matmul — the port's kernels, timed
# ---------------------------------------------------------------------------

# one grid point: its kernel call, the plain version of the same call on
# the same inputs (for checks; never timed), and its traffic terms
Case = collections.namedtuple("Case", "call plain bytes_term flops_term")
PLAIN_HEADS = 4            # heads a call of the plain prefill


def _randn(generator, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype)


def _decode_case(cfg, batch: int, skv: int, kv_bits: int, *,
                 generator: torch.Generator) -> Case:
    """A decode-attention invocation over a full pool + its traffic terms.

    The reference picks the Pallas kernel's ``block_k``; the CUDA kernels
    take no block argument (they plan their own splits of the pool:
    ``decode.decode_splits``), so there is none here."""
    from repro_torch.kernels.flash_attention.decode import (
        flash_decode_fwd, flash_decode_plain, flash_decode_quant_fwd,
        flash_decode_quant_plain)
    from repro_torch.quant.core import quantize_kv

    Hq, Hkv, hd = cfg.n_heads, max(cfg.n_kv_heads or cfg.n_heads, 1), cfg.head_dim
    dev = generator.device
    q = _randn(generator, (batch, 1, Hq, hd))
    k = _randn(generator, (batch, skv, Hkv, hd))
    v = _randn(generator, (batch, skv, Hkv, hd))
    q_pos = torch.full((batch, 1), skv - 1, dtype=torch.int32, device=dev)
    kv_pos = torch.arange(skv, dtype=torch.int32, device=dev).expand(
        batch, skv).contiguous()
    pos = dict(q_pos=q_pos, kv_pos=kv_pos)

    if kv_bits:
        k_q, k_s = quantize_kv(k, kv_bits)
        v_q, v_s = quantize_kv(v, kv_bits)
        pool = (q, k_q, k_s, v_q, v_s)
        pos["kv_bits"] = kv_bits
        fwd, plain = flash_decode_quant_fwd, flash_decode_quant_plain
    else:
        pool = (q, k, v)
        fwd, plain = flash_decode_fwd, flash_decode_plain
    del k, v

    # regressors: the per-layer KV stream Plane B charges for score_dec —
    # traffic.kv_cache_bytes_per_layer at the pool depth, once per slot
    w = Workload.from_config(cfg, seq_len=skv, kv_bits=kv_bits or 16)
    bytes_term = batch * traffic.kv_cache_bytes_per_layer(w, skv)
    flops_term = 4.0 * batch * Hq * skv * hd       # QK^T + PV, one query row
    return Case(lambda: fwd(*pool, **pos), lambda: plain(*pool, **pos),
                bytes_term, flops_term)


def _prefill_case(cfg, batch: int, seq: int, *, seg_len: int,
                  generator: torch.Generator) -> Case:
    """Segmented (packed-prompt) causal prefill attention + traffic terms.

    The reference's ``block_q``/``block_k`` have no counterpart: the CUDA
    kernel plans its own blocks (``kernel.prefill_plan``)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)

    Hq, hd = cfg.n_heads, cfg.head_dim
    q = _randn(generator, (batch, Hq, seq, hd))
    k = _randn(generator, (batch, Hq, seq, hd))
    v = _randn(generator, (batch, Hq, seq, hd))
    seg = (torch.arange(seq, dtype=torch.int32, device=generator.device)
           // seg_len).expand(batch, seq).contiguous()
    args = dict(segments=seg, causal=True)

    # regressors: the full-sequence score phase transformer_phases
    # charges, quadratic in S.  The Pallas kernel sweeps the causal S^2
    # block grid whatever the segments; prefill.cu skips every key tile
    # with no live same-segment pair, so its work is about S * seg_len
    # (causally halved) and it follows this term only while one segment
    # fills a row (seg_len >= seq): time it so on the card
    w = Workload.from_config(cfg, seq_len=seq)
    score = next(p for p in traffic.transformer_phases(w)
                 if p.name == "score")
    flops_term = batch * score.sm_flops
    bytes_term = batch * traffic.phase_bytes(score)

    def plain():
        # the plain version holds (B, H, S, S) f32 scores: run it a batch
        # row and PLAIN_HEADS heads at a time (each independent)
        return torch.cat([torch.cat([flash_attention_plain(
            q[b:b + 1, h:h + PLAIN_HEADS], k[b:b + 1, h:h + PLAIN_HEADS],
            v[b:b + 1, h:h + PLAIN_HEADS], segments=seg[b:b + 1], causal=True)
            for h in range(0, Hq, PLAIN_HEADS)], dim=1) for b in range(batch)])
    return Case(lambda: flash_attention_fwd(q, k, v, **args), plain,
                bytes_term, flops_term)


def _qmm_case(cfg, m: int, k_dim: int, n_dim: int, bits: int, *,
              generator: torch.Generator) -> Case:
    """Fused dequant-matmul (weight-streaming regime) + traffic terms.

    The reference's ``bm/bn/bk`` have no counterpart: ``qmatmul.cu``
    plans its own tile and K split (``quant.kernel.plan``)."""
    from repro_torch.quant.core import quantize
    from repro_torch.quant.kernel import quant_matmul_fwd, quant_matmul_plain

    x = _randn(generator, (m, k_dim))
    qt = quantize(_randn(generator, (k_dim, n_dim), torch.float32), bits)

    # regressors: the streamed-weight bytes Plane B charges for a
    # quantised (K, N) projection (codes + f32 scale plane)
    w = Workload.from_config(cfg, seq_len=m, weight_bits=bits)
    bytes_term = w.weight_dram_bytes(k_dim, n_dim)
    flops_term = 2.0 * m * k_dim * n_dim
    return Case(lambda: quant_matmul_fwd(x, qt.q, qt.scale, bits=bits),
                lambda: quant_matmul_plain(x, qt.q, qt.scale, bits=bits),
                bytes_term, flops_term)


def kernel_case(kind: str, cfg, params: dict, *,
                generator: torch.Generator) -> Case:
    """The case of one grid point of :func:`kernel_samples` (its ``kind``
    and ``params``), its inputs drawn with ``generator`` on its device."""
    if kind.startswith("decode_attn"):
        bits = params["kv_bits"]
        return _decode_case(cfg, params["batch"], params["kv_len"],
                            0 if bits == 16 else bits, generator=generator)
    if kind == "prefill_attn":
        return _prefill_case(cfg, params["batch"], params["seq"],
                             seg_len=params["seg_len"], generator=generator)
    if kind == "dequant_matmul":
        return _qmm_case(cfg, params["m"], params["k"], params["n"],
                         params["bits"], generator=generator)
    raise ValueError(f"no kernel case of kind {kind!r}")


def kernel_samples(archs: Sequence[str] = ("bert-base", "gpt-j"), *,
                   batches: Sequence[int] = (1, 2),
                   kv_lens: Sequence[int] = (128, 256, 384),
                   kv_bits: Sequence[int] = (0, 8, 4),
                   prefill_lens: Sequence[int] = (128, 256),
                   seg_len: int = 64,
                   qmm_shapes: Sequence[tuple[int, int]] = ((128, 256),
                                                           (256, 256),
                                                           (256, 512)),
                   qmm_m: int = 8,
                   qmm_bits: Sequence[int] = (8,),
                   warmup: int = 1, repeat: int = 3,
                   clock: Callable[[], float] = time.perf_counter,
                   device=None, reduce: bool = True,
                   seed: int = 0) -> list[Sample]:
    """Time the port's kernels across a zoo x batch x KV-position grid and
    return one :class:`Sample` per grid point, in the reference's order.

    Kinds produced: ``decode_attn`` / ``decode_attn_kv8`` /
    ``decode_attn_kv4`` (pool depth = the KV-position axis),
    ``prefill_attn`` (segmented packed prompts), ``dequant_matmul``.
    ``device`` is the card unless given (``"cpu"`` times the plain
    versions); ``reduce=False`` runs the named configs at full width.
    """
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    out: list[Sample] = []
    for arch in archs:
        cfg = _config(arch, reduce)
        points = [("decode_attn" + (f"_kv{bits}" if bits else ""),
                   {"batch": batch, "kv_len": skv, "kv_bits": bits or 16})
                  for bits in kv_bits for batch in batches for skv in kv_lens]
        points += [("prefill_attn",
                    {"batch": batch, "seq": seq, "seg_len": seg_len})
                   for batch in batches for seq in prefill_lens]
        points += [("dequant_matmul",
                    {"m": qmm_m, "k": k_dim, "n": n_dim, "bits": bits})
                   for bits in qmm_bits for (k_dim, n_dim) in qmm_shapes]
        for kind, params in points:
            case = kernel_case(kind, cfg, params, generator=generator)
            t = measure(case.call, warmup=warmup, repeat=repeat, clock=clock)
            out.append(Sample(kind, arch, params, case.bytes_term,
                              case.flops_term, t.best_s, t.compile_s))
            del case                    # free its inputs before the next
    return out


# ---------------------------------------------------------------------------
# executor grid: the engine's fused decode-step program, timed end to end
# ---------------------------------------------------------------------------

def executor_samples(archs: Sequence[str] = ("bert-base",), *,
                     batches: Sequence[int] = (1, 2, 4),
                     kv_len: int = 128, prompt_len: int = 16,
                     impl: str = "ref",
                     warmup: int = 1, repeat: int = 3,
                     steps_per_call: int = 8,
                     clock: Callable[[], float] = time.perf_counter,
                     device=None, reduce: bool = True,
                     seed: int = 0) -> list[Sample]:
    """Time the engine's ``fused_step`` program (decode step over the slot
    pool — the thing a serving decode iteration actually runs): on the
    card the CUDA graph the engine captured, replayed; on the CPU the
    eager step.

    Where the reference chains the donated cache into the next call, the
    port's step writes its pool in place; either way slot positions
    advance one token per step and the byte regressor is evaluated at the
    midpoint of the timed window.  The budget ``kv_len - prompt_len - 2``
    keeps every slot live through it.  Each timed call runs
    ``steps_per_call`` steps and reports the per-step time, amortising
    scheduler jitter over the chain.  ``device`` and ``reduce`` as in
    :func:`kernel_samples`.
    """
    import repro_torch.models.transformer as T
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    dev = resolve_device(device)
    out: list[Sample] = []
    for arch in archs:
        cfg = _config(arch, reduce)
        for batch in batches:
            params = T.init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed),
                device=dev, dtype=torch.bfloat16)
            eng = ServingEngine(cfg, params, EngineConfig(
                max_batch=batch, kv_len=kv_len,
                max_new_tokens=kv_len - prompt_len - 2,
                impl=impl, fused=True, packed=True, seed=seed), device=dev)
            for i in range(batch):
                eng.submit([(7 * i + j) % 97 + 1 for j in range(prompt_len)])
            eng.step()                      # admit + first decode step

            def call(eng=eng):
                packed = None
                for _ in range(steps_per_call):
                    packed = eng.executor.run("fused_step", eng.pool)
                return packed

            t = measure(call, warmup=warmup, repeat=repeat, clock=clock)
            t = Timing(compile_s=t.compile_s,
                       times_s=tuple(x / steps_per_call for x in t.times_s))
            del eng, params, call
            # positions at the midpoint of the steady-state window
            mid = (prompt_len + 1
                   + steps_per_call * (warmup + repeat // 2))
            w = Workload.from_config(cfg, seq_len=kv_len)
            phases = traffic.decode_step_phases(w, [mid] * batch,
                                                batch=batch)
            bytes_term = traffic.total_traffic_bytes(phases)
            flops_term = sum(p.repeat * (p.sm_flops + p.reram_flops)
                             for p in phases)
            out.append(Sample("executor_step", arch,
                              {"batch": batch, "kv_len": kv_len,
                               "pos": mid, "impl": impl},
                              bytes_term, flops_term, t.best_s, t.compile_s))
    return out
