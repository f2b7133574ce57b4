#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which must pass or the script exits non-zero:

1. device  — the card's name and power limit, as nvidia-smi reports them;
2. build   — the CUDA kernels of ``src/repro_torch/kernels/csrc`` built with
             nvcc (``repro_torch.kernels.build``);
3. kernels — each of the five kernels against its plain PyTorch version on
             the card, at the serving path's shapes (qwen2.5-3b's and
             gemma2-9b's: every projection, the 5120-entry global pool and
             the 4096-entry ring at head dim 256) and at edge cases
             (window, softcap, an empty slot, a pad-only tile, ragged
             lengths and shapes, GQA rep 1 and 8, f32, head_dim 256, int8 and
             int4, per-channel and per-group scales, M from 1 to 1024), with
             its time (at both models' shapes), the plain version's time, one
             PyTorch call's time (a
             yardstick the port never calls: ``scaled_dot_product_attention``
             with an explicit mask for attention, ``torch.matmul`` with the
             dequantised bf16 weights for the matmuls) and its bound; each
             dequant-matmul and prefill case prints the design it ran
             (tensor cores or CUDA cores) and is checked to run the one its
             dtype, head dims and group call for; each decode case, fp and
             quantised, prints its kernel and split count (wholly masked
             splits, one split, rep 16 and rep 32 in two row groups among
             them; fp also f32 hd 256 and V rows not 16-byte aligned;
             quantised also head dims 16 and 6, code rows shorter than 16
             bytes, and rep 20 in f32) and is
             checked to run the split count of its plan; split shapes of
             the dequant-matmul and of both decodes launched on two streams
             at once must give what they give on one, bit for bit; the
             prefill also without segments at the shapes the sequential
             baseline launches (qwen2.5-3b's buckets of 8..1024 tokens,
             gemma2-9b's exact lengths up to 4600 under its window);
4. engine  — the port's serving engine on full-width qwen2.5-3b and
             gemma2-9b (42 layers, local 4096-entry rings and global layers,
             head dim 256) with random bf16 weights, fp and then quantised
             (``w8kv8``, ``w4kv4``): 16 requests (prompts of 4..384 tokens,
             so chunked prefill runs; gemma2-9b adds one of 4600 tokens whose
             rings wrap), greedy, 32 new tokens each, with the launch count of
             each kernel during each run, checked against the run's steps and
             calls, every quantised projection checked to have run on tensor
             cores and every prefill on the design its head dim calls for,
             and every kernel of ``qmatmul.cu``, ``decode.cu``,
             ``decode_quant.cu`` and ``prefill.cu`` it launched checked to be
             one that phase 3 held against its plain version.  The engine
             replays its three programs (fused step, packed prefill, chunk
             step) from CUDA graphs captured when it is built, and traces
             each decode step's wall time (dispatch + fetch);
4a. graphs — each engine run again with its programs run through the
             eager methods: token streams bit for bit and every launch
             count equal (a replay counts what its capture launched);
             tokens/s, TTFT, TPOT, decode-step wall time, build time and
             peak memory, eager and replayed;
4b. baselines — at fp, sequential admission (``packed=False``) on both
             models (gemma2-9b's 4600-token prompt through a batch-1 prefill
             that wraps its rings) and the host-looped step
             (``fused=False``) on qwen2.5-3b, whose streams must equal the
             sequential fused path's bit for bit;
4c. sampling — qwen2.5-3b at temperature 0.8 through the graphs: the
             same seed repeats, another does not, replays draw anew;
5. crossbar — the PIM-MVM entry point ``pim_mvm`` on the shapes of
             ``benchmarks/kernel_micro.py``, f32 x (as there) and bf16 x,
             against its oracle and the fp product, with the kernel's launch
             count, the bf16 calls checked to have run on tensor cores, in
             kernels that phase 3 checked;
6. logits  — packed prefill plus 4 decode steps at full width with
             ``impl="flash"`` against ``impl="ref"``, fp and ``w8kv8``: qwen2.5-3b,
             gemma2-9b (with a 4200-token row: windowed prefill, a wrapped
             ring), gemma3-27b and minitron-8b (depth cut to one pattern
             period plus the remainder); the sequential baseline's
             first-token logits against the packed prefill's;
7. profile — torch.profiler over 4 full-pool decode steps and 2 chunk
             steps (8 rows of a 128-token chunk), fp and ``w8kv8``, of
             qwen2.5-3b and gemma2-9b, replayed and eager: device busy time,
             wall time and kernels launched per step (read, not checked).

Each model's weights are freed before the next is made.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits 1
and prints no result.
"""
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
L2_BYTES = 50e6                    # H100 SXM L2
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.bfloat16": 1e-2, "torch.float32": 2e-5}
# dequant-matmul: error relative to the plain version's largest magnitude
# (bf16: one output rounding after a long f32 sum in another order)
MATMUL_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}
QUANT_RUNS = {"fp": dict(), "w8kv8": dict(weight_bits=8, kv_bits=8),
              "w4kv4": dict(weight_bits=4, kv_bits=4)}
MAX_BATCH, NEW_TOKENS, N_REQUESTS, CHUNK = 8, 32, 16, 128
# the served models at full width and depth: the pool's length, prompts
# beside the 16 of 4..384 tokens, and a long row of the logits phase
# (gemma2-9b's 4600 and 4200 wrap its 4096-entry local rings: in chunked
# prefill and decode, and in the packed prefill's insert)
SERVED = {"qwen2.5-3b": dict(kv_len=1024, long_prompts=(), logits_row=0),
          "gemma2-9b": dict(kv_len=5120, long_prompts=(4600,), logits_row=4200)}
# logits only, full width at a cut depth: one pattern period plus the
# remainder (gemma3-27b: qk-norm at head dim 128; minitron-8b: the untied
# 256000-column lm_head, ReLU^2 without GLU)
LOGITS_ONLY = {"gemma3-27b": 8, "minitron-8b": 2}
# gemma2-9b's attention as the engine runs it: 8 slots, 16 query heads over
# 8 KV heads of dim 256, a 5120-entry global pool and 4096-entry local rings
# (window 4096), attention softcap 50
GEMMA2_DECODE = dict(B=8, Skv=5120, Hq=16, Hkv=8, hd=256, softcap=50.0)
GEMMA2_RING = dict(B=8, Skv=4096, Hq=16, Hkv=8, hd=256, window=4096, softcap=50.0,
                   ring=True)
GEMMA2_PREFILL = dict(S=128, Hq=16, Hkv=8, hd=256, window=4096, softcap=50.0)
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def device_ms(fn, iters, warmup=3):
    """Mean device time of one call (ms): the kernel time torch.profiler
    records over ``iters`` calls, summed and divided by ``iters`` — what
    the card spends on a call, without the host's gaps between launches
    (CUDA events around a loop of calls this small would time the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    check(busy_us > 0, "the profiler recorded no device time")
    return busy_us / 1e3 / iters


def bound(nbytes, flops, dtype):
    """Least time on the card (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def decode_case(torch, rng, *, B=8, Skv=1024, Hq=16, Hkv=2, hd=128, lens=None,
                window=0, softcap=0.0, ring=False, empty=(), dtype=None, copies=1,
                hdv=None, v_offset=0):
    """Inputs of one decode call; ``copies`` distinct K/V pools (to time
    with a cold L2, as each layer's pool is); V rows of ``hdv`` (default
    hd).  ``v_offset`` > 0 makes V a view that starts that many elements
    into wider rows (V not 16-byte aligned)."""
    hdv = hdv or hd
    dtype = dtype or torch.bfloat16
    dev = DEVICE
    lens = rng.integers(64, Skv + 1, B) if lens is None else np.asarray(lens)
    kv_pos = np.full((B, Skv), -1, np.int32)
    for b, n in enumerate(lens):
        if b in empty:
            continue
        if ring:                       # a wrapped ring, scrambled, with holes
            n = Skv + int(n)
            s = np.arange(Skv)
            kv_pos[b] = n - 1 - ((n - 1 - s) % Skv)
            kv_pos[b, rng.choice(Skv, Skv // 8, replace=False)] = -1
        else:
            kv_pos[b, :n] = np.arange(n)
    q_pos = np.maximum(kv_pos.max(axis=1, keepdims=True), 0).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q = torch.randn((B, 1, Hq, hd), generator=g, device=dev).to(dtype)
    pools = [(torch.randn((B, Skv, Hkv, hd), generator=g, device=dev).to(dtype),
              torch.randn((B, Skv, Hkv, hdv + v_offset), generator=g,
                          device=dev).to(dtype)[..., v_offset:])
             for _ in range(copies)]
    return dict(q=q, pools=pools, q_pos=torch.from_numpy(q_pos).to(dev),
                kv_pos=torch.from_numpy(kv_pos).to(dev), window=window,
                softcap=softcap, kv_pos_np=kv_pos, q_pos_np=q_pos)


def prefill_case(torch, rng, *, S=128, Hq=16, Hkv=2, hd=128, lens=(37, 50, 20),
                 window=0, softcap=0.0, segmented=True, dtype=None):
    dtype = dtype or torch.bfloat16
    dev = DEVICE
    seg = np.full((1, S), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i
        off += n
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q = torch.randn((1, Hq, S, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((1, Hkv, S, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((1, Hkv, S, hd), generator=g, device=dev).to(dtype)
    return dict(q=q, k=k, v=v, window=window, softcap=softcap,
                segments=torch.from_numpy(seg).to(dev) if segmented else None,
                seg_np=seg if segmented else None)


# the kernels of prefill.cu, decode.cu and decode_quant.cu (their wrappers'
# kernel_launches / quant_kernel_launches keys) that some case of
# run_kernel_checks / run_quant_decode_checks held against the plain version
CHECKED_PREFILL = set()
CHECKED_DECODE = set()
CHECKED_DECODE_QUANT = set()


def ran_one(counter, fn, what):
    """Call ``fn`` and return its output and the one kernel it launched, by
    the key of the wrapper's launch ``counter``."""
    before = counter.copy()
    out = fn()
    ran = list((counter - before).elements())
    check(len(ran) == 1, f"expected one {what} launch, saw {ran}")
    return out, ran[0]


def attention_kernel_name(k):
    dtype = k.dtype.split(".")[-1]
    if hasattr(k, "bits"):
        return f"int{k.bits}/{dtype}/rows{k.rows}/dims{k.dims}/splits{k.splits}"
    if hasattr(k, "splits"):
        return f"{dtype}/rows{k.rows}/dims{k.dims}/splits{k.splits}"
    return f"{k.design}/heads{k.heads}/rows{k.rows}/{dtype}"


def masked_splits(kv_pos, sp):
    """(slot, split) pairs of a split plan whose every pool entry is empty."""
    valid, n = kv_pos >= 0, sp.tiles * 32
    return sum(int(not valid[b, s * n:(s + 1) * n].any())
               for b in range(valid.shape[0]) for s in range(sp.splits))


def two_streams(torch, calls):
    """Each of ``calls`` launched 20 times over two streams at once, in
    turns: True when every output equals what the call gives alone, bit
    for bit (each stream's split tickets are its own, and splits are
    merged in a fixed order)."""
    alone = [f() for f in calls]
    streams = [torch.cuda.Stream(device=DEVICE) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for r in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                j = (r + i) % len(calls)
                outs.append((j, calls[j]()))
    torch.cuda.synchronize()
    return len(outs), all(torch.equal(out, alone[j]) for j, out in outs)


def expected_prefill_design(dtype, hd):
    """Tensor cores for bf16 with head dim 64 or 128 (prefill.cu's plan);
    CUDA cores otherwise."""
    import torch
    return "tensor_core" if dtype == torch.bfloat16 and hd in (64, 128) else "cuda_core"


def check_attention_checked(what, kernels, checked):
    """Every kernel of prefill.cu, decode.cu or decode_quant.cu that
    ``what`` launched was held against its plain version in phase 3."""
    missed = sorted(attention_kernel_name(k) for k in kernels if k not in checked)
    check(not missed, f"{what}: attention kernels launched but never checked: {missed}")


def decode_timing(torch, rng, kw):
    """Device time of the fp decode at a shape (``decode_case``'s keywords),
    cycling over pools that span twice the L2, beside its plain version, its
    bound and ``scaled_dot_product_attention`` over the same pools and mask
    (without a softcap, which it lacks)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.decode import (decode_splits,
                                                            flash_decode_fwd,
                                                            flash_decode_plain,
                                                            row_groups)
    from repro_torch.kernels.flash_attention.decode import kernel_launches as decode_launches
    from repro_torch.kernels.scratch import sm_count
    shape = dict(dict(B=8, Skv=1024, Hkv=2, hd=128), **kw)
    pool_bytes = 2 * shape["B"] * shape["Skv"] * shape["Hkv"] * shape["hd"] * 2
    c = decode_case(torch, rng, copies=cold_copies(pool_bytes), **kw)
    B, Skv, Hkv, hd = c["pools"][0][0].shape
    Hq = c["q"].shape[2]
    nxt = cycler(c["pools"])
    args = dict(q_pos=c["q_pos"], kv_pos=c["kv_pos"], window=c["window"],
                softcap=c["softcap"])
    _, kernel = ran_one(decode_launches, lambda: flash_decode_fwd(c["q"], *nxt(), **args),
                        "decode")
    sp = decode_splits(B, Hkv * row_groups(Hq // Hkv)[0], Skv, sm_count(c["q"].device))
    ms = device_ms(lambda: flash_decode_fwd(c["q"], *nxt(), **args), 200)
    plain_ms = device_ms(lambda: flash_decode_plain(c["q"], *nxt(), **args), 20)
    mask = (c["kv_pos"] >= 0) & (c["kv_pos"] <= c["q_pos"])
    if c["window"]:
        mask &= c["q_pos"] - c["kv_pos"] < c["window"]
    qt = c["q"].transpose(1, 2)
    nxt_lib = cycler([(k.transpose(1, 2), v.transpose(1, 2)) for k, v in c["pools"]])
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, *nxt_lib(), attn_mask=mask[:, None, None, :], enable_gqa=True), 100)
    valid = int(mask.sum().item())
    esz = c["q"].element_size()
    nbytes = (2 * B * Hq * hd * esz                       # q in, out
              + 2 * valid * Hkv * hd * esz                # valid K and V rows
              + c["kv_pos_np"].nbytes + c["q_pos_np"].nbytes)
    flops = 4 * valid * Hq * hd                           # QK^T and PV
    b_ms, b_by = bound(nbytes, flops, str(c["q"].dtype))
    name = attention_kernel_name(kernel)
    print(f"kernel flash_decode timing shape={[B, Skv, Hq, Hkv, hd]} kernel={name} "
          f"splits={sp.splits} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "shape": [B, Skv, Hq, Hkv, hd], "kernel": name,
            "splits": sp.splits, "valid_entries": valid, "window": c["window"],
            "softcap": c["softcap"]}


def run_kernel_checks(torch):
    from repro_torch.kernels.flash_attention.decode import (decode_splits,
                                                            flash_decode_fwd,
                                                            flash_decode_plain,
                                                            row_groups)
    from repro_torch.kernels.flash_attention.decode import kernel_launches as decode_launches
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                            flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill_launches
    from repro_torch.kernels.scratch import sm_count
    rng = np.random.default_rng(0)
    sms = sm_count(torch.device(DEVICE))
    records = {}

    def plan(k, Hq):
        B, Skv, Hkv = k.shape[:3]
        return decode_splits(B, Hkv * row_groups(Hq // Hkv)[0], Skv, sms)

    # -- decode ---------------------------------------------------------------
    cases = {
        "main B8 Skv1024 Hq16 Hkv2 hd128": dict(),
        "window256 softcap50": dict(window=256, softcap=50.0),
        "empty slots 0,5": dict(empty=(0, 5)),
        "ring scrambled with holes": dict(ring=True),
        "Skv1000 (not a multiple of 128)": dict(Skv=1000),
        "rep1 Hq8 Hkv8": dict(Hq=8, Hkv=8),
        "rep8 hd256 Skv300": dict(Hq=16, Hkv=2, hd=256, Skv=300),
        "f32 B3 Skv200 rep4": dict(B=3, Skv=200, Hq=8, Hkv=2, dtype=torch.float32),
    }
    # the split-KV cases draw from a generator of their own, so the timed
    # inputs below stay those that earlier versions of the kernel were timed on
    rng_split = np.random.default_rng(6)
    split_cases = {
        "short slots: wholly masked splits": dict(lens=[40, 90, 1, 33, 64, 100, 2, 70]),
        "B40 Hkv4: one split": dict(B=40, Hq=16, Hkv=4),
        "rep16 Hq16 Hkv1": dict(Hq=16, Hkv=1),
        "rep32 Hq32 Hkv1: two row groups": dict(Hq=32, Hkv=1),
        "f32 hd256 rep2 Skv300 (gemma2-9b heads)": dict(Skv=300, Hq=16, Hkv=8, hd=256,
                                                        dtype=torch.float32),
        "V not 16-byte aligned (2-byte)": dict(v_offset=1),
        "V not 16-byte aligned (4-byte)": dict(v_offset=2),
        "hd96 hdv64 (hd != hdv, 12 pieces a K row)": dict(hd=96, hdv=64),
        # one split of 532 tiles: the kernel walks it in two chunks of tile masks
        "one split over 17000 entries": dict(B=40, Hkv=4, Skv=17000,
                                             lens=[17000 - 400 * b for b in range(40)]),
        "gemma2-9b global B8 Skv5120 Hq16 Hkv8 hd256 softcap50": GEMMA2_DECODE,
        "gemma2-9b ring B8 Skv4096 hd256 window4096 softcap50": GEMMA2_RING,
    }
    errs = []
    for name, kw, case_rng in ([(n, kw, rng) for n, kw in cases.items()]
                               + [(n, kw, rng_split) for n, kw in split_cases.items()]):
        c = decode_case(torch, case_rng, **kw)
        k, v = c["pools"][0]
        args = dict(q_pos=c["q_pos"], kv_pos=c["kv_pos"], window=c["window"],
                    softcap=c["softcap"])
        out, kernel = ran_one(decode_launches, lambda: flash_decode_fwd(c["q"], k, v, **args),
                              "decode")
        CHECKED_DECODE.add(kernel)
        ref = flash_decode_plain(c["q"], k, v, **args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(c["q"].dtype)]
        empty_ok = all(bool((out[b] == 0).all()) for b in kw.get("empty", ()))
        sp = plan(k, c["q"].shape[2])
        print(f"kernel flash_decode case={name!r} splits={sp.splits} tiles_a_split={sp.tiles} "
              f"wholly_masked_splits={masked_splits(c['kv_pos_np'], sp)} "
              f"kernel={attention_kernel_name(kernel)} max_abs_err={err:.3e} tol={tol:g}"
              f" empty_slots_zero={empty_ok}")
        check(np.isfinite(err) and err <= tol and empty_ok,
              f"decode kernel disagrees with its plain version ({name})")
        check(kernel.splits == sp.splits, f"decode ({name}) ran {kernel.splits} splits, "
              f"its plan {sp.splits}")
        errs.append({"case": name, "splits": sp.splits, "max_abs_err": err, "tol": tol})

    # split shapes of two kernels (bf16 rows1/dims4, f32 rows1/dims8)
    calls = []
    for kw in (dict(), dict(Skv=300, Hq=16, Hkv=8, hd=256, dtype=torch.float32)):
        c = decode_case(torch, rng_split, **kw)
        calls.append(functools.partial(flash_decode_fwd, c["q"], *c["pools"][0],
                                       q_pos=c["q_pos"], kv_pos=c["kv_pos"]))
    n, same = two_streams(torch, calls)
    print(f"kernel flash_decode two_streams launches={n} identical={same}")
    check(same, "decode split shapes on two streams differ from one stream")

    t = decode_timing(torch, rng, {})
    records["flash_decode"] = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/flash_attention/decode.py:113",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "shape", "kernel", "splits", "valid_entries")},
        "gemma2_9b": decode_timing(torch, rng_split, GEMMA2_DECODE), "cases": errs}

    # -- packed prefill -------------------------------------------------------
    cases = {
        "main S128 Hq16 Hkv2 hd128, 3 prompts + pad": dict(),
        "window32 softcap50": dict(window=32, softcap=50.0),
        "pad-only tiles (70 real of 128)": dict(lens=(40, 30)),
        "S100 (not a multiple of 32)": dict(S=100, lens=(60, 33)),
        "rep1 Hq16 Hkv16": dict(Hkv=16),
        "rep8 hd256": dict(Hq=8, Hkv=1, hd=256),
        "f32 rep4": dict(Hq=8, Hkv=2, dtype=torch.float32),
        "no segments, causal S256": dict(S=256, segmented=False),
        "long stream S4096 rep8": dict(S=4096, lens=(1500, 2000, 500)),
        "rep1 S2048 Hq4": dict(S=2048, Hq=4, Hkv=4, lens=(2000,)),
        "rep2 hd64": dict(Hq=4, Hkv=2, hd=64),
        "gemma2-9b S128 Hq16 Hkv8 hd256 window4096 softcap50": GEMMA2_PREFILL,
    }
    # the sequential baseline's batch-1 prefills, without segments:
    # qwen2.5-3b's power-of-two buckets, gemma2-9b's exact lengths (its 4600-
    # token prompt under the 4096 window)
    cases.update({f"non-segmented S{S} (a qwen2.5-3b bucket)": dict(S=S, segmented=False)
                  for S in (8, 16, 32, 64, 128, 256, 512, 1024)})
    cases.update({f"non-segmented gemma2-9b S{S} window4096 softcap50":
                  dict(GEMMA2_PREFILL, S=S, segmented=False) for S in (17, 384, 4600)})
    errs = []
    for name, kw in cases.items():
        c = prefill_case(torch, rng, **kw)
        args = dict(segments=c["segments"], window=c["window"], softcap=c["softcap"])
        out, kernel = ran_one(prefill_launches, lambda: flash_attention_fwd(
            c["q"], c["k"], c["v"], **args), "prefill")
        CHECKED_PREFILL.add(kernel)
        ref = flash_attention_plain(c["q"], c["k"], c["v"], **args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(c["q"].dtype)]
        pad_ok = True
        if c["seg_np"] is not None:
            pad = torch.from_numpy(c["seg_np"][0] < 0).to(DEVICE)
            pad_ok = bool((out[:, :, pad] == 0).all())
        want = expected_prefill_design(c["q"].dtype, c["q"].shape[-1])
        print(f"kernel flash_prefill case={name!r} design={kernel.design} "
              f"kernel={attention_kernel_name(kernel)} max_abs_err={err:.3e} tol={tol:g}"
              f" pad_rows_zero={pad_ok}")
        check(np.isfinite(err) and err <= tol and pad_ok,
              f"prefill kernel disagrees with its plain version ({name})")
        check(kernel.design == want, f"prefill ({name}) ran on {kernel.design}, expected {want}")
        errs.append({"case": name, "design": kernel.design, "max_abs_err": err, "tol": tol})

    t = prefill_timing(torch, rng, {})
    records["flash_prefill"] = {
        "name": "flash_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefill.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:123",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "shape", "kernel", "attended_pairs")},
        "gemma2_9b": prefill_timing(torch, rng, GEMMA2_PREFILL), "cases": errs}
    return records


def prefill_timing(torch, rng, kw):
    """Device time of the packed prefill at a shape (``prefill_case``'s
    keywords; three prompts and pad), beside its plain version, its bound
    and ``scaled_dot_product_attention`` with the same mask (without a
    softcap, which it lacks)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                            flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill_launches
    c = prefill_case(torch, rng, **kw)
    _, Hq, S, hd = c["q"].shape
    Hkv = c["k"].shape[1]
    args = dict(segments=c["segments"], window=c["window"], softcap=c["softcap"])
    _, kernel = ran_one(prefill_launches, lambda: flash_attention_fwd(
        c["q"], c["k"], c["v"], **args), "prefill")
    ms = device_ms(lambda: flash_attention_fwd(c["q"], c["k"], c["v"], **args), 200)
    plain_ms = device_ms(lambda: flash_attention_plain(c["q"], c["k"], c["v"], **args), 20)
    seg = c["segments"][0]
    idx = torch.arange(S, device=DEVICE)
    lib_mask = ((seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
                & (idx[None, :] <= idx[:, None]))
    if c["window"]:
        lib_mask &= idx[:, None] - idx[None, :] < c["window"]
    lib_mask = lib_mask[None, None]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        c["q"], c["k"], c["v"], attn_mask=lib_mask, enable_gqa=True), 200)
    pairs = int(lib_mask.sum().item())                     # attended (q, k) pairs
    esz = c["q"].element_size()
    nbytes = (2 * Hq * S * hd + 2 * Hkv * S * hd) * esz + c["seg_np"].nbytes
    flops = 4 * pairs * Hq * hd
    b_ms, b_by = bound(nbytes, flops, str(c["q"].dtype))
    name = attention_kernel_name(kernel)
    print(f"kernel flash_prefill timing shape={[1, S, Hq, Hkv, hd]} kernel={name} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "shape": [1, S, Hq, Hkv, hd], "kernel": name,
            "design": kernel.design, "attended_pairs": pairs, "softcap": c["softcap"]}


def cold_copies(nbytes):
    """Distinct copies of an operand of ``nbytes`` to cycle over so that
    the copies span twice the L2: each call then reads its operand from
    HBM, as a layer's weights and pool are read once a step."""
    return max(2, -(-int(2 * L2_BYTES) // int(nbytes)))


def cycler(items):
    """A function returning the next of ``items`` on each call (to time
    with a cold L2: each layer's weights and pool are read once a step)."""
    it = iter(range(1 << 30))
    return lambda: items[next(it) % len(items)]


def run_quant_decode_checks(torch):
    """The quantised-pool decode kernel, kv8 and kv4, against its plain
    version; timed at qwen2.5-3b's and gemma2-9b's shapes."""
    from repro_torch.kernels.flash_attention.decode import (decode_splits,
                                                            flash_decode_quant_fwd,
                                                            flash_decode_quant_plain,
                                                            quant_kernel_launches,
                                                            row_groups)
    from repro_torch.kernels.scratch import sm_count
    from repro_torch.quant.core import quantize_kv
    rng = np.random.default_rng(3)
    sms = sm_count(torch.device(DEVICE))

    def quant_case(bits, copies=1, case_rng=rng, **kw):
        c = decode_case(torch, case_rng, copies=copies, **kw)
        c["qpools"] = [(*quantize_kv(k, bits), *quantize_kv(v, bits))
                       for k, v in c.pop("pools")]
        return c

    cases = {
        "main B8 Skv1024 Hq16 Hkv2 hd128": dict(),
        "window256 softcap50": dict(window=256, softcap=50.0),
        "empty slots 0,5": dict(empty=(0, 5)),
        "ring scrambled with holes": dict(ring=True),
        "Skv1000 (not a multiple of 128)": dict(Skv=1000),
        "rep1 Hq8 Hkv8": dict(Hq=8, Hkv=8),
        "rep8 hd256 Skv300": dict(Hq=16, Hkv=2, hd=256, Skv=300),
        "f32 B3 Skv200 rep4": dict(B=3, Skv=200, Hq=8, Hkv=2, dtype=torch.float32),
        "short slots: wholly masked splits": dict(lens=[40, 90, 1, 33, 64, 100, 2, 70]),
        "B40 Hkv4: one split": dict(B=40, Hq=16, Hkv=4),
        "rep16 Hq16 Hkv1": dict(Hq=16, Hkv=1),
    }
    # shapes beyond the serving ones, from a generator of their own (so the
    # timed inputs below stay those that earlier versions were timed on):
    # K code rows of 16 and 8 bytes (kv8, kv4), of 6 and 3 (byte copies, and
    # V rows not whole float4s of the merge), rep above 16, gemma2-9b's pools
    rng_new = np.random.default_rng(7)
    new_cases = {
        "hd16 (reduced configs' head dim)": dict(B=3, Skv=200, Hq=8, Hkv=2, hd=16),
        "hd6 B3 Skv200 (code rows of a few bytes)": dict(B=3, Skv=200, Hq=8, Hkv=2, hd=6),
        "rep32 Hq32 Hkv1: two row groups": dict(Hq=32, Hkv=1),
        "rep20 Hq40 Hkv2 hd16 f32: a short row group": dict(B=3, Skv=200, Hq=40, Hkv=2, hd=16,
                                                           dtype=torch.float32),
        "gemma2-9b global B8 Skv5120 Hq16 Hkv8 hd256 softcap50": GEMMA2_DECODE,
        "gemma2-9b ring B8 Skv4096 hd256 window4096 softcap50": GEMMA2_RING,
    }
    errs = []
    for bits in (8, 4):
        for name, kw, case_rng in ([(n, kw, rng) for n, kw in cases.items()]
                                   + [(n, kw, rng_new) for n, kw in new_cases.items()]):
            c = quant_case(bits, case_rng=case_rng, **kw)
            k_q, k_s, v_q, v_s = c["qpools"][0]
            args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"],
                        window=c["window"], softcap=c["softcap"])
            out, kernel = ran_one(quant_kernel_launches, lambda: flash_decode_quant_fwd(
                c["q"], k_q, k_s, v_q, v_s, **args), "quantised decode")
            CHECKED_DECODE_QUANT.add(kernel)
            ref = flash_decode_quant_plain(c["q"], k_q, k_s, v_q, v_s, **args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(c["q"].dtype)]
            empty_ok = all(bool((out[b] == 0).all()) for b in kw.get("empty", ()))
            B, Skv, Hkv = k_q.shape[:3]
            sp = decode_splits(B, Hkv * row_groups(c["q"].shape[2] // Hkv)[0], Skv, sms)
            print(f"kernel flash_decode_quant kv{bits} case={name!r} splits={sp.splits} "
                  f"tiles_a_split={sp.tiles} "
                  f"wholly_masked_splits={masked_splits(c['kv_pos_np'], sp)} "
                  f"kernel={attention_kernel_name(kernel)} max_abs_err={err:.3e} "
                  f"tol={tol:g} empty_slots_zero={empty_ok}")
            check(np.isfinite(err) and err <= tol and empty_ok,
                  f"quantised decode kernel disagrees with its plain version "
                  f"(kv{bits}, {name})")
            check(kernel.splits == sp.splits, f"quantised decode ({name}) ran "
                  f"{kernel.splits} splits, its plan {sp.splits}")
            errs.append({"case": f"kv{bits} {name}", "splits": sp.splits,
                         "max_abs_err": err, "tol": tol})

    # the split decode launched on two streams at once gives what it gives
    # alone, bit for bit
    calls = []
    for bits in (8, 4):
        c = quant_case(bits)
        args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"])
        calls.append(functools.partial(flash_decode_quant_fwd, c["q"], *c["qpools"][0],
                                       **args))
    n, same = two_streams(torch, calls)
    print(f"kernel flash_decode_quant two_streams launches={n} identical={same}")
    check(same, "quantised decode split shapes on two streams differ from one stream")

    t8, t4 = (quant_decode_timing(torch, rng, bits, {}) for bits in (8, 4))
    g8, g4 = (quant_decode_timing(torch, rng, bits, GEMMA2_DECODE) for bits in (8, 4))
    return {"flash_decode_quant": {
        "name": "flash_decode_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_quant.cu",
        "replaces": "src/repro/kernels/flash_attention/decode.py:226",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        **{k: t8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "shape", "valid_entries", "kernel")},
        "library": "scaled_dot_product_attention over the pools dequantised to bf16",
        "kv_bits": 8, "kv4": t4, "gemma2_9b": {"kv8": g8, "kv4": g4}, "cases": errs}}


def quant_decode_timing(torch, rng, bits, kw):
    """Device time of the quantised decode at a shape (``decode_case``'s
    keywords), cycling over pools that span twice the L2, beside its plain
    version, its bound and ``scaled_dot_product_attention`` over the pools
    dequantised to bf16 (an fp pool, which quantisation replaces; without a
    softcap, which it lacks)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.decode import (flash_decode_quant_fwd,
                                                            flash_decode_quant_plain,
                                                            quant_kernel_launches)
    from repro_torch.quant.core import dequantize_kv, quantize_kv
    shape = dict(dict(B=8, Skv=1024, Hkv=2, hd=128), **kw)
    pool_bytes = 2 * shape["B"] * shape["Skv"] * shape["Hkv"] * (shape["hd"] * bits // 8 + 4)
    c = decode_case(torch, rng, copies=cold_copies(pool_bytes), **kw)
    qpools = [(*quantize_kv(k, bits), *quantize_kv(v, bits)) for k, v in c.pop("pools")]
    B, Skv, Hkv, hdq = qpools[0][0].shape
    Hq, hd = c["q"].shape[2], c["q"].shape[3]
    args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"], window=c["window"],
                softcap=c["softcap"])
    nxt = cycler(qpools)
    _, kernel = ran_one(quant_kernel_launches, lambda: flash_decode_quant_fwd(
        c["q"], *nxt(), **args), "quantised decode")
    ms = device_ms(lambda: flash_decode_quant_fwd(c["q"], *nxt(), **args), 200)
    plain_ms = device_ms(lambda: flash_decode_quant_plain(c["q"], *nxt(), **args), 20)
    mask = (c["kv_pos"] >= 0) & (c["kv_pos"] <= c["q_pos"])
    if c["window"]:
        mask &= c["q_pos"] - c["kv_pos"] < c["window"]
    qt = c["q"].transpose(1, 2)
    lib_pools = [(dequantize_kv(kq, ks, bits).to(c["q"].dtype).transpose(1, 2),
                  dequantize_kv(vq, vs, bits).to(c["q"].dtype).transpose(1, 2))
                 for kq, ks, vq, vs in qpools]
    nxt_lib = cycler(lib_pools)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, *nxt_lib(), attn_mask=mask[:, None, None, :], enable_gqa=True), 100)
    valid = int(mask.sum().item())
    esz = c["q"].element_size()
    nbytes = (2 * B * Hq * hd * esz                     # q in, out
              + 2 * valid * Hkv * (hdq + 4)             # K and V codes + scales
              + c["kv_pos_np"].nbytes + c["q_pos_np"].nbytes)
    b_ms, b_by = bound(nbytes, 4 * valid * Hq * hd, str(c["q"].dtype))
    name = attention_kernel_name(kernel)
    print(f"kernel flash_decode_quant timing kv{bits} shape={[B, Skv, Hq, Hkv, hd]} "
          f"kernel={name} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "shape": [B, Skv, Hq, Hkv, hd], "kernel": name,
            "valid_entries": valid, "window": c["window"], "softcap": c["softcap"]}


def matmul_record(name, source, replaces, errs, ms, plain_ms, library_ms, nbytes,
                  flops, dtype, **extra):
    """A dequant-matmul kernel's JSON record.  Its bound takes the peak of
    x's dtype: the codes are exact in bf16, so a bf16 tensor-core product
    of x and the codes, f32 accumulation and the scales applied per column,
    group or tile compute the same function (this kernel dequantises to
    f32 on CUDA cores instead)."""
    b_ms, b_by = bound(nbytes, flops, dtype)
    print(f"kernel {name} timing ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
          + " ".join(f"{k}={v}" for k, v in extra.items()))
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": max(e["max_abs_err"] for e in errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library": "torch.matmul of x with the weights dequantised to bf16",
            **extra, "cases": errs}


# the kernels of qmatmul.cu (repro_torch.quant.kernel.Kernel) that some
# case of run_matmul_checks held against its plain version
CHECKED_KERNELS = set()


def kernel_name(k):
    return (f"{k.design}/bm{k.bm}/int{k.bits}/{k.scales}/{k.dtype.split('.')[-1]}"
            + ("/split" if k.split else ""))


def ran_kernel(torch, fn):
    """Call ``fn`` and name the kernel of ``qmatmul.cu`` it launched
    (``repro_torch.quant.kernel.kernel_launches``)."""
    from repro_torch.quant.kernel import kernel_launches
    return ran_one(kernel_launches, fn, "dequant-matmul")


def check_kernels_checked(what, kernels):
    """Every kernel of qmatmul.cu that ``what`` launched was held against
    its plain version in run_matmul_checks."""
    missed = sorted(kernel_name(k) for k in kernels if k not in CHECKED_KERNELS)
    check(not missed, f"{what}: dequant-matmul kernels launched but never checked: {missed}")


def expected_design(dtype, group):
    """Tensor cores for bf16 x with a group that is 0 or a multiple of the
    mma depth (16); CUDA cores otherwise (qmatmul.cu's make_plan)."""
    import torch
    return "tensor_core" if dtype == torch.bfloat16 and group % 16 == 0 else "cuda_core"


def check_matmul(torch, label, name, fwd, plain, x, *args, **kw):
    out, kernel = ran_kernel(torch, lambda: fwd(x, *args, **kw))
    design = kernel.design
    CHECKED_KERNELS.add(kernel)
    ref = plain(x, *args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-30)
    tol = MATMUL_TOL[str(x.dtype)]
    want = expected_design(x.dtype, kw.get("group", 0))
    print(f"kernel {label} case={name!r} design={design} kernel={kernel_name(kernel)} "
          f"max_abs_err={err:.3e} "
          f"rel_to_max={err / scale:.3e} tol={tol:g}")
    check(out.dtype == x.dtype and out.shape == ref.shape and np.isfinite(err)
          and err <= tol * scale, f"{label} kernel disagrees with its plain version ({name})")
    check(design == want, f"{label} ({name}) ran on {design}, expected {want}")
    return {"case": name, "design": design, "max_abs_err": err, "rel_to_max": err / scale,
            "tol": tol}


def projection_shapes(cfg):
    """(K, N) of each distinct dense projection of a model, named by its
    weights: q, k and v, o, the MLP's (gate and up, down) and an untied
    lm_head."""
    D, hd, hdv = cfg.d_model, cfg.head_dim, cfg.v_head_dim
    shapes = {}
    for what, kn in (("wq", (D, cfg.n_heads * hd)), ("wk/wv", (D, cfg.n_kv_heads * hd)),
                     ("wo", (cfg.n_heads * hdv, D)), ("w_up", (D, cfg.d_ff)),
                     ("w_down", (cfg.d_ff, D))) + \
            ((("lm_head", (D, cfg.vocab_size)),) if not cfg.tie_embeddings else ()):
        shapes.setdefault(kn, what)
    return shapes


def run_matmul_checks(torch):
    """The dequant-matmul kernel through both of its wrappers."""
    from repro_torch.kernels.pim_mvm.kernel import pim_mvm_fwd, pim_mvm_plain
    from repro_torch.quant.core import dequantize, quantize, quantize_weights
    from repro_torch.config import get_config
    from repro_torch.quant.kernel import quant_matmul_fwd, quant_matmul_plain
    g = torch.Generator(device=DEVICE).manual_seed(4)

    def operands(M, K, N, dtype=torch.bfloat16):
        x = torch.randn((M, K), generator=g, device=DEVICE).to(dtype)
        w = torch.randn((K, N), generator=g, device=DEVICE) / K ** 0.5
        return x, w

    cases = {
        "int8 per-channel (8, 2048, 11008) decode": (8, 2048, 11008, 8, 0, None),
        "int4 per-channel (8, 11008, 2048) w_down": (8, 11008, 2048, 4, 0, None),
        "int8 group128 (128, 2048, 2048)": (128, 2048, 2048, 8, 128, None),
        "int4 group128 (128, 2048, 2048)": (128, 2048, 2048, 4, 128, None),
        "int8 (1024, 2048, 256) chunk-step wk": (1024, 2048, 256, 8, 0, None),
        "ragged int8 (3, 48, 50)": (3, 48, 50, 8, 0, None),
        "ragged int4 group32 (100, 96, 200)": (100, 96, 200, 4, 32, None),
        "f32 x int8 (8, 2048, 2048)": (8, 2048, 2048, 8, 0, torch.float32),
        "f32 x int4 group128 (64, 2048, 2048)": (64, 2048, 2048, 4, 128, torch.float32),
        "int8 per-channel (1024, 2048, 11008) chunk-step w_up": (1024, 2048, 11008, 8, 0,
                                                                 None),
        "int4 group128 (1024, 11008, 2048) chunk-step w_down": (1024, 11008, 2048, 4, 128,
                                                               None),
        "int8 per-channel (128, 2048, 2048) packed prefill": (128, 2048, 2048, 8, 0, None),
        "int4 per-channel (17, 2048, 256) between the tiles": (17, 2048, 256, 4, 0, None),
        "int8 per-channel (1, 2048, 2048) one row": (1, 2048, 2048, 8, 0, None),
        "int8 group8 (64, 256, 512) CUDA cores": (64, 256, 512, 8, 8, None),
        "int4 per-channel (1024, 2048, 11008) chunk-step w_up": (1024, 2048, 11008, 4, 0,
                                                                 None),
        "int4 per-channel (1024, 11008, 2048) chunk-step w_down": (1024, 11008, 2048, 4, 0,
                                                                   None),
        "int8 per-channel (1024, 2048, 2048) chunk-step wq": (1024, 2048, 2048, 8, 0, None),
        "int4 group128 (8, 2048, 2048) decode": (8, 2048, 2048, 4, 128, None),
        "int8 group128 (1024, 2048, 11008) chunk-step w_up": (1024, 2048, 11008, 8, 128,
                                                              None),
        "minitron-8b lm_head int8 (4, 4096, 256000) decode": (4, 4096, 256000, 8, 0, None),
        "minitron-8b lm_head int8 (3, 4096, 256000) packed prefill": (3, 4096, 256000, 8, 0,
                                                                      None),
    }
    # every projection of gemma2-9b as the engine runs it: per channel, int8
    # and int4, at the decode step's 8 rows, the packed prefill's 128 and the
    # chunk step's 1024
    for (K, N), what in projection_shapes(get_config("gemma2-9b")).items():
        for M in (8, 128, 1024):
            for bits in (8, 4):
                cases[f"gemma2-9b {what} int{bits} ({M}, {K}, {N})"] = (M, K, N, bits, 0, None)
    errs = []
    for name, (M, K, N, bits, group, dtype) in cases.items():
        x, w = operands(M, K, N, dtype or torch.bfloat16)
        qt = quantize(w, bits, group=group)
        errs.append(check_matmul(torch, "quant_matmul", name, quant_matmul_fwd,
                                 quant_matmul_plain, x, qt.q, qt.scale, bits=bits,
                                 group=group))

    # split shapes (a decode tile and a wide tile) launched on two streams
    # at once give what they give alone, bit for bit (split-K)
    calls = []
    for M, K, N, bits, group in ((8, 2048, 11008, 8, 0), (128, 2048, 2048, 8, 128)):
        x, w = operands(M, K, N)
        qt = quantize(w, bits, group=group)
        calls.append(functools.partial(quant_matmul_fwd, x, qt.q, qt.scale, bits=bits,
                                       group=group))
    n, same = two_streams(torch, calls)
    print(f"kernel quant_matmul two_streams launches={n} identical={same}")
    check(same, "dequant-matmul split shapes on two streams differ from one stream")

    def timed(M, K, N, bits):
        x, _ = operands(M, K, N)
        copies = cold_copies(K * N * bits // 8)
        qts = [quantize(operands(1, K, N)[1], bits) for _ in range(copies)]
        nxt = cycler(qts)
        args = lambda: (lambda qt: (qt.q, qt.scale))(nxt())  # noqa: E731
        kw = dict(bits=bits)
        _, kernel = ran_kernel(torch, lambda: quant_matmul_fwd(x, *args(), **kw))
        ms = device_ms(lambda: quant_matmul_fwd(x, *args(), **kw), 100)
        plain_ms = device_ms(lambda: quant_matmul_plain(x, *args(), **kw), 10)
        lib = [dequantize(qt).to(torch.bfloat16) for qt in qts]
        nxt_lib = cycler(lib)
        library_ms = device_ms(lambda: torch.matmul(x, nxt_lib()), 100)
        nbytes = qts[0].q.numel() + qts[0].scale.numel() * 4 + (M * K + M * N) * 2
        return ms, plain_ms, library_ms, nbytes, 2 * M * K * N, copies, kernel.design

    bf16 = str(torch.bfloat16)

    def shape_record(M, K, N, bits):
        t = timed(M, K, N, bits)
        b_ms, b_by = bound(t[3], t[4], bf16)
        print(f"kernel quant_matmul timing shape=({M}, {K}, {N}) int{bits} design={t[6]} "
              f"ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})")
        return {"shape": [M, K, N], "weight_bits": bits, "design": t[6], "ms": t[0],
                "plain_ms": t[1], "library_ms": t[2], "bound_ms": b_ms, "bound_by": b_by,
                "copies": t[5]}

    # serving's decode shape at int8 (the record's main numbers), w_down at
    # int4, and the chunk step's w_up at int8 and w_down at int4
    ms, plain_ms, library_ms, nbytes, flops, copies, design = timed(8, 2048, 11008, 8)
    records = {"quant_matmul": matmul_record(
        "quant_matmul", "src/repro_torch/kernels/csrc/qmatmul.cu",
        "src/repro/quant/kernel.py:59", errs, ms, plain_ms, library_ms, nbytes, flops,
        bf16, shape=[8, 2048, 11008], weight_bits=8, design=design, copies=copies,
        int4_w_down=shape_record(8, 11008, 2048, 4),
        chunk_step=shape_record(1024, 2048, 11008, 8),
        chunk_step_int4_w_down=shape_record(1024, 11008, 2048, 4),
        gemma2_9b={"decode_w_up_int8": shape_record(8, 3584, 14336, 8),
                   "decode_w_down_int4": shape_record(8, 14336, 3584, 4),
                   "chunk_step_w_up_int8": shape_record(1024, 3584, 14336, 8)})}

    # -- the crossbar layout --------------------------------------------------
    cases = {"kernel_micro (256, 1024, 512)": (256, 1024, 512, None),
             "kernel_micro (512, 2048, 1024)": (512, 2048, 1024, None),
             "decode (8, 2048, 11008)": (8, 2048, 11008, None),
             "f32 x (256, 1024, 512)": (256, 1024, 512, torch.float32)}
    errs = []
    for name, (M, K, N, dtype) in cases.items():
        x, w = operands(M, K, N, dtype or torch.bfloat16)
        wq, sc = quantize_weights(w)
        errs.append(check_matmul(torch, "pim_mvm", name, pim_mvm_fwd, pim_mvm_plain,
                                 x, wq, sc))
    M, K, N = 512, 2048, 1024
    x, _ = operands(M, K, N)
    planes = [quantize_weights(operands(1, K, N)[1]) for _ in range(cold_copies(K * N))]
    nxt = cycler(planes)
    _, kernel = ran_kernel(torch, lambda: pim_mvm_fwd(x, *nxt()))
    ms = device_ms(lambda: pim_mvm_fwd(x, *nxt()), 100)
    plain_ms = device_ms(lambda: pim_mvm_plain(x, *nxt()), 10)
    from repro_torch.kernels.pim_mvm.ref import dequantize_ref
    lib = [dequantize_ref(wq, sc).to(torch.bfloat16) for wq, sc in planes]
    nxt_lib = cycler(lib)
    library_ms = device_ms(lambda: torch.matmul(x, nxt_lib()), 100)
    nbytes = K * N + planes[0][1].numel() * 4 + (M * K + M * N) * 2
    records["pim_mvm"] = matmul_record(
        "pim_mvm", "src/repro_torch/kernels/csrc/qmatmul.cu",
        "src/repro/kernels/pim_mvm/kernel.py:60", errs, ms, plain_ms, library_ms,
        nbytes, 2 * M * K * N, str(x.dtype), shape=[M, K, N], design=kernel.design,
        copies=len(planes))
    return records


# ---------------------------------------------------------------------------
# engine and logits at full width
# ---------------------------------------------------------------------------

def reset_launches():
    """Every wrapper's launch count and per-kernel counter to 0 (a replayed
    CUDA graph adds what its capture counted: ``repro_torch.kernels.launches``)."""
    from repro_torch.kernels import launches
    for fn in launches.wrappers().values():
        fn.launches = 0
    for counter in launches.counters().values():
        counter.clear()


def read_launches():
    from repro_torch.kernels import launches
    return {name: fn.launches for name, fn in launches.wrappers().items()}


def read_kernels():
    """Launches of each kernel of qmatmul.cu since reset_launches(), and
    of each of its designs."""
    from repro_torch.quant.kernel import DESIGNS, kernel_launches
    kernels = kernel_launches.copy()
    return kernels, {d: sum(n for k, n in kernels.items() if k.design == d) for d in DESIGNS}


def tensor_bytes(tree):
    """Bytes of the tensors in a nested dict/list (a slot pool)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(t) for t in tree.values())
    return sum(tensor_bytes(t) for t in tree)


def projections(cfg):
    """Dense projections of one forward call (each a dequant-matmul under
    ``weight_bits``): q, k, v, o and the MLP's (three gated, two plain) in
    every layer, and an untied lm_head once."""
    return (4 + (3 if cfg.glu else 2)) * cfg.n_layers + (0 if cfg.tie_embeddings else 1)


def local_positions(cfg, cache):
    """The largest position held by any local (ring) layer's pool."""
    from repro_torch.models.transformer import build_groups
    return max((int(cache["stack"][gi][f"u{ui}"]["attn"]["pos"].max())
                for gi, spec in enumerate(build_groups(cfg))
                for ui, kind in enumerate(spec.units) if kind == "local"), default=-1)


@contextlib.contextmanager
def eager_programs():
    """Engines built inside run their three programs through the eager
    methods (the functions the graphs capture), not replayed from graphs."""
    from repro_torch.serving.executor import Executor
    capture = Executor.capture
    Executor.capture = lambda self, *a, **k: None
    try:
        yield
    finally:
        Executor.capture = capture


def run_engine(torch, cfg, params, run="fp", kv_len=1024, long_prompts=(), eager=False,
               **paths):
    """One drain of the 16 requests (and ``long_prompts``), fp or quantised
    (``QUANT_RUNS``), traced, with every kernel's launches counted over that
    drain alone.  The default path replays its programs from CUDA graphs;
    ``eager`` runs them through the eager methods; ``paths`` picks a
    baseline (``fused=False``, ``packed=False``)."""
    from repro_torch.kernels.launches import counters as launch_counters
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    bits = QUANT_RUNS[run]
    label = run + "".join(f" {k}={v}" for k, v in paths.items()) + (" eager" if eager else "")
    ecfg = EngineConfig(max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK,
                        max_new_tokens=NEW_TOKENS, impl="flash", trace=True, **bits, **paths)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in rng.integers(4, 385, N_REQUESTS)]
    prompts += [rng.integers(0, cfg.vocab_size, size=n) for n in long_prompts]

    # warm-up: cuBLAS handles, allocator pools, kernel modules
    with eager_programs() if eager else contextlib.nullcontext():
        warm = ServingEngine(cfg, params, EngineConfig(
            max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK, max_new_tokens=2,
            impl="flash", **bits, **paths), device=DEVICE)
        for p in prompts[:2]:
            warm.submit(p)
        warm.run_until_drained()
        del warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        engine = ServingEngine(cfg, params, ecfg, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t_build
    graphs = engine.executor.graphs
    check((graphs is None) == (eager or not paths.get("fused", True)),
          f"{label}: programs {'not ' if graphs is None else ''}captured")
    if graphs is not None:
        want = ["fused_step"] + (["packed_prefill", "chunk_step"]
                                 if paths.get("packed", True) else [])
        check(sorted(graphs.graphs) == sorted(want), f"{label}: captured {sorted(graphs.graphs)}")
    reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    kernels, designs = read_kernels()
    attn = {k: v.copy() for k, v in launch_counters().items() if k != "qmatmul"}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    qp = engine.executor.params
    params_gb = sum(tensor_bytes(t) for t in (*qp.parameters(), *qp.buffers())) / 1e9
    pool_gb = tensor_bytes(engine.pool.cache) / 1e9
    st = engine.stats()
    print(f"engine run={label} arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"weight_bits={st['weight_bits']} kv_bits={st['kv_bits']} "
          f"finished={st['finished']}/{len(prompts)} tokens={st['tokens']} "
          f"tokens_per_s={st['tokens_per_s']:.2f} mean_ttft_s={st['mean_ttft_s']:.4f} "
          f"ttft_p95_s={st['ttft_p95_s']:.4f} mean_tpot_s={st['mean_tpot_s']:.5f} "
          f"decode_steps={st['decode_steps']} prefill_calls={st['prefill_calls']} "
          f"prefill_tokens={st['prefill_tokens']} wall_s={wall:.3f} build_s={build_s:.3f} "
          f"decode_step_wall_ms={st['trace_decode_step_s'] * 1e3:.3f} "
          f"decode_step_p95_ms={st['trace_decode_step_p95_s'] * 1e3:.3f} "
          f"peak_memory_gib={peak_gib:.2f} params_gb={params_gb:.3f} "
          f"pool_gb={pool_gb:.4f} launches={json.dumps(launches)} "
          f"qmatmul_designs={json.dumps(designs)} "
          f"qmatmul_kernels={json.dumps({kernel_name(k): n for k, n in kernels.items()})} "
          + " ".join(f"{w}_kernels=" + json.dumps(
              {attention_kernel_name(k): n for k, n in c.items()}) for w, c in attn.items()))
    check(st["finished"] == len(prompts) and st["failed"] == 0,
          f"engine ({label}) finished {st['finished']} of {len(prompts)}")
    outs = [r.output for r in sorted(engine.finished, key=lambda r: r.uid)]
    check(all(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o)
              for o in outs), f"engine ({label}) produced malformed token streams")
    if paths.get("packed", True):
        check(any(n > CHUNK for n in st["prompt_lens"]), "no chunked prefill ran")
    else:
        check(st["prefill_calls"] == len(prompts), f"{label}: {st['prefill_calls']} "
              f"prefill calls for {len(prompts)} requests")
    if "local" in cfg.pattern:
        # the long prompt's slot keeps its ring: positions past the window
        held = local_positions(cfg, engine.pool.cache)
        print(f"engine run={label} local_ring_cap={min(cfg.window, kv_len)} "
              f"largest_position_held={held}")
        check(held >= min(cfg.window, kv_len), f"{label}: no local ring wrapped")
    steps = st["decode_steps"] * cfg.n_layers
    quant_kv, quant_w = bool(bits.get("kv_bits")), bool(bits.get("weight_bits"))
    want_decode = {"flash_decode": 0 if quant_kv else steps,
                   "flash_decode_quant": steps if quant_kv else 0}
    for name, n in want_decode.items():
        check(launches[name] == n, f"{run}: {name} launches {launches[name]} != {n}")
    # every projection of every forward call (decode step, packed prefill,
    # chunk step) went through the dequant-matmul kernel
    calls = st["decode_steps"] + st["prefill_calls"]
    want_mm = projections(cfg) * calls if quant_w else 0
    check(launches["quant_matmul"] == want_mm,
          f"{run}: quant_matmul launches {launches['quant_matmul']} != {want_mm}")
    # the engine runs bf16: every projection on tensor cores
    check(designs == {"cuda_core": 0, "tensor_core": want_mm},
          f"{run}: qmatmul designs {designs}, want {want_mm} on tensor cores")
    check_kernels_checked(f"engine ({run})", kernels)
    check(launches["flash_prefill"] > 0 and
          launches["flash_prefill"] % cfg.n_layers == 0,
          f"{run}: prefill kernel launches {launches['flash_prefill']}")
    # every packed prefill on the design its head dim calls for (tensor cores
    # at 64/128, CUDA cores at 256), in kernels that phase 3 checked
    want_pf = expected_prefill_design(torch.bfloat16, cfg.head_dim)
    on = sum(n for k, n in attn["prefill"].items() if k.design == want_pf)
    check(on == launches["flash_prefill"],
          f"{run}: {on} of {launches['flash_prefill']} prefill launches on {want_pf}")
    if not paths.get("packed", True):
        # one non-segmented prefill a request and layer
        check(launches["flash_prefill"] == st["prefill_calls"] * cfg.n_layers,
              f"{label}: prefill launches {launches['flash_prefill']}")
    check_attention_checked(f"engine ({label}) prefill", attn["prefill"], CHECKED_PREFILL)
    check_attention_checked(f"engine ({label}) decode", attn["decode"], CHECKED_DECODE)
    check_attention_checked(f"engine ({label}) quantised decode", attn["decode_quant"],
                            CHECKED_DECODE_QUANT)
    check(launches["pim_mvm"] == 0, f"{label}: the crossbar kernel ran in serving")
    return {"stats": st, "launches": launches, "designs": designs, "wall_s": wall,
            "peak_gib": peak_gib, "outputs": outs, "build_s": build_s,
            "kernels": {"qmatmul": kernels, **attn},
            "params_gb": params_gb, "pool_gb": pool_gb}


def run_graphs(torch, cfg, params, run, replayed, kv_len, long_prompts):
    """The same drain as ``replayed`` (the engine phase's, its programs
    replayed from CUDA graphs) through the eager methods: the token streams
    bit for bit, the launch counts (replays counted) and the kernels equal;
    tokens/s, TTFT, TPOT, the decode step's wall time (dispatch + fetch)
    and peak memory of both."""
    eager = run_engine(torch, cfg, params, run, kv_len=kv_len, long_prompts=long_prompts,
                       eager=True)
    r, e = replayed["stats"], eager["stats"]
    same_streams = replayed["outputs"] == eager["outputs"]
    print(f"graphs arch={cfg.name} run={run} streams_identical={same_streams} "
          f"launches_equal={replayed['launches'] == eager['launches']} "
          + " ".join(f"{k}_eager={e[k]:.5f} {k}_replayed={r[k]:.5f}" for k in (
              "tokens_per_s", "mean_ttft_s", "ttft_p95_s", "mean_tpot_s",
              "trace_decode_step_s", "trace_decode_step_p95_s"))
          + f" peak_memory_gib_eager={eager['peak_gib']:.3f} "
          f"peak_memory_gib_replayed={replayed['peak_gib']:.3f} "
          f"build_s_eager={eager['build_s']:.3f} build_s_replayed={replayed['build_s']:.3f}")
    check(same_streams, f"graphs ({cfg.name} {run}): replayed and eager streams differ")
    check(replayed["launches"] == eager["launches"] and
          replayed["kernels"] == eager["kernels"],
          f"graphs ({cfg.name} {run}): launches {replayed['launches']} replayed, "
          f"{eager['launches']} eager")
    return eager


def run_sampling(torch, cfg, params, kv_len):
    """``temperature`` 0.8 through the replayed programs, whose graphs draw
    from the executor's generator (registered with each graph): an engine
    with the same seed repeats a run's streams, another seed does not, and
    each stream's tokens differ from one another (each replay draws anew)."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    runs = []
    for seed in (3, 3, 4):
        engine = ServingEngine(cfg, params, EngineConfig(
            max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK, max_new_tokens=8,
            temperature=0.8, seed=seed), device=DEVICE)
        rng = np.random.default_rng(0)
        for n in (5, 20, 40, 200):
            engine.submit(rng.integers(0, cfg.vocab_size, size=n))
        runs.append([r.output for r in sorted(engine.run_until_drained(), key=lambda r: r.uid)])
        del engine
    repeats, differs = runs[0] == runs[1], runs[0] != runs[2]
    fresh = all(len(set(o)) > 1 for o in runs[0])
    print(f"sampling arch={cfg.name} temperature=0.8 same_seed_repeats={repeats} "
          f"other_seed_differs={differs} replays_draw_anew={fresh} stream0={runs[0][0]}")
    check(repeats and differs and fresh, "sampling through the graphs is not seeded draws")


def run_baselines(torch, cfg, params, by_run, kv_len, long_prompts):
    """The engine's baselines at full width, fp, their own calls eager (one
    launch a kernel): sequential admission (``packed=False``: a batch-1
    prefill a request, right-padded to a power-of-two bucket on qwen2.5-3b,
    exact on gemma2-9b, whose 4600-token prompt fills a wrapped ring), the
    fused step replayed; and on qwen2.5-3b the host-looped step
    (``fused=False``), whose greedy streams equal the sequential fused
    path's bit for bit (the same admission, so the same prefill)."""
    drain = dict(kv_len=kv_len, long_prompts=long_prompts)
    seq = run_engine(torch, cfg, params, "fp", packed=False, **drain)
    by_run[f"{cfg.name} fp packed=False"] = seq["launches"]
    if cfg.name != "qwen2.5-3b":
        return
    host = run_engine(torch, cfg, params, "fp", fused=False, **drain)
    by_run[f"{cfg.name} fp fused=False"] = host["launches"]
    same = host["outputs"] == seq["outputs"]
    print(f"baseline arch={cfg.name} fused=False streams_equal_fused_sequential={same}")
    check(same, "the host-looped streams differ from the fused step's")


def run_crossbar(torch):
    """The PIM-MVM entry point as ``examples/quickstart.py`` and
    ``benchmarks/kernel_micro.py`` drive it: program the crossbars
    (``quantize_weights``), then ``pim_mvm``, with f32 x (kernel_micro's)
    and bf16 x; checked against the oracle and against the fp product
    (quantisation error, as kernel_micro reports it)."""
    from repro_torch.kernels.pim_mvm.ops import pim_mvm, quantize_weights
    g = torch.Generator(device=DEVICE).manual_seed(5)
    shapes = [(256, 1024, 512), (512, 2048, 1024)]
    dtypes = (torch.float32, torch.bfloat16)
    inputs = []
    for M, K, N in shapes:
        x = torch.randn((M, K), generator=g, device=DEVICE)
        w = torch.randn((K, N), generator=g, device=DEVICE) / K ** 0.5
        inputs += [((M, K, N), x.to(dt), w, *quantize_weights(w)) for dt in dtypes]
    torch.cuda.synchronize()
    reset_launches()
    outs = [pim_mvm(x, wq, sc) for _, x, _, wq, sc in inputs]
    torch.cuda.synchronize()
    launches, (kernels, designs) = read_launches(), read_kernels()
    for ((M, K, N), x, w, wq, sc), out in zip(inputs, outs):
        ref = pim_mvm(x, wq, sc, impl="ref").float()
        fp = x.float() @ w
        err = float((out.float() - ref).abs().max() / ref.abs().max())
        rel = float((out.float() - fp).abs().max() / fp.abs().max())
        print(f"crossbar shape={M}x{K}x{N} dtype={x.dtype} rel_err_vs_oracle={err:.3e} "
              f"rel_err_vs_fp={rel:.3e}")
        check(np.isfinite(err) and err <= MATMUL_TOL[str(x.dtype)] and rel < 3e-2,
              f"pim_mvm {M}x{K}x{N} {x.dtype} disagrees (oracle {err:.3e}, fp {rel:.3e})")
    print(f"crossbar launches={json.dumps(launches)} qmatmul_designs={json.dumps(designs)}")
    check(launches["pim_mvm"] == len(inputs) and
          sum(launches.values()) == launches["pim_mvm"],
          f"crossbar launches {launches}")
    check(designs == {"cuda_core": len(shapes), "tensor_core": len(shapes)},
          f"crossbar: f32 x on CUDA cores, bf16 x on tensor cores; saw {designs}")
    check_kernels_checked("crossbar", kernels)
    return launches


def profiled(torch, arch, run, what, step, steps):
    """``steps`` calls of ``step`` timed on the host clock (to a
    synchronise), then torch.profiler over as many: device busy time (the
    sum of kernel times) a call, the share of the wall time the card was
    idle, kernels launched a call and the largest kernels.  The profiler
    slows the host, so its own wall time is not the engine's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile arch={arch} run={run} {what} wall_ms={step_ms:.3f} busy_ms={busy_ms:.3f} "
          f"idle_share={1 - busy_ms / step_ms:.3f} wall_ms_profiled={wall_ms:.3f} "
          f"kernels_per_step={launches:.0f} top=" + json.dumps(
              [[e.key[:60], round(e.self_device_time_total / 1e3 / steps, 4), e.count // steps]
               for e in top]))
    return {"busy_ms": busy_ms, "kernels_per_step": launches, "wall_ms": step_ms,
            "wall_ms_profiled": wall_ms}


def run_profile(torch, cfg, params, run="fp", kv_len=1024, steps=4, chunk_steps=2):
    """Where a step's time goes, with every slot of the pool busy: ``steps``
    fused decode steps, then ``chunk_steps`` chunked-prefill steps (the
    executor's ``chunk_step``, as the engine calls it for long prompts:
    all 8 rows with a 128-token chunk, M = 1024 rows a projection); each
    replayed from its CUDA graph, as the engine runs it, and then through
    the eager method (the decode step with its fetch, as ``step`` does)."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK,
        max_new_tokens=4 * steps + 8, impl="flash", **QUANT_RUNS[run]), device=DEVICE)
    rng = np.random.default_rng(2)
    for _ in range(MAX_BATCH):        # 8 x 16 tokens: one packed stream
        engine.submit(rng.integers(0, cfg.vocab_size, size=16))
    engine.step()                     # admission (one packed prefill) + a step
    engine.step()
    check(len(engine.pool.decoding()) == MAX_BATCH, "profile: pool not full")
    ex, pool = engine.executor, engine.pool
    decode = profiled(torch, cfg.name, run, "decode_step replayed", engine.step, steps)
    decode_eager = profiled(torch, cfg.name, run, "decode_step eager", lambda: ex.fetch(
        ex.fused_step(pool.cache, pool.state)[2]), steps)

    # chunk steps over the same pool: each row's next 128 tokens at
    # positions 32..159, no row final (the slots' state is left as it is)
    B, C = MAX_BATCH, engine._chunk
    host = (rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32),
            np.broadcast_to(32 + np.arange(C, dtype=np.int32), (B, C)).copy(),
            np.full((B,), C - 1, np.int32), np.zeros((B,), bool), np.ones((B,), np.int32))
    args = [torch.from_numpy(a).to(DEVICE) for a in host]
    chunk = profiled(torch, cfg.name, run, "chunk_step replayed",
                     lambda: ex.run("chunk_step", pool, *host), chunk_steps)
    chunk_eager = profiled(torch, cfg.name, run, "chunk_step eager",
                           lambda: ex.chunk_step(pool.cache, pool.state, *args), chunk_steps)
    return {"decode_step": decode, "decode_step_eager": decode_eager,
            "chunk_step": chunk, "chunk_step_eager": chunk_eager}


def run_logits(torch, cfg, params, run="fp", long_row=0):
    """Packed prefill + 4 teacher-forced decode steps at full width,
    impl="flash" against impl="ref", each on its own slot pool.  Quantised
    (``QUANT_RUNS``), "ref" is the attention oracle over the pool
    dequantised to bf16 plus the reference's dequantise-then-matmul, whose
    weights are rounded to bf16; the kernels keep them in f32.  A
    ``long_row`` of that many prompt tokens joins the three short ones in
    the packed stream: past a local window, its prefill is windowed, its
    ring wraps in the packed insert, and the decode steps read it wrapped.
    The sequential baseline's first-token logits (a batch-1 prefill of each
    row, padded as the engine pads it) are held to the packed prefill's
    under the same bound."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig, _bucket_len
    from repro_torch.serving.executor import Executor
    from repro_torch.serving.pool import SlotPool

    rng = np.random.default_rng(1)
    lens = (30, 61, 17) + ((long_row,) if long_row else ())
    B, C = 4, -(-sum(lens) // CHUNK) * CHUNK
    kv_len = max(256, -(-(max(lens) + 8) // 256) * 256)
    toks = np.zeros((1, C), np.int32)
    seg = np.full((1, C), -1, np.int32)
    pos = np.zeros((1, C), np.int32)
    gather = np.zeros((B,), np.int32)
    seg_len = np.zeros((B,), np.int32)
    off = 0
    for i, n in enumerate(lens):
        toks[0, off:off + n] = rng.integers(0, cfg.vocab_size, n)
        seg[0, off:off + n], pos[0, off:off + n] = i, np.arange(n)
        gather[i], seg_len[i] = off + n - 1, n
        off += n
    active = np.arange(B) < len(lens)
    steps = rng.integers(0, cfg.vocab_size, (4, B)).astype(np.int32)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(DEVICE)  # noqa: E731

    results = {}
    for impl in ("flash", "ref"):
        ecfg = EngineConfig(max_batch=B, kv_len=kv_len, impl=impl, **QUANT_RUNS[run])
        ex = Executor(cfg, params, ecfg, device=torch.device(DEVICE))
        pool = SlotPool(cfg, ecfg, device=torch.device(DEVICE))
        with torch.no_grad():
            logits, pc = T.prefill_packed(ex.params, cfg, dev(toks), dev(pos), dev(seg),
                                          dev(gather), impl=impl, kv_bits=ecfg.kv_bits)
            if impl == "flash":
                # the sequential baseline's first-token logits of each row:
                # a batch-1 prefill padded as the engine pads it
                bucketed = all(k == "global" for k in cfg.layer_kinds)
                seq = []
                for i, n in enumerate(lens):
                    row = np.zeros((1, _bucket_len(n, kv_len) if bucketed else n), np.int32)
                    row[0, :n] = toks[0, gather[i] - n + 1:gather[i] + 1]
                    seq.append(ex.prefill(dev(row), n)[0].float())
                sequential = torch.cat(seq)
            ex.packed_insert(pool.cache, pc["stack"], dev(seg), dev(pos),
                              dev(seg_len), dev(active))
            del pc
            if long_row and "local" in cfg.pattern:
                held = local_positions(cfg, pool.cache)
                check(held >= cfg.window, f"logits ({run}): the local ring did not wrap")
            out = [logits.float()]
            for s in range(4):
                p = np.where(active, seg_len + s, -1).astype(np.int32)
                logits, _ = T.decode_step(ex.params, cfg, pool.cache, dev(steps[s]),
                                          dev(p), impl=impl)
                out.append(logits.float()[: len(lens)])
        del ex, pool
        results[impl] = out
    names = ["prefill"] + [f"decode{s}" for s in range(4)]
    scale = max(float(r.abs().max()) for r in results["ref"])
    # bound: the oracle rounds its probabilities to bf16 before the value
    # product and the kernels do not; over 36-42 bf16 layers of random
    # weights that difference may grow to a few bf16 ulps of the logits' scale
    limit = 5e-2 * max(1.0, scale)
    diffs = {n: float((a - b).abs().max()) for n, a, b in
             zip(names, results["flash"], results["ref"])}
    # sequential against packed, both through the kernels
    diffs["sequential_prefill"] = float((sequential - results["flash"][0][:len(lens)]).abs().max())
    finite = all(bool(torch.isfinite(r).all()) for r in results["flash"])
    print(f"logits run={run} arch={cfg.name} layers={cfg.n_layers} rows={list(lens)} "
          f"stream={C} kv_len={kv_len} max_abs_diff={json.dumps(diffs)} "
          f"bound={limit:.4f} ref_scale={scale:.4f} finite={finite}")
    check(finite and max(diffs.values()) <= limit,
          f"flash and ref logits ({run}) disagree beyond the bound")
    return diffs, limit


def make_params(torch, cfg):
    """Random bf16 weights (seed 0) on the card, after the last model's are
    freed."""
    from repro_torch.models import transformer as T
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"params: arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"{n_params} in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return params


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.config import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    b = build.build()
    ptxas = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {b.seconds:.2f} s, libraries {sorted(b.libs)}")
    for ln in ptxas:
        print(f"build ptxas: {ln}")

    records = run_kernel_checks(torch)
    records.update(run_quant_decode_checks(torch))
    records.update(run_matmul_checks(torch))

    start = time.perf_counter()
    by_run = {}            # launches of each main-path run, counted from 0 before it
    for arch, serve in SERVED.items():
        cfg = get_config(arch)
        params = make_params(torch, cfg)
        drain = dict(kv_len=serve["kv_len"], long_prompts=serve["long_prompts"])
        for run in QUANT_RUNS:
            r = run_engine(torch, cfg, params, run, **drain)
            by_run[f"{arch} {run}"] = r["launches"]
            run_graphs(torch, cfg, params, run, r, **drain)
            if run == "fp":
                run_baselines(torch, cfg, params, by_run, **drain)
        if arch == "qwen2.5-3b":
            run_sampling(torch, cfg, params, serve["kv_len"])
        if arch == "qwen2.5-3b":
            by_run["crossbar"] = run_crossbar(torch)
        for run in ("fp", "w8kv8"):
            run_logits(torch, cfg, params, run, long_row=serve["logits_row"])
        for run in ("fp", "w8kv8"):
            run_profile(torch, cfg, params, run, kv_len=serve["kv_len"])
        del params
        print(f"phases of {arch} done at {time.perf_counter() - start:.1f} s")
    for arch, layers in LOGITS_ONLY.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        params = make_params(torch, cfg)
        for run in ("fp", "w8kv8"):
            run_logits(torch, cfg, params, run)
        del params
        print(f"phases of {arch} done at {time.perf_counter() - start:.1f} s")

    for name, rec in records.items():
        rec["launches"] = sum(n[name] for n in by_run.values())
        rec["launches_by_run"] = {run: n[name] for run, n in by_run.items() if n[name]}
        check(rec["launches"] > 0, f"kernel {name} never launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: rec[k] for k in keys}, **{k: v for k, v in rec.items() if k not in keys}}
        for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
