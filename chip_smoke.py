#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which must pass or the script exits non-zero:

1. device  — the card's name and power limit, as nvidia-smi reports them;
2. build   — the CUDA kernels of ``src/repro_torch/kernels/csrc`` built with
             nvcc (``repro_torch.kernels.build``);
3. kernels — each of the five kernels against its plain PyTorch version on
             the card, at the serving path's shapes and at edge cases
             (window, softcap, an empty slot, a pad-only tile, ragged
             lengths and shapes, GQA rep 1 and 8, f32, head_dim 256, int8 and
             int4, per-channel and per-group scales, M from 1 to 1024), with
             its time, the plain version's time, one PyTorch call's time (a
             yardstick the port never calls: ``scaled_dot_product_attention``
             with an explicit mask for attention, ``torch.matmul`` with the
             dequantised bf16 weights for the matmuls) and its bound; each
             dequant-matmul case prints the design of ``qmatmul.cu`` it ran
             (tensor cores or CUDA cores) and is checked to run the one its
             dtype and group call for; split shapes launched on two streams
             at once must give what they give on one;
4. engine  — the port's serving engine on full-width qwen2.5-3b with random
             bf16 weights, fp and then quantised (``w8kv8``, ``w4kv4``): 16
             requests (prompts of 4..384 tokens, so chunked prefill runs),
             greedy, 32 new tokens each, with the launch count of each kernel
             during each run, checked against the run's steps and calls, and
             every quantised projection checked to have run on tensor cores,
             in a kernel of ``qmatmul.cu`` that phase 3 checked;
5. crossbar — the PIM-MVM entry point ``pim_mvm`` on the shapes of
             ``benchmarks/kernel_micro.py``, f32 x (as there) and bf16 x,
             against its oracle and the fp product, with the kernel's launch
             count, the bf16 calls checked to have run on tensor cores, in
             kernels that phase 3 checked;
6. logits  — packed prefill plus 4 decode steps at full width with
             ``impl="flash"`` against ``impl="ref"``, fp and ``w8kv8``;
7. profile — torch.profiler over 4 full-pool decode steps and 2 chunk
             steps (8 rows of a 128-token chunk), fp and ``w8kv8``: device
             busy time and kernels launched per step (read, not checked).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits 1
and prints no result.
"""
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
PROJECTIONS = 7                     # wq, wk, wv, wo, w_gate, w_up, w_down
ARCH, MAX_BATCH, KV_LEN, NEW_TOKENS, N_REQUESTS = "qwen2.5-3b", 8, 1024, 32, 16
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
                window=0, softcap=0.0, ring=False, empty=(), dtype=None, copies=1):
    """Inputs of one decode call; ``copies`` distinct K/V pools (to time
    with a cold L2, as each layer's pool is)."""
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
              torch.randn((B, Skv, Hkv, hd), generator=g, device=dev).to(dtype))
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


def run_kernel_checks(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd,
                                                            flash_decode_plain)
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                            flash_attention_plain)
    rng = np.random.default_rng(0)
    records = {}

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
    errs = []
    for name, kw in cases.items():
        c = decode_case(torch, rng, **kw)
        k, v = c["pools"][0]
        args = dict(q_pos=c["q_pos"], kv_pos=c["kv_pos"], window=c["window"],
                    softcap=c["softcap"])
        out = flash_decode_fwd(c["q"], k, v, **args)
        ref = flash_decode_plain(c["q"], k, v, **args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(c["q"].dtype)]
        empty_ok = all(bool((out[b] == 0).all()) for b in kw.get("empty", ()))
        print(f"kernel flash_decode case={name!r} max_abs_err={err:.3e} tol={tol:g}"
              f" empty_slots_zero={empty_ok}")
        check(np.isfinite(err) and err <= tol and empty_ok,
              f"decode kernel disagrees with its plain version ({name})")
        errs.append({"case": name, "max_abs_err": err, "tol": tol})

    pool_bytes = 2 * 8 * 1024 * 2 * 128 * 2     # K + V: B 8, Skv 1024, Hkv 2, hd 128, bf16
    c = decode_case(torch, rng, copies=cold_copies(pool_bytes))
    B, Skv, Hkv, hd = c["pools"][0][0].shape
    Hq = c["q"].shape[2]
    it = iter(range(1 << 30))

    def pool():
        return c["pools"][next(it) % len(c["pools"])]

    args = dict(q_pos=c["q_pos"], kv_pos=c["kv_pos"])
    ms = device_ms(lambda: flash_decode_fwd(c["q"], *pool(), **args), 200)
    plain_ms = device_ms(lambda: flash_decode_plain(c["q"], *pool(), **args), 20)
    mask = (c["kv_pos"] >= 0) & (c["kv_pos"] <= c["q_pos"])
    qt = c["q"].transpose(1, 2)
    lib_pools = [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in c["pools"]]
    lib_mask = mask[:, None, None, :]
    it2 = iter(range(1 << 30))

    def library():
        k, v = lib_pools[next(it2) % len(lib_pools)]
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=lib_mask,
                                              enable_gqa=True)
    library_ms = device_ms(library, 100)
    valid = int((c["kv_pos_np"] >= 0).sum())
    esz = c["q"].element_size()
    nbytes = (2 * B * Hq * hd * esz                       # q in, out
              + 2 * valid * Hkv * hd * esz                # valid K and V rows
              + c["kv_pos_np"].nbytes + c["q_pos_np"].nbytes)
    flops = 4 * valid * Hq * hd                           # QK^T and PV
    b_ms, b_by = bound(nbytes, flops, str(c["q"].dtype))
    records["flash_decode"] = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/flash_attention/decode.py:113",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms, "shape": [B, Skv, Hq, Hkv, hd],
        "valid_entries": valid, "cases": errs}
    print(f"kernel flash_decode timing ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")

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
    }
    errs = []
    for name, kw in cases.items():
        c = prefill_case(torch, rng, **kw)
        args = dict(segments=c["segments"], window=c["window"], softcap=c["softcap"])
        out = flash_attention_fwd(c["q"], c["k"], c["v"], **args)
        ref = flash_attention_plain(c["q"], c["k"], c["v"], **args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(c["q"].dtype)]
        pad_ok = True
        if c["seg_np"] is not None:
            pad = torch.from_numpy(c["seg_np"][0] < 0).to(DEVICE)
            pad_ok = bool((out[:, :, pad] == 0).all())
        print(f"kernel flash_prefill case={name!r} max_abs_err={err:.3e} tol={tol:g}"
              f" pad_rows_zero={pad_ok}")
        check(np.isfinite(err) and err <= tol and pad_ok,
              f"prefill kernel disagrees with its plain version ({name})")
        errs.append({"case": name, "max_abs_err": err, "tol": tol})

    c = prefill_case(torch, rng)
    _, Hq, S, hd = c["q"].shape
    Hkv = c["k"].shape[1]
    args = dict(segments=c["segments"])
    ms = device_ms(lambda: flash_attention_fwd(c["q"], c["k"], c["v"], **args), 200)
    plain_ms = device_ms(lambda: flash_attention_plain(c["q"], c["k"], c["v"], **args), 20)
    seg = c["segments"][0]
    idx = torch.arange(S, device=DEVICE)
    lib_mask = ((seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
                & (idx[None, :] <= idx[:, None]))[None, None]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        c["q"], c["k"], c["v"], attn_mask=lib_mask, enable_gqa=True), 200)
    pairs = int(lib_mask.sum().item())                     # attended (q, k) pairs
    esz = c["q"].element_size()
    nbytes = (2 * Hq * S * hd + 2 * Hkv * S * hd) * esz + c["seg_np"].nbytes
    flops = 4 * pairs * Hq * hd
    b_ms, b_by = bound(nbytes, flops, str(c["q"].dtype))
    records["flash_prefill"] = {
        "name": "flash_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefill.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:123",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms, "shape": [1, S, Hq, Hkv, hd],
        "attended_pairs": pairs, "cases": errs}
    print(f"kernel flash_prefill timing ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")
    return records


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
    version; timed at the main shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.decode import (flash_decode_quant_fwd,
                                                            flash_decode_quant_plain)
    from repro_torch.quant.core import dequantize_kv, quantize_kv
    rng = np.random.default_rng(3)

    def quant_case(bits, copies=1, **kw):
        c = decode_case(torch, rng, copies=copies, **kw)
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
    }
    errs = []
    for bits in (8, 4):
        for name, kw in cases.items():
            c = quant_case(bits, **kw)
            k_q, k_s, v_q, v_s = c["qpools"][0]
            args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"],
                        window=c["window"], softcap=c["softcap"])
            out = flash_decode_quant_fwd(c["q"], k_q, k_s, v_q, v_s, **args)
            ref = flash_decode_quant_plain(c["q"], k_q, k_s, v_q, v_s, **args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(c["q"].dtype)]
            empty_ok = all(bool((out[b] == 0).all()) for b in kw.get("empty", ()))
            print(f"kernel flash_decode_quant kv{bits} case={name!r} max_abs_err={err:.3e} "
                  f"tol={tol:g} empty_slots_zero={empty_ok}")
            check(np.isfinite(err) and err <= tol and empty_ok,
                  f"quantised decode kernel disagrees with its plain version "
                  f"(kv{bits}, {name})")
            errs.append({"case": f"kv{bits} {name}", "max_abs_err": err, "tol": tol})

    timing = {}
    for bits in (8, 4):
        pool_bytes = 2 * 8 * 1024 * 2 * (128 * bits // 8 + 4)  # K + V codes and scales
        c = quant_case(bits, copies=cold_copies(pool_bytes))
        B, Skv, Hkv, hdq = c["qpools"][0][0].shape
        Hq, hd = c["q"].shape[2], c["q"].shape[3]
        args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"])
        nxt = cycler(c["qpools"])
        ms = device_ms(lambda: flash_decode_quant_fwd(c["q"], *nxt(), **args), 200)
        plain_ms = device_ms(lambda: flash_decode_quant_plain(c["q"], *nxt(), **args), 20)
        valid = int((c["kv_pos_np"] >= 0).sum())
        esz = c["q"].element_size()
        nbytes = (2 * B * Hq * hd * esz                     # q in, out
                  + 2 * valid * Hkv * (hdq + 4)             # K and V codes + scales
                  + c["kv_pos_np"].nbytes + c["q_pos_np"].nbytes)
        flops = 4 * valid * Hq * hd
        timing[bits] = dict(ms=ms, plain_ms=plain_ms, bound=bound(nbytes, flops,
                                                                   str(c["q"].dtype)))
        if bits == 8:
            # yardstick: scaled_dot_product_attention over the pools
            # dequantised to bf16 (an fp pool, which quantisation replaces)
            mask = ((c["kv_pos"] >= 0) & (c["kv_pos"] <= c["q_pos"]))[:, None, None, :]
            qt = c["q"].transpose(1, 2)
            lib_pools = [(dequantize_kv(kq, ks, bits).to(c["q"].dtype).transpose(1, 2),
                          dequantize_kv(vq, vs, bits).to(c["q"].dtype).transpose(1, 2))
                         for kq, ks, vq, vs in c["qpools"]]
            nxt_lib = cycler(lib_pools)
            timing[bits]["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(qt, *nxt_lib(), attn_mask=mask,
                                                       enable_gqa=True), 100)
            shape, valid8 = [B, Skv, Hq, Hkv, hd], valid
    t8, t4 = timing[8], timing[4]
    print(f"kernel flash_decode_quant timing kv8 ms={t8['ms']:.4f} "
          f"plain_ms={t8['plain_ms']:.4f} library_ms={t8['library_ms']:.4f} "
          f"bound_ms={t8['bound'][0]:.5f} ({t8['bound'][1]}); kv4 ms={t4['ms']:.4f} "
          f"plain_ms={t4['plain_ms']:.4f} bound_ms={t4['bound'][0]:.5f}")
    return {"flash_decode_quant": {
        "name": "flash_decode_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_quant.cu",
        "replaces": "src/repro/kernels/flash_attention/decode.py:226",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "ms": t8["ms"], "plain_ms": t8["plain_ms"], "bound_ms": t8["bound"][0],
        "bound_by": t8["bound"][1], "library_ms": t8["library_ms"],
        "library": "scaled_dot_product_attention over the pools dequantised to bf16",
        "shape": shape, "kv_bits": 8, "valid_entries": valid8,
        "kv4": {"ms": t4["ms"], "plain_ms": t4["plain_ms"], "bound_ms": t4["bound"][0]},
        "cases": errs}}


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
    before = kernel_launches.copy()
    out = fn()
    ran = list((kernel_launches - before).elements())
    check(len(ran) == 1, f"expected one dequant-matmul launch, saw {ran}")
    return out, ran[0]


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


def run_matmul_checks(torch):
    """The dequant-matmul kernel through both of its wrappers."""
    from repro_torch.kernels.pim_mvm.kernel import pim_mvm_fwd, pim_mvm_plain
    from repro_torch.quant.core import dequantize, quantize, quantize_weights
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
    }
    errs = []
    for name, (M, K, N, bits, group, dtype) in cases.items():
        x, w = operands(M, K, N, dtype or torch.bfloat16)
        qt = quantize(w, bits, group=group)
        errs.append(check_matmul(torch, "quant_matmul", name, quant_matmul_fwd,
                                 quant_matmul_plain, x, qt.q, qt.scale, bits=bits,
                                 group=group))

    # split shapes (a decode tile and a wide tile) launched on two streams
    # at once give what they give alone, bit for bit: each stream's split-K
    # tickets are its own, and the splits are added in a fixed order
    calls = []
    for M, K, N, bits, group in ((8, 2048, 11008, 8, 0), (128, 2048, 2048, 8, 128)):
        x, w = operands(M, K, N)
        qt = quantize(w, bits, group=group)
        calls.append(functools.partial(quant_matmul_fwd, x, qt.q, qt.scale, bits=bits,
                                       group=group))
    alone = [f() for f in calls]
    streams = [torch.cuda.Stream(device=DEVICE) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for r in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                j = (r + i) % 2
                outs.append((j, calls[j]()))
    torch.cuda.synchronize()
    same = all(torch.equal(out, alone[j]) for j, out in outs)
    print(f"kernel quant_matmul two_streams launches={len(outs)} identical={same}")
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
        chunk_step_int4_w_down=shape_record(1024, 11008, 2048, 4))}

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

def kernel_counters():
    """Every kernel wrapper of the port, by the name of its JSON record."""
    from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd,
                                                            flash_decode_quant_fwd)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.pim_mvm.kernel import pim_mvm_fwd
    from repro_torch.quant.kernel import quant_matmul_fwd
    return {"flash_decode": flash_decode_fwd, "flash_prefill": flash_attention_fwd,
            "flash_decode_quant": flash_decode_quant_fwd,
            "quant_matmul": quant_matmul_fwd, "pim_mvm": pim_mvm_fwd}


def reset_launches():
    from repro_torch.quant.kernel import kernel_launches
    for fn in kernel_counters().values():
        fn.launches = 0
    kernel_launches.clear()


def read_launches():
    return {name: fn.launches for name, fn in kernel_counters().items()}


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


def run_engine(torch, cfg, params, run="fp"):
    """One drain of the 16 requests, fp or quantised (``QUANT_RUNS``), with
    every kernel's launches counted over that drain alone."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    bits = QUANT_RUNS[run]
    ecfg = EngineConfig(max_batch=MAX_BATCH, kv_len=KV_LEN,
                        max_new_tokens=NEW_TOKENS, impl="flash", **bits)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in rng.integers(4, 385, N_REQUESTS)]

    # warm-up: cuBLAS handles, allocator pools, kernel modules
    warm = ServingEngine(cfg, params, EngineConfig(
        max_batch=MAX_BATCH, kv_len=KV_LEN, max_new_tokens=2, impl="flash", **bits),
        device=DEVICE)
    for p in prompts[:2]:
        warm.submit(p)
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(cfg, params, ecfg, device=DEVICE)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    kernels, designs = read_kernels()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    qp = engine.executor.params
    params_gb = sum(tensor_bytes(t) for t in (*qp.parameters(), *qp.buffers())) / 1e9
    pool_gb = tensor_bytes(engine.pool.cache) / 1e9
    st = engine.stats()
    print(f"engine run={run} arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"weight_bits={st['weight_bits']} kv_bits={st['kv_bits']} "
          f"finished={st['finished']}/{N_REQUESTS} tokens={st['tokens']} "
          f"tokens_per_s={st['tokens_per_s']:.2f} mean_ttft_s={st['mean_ttft_s']:.4f} "
          f"ttft_p95_s={st['ttft_p95_s']:.4f} mean_tpot_s={st['mean_tpot_s']:.5f} "
          f"decode_steps={st['decode_steps']} prefill_calls={st['prefill_calls']} "
          f"prefill_tokens={st['prefill_tokens']} wall_s={wall:.3f} "
          f"peak_memory_gib={peak_gib:.2f} params_gb={params_gb:.3f} "
          f"pool_gb={pool_gb:.4f} launches={json.dumps(launches)} "
          f"qmatmul_designs={json.dumps(designs)} "
          f"qmatmul_kernels={json.dumps({kernel_name(k): n for k, n in kernels.items()})}")
    check(st["finished"] == N_REQUESTS and st["failed"] == 0,
          f"engine ({run}) finished {st['finished']} of {N_REQUESTS}")
    outs = [r.output for r in engine.finished]
    check(all(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o)
              for o in outs), f"engine ({run}) produced malformed token streams")
    check(any(n > 128 for n in st["prompt_lens"]), "no chunked prefill ran")
    steps = st["decode_steps"] * cfg.n_layers
    quant_kv, quant_w = bool(bits.get("kv_bits")), bool(bits.get("weight_bits"))
    want_decode = {"flash_decode": 0 if quant_kv else steps,
                   "flash_decode_quant": steps if quant_kv else 0}
    for name, n in want_decode.items():
        check(launches[name] == n, f"{run}: {name} launches {launches[name]} != {n}")
    # every projection of every forward call (decode step, packed prefill,
    # chunk step) went through the dequant-matmul kernel
    calls = st["decode_steps"] + st["prefill_calls"]
    want_mm = PROJECTIONS * cfg.n_layers * calls if quant_w else 0
    check(launches["quant_matmul"] == want_mm,
          f"{run}: quant_matmul launches {launches['quant_matmul']} != {want_mm}")
    # the engine runs bf16: every projection on tensor cores
    check(designs == {"cuda_core": 0, "tensor_core": want_mm},
          f"{run}: qmatmul designs {designs}, want {want_mm} on tensor cores")
    check_kernels_checked(f"engine ({run})", kernels)
    check(launches["flash_prefill"] > 0 and
          launches["flash_prefill"] % cfg.n_layers == 0,
          f"{run}: prefill kernel launches {launches['flash_prefill']}")
    check(launches["pim_mvm"] == 0, f"{run}: the crossbar kernel ran in serving")
    return {"stats": st, "launches": launches, "designs": designs, "wall_s": wall,
            "peak_gib": peak_gib,
            "params_gb": params_gb, "pool_gb": pool_gb}


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


def profiled(torch, run, what, step, steps):
    """torch.profiler over ``steps`` calls of ``step``: device busy time
    (the sum of kernel times) a call, kernels launched a call and the
    largest kernels.  The profiler slows the host, so the wall time here is
    not the engine's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
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
    print(f"profile run={run} {what} busy_ms={busy_ms:.3f} wall_ms_profiled={wall_ms:.3f} "
          f"kernels_per_step={launches:.0f} top=" + json.dumps(
              [[e.key[:60], round(e.self_device_time_total / 1e3 / steps, 4), e.count // steps]
               for e in top]))
    return {"busy_ms": busy_ms, "kernels_per_step": launches, "wall_ms_profiled": wall_ms}


def run_profile(torch, cfg, params, run="fp", steps=4, chunk_steps=2):
    """Where a step's time goes, with every slot of the pool busy: ``steps``
    fused decode steps, then ``chunk_steps`` chunked-prefill steps (the
    executor's ``chunk_step``, as the engine calls it for long prompts:
    all 8 rows with a 128-token chunk, M = 1024 rows a projection)."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=MAX_BATCH, kv_len=KV_LEN, max_new_tokens=steps + 8,
        impl="flash", **QUANT_RUNS[run]), device=DEVICE)
    rng = np.random.default_rng(2)
    for _ in range(MAX_BATCH):        # 8 x 16 tokens: one packed stream
        engine.submit(rng.integers(0, cfg.vocab_size, size=16))
    engine.step()                     # admission (one packed prefill) + a step
    engine.step()
    check(len(engine.pool.decoding()) == MAX_BATCH, "profile: pool not full")
    decode = profiled(torch, run, "decode_step", engine.step, steps)

    # chunk steps over the same pool: each row's next 128 tokens at
    # positions 32..159, no row final (the slots' state is left as it is)
    B, C = MAX_BATCH, engine._chunk
    dev = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    toks = dev(rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32))
    pos = dev(np.broadcast_to(32 + np.arange(C, dtype=np.int32), (B, C)).copy())
    take = dev(np.full((B,), C - 1, np.int32))
    final, budget = dev(np.zeros((B,), bool)), dev(np.ones((B,), np.int32))
    ex, pool = engine.executor, engine.pool

    def chunk_step():
        pool.cache, pool.state, _ = ex.chunk_step(pool.cache, pool.state, toks, pos, take,
                                                  final, budget)
    chunk_step()                      # warm-up
    chunk = profiled(torch, run, "chunk_step", chunk_step, chunk_steps)
    return {"decode_step": decode, "chunk_step": chunk}


def run_logits(torch, cfg, params, run="fp"):
    """Packed prefill + 4 teacher-forced decode steps at full width,
    impl="flash" against impl="ref", each on its own slot pool.  Quantised
    (``QUANT_RUNS``), "ref" is the attention oracle over the pool
    dequantised to bf16 plus the reference's dequantise-then-matmul, whose
    weights are rounded to bf16; the kernels keep them in f32."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.executor import Executor
    from repro_torch.serving.pool import SlotPool

    rng = np.random.default_rng(1)
    B, C, lens = 4, 128, (30, 61, 17)
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
        ecfg = EngineConfig(max_batch=B, kv_len=256, impl=impl, **QUANT_RUNS[run])
        ex = Executor(cfg, params, ecfg, device=torch.device(DEVICE))
        pool = SlotPool(cfg, ecfg, device=torch.device(DEVICE))
        with torch.no_grad():
            logits, pc = T.prefill_packed(ex.params, cfg, dev(toks), dev(pos), dev(seg),
                                          dev(gather), impl=impl, kv_bits=ecfg.kv_bits)
            ex.packed_insert(pool.cache, pc["stack"], dev(seg), dev(pos),
                              dev(seg_len), dev(active))
            out = [logits.float()]
            for s in range(4):
                p = np.where(active, seg_len + s, -1).astype(np.int32)
                logits, _ = T.decode_step(ex.params, cfg, pool.cache, dev(steps[s]),
                                          dev(p), impl=impl)
                out.append(logits.float()[: len(lens)])
        del ex
        results[impl] = out
    names = ["prefill"] + [f"decode{s}" for s in range(4)]
    scale = max(float(r.abs().max()) for r in results["ref"])
    # bound: the oracle rounds its probabilities to bf16 before the value
    # product and the kernels do not; over 36 bf16 layers of random weights
    # that difference may grow to a few bf16 ulps of the logits' scale
    limit = 5e-2 * max(1.0, scale)
    diffs = {n: float((a - b).abs().max()) for n, a, b in
             zip(names, results["flash"], results["ref"])}
    finite = all(bool(torch.isfinite(r).all()) for r in results["flash"])
    print(f"logits run={run} arch={cfg.name} max_abs_diff={json.dumps(diffs)} "
          f"bound={limit:.4f} ref_scale={scale:.4f} finite={finite}")
    check(finite and max(diffs.values()) <= limit,
          f"flash and ref logits ({run}) disagree beyond the bound")
    return diffs, limit


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T

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

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"params: {n_params} in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    runs = {run: run_engine(torch, cfg, params, run) for run in QUANT_RUNS}
    crossbar = run_crossbar(torch)
    for run in ("fp", "w8kv8"):
        run_logits(torch, cfg, params, run)
    for run in ("fp", "w8kv8"):
        run_profile(torch, cfg, params, run)

    # launches: each main-path run, counted from 0 just before it
    by_run = {run: r["launches"] for run, r in runs.items()}
    by_run["crossbar"] = crossbar
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
