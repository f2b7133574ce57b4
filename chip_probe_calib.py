#!/usr/bin/env python3
"""Where phase ``calib``'s fits come from, on one NVIDIA card.

    python3 chip_probe_calib.py                      # the phase, then every study
    python3 chip_probe_calib.py prefill executor     # the phase, then the named ones
    python3 chip_probe_calib.py --no-phase replay    # the named ones only

First phase ``calib`` of ``chip_smoke.py`` alone (``run_calib``: its grid,
its checks and its pins).  Then each study named on the command line:

- ``prefill``: the prefill kind of ``kernel_samples`` on llama2-7b at full
  width, B 4 and 8, one segment a row, fitted on each S grid of
  ``PREFILL_GRIDS``: the reference's regressor (the score phase, whose
  term counts the output projection, linear in S) against the kernel's
  causal work (quadratic in S);
- ``executor``: ``executor_samples`` at phase ``calib``'s settings four
  times (is the step's growth with B systematic?), then with 32 replays a
  timed call, with ``impl="ref"`` (the oracle reads the whole pool) at
  ``kv_len`` 512 and 2048, and with B up to 16;
- ``replay``: is the replayed step bound by the host or by the card?  At
  each of phase ``calib``'s batches, up and back down, ``REPLAY_CALLS``
  calls of 8 replays as ``measure`` times them (the spread of their wall
  times), the host's time to issue the 8 replays, and the card's time for
  them (CUDA events) with the stream held busy while the host issues
  them, so that no gap of the host's shows in it; the SM clock before and
  after;
- ``clocks``: B 8 engines replayed for ``CLOCK_SECONDS`` seconds while
  ``nvidia-smi`` samples the SM clock, power and clock-event reasons every
  20 ms: which clock, and which reasons, do the fast calls (under 0.93 of
  the median) and the others run at?
- ``library``: the library's time for the four kernels at the shapes
  of ``PERF.md``'s phase ``calib`` row (llama2-7b, MHA 32/32, hd 128):
  the decode over a full 32768-entry pool at B 8, fp, kv8 and kv4
  (``scaled_dot_product_attention`` with the valid-entry mask, over the
  pool dequantised to bf16 for kv8/kv4, the dequantisation timed with
  it), the causal prefill at B 8, S 16384 (``scaled_dot_product_attention``
  with ``is_causal``) and the (8, 8192, 128256) dequant-matmul at int8 and
  int4 (the weight dequantised to bf16, then ``torch.matmul``), each beside
  the kernel on the same inputs, timed as phase ``calib`` times (host
  clock, min of 5 synchronised calls, median of 3 passes);
- ``engines``: B 8 engines over one set of weights, built one after
  another for ``CLOCK_SECONDS`` seconds, 40 calls of 8 replays each: per
  engine its first, median and last call, the hash of its tokens, its
  capture stream and where its KV pool and weights lie.  Is a fast step a
  property of one engine or of a moment, and does it compute the same
  tokens?

Each sample and each fit is printed.  Not part of the port's checks:
``chip_smoke.py`` is.
"""
import subprocess
import sys
import time

import chip_smoke as cs

PREFILL_GRIDS = ((1024, 2048, 4096), (4096, 8192, 16384), (8192, 12288, 16384))
EXECUTOR_RUNS = {"flash0": {}, "flash1": {}, "flash2": {}, "flash3": {},
                 "flash_spc32": dict(steps_per_call=32), "ref512": dict(impl="ref"),
                 "ref2048": dict(impl="ref", kv_len=2048),
                 "flash_b16": dict(batches=(1, 4, 8, 16))}


def print_fit(tag, samples, seconds):
    from repro_torch.profile.costmodel import fit_phase
    f = fit_phase(samples)
    print(f"probe {tag} fit kind={f.kind} term={f.term} rate={f.rate:.4e} "
          f"intercept_us={f.intercept_s * 1e6:.2f} r2={f.r2:.5f} "
          f"rate_ci95_rel={f.rate_ci95_rel} heldout_max_rel_err={f.heldout_max_rel_err:.4f} "
          f"heldout_mean_rel_err={f.heldout_mean_rel_err:.4f} ({seconds:.1f} s)")


def study_prefill():
    from repro_torch.config import get_config
    from repro_torch.profile.bench import kernel_samples
    cfg = get_config(cs.CALIB_ARCH)
    for lens in PREFILL_GRIDS:
        t0 = time.perf_counter()
        samples = kernel_samples((cs.CALIB_ARCH,), batches=(4, 8), kv_lens=(), kv_bits=(),
                                 prefill_lens=lens, seg_len=max(lens), qmm_bits=(),
                                 repeat=cs.CALIB_REPEAT, device=cs.DEVICE, reduce=False)
        for s in samples:
            # the kernel's causal work: 2·S²·(heads x head dim) a row
            causal = 2 * s.params["seq"] ** 2 * cfg.n_heads * cfg.head_dim * s.params["batch"]
            print(f"probe prefill {s.params} flops={s.flops_term:.4e} seconds={s.seconds:.6e} "
                  f"causal_flops_per_s={causal / s.seconds:.4e}")
        print_fit(f"prefill S {lens}", samples, time.perf_counter() - t0)


def study_executor():
    import torch
    from repro_torch.profile.bench import executor_samples
    for tag, kw in EXECUTOR_RUNS.items():
        t0 = time.perf_counter()
        args = dict(cs.CALIB_EXECUTOR, warmup=1, repeat=cs.CALIB_REPEAT, steps_per_call=8,
                    device=cs.DEVICE, reduce=False)
        args.update(kw)
        samples = executor_samples(**args)
        print(f"probe executor {tag} " + " ".join(
            f"B{s.params['batch']}={s.seconds * 1e3:.4f}ms" for s in samples))
        print_fit(f"executor {tag}", samples, time.perf_counter() - t0)
        cs.collect(torch)


REPLAY_CALLS = 40


def sm_clock():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def study_replay():
    import numpy as np
    import torch
    import repro_torch.models.transformer as T
    from repro_torch.config import get_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    ex = cs.CALIB_EXECUTOR
    cfg = get_config(ex["archs"][0])
    prompt, spc = 16, 8
    for batch in tuple(ex["batches"]) + tuple(reversed(ex["batches"])):
        params = T.init_params(cfg, torch.Generator(device=cs.DEVICE).manual_seed(0),
                               device=cs.DEVICE, dtype=torch.bfloat16)
        eng = ServingEngine(cfg, params, EngineConfig(
            max_batch=batch, kv_len=ex["kv_len"], max_new_tokens=ex["kv_len"] - prompt - 2,
            impl=ex["impl"], fused=True, packed=True, seed=0), device=cs.DEVICE)
        for i in range(batch):
            eng.submit([(7 * i + j) % 97 + 1 for j in range(prompt)])
        eng.step()
        clock0 = sm_clock()

        def run():
            for _ in range(spc):
                eng.executor.run("fused_step", eng.pool)
        run()
        torch.cuda.synchronize()
        walls, issues = [], []
        for _ in range(REPLAY_CALLS):
            t0 = time.perf_counter()
            run()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / spc)
            issues.append((t1 - t0) / spc)
        devs = []
        for _ in range(8):
            torch.cuda._sleep(50_000_000)           # holds the stream ~25 ms
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            devs.append(e0.elapsed_time(e1) / 1e3 / spc)
        w, d = np.asarray(walls) * 1e3, np.asarray(devs) * 1e3
        print(f"probe replay B{batch} wall_ms min={w.min():.4f} p50={np.median(w):.4f} "
              f"max={w.max():.4f} first5_min={w[:5].min():.4f} "
              f"issue_ms min={min(issues) * 1e3:.4f} p50={np.median(issues) * 1e3:.4f} "
              f"device_ms min={d.min():.4f} p50={np.median(d):.4f} max={d.max():.4f} "
              f"sm_clock before={clock0!r} after={sm_clock()!r}")
        print(f"probe replay B{batch} walls_ms " + " ".join(f"{x:.4f}" for x in w))
        del eng, params, run
        cs.collect(torch)


CLOCK_SECONDS = 20.0
CLOCK_QUERY = "clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_event_reasons.active"


def study_clocks():
    import collections
    import datetime
    import tempfile
    import numpy as np
    import torch
    import repro_torch.models.transformer as T
    from repro_torch.config import get_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    ex = cs.CALIB_EXECUTOR
    cfg = get_config(ex["archs"][0])
    prompt, spc, batch = 16, 8, 8
    calls = []                                      # (start, end) epoch s, ms a step
    with tempfile.TemporaryFile("w+") as log:
        mon = subprocess.Popen(["nvidia-smi", f"--query-gpu=timestamp,{CLOCK_QUERY}",
                                "--format=csv,noheader", "-lms", "20"], stdout=log, text=True)
        try:
            params = T.init_params(cfg, torch.Generator(device=cs.DEVICE).manual_seed(0),
                                   device=cs.DEVICE, dtype=torch.bfloat16)
            t_end = time.perf_counter() + CLOCK_SECONDS
            while time.perf_counter() < t_end:
                eng = ServingEngine(cfg, params, EngineConfig(
                    max_batch=batch, kv_len=ex["kv_len"],
                    max_new_tokens=ex["kv_len"] - prompt - 2, impl=ex["impl"], fused=True,
                    packed=True, seed=0), device=cs.DEVICE)
                for j in range(batch):
                    eng.submit([(7 * j + k) % 97 + 1 for k in range(prompt)])
                eng.step()
                for _ in range(40):                 # 320 steps, inside the budget
                    t0, w0 = time.perf_counter(), time.time()
                    for _ in range(spc):
                        eng.executor.run("fused_step", eng.pool)
                    torch.cuda.synchronize()
                    calls.append((w0, time.time(), (time.perf_counter() - t0) / spc * 1e3))
                del eng
            del params
            cs.collect(torch)
        finally:
            mon.terminate()
            mon.wait()
        log.seek(0)
        samples = []                                # (epoch s, SM clock, event reasons)
        for line in log.read().splitlines():
            f = [x.strip() for x in line.split(",")]
            t = datetime.datetime.strptime(f[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
            samples.append((t, f[1], f[-1]))
    ms = np.asarray([c[2] for c in calls])
    med = np.median(ms)
    fast = [c for c in calls if c[2] < 0.93 * med]
    print(f"probe clocks B{batch} calls={len(ms)} median_ms={med:.4f} min={ms.min():.4f} "
          f"p1={np.percentile(ms, 1):.4f} p99={np.percentile(ms, 99):.4f} "
          f"fast(<0.93 median)={len(fast)} fast_ms={[round(c[2], 4) for c in fast][:20]}")

    def during(sel):
        return dict(collections.Counter(
            (clk, why) for t, clk, why in samples if any(a <= t <= b for a, b, _ in sel)))
    print(f"probe clocks nvidia-smi samples={len(samples)} (SM clock, event reasons): "
          f"all {dict(collections.Counter((c, w) for _, c, w in samples))} "
          f"during fast calls {during(fast)} "
          f"during the others {during([c for c in calls if c[2] >= 0.93 * med])}")


def first_tensor(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree
    for x in items:
        if isinstance(x, (dict, list, tuple, torch.Tensor)):
            t = first_tensor(x)
            if t is not None:
                return t
    return None


def study_engines():
    import hashlib
    import numpy as np
    import torch
    import repro_torch.models.transformer as T
    from repro_torch.config import get_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    ex = cs.CALIB_EXECUTOR
    cfg = get_config(ex["archs"][0])
    prompt, spc, batch = 16, 8, 8
    params = T.init_params(cfg, torch.Generator(device=cs.DEVICE).manual_seed(0),
                           device=cs.DEVICE, dtype=torch.bfloat16)
    w_ptr = next(iter(params.parameters())).data_ptr()
    t_end, n = time.perf_counter() + CLOCK_SECONDS, 0
    hashes = {}
    while time.perf_counter() < t_end:
        eng = ServingEngine(cfg, params, EngineConfig(
            max_batch=batch, kv_len=ex["kv_len"], max_new_tokens=ex["kv_len"] - prompt - 2,
            impl=ex["impl"], fused=True, packed=True, seed=0), device=cs.DEVICE)
        for j in range(batch):
            eng.submit([(7 * j + k) % 97 + 1 for k in range(prompt)])
        eng.step()
        digest, walls = hashlib.sha1(), []
        for _ in range(40):
            t0 = time.perf_counter()
            outs = [eng.executor.run("fused_step", eng.pool).clone() for _ in range(spc)]
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / spc * 1e3)
            for o in outs:
                digest.update(o.cpu().numpy().tobytes())
        h = digest.hexdigest()[:16]
        hashes[h] = hashes.get(h, 0) + 1
        w = np.asarray(walls)
        print(f"probe engine #{n} first_ms={w[0]:.4f} p50_ms={np.median(w):.4f} "
              f"last_ms={w[-1]:.4f} tokens_sha1={h} "
              f"stream={eng.executor.graphs.stream.cuda_stream:#x} "
              f"kv_at={first_tensor(eng.pool.cache).data_ptr():#x} weights_at={w_ptr:#x}")
        del eng, outs
        n += 1
    print(f"probe engines {n} token hashes {hashes}")
    del params
    cs.collect(torch)


def host_ms(fn, calls=5, passes=3):
    """Phase ``calib``'s timing: the min over ``calls`` synchronised calls
    on the host clock, the median over ``passes`` passes (ms)."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    mins = []
    for _ in range(passes):
        best = float("inf")
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        mins.append(best * 1e3)
    return statistics.median(mins)


def study_library():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd,
                                                            flash_decode_quant_fwd)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.quant.core import dequantize, dequantize_kv, quantize, quantize_kv
    from repro_torch.quant.kernel import quant_matmul_fwd
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, hd, skv, seq = 8, 32, 128, 32768, 16384
    M, K, N = 8, 8192, 128256

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)

    def report(what, kernel_ms, library_ms):
        print(f"probe library {what} kernel_ms={kernel_ms:.4f} library_ms={library_ms:.4f} "
              f"library_over_kernel={library_ms / kernel_ms:.3f} card={cs.CARD}")
    q, k, v = randn(B, 1, H, hd), randn(B, skv, H, hd), randn(B, skv, H, hd)
    q_pos = torch.full((B, 1), skv - 1, dtype=torch.int32, device="cuda")
    kv_pos = torch.arange(skv, dtype=torch.int32, device="cuda").expand(B, skv).contiguous()
    mask = (kv_pos <= q_pos)[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    report("decode B=8 Skv=32768 fp",
           host_ms(lambda: flash_decode_fwd(q, k, v, q_pos=q_pos, kv_pos=kv_pos)),
           host_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)))
    for bits in (8, 4):
        k_q, k_s = quantize_kv(k, bits)
        v_q, v_s = quantize_kv(v, bits)

        def library():
            kd = dequantize_kv(k_q, k_s, bits).to(torch.bfloat16).transpose(1, 2)
            vd = dequantize_kv(v_q, v_s, bits).to(torch.bfloat16).transpose(1, 2)
            return F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask)
        report(f"decode B=8 Skv=32768 kv{bits}",
               host_ms(lambda: flash_decode_quant_fwd(q, k_q, k_s, v_q, v_s, kv_bits=bits,
                                                      q_pos=q_pos, kv_pos=kv_pos)),
               host_ms(library))
        del k_q, k_s, v_q, v_s
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    q, k, v = randn(B, H, seq, hd), randn(B, H, seq, hd), randn(B, H, seq, hd)
    seg = torch.zeros((B, seq), dtype=torch.int32, device="cuda")
    report("prefill B=8 S=16384 causal",
           host_ms(lambda: flash_attention_fwd(q, k, v, segments=seg, causal=True)),
           host_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)))
    del q, k, v
    torch.cuda.empty_cache()
    x = randn(M, K)
    for bits in (8, 4):
        w = quantize(randn(K, N, dtype=torch.float32), bits)
        report(f"qmatmul M=8 K=8192 N=128256 int{bits}",
               host_ms(lambda: quant_matmul_fwd(x, w.q, w.scale, bits=bits)),
               host_ms(lambda: torch.matmul(x, dequantize(w).to(torch.bfloat16))))
        del w
        torch.cuda.empty_cache()


STUDIES = {"prefill": study_prefill, "executor": study_executor, "replay": study_replay,
           "clocks": study_clocks, "engines": study_engines, "library": study_library}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_calib: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    phase = "--no-phase" not in args
    studies = [a for a in args if a != "--no-phase"] or list(STUDIES)
    unknown = [s for s in studies if s not in STUDIES]
    if unknown:
        print(f"chip_probe_calib: no study {unknown}; the studies: {list(STUDIES)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    print(f"device: {cs.CARD}")
    b = build.build()
    print(f"build: {b.seconds:.2f} s")
    if phase:
        cs.run_calib(torch, {})
    for name in studies:
        STUDIES[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
