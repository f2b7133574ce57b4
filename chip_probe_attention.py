#!/usr/bin/env python3
"""Where the time of the two split-KV decodes (``decode.cu`` over the fp
pool, ``decode_quant.cu`` over the quantised one) and of the tensor-core
prefill (``prefill.cu``) goes, on one NVIDIA card.

    python3 chip_probe_attention.py                  # the plans, as built
    python3 chip_probe_attention.py dc_nomerge ...   # and named variants
    python3 chip_probe_attention.py --wide [pf_...]  # the wide-head prefills

At the serving engine's shapes (decode: B = 8 slots, a 1024-entry pool,
16 query heads over 2 KV heads, head_dim 128, bf16, kv8 and kv4; prefill: one
128-token packed stream of three prompts and pad, the same heads), it
times each kernel (device time per call, as ``chip_smoke.py`` measures it,
cycling over pools that span twice the L2) under the plan the wrapper
makes, then under other plans (the wrapper's plan function replaced for the
call: split counts of the decode, query heads and rows a block of the
prefill), each checked against the plain version.  Then, for each variant
named on the command line, it rebuilds the variant's source with one edit
(in ``build/attention_probe/<variant>``, git-ignored) and times that kernel
in the same process; some variants are ablations that compute wrong results
on purpose (what a part of the kernel costs).  The wrappers' plans are
timed again at the end ("again"): calls made later in one process may read
faster, so compare a variant with the timings around it.  Not part of the
port's checks: ``chip_smoke.py`` is.

``--wide`` studies the prefill's tensor-core design at the wide heads
instead (hd 256: gemma2-9b's and gpt-j's 128-token packed streams and
recurrentgemma-9b's 4608-token padded prompt at MQA rep 16; MLA's hd 192 /
hdv 128 at deepseek-v2's 384-token prompt over 128 heads): ``ptxas``'s
registers and spills of each ``prefill_tc_kernel`` instantiation, then
each shape under the plan (checked against the plain version, timed
beside it, ``scaled_dot_product_attention`` and the bound, as
``chip_smoke.py`` times it) and under other blocks, then each ``pf_*``
variant named at those shapes.
"""
import pathlib
import shutil
import sys

import numpy as np

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
# decode: split counts (tiles a split: the fewest that cover the pool);
# prefill: (query heads, query rows) a block
SPLITS = (1, 2, 4, 8, 16, 32)
PREFILL_BLOCKS = ((1, 16), (2, 16), (8, 16), (1, 32), (2, 32), (1, 64))
_PV = "for (int i = 0; i < 3; ++i) {\n            mma_bf16(o[2 * np], pa[i], r[0], r[1]);"
SOURCES = {"dc": "decode.cu", "dq": "decode_quant.cu", "pf": "prefill.cu"}  # by prefix
VARIANTS = {   # name: [(file of csrc/, its text, the replacement), ...]
    # fp decode ablations (wrong results): the merge, every tile, the
    # tiles' arithmetic, the scores, the values; and blocks of 4 warps (2
    # query rows each at rep 8)
    "dc_nomerge": [("decode.cu", "  split_kv_merge<T>(p.split, unit, ob, p.o_sh, nrows, -1, lb);", "")],
    "dc_notiles": [("decode.cu", "    int cur = next_live(0), s = 0;", "    int cur = cn, s = 0;")],
    "dc_nocompute": [("decode.cu", "      if (active) {\n        const bool valid",
                      "      if (false) {\n        const bool valid")],
    "dc_noscores": [("decode.cu", "        for (int c = 0; c < kbytes; c += 16) {",
                     "        for (int c = 0; c < 0; c += 16) {")],
    "dc_novalues": [("decode.cu", "          for (int jj = 0; jj < kTile; ++jj) {",
                     "          for (int jj = 0; jj < 0; ++jj) {")],
    "dc_4warps": [("decode.cu", "constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    # registers capped for two blocks an SM (the plan's 176 blocks in one
    # wave), in either decode
    "dc_2blocks": [("decode.cu", "__launch_bounds__(kThreads) decode_attention_kernel",
                    "__launch_bounds__(kThreads, 2) decode_attention_kernel")],
    "dq_2blocks": [("decode_quant.cu", "__launch_bounds__(kThreads) decode_quant_kernel",
                    "__launch_bounds__(kThreads, 2) decode_quant_kernel")],
    # decode ablations (wrong results): the merge, every tile, the tiles'
    # arithmetic, the scores, the values
    "dq_nomerge": [("decode_quant.cu",
                    "  split_kv_merge<T>(p.split, unit, ob, p.o_sh, nrows, p.hdv, lb);", "")],
    "dq_notiles": [("decode_quant.cu", "  int cur = next_live(0), s = 0;",
                    "  int cur = nt, s = 0;")],
    "dq_nocompute": [("decode_quant.cu", "    if (active) {\n      const unsigned vmask",
                      "    if (false) {\n      const unsigned vmask")],
    "dq_noscores": [("decode_quant.cu", "      for (int c = 0; c < hdq; c += 16) {",
                     "      for (int c = 0; c < 0; c += 16) {")],
    "dq_novalues": [("decode_quant.cu", "        for (int jj = 0; jj < kTile; ++jj) {",
                     "        for (int jj = 0; jj < 0; ++jj) {")],
    # decode tuning choices: blocks of 4 warps (2 query rows each at rep 8),
    # the merge's division as a reciprocal
    "dq_4warps": [("decode_quant.cu", "constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "dq_rcp": [("split_kv.cuh", "    if (L == 0.f) L = 1.f;  // empty unit -> exact zeros",
                "    if (L == 0.f) L = 1.f;  // empty unit -> exact zeros\n    const float inv = 1.f / L;"),
               ("split_kv.cuh", "{o.x / L, o.y / L, o.z / L, o.w / L}",
                "{o.x * inv, o.y * inv, o.z * inv, o.w * inv}")],
    # prefill ablations (wrong results): no run-time tile skip, no tiles'
    # arithmetic, no S or no P.V product, no Q loads
    "pf_noprologue": [("prefill.cu", "  if (sb) {  // which tiles hold",
                       "  if (false) {  // which tiles hold"),
                      ("prefill.cu", "    if (sb)\n      while (tt < ntile",
                       "    if (false)\n      while (tt < ntile")],
    "pf_nocompute": [("prefill.cu", "    if (need) {", "    if (false) {")],
    "pf_nos": [("prefill.cu", "          mma_bf16(sc[2 * np], qf[kk], r[0], r[1]);\n"
                "          mma_bf16(sc[2 * np + 1], qf[kk], r[2], r[3]);", "")],
    "pf_nopv": [("prefill.cu", _PV, _PV.replace("i < 3", "i < 0"))],
    "pf_noq": [("prefill.cu", "  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;",
                "  return ok ? 0x3f803f80u : 0u;")],
    # prefill tuning choices: P in two or one bf16 terms instead of three
    # (two: right to 2^-17 of P), the epilogue's f32 division an element,
    # exp as exp2f of a scaled argument
    "pf_p2": [("prefill.cu", _PV, _PV.replace("i < 3", "i < 2"))],
    "pf_p1": [("prefill.cu", _PV, _PV.replace("i < 3", "i < 1"))],
    "pf_div": [("prefill.cu", "pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);",
                "pack_bf16(o[n][2 * i] / (1.f / inv), o[n][2 * i + 1] / (1.f / inv));")],
    "pf_exp2": [("prefill.cu", "expf(sc[n][c] - m[c >> 1])",
                 "exp2f((sc[n][c] - m[c >> 1]) * 1.4426950408889634f)")],
    # the wide heads' register choice undone: one warp a 16-row tile at hd
    # 256 too, Q's 64 registers and O's 128 in it (ptxas spills); the plan
    # is the wrapper's, so a block holds half as many warps
    "pf_nosplit": [("prefill.cu", "return hd / 4 + hdv / 2 > 128 ? 2 : 1;", "return 1;")],
    # the pair without the exchange: each warp sums the whole of S itself
    # (all of Q's dims in its registers) and keeps its half of O's columns
    "pf_dups": [("prefill.cu", "constexpr int kD = HD / kSplit,", "constexpr int kD = HD,"),
                ("prefill.cu", "head * a.q_sh + half * kD;", "head * a.q_sh;"),
                ("prefill.cu", "const int d0 = half * kD + kk * 16;", "const int d0 = kk * 16;"),
                ("prefill.cu", "if constexpr (kSplit > 1) {\n        // the pair's halves",
                 "if constexpr (false) {\n        // the pair's halves")],
    # blocks of at most 4 warps (PLAN_PATCHES), three an SM: at most 168
    # registers a thread
    "pf_3blocks4": [("prefill.cu", "__launch_bounds__(32 * kMaxWarps) prefill_tc_kernel",
                     "__launch_bounds__(128, 3) prefill_tc_kernel")],
}
# what a variant changes in the wrapper's plan while it is timed
PLAN_PATCHES = {"pf_3blocks4": {"TC_MAX_WARPS": 4}}
# --wide: name -> (chip_smoke's shape, timing iterations, other blocks
# (query heads, query rows) to time beside the plan's)
WIDE = {
    "gemma2-9b S128 16/8 hd256": (cs.GEMMA2_PREFILL, 200, ((1, 16), (2, 32), (1, 64))),
    "gpt-j S128 16/16 hd256": (cs.PAPER_PREFILL["gpt-j"], 200, ((1, 16), (1, 64))),
    "recurrentgemma-9b S4608 16/1 hd256": (dict(cs.RGEMMA_PREFILL, S=4608), 20,
                                           ((2, 16), (2, 32), (1, 64))),
    "deepseek-v2 MLA S384 128/128 hd192/128": (dict(cs.MLA_PREFILL, S=384), 50,
                                               ((1, 32), (1, 64))),
}


def rebuilt(name, build):
    """The build of variant ``name``'s edited source (one edit of its
    file under ``build/attention_probe/<name>``), loaded in place of the
    source's until ``restore`` is called."""
    source = SOURCES[name[:2]]
    d = ROOT / "build" / "attention_probe" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    src = build.CSRC
    for f in list(src.glob("*.cuh")) + [src / source]:
        shutil.copy(f, d / f.name)
    for file, old, new in VARIANTS[name]:
        text = (d / file).read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: its text is no longer in {file}")
        (d / file).write_text(text.replace(old, new))
    build.build.cache_clear()
    build.bind.cache_clear()
    build.CSRC, build.BUILD_ROOT = d, d / "out"
    return build.build()


def restore(build, src, root):
    build.build.cache_clear()
    build.bind.cache_clear()
    build.CSRC, build.BUILD_ROOT = src, root


def ptxas_lines(log, source="prefill.cu"):
    """``ptxas -v``'s lines of one source: each entry function's name,
    then its registers, stack and spills."""
    part = log.split(f"== {source}")[-1].split("\n== ")[0]
    return [ln.strip() for ln in part.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def wide(torch, names):
    """The tensor-core prefill at the wide heads (``WIDE``): registers and
    spills, each shape checked and timed under the plan and other blocks,
    then under each named ``pf_*`` variant."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K
    b = build.build()
    print(f"build {b.seconds:.1f} s")
    for ln in ptxas_lines(b.log):
        print(ln)
    rng = np.random.default_rng(30)
    cases = {n: (cs.prefill_case(torch, rng, **kw), kw, it, blocks)
             for n, (kw, it, blocks) in WIDE.items()}

    def run(tag, name, blocks=None):
        c, kw, iters, _ = cases[name]
        args = dict(segments=c["segments"], window=c["window"], softcap=c["softcap"],
                    causal=c["causal"])
        out = K.flash_attention_fwd(c["q"], c["k"], c["v"], **args)
        ref = K.flash_attention_plain(c["q"], c["k"], c["v"], **args)
        err = float((out.float() - ref.float()).abs().max())
        pad = "" if c["seg_np"] is None else \
            f" pad_rows_zero={bool((out[:, :, torch.from_numpy(c['seg_np'][0] < 0).to(out.device)] == 0).all())}"
        ms = cs.device_ms(lambda: K.flash_attention_fwd(c["q"], c["k"], c["v"], **args), iters)
        print(f"{tag:12s} {name} block={blocks or 'plan'} ms={ms:.4f} "
              f"max_abs_err={err:.2e}{pad}", flush=True)

    for name, (c, kw, iters, blocks) in cases.items():
        cs.prefill_timing(torch, np.random.default_rng(31), kw, iters=iters)
        run("as built", name)
        plan = K.prefill_plan
        for h, r in blocks:
            K.prefill_plan = lambda *a, h=h, r=r: K.Plan("tensor_core", h, r)
            run(f"h{h}r{r}", name, (h, r))
        K.prefill_plan = plan
    src, root = build.CSRC, build.BUILD_ROOT
    for name in names:
        for ln in ptxas_lines(rebuilt(name, build).log):
            print(f"{name} {ln}")
        saved = {k: getattr(K, k) for k in PLAN_PATCHES.get(name, {})}
        for k, v in PLAN_PATCHES.get(name, {}).items():
            setattr(K, k, v)
        for case in cases:
            run(name, case)
        for k, v in saved.items():
            setattr(K, k, v)
        restore(build, src, root)
    for case in cases:
        run("again", case)
    return 0


def main(names):
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_attention: no CUDA device", file=sys.stderr)
        return 1
    is_wide = "--wide" in names
    names = [n for n in names if n != "--wide"]
    unknown = [n for n in names if n not in VARIANTS or (is_wide and not n.startswith("pf"))]
    if unknown:
        print(f"unknown variants {unknown}; known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import decode as D
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.scratch import sm_count
    from repro_torch.quant.core import quantize_kv
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip())
    if is_wide:
        return wide(torch, names)
    sms = sm_count(torch.device("cuda"))
    rng = np.random.default_rng(0)
    decode = {}
    for bits in (8, 4):
        c = cs.decode_case(torch, rng, copies=cs.cold_copies(2 * 8 * 1024 * 2 * (
            128 * bits // 8 + 4)))
        pools = [(*quantize_kv(k, bits), *quantize_kv(v, bits)) for k, v in c["pools"]]
        args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"])
        decode[bits] = (c["q"], pools, args)
    p = cs.prefill_case(torch, rng)
    pargs = dict(segments=p["segments"])
    plain_prefill = K.flash_attention_plain(p["q"], p["k"], p["v"], **pargs).float()
    c = cs.decode_case(torch, rng, copies=cs.cold_copies(2 * 8 * 1024 * 2 * 128 * 2))
    fp = (c["q"], c["pools"], dict(q_pos=c["q_pos"], kv_pos=c["kv_pos"]))

    def time_fp_decode(tag):
        q, pools, args = fp
        B, Skv, Hkv = pools[0][0].shape[:3]
        sp = D.decode_splits(B, Hkv, Skv, sms)
        out = D.flash_decode_fwd(q, *pools[0], **args).float()
        err = (out - D.flash_decode_plain(q, *pools[0], **args).float()).abs().max()
        nxt = cs.cycler(pools)
        ms = cs.device_ms(lambda: D.flash_decode_fwd(q, *nxt(), **args), 200)
        print(f"{tag:13s} decode bf16 splits={sp.splits} tiles={sp.tiles} "
              f"blocks={B * Hkv * sp.splits} ms={ms:.4f} max_abs_err={float(err):.2e}")

    def time_decode(tag):
        for bits, (q, pools, args) in decode.items():
            B, Skv, Hkv = pools[0][0].shape[:3]
            sp = D.decode_splits(B, Hkv, Skv, sms)
            out = D.flash_decode_quant_fwd(q, *pools[0], **args).float()
            err = (out - D.flash_decode_quant_plain(q, *pools[0], **args).float()).abs().max()
            nxt = cs.cycler(pools)
            ms = cs.device_ms(lambda: D.flash_decode_quant_fwd(q, *nxt(), **args), 200)
            print(f"{tag:13s} decode_quant kv{bits} splits={sp.splits} tiles={sp.tiles} "
                  f"blocks={B * Hkv * sp.splits} ms={ms:.4f} max_abs_err={float(err):.2e}")

    def time_prefill(tag):
        B, Hq, S, hd = p["q"].shape
        plan = K.prefill_plan(B, S, Hq, p["k"].shape[1], hd, hd, p["q"].dtype, True, sms)
        out = K.flash_attention_fwd(p["q"], p["k"], p["v"], **pargs).float()
        err = (out - plain_prefill).abs().max()
        ms = cs.device_ms(lambda: K.flash_attention_fwd(p["q"], p["k"], p["v"], **pargs), 200)
        print(f"{tag:13s} prefill {plan.design} heads={plan.heads} rows={plan.rows} "
              f"warps_a_block={plan.heads * plan.rows // 16} ms={ms:.4f} "
              f"max_abs_err={float(err):.2e}")

    print(f"build {build.build().seconds:.1f} s")
    time_fp_decode("as built")
    time_decode("as built")
    time_prefill("as built")
    plan_decode, plan_prefill = D.decode_splits, K.prefill_plan
    ntiles = 1024 // D.TILE
    for n in SPLITS:
        tiles = -(-ntiles // n)
        D.decode_splits = lambda *a, tiles=tiles: D.Split(-(-ntiles // tiles), tiles)
        time_fp_decode(f"splits{n}")
        time_decode(f"splits{n}")
    D.decode_splits = plan_decode
    for heads, rows in PREFILL_BLOCKS:
        K.prefill_plan = lambda *a, h=heads, r=rows: K.Plan("tensor_core", h, r)
        time_prefill(f"h{heads}r{rows}")
    K.prefill_plan = plan_prefill

    src, root = build.CSRC, build.BUILD_ROOT
    for name in names:
        rebuilt(name, build)
        {"dc": time_fp_decode, "dq": time_decode, "pf": time_prefill}[name[:2]](name)
        restore(build, src, root)
    time_fp_decode("again")
    time_decode("again")
    time_prefill("again")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
