#!/usr/bin/env python3
"""Where the time of the dequant-matmul kernels (``qmatmul.cu``) goes, on
one NVIDIA card.

    python3 chip_probe_qmatmul.py                    # the shapes, as built
    python3 chip_probe_qmatmul.py noconv nomma ...   # and named variants

It times ``quant_matmul_fwd`` / ``pim_mvm_fwd`` (device time per call, as
``chip_smoke.py`` measures it) at the serving engine's and the crossbar's
shapes, with the plan each takes.  Then, for each variant named on the
command line, it rebuilds ``qmatmul.cu`` with one edit of the source (in
``build/qmatmul_probe/<variant>``, git-ignored) and times the same shapes in
the same process.  Some variants are ablations that compute wrong results
on purpose (what a part of the kernel costs); the others are tuning
choices.  The unchanged source is timed again at the end ("again"): calls
made later in one process run faster (clocks, caches), so compare a
variant with the timings around it.  Not part of the port's checks:
``chip_smoke.py`` is.
"""
import pathlib
import shutil
import sys

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
# (M, K, N, bits, group, crossbar tile scales)
SHAPES = [(8, 2048, 11008, 8, 0, False), (8, 11008, 2048, 4, 0, False),
          (8, 2048, 2048, 8, 0, False), (1024, 2048, 11008, 8, 0, False),
          (1024, 11008, 2048, 4, 0, False), (1024, 2048, 2048, 8, 0, False),
          (1024, 2048, 256, 8, 0, False), (128, 2048, 2048, 8, 0, False),
          (128, 2048, 2048, 8, 128, False), (512, 2048, 1024, 8, 0, True),
          (256, 1024, 512, 8, 0, True), (512, 2048, 1024, 8, 0, False)]
_MMA = "mma_bf16(GROUPED ? part[i][j] : acc[i][j], af[i], bfr[h][j][0], bfr[h][j][1]);"
_CONV = "const uint2 lo = int8_pairs(r[2 * p]), hi = int8_pairs(r[2 * p + 1]);"
_RAW = ("const uint2 lo = make_uint2(r[2 * p], r[2 * p] ^ 1u), "
        "hi = make_uint2(r[2 * p + 1], r[2 * p + 1] ^ 1u);")
VARIANTS = {   # name: [(text of qmatmul.cu, its replacement), ...]
    # ablations of the wide tile's K loop (wrong results)
    "noconv": [(_CONV, _RAW)],
    "nomma": [(_MMA, "(GROUPED ? part[i][j] : acc[i][j])[0] += __uint_as_float("
                     "af[i][0] ^ af[i][3] ^ bfr[h][j][0] ^ bfr[h][j][1]);")],
    "noloop": [("  const int nk = (k_end - k_beg + BK - 1) / BK;",
                "  const int nk = 0 * ((k_end - k_beg + BK - 1) / BK);")],
    "noreduce": [("  if (split) reduce_splits<BM, BN>(a.ws, out, a.tickets, a.M, a.N, m0, n0);", ""),
                 ("  if (split) reduce_splits<8, BN>(a.ws, out, a.tickets, a.M, a.N, 0, n0);", "")],
    # tuning choices (right results)
    "nosplit": [("  long long splits = std::min(target / tiles, max_splits);",
                 "  long long splits = 1;")],
    "stages3": [("static constexpr int BM = BM_, BN = 128, BK = 64, STAGES = 4;",
                 "static constexpr int BM = BM_, BN = 128, BK = 64, STAGES = 3;")],
    # grouped and crossbar scales always on 128-row tiles (one block an SM),
    # or on 64-row tiles with a K split for one block an SM, not two
    "grouped128": [("    p.bm = cdiv(M, 128) * cdiv(N, 128) >= sms ? 128 : 64;",
                    "    p.bm = grouped || cdiv(M, 128) * cdiv(N, 128) >= sms ? 128 : 64;")],
    "grouped64x1": [("    target = grouped && p.bm == 128 ? sms : 2LL * sms;",
                     "    target = grouped ? sms : 2LL * sms;")],
}


def main(names):
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_qmatmul: no CUDA device", file=sys.stderr)
        return 1
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.pim_mvm.kernel import pim_mvm_fwd, pim_mvm_plain
    from repro_torch.quant import kernel as Qk
    from repro_torch.quant.core import quantize, quantize_weights
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for M, K, N, bits, group, tile in SHAPES:
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        ws = [torch.randn((K, N), generator=g, device="cuda")
              for _ in range(cs.cold_copies(K * N * bits // 8))]
        if tile:
            planes = [quantize_weights(w) for w in ws]
            fwd, plain = (lambda x, q: pim_mvm_fwd(x, *q)), (lambda x, q: pim_mvm_plain(x, *q))
        else:
            planes = [(q.q, q.scale) for q in (quantize(w, bits, group=group) for w in ws)]
            kw = dict(bits=bits, group=group)
            fwd = (lambda kw: lambda x, q: Qk.quant_matmul_fwd(x, *q, **kw))(kw)
            plain = (lambda kw: lambda x, q: Qk.quant_matmul_plain(x, *q, **kw))(kw)
        cases.append(((M, K, N, bits, group, tile), x, planes, fwd, plain))

    def use(csrc, out):
        build.build.cache_clear()
        build.bind.cache_clear()
        Qk.plan.cache_clear()
        build.CSRC, build.BUILD_ROOT = csrc, out

    def timings(tag):
        for (M, K, N, bits, group, tile), x, planes, fwd, plain in cases:
            out, ref = fwd(x, planes[0]).float(), plain(x, planes[0]).float()
            err = float((out - ref).abs().max() / ref.abs().max())
            nxt = cs.cycler(planes)
            ms = cs.device_ms(lambda: fwd(x, nxt()), 50)
            p = Qk.plan(M, K, N, bits=bits, group_rows=128 if tile else (group or K), tile=tile,
                        dtype=x.dtype, sms=Qk._sms(x.device))
            print(f"{tag:9s} ({M}, {K}, {N}) int{bits} group={group} tile={int(tile)} "
                  f"bm={p.bm} bn={p.bn} splits={p.splits} ms={ms:.4f} "
                  f"TFLOP/s={2 * M * K * N / ms / 1e9:.1f} "
                  f"code_GB/s={K * N * bits / 8 / ms / 1e6:.0f} rel_err={err:.2e}")

    src, root = build.CSRC, build.BUILD_ROOT
    print(f"build {build.build().seconds:.1f} s")
    timings("as built")
    for name in names:
        d = ROOT / "build" / "qmatmul_probe" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in src.iterdir():
            shutil.copy(f, d / f.name)
        text = (d / "qmatmul.cu").read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: its text is no longer in qmatmul.cu")
            text = text.replace(old, new)
        (d / "qmatmul.cu").write_text(text)
        use(d, d / "out")
        build.build()
        timings(name)
    if names:
        use(src, root)
        timings("again")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
