#!/usr/bin/env python3
"""Where the time of the MoE expert path's kernels (``grouped_matmul.cu``)
goes, on one NVIDIA card.

    python3 chip_probe_grouped.py                   # the source as built
    python3 chip_probe_grouped.py mma 2b ...        # and named variants

For the source as built, then for each variant named (``grouped_matmul.cu``
rebuilt with one edit, alone, in ``build/grouped_probe/<variant>``,
git-ignored), in a process of its own so that a variant that faults stops
only itself: the ptxas report of its kernels; each kernel against its
plain version at qwen3-moe-30b-a3b's shapes (the product at gate/up's (K,
N), the scaled product at down's, the fused gate/up with silu, at T 64
decode rows and 3072 prefill-384 rows, every row to one expert, T 1; the
combine of 8 and 384 tokens, k 8); then each one's device time per call
(``chip_smoke.device_ms``), cycling over copies that span twice the L2.
Calls later in one process run faster (clocks, caches), so the source as
built is timed again at the end ("again") when variants were named.  Not
part of the port's checks: ``chip_smoke.py`` is.
"""
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
_ROWS = r"constexpr int kWgmmaRows = \d+;"
_BLOCKS = r"constexpr int kBlocksPerSM = \d+;"
# clock64 stamps of block 0 (read back by repro_grouped_trace): [0] the
# producer issues a stage's TMA, [1] consumer thread 0 finds it full
_TRACE = [
    (re.escape("namespace {\n"), "namespace {\n__device__ long long g_trace[4][1024];\n"),
    (re.escape("      int stage = 0;\n"), "      int stage = 0, tq = 0;\n"),
    (re.escape("          mbar_expect_tx(&full[stage], S::kStageBytes);"),
     "          if (blockIdx.x == 0 && tq < 1024) g_trace[0][tq] = clock64();\n"
     "          ++tq;\n"
     "          mbar_expect_tx(&full[stage], S::kStageBytes);"),
    (re.escape("      mbar_wait(&full[stage], phase);\n"),
     "      mbar_wait(&full[stage], phase);\n"
     "      if (tid == 0 && blockIdx.x == 0 && q < 1024) g_trace[1][q] = clock64();\n"),
    (r"\Z", "\nextern \"C\" int repro_grouped_trace(void* host) {\n"
            "  return cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));\n}\n"),
]
VARIANTS = {   # name: [(pattern in grouped_matmul.cu, its replacement), ...]
    # the consumers' instruction: wgmma for every pass, or for none (mma.sync)
    # (as built: wgmma for passes of more than 16 rows; a decode pass holds 1-16)
    "wgmma0": [(_ROWS, "constexpr int kWgmmaRows = 0;")],
    "mma": [(_ROWS, "constexpr int kWgmmaRows = 64;")],
    # blocks an SM (one block's TMA boxes land one after another)
    "1b": [(_BLOCKS, "constexpr int kBlocksPerSM = 1;")],
    "2b": [(_BLOCKS, "constexpr int kBlocksPerSM = 2;")],
    "4b": [(_BLOCKS, "constexpr int kBlocksPerSM = 4;"),
           (re.escape("constexpr int kXStages = 3;"), "constexpr int kXStages = 2;")],
    # the consumers' x ring
    "xstages4": [(re.escape("constexpr int kXStages = 3;"), "constexpr int kXStages = 4;")],
    # no L2 promotion of the weight boxes
    "nopromo": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    # timing ablations (wrong results): boxes of 256 columns (512-byte rows,
    # no swizzle), with the block's 1 or 2; no products computed
    "wide256": [(r"constexpr int kBM = 64, kBN = 64, kBK = 64;",
                 "constexpr int kBM = 64, kBN = 256, kBK = 64;"),
                ("CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_NONE")],
    "nocompute": [(re.escape("if (mt < n_mt) {"), "if (mt < n_mt && kt < 0) {")],
    # block 0's stage timeline (clock64)
    "trace": _TRACE,
}
ROWS = {"decode": 64, "prefill384": 3072}


def one(name):
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.grouped_matmul import kernel as G

    src = build.CSRC
    d = ROOT / "build" / "grouped_probe" / name.replace(" ", "_")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in ("grouped_matmul.cu", "common.cuh"):
        shutil.copy(src / f, d / f)
    text = (d / "grouped_matmul.cu").read_text()
    for old, new in VARIANTS.get(name, []):
        if not re.search(old, text):
            raise SystemExit(f"variant {name}: {old!r} is no longer in grouped_matmul.cu")
        text = re.sub(old, new, text)
    (d / "grouped_matmul.cu").write_text(text)
    build.CSRC, build.BUILD_ROOT = d, d / "out"
    b = build.build()
    print(f"[{name}] build {b.seconds:.1f} s")
    for ln in b.log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"[{name}] ptxas {ln.strip()[:160]}")

    g = torch.Generator(device=cs.DEVICE).manual_seed(21)
    rng = np.random.default_rng(21)
    bf16 = torch.bfloat16
    E, k = cs.MOE_EXPERTS, cs.MOE_TOP_K
    (Kg, Ng), (Kd, Nd) = cs.MOE_GMM_SHAPES["gate/up"], cs.MOE_GMM_SHAPES["down"]

    def check(what, out, ref):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = max(ref.float().abs().max().item(), 1e-30)
        ok = err <= cs.MATMUL_TOL["torch.bfloat16"] * scale
        print(f"[{name}] check {what} max_abs_err={err:.3e} rel_to_max={err / scale:.3e} "
              f"bits_equal={torch.equal(out, ref)} {'ok' if ok else 'FAILED'}")

    def timed(what, fn, copies):
        nxt = cs.cycler(copies)
        ms = cs.device_ms(lambda: fn(nxt()), 50)
        print(f"[{name}] time {what} ms={ms:.4f}")

    for phase, T in ROWS.items():
        tokens = T // k
        order, off, sizes = cs.routing(torch, rng, tokens)
        selected = int((sizes > 0).sum())
        x = torch.randn((tokens, Kg), generator=g, device=cs.DEVICE).to(bf16)
        rows = order // k
        xs = x[rows]
        n = cs.cold_copies(2 * selected * Kg * Ng * 2)
        wg = [(torch.randn((E, Kg, Ng), generator=g, device=cs.DEVICE) / Kg ** 0.5).to(bf16)
              for _ in range(n)]
        wu = [(torch.randn((E, Kg, Ng), generator=g, device=cs.DEVICE) / Kg ** 0.5).to(bf16)
              for _ in range(n)]
        wd = [(torch.randn((E, Kd, Nd), generator=g, device=cs.DEVICE) / Kd ** 0.5).to(bf16)
              for _ in range(n)]
        h = torch.randn((T, Kd), generator=g, device=cs.DEVICE).to(bf16)
        gates = torch.rand((T,), generator=g, device=cs.DEVICE).to(bf16)
        check(f"product {phase} ({T}, {Kg}, {Ng}) design={G.plan(xs, wg[0], xs).design}",
              G.grouped_matmul_fwd(xs, wg[0], off), G.grouped_matmul_plain(xs, wg[0], off))
        check(f"scaled {phase} ({T}, {Kd}, {Nd})", G.grouped_matmul_fwd(h, wd[0], off, gates),
              G.grouped_matmul_plain(h, wd[0], off, gates))
        check(f"gate_up {phase} ({T}, {Kg}, {Ng})",
              G.grouped_gate_up_fwd(x, rows, wg[0], wu[0], off, "silu"),
              G.grouped_gate_up_plain(x, rows, wg[0], wu[0], off, "silu"))
        ys = torch.randn((T, Nd), generator=g, device=cs.DEVICE).to(bf16)
        check(f"combine {phase} tokens={tokens} k={k}", G.combine_fwd(ys, order, k),
              G.combine_plain(ys, order, k))
        timed(f"product {phase} ({T}, {Kg}, {Ng}) selected={selected}",
              lambda w: G.grouped_matmul_fwd(xs, w, off), wg)
        timed(f"scaled {phase} ({T}, {Kd}, {Nd})",
              lambda w: G.grouped_matmul_fwd(h, w, off, gates), wd)
        pairs = list(zip(wg, wu))
        timed(f"gate_up {phase} ({T}, {Kg}, {Ng})",
              lambda p: G.grouped_gate_up_fwd(x, rows, p[0], p[1], off, "silu"), pairs)
        yss = [torch.randn((T, Nd), generator=g, device=cs.DEVICE).to(bf16)
               for _ in range(cs.cold_copies(T * Nd * 2))]
        timed(f"combine {phase} tokens={tokens}", lambda y: G.combine_fwd(y, order, k), yss)
        del wg, wu, wd, pairs, yss
    for what, sizes in (("every row to one expert", [0] * 40 + [3072] + [0] * 87),
                        ("T1", [0, 1] + [0] * 126)):
        sizes = np.asarray(sizes)
        off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)).to(cs.DEVICE)
        T = int(sizes.sum())
        x = torch.randn((T, Kg), generator=g, device=cs.DEVICE).to(bf16)
        rows = torch.randperm(T, generator=g, device=cs.DEVICE)
        w0 = (torch.randn((E, Kg, Ng), generator=g, device=cs.DEVICE) / Kg ** 0.5).to(bf16)
        w1 = (torch.randn((E, Kg, Ng), generator=g, device=cs.DEVICE) / Kg ** 0.5).to(bf16)
        check(f"gate_up {what}", G.grouped_gate_up_fwd(x, rows, w0, w1, off, "silu"),
              G.grouped_gate_up_plain(x, rows, w0, w1, off, "silu"))
        check(f"product {what}", G.grouped_matmul_fwd(x, w0, off),
              G.grouped_matmul_plain(x, w0, off))
    if name.startswith("trace"):
        trace(name, G, g, rng)
    return 0


def trace(name, G, g, rng):
    """Block 0's stage timeline of one decode product launch."""
    import ctypes

    import torch
    from repro_torch.kernels import build
    E, k = cs.MOE_EXPERTS, cs.MOE_TOP_K
    Kg, Ng = cs.MOE_GMM_SHAPES["gate/up"]
    order, off, sizes = cs.routing(torch, rng, ROWS["decode"] // k)
    xs = torch.randn((ROWS["decode"], Kg), generator=g, device=cs.DEVICE).to(torch.bfloat16)
    w = (torch.randn((E, Kg, Ng), generator=g, device=cs.DEVICE) / Kg ** 0.5).to(torch.bfloat16)
    G.grouped_matmul_fwd(xs, w, off)
    torch.cuda.synchronize()
    buf = np.zeros((4, 1024), np.int64)
    err = build.bind("grouped_matmul", "repro_grouped_trace", (ctypes.c_void_p,))(
        buf.ctypes.data)
    issue, full = buf[0], buf[1]
    n = min(int((issue > 0).sum()), int((full > 0).sum()), 1024)
    t0 = issue[0]
    print(f"[{name}] trace err={err} stages={n}")
    for q in list(range(min(n, 16))) + list(range(max(16, n - 4), n)):
        print(f"[{name}] trace q={q} issue={issue[q] - t0} full={full[q] - t0} "
              f"latency={full[q] - issue[q]}")
    print(f"[{name}] trace cycles: mean issue-to-issue={np.diff(issue[:n]).mean():.0f} "
          f"mean full-to-full={np.diff(full[:n]).mean():.0f} "
          f"mean issue-to-full={np.mean(full[:n] - issue[:n]):.0f} total={full[n - 1] - t0}")


def main(names):
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_grouped: no CUDA device", file=sys.stderr)
        return 1
    if names[:1] == ["--one"]:
        return one(names[1])
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    failed = []
    for name in ["as built", *names, *(["again"] if names else [])]:
        r = subprocess.run([sys.executable, __file__, "--one", name], capture_output=True,
                           text=True, timeout=600)
        print(r.stdout, end="")
        if r.returncode:
            failed.append(name)
            print(f"[{name}] exit {r.returncode}: {r.stderr[-2000:]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
