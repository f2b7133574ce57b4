#!/usr/bin/env python3
"""How far a zeroed source moves the prefill logits of the cross-attention
stacks, beside the flash-vs-ref gap and bound, on one NVIDIA card.

    python3 chip_probe_cross_source.py

For whisper-large-v3 (full depth) and llama-3.2-vision-90b (``chip_smoke``'s
30 of 100 layers), with random bf16 weights (seed 0) and ``chip_smoke``'s
batch, prompt and source draw: the prefill logits with ``impl="flash"`` and
``impl="ref"``, each with the source and with it zeroed, for each scale of
the source (whisper's frames, the vision stack's patches) and, for the
vision stack, each setting of its gates.  Prints per setting the logits'
scale, the bound (5e-2 of it), flash vs ref, and the largest move a zeroed
source makes under either ``impl``.  A source that moves the logits less
than the bound cannot be told from an absent one by phase ``cross``'s
flash-vs-ref check.  Not part of the port's checks: ``chip_smoke.py`` is.
"""
import subprocess
import sys

import chip_smoke as cs

SCALES = {"whisper-large-v3": (0.02, 1.0), "llama-3.2-vision-90b": (0.02, 1.0, 4.0)}
# (gate_attn, gate_mlp) of the vision stack's gated layers
GATES = ((0.5, 1.0), (1.0, 1.0), (3.0, 3.0))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_cross_source: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, cs.SRC)
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"build {build.build().seconds:.1f} s", flush=True)
    for arch, scales in SCALES.items():
        cfg = cs.cross_config(arch)
        params = cs.make_params(torch, cfg)
        m = cs.CROSS_MODELS[arch]
        g = torch.Generator(device=cs.DEVICE).manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (cs.CROSS_BATCH, m["prompt"]), generator=g,
                             device=cs.DEVICE, dtype=torch.int32)
        drawn = cs.cross_source(torch, cfg, g)
        key, = drawn
        unit = drawn[key] / cs.CROSS_SOURCE_STD[cfg.family]
        for gates in (GATES if cfg.family == "vlm" else (None,)):
            with torch.no_grad():
                if gates:
                    for spec in params["stack"]:
                        for u in spec.values():
                            if "gate_attn" in u:
                                u["gate_attn"].fill_(gates[0])
                                u["gate_mlp"].fill_(gates[1])
                for scale in scales:
                    out = {}
                    for impl in ("flash", "ref"):
                        for name, src in (("src", unit * scale), ("zero", torch.zeros_like(unit))):
                            out[impl, name] = T.prefill(params, cfg, toks, impl=impl,
                                                        kv_cap=m["kv_len"],
                                                        **{key: src})[0].float()

                    def gap(a, b):
                        return float((out[a] - out[b]).abs().max())
                    ref_scale = float(out["ref", "src"].abs().max())
                    print(f"{arch} gates={gates} source_std={scale} ref_scale={ref_scale:.4f} "
                          f"bound={5e-2 * max(1.0, ref_scale):.4f} "
                          f"flash_vs_ref={gap(('flash', 'src'), ('ref', 'src')):.4f} "
                          f"zeroed_moves_flash={gap(('flash', 'src'), ('flash', 'zero')):.4f} "
                          f"zeroed_moves_ref={gap(('ref', 'src'), ('ref', 'zero')):.4f}",
                          flush=True)
        del params
        cs.collect(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
