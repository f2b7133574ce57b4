"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Brings up the port's continuous-batching engine with random weights and
drives a synthetic request workload, reporting throughput / TTFT /
latency (counterpart of ``repro.launch.serve``).  Runs on the CUDA card
unless ``--device cpu`` is given.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--kv-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="flash", choices=["flash", "ref"],
                    help="attention impl (flash = the CUDA kernels)")
    ap.add_argument("--decode-chunk", type=int, default=1,
                    help="decode iterations per host sync")
    ap.add_argument("--weight-bits", type=int, default=0, choices=[0, 4, 8],
                    help="weight-only quantisation (0 = native fp)")
    ap.add_argument("--weight-group", type=int, default=0,
                    help="rows of K per weight scale (0 = one per channel)")
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 4, 8],
                    help="quantised slot-pool KV cache (0 = fp pool)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch import resolve_device
    from repro_torch.config import get_config, reduce_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device, dtype=torch.bfloat16)
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=args.max_batch, kv_len=args.kv_len,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        seed=args.seed, impl=args.impl, decode_chunk=args.decode_chunk,
        weight_bits=args.weight_bits, weight_group=args.weight_group,
        kv_bits=args.kv_bits), device=device)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, min(64, args.kv_len - args.max_new_tokens - 1)))
        engine.submit(rng.integers(0, cfg.vocab_size, size=plen))

    engine.run_until_drained()
    stats = engine.stats()
    bits = (f"w{args.weight_bits or 'fp'}/kv{args.kv_bits or 'fp'} "
            if (args.weight_bits or args.kv_bits) else "")
    print(f"arch={cfg.name} device={device} {bits}requests={stats['finished']} "
          f"tokens={stats['tokens']} "
          f"throughput={stats['tokens_per_s']:.1f} tok/s "
          f"ttft={stats['mean_ttft_s']*1e3:.0f}ms "
          f"latency={stats['mean_latency_s']*1e3:.0f}ms")
    return stats


if __name__ == "__main__":
    main()
