"""End-to-end serving example on the PyTorch port (the counterpart of
``examples/serve_e2e.py``): bring up the continuous-batching engine on a
reduced assigned architecture and push a batched request workload through
it, reporting throughput/TTFT/latency — then cross-check one greedy
completion against teacher forcing.

Run:  PYTHONPATH=src python examples/serve_e2e_torch.py [--arch gemma2-9b] [--device cpu]
(on the first CUDA card by default; without one it raises unless
``--device cpu`` is given)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import get_config, reduce_config
from repro_torch.models import transformer as T
from repro_torch.serving.engine import EngineConfig, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--kv-len", type=int, default=96)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = reduce_config(get_config(args.arch))
    if cfg.family == "encoder":
        raise SystemExit("encoder-only archs have no decode step")
    print(f"arch={cfg.name} (reduced: {cfg.param_count()/1e6:.1f}M params), "
          f"slots={args.max_batch} kv_len={args.kv_len}")

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                           device=dev, dtype=torch.float32)
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=args.max_batch, kv_len=args.kv_len,
        max_new_tokens=args.max_new_tokens, impl="ref"), device=dev)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.integers(4, 32))
        engine.submit(rng.integers(0, cfg.vocab_size, size=plen))
    engine.run_until_drained()
    s = engine.stats()
    print(f"drained {s['finished']} requests / {s['tokens']} tokens in "
          f"{time.time()-t0:.1f}s -> {s['tokens_per_s']:.1f} tok/s, "
          f"TTFT {s['mean_ttft_s']*1e3:.0f} ms, "
          f"latency {s['mean_latency_s']*1e3:.0f} ms")

    # consistency check: engine greedy == teacher-forced argmax chain
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    engine2 = ServingEngine(cfg, params, EngineConfig(
        max_batch=1, kv_len=args.kv_len, max_new_tokens=6, impl="ref"), device=dev)
    engine2.submit(prompt)
    engine2.run_until_drained()
    got = engine2.finished[0].output
    toks = list(prompt)
    want = []
    with torch.no_grad():
        for _ in range(6):
            logits, _ = T.prefill(params, cfg, torch.tensor([toks], dtype=torch.int32,
                                                            device=dev),
                                  impl="ref", kv_cap=args.kv_len)
            want.append(int(torch.argmax(logits[0])))
            toks.append(want[-1])
    status = "MATCH" if got == want else f"MISMATCH ({got} vs {want})"
    print(f"incremental-vs-teacher-forced greedy decode: {status}")


if __name__ == "__main__":
    main()
