"""Quickstart on the PyTorch port: the three layers of the framework in
~80 lines (the counterpart of ``examples/quickstart.py``).

  1. Plane B — design a chiplet NoI for a transformer workload and compare
     2.5D-HI against the HAIMA/TransPIM baselines (the paper's headline;
     numpy only, the reference's numbers).
  2. Plane A — instantiate one of the assigned architectures (reduced) and
     run a forward + a train step.
  3. Kernels — on a card, the CUDA prefill-attention and PIM-MVM
     (``qmatmul.cu``'s crossbar route) kernels against their plain
     PyTorch versions; on the CPU, where no kernel runs, the plain
     versions against the oracles.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(on the first CUDA card by default; without one it raises unless
``--device cpu`` is given)
"""
import argparse

import torch

# ── 1. the paper's architecture plane ──────────────────────────────────────
from repro_torch.config import get_config, reduce_config
from repro_torch.core.simulator import simulate_2p5d_hi
from repro_torch.core.baselines import simulate_haima_chiplet, simulate_transpim_chiplet
from repro_torch.core.traffic import Workload

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

from repro_torch import resolve_device

dev = resolve_device(args.device)

w = Workload.from_config(get_config("bert-base"), seq_len=64)
hi = simulate_2p5d_hi(w, 36)
ha = simulate_haima_chiplet(w, 36)
tp = simulate_transpim_chiplet(w, 36)
print(f"[plane B] BERT-Base n=64 on 36 chiplets:")
print(f"  2.5D-HI         {hi.latency_s*1e3:7.1f} ms  {hi.energy_j:6.2f} J")
print(f"  HAIMA_chiplet   {ha.latency_s*1e3:7.1f} ms  ({ha.latency_s/hi.latency_s:.1f}x slower)")
print(f"  TransPIM_chiplet{tp.latency_s*1e3:7.1f} ms  ({tp.latency_s/hi.latency_s:.1f}x slower)")

# ── 2. the workload plane: a real (reduced) assigned architecture ──────────
from repro_torch.models import transformer as T
from repro_torch.launch.steps import make_train_step
from repro_torch.training.optimizer import adamw_init

cfg = reduce_config(get_config("gemma2-9b"))
gen = torch.Generator(device=dev).manual_seed(0)
params = T.trainable(T.init_params(cfg, gen, device=dev, dtype=torch.float32))
batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=gen, device=dev,
                                 dtype=torch.int32)}
with torch.no_grad():
    loss, _ = T.loss_fn(params, cfg, batch)
print(f"\n[plane A] reduced gemma2-9b ({cfg.param_count()/1e6:.1f}M params) "
      f"forward loss = {float(loss):.3f}")

step = make_train_step(cfg)
params2, opt, metrics = step(params, adamw_init(params), batch)
print(f"[plane A] one train step: loss={metrics['loss']:.3f} "
      f"gnorm={metrics['gnorm']:.3f}")

# ── 3. the kernels (the CUDA sources on a card; plain versions on the CPU) ──
from repro_torch.kernels.flash_attention.kernel import flash_attention_plain
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.pim_mvm.kernel import pim_mvm_plain
from repro_torch.kernels.pim_mvm.ops import pim_mvm, quantize_weights

card = dev.type == "cuda"
q = torch.randn((1, 128, 4, 64), generator=gen, device=dev)
k = torch.randn((1, 128, 2, 64), generator=gen, device=dev)
v = torch.randn((1, 128, 2, 64), generator=gen, device=dev)
want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2) if card else attention_ref(q, k, v)
err = float((attention(q, k, v, impl="flash") - want).abs().max())
print(f"\n[kernels] flash attention (GQA, causal) max err vs "
      f"{'plain version' if card else 'oracle'}: {err:.2e}")

x = torch.randn((128, 256), generator=gen, device=dev)
wfp = torch.randn((256, 128), generator=gen, device=dev)
wq, scales = quantize_weights(wfp)
out = pim_mvm(x, wq, scales, impl="flash")
if card:
    rel = float((out - pim_mvm_plain(x, wq, scales)).abs().max()
                / pim_mvm_plain(x, wq, scales).abs().max())
    print(f"[kernels] PIM-MVM int8-crossbar kernel rel err vs plain version: {rel:.3%}")
rel = float((out - x @ wfp).abs().max() / (x @ wfp).abs().max())
print(f"[kernels] PIM-MVM int8-crossbar quantised matmul rel err: {rel:.3%}")
