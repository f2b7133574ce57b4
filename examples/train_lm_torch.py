"""End-to-end training example on the PyTorch port (the counterpart of
``examples/train_lm.py``): train a ~100M-param LM for a few hundred steps
with the full production stack — sharded data pipeline, AdamW,
checkpointing (resume works mid-run), preemption handling, and the
straggler watchdog — on a one-rank mesh.  Loss must visibly descend on the
structured synthetic corpus.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
      (~100M params; use --tiny for a fast smoke run; on the first CUDA
      card by default, without one it raises unless ``--device cpu`` is
      given)
"""
import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.config import ShapeSpec, get_config, reduce_config
from repro_torch.launch.mesh import launch_mesh
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (fast CPU smoke)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    if args.tiny:
        cfg = reduce_config(get_config("qwen2.5-3b"))
    else:
        # mamba2-130m: the one assigned architecture that genuinely is
        # ~100M params — train it for real
        cfg = get_config("mamba2-130m")
    shape = ShapeSpec("train_lm", "train", args.seq, args.batch)
    # the reference's small_mesh(1, 1): a one-rank group and its mesh
    mesh = launch_mesh(1, 1, device_type=dev.type)

    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"batch={args.batch} seq={args.seq} steps={args.steps}")

    try:
        trainer = Trainer(
            cfg, shape, mesh,
            opt_cfg=OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
            tcfg=TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50),
        )
        if trainer.step:
            print(f"resumed from checkpoint at step {trainer.step}")

        first = None
        for m in trainer.run(args.steps - trainer.step):
            if first is None:
                first = m["loss"]
            if m["step"] % 10 == 0:
                print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
                      f"gnorm {m['gnorm']:.2f}  lr {m['lr']:.2e}  "
                      f"{m['dt']*1e3:6.0f} ms/step", flush=True)
        trainer.save()
        last = trainer.metrics_log[-1]["loss"]
        print(f"done: loss {first:.4f} -> {last:.4f} "
              f"({trainer.slow_steps} slow steps, checkpoint at {args.ckpt_dir})")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
