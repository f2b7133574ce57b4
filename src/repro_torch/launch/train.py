"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(counterpart of ``repro.launch.train``).

Trains a model with random initial weights on the synthetic token stream
of ``data/pipeline.py`` through :class:`~repro_torch.training.trainer.Trainer`,
printing the loss every 10 steps.  Runs on the CUDA card unless ``--device
cpu`` is given.  The fault-tolerance knobs (checkpoint dir and interval)
map onto ``TrainerConfig``.  ``--reduced`` shrinks the config for a smoke
run, and the shape with it (at most 32 tokens a row, the reduced position
table's reach, and 8 rows) unless ``--seq-len`` / ``--global-batch`` say
otherwise.

Sharded: one process a rank under ``torchrun``, with ``--data-axis`` and
``--model-axis`` the mesh's axes (``launch/mesh.py``'s ``launch_mesh``;
the ranks ``--model-axis`` leaves go to ``data``), e.g. ``torchrun
--nproc-per-node 4 -m repro_torch.launch.train --arch qwen2.5-3b --reduced
--device cpu --data-axis 2 --model-axis 2``.  Without ``torchrun`` the
trainer runs on one device; ``--devices`` more than the ranks started is
refused.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config (and the shape) for smoke runs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to train on (0: those torchrun started, else one)")
    ap.add_argument("--data-axis", type=int, default=0,
                    help="data-axis size (0: the ranks the model axis leaves)")
    ap.add_argument("--model-axis", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import os
    world = int(os.environ.get("WORLD_SIZE", "1"))
    for flag, n in (("devices", args.devices),
                    ("data-axis x model-axis", max(args.data_axis, 1) * max(args.model_axis, 1))):
        if n > world:
            ap.error(f"--{flag} asks for {n} ranks, {world} started: launch one process "
                     f"a rank with torchrun")

    import torch
    from repro_torch import resolve_device
    from repro_torch.config import SHAPES, ShapeSpec, get_config, reduce_config
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = reduce_config(cfg)
        shape = ShapeSpec(shape.name, shape.kind, min(shape.seq_len, 32),
                          min(shape.global_batch, 8))
    if args.global_batch or args.seq_len:
        shape = ShapeSpec(shape.name, shape.kind, args.seq_len or shape.seq_len,
                          args.global_batch or shape.global_batch)
    device = resolve_device(args.device)
    from repro_torch.launch.mesh import launch_mesh
    mesh = launch_mesh(args.data_axis, args.model_axis, device_type=device.type)
    n_params = sum(p.numel() for p in
                   T.init_params(cfg, None, device="meta", dtype=torch.float32).parameters())
    lead = mesh is None or mesh.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device} "
        f"mesh={None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"batch={shape.global_batch} seq={shape.seq_len}")

    trainer = Trainer(
        cfg, shape, mesh, opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps),
        tcfg=TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                           accum=args.accum, remat=args.remat),
        seed=args.seed, device=device)
    start = trainer.step
    for m in trainer.run(args.steps - start):
        if m["step"] % 10 == 0 or m["step"] == start:
            say(f"step {m['step']:5d} loss={m['loss']:.4f} "
                f"gnorm={m['gnorm']:.3f} lr={m['lr']:.2e} "
                f"dt={m['dt'] * 1e3:.0f}ms", flush=True)
    if args.ckpt_dir:
        trainer.save()
    say(f"done: {trainer.step} steps, {trainer.slow_steps} slow steps")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
