"""Fault-tolerant training loop (counterpart of the reference's
``training/trainer.py``).

- **Checkpoint/restart**: periodic atomic saves, a save on preemption
  (SIGTERM), and resume from ``LATEST`` on construction.
- **Step retry**: a step that raises before its update (an executor
  fault; tests inject them through ``fault_hook``) is retried with
  exponential backoff from the last good state, which it has not
  touched: the gradients are taken and the metrics read before anything
  is written.  The in-place AdamW update that follows is the commit.  A
  fault inside it (:class:`CommitError`) leaves the state part-written,
  so it is not retried: the trainer restores the last checkpoint and
  raises.
- **Straggler watchdog**: an EMA of the step's wall time; steps slower than
  ``slow_step_factor`` times the EMA are counted and reported.

The state is f32 master parameters (a tree of tensors that take
gradients), f32 moments and an int32 count, updated in place so that one
copy of it fits the card.  With a mesh (a ``torch.distributed``
``DeviceMesh``, axes ``("data", "model")``, every rank running the same
trainer) the step runs under the reference's train plan, the parameters
and both moments are sharded alike at its specs (ZeRO) and the batch over
``data``; a checkpoint holds whole tensors (written by the mesh's first
rank), so it restores on any mesh, and :meth:`Trainer.remesh` moves the
live state onto another mesh (**elastic re-mesh**: a sub-mesh after
losing ranks, whose left-out ranks then hold nothing and step no more).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, DataState, LMDataPipeline
from repro_torch.launch.steps import CommitError, make_train_step
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.api import full, is_dtensor
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.optimizer import OptConfig, adamw_init


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = ""
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 3
    retry_backoff_s: float = 0.2
    slow_step_factor: float = 3.0
    ema_alpha: float = 0.2
    accum: int = 1
    remat: bool = False


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, mesh=None, *,
                 opt_cfg: OptConfig = OptConfig(),
                 tcfg: TrainerConfig = TrainerConfig(),
                 data_cfg: Optional[DataConfig] = None,
                 seed: int = 0, device=None):
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                                f"{type(mesh).__name__}")
            if device is None:
                device = "cpu" if mesh.device_type == "cpu" else torch.device(
                    "cuda", torch.cuda.current_device())
        self.device = resolve_device(device)
        self.cfg, self.shape, self.tcfg, self.opt_cfg = cfg, shape, tcfg, opt_cfg
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
            global_batch=shape.global_batch, seed=seed)
        self.pipeline = LMDataPipeline(self.data_cfg)
        self.step = 0
        self.metrics_log: list[dict] = []
        self.slow_steps = 0
        self._ema_dt: Optional[float] = None
        self.preemption = CKPT.PreemptionHandler()
        self._build(mesh)
        self._init_or_restore(seed)

    # -- construction -------------------------------------------------------
    def _build(self, mesh):
        """The step for ``mesh`` (None: one device): the train plan and the
        specs of the parameters, the moments (alike) and the batch."""
        self.mesh = mesh
        self._pspecs = T.param_tree(T.init_params(self.cfg, None, device="meta",
                                                  dtype=torch.float32))
        self._ospecs = adamw_init(self._pspecs)
        plan = None
        if mesh is not None:
            plan, self.ctx = SH.build_plan(self.cfg, self.shape, mesh, mode="train")
            self.pshard = SH.params_shardings(self._pspecs, self.ctx)
        self.jstep = make_train_step(self.cfg, plan, opt_cfg=self.opt_cfg,
                                     accum=self.tcfg.accum, remat=self.tcfg.remat)

    def _place(self, params, opt_state):
        """Whole state (the same on every rank; a checkpoint's, or gathered
        for a re-mesh) onto the mesh: parameters and moments at the
        parameters' specs; as it is without a mesh."""
        if self.mesh is None:
            return params, opt_state
        put = lambda tree: SH.distribute_tree(tree, self.pshard, self.mesh)   # noqa: E731
        return put(params), {"m": put(opt_state["m"]), "v": put(opt_state["v"]),
                             "count": opt_state["count"]}

    def in_mesh(self) -> bool:
        """Whether this rank holds part of the state (always without a
        mesh; a rank left out of a sub-mesh holds nothing)."""
        return self.mesh is None or self.mesh.get_coordinate() is not None

    def _restore(self) -> bool:
        """The state of the checkpoint ``LATEST`` names, if there is one."""
        t = self.tcfg
        if not (t.ckpt_dir and CKPT.latest_step(t.ckpt_dir) is not None):
            return False
        params, opt, meta = CKPT.restore_checkpoint(
            t.ckpt_dir, params_template=self._pspecs, opt_template=self._ospecs,
            device=self.device)
        self.params, self.opt_state = self._place(T.trainable(params), opt)
        self.step = int(meta["step"])
        ds = meta.get("data_state") or {}
        if ds:
            self.pipeline.state = DataState.from_dict(ds)
        self.pipeline.at_step(self.step)
        return True

    def _init_or_restore(self, seed):
        if self._restore():
            return
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = T.trainable(T.init_params(self.cfg, gen, device=self.device,
                                           dtype=torch.float32))
        if self.mesh is not None:
            params = SH.distribute_tree(params, self.pshard, self.mesh)
        self.params = params
        self.opt_state = adamw_init(params)     # zeros placed as the parameters

    # -- one step with retry + watchdog --------------------------------------
    def train_step(self, batch: dict[str, np.ndarray],
                   fault_hook: Optional[Callable[[int], None]] = None) -> dict:
        if self.params is None:
            raise RuntimeError("the trainer's state was lost in a failed update and no "
                               "checkpoint holds it")
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}
        if self.mesh is not None:
            batch = SH.distribute_tree(batch, SH.batch_shardings(batch, self.ctx), self.mesh)
        last_err: Optional[Exception] = None
        for attempt in range(self.tcfg.max_retries + 1):
            try:
                if fault_hook is not None:
                    fault_hook(attempt)  # the test harness injects failures here
                t0 = time.time()
                self.params, self.opt_state, metrics = self.jstep(self.params, self.opt_state,
                                                                  batch)
                dt = time.time() - t0
                self._watchdog(dt)
                metrics.update(step=self.step, dt=dt, retries=attempt,
                               slow_steps=self.slow_steps)
                self.step += 1
                self.pipeline.at_step(self.step)
                self.metrics_log.append(metrics)
                return metrics
            except CommitError as e:
                # part of the state holds this step: no retry from it
                failed, self.params, self.opt_state = self.step, None, None
                if self._restore():
                    raise RuntimeError(f"step {failed} failed inside its update; the "
                                       f"checkpoint of step {self.step} is restored") from e
                raise RuntimeError(f"step {failed} failed inside its update, and no "
                                   f"checkpoint holds the state") from e
            except (RuntimeError, ValueError, OSError) as e:  # executor fault
                last_err = e
                time.sleep(self.tcfg.retry_backoff_s * (2 ** attempt))
        raise RuntimeError(
            f"step {self.step} failed after {self.tcfg.max_retries + 1} "
            f"attempts") from last_err

    def _watchdog(self, dt: float):
        if self._ema_dt is None:
            self._ema_dt = dt
            return
        if dt > self.tcfg.slow_step_factor * self._ema_dt:
            self.slow_steps += 1
        a = self.tcfg.ema_alpha
        self._ema_dt = (1 - a) * self._ema_dt + a * dt

    # -- loop ----------------------------------------------------------------
    def run(self, n_steps: int) -> list[dict]:
        out = []
        for _ in range(n_steps):
            batch = self.pipeline.global_batch_at(self.step)
            m = self.train_step(batch)
            out.append(m)
            t = self.tcfg
            if t.ckpt_dir and (
                    self.preemption.should_save
                    or (t.ckpt_every and self.step % t.ckpt_every == 0)):
                self.save()
                if self.preemption.should_save:
                    self.preemption.reset()
                    break
        return out

    def save(self) -> Optional[str]:
        """A checkpoint of whole tensors (gathered on a mesh, where the
        mesh's first rank writes and every rank returns its path)."""
        if not self.tcfg.ckpt_dir:
            return None
        params, opt = SH.gather_tree(self.params), SH.gather_tree(self.opt_state)
        if self.mesh is not None and self.mesh.get_rank() != int(self.mesh.mesh.flatten()[0]):
            return CKPT.checkpoint_path(self.tcfg.ckpt_dir, self.step)
        return CKPT.save_checkpoint(
            self.tcfg.ckpt_dir, self.step, params=params, opt_state=opt,
            data_state=self.pipeline.state.to_dict(), keep=self.tcfg.keep)

    # -- elastic -------------------------------------------------------------
    def remesh(self, new_mesh):
        """Re-shard live state onto a new mesh (elastic scale up or down
        after losing or gaining ranks): the state gathered whole on the old
        mesh (every rank of it takes part), the step rebuilt for the new
        one, and each rank of the new mesh keeps its slices."""
        params, opt = SH.gather_tree(self.params), SH.gather_tree(self.opt_state)
        if is_dtensor(opt["count"]):
            opt["count"] = full(opt["count"])
        self._build(new_mesh)
        self.params, self.opt_state = self._place(params, opt)
