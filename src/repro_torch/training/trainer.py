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

The state lives on one device: f32 master parameters (a tree of tensors
that take gradients), f32 moments and an int32 count, updated in place so
that one copy of it fits the card.  Sharding waits for the port's sharded
plane: ``mesh`` must be None and :meth:`Trainer.remesh` raises.
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
            raise NotImplementedError("sharded training (mesh=) has no port yet: "
                                      "the trainer runs on one device")
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
        self._build()
        self._init_or_restore(seed)

    # -- construction -------------------------------------------------------
    def _build(self):
        self._pspecs = T.param_tree(T.init_params(self.cfg, None, device="meta",
                                                  dtype=torch.float32))
        self._ospecs = adamw_init(self._pspecs)
        self.jstep = make_train_step(self.cfg, opt_cfg=self.opt_cfg, accum=self.tcfg.accum,
                                     remat=self.tcfg.remat)

    def _restore(self) -> bool:
        """The state of the checkpoint ``LATEST`` names, if there is one."""
        t = self.tcfg
        if not (t.ckpt_dir and CKPT.latest_step(t.ckpt_dir) is not None):
            return False
        params, opt, meta = CKPT.restore_checkpoint(
            t.ckpt_dir, params_template=self._pspecs, opt_template=self._ospecs,
            device=self.device)
        self.params = T.trainable(params)
        self.opt_state = opt
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
        self.params = T.trainable(T.init_params(self.cfg, gen, device=self.device,
                                                dtype=torch.float32))
        self.opt_state = adamw_init(self.params)

    # -- one step with retry + watchdog --------------------------------------
    def train_step(self, batch: dict[str, np.ndarray],
                   fault_hook: Optional[Callable[[int], None]] = None) -> dict:
        if self.params is None:
            raise RuntimeError("the trainer's state was lost in a failed update and no "
                               "checkpoint holds it")
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}
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
        if not self.tcfg.ckpt_dir:
            return None
        return CKPT.save_checkpoint(
            self.tcfg.ckpt_dir, self.step, params=self.params, opt_state=self.opt_state,
            data_state=self.pipeline.state.to_dict(), keep=self.tcfg.keep)

    # -- elastic -------------------------------------------------------------
    def remesh(self, new_mesh):
        """Re-shard live state onto another device topology: waits for the
        port's sharded plane."""
        raise NotImplementedError("remesh has no port yet: the trainer runs on one device")
