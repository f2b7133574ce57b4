"""Slot-pool layer (counterpart of the reference's ``serving/pool.py``):
the slotted KV cache, the per-slot decode state, and the slot lifecycle.

One :class:`SlotPool` owns everything whose lifetime is "a slot":

- the device KV cache built by ``models.transformer.init_cache`` (bf16,
  or int8 codes with f32 scales under ``kv_bits``);
- the fused-path device state: last token, position, budget and liveness
  per slot.  The state tensors, like the cache, are allocated once and
  every program writes them in place, so a CUDA graph captured over them
  reads what the host writes there (:meth:`kill`);
- the host arrays of the ``fused=False`` baseline, made on first use;
- host bookkeeping: which ``Request`` occupies each slot, chunked-prefill
  progress (``prefilling``: slot -> (next_prompt_pos, budget)) and the
  anomaly-quarantine counters.

The engine allocates and frees slots through this object; the executor
updates ``(cache, state)`` and hands them back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T


class SlotPool:
    def __init__(self, cfg: ModelConfig, ecfg, *, device):
        B, S = ecfg.max_batch, ecfg.kv_len
        self.ecfg = ecfg
        self.cache = T.init_cache(cfg, B, S, dtype=torch.bfloat16, device=device,
                                  kv_bits=ecfg.kv_bits)
        i32 = dict(dtype=torch.int32, device=device)
        self.state = {
            "tokens": torch.zeros((B,), **i32),
            "pos": torch.zeros((B,), **i32),
            "budget": torch.zeros((B,), **i32),
            "live": torch.zeros((B,), dtype=torch.bool, device=device),
        }
        self.slot_req: list = [None] * B
        self.prefilling: dict[int, tuple[int, int]] = {}
        self.anomalies: list[int] = [0] * B
        # host-path (fused=False) arrays, made on first admission
        self.host: Optional[dict[str, np.ndarray]] = None

    def free_slots(self) -> list[int]:
        """Free slot indices, ascending (allocation order is index order)."""
        return [i for i in range(self.ecfg.max_batch) if self.slot_req[i] is None]

    def occupied(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def decoding(self) -> list:
        """Requests in slots that are actively decoding (occupied and not
        mid-prefill) — the set a prefill burst would preempt."""
        return [r for i, r in enumerate(self.slot_req)
                if r is not None and i not in self.prefilling]

    def ensure_host(self) -> dict[str, np.ndarray]:
        """The ``fused=False`` baseline's per-slot position, budget and last
        token, on the host."""
        if self.host is None:
            B = self.ecfg.max_batch
            self.host = {"slot_pos": np.zeros(B, np.int32),
                         "slot_budget": np.zeros(B, np.int32),
                         "last_token": np.zeros(B, np.int32)}
        return self.host

    def release(self, slot: int) -> None:
        """Free a slot whose request finished (continuous batching)."""
        self.slot_req[slot] = None

    def kill(self, slot: int) -> None:
        """Free ``slot`` and silence its device row so the decode sweep never
        advances a dead request again."""
        self.slot_req[slot] = None
        self.prefilling.pop(slot, None)
        self.anomalies[slot] = 0
        if self.ecfg.fused:
            self.state["live"][slot] = False
        elif self.host is not None:
            self.host["slot_budget"][slot] = 0
