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
  anomaly-quarantine counters;
- for speculative decoding with a draft model (``spec_draft="model"``),
  the draft model's own KV pool (:meth:`init_draft`), which the
  speculative step keeps in lockstep with the target's.

The engine allocates and frees slots through this object; the executor
updates ``(cache, state)`` and hands them back.  The checkpoint plane
(``serving/checkpoint.py``) serialises the pool through :meth:`array_tree`
/ :meth:`meta` and restores it through :meth:`load_array_tree` /
:meth:`load_meta`, in the reference's tree layout (``cache/...``,
``state/...``, ``draft/...``, ``host/...`` flat keys).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import tree_items
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
        # the draft model's KV pool (spec_draft="model"); self-speculation
        # drafts in the target's own pool
        self.draft_cache = None
        self.device = device

    def init_draft(self, draft_cfg: ModelConfig) -> None:
        """Allocate the draft model's KV pool: the target pool's slots and
        depth in the draft config's geometry, always bf16 (the draft is
        cheap by construction)."""
        self.draft_cache = T.init_cache(draft_cfg, self.ecfg.max_batch, self.ecfg.kv_len,
                                        dtype=torch.bfloat16, device=self.device)

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
            self.host = _zero_host(self.ecfg.max_batch)
        return self.host

    def release(self, slot: int) -> None:
        """Free a slot whose request finished (continuous batching)."""
        self.slot_req[slot] = None

    def truncate(self, slot: int, keep_len: int) -> None:
        """Invalidate every cache entry of ``slot`` (the draft pool's too) at
        positions >= ``keep_len``: the ``pos`` leaves alone decide validity,
        so this is a whole logical rollback, in place (the host-side sibling
        of the speculative step's in-program rollback)."""
        for cache in (self.cache, self.draft_cache):
            for name, leaf in cache_leaves(cache):
                if name == "pos":
                    row = leaf[:, slot]
                    row.copy_(torch.where(row >= keep_len, -1, row))

    def valid_len(self, slot: int) -> int:
        """1 + the highest valid cache position of ``slot`` (0 = empty): the
        committed prefix a rollback left."""
        return max(int(leaf[:, slot].max()) + 1
                   for name, leaf in cache_leaves(self.cache) if name == "pos")

    def kill(self, slot: int) -> None:
        """Free ``slot`` and silence its device row so the decode sweep never
        advances a dead request again.  The draft pool needs nothing: a dead
        row's draft steps write nowhere, and the next request admitted to the
        slot rewrites the slot's draft rows whole (``Executor.draft_prefill``)."""
        self.slot_req[slot] = None
        self.prefilling.pop(slot, None)
        self.anomalies[slot] = 0
        if self.ecfg.fused:
            self.state["live"][slot] = False
        elif self.host is not None:
            self.host["slot_budget"][slot] = 0

    # -- serialization API (serving/checkpoint.py) ------------------------------
    def array_tree(self) -> dict:
        """Every array leaf of the pool, in the snapshot's tree layout:
        ``cache``, ``state``, the draft model's pool under ``draft`` once it
        exists and the host arrays under ``host`` once they exist.  Leaves
        are the live tensors: callers copy them."""
        tree: dict = {"cache": self.cache, "state": self.state}
        if self.draft_cache is not None:
            tree["draft"] = self.draft_cache
        if self.host is not None:
            tree["host"] = dict(self.host)
        return tree

    def array_template(self, with_host: bool) -> dict:
        """A structure-matching template for ``ckpt.unflatten_tree``, with
        fresh zero host arrays when the snapshot carries them."""
        tree = {k: v for k, v in self.array_tree().items() if k != "host"}
        if with_host:
            tree["host"] = _zero_host(self.ecfg.max_batch)
        return tree

    def load_array_tree(self, tree: dict) -> None:
        """Adopt restored leaves.  Cache, state and draft leaves are copied
        **in place** into the tensors the pool already holds (a CUDA graph
        captured over the pool reads them by address), after every leaf was
        checked: one of another shape or dtype is refused and nothing is
        written.  Host arrays stay numpy."""
        live = self.array_tree()
        names = [k for k in ("cache", "state", "draft") if k in tree]
        if any(k not in live for k in names):
            raise ValueError("the restored tree has a draft pool, the pool has none")
        dst = dict(tree_items({k: live[k] for k in names}))
        src = dict(tree_items({k: tree[k] for k in names}))
        missing = sorted(dst.keys() - src.keys())
        if missing:
            raise KeyError(f"restored tree lacks {missing[0]}")
        for path, leaf in dst.items():
            got = torch.as_tensor(src[path])
            if tuple(got.shape) != tuple(leaf.shape) or got.dtype != leaf.dtype:
                raise ValueError(f"restored leaf {path} is {got.dtype} {tuple(got.shape)}, "
                                 f"the pool's {leaf.dtype} {tuple(leaf.shape)}")
        for path, leaf in dst.items():
            leaf.copy_(torch.as_tensor(src[path]))
        if "host" in tree:
            self.host = {k: np.array(v) for k, v in tree["host"].items()}

    def meta(self) -> dict:
        """JSON-safe slot bookkeeping for the snapshot's meta record."""
        return {
            "prefilling": [[int(s), int(start), int(budget)]
                           for s, (start, budget) in self.prefilling.items()],
            "slot_anomalies": list(self.anomalies),
        }

    def load_meta(self, prefilling, slot_anomalies) -> None:
        self.prefilling = {int(s): (int(start), int(budget))
                           for s, start, budget in prefilling}
        self.anomalies = list(slot_anomalies)


def _zero_host(B: int) -> dict[str, np.ndarray]:
    """The ``fused=False`` baseline's host arrays, zeroed."""
    return {"slot_pos": np.zeros(B, np.int32), "slot_budget": np.zeros(B, np.int32),
            "last_token": np.zeros(B, np.int32)}


def cache_leaves(cache):
    """(name, tensor) of every leaf of a slot pool (``T.init_cache``'s
    tree; ``None`` has none), in a fixed order.  Axis 1 of every leaf is
    the slot, axis 2 the cache entry (ring index)."""
    if cache is None:
        return
    for group in cache["stack"]:
        for unit in group.values():
            yield from unit["attn"].items()
