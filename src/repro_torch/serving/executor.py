"""Executor layer (counterpart of the reference's ``serving/executor.py``):
the device programs of the serving engine and its single device→host
transfer point.

The fused decode step (decode → sample → bookkeeping), the packed ragged
prefill with its multi-slot insert, and the chunked-prefill continuation
run here.  The executor owns the parameters, the sampling generator and
the host-transfer accounting; it holds no request or slot bookkeeping —
callers pass ``(cache, state)`` in and adopt what comes back.

Where the reference donates the cache to a jitted program, the port
updates the pool tensors **in place** and returns the same cache object.
PyTorch runs eagerly, so a "program" here is the sequence of kernels one
method enqueues; the only synchronising read is :meth:`fetch` (and the
data-dependent index lists of the prefill-side scatters).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.attention import ring_positions
from repro_torch.quant.core import quantize_params


class Executor:
    def __init__(self, cfg: ModelConfig, params, ecfg, *, device):
        self.cfg, self.ecfg = cfg, ecfg
        self.params = params
        if ecfg.weight_bits:
            # weight-only quantisation, once, of the engine's own copy
            self.params = T.Transformer(cfg, quantize_params(
                params, ecfg.weight_bits, group=ecfg.weight_group))
        self.generator = torch.Generator(device=device).manual_seed(ecfg.seed)
        # host-transfer accounting
        self.host_transfers = 0
        self.host_bytes = 0

    # -- device→host choke point ---------------------------------------------
    def fetch(self, x: torch.Tensor) -> np.ndarray:
        """The engine's single device→host transfer point."""
        arr = x.cpu().numpy()
        self.host_transfers += 1
        self.host_bytes += arr.nbytes
        return arr

    def _sample(self, logits):
        if self.ecfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.ecfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0].to(torch.int32)

    # -- fused path --------------------------------------------------------------
    @torch.no_grad()
    def fused_step(self, cache, state):
        """decode → sample → bookkeeping for ``decode_chunk`` iterations (a
        Python loop).  Returns the (cache, state) plus a packed (K, 3, B)
        int32 of (next_token | -1, done, anomaly) — the only tensor the host
        reads back per step.

        A slot whose logits come back non-finite is *frozen*: no token
        committed, pos/budget untouched, still live — the identical step
        re-runs next iteration (the KV write at the same pos is
        idempotent), so a transient fault costs one retry and a persistent
        one is quarantined by the host without touching the other slots."""
        ecfg = self.ecfg
        rows = []
        for _ in range(max(1, ecfg.decode_chunk)):
            live = state["live"]
            # dead / mid-prefill slots write at pos -1 → dropped
            pos_w = torch.where(live, state["pos"], -1)
            logits, cache = T.decode_step(self.params, self.cfg, cache,
                                          state["tokens"], pos_w, impl=ecfg.impl)
            nxt = self._sample(logits)
            bad = ~torch.isfinite(logits).all(dim=-1)
            ok = live & ~bad
            pos_new = torch.where(ok, state["pos"] + 1, state["pos"])
            budget_new = torch.where(ok, state["budget"] - 1, state["budget"])
            done = (budget_new <= 0) | (pos_new >= ecfg.kv_len)
            if ecfg.eos_token >= 0:
                done = done | (nxt == ecfg.eos_token)
            done = ok & done
            rows.append(torch.stack([torch.where(ok, nxt, -1),
                                     done.to(torch.int32),
                                     (live & bad).to(torch.int32)]))
            state = {
                "tokens": torch.where(ok, nxt, state["tokens"]),
                "pos": pos_new,
                "budget": budget_new,
                "live": live & ~done,
            }
        return cache, state, torch.stack(rows)

    @torch.no_grad()
    def packed_prefill(self, cache, state, tokens, positions, seg, gather_idx,
                       seg_len, final, budget, active):
        """One ragged prefill for every admitted segment: packed forward pass
        (segment-masked attention) → per-segment first-token sample → one
        multi-slot scatter insert → state update.  Segment id == target slot
        index; ``active`` masks unused slots, ``final`` the segments whose
        prompt completed in this stream (non-final = first chunk of a long
        prompt, which only inserts KV)."""
        logits, pcache = T.prefill_packed(self.params, self.cfg, tokens, positions,
                                          seg, gather_idx, impl=self.ecfg.impl,
                                          kv_bits=self.ecfg.kv_bits)
        nxt = self._sample(logits)
        self.packed_insert(cache, pcache["stack"], seg, positions, seg_len, active)
        fin = active & final
        state = {
            "tokens": torch.where(fin, nxt, state["tokens"]),
            "pos": torch.where(fin, seg_len, state["pos"]),
            "budget": torch.where(fin, budget - 1, state["budget"]),
            "live": torch.where(fin, budget > 1, state["live"]),
        }
        return cache, state, torch.where(fin, nxt, -1)

    def packed_insert(self, cache, pstack, seg, positions, seg_len, active):
        """Scatter each packed segment into its KV slot, in place.  Validity
        is governed by the ``pos`` leaves, so those rows are rebuilt per
        active slot (ring slot ``s`` of a cap-``c`` cache holds position
        ``p ≡ s (mod c)``, ``p ∈ [len-c, len)``), while every other leaf
        (k/v, or the code and scale planes) scatters the packed tokens
        straight to their (slot, ring index) targets."""
        seg1, pos1 = seg[0], positions[0]                 # (C,) slot id / pos
        for pool_g, packed_g in zip(cache["stack"], pstack):
            for unit, pc in packed_g.items():
                pool, packed = pool_g[unit]["attn"], pc["attn"]
                cap = pool["pos"].shape[2]
                p = ring_positions(seg_len[:, None], cap)           # (B, cap)
                rows = torch.where((p >= 0) & active[:, None], p, -1)
                pool["pos"].copy_(torch.where(active[None, :, None], rows[None],
                                              pool["pos"]))
                # only the last `cap` tokens of a segment survive its ring
                keep = (seg1 >= 0) & \
                    (pos1 >= seg_len[seg1.clamp(min=0).long()] - cap)
                idx = keep.nonzero()[:, 0]
                row, ring = seg1[idx].long(), torch.remainder(pos1[idx], cap).long()
                for name in pool:
                    if name != "pos":
                        pool[name][:, row, ring] = packed[name][:, 0, idx].to(pool[name].dtype)

    @torch.no_grad()
    def chunk_step(self, cache, state, tokens, pos, take_idx, final, budget):
        """One chunked-prefill continuation over the pool: write each
        prefilling row's next chunk into its cache at explicit positions,
        attend to the whole cache, and activate rows whose prompt completed
        (sample their first token)."""
        logits, cache = T.chunk_prefill_step(self.params, self.cfg, cache, tokens,
                                             pos, take_idx, impl=self.ecfg.impl)
        nxt = self._sample(logits)
        pos_end = torch.where(pos >= 0, pos + 1, 0).amax(dim=1).to(torch.int32)
        state = {
            "tokens": torch.where(final, nxt, state["tokens"]),
            "pos": torch.where(final, pos_end, state["pos"]),
            "budget": torch.where(final, budget - 1, state["budget"]),
            "live": torch.where(final, budget > 1, state["live"]),
        }
        return cache, state, torch.where(final, nxt, -1)
