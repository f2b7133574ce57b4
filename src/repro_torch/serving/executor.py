"""Executor layer (counterpart of the reference's ``serving/executor.py``):
the device programs of the serving engine and its single device→host
transfer point.

The fused decode step (decode → sample → bookkeeping), the packed ragged
prefill with its multi-slot insert, and the chunked-prefill continuation
run here, and so do the baselines' pieces: the batch-1 prefill and insert
of sequential admission (``packed=False``) and the host-looped decode and
sampling of ``fused=False``.  The executor owns the parameters, the
sampling generator and the host-transfer accounting; it holds no request
or slot bookkeeping — callers pass ``(cache, state)`` in and get the same
objects back.

Where the reference donates the cache to a jitted program, the port
updates the pool's cache and state tensors **in place**.  The three
programs have fixed shapes and read no device data on the host, so on a
card :meth:`capture` records each of them once in a CUDA graph
(:mod:`.graphs`) and :meth:`run` replays it; the only synchronising read
is :meth:`fetch`.  On the CPU :meth:`run` calls the program's method.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.attention import put_unique, ring_positions, unique_targets
from repro_torch.quant.core import quantize_params

# the three programs: the engine's default path, each one device call
PROGRAMS = ("fused_step", "packed_prefill", "chunk_step")


def _assign(state: dict, **new) -> None:
    """Write new values into the state tensors in place (every value is
    computed before any is written)."""
    for name, value in new.items():
        state[name].copy_(value)


class Executor:
    def __init__(self, cfg: ModelConfig, params, ecfg, *, device):
        self.cfg, self.ecfg = cfg, ecfg
        self.device = torch.device(device)
        self.params = params
        if ecfg.weight_bits:
            # weight-only quantisation, once, of the engine's own copy
            self.params = T.Transformer(cfg, quantize_params(
                params, ecfg.weight_bits, group=ecfg.weight_group))
        self.generator = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        self.graphs = None            # the captured programs (.graphs.ProgramGraphs)
        # host-transfer accounting
        self.host_transfers = 0
        self.host_bytes = 0

    # -- device→host choke point ---------------------------------------------
    def fetch(self, x: torch.Tensor) -> np.ndarray:
        """The engine's single device→host transfer point."""
        arr = x.to("cpu").numpy()
        self.host_transfers += 1
        self.host_bytes += arr.nbytes
        return arr

    def _sample(self, logits):
        if self.ecfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # one categorical draw as torch.multinomial makes it, argmax of
        # p / E with E ~ Exp(1), without its host-side check of p
        probs = torch.softmax(logits.float() / self.ecfg.temperature, dim=-1)
        e = torch.empty_like(probs).exponential_(generator=self.generator)
        return torch.argmax(probs / e, dim=-1).to(torch.int32)

    # -- the programs: captured once, replayed --------------------------------
    def capture(self, pool, programs=PROGRAMS, *, chunk: int) -> None:
        """Record ``programs`` over ``pool`` as CUDA graphs, with a packed
        stream of ``chunk`` tokens, which :meth:`run` then replays.  Every
        slot of the pool must be dead, so that the warm-up and the capture
        leave pool and state as they are."""
        from repro_torch.serving.graphs import ProgramGraphs
        self.graphs = ProgramGraphs(self, pool, programs, chunk)

    def run(self, name: str, pool, *host: np.ndarray) -> torch.Tensor:
        """Run program ``name`` over ``pool`` with the host arrays ``host``
        as its inputs (after cache and state): replayed from its graph where
        it was captured, else eagerly.  Returns its output on the device."""
        if self.graphs is not None:
            return self.graphs.replay(name, host)
        args = [torch.from_numpy(a).to(self.device) for a in host]
        return getattr(self, name)(pool.cache, pool.state, *args)[2]

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
            _assign(state, tokens=torch.where(ok, nxt, state["tokens"]), pos=pos_new,
                    budget=budget_new, live=live & ~done)
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
        _assign(state, tokens=torch.where(fin, nxt, state["tokens"]),
                pos=torch.where(fin, seg_len, state["pos"]),
                budget=torch.where(fin, budget - 1, state["budget"]),
                live=torch.where(fin, budget > 1, state["live"]))
        return cache, state, torch.where(fin, nxt, -1)

    def packed_insert(self, cache, pstack, seg, positions, seg_len, active):
        """Scatter each packed segment into its KV slot, in place.  Validity
        is governed by the ``pos`` leaves, so those rows are rebuilt per
        active slot (ring slot ``s`` of a cap-``c`` cache holds position
        ``p ≡ s (mod c)``, ``p ∈ [len-c, len)``), while every other leaf
        (k/v, or the code and scale planes) scatters the packed tokens
        straight to their (slot, ring index) targets: only the last ``c``
        tokens of a segment, so the targets are unique, and pads dropped
        on the device (:func:`unique_targets`)."""
        seg1, pos1 = seg[0], positions[0]                 # (C,) slot id / pos
        for pool_g, packed_g in zip(cache["stack"], pstack):
            for unit, pc in packed_g.items():
                pool, packed = pool_g[unit]["attn"], pc["attn"]
                cap = pool["pos"].shape[2]
                p = ring_positions(seg_len[:, None], cap)           # (B, cap)
                rows = torch.where((p >= 0) & active[:, None], p, -1)
                pool["pos"].copy_(torch.where(active[None, :, None], rows[None],
                                              pool["pos"]))
                keep = (seg1 >= 0) & \
                    (pos1 >= seg_len[seg1.clamp(min=0).long()] - cap)
                loc = seg1.clamp(min=0) * cap + torch.remainder(pos1, cap)
                sel, tgt, keep = unique_targets(loc, keep, pool["pos"].shape[1] * cap)
                for name in pool:
                    if name != "pos":
                        put_unique(pool[name], sel, tgt, keep, packed[name][:, 0], lead=1)

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
        _assign(state, tokens=torch.where(final, nxt, state["tokens"]),
                pos=torch.where(final, pos_end, state["pos"]),
                budget=torch.where(final, budget - 1, state["budget"]),
                live=torch.where(final, budget > 1, state["live"]))
        return cache, state, torch.where(final, nxt, -1)

    # -- the baselines (eager) -------------------------------------------------
    @torch.no_grad()
    def prefill_insert(self, cache, state, tokens, slot: int, length: int, budget: int):
        """Sequential admission (``packed=False``): one right-padded batch-1
        prompt → first-token sample → insert into ``slot`` → that slot's
        state.  Returns (cache, state, first token on the device)."""
        logits, pcache = self.prefill(tokens, length)
        tok = self._sample(logits)[0]
        self.insert(cache, pcache, slot, length)
        state["tokens"][slot] = tok
        state["pos"][slot] = length
        state["budget"][slot] = budget - 1
        state["live"][slot] = budget > 1
        return cache, state, tok

    @torch.no_grad()
    def prefill(self, tokens, length: int):
        """A batch-1 prefill padded to a bucketed length: (logits, cache)
        exact at ``length``, with the pool's depth and precision."""
        return T.prefill(self.params, self.cfg, tokens, impl=self.ecfg.impl,
                         kv_cap=self.ecfg.kv_len, length=length,
                         kv_bits=self.ecfg.kv_bits)

    def insert(self, cache, pcache, slot: int, length: int):
        """Copy a batch-1 prefill cache into slot ``slot`` of the pool, in
        place, every leaf whole.  ``pos`` entries at cache indices >=
        ``length`` are invalidated, so right-padding never leaves attendable
        entries (ring caches hold only positions < length)."""
        for pool_g, one_g in zip(cache["stack"], pcache["stack"]):
            for unit, one in one_g.items():
                pool = pool_g[unit]["attn"]
                for name, leaf in one["attn"].items():
                    if name == "pos":
                        idx = torch.arange(leaf.shape[-1], device=leaf.device)
                        leaf = torch.where(idx < length, leaf, -1)
                    pool[name][:, slot].copy_(leaf[:, 0])
        return cache

    @torch.no_grad()
    def decode(self, cache, tokens, pos):
        """One decode step of the host-looped baseline (``fused=False``):
        (logits, cache)."""
        return T.decode_step(self.params, self.cfg, cache, tokens, pos,
                             impl=self.ecfg.impl)

    def sample_host(self, logits) -> np.ndarray:
        """Host-path sampling (``fused=False``): the sampled tokens, fetched.
        Draws come from the executor's generator, as on the fused path."""
        return self.fetch(self._sample(logits))
