"""Executor layer (counterpart of the reference's ``serving/executor.py``):
the device programs of the serving engine and its single device→host
transfer point.

The fused decode step (decode → sample → bookkeeping), the speculative
step that takes its place under ``spec_k`` (draft, verify, accept, roll
back), the packed ragged prefill with its multi-slot insert, and the
chunked-prefill continuation run here, and so do the baselines' pieces:
the batch-1 prefill and insert of sequential admission (``packed=False``)
and the host-looped decode and sampling of ``fused=False``.  The executor
owns the parameters (and a speculative draft's), the sampling generator
and the host-transfer accounting; it holds no request or slot bookkeeping
— callers pass ``(cache, state)`` in and get the same objects back.

Where the reference donates the cache to a jitted program, the port
updates the pool's cache and state tensors **in place**.  The programs
have fixed shapes and read no device data on the host, so on a card
:meth:`capture` records each of them once in a CUDA graph (:mod:`.graphs`)
and :meth:`run` replays it; the only synchronising read is :meth:`fetch`.
On the CPU :meth:`run` calls the program's method.

With a mesh (``torch.distributed`` ``DeviceMesh``) the executor builds the
reference's two serving plans (``parallel.sharding``): the decode plan,
under which the fused step, the chunk step, sequential admission and the
host-looped baseline run, and the packed-prefill plan, under which the
packed forward pass runs (its sample and insert under the decode plan, as
the reference's).  The parameters are distributed at the decode plan's
specs (weights over ``model``, and over ``data`` as well above 6 GiB a
model rank: ``sharding._serving_fsdp``), the pool by
``cache_shardings``, and the per-slot state stays a plain tensor, the
same on every rank.  Logits are gathered whole before
sampling, so the packed ``(K, 3, B)`` read stays the only host read.  A
write into the pool by slot index runs on each rank's own slots
(:func:`_pool_views`).  The speculative step runs under the decode plan
too: the draft's decode steps under the draft's own (a quantised
self-draft's weights placed as the serving weights, a draft model's at
its own decode plan's specs), and its column save, restore and rollback on
each rank's own slots (:meth:`Executor._spec_cols`).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.attention import (HEAD_LEAVES, put_unique, ring_positions,
                                          unique_targets)
from repro_torch.parallel.api import (activate_plan, full, local_views, planned_mesh,
                                      region_placements, sharded_over, to_placements)
from repro_torch.parallel import sharding as SH
from repro_torch.quant.core import quantize_params
from repro_torch.serving.pool import attn_units

# the three programs of the engine's default path, each one device call;
# under spec_k the speculative step takes the fused step's place
PROGRAMS = ("fused_step", "packed_prefill", "chunk_step")
SPEC_PROGRAMS = ("spec_step", "packed_prefill", "chunk_step")


def _assign(state: dict, **new) -> None:
    """Write new values into the state tensors in place (every value is
    computed before any is written)."""
    for name, value in new.items():
        state[name].copy_(value)


class Executor:
    def __init__(self, cfg: ModelConfig, params, ecfg, *, device, mesh=None):
        self.cfg, self.ecfg = cfg, ecfg
        self.device = torch.device(device)
        self.params = params
        if ecfg.weight_bits:
            # weight-only quantisation, once, of the engine's own copy
            self.params = T.Transformer(cfg, quantize_params(
                params, ecfg.weight_bits, group=ecfg.weight_group))
        # the decode and packed-prefill plans of a mesh; shard_ctx places
        # the pool (SlotPool)
        self._plan = self._prefill_plan = self.shard_ctx = None
        self.mesh = mesh
        if mesh is not None:
            self._plan, self.shard_ctx = SH.serving_decode_plan(
                cfg, mesh, max_batch=ecfg.max_batch, kv_len=ecfg.kv_len)
            self._prefill_plan, _ = SH.serving_prefill_plan(
                cfg, mesh, prefill_chunk=min(ecfg.prefill_chunk or min(128, ecfg.kv_len),
                                             ecfg.kv_len))
            self.params = SH.distribute_params(self.params, self.shard_ctx)
        self.generator = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        self.graphs = None            # the captured programs (.graphs.ProgramGraphs)
        # speculative decoding: self-speculation drafts with a quantised copy
        # of the unquantised serving params (spec_draft_bits; 0 = the serving
        # params themselves); a draft model comes through set_draft()
        self.draft_cfg, self.draft_params, self._draft_plan = cfg, None, self._plan
        if ecfg.spec_k > 0 and ecfg.spec_draft == "self":
            self.draft_params = self.params
            if ecfg.spec_draft_bits:
                self.draft_params = T.Transformer(cfg, quantize_params(
                    params, ecfg.spec_draft_bits, group=ecfg.weight_group))
                if mesh is not None:
                    self.draft_params = SH.distribute_params(self.draft_params,
                                                             self.shard_ctx)
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
        logits = full(logits)           # a sharded vocab, gathered whole first
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
        as its inputs (after the pool's): replayed from its graph where it
        was captured, else eagerly.  Returns its output on the device."""
        if self.graphs is not None:
            return self.graphs.replay(name, host)
        args = [torch.from_numpy(a).to(self.device) for a in host]
        return getattr(self, name)(*pool_args(name, pool), *args)[2]

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
            with activate_plan(self._plan):
                logits, cache = T.decode_step(self.params, self.cfg, cache,
                                              state["tokens"], pos_w, impl=ecfg.impl)
            logits = full(logits)
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
        with activate_plan(self._prefill_plan):
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
        with activate_plan(self._plan):
            self._packed_insert(cache, pstack, seg, positions, seg_len, active)

    @staticmethod
    def _packed_insert(cache, pstack, seg, positions, seg_len, active):
        seg1, pos1 = seg[0], positions[0]                 # (C,) slot id / pos
        for pool_g, packed_g in zip(cache["stack"], pstack):
            for unit, pc in packed_g.items():
                with _pool_views(pool_g[unit]["attn"], pc["attn"]) as (pool, packed, off):
                    B, cap = pool["pos"].shape[1:3]
                    sl, act = seg_len[off:off + B], active[off:off + B]
                    p = ring_positions(sl[:, None], cap)            # (B, cap)
                    rows = torch.where((p >= 0) & act[:, None], p, -1)
                    pool["pos"].copy_(torch.where(act[None, :, None], rows[None],
                                                  pool["pos"]))
                    # this rank's slots are off .. off + B - 1
                    keep = (seg1 >= off) & (seg1 < off + B) & \
                        (pos1 >= seg_len[seg1.clamp(min=0).long()] - cap)
                    loc = (seg1 - off).clamp(0, B - 1) * cap + torch.remainder(pos1, cap)
                    sel, tgt, keep = unique_targets(loc, keep, B * cap)
                    for name in pool:
                        if name != "pos":
                            put_unique(pool[name], sel, tgt, keep, packed[name][:, 0],
                                       lead=1)

    @torch.no_grad()
    def chunk_step(self, cache, state, tokens, pos, take_idx, final, budget):
        """One chunked-prefill continuation over the pool: write each
        prefilling row's next chunk into its cache at explicit positions,
        attend to the whole cache, and activate rows whose prompt completed
        (sample their first token)."""
        with activate_plan(self._plan):
            logits, cache = T.chunk_prefill_step(self.params, self.cfg, cache, tokens,
                                                 pos, take_idx, impl=self.ecfg.impl)
        nxt = self._sample(logits)
        pos_end = torch.where(pos >= 0, pos + 1, 0).amax(dim=1).to(torch.int32)
        _assign(state, tokens=torch.where(final, nxt, state["tokens"]),
                pos=torch.where(final, pos_end, state["pos"]),
                budget=torch.where(final, budget - 1, state["budget"]),
                live=torch.where(final, budget > 1, state["live"]))
        return cache, state, torch.where(final, nxt, -1)

    # -- speculative decoding ---------------------------------------------------
    def set_draft(self, draft_cfg: ModelConfig, draft_params) -> None:
        """Attach a separate draft model (``spec_draft="model"``); under a
        mesh its weights go to its own decode plan's specs, under which its
        steps run."""
        if self.mesh is not None:
            self._draft_plan, ctx = SH.serving_decode_plan(
                draft_cfg, self.mesh, max_batch=self.ecfg.max_batch, kv_len=self.ecfg.kv_len)
            draft_params = SH.distribute_params(draft_params, ctx)
        self.draft_cfg, self.draft_params = draft_cfg, draft_params

    @torch.no_grad()
    def draft_prefill(self, dcache, tokens, slot: int, length: int):
        """Mirror a completed prompt into the draft model's pool: one
        right-padded batch-1 draft prefill, inserted into ``slot`` in place
        (eager, one launch a kernel, as the sequential baseline's)."""
        with activate_plan(self._draft_plan):
            _, pcache = T.prefill(self.draft_params, self.draft_cfg, tokens,
                                  impl=self.ecfg.impl, kv_cap=self.ecfg.kv_len,
                                  length=length)
        return self.insert(dcache, pcache, slot, length)

    def _spec_ring(self, leaf, p):
        """(slot index (B, 1), ring index (B, spec_k+1)) of the columns at
        positions ``p .. p+spec_k`` of a pool leaf (``p`` the positions of
        its ``B`` slots): the columns a speculative step can write.
        ``spec_k + 1`` fits the smallest ring (validated by the engine), so
        a row's ring indices are distinct."""
        jj = torch.arange(self.ecfg.spec_k + 1, dtype=torch.int32, device=p.device)
        bidx = torch.arange(leaf.shape[1], device=p.device)[:, None]
        return bidx, torch.remainder(p[:, None] + jj[None], leaf.shape[2]).long()

    def _spec_cols(self, cache, p) -> list:
        """Copies of the ``spec_k + 1`` columns at ring indices ``(p + j) %
        cap`` of every leaf, (repeats, B, spec_k+1, ...) each: the pre-step
        bytes a rollback writes back (advanced indexing copies).  Under a
        mesh each rank copies its own slots' columns (:func:`_pool_views`:
        the slot axis local, a sharded ring gathered whole)."""
        saved = []
        for attn in attn_units(cache):
            with _pool_views(attn, {}) as (pool, _, off):
                for leaf in pool.values():
                    ring = self._spec_ring(leaf, p[off:off + leaf.shape[1]])
                    saved.append(leaf[(slice(None),) + ring])
        return saved

    def _spec_restore(self, cache, saved, p, mask) -> None:
        """Write the saved columns back where ``mask`` (B, spec_k+1) is set,
        in place; elsewhere a column keeps what it holds.  Under a mesh each
        rank writes its own slots, with its rows of ``p`` and ``mask``."""
        saved = iter(saved)
        for attn in attn_units(cache):
            with _pool_views(attn, {}) as (pool, _, off):
                for leaf in pool.values():
                    sv, rows = next(saved), slice(off, off + leaf.shape[1])
                    ix = (slice(None),) + self._spec_ring(leaf, p[rows])
                    m = mask[rows].reshape((1,) + mask[rows].shape + (1,) * (sv.dim() - 3))
                    leaf[ix] = torch.where(m, sv, leaf[ix])

    def _accept_sampled(self, dlogits, vlogits, dtoks):
        """Rejection sampling (Leviathan et al.): accept draft ``d_j`` iff
        ``u * q(d_j) <= p(d_j)``; at the first rejection draw from the
        normalised residual ``max(p - q, 0)``, with ``q := 0`` past the
        drafts, so full acceptance draws from the last target distribution.
        Returns (accepted count n (B,), next token (B,))."""
        tau, (B, K) = self.ecfg.temperature, dtoks.shape
        qd = torch.softmax(dlogits.float() / tau, dim=-1)           # (B, K, V)
        pt = torch.softmax(vlogits.float() / tau, dim=-1)           # (B, K+1, V)
        idx = dtoks.long()[..., None]
        q_at = torch.gather(qd, 2, idx)[..., 0]
        p_at = torch.gather(pt[:, :K], 2, idx)[..., 0]
        u = torch.rand((B, K), generator=self.generator, device=dtoks.device)
        n = torch.cumprod((u * q_at <= p_at).to(torch.int32), dim=1).sum(dim=1)
        at_n = n.long()[:, None, None].expand(B, 1, pt.shape[-1])
        p_n = torch.gather(pt, 1, at_n)[:, 0]
        q_n = torch.gather(torch.cat([qd, torch.zeros_like(pt[:, :1])], dim=1), 1,
                           at_n)[:, 0]
        res = torch.clamp_min(p_n - q_n, 0.0)
        res = torch.clamp_min(res / torch.clamp_min(res.sum(-1, keepdim=True), 1e-30),
                              1e-30)
        # one categorical draw, as _sample makes it: argmax of res / E
        e = torch.empty_like(res).exponential_(generator=self.generator)
        return n.to(torch.int32), torch.argmax(res / e, dim=-1).to(torch.int32)

    @torch.no_grad()
    def spec_step(self, cache, state, dcache=None):
        """The speculative counterpart of :meth:`fused_step`: ``spec_k``
        draft decode steps (the draft's params, in the draft pool
        ``dcache`` or, drafting with itself, the target's own pool), one
        :func:`T.verify_step` scoring ``[t0, d_1..d_K]`` at positions
        ``p..p+K``, greedy or rejection-sampling acceptance, then a rollback
        of every column past the committed prefix from copies taken before
        the step.  Everything is written in place.

        With ``n`` drafts accepted a live row commits ``m + 1`` tokens
        ``[d_1..d_m, t_next]``, ``m = min(n, budget-1, kv_len-1-pos,
        eos_idx)``: the cache ends valid through ``pos + m`` and the last
        committed token is the new pending one at ``pos + m + 1``, the
        fused step's invariant a token at a time.  A row whose verify logits
        are non-finite is frozen (every column restored, its state left) and
        flagged.  A dead row writes nothing: the draft steps write at
        ``pos -1``, the wipe and the rollback are masked by ``live``, verify
        writes at ``-1`` and the draft model's catch-up too.

        Returns (cache, state, packed (spec_k+1, 4, B) int32 of (token | -1,
        done, anomaly, accepted)); ``dcache`` is updated in place."""
        with activate_plan(self._plan):
            return self._spec_step(cache, state, dcache)

    def _spec_step(self, cache, state, dcache):
        ecfg = self.ecfg
        K, B = ecfg.spec_k, ecfg.max_batch
        live, p, t0 = state["live"], state["pos"], state["tokens"]
        self_draft = dcache is None
        jidx = torch.arange(K + 1, dtype=torch.int32, device=p.device)
        saved = self._spec_cols(cache, p)
        dsaved = None if self_draft else self._spec_cols(dcache, p)

        # -- draft: K sequential decode steps at the draft's precision -------
        dc = cache if self_draft else dcache
        tok, dtoks, dlogits = t0, [], []
        for j in range(K):
            with activate_plan(self._draft_plan):
                logits, _ = T.decode_step(self.draft_params, self.draft_cfg, dc, tok,
                                          torch.where(live, p + j, -1), impl=ecfg.impl)
            logits = full(logits)
            tok = self._sample(logits)
            dtoks.append(tok)
            dlogits.append(logits)
        dtoks = torch.stack(dtoks, dim=1)                           # (B, K)
        if self_draft:
            # wipe the drafts' K/V: verify needs every valid cache position
            # below its block's, and the saved columns are the pre-draft bytes
            self._spec_restore(cache, saved, p, live[:, None].expand(B, K + 1))

        # -- verify: [t0, d_1..d_K] scored in one chunk pass ------------------
        vtoks = torch.cat([t0[:, None], dtoks], dim=1)              # (B, K+1)
        vpos = torch.where(live[:, None], p[:, None] + jidx[None], -1)
        vlogits, _ = T.verify_step(self.params, self.cfg, cache, vtoks, vpos,
                                   impl=ecfg.impl)
        vlogits = full(vlogits)
        bad = ~torch.isfinite(vlogits).all(dim=2).all(dim=1)
        ok = live & ~bad

        # -- acceptance -------------------------------------------------------
        if ecfg.temperature <= 0.0:
            tgt = torch.argmax(vlogits, dim=-1).to(torch.int32)     # (B, K+1)
            n = torch.cumprod((dtoks == tgt[:, :K]).to(torch.int32), dim=1) \
                .sum(dim=1).to(torch.int32)
            t_next = torch.gather(tgt, 1, n.long()[:, None])[:, 0]
        else:
            n, t_next = self._accept_sampled(torch.stack(dlogits, dim=1), vlogits, dtoks)

        # -- commit bound: budget, cache depth, eos ---------------------------
        comm = torch.cat([dtoks, torch.zeros_like(dtoks[:, :1])], dim=1)
        comm = torch.where(jidx[None] == n[:, None], t_next[:, None], comm)
        m = torch.minimum(n, state["budget"] - 1)
        m = torch.minimum(m, ecfg.kv_len - 1 - p)
        eos_idx = torch.full_like(n, K + 1)
        if ecfg.eos_token >= 0:
            eos_idx = torch.where(comm == ecfg.eos_token, jidx[None], K + 1) \
                .amin(dim=1).to(torch.int32)
            m = torch.minimum(m, eos_idx)
        m = torch.clamp_min(m, 0)

        # -- rollback past the committed prefix --------------------------------
        mask = live[:, None] & ((jidx[None] > m[:, None]) | bad[:, None])
        self._spec_restore(cache, saved, p, mask)
        if not self_draft:
            # full acceptance leaves the draft pool one entry short (input
            # d_K at p+K was never drafted): one catch-up step writes it
            cu_pos = torch.where(ok & (m == K), p + K, -1)
            with activate_plan(self._draft_plan):
                T.decode_step(self.draft_params, self.draft_cfg, dcache, dtoks[:, K - 1],
                              cu_pos, impl=ecfg.impl)
            self._spec_restore(dcache, dsaved, p, mask)

        # -- state update ---------------------------------------------------------
        c = torch.where(ok, m + 1, 0)
        t_last = torch.gather(comm, 1, m.long()[:, None])[:, 0]
        pos_new = p + c
        budget_new = state["budget"] - c
        done = ok & ((budget_new <= 0) | (pos_new >= ecfg.kv_len) | (eos_idx <= m))
        row0 = jidx[:, None] == 0
        packed = torch.stack([
            torch.where((jidx[:, None] <= m[None]) & ok[None], comm.T, -1),
            ((jidx[:, None] == m[None]) & done[None]).to(torch.int32),
            (row0 & (live & bad)[None]).to(torch.int32),
            torch.where(row0 & ok[None], n[None], 0)], dim=1).to(torch.int32)
        _assign(state, tokens=torch.where(ok, t_last, t0), pos=pos_new,
                budget=budget_new, live=live & ~done)
        return cache, state, packed

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
        with activate_plan(self._plan):
            return T.prefill(self.params, self.cfg, tokens, impl=self.ecfg.impl,
                             kv_cap=self.ecfg.kv_len, length=length,
                             kv_bits=self.ecfg.kv_bits)

    def insert(self, cache, pcache, slot: int, length: int):
        """Copy a batch-1 prefill cache into slot ``slot`` of the pool, in
        place, every leaf of every unit whole (attention K/V or codes, a
        recurrent unit's ``conv`` and ``state``/``h``), cast to the pool's
        dtype.  ``pos`` entries at cache indices >= ``length`` are
        invalidated, so right-padding never leaves attendable entries (ring
        caches hold only positions < length)."""
        with activate_plan(self._plan):
            return self._insert(cache, pcache, slot, length)

    @staticmethod
    def _insert(cache, pcache, slot: int, length: int):
        for pool_g, one_g in zip(cache["stack"], pcache["stack"]):
            for unit, one in one_g.items():
                with _pool_views(dict(_unit_leaves(pool_g[unit])),
                                 dict(_unit_leaves(one))) as (pool, ones, off):
                    local = slot - off
                    if not 0 <= local < next(iter(pool.values())).shape[1]:
                        continue                    # another rank's slot
                    for name, dst in pool.items():
                        leaf = ones[name]
                        if name == "pos":
                            idx = torch.arange(leaf.shape[-1], device=leaf.device)
                            leaf = torch.where(idx < length, leaf, -1)
                        dst[:, local].copy_(leaf[:, 0])
        return cache

    @torch.no_grad()
    def decode(self, cache, tokens, pos):
        """One decode step of the host-looped baseline (``fused=False``):
        (logits, cache)."""
        with activate_plan(self._plan):
            return T.decode_step(self.params, self.cfg, cache, tokens, pos,
                                 impl=self.ecfg.impl)

    def sample_host(self, logits) -> np.ndarray:
        """Host-path sampling (``fused=False``): the sampled tokens, fetched.
        Draws come from the executor's generator, as on the fused path."""
        return self.fetch(self._sample(logits))


@contextlib.contextmanager
def _pool_views(pool: dict, values: dict):
    """(pool leaves, value leaves, first slot) on this rank: a unit's pool
    leaves ``(R, B, ...)`` and the values bound for them (``(R, 1, ...)``:
    a prefill's cache, or a packed stream's) as local tensors.  A sharded
    pool gives its own slots (axis 1) and KV heads (axis 3 of K/V leaves),
    written in place, and the values the same heads; unsharded, everything
    as it is and slot 0 first."""
    mesh = planned_mesh("pool write", *pool.values())
    if mesh is None:
        yield pool, values, 0
        return
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def heads(name):
        return sharded_over(pool[name].placements, 3) if name in HEAD_LEAVES else []
    targets = {n: region_placements(mesh, {1: sharded_over(t.placements, 1), 3: heads(n)})
               for n, t in pool.items()}
    name, leaf = next(iter(pool.items()))
    off = compute_local_shape_and_global_offset(leaf.shape, mesh, targets[name])[1][1]
    with local_views(mesh, pool, targets) as local:
        yield local, {n: to_placements(v, mesh, region_placements(mesh, {3: heads(n)}))
                      .to_local() for n, v in values.items()}, off


def _unit_leaves(unit: dict):
    """(name, tensor) of every leaf of one unit's cache, in a fixed order."""
    for name, leaf in sorted(unit.items()):
        if isinstance(leaf, dict):
            yield from _unit_leaves(leaf)
        else:
            yield name, leaf


def pool_args(name: str, pool) -> tuple:
    """What program ``name`` takes from the pool: (cache, state), and the
    speculative step the draft model's pool too."""
    if name == "spec_step":
        return pool.cache, pool.state, pool.draft_cache
    return pool.cache, pool.state
