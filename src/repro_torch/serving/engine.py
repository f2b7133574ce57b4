"""Batched serving engine: the wiring layer of the serving stack
(counterpart of the reference's ``serving/engine.py``).

Policy, device execution and slot lifecycle live in three sibling layers::

    scheduler.py   admission policy (Scheduler protocol; FIFO default)
    executor.py    the device programs (fused decode step, packed ragged
                   prefill, chunked continuation) + the single
                   device→host transfer point
    pool.py        the slotted KV cache, per-slot decode state, slot
                   lifecycle

``ServingEngine`` owns the request queue, terminal bookkeeping and the
iteration loop.  Each iteration runs:

1. **admission** — the scheduler picks queued requests; all picked
   prompts pack back-to-back into one ragged ``(1, C)`` stream and prefill
   in a **single** call, with one multi-slot scatter insert.  Prompts
   longer than ``C`` contribute their first ``≤ C`` tokens and enter the
   *prefilling* state;
2. **chunked-prefill continuation** — every prefilling slot advances by at
   most one ``C``-token chunk per iteration;
3. **decode** — one fused step over the full slot pool; the only
   device→host traffic per iteration is one packed ``(K, 3, max_batch)``
   int32 of ``(next_token, done, anomaly)``.

On a card the three programs (fused step, packed prefill, chunk step)
are captured as CUDA graphs when the engine is built and replayed from
then on (``executor.py``, ``graphs.py``); on the CPU they run eagerly.

``packed=False`` keeps the sequential admission baseline (one
bucket-padded batch-1 prefill+insert call per request) and
``fused=False`` the host-looped decode step: measurement baselines, run
eagerly on the card too.  ``trace=True`` records each decode iteration's
wall-clock split (``self.trace``, the ``trace_*`` keys of ``stats()``).

The port runs the FIFO scheduler, fp or quantised
(``weight_bits``/``weight_group``/``kv_bits``).  ``EngineConfig`` fields
of the reference that it does not implement raise
``NotImplementedError`` when the engine is built (see ``ROADMAP.md``).
The engine runs on ``"cuda"`` unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.serving.executor import Executor
from repro_torch.serving.pool import SlotPool
from repro_torch.serving.scheduler import FifoScheduler, Scheduler


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8            # KV slot pool size
    kv_len: int = 256             # per-slot KV depth
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 → greedy
    eos_token: int = -1           # -1 → never stops early
    impl: str = "flash"           # attention impl ("flash" → the CUDA kernels)
    seed: int = 0
    fused: bool = True            # fused on-device step (False = host-looped)
    packed: bool = True           # packed prefill + chunked continuation
    #   (False = sequential admission: one batch-1 prefill per request)
    prefill_chunk: int = 0        # packed-stream / chunk budget in tokens
    #   (0 → min(128, kv_len))
    decode_chunk: int = 1         # decode iterations per step()
    weight_bits: int = 0          # 0 = native fp; 8/4 = weight-only
    #   quantisation of the dense projections (dequant-matmul kernel)
    weight_group: int = 0         # rows of K per scale group (0 = per-channel)
    kv_bits: int = 0              # 0 = fp pool; 8/4 = quantised slot-pool KV
    deadline_ms: float = 0.0
    max_queue: int = 0
    anomaly_retries: int = 1      # NaN/inf-logit quarantine: a slot whose
    #   logits go non-finite is frozen and retried this many times before
    #   only that request is failed
    spec_k: int = 0
    clock: Callable[[], float] = time.monotonic
    #   the engine's time source for request timestamps
    trace: bool = False           # per-iteration wall-clock tracer: each
    #   decode iteration appends {"prefill_s", "decode_s", "d2h_s",
    #   "step_s", "iters"} to ``ServingEngine.trace``; stats() adds trace_*
    #   keys only when tracing.  Durations are time.perf_counter's, not
    #   ``clock``'s


# fields of the reference's EngineConfig this slice does not implement, with
# the value that means "off"
_NOT_PORTED = {"deadline_ms": 0.0, "max_queue": 0, "spec_k": 0}

# prompt-length buckets of the sequential (packed=False) baseline
_MIN_BUCKET = 8


def _bucket_len(plen: int, kv_len: int) -> int:
    b = _MIN_BUCKET
    while b < plen:
        b *= 2
    return min(b, kv_len)


class EngineStallError(RuntimeError):
    """``run_until_drained`` exhausted ``max_iters`` with requests still in
    flight; every stranded request was marked ``FAILED_MAX_ITERS`` first."""


# Request terminal states (Request.status)
QUEUED = "queued"
ACTIVE = "active"
DONE = "done"
FAILED_ANOMALY = "failed_anomaly"      # non-finite logits past the retries
FAILED_MAX_ITERS = "failed_max_iters"  # stranded at max_iters exhaustion


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                       # (prompt_len,) int32
    max_new_tokens: Optional[int] = None
    priority: int = 0
    # -- filled by the engine -------------------------------------------------
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = QUEUED
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


def _percentiles(xs) -> tuple:
    """(p50, p95, p99) of a sample list; an empty class is (None,)*3."""
    if not xs:
        return (None, None, None)
    p = np.percentile(np.asarray(xs, np.float64), (50.0, 95.0, 99.0))
    return (float(p[0]), float(p[1]), float(p[2]))


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, ecfg: Optional[EngineConfig] = None,
                 *, device=None, scheduler: Optional[Scheduler] = None, mesh=None):
        self.cfg = cfg
        self.ecfg = ecfg = ecfg if ecfg is not None else EngineConfig()
        if ecfg.weight_bits not in (0, 4, 8):
            raise ValueError(f"weight_bits must be 0, 4 or 8, got {ecfg.weight_bits}")
        if ecfg.kv_bits not in (0, 4, 8):
            raise ValueError(f"kv_bits must be 0, 4 or 8, got {ecfg.kv_bits}")
        for name, off in _NOT_PORTED.items():
            if getattr(ecfg, name) != off:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(ecfg, name)!r} has no port yet")
        if mesh is not None:
            raise NotImplementedError("a mesh (sharded serving) has no port yet")
        self.device = resolve_device(device)
        pdev = next(params.parameters()).device
        if pdev.type != self.device.type:
            raise ValueError(f"parameters on {pdev}, engine on {self.device}")

        self.scheduler: Scheduler = scheduler if scheduler is not None \
            else FifoScheduler()
        self.executor = Executor(cfg, params, ecfg, device=self.device)
        self.pool = SlotPool(cfg, ecfg, device=self.device)

        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self.failed: list[Request] = []
        self._uid = 0

        # prefill / schedule accounting
        self.decode_steps = 0
        self.prefill_tokens = 0
        self.prefill_time = 0.0
        self.prefill_calls = 0
        self.max_stall_tokens = 0
        self._stall_tokens = 0
        # {n_active: decode iterations at that occupancy}
        self.active_slot_hist: collections.Counter = collections.Counter()
        # per-iteration wall-clock records (EngineConfig(trace=))
        self.trace: list[dict] = []

        S = ecfg.kv_len
        self._chunk = min(ecfg.prefill_chunk or min(128, S), S)
        # pow2 bucketing (sequential baseline) is exact only where cache
        # index == token position: global layers, not rings
        self._bucketed = all(k == "global" for k in cfg.layer_kinds)
        if self.device.type == "cuda":
            # the programs this configuration runs, replayed from graphs
            programs = [name for name, used in (
                ("fused_step", ecfg.fused), ("packed_prefill", ecfg.fused and ecfg.packed),
                ("chunk_step", ecfg.fused and ecfg.packed)) if used]
            if programs:
                self.executor.capture(self.pool, programs, chunk=self._chunk)

    @property
    def host_transfers(self):
        return self.executor.host_transfers

    @property
    def host_bytes(self):
        return self.executor.host_bytes

    def _now(self) -> float:
        return self.ecfg.clock()

    def _fetch(self, x) -> np.ndarray:
        return self.executor.fetch(x)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -- public API -------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: Optional[int] = None,
               *, priority: int = 0) -> Request:
        """Validate and enqueue one request (malformed inputs raise
        ``ValueError`` here, not inside a device step)."""
        arr = np.asarray(prompt)
        if arr.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got ndim={arr.ndim}")
        if arr.size == 0:
            raise ValueError("prompt must hold at least one token")
        if arr.dtype.kind not in "iu":
            raise ValueError(f"prompt must be integer token ids, got dtype={arr.dtype}")
        if arr.size + 1 >= self.ecfg.kv_len:
            raise ValueError(
                f"prompt ({arr.size}) ≥ kv_len ({self.ecfg.kv_len}): no room "
                f"for even one generated token in the KV budget")
        if max_new_tokens is not None and max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
        req = Request(uid=self._uid, prompt=arr.astype(np.int32),
                      max_new_tokens=max_new_tokens, priority=int(priority),
                      t_enqueue=self._now())
        self._uid += 1
        self.queue.append(req)
        return req

    def _fail(self, req: Request, status: str, now: Optional[float] = None):
        req.status = status
        req.t_done = now if now is not None else self._now()
        self.failed.append(req)

    # -- scheduler seams -------------------------------------------------------
    def _prefill_allowed(self) -> bool:
        if not (self.queue or self.pool.prefilling):
            return True
        decoding = self.pool.decoding()
        if not decoding:
            return True
        return self.scheduler.allow_prefill(decoding, self._now())

    def _pop_admissible(self) -> Optional[tuple]:
        """Pop the scheduler's next admissible queued request.  Requests
        asking for 0 tokens finish immediately."""
        while self.queue:
            idx = self.scheduler.select(self.queue, self._now())
            if idx is None:
                return None
            req = self.queue[idx]
            del self.queue[idx]
            budget = req.max_new_tokens if req.max_new_tokens is not None \
                else self.ecfg.max_new_tokens
            if budget <= 0:
                req.done = True
                req.status = DONE
                req.t_admit = req.t_first_token = req.t_done = self._now()
                self.finished.append(req)
                continue
            return req, len(req.prompt), budget
        return None

    # -- iteration loop --------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: (scheduler-gated) admission + chunked
        prefill continuation + one decode step over the slot pool.  Returns
        the number of occupied slots."""
        if self.ecfg.fused:
            return self._step_fused()
        return self._step_host()

    def _step_fused(self) -> int:
        t0 = time.perf_counter()
        calls0 = self.prefill_calls
        if self._prefill_allowed():
            if self.ecfg.packed:
                self._admit_packed()
            else:
                self._admit_fused()
        dt = time.perf_counter() - t0
        self.prefill_time += dt
        if self.prefill_calls > calls0:
            self.scheduler.observe_prefill(dt)
        occupied = self.pool.occupied()
        if occupied == len(self.pool.prefilling):
            # no live slot: nothing to decode
            self._stall_tokens = 0
            return occupied
        tr = self.ecfg.trace
        td0 = time.perf_counter() if tr else 0.0
        packed = self.executor.run("fused_step", self.pool)
        td1 = time.perf_counter() if tr else 0.0
        arr = self._fetch(packed)                 # ONE d2h transfer
        if tr:
            # dispatch (a graph replay on the card) is asynchronous: the
            # fetch waits on the step, so decode_s + d2h_s is its wall time
            td2 = time.perf_counter()
            self.trace.append({"prefill_s": dt, "decode_s": td1 - td0,
                               "d2h_s": td2 - td1, "step_s": td2 - t0,
                               "iters": int(arr.shape[0])})
        self.decode_steps += arr.shape[0]
        self.max_stall_tokens = max(self.max_stall_tokens, self._stall_tokens)
        self._stall_tokens = 0
        now = self._now()
        for it in range(arr.shape[0]):            # decode_chunk iterations
            self.active_slot_hist[int((arr[it, 0] >= 0).sum())] += 1
            for i, req in enumerate(self.pool.slot_req):
                if req is None or i in self.pool.prefilling:
                    continue
                if arr[it, 2, i]:                 # non-finite logits: frozen
                    self.pool.anomalies[i] += 1
                    if self.pool.anomalies[i] > self.ecfg.anomaly_retries:
                        self._fail(req, FAILED_ANOMALY, now)
                        self.pool.kill(i)
                    continue
                if arr[it, 0, i] < 0:
                    continue
                self.pool.anomalies[i] = 0
                tok = int(arr[it, 0, i])
                if not req.output:
                    req.t_first_token = now
                req.output.append(tok)
                if arr[it, 1, i]:
                    req.done = True
                    req.status = DONE
                    req.t_done = now
                    self.finished.append(req)
                    self.pool.release(i)     # slot freed → continuous batching
        return self.pool.occupied()

    def _step_host(self) -> int:
        """The host-looped step (``fused=False`` baseline): decode, then
        sampling and bookkeeping on the host, one round trip a token."""
        t0 = time.perf_counter()
        calls0 = self.prefill_calls
        if self._prefill_allowed():
            self._admit_host()
        dt = time.perf_counter() - t0
        self.prefill_time += dt
        if self.prefill_calls > calls0:
            self.scheduler.observe_prefill(dt)
        live = [i for i, r in enumerate(self.pool.slot_req) if r is not None]
        if not live:
            return 0
        host = self.pool.ensure_host()
        self.active_slot_hist[len(live)] += 1
        tokens, pos = self._dev(host["last_token"]), self._dev(host["slot_pos"])
        tr = self.ecfg.trace
        td0 = time.perf_counter() if tr else 0.0
        logits, _ = self.executor.decode(self.pool.cache, tokens, pos)
        td1 = time.perf_counter() if tr else 0.0
        self.decode_steps += 1
        self.max_stall_tokens = max(self.max_stall_tokens, self._stall_tokens)
        self._stall_tokens = 0
        nxt = self.executor.sample_host(logits)
        if tr:
            # the host path's "d2h" is the sampling round trip that waits on
            # the decode, the same split as the fused path's
            td2 = time.perf_counter()
            self.trace.append({"prefill_s": dt, "decode_s": td1 - td0,
                               "d2h_s": td2 - td1, "step_s": td2 - t0, "iters": 1})
        now = self._now()
        for i in live:
            req = self.pool.slot_req[i]
            tok = int(nxt[i])
            if not req.output:
                req.t_first_token = now
            req.output.append(tok)
            host["last_token"][i] = tok
            host["slot_pos"][i] += 1
            host["slot_budget"][i] -= 1
            hit_eos = self.ecfg.eos_token >= 0 and tok == self.ecfg.eos_token
            if host["slot_budget"][i] <= 0 or hit_eos or \
                    host["slot_pos"][i] >= self.ecfg.kv_len:
                req.done = True
                req.status = DONE
                req.t_done = now
                self.finished.append(req)
                self.pool.release(i)     # slot freed → continuous batching
        return self.pool.occupied()

    def run_until_drained(self, max_iters: int = 10_000) -> list[Request]:
        """Step until every request reaches a terminal state; exhausting
        ``max_iters`` marks the stranded requests and raises
        ``EngineStallError``."""
        it = 0
        while self.queue or any(r is not None for r in self.pool.slot_req):
            self.step()
            it += 1
            if it > max_iters:
                now = self._now()
                stranded = list(self.queue) + [r for r in self.pool.slot_req
                                               if r is not None]
                for req in self.queue:
                    self._fail(req, FAILED_MAX_ITERS, now)
                self.queue.clear()
                for i, req in enumerate(self.pool.slot_req):
                    if req is not None:
                        self._fail(req, FAILED_MAX_ITERS, now)
                        self.pool.kill(i)
                raise EngineStallError(
                    f"engine did not drain in {max_iters} iterations; "
                    f"{len(stranded)} request(s) marked {FAILED_MAX_ITERS}")
        return self.finished

    # -- admission: packed ragged prefill + chunked continuation ---------------
    def _admit_packed(self):
        B, C = self.ecfg.max_batch, self._chunk
        if self.pool.prefilling:
            self._continue_chunks()
        free = self.pool.free_slots()
        if not free or not self.queue:
            return

        segs = []                      # (req, slot, off, take, final, budget)
        used = 0
        while free and used < C:
            nxt = self._pop_admissible()
            if nxt is None:
                break
            req, plen, budget = nxt
            if plen > C - used and used > 0:
                # the whole prompt doesn't fit the rest of the stream: don't
                # fragment it — re-queue at the head, admit next iteration
                self.queue.appendleft(req)
                break
            take = min(plen, C - used)
            slot = free.pop(0)
            segs.append((req, slot, used, take, take == plen, budget))
            used += take
        if not segs:
            return

        toks = np.zeros((1, C), np.int32)
        seg = np.full((1, C), -1, np.int32)
        pos = np.zeros((1, C), np.int32)
        gather = np.zeros((B,), np.int32)
        len_v = np.zeros((B,), np.int32)
        fin_v = np.zeros((B,), bool)
        bud_v = np.ones((B,), np.int32)
        act_v = np.zeros((B,), bool)
        t_adm = self._now()
        for req, slot, off, take, final, budget in segs:
            req.t_admit = t_adm
            toks[0, off:off + take] = req.prompt[:take]
            seg[0, off:off + take] = slot
            pos[0, off:off + take] = np.arange(take)
            gather[slot] = off + take - 1
            len_v[slot] = take
            fin_v[slot], bud_v[slot], act_v[slot] = final, budget, True

        first = self.executor.run("packed_prefill", self.pool, toks, pos, seg, gather,
                                  len_v, fin_v, bud_v, act_v)
        arr = self._fetch(first)                  # one d2h per admission burst
        self.prefill_tokens += used
        self.prefill_calls += 1
        self._stall_tokens += used
        now = self._now()
        for req, slot, off, take, final, budget in segs:
            req.status = ACTIVE
            if final:
                req.output = [int(arr[slot])]
                req.t_first_token = now
                if budget == 1:     # the prefill sample was the whole budget
                    req.done = True
                    req.status = DONE
                    req.t_done = now
                    self.finished.append(req)
                    continue
                self.pool.slot_req[slot] = req
            else:                   # long prompt: first chunk only
                self.pool.slot_req[slot] = req
                self.pool.prefilling[slot] = (take, budget)

    def _continue_chunks(self):
        """Advance every mid-prefill slot by one <= C-token chunk (one
        batched call), activating rows whose prompt completed."""
        B, C = self.ecfg.max_batch, self._chunk
        toks = np.zeros((B, C), np.int32)
        pos = np.full((B, C), -1, np.int32)
        take_idx = np.zeros((B,), np.int32)
        fin_v = np.zeros((B,), bool)
        bud_v = np.ones((B,), np.int32)
        plan = []                                  # (slot, start, c, budget)
        for slot, (start, budget) in self.pool.prefilling.items():
            req = self.pool.slot_req[slot]
            plen = len(req.prompt)
            c = min(plen - start, C)
            toks[slot, :c] = req.prompt[start:start + c]
            pos[slot, :c] = start + np.arange(c)
            take_idx[slot] = c - 1
            fin_v[slot] = start + c == plen
            bud_v[slot] = budget
            plan.append((slot, start, c, budget))

        first = self.executor.run("chunk_step", self.pool, toks, pos, take_idx, fin_v,
                                  bud_v)
        arr = self._fetch(first)
        self.prefill_tokens += sum(c for _, _, c, _ in plan)
        self.prefill_calls += 1
        self._stall_tokens += C                    # one batched chunk call
        now = self._now()
        for slot, start, c, budget in plan:
            req = self.pool.slot_req[slot]
            if start + c == len(req.prompt):       # prompt complete
                del self.pool.prefilling[slot]
                req.output = [int(arr[slot])]
                req.t_first_token = now
                if budget == 1:
                    req.done = True
                    req.status = DONE
                    req.t_done = now
                    self.finished.append(req)
                    self.pool.release(slot)
            else:
                self.pool.prefilling[slot] = (start + c, budget)

    # -- admission: sequential baselines ---------------------------------------
    def _next_request(self, slot: int) -> Optional[tuple]:
        """Pop the next admissible queued request and its right-padded
        prompt (a power-of-two bucket where the stack allows it), or None."""
        if self.pool.slot_req[slot] is not None:
            return None
        nxt = self._pop_admissible()
        if nxt is None:
            return None
        req, plen, budget = nxt
        pad = _bucket_len(plen, self.ecfg.kv_len) if self._bucketed else plen
        toks = np.zeros((1, pad), np.int32)
        toks[0, :plen] = req.prompt
        return req, toks, plen, budget

    def _admit_fused(self):
        """Sequential admission on the fused path (``packed=False``)."""
        for slot in range(self.ecfg.max_batch):
            nxt = self._next_request(slot)
            if nxt is not None:
                self._admit_one(slot, *nxt)

    def _admit_one(self, slot: int, req, toks, plen: int, budget: int):
        """One right-padded batch-1 prefill+insert call and its bookkeeping."""
        req.t_admit = self._now()
        _, _, first = self.executor.prefill_insert(
            self.pool.cache, self.pool.state, self._dev(toks), slot, plen, budget)
        tok = int(self._fetch(first))
        self.prefill_tokens += plen
        self.prefill_calls += 1
        self._stall_tokens += toks.shape[1]
        req.output = [tok]
        req.t_first_token = self._now()
        if budget == 1:             # the prefill sample was the whole budget
            req.done = True
            req.status = DONE
            req.t_done = req.t_first_token
            self.finished.append(req)
        else:
            req.status = ACTIVE
            self.pool.slot_req[slot] = req

    def _admit_host(self):
        """Sequential admission of the host-looped baseline (``fused=False``):
        prefill, insert and sampling as separate calls."""
        host = self.pool.ensure_host()
        for slot in range(self.ecfg.max_batch):
            nxt = self._next_request(slot)
            if nxt is None:
                continue
            req, toks, plen, budget = nxt
            req.t_admit = self._now()
            logits, pcache = self.executor.prefill(self._dev(toks), plen)
            self.executor.insert(self.pool.cache, pcache, slot, plen)
            first = self.executor.sample_host(logits)
            self.prefill_tokens += plen
            self.prefill_calls += 1
            self._stall_tokens += toks.shape[1]
            req.output = [int(first[0])]
            req.t_first_token = self._now()
            if budget == 1:         # the prefill sample was the whole budget
                req.done = True
                req.status = DONE
                req.t_done = req.t_first_token
                self.finished.append(req)
                continue
            req.status = ACTIVE
            self.pool.slot_req[slot] = req
            host["slot_pos"][slot] = plen
            host["slot_budget"][slot] = budget - 1
            host["last_token"][slot] = int(first[0])

    # -- stats ---------------------------------------------------------------
    def _failure_stats(self) -> dict:
        by_status = collections.Counter(r.status for r in self.failed)
        return {
            "failed": len(self.failed),
            "failed_anomaly": by_status.get(FAILED_ANOMALY, 0),
            "failed_max_iters": by_status.get(FAILED_MAX_ITERS, 0),
            # the reference's bounded queue, deadlines and checkpoints have
            # no port yet: their counters stay 0, kept for key parity
            "rejected": 0,
            "failed_deadline": 0,
            "checkpoints_written": 0,
            "restores": 0,
            "replayed_requests": 0,
        }

    def stats(self) -> dict:
        done = self.finished
        if not done:
            return {"finished": 0, **self._failure_stats()}
        lat = [r.t_done - r.t_enqueue for r in done]
        ttft = [r.t_first_token - r.t_enqueue for r in done]
        tpot = [(r.t_done - r.t_first_token) / (len(r.output) - 1)
                for r in done if len(r.output) > 1]
        qwait = [r.t_admit - r.t_enqueue for r in done if r.t_admit > 0.0]
        lat_p, ttft_p = _percentiles(lat), _percentiles(ttft)
        tpot_p, qwait_p = _percentiles(tpot), _percentiles(qwait)
        toks = sum(len(r.output) for r in done)
        span = max(r.t_done for r in done) - min(r.t_enqueue for r in done)
        # measured per-iteration wall clock, present only when tracing
        trace: dict = {}
        if self.ecfg.trace:
            steps = [t["decode_s"] + t["d2h_s"] for t in self.trace]
            step_p = _percentiles(steps)
            trace = {
                "trace_iterations": len(self.trace),
                "trace_prefill_s": float(sum(t["prefill_s"] for t in self.trace)),
                "trace_decode_s": float(sum(t["decode_s"] for t in self.trace)),
                "trace_d2h_s": float(sum(t["d2h_s"] for t in self.trace)),
                # one decode iteration's wall time: dispatch plus the fetch
                # that waits on it
                "trace_decode_step_s": float(np.mean(steps)) if steps else None,
                "trace_decode_step_p50_s": step_p[0],
                "trace_decode_step_p95_s": step_p[1],
            }
        return {
            "finished": len(done),
            "tokens": toks,
            "tokens_per_s": toks / max(span, 1e-9),
            "mean_latency_s": float(np.mean(lat)),
            "mean_ttft_s": float(np.mean(ttft)),
            "mean_tpot_s": float(np.mean(tpot)) if tpot else None,
            "mean_queue_wait_s": float(np.mean(qwait)) if qwait else None,
            "latency_p50_s": lat_p[0],
            "latency_p95_s": lat_p[1],
            "latency_p99_s": lat_p[2],
            "ttft_p50_s": ttft_p[0],
            "ttft_p95_s": ttft_p[1],
            "ttft_p99_s": ttft_p[2],
            "tpot_p50_s": tpot_p[0],
            "tpot_p95_s": tpot_p[1],
            "tpot_p99_s": tpot_p[2],
            "queue_wait_p50_s": qwait_p[0],
            "queue_wait_p95_s": qwait_p[1],
            "queue_wait_p99_s": qwait_p[2],
            "decode_steps": self.decode_steps,
            "host_transfers": self.host_transfers,
            "host_bytes": self.host_bytes,
            "host_bytes_per_token": self.host_bytes / max(toks, 1),
            "prefill_tokens": self.prefill_tokens,
            "prefill_calls": self.prefill_calls,
            "prefill_time_s": self.prefill_time,
            "prefill_tokens_per_s": self.prefill_tokens / max(self.prefill_time, 1e-9),
            "max_stall_tokens": self.max_stall_tokens,
            "prompt_lens": [len(r.prompt) for r in done],
            "gen_lens": [len(r.output) for r in done],
            "prefill_chunk": self._chunk,
            "max_batch": self.ecfg.max_batch,
            "weight_bits": self.ecfg.weight_bits or 16,
            "kv_bits": self.ecfg.kv_bits or 16,
            "active_slots_hist": dict(sorted(self.active_slot_hist.items())),
            **trace,
            **self._failure_stats(),
        }
