"""Batched serving engine: the wiring layer of the serving stack
(counterpart of the reference's ``serving/engine.py``).

Policy, device execution and slot lifecycle live in three sibling layers::

    scheduler.py   admission policy (Scheduler protocol: FifoScheduler,
                   the default, or SloScheduler)
    executor.py    the device programs (fused decode step or speculative
                   step, packed ragged prefill, chunked continuation) +
                   the single device→host transfer point
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
With ``spec_k > 0`` the speculative step (``spec_k`` draft steps, one
batched verify, acceptance and rollback) is captured in the fused step's
place and commits up to ``spec_k + 1`` tokens a slot a step; a draft
model's prompt prefill (``spec_draft="model"``) runs eagerly.

Hardening (defaults off): per-request deadlines (``deadline_ms``:
expired requests are evicted, queued or mid-decode, as
``FAILED_DEADLINE``), bounded-queue shedding (``max_queue``: the
retriable ``REJECTED``), the NaN/inf logit quarantine
(``anomaly_retries``) and ``EngineStallError`` from
``run_until_drained``.  Every submitted request ends in a terminal state.

``packed=False`` keeps the sequential admission baseline (one
bucket-padded batch-1 prefill+insert call per request) and
``fused=False`` the host-looped decode step: measurement baselines, run
eagerly on the card too.  ``trace=True`` records each decode iteration's
wall-clock split (``self.trace``, the ``trace_*`` keys of ``stats()``).

The engine serves fp or quantised (``weight_bits``/``weight_group``/
``kv_bits``).  :meth:`ServingEngine.restore` revives one from a snapshot
(``serving/checkpoint.py``: snapshots, the admission journal, replay).
A mesh (sharded serving) has no port yet: ``mesh=`` raises
``NotImplementedError``.  The engine runs on ``"cuda"`` unless
``device="cpu"`` is passed.
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
    deadline_ms: float = 0.0      # per-request TTL from submit (0 = none):
    #   expired requests are evicted (queued or mid-decode) as FAILED_DEADLINE
    max_queue: int = 0            # bounded admission queue (0 = unbounded):
    #   submits beyond it are shed with the retriable REJECTED status
    anomaly_retries: int = 1      # NaN/inf-logit quarantine: a slot whose
    #   logits go non-finite is frozen and retried this many times before
    #   only that request is failed
    spec_k: int = 0               # speculative decoding: draft this many
    #   tokens a step and verify them in one batched call (0 = off).  Needs
    #   the fused, packed path, decode_chunk 1, and spec_k+1 within the
    #   smallest cache ring (min(window, kv_len))
    spec_draft: str = "self"      # "self": a quantised copy of the serving
    #   params drafts (spec_draft_bits); "model": a separate draft model,
    #   ServingEngine(draft=(cfg, params)), with its own KV pool
    spec_draft_bits: int = 8      # self-draft precision (8 / 4; 0 = the
    #   serving params themselves: greedy acceptance 1)
    clock: Callable[[], float] = time.monotonic
    #   the engine's time source for request timestamps
    trace: bool = False           # per-iteration wall-clock tracer: each
    #   decode iteration appends {"prefill_s", "decode_s", "d2h_s",
    #   "step_s", "iters"} to ``ServingEngine.trace``; stats() adds trace_*
    #   keys only when tracing.  Durations are time.perf_counter's, not
    #   ``clock``'s


# prompt-length buckets of the sequential (packed=False) baseline
_MIN_BUCKET = 8


def _bucket_len(plen: int, kv_len: int) -> int:
    b = _MIN_BUCKET
    while b < plen:
        b *= 2
    return min(b, kv_len)


def _check_spec(cfg: ModelConfig, ecfg: EngineConfig, draft) -> None:
    """What speculative decoding needs of the configuration (the
    reference's checks and messages).  The port's stacks, a draft model's
    too, are all attention-only (``ModelConfig`` takes no other layer
    kind), which the verify's chunk pass needs."""
    if ecfg.spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {ecfg.spec_k}")
    if not (ecfg.fused and ecfg.packed):
        raise ValueError("speculative decoding requires the fused=True, packed=True path")
    if ecfg.decode_chunk != 1:
        raise ValueError("spec_k > 0 requires decode_chunk == 1 "
                         "(the spec step IS the multi-token step)")
    if ecfg.spec_draft not in ("self", "model"):
        raise ValueError(f"spec_draft must be 'self' or 'model', got {ecfg.spec_draft!r}")
    if ecfg.spec_draft_bits not in (0, 4, 8):
        raise ValueError(f"spec_draft_bits must be 0, 4 or 8, got {ecfg.spec_draft_bits}")
    caps = [ecfg.kv_len] + [cfg.window for k in cfg.layer_kinds if k == "local"]
    if ecfg.spec_k + 1 > min(caps):
        raise ValueError(
            f"spec_k+1 ({ecfg.spec_k + 1}) exceeds the smallest cache ring "
            f"({min(caps)}): the saved-column rollback needs unique ring indices")
    if ecfg.spec_draft == "model":
        if draft is None:
            raise ValueError("spec_draft='model' needs draft=(draft_cfg, draft_params)")
        if draft[0].vocab_size != cfg.vocab_size:
            raise ValueError(f"draft vocab ({draft[0].vocab_size}) != target vocab "
                             f"({cfg.vocab_size})")


class EngineStallError(RuntimeError):
    """``run_until_drained`` exhausted ``max_iters`` with requests still in
    flight; every stranded request was marked ``FAILED_MAX_ITERS`` first."""


# Request states (Request.status); a submitted request ends in exactly one
# of TERMINAL
QUEUED = "queued"
ACTIVE = "active"
DONE = "done"
FAILED_DEADLINE = "failed_deadline"    # missed its EngineConfig.deadline_ms
FAILED_ANOMALY = "failed_anomaly"      # non-finite logits past the retries
FAILED_MAX_ITERS = "failed_max_iters"  # stranded at max_iters exhaustion
REJECTED = "rejected"                  # shed at submit (bounded queue):
#                                        retriable, resubmit later
TERMINAL = (DONE, FAILED_DEADLINE, FAILED_ANOMALY, FAILED_MAX_ITERS, REJECTED)


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
    deadline: float = float("inf")           # absolute, on the engine clock
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL


def _percentiles(xs) -> tuple:
    """(p50, p95, p99) of a sample list; an empty class is (None,)*3."""
    if not xs:
        return (None, None, None)
    p = np.percentile(np.asarray(xs, np.float64), (50.0, 95.0, 99.0))
    return (float(p[0]), float(p[1]), float(p[2]))


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, ecfg: Optional[EngineConfig] = None,
                 *, device=None, scheduler: Optional[Scheduler] = None, mesh=None,
                 draft: Optional[tuple] = None):
        self.cfg = cfg
        self.ecfg = ecfg = ecfg if ecfg is not None else EngineConfig()
        if ecfg.weight_bits not in (0, 4, 8):
            raise ValueError(f"weight_bits must be 0, 4 or 8, got {ecfg.weight_bits}")
        if ecfg.kv_bits not in (0, 4, 8):
            raise ValueError(f"kv_bits must be 0, 4 or 8, got {ecfg.kv_bits}")
        if ecfg.spec_k:
            _check_spec(cfg, ecfg, draft)
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
        if ecfg.spec_k and ecfg.spec_draft == "model":
            self.executor.set_draft(*draft)
            self.pool.init_draft(draft[0])

        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self.failed: list[Request] = []      # deadline / anomaly / max_iters
        self.rejected: list[Request] = []    # shed at submit (retriable)
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
        # speculative decoding: steps, drafts proposed and accepted, tokens
        # committed (the accepted prefix plus the correction token, capped)
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        # crash safety (serving/checkpoint.py): snapshots committed on this
        # engine's lineage, times its state was revived, journal-tail
        # requests submitted again; the wall seconds of the last snapshot
        # (d2h_s, digest_s, write_s, fsync_s) and of the restore that built
        # this engine (read_s, build_s, load_s)
        self.checkpoints_written = 0
        self.restores = 0
        self.replayed_requests = 0
        self.save_s: dict = {}
        self.restore_s: dict = {}

        S = ecfg.kv_len
        self._chunk = min(ecfg.prefill_chunk or min(128, S), S)
        # pow2 bucketing (sequential baseline) is exact only where cache
        # index == token position: global layers, not rings
        self._bucketed = all(k == "global" for k in cfg.layer_kinds)
        if self.device.type == "cuda":
            # the programs this configuration runs, replayed from graphs
            decode = "spec_step" if ecfg.spec_k else "fused_step"
            programs = [name for name, used in (
                (decode, ecfg.fused), ("packed_prefill", ecfg.fused and ecfg.packed),
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
        now = self._now()
        req = Request(uid=self._uid, prompt=arr.astype(np.int32),
                      max_new_tokens=max_new_tokens, priority=int(priority),
                      t_enqueue=now)
        if self.ecfg.deadline_ms > 0:
            req.deadline = now + self.ecfg.deadline_ms / 1e3
        self._uid += 1
        if self.ecfg.max_queue > 0 and len(self.queue) >= self.ecfg.max_queue:
            # shed: returned REJECTED instead of enqueued
            req.status = REJECTED
            req.t_done = now
            self.rejected.append(req)
            return req
        self.queue.append(req)
        return req

    def _fail(self, req: Request, status: str, now: Optional[float] = None):
        req.status = status
        req.t_done = now if now is not None else self._now()
        self.failed.append(req)

    def _evict_expired(self):
        """Fail every queued or in-flight request past its deadline: expired
        work is dropped before it spends another admission or decode step,
        and its slot frees for a request that can still make it."""
        now = self._now()
        if self.queue:
            kept = collections.deque()
            for req in self.queue:
                if now > req.deadline:
                    self._fail(req, FAILED_DEADLINE, now)
                else:
                    kept.append(req)
            self.queue = kept
        for i, req in enumerate(self.pool.slot_req):
            if req is not None and now > req.deadline:
                self._fail(req, FAILED_DEADLINE, now)
                self.pool.kill(i)

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
        """One engine iteration: deadline eviction + (scheduler-gated)
        admission + chunked prefill continuation + one decode (or
        speculative) step over the slot pool.  Returns the number of
        occupied slots."""
        if self.ecfg.deadline_ms > 0:
            self._evict_expired()
        if self.ecfg.spec_k:
            return self._step_spec()
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

    def _step_spec(self) -> int:
        """One speculative iteration: admission (the packed path), then one
        draft + verify step over the slot pool, whose one device→host
        transfer, a packed ``(spec_k+1, 4, B)`` of (token | -1, done,
        anomaly, accepted), commits up to ``spec_k + 1`` tokens a slot."""
        t0 = time.perf_counter()
        calls0 = self.prefill_calls
        if self._prefill_allowed():
            self._admit_packed()
        dt = time.perf_counter() - t0
        self.prefill_time += dt
        if self.prefill_calls > calls0:
            self.scheduler.observe_prefill(dt)
        occupied = self.pool.occupied()
        if occupied == len(self.pool.prefilling):
            self._stall_tokens = 0
            return occupied
        tr = self.ecfg.trace
        td0 = time.perf_counter() if tr else 0.0
        packed = self.executor.run("spec_step", self.pool)
        td1 = time.perf_counter() if tr else 0.0
        arr = self._fetch(packed)                 # ONE d2h transfer
        if tr:
            td2 = time.perf_counter()
            self.trace.append({"prefill_s": dt, "decode_s": td1 - td0,
                               "d2h_s": td2 - td1, "step_s": td2 - t0, "iters": 1})
        self.decode_steps += 1                    # one target weight stream
        self.spec_steps += 1
        self.max_stall_tokens = max(self.max_stall_tokens, self._stall_tokens)
        self._stall_tokens = 0
        now = self._now()
        K = self.ecfg.spec_k
        self.active_slot_hist[int((arr[0, 0] >= 0).sum())] += 1
        for i, req in enumerate(self.pool.slot_req):
            if req is None or i in self.pool.prefilling:
                continue
            if arr[0, 2, i]:                      # non-finite verify logits:
                # every column restored, the state left: the fused step's retry
                self.pool.anomalies[i] += 1
                if self.pool.anomalies[i] > self.ecfg.anomaly_retries:
                    self._fail(req, FAILED_ANOMALY, now)
                    self.pool.kill(i)
                continue
            if arr[0, 0, i] < 0:
                continue
            self.pool.anomalies[i] = 0
            self.spec_drafted += K
            self.spec_accepted += int(arr[0, 3, i])
            for it in range(arr.shape[0]):        # the committed prefix, in order
                if arr[it, 0, i] < 0:
                    break
                tok = int(arr[it, 0, i])
                if not req.output:
                    req.t_first_token = now
                req.output.append(tok)
                self.spec_committed += 1
                if arr[it, 1, i]:
                    req.done = True
                    req.status = DONE
                    req.t_done = now
                    self.finished.append(req)
                    self.pool.release(i)
                    break
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
                self._draft_ingest(req, slot)
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
                    self._draft_ingest(req, slot)
            else:
                self.pool.prefilling[slot] = (start + c, budget)

    def _draft_ingest(self, req, slot: int) -> None:
        """With a draft model, mirror a completed prompt into its pool (one
        batch-1 draft prefill, right-padded to a chunk multiple, and an
        insert) so that the draft decodes with the target's context.  A
        self-draft shares the target's pool: nothing to do."""
        if self.pool.draft_cache is None:
            return
        plen = len(req.prompt)
        pad = min(-(-plen // self._chunk) * self._chunk, self.ecfg.kv_len)
        toks = np.zeros((1, pad), np.int32)
        toks[0, :plen] = req.prompt
        self.executor.draft_prefill(self.pool.draft_cache, self._dev(toks), slot, plen)

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

    # -- crash safety -----------------------------------------------------------
    @classmethod
    def restore(cls, cfg: ModelConfig, params, ckpt_dir: str, *,
                ecfg: Optional[EngineConfig] = None, device=None, mesh=None,
                scheduler: Optional[Scheduler] = None, replay: bool = True,
                draft: Optional[tuple] = None) -> "ServingEngine":
        """Revive an engine from its newest intact snapshot in ``ckpt_dir``
        (written by ``serving/checkpoint.py``), resuming bit for bit and
        submitting again the journal's requests from after the snapshot.
        See :func:`repro_torch.serving.checkpoint.restore_engine`."""
        from repro_torch.serving.checkpoint import restore_engine
        return restore_engine(cfg, params, ckpt_dir, ecfg=ecfg, device=device, mesh=mesh,
                              scheduler=scheduler, replay=replay, draft=draft)

    # -- stats ---------------------------------------------------------------
    def _failure_stats(self) -> dict:
        by_status = collections.Counter(r.status for r in self.failed)
        return {
            "failed": len(self.failed),
            "rejected": len(self.rejected),
            "failed_deadline": by_status.get(FAILED_DEADLINE, 0),
            "failed_anomaly": by_status.get(FAILED_ANOMALY, 0),
            "failed_max_iters": by_status.get(FAILED_MAX_ITERS, 0),
            "checkpoints_written": self.checkpoints_written,
            "restores": self.restores,
            "replayed_requests": self.replayed_requests,
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
        # speculative acceptance, present only when spec_k > 0: the
        # acceptance of a draft, and tokens committed a slot a step
        spec: dict = {}
        if self.ecfg.spec_k:
            drafted = self.spec_drafted
            spec = {
                "spec_k": self.ecfg.spec_k,
                "spec_draft": self.ecfg.spec_draft,
                "spec_draft_bits": self.ecfg.spec_draft_bits,
                "spec_steps": self.spec_steps,
                "spec_drafted": drafted,
                "spec_accepted": self.spec_accepted,
                "spec_committed": self.spec_committed,
                "spec_acceptance": self.spec_accepted / drafted if drafted else None,
                "spec_tokens_per_step": (self.spec_committed * self.ecfg.spec_k / drafted
                                         if drafted else None),
            }
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
            **spec,
            **trace,
            **self._failure_stats(),
        }
