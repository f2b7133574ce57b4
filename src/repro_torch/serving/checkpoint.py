"""Crash-safe serving (counterpart of the reference's
``serving/checkpoint.py``): snapshot and restore of a live engine's state,
with a bit-exact resume and journal replay.

The engine is a state machine over (device tensors, host bookkeeping):
the slot pool's KV cache (bf16 rows, or int8 / int4 codes and f32 scales
under ``kv_bits``), the draft model's pool, the fused path's per-slot
state, the sampling generator's state, the request objects in queue,
slots and terminal lists, chunked-prefill progress, the anomaly counters
and the counters ``stats()`` reports.  A snapshot holds all of it, so an
engine killed between any two ``step()`` calls restores to the state it
had, and every later token is the one the uninterrupted run gives: greedy
or sampled (the generator's state replays the same draws).

Storage layout (on ``repro_torch.ckpt``; the reference's format but for
the generator)::

    <ckpt_dir>/
      journal.jsonl          append-only admission journal (one fsync'd
                             line per accepted submit: uid, prompt, budget)
      snap_00000000/         versioned snapshot directories
        arrays.npz           every array leaf, dtype-exact (bf16 as bits)
        meta.json            bookkeeping + config echo + sha256 digest
      LATEST                 pointer file, rewritten last (commit point)

**The generator.**  Where the reference threads PRNG keys (its
``state/key`` and ``seed_key`` leaves), the port draws every sample from
one ``torch.Generator`` (``Executor.generator``), which each captured CUDA
graph holds.  Its state is the snapshot's ``generator`` leaf (a uint8
tensor: 16 bytes on a card, 5056 on the CPU) and goes back through
``set_state`` into the restored engine's own generator, after the engine
was built and its graphs captured: a new ``Generator`` object would not be
the one the graphs draw from.

**In place.**  The restored engine is built first, which captures its
graphs over a dead pool; then every cache, state and draft leaf is copied
into the tensors the pool already holds (``SlotPool.load_array_tree``),
because the graphs read them by address.

**Exactly once.**  Requests submitted after the last snapshot are not in
it; they are recovered from the journal: :func:`restore_engine` rewinds
the engine to the snapshot, then resubmits the journal tail (entries with
``uid >=`` the snapshot's next uid) in uid order.  The restored uid
counter reassigns the same uids and prefill is deterministic, so the
replayed requests give the tokens the uninterrupted run would have:
nothing lost (journal), nothing duplicated (requests the snapshot already
holds are skipped), nothing divergent (state and generator bit-exact).
Requests that finished between the snapshot and the crash rewind and
decode again to the same output.

Replay is bit-exact when the post-snapshot submits form one burst before
further ``step()`` calls, or when the bounded queue never sheds;
interleaving submits with steps across a bounded queue can shed
differently on replay (the retriable ``REJECTED`` contract covers that).
Deadlines are absolute engine-clock values: a process with another clock
origin shifts them, so crash-safe deadline serving injects a persistent
``EngineConfig(clock=)``.

Snapshot IO runs under ``ckpt.retry`` (a flaky store costs a late
snapshot, not a crash), and restore walks snapshots newest to oldest,
skipping any whose digest or format version fails, so a torn newest
snapshot degrades to the previous one.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import sys
import time
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import (atomic_save_dir, digest_arrays, flatten_tree, list_snapshots,
                              load_arrays, read_latest, retry, save_arrays, unflatten_tree)
from repro_torch.serving.engine import REJECTED, EngineConfig, Request, ServingEngine

FORMAT_VERSION = 1
SNAP_PREFIX = "snap_"
JOURNAL = "journal.jsonl"

# engine-config fields echoed into the snapshot; all but the operational
# policy knobs (deadline/shedding/quarantine budgets, free to change
# across a restart) must match at restore or the resumed token stream
# could not be bit-exact
_ECHO_FIELDS = ("max_batch", "kv_len", "max_new_tokens", "temperature",
                "eos_token", "impl", "seed", "fused", "packed",
                "prefill_chunk", "decode_chunk", "weight_bits",
                "weight_group", "kv_bits", "deadline_ms", "max_queue",
                "anomaly_retries", "spec_k", "spec_draft",
                "spec_draft_bits")
_POLICY_FIELDS = ("deadline_ms", "max_queue", "anomaly_retries")
# dataclass defaults, the comparison fallback for echo fields a snapshot
# written by an older engine does not carry (it ran with the default)
_ECFG_DEFAULTS = {f.name: f.default for f in dataclasses.fields(EngineConfig)}


def _warn(msg: str) -> None:
    print(f"serving.checkpoint: {msg}", file=sys.stderr)


# ---------------------------------------------------------------------------
# request (de)serialisation
# ---------------------------------------------------------------------------

def _req_to_dict(req: Request) -> dict:
    return {"uid": req.uid, "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": req.max_new_tokens,
            "priority": req.priority,
            "output": list(req.output), "done": req.done,
            "status": req.status, "deadline": req.deadline,
            "t_enqueue": req.t_enqueue, "t_admit": req.t_admit,
            "t_first_token": req.t_first_token,
            "t_done": req.t_done}


def _req_from_dict(d: dict) -> Request:
    # .get defaults keep priority-less snapshots restorable
    return Request(uid=int(d["uid"]),
                   prompt=np.asarray(d["prompt"], np.int32),
                   max_new_tokens=d["max_new_tokens"],
                   priority=int(d.get("priority", 0)),
                   output=list(d["output"]), done=bool(d["done"]),
                   status=d["status"], deadline=float(d["deadline"]),
                   t_enqueue=float(d["t_enqueue"]),
                   t_admit=float(d.get("t_admit", 0.0)),
                   t_first_token=float(d["t_first_token"]),
                   t_done=float(d["t_done"]))


def _engine_arrays(engine: ServingEngine) -> dict[str, torch.Tensor]:
    """Every array leaf of the engine as one flat dict of CPU tensors: the
    slot pool's serialization tree (``SlotPool.array_tree``) plus the
    sampling generator's state.  Leaves are copied with ``.to("cpu")``,
    not through the executor's ``fetch``, so a snapshot never perturbs the
    host-transfer counters the benchmarks read."""
    tree = dict(engine.pool.array_tree())
    tree["generator"] = engine.executor.generator.get_state()
    return flatten_tree(tree)


def _engine_meta(engine: ServingEngine) -> dict:
    return {
        "version": FORMAT_VERSION,
        "model": engine.cfg.name,
        "engine": {f: getattr(engine.ecfg, f) for f in _ECHO_FIELDS},
        "uid": engine._uid,
        "slot_req": [None if r is None else _req_to_dict(r)
                     for r in engine.pool.slot_req],
        "queue": [_req_to_dict(r) for r in engine.queue],
        "finished": [_req_to_dict(r) for r in engine.finished],
        "failed": [_req_to_dict(r) for r in engine.failed],
        "rejected": [_req_to_dict(r) for r in engine.rejected],
        **engine.pool.meta(),        # prefilling + slot_anomalies
        # the scheduler's state (SloScheduler's stall estimate and deferral
        # counter): restoring it keeps admissions after the restore in the
        # uninterrupted run's order
        "scheduler": (engine.scheduler.state_dict()
                      if hasattr(engine.scheduler, "state_dict") else {}),
        "counters": {
            "host_transfers": engine.host_transfers,
            "host_bytes": engine.host_bytes,
            "decode_steps": engine.decode_steps,
            "prefill_tokens": engine.prefill_tokens,
            "prefill_time": engine.prefill_time,
            "prefill_calls": engine.prefill_calls,
            "max_stall_tokens": engine.max_stall_tokens,
            "stall_tokens": engine._stall_tokens,
            "checkpoints_written": engine.checkpoints_written,
            "restores": engine.restores,
            "replayed_requests": engine.replayed_requests,
            "spec_steps": engine.spec_steps,
            "spec_drafted": engine.spec_drafted,
            "spec_accepted": engine.spec_accepted,
            "spec_committed": engine.spec_committed,
            "active_slot_hist": {str(k): int(v)
                                 for k, v in engine.active_slot_hist.items()},
        },
    }


def _meta_digest(arrays: dict, meta: dict) -> str:
    """Integrity hash binding the array leaves to the bookkeeping."""
    canon = json.dumps({k: v for k, v in meta.items() if k != "digest"}, sort_keys=True)
    return digest_arrays(arrays, extra=canon)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_engine(engine: ServingEngine, ckpt_dir: str, *, keep: int = 3,
                retries: int = 0, backoff_s: float = 0.05, sleep=time.sleep) -> str:
    """Snapshot the whole engine state atomically; returns the committed
    snapshot's path.  ``retries``/``backoff_s`` bound the transient-IO
    retry loop (``ckpt.retry``).  The files are fsync'd before the commit.
    ``engine.save_s`` records the snapshot's wall seconds: device-to-host
    copies, digest, write and fsync (of the last attempt)."""
    snaps = list_snapshots(ckpt_dir, SNAP_PREFIX)
    nxt = 1 + int(snaps[-1][len(SNAP_PREFIX):]) if snaps else 0
    name = f"{SNAP_PREFIX}{nxt:08d}"
    t0 = time.perf_counter()
    arrays = _engine_arrays(engine)
    t1 = time.perf_counter()
    # the snapshot counts itself, so a restore of it reports every snapshot
    # committed on its lineage (the increment is rolled back on failure)
    engine.checkpoints_written += 1
    meta = _engine_meta(engine)
    meta["digest"] = _meta_digest(arrays, meta)
    times = {"d2h_s": t1 - t0, "digest_s": time.perf_counter() - t1}

    def write(tmp: str) -> None:
        t = time.perf_counter()
        paths = [os.path.join(tmp, "arrays.npz"), os.path.join(tmp, "meta.json")]
        save_arrays(paths[0], arrays)
        with open(paths[1], "w") as f:
            json.dump(meta, f)
        times["write_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for p in paths:
            _fsync(p)
        times["fsync_s"] = time.perf_counter() - t

    try:
        path = retry(lambda: atomic_save_dir(ckpt_dir, name, write, prefix=SNAP_PREFIX,
                                             keep=keep),
                     retries=retries, backoff_s=backoff_s, sleep=sleep)
    except Exception:
        engine.checkpoints_written -= 1
        raise
    engine.save_s = times
    return path


# ---------------------------------------------------------------------------
# load + integrity walk
# ---------------------------------------------------------------------------

def _load_snapshot(path: str) -> tuple[dict, dict]:
    """(arrays, meta) of one snapshot dir; raises on any corruption:
    unreadable files, a version mismatch, or a digest that does not match
    the stored leaves and bookkeeping."""
    arrays = load_arrays(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"snapshot format v{meta.get('version')} != v{FORMAT_VERSION}")
    if meta.get("digest") != _meta_digest(arrays, meta):
        raise ValueError("integrity digest mismatch (torn or corrupt write)")
    return arrays, meta


def load_newest_intact(ckpt_dir: str) -> tuple[dict, dict, str]:
    """Walk snapshots newest to oldest (the ``LATEST`` pointer first) and
    return the first that passes the integrity checks.  A corrupt newest
    snapshot degrades to the previous one with a warning; no intact
    snapshot raises ``FileNotFoundError``."""
    names = list_snapshots(ckpt_dir, SNAP_PREFIX)
    order = list(reversed(names))
    latest = read_latest(ckpt_dir)
    if latest in names:
        order = [latest] + [n for n in order if n != latest]
    if not order:
        raise FileNotFoundError(f"no snapshot in {ckpt_dir}")
    last_err: Optional[Exception] = None
    for name in order:
        try:
            arrays, meta = _load_snapshot(os.path.join(ckpt_dir, name))
            return arrays, meta, name
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            _warn(f"skipping snapshot {name}: {e}")
            last_err = e
    raise FileNotFoundError(f"no intact snapshot in {ckpt_dir} (last error: {last_err})")


# ---------------------------------------------------------------------------
# restore + journal replay
# ---------------------------------------------------------------------------

def _check_config(meta: dict, cfg_name: str, ecfg: EngineConfig) -> None:
    if meta["model"] != cfg_name:
        raise ValueError(f"snapshot is of model {meta['model']!r}, restore got {cfg_name!r}")
    for f in _ECHO_FIELDS:
        if f in _POLICY_FIELDS:      # operational policy may change
            continue
        # a snapshot from an engine predating field f ran with its default
        snap_val = meta["engine"].get(f, _ECFG_DEFAULTS[f])
        if snap_val != getattr(ecfg, f):
            raise ValueError(
                f"engine config mismatch on {f!r}: snapshot has {snap_val!r}, restore got "
                f"{getattr(ecfg, f)!r} — a bit-exact resume needs the snapshot's value")


def _load_generator(gen: torch.Generator, state: torch.Tensor) -> None:
    """Put a snapshot's generator state into the engine's own generator, in
    place (the CUDA graphs hold that object).  A state of the other device
    type is refused: a card's is 16 bytes, the CPU's 5056."""
    want = gen.get_state().numel()
    if state.numel() != want:
        raise ValueError(f"snapshot generator state has {state.numel()} bytes, this engine's "
                         f"{gen.device.type} generator {want}: a snapshot restores on the "
                         f"device type that wrote it")
    gen.set_state(state.to(torch.uint8).contiguous())


def read_journal(ckpt_dir: str) -> list[dict]:
    """Parse the admission journal; a torn last line (a crash mid-append)
    is dropped, every complete line before it survives."""
    path = os.path.join(ckpt_dir, JOURNAL)
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                _warn("dropping torn journal tail line")
    return out


def restore_engine(cfg, params, ckpt_dir: str, *, ecfg: Optional[EngineConfig] = None,
                   device=None, mesh=None, scheduler=None, replay: bool = True,
                   draft=None) -> ServingEngine:
    """Revive a :class:`ServingEngine` from its newest intact snapshot.

    ``ecfg=None`` rebuilds the engine config from the snapshot's echo
    (default clock); an explicit ``ecfg`` must match the snapshot on every
    field that shapes state or sampling (the policy knobs
    ``deadline_ms``/``max_queue``/``anomaly_retries`` may differ).
    ``params`` are the caller's weights, as at the original construction
    (quantisation derives again deterministically); they are not part of
    the snapshot.  ``scheduler`` and ``draft`` go to the new engine as to
    the original.  With ``replay=True`` the journal's tail (requests
    submitted after the snapshot) is submitted again in uid order, and the
    restored counter gives each its original uid.  The engine runs on the
    card unless ``device="cpu"``.  ``engine.restore_s`` records the wall
    seconds of reading the snapshot, building the engine (its graphs
    captured) and loading the state."""
    t0 = time.perf_counter()
    arrays, meta, _ = load_newest_intact(ckpt_dir)
    if ecfg is None:
        ecfg = EngineConfig(**meta["engine"])
    _check_config(meta, cfg.name, ecfg)
    t1 = time.perf_counter()
    engine = ServingEngine(cfg, params, ecfg, device=device, mesh=mesh, scheduler=scheduler,
                           draft=draft)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t2 = time.perf_counter()

    host = any(k.startswith("host/") for k in arrays)
    tree = unflatten_tree(engine.pool.array_template(with_host=host), arrays, cast=False)
    if "generator" not in arrays:
        raise KeyError("checkpoint missing leaf 'generator'")
    engine.pool.load_array_tree(tree)
    _load_generator(engine.executor.generator, arrays["generator"])

    engine.pool.slot_req = [None if r is None else _req_from_dict(r) for r in meta["slot_req"]]
    engine.queue = collections.deque(_req_from_dict(r) for r in meta["queue"])
    engine.finished = [_req_from_dict(r) for r in meta["finished"]]
    engine.failed = [_req_from_dict(r) for r in meta["failed"]]
    engine.rejected = [_req_from_dict(r) for r in meta["rejected"]]
    engine.pool.load_meta(meta["prefilling"], meta["slot_anomalies"])
    engine._uid = int(meta["uid"])
    c = meta["counters"]
    engine.executor.host_transfers = c["host_transfers"]
    engine.executor.host_bytes = c["host_bytes"]
    engine.decode_steps = c["decode_steps"]
    engine.prefill_tokens = c["prefill_tokens"]
    engine.prefill_time = c["prefill_time"]
    engine.prefill_calls = c["prefill_calls"]
    engine.max_stall_tokens = c["max_stall_tokens"]
    engine._stall_tokens = c["stall_tokens"]
    engine.checkpoints_written = c["checkpoints_written"]
    engine.replayed_requests = c["replayed_requests"]
    engine.spec_steps = int(c.get("spec_steps", 0))
    engine.spec_drafted = int(c.get("spec_drafted", 0))
    engine.spec_accepted = int(c.get("spec_accepted", 0))
    engine.spec_committed = int(c.get("spec_committed", 0))
    engine.active_slot_hist = collections.Counter(
        {int(k): int(v) for k, v in c["active_slot_hist"].items()})
    engine.restores = c["restores"] + 1
    # scheduler state: .get keeps snapshots without one restorable (their
    # policies start cold)
    if hasattr(engine.scheduler, "load_state_dict"):
        engine.scheduler.load_state_dict(meta.get("scheduler", {}))

    if replay:
        tail = sorted((e for e in read_journal(ckpt_dir) if int(e["uid"]) >= engine._uid),
                      key=lambda e: int(e["uid"]))
        for entry in tail:
            req = engine.submit(np.asarray(entry["prompt"], np.int32), entry["max_new_tokens"],
                                priority=int(entry.get("priority", 0)))
            if req.uid != int(entry["uid"]):
                raise RuntimeError(f"journal replay desync: resubmit assigned uid {req.uid}, "
                                   f"journal recorded {entry['uid']}")
        engine.replayed_requests += len(tail)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    engine.restore_s = {"read_s": t1 - t0, "build_s": t2 - t1,
                        "load_s": time.perf_counter() - t2}
    return engine


# ---------------------------------------------------------------------------
# checkpointer: journal + periodic snapshots around one engine
# ---------------------------------------------------------------------------

class EngineCheckpointer:
    """Admission journal and snapshot writer for one engine.

    Route submits through :meth:`submit` so every accepted request reaches
    the append-only journal (fsync'd) before it can be lost with the
    process; call :meth:`save` at snapshot boundaries (between ``step()``
    calls: engine state is consistent only there).  ``every`` > 0 makes
    :meth:`maybe_save` snapshot each time that many engine iterations have
    passed since the last one."""

    def __init__(self, engine: ServingEngine, ckpt_dir: str, *, keep: int = 3,
                 every: int = 0, retries: int = 0, backoff_s: float = 0.05,
                 sleep=time.sleep):
        self.engine, self.ckpt_dir = engine, ckpt_dir
        self.keep, self.every = keep, every
        self.retries, self.backoff_s, self._sleep = retries, backoff_s, sleep
        self._steps_since = 0
        os.makedirs(ckpt_dir, exist_ok=True)

    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               priority: int = 0) -> Request:
        req = self.engine.submit(prompt, max_new_tokens, priority=priority)
        if req.status != REJECTED:       # shed requests are the caller's to
            #                              retry: never replayed
            with open(os.path.join(self.ckpt_dir, JOURNAL), "a") as f:
                f.write(json.dumps({"uid": req.uid, "prompt": [int(t) for t in req.prompt],
                                    "max_new_tokens": req.max_new_tokens,
                                    "priority": req.priority}) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return req

    def save(self) -> str:
        self._steps_since = 0
        return save_engine(self.engine, self.ckpt_dir, keep=self.keep, retries=self.retries,
                           backoff_s=self.backoff_s, sleep=self._sleep)

    def maybe_save(self) -> Optional[str]:
        """Call once per engine iteration; snapshots every ``every``-th."""
        self._steps_since += 1
        if self.every > 0 and self._steps_since >= self.every:
            return self.save()
        return None
