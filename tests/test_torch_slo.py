"""The port's SLO plane, front end and workload generator against the
reference's, live, on the CPU (the counterparts of ``tests/test_scheduler.py``,
``tests/test_serving.py``'s deadline and bounded-queue cases and
``tests/test_layering.py``'s scheduler, frontend and workload cases).

The schedulers are driven over the same fake request records; the engines
(reduced qwen2.5-3b, the reference's f32 weights, ``impl="ref"``) on the
same injected fake clock, so deadlines and arrivals fall on the same
iterations in both: statuses, timestamps, schedules and token counts must
be equal.  Tokens are compared where the plain streams are (the two
packages' greedy streams may part at an exact tie, which
``tests/test_torch_serving.py`` checks).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import transformer as TJ
from repro.serving import scheduler as RS
from repro.serving import workload as RW
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.frontend import ServingFrontend as JaxFrontend
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.serving import scheduler as TS
from repro_torch.serving import workload as TW
from repro_torch.serving.engine import (DONE, FAILED_DEADLINE, REJECTED, EngineConfig,
                                        ServingEngine)
from repro_torch.serving.frontend import ServingFrontend

SETTINGS = dict(max_batch=3, kv_len=48, max_new_tokens=6, impl="ref")


# -- the schedulers over fake requests ---------------------------------------------

@dataclasses.dataclass
class FakeReq:
    """The Request-shaped view a scheduler may read."""
    uid: int
    priority: int = 0
    t_enqueue: float = 0.0
    t_first_token: float = 0.0
    output: list = dataclasses.field(default_factory=list)


def _drain_order(sched, specs, now):
    """The engine's selection loop (select, pop, until empty) over requests
    (uid, priority, t_enqueue)."""
    q = [FakeReq(uid=u, priority=p, t_enqueue=t) for u, p, t in specs]
    order = []
    while q:
        idx = sched.select(q, now)
        if idx is None:
            break
        order.append(q.pop(idx).uid)
    return order


def _both(name, **kw):
    """The reference's scheduler ``name`` and the port's, built alike (SLO
    classes given as (ttft_ms, tpot_ms) pairs)."""
    out = []
    for mod in (RS, TS):
        args = dict(kw)
        if "classes" in kw:
            args["classes"] = {p: mod.SloClass(*c) for p, c in kw["classes"].items()}
        if "default" in kw:
            args["default"] = mod.SloClass(*kw["default"])
        out.append(getattr(mod, name)(**args))
    return out


SELECTIONS = {
    "fifo ignores priority": ("FifoScheduler", {}, [(0, 0, 0.0), (1, 5, 0.0), (2, 9, 0.0)], 1.0),
    "priority, then fifo": ("SloScheduler", {}, [(0, 0, 0.0), (1, 2, 0.1), (2, 1, 0.2),
                                                 (3, 2, 0.3)], 1.0),
    "equal priority is fifo": ("SloScheduler", {}, [(0, 1, 0.0), (1, 1, 0.1), (2, 1, 0.2)],
                               1.0),
    "one class: fifo": ("SloScheduler", dict(classes={1: (100.0,), 2: (5000.0,)}),
                        [(0, 2, 0.0), (1, 2, 0.01)], 1.0),
    "priority before slack": ("SloScheduler", dict(classes={1: (100.0,), 2: (5000.0,)}),
                              [(0, 2, 0.0), (1, 1, 0.01)], 1.0),
    "slack orders a level": ("SloScheduler", dict(default=(5000.0,), classes={3: (100.0,)}),
                             [(0, 3, 0.0), (1, 3, 0.5), (2, 0, 0.2)], 1.0),
    "aged a level": ("SloScheduler", dict(aging_s=1.0), [(0, 0, 0.0), (1, 2, 9.9)], 1.0),
    "aged past": ("SloScheduler", dict(aging_s=1.0), [(0, 0, 0.0), (1, 2, 9.9)], 10.0),
    "no aging starves": ("SloScheduler", dict(aging_s=0.0), [(0, 0, 0.0), (1, 2, 1e6)],
                         1e6 + 1.0),
}


@pytest.mark.parametrize("case", sorted(SELECTIONS))
def test_selection_matches_reference(case):
    name, kw, specs, now = SELECTIONS[case]
    ref, port = _both(name, **kw)
    assert _drain_order(port, specs, now) == _drain_order(ref, specs, now)
    assert port.select([], now) is None


def _decoding(due_in_s, now, tpot_ms=50.0, priority=1):
    """One decoding request whose next token is due in ``due_in_s``."""
    n_out = 4
    return [FakeReq(uid=0, priority=priority,
                    t_first_token=now + due_in_s - n_out * tpot_ms / 1e3, output=[0] * n_out)]


GATES = {
    "slack absorbs the stall": (dict(classes={1: (math.inf, 50.0)}), [0.010], [0.040]),
    "slack too thin": (dict(classes={1: (math.inf, 50.0)}), [0.030], [0.005]),
    "no tpot target": ({}, [10.0], [0.001]),
    "deferral bounded": (dict(classes={1: (math.inf, 50.0)}, max_defer=3), [0.5],
                         [0.001] * 8),
    "allow resets the count": (dict(classes={1: (math.inf, 50.0)}, max_defer=3), [0.020],
                               [0.001, 0.100, 0.001, 0.001, 0.001]),
    "ewma of bursts": (dict(ewma=0.5, classes={1: (math.inf, 50.0)}), [0.100, 0.020, 0.020],
                       [0.030, 0.050]),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_prefill_gating_matches_reference(case):
    """The same bursts observed, then the same decisions, stall estimates
    and snapshot state; a fresh port scheduler loaded with that state
    decides on as the first does."""
    kw, bursts, dues = GATES[case]
    ref, port = _both("SloScheduler", **kw)
    now = 100.0
    for s in (ref, port):
        for b in bursts:
            s.observe_prefill(b)
    assert port._stall_est_s == ref._stall_est_s
    half = len(dues) // 2
    got = [port.allow_prefill(_decoding(d, now), now) for d in dues[:half]]
    want = [ref.allow_prefill(_decoding(d, now), now) for d in dues]
    fresh = _both("SloScheduler", **kw)[1]
    fresh.load_state_dict(port.state_dict())
    got += [fresh.allow_prefill(_decoding(d, now), now) for d in dues[half:]]
    assert got == want
    assert fresh.state_dict() == ref.state_dict()


def test_fifo_state_and_protocol():
    fifo, slo = TS.FifoScheduler(), TS.SloScheduler()
    assert fifo.state_dict() == RS.FifoScheduler().state_dict() == {}
    fifo.load_state_dict({})
    assert isinstance(fifo, TS.Scheduler) and isinstance(slo, TS.Scheduler)
    assert all(fifo.allow_prefill(_decoding(0.0, 1.0), 99.0) for _ in range(32))


@pytest.mark.parametrize("kw", [dict(max_defer=0), dict(ewma=0.0), dict(ewma=1.5)])
def test_scheduler_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        RS.SloScheduler(**kw)
    with pytest.raises(ValueError) as got:
        TS.SloScheduler(**kw)
    assert str(got.value) == str(want.value)


# -- the engines on a fake clock --------------------------------------------------

class FakeClock:
    """An injectable ``EngineConfig(clock=)``: advances by ``auto`` at each
    reading; ``sleep`` advances it too (at least 1 ms)."""

    def __init__(self, t: float = 100.0, auto: float = 0.0):
        self.t, self.auto = t, auto
        self.sleeps: list[float] = []

    def __call__(self) -> float:
        self.t += self.auto
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def sleep(self, dt: float) -> None:
        self.sleeps.append(dt)
        self.t += max(dt, 1e-3)


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_reduce_config(jax_get_config("qwen2.5-3b"))
    params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    cfg_t = reduce_config(get_config("qwen2.5-3b"))
    return cfg_j, params_j, cfg_t, params_from_jax(jax.device_get(params_j), cfg_t,
                                                   device="cpu", dtype=torch.float32)


def _engines(model, *, scheduler=None, clock_kw=None, **kw):
    """[(the reference's engine, its clock), (the port's, its clock)], each
    on a fake clock of its own; ``scheduler(module)`` builds each one's
    scheduler from its package's scheduler module."""
    cfg_j, params_j, cfg_t, params_t = model
    cj, ct = FakeClock(**(clock_kw or {})), FakeClock(**(clock_kw or {}))
    ref = JaxServingEngine(cfg_j, params_j, JaxEngineConfig(**dict(SETTINGS, clock=cj, **kw)),
                           scheduler=scheduler(RS) if scheduler else None)
    port = ServingEngine(cfg_t, params_t, EngineConfig(**dict(SETTINGS, clock=ct, **kw)),
                         scheduler=scheduler(TS) if scheduler else None, device="cpu")
    return [(ref, cj), (port, ct)]


def _timeline(reqs):
    return [(r.uid, r.status, len(r.output), r.t_enqueue, r.t_admit, r.t_first_token,
             r.t_done) for r in reqs]


def test_bounded_queue_sheds_like_reference(model):
    """``max_queue``: overload is shed as retriable REJECTED at submit,
    admitted requests still finish, every request ends terminal."""
    timelines = []
    for eng, _ in _engines(model, max_batch=1, max_new_tokens=2, max_queue=2):
        reqs = [eng.submit(np.asarray([1, 2, 3])) for _ in range(5)]
        assert [r.status for r in reqs].count(REJECTED) == 3
        eng.run_until_drained()
        assert all(r.terminal for r in reqs)
        assert all(r.output == [] for r in reqs if r.status == REJECTED)
        s = eng.stats()
        assert s["rejected"] == 3 and s["finished"] == 2
        timelines.append(_timeline(reqs))
    assert timelines[1] == timelines[0]


def test_deadline_expires_queued_request_like_reference(model):
    for eng, clock in _engines(model, max_batch=1, deadline_ms=20):
        r = eng.submit(np.asarray([1, 2, 3]))
        clock.advance(0.05)
        eng.step()
        assert r.status == FAILED_DEADLINE and r.terminal
        assert not eng.queue and all(x is None for x in eng.pool.slot_req)
        assert eng.stats()["failed_deadline"] == 1 and r.t_done == clock.t


def test_deadline_evicts_mid_decode_like_reference(model):
    """A clock that advances 5 ms a reading and a 110 ms deadline: the
    first two requests finish, the others are evicted mid-decode (and in
    the queue) on the same iterations of both engines, with as many
    tokens."""
    timelines = []
    for eng, _ in _engines(model, max_batch=2, deadline_ms=110, max_new_tokens=6,
                           clock_kw=dict(auto=0.005)):
        rng = np.random.default_rng(5)
        reqs = [eng.submit(rng.integers(0, 256, size=n)) for n in (4, 7, 3, 9, 5)]
        eng.run_until_drained()
        st = eng.stats()
        assert st["failed_deadline"] > 0 and st["finished"] > 0
        assert st["failed_deadline"] + st["finished"] == len(reqs)
        assert any(0 < len(r.output) < 6 for r in reqs if r.status == FAILED_DEADLINE)
        timelines.append(_timeline(reqs))
    assert timelines[1] == timelines[0]


def _drain_six(eng):
    rng = np.random.default_rng(11)
    reqs = [eng.submit(rng.integers(0, 256, size=n)) for n in (5, 23, 9, 12, 3, 17)]
    eng.run_until_drained()
    return _timeline(reqs), [r.output for r in reqs]


def test_slo_scheduler_without_targets_matches_fifo(model):
    """``SloScheduler()`` with no targets and uniform priority is FIFO, and
    an explicit ``FifoScheduler()`` is the default: the port's streams and
    timelines equal those of its default engine, and the timeline the
    reference's SLO engine's."""
    clock_kw = dict(auto=0.001)
    (ref, _), (port, _) = _engines(model, scheduler=lambda m: m.SloScheduler(),
                                   clock_kw=clock_kw)
    ref_slo, port_slo = _drain_six(ref), _drain_six(port)
    assert port_slo[0] == ref_slo[0]
    default = _drain_six(_engines(model, clock_kw=clock_kw)[1][0])
    explicit = _drain_six(_engines(model, scheduler=lambda m: m.FifoScheduler(),
                                   clock_kw=clock_kw)[1][0])
    assert port_slo == default == explicit


def test_slo_classes_order_admission_like_reference(model):
    """Two priority classes with TTFT targets on a clock that advances 2 ms
    a reading: the same admission order and timestamps as the reference's
    engine.  (TPOT targets gate prefill on the measured wall time of
    admission bursts, which two engines do not share: the gating is held
    against the reference's above, scheduler to scheduler.)"""
    def sched(mod):
        return mod.SloScheduler({1: mod.SloClass(ttft_ms=30.0),
                                 0: mod.SloClass(ttft_ms=300.0)})
    timelines = []
    for eng, _ in _engines(model, scheduler=sched, max_batch=2, prefill_chunk=8,
                           clock_kw=dict(auto=0.002)):
        rng = np.random.default_rng(2)
        reqs = [eng.submit(rng.integers(0, 256, size=n), priority=p)
                for n, p in ((12, 0), (5, 0), (20, 1), (4, 1), (9, 0), (6, 1))]
        eng.run_until_drained()
        timelines.append(_timeline(reqs))
        assert eng.stats()["finished"] == len(reqs)
    assert timelines[1] == timelines[0]
    admitted = [uid for uid, *_ in sorted(timelines[1], key=lambda t: (t[4], t[0]))]
    assert admitted != sorted(admitted)          # the classes reordered admission


# -- the front end ---------------------------------------------------------------

def _frontends(model, **kw):
    """[(the reference's front end, its clock), (the port's, its clock)]."""
    (ref, cj), (port, ct) = _engines(model, **kw)
    return [(JaxFrontend(ref, sleep=cj.sleep), cj), (ServingFrontend(port, sleep=ct.sleep), ct)]


def test_frontend_streams_tokens_incrementally_like_reference(model):
    seen_by = []
    for fe, _ in _frontends(model, max_batch=2, max_new_tokens=5):
        rng = np.random.default_rng(2)
        seen = []
        streams = [fe.submit(rng.integers(0, 256, size=5),
                             on_token=lambda st, tok: seen.append((st.uid, tok)))
                   for _ in range(3)]
        assert fe.drain() == streams
        for st in streams:
            assert st.done and st.status == DONE
            assert st.tokens == st.request.output and len(st.tokens) == 5
        for uid in (0, 1, 2):       # each stream's callbacks, in order
            assert [t for u, t in seen if u == uid] == streams[uid].tokens
        seen_by.append([u for u, _ in seen])
    assert seen_by[1] == seen_by[0]   # delivered in the same interleaving


def test_stream_iterator_pumps_to_completion(model):
    fe = _frontends(model, max_batch=1, max_new_tokens=4)[1][0]
    rng = np.random.default_rng(3)
    a = fe.submit(rng.integers(0, 256, size=4))
    b = fe.submit(rng.integers(0, 256, size=4))
    got_a = list(a)                   # iterating drives the engine
    assert got_a == a.request.output and len(got_a) == 4
    assert list(b) == b.request.output and len(b.tokens) == 4


def test_frontend_rejected_stream_ends_immediately(model):
    fe = _frontends(model, max_batch=1, max_new_tokens=2, max_queue=1)[1][0]
    rng = np.random.default_rng(4)
    fe.submit(rng.integers(0, 256, size=4))
    shed = fe.submit(rng.integers(0, 256, size=4))
    assert shed.status == REJECTED and shed.done and list(shed) == []
    fe.drain()
    assert fe.engine.stats()["rejected"] == 1


def test_frontend_without_a_checkpointer_port():
    with pytest.raises(NotImplementedError, match="checkpointer"):
        ServingFrontend(object(), checkpointer=object())


@pytest.mark.parametrize("rate,batch", [(4.0, 2), (200.0, 1)])
def test_play_replays_a_workload_like_reference(model, rate, batch):
    """``play`` on a fake clock, at a rate the pool keeps up with and at one
    far beyond a slot's service: every arrival is submitted in arrival order
    no earlier than due, never a negative sleep, and the same sleeps,
    timestamps and token counts as the reference's front end."""
    wl = TW.make_workload(8, rate_rps=rate, seed=13, hi_fraction=0.5, min_len=4,
                          max_len=8, vocab=256, max_new_tokens=3)
    runs = []
    for fe, clock in _frontends(model, max_batch=batch, max_new_tokens=3):
        t0 = clock()
        streams = fe.play(wl)
        assert len(streams) == 8 and all(st.done and st.status == DONE for st in streams)
        assert all(len(st.tokens) == 3 for st in streams)
        uids = [st.request.uid for st in streams]
        assert uids == sorted(uids)
        by_t = sorted(wl, key=lambda a: a.t)
        assert [st.request.priority for st in streams] == [a.priority for a in by_t]
        assert all(st.request.t_enqueue >= t0 + a.t - 1e-9 for st, a in zip(streams, by_t))
        assert all(dt >= 0.0 for dt in clock.sleeps)
        runs.append((_timeline([st.request for st in streams]), clock.sleeps))
    assert runs[1] == runs[0]


# -- the workload generator --------------------------------------------------------

WORKLOADS = {
    "poisson": dict(n=12, rate_rps=3.0, seed=1),
    "bursty": dict(n=10, rate_rps=5.0, seed=2, kind="bursty", burst=3),
    "trace": dict(n=4, rate_rps=1.0, kind="trace", trace=[0.0, 0.5, 0.5, 2.0, 3.0]),
    "two classes, shared prefix": dict(n=20, rate_rps=8.0, seed=9, hi_fraction=0.3,
                                       hi_priority=2, min_len=6, max_len=30, vocab=1000,
                                       shared_prefix=4, max_new_tokens=7),
}


@pytest.mark.parametrize("case", sorted(WORKLOADS))
def test_make_workload_equals_reference(case):
    ref, port = RW.make_workload(**WORKLOADS[case]), TW.make_workload(**WORKLOADS[case])
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        assert (b.t, b.max_new_tokens, b.priority) == (a.t, a.max_new_tokens, a.priority)
        assert b.prompt.dtype == a.prompt.dtype and np.array_equal(b.prompt, a.prompt)


@pytest.mark.parametrize("kw", [dict(rate_rps=0.0), dict(kind="other"),
                                dict(kind="trace", trace=[1.0, 0.5]),
                                dict(kind="trace", trace=[0.0]),
                                dict(min_len=5, max_len=4), dict(shared_prefix=4),
                                dict(kind="bursty", burst=0)])
def test_workload_validation_matches_reference(kw):
    args = dict(dict(n=3, rate_rps=1.0), **kw)
    with pytest.raises(ValueError) as want:
        RW.make_workload(**args)
    with pytest.raises(ValueError) as got:
        TW.make_workload(**args)
    assert str(got.value) == str(want.value)
