"""The profiling plane of the port (``repro_torch.profile``) against the
reference's (``repro.profile``), live, on the CPU.

The timer, the fits, the table's JSON, the measured ``Calib`` and the
error report are the reference's code with its imports changed, so each
case runs both packages on the same inputs and compares with ``==``.
The samplers run the port's plain versions (``device="cpu"``) and the
reference's Pallas kernels in interpret mode, each under the same fake
clock: every ``Sample`` is then equal field by field, the measured
seconds included; on inputs drawn alike, each case's output is the
reference kernel's within the bf16 bound.  Without a card and without ``device="cpu"`` the port's
samplers raise.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.profile.bench as RB
import repro.profile.calibrate as RCa
import repro.profile.costmodel as RCo
import repro_torch.profile as TP
import repro_torch.profile.bench as TB
import repro_torch.profile.calibrate as TCa
import repro_torch.profile.costmodel as TCo
from repro.config import get_config as ref_config
from repro.config import reduce_config as ref_reduce
from repro.profile import __all__ as REF_ALL
from repro_torch.config import get_config as port_config
from repro_torch.config import reduce_config as port_reduce


class FakeClock:
    """Deterministic clock: each stop edge (every second call; ``measure``
    reads the clock twice a timed call) advances by the next scripted dt,
    or by a cycle of distinct dts once the script runs out."""

    def __init__(self, dts=()):
        self.t, self.dts, self.i = 0.0, list(dts), 0

    def __call__(self):
        if self.i % 2 == 1:
            self.t += self.dts.pop(0) if self.dts else 1e-3 * (1 + (self.i // 2) % 5)
        self.i += 1
        return self.t


def _fields(x):
    return dataclasses.asdict(x)


def test_the_package_exports_the_reference_names():
    assert TP.__all__ == REF_ALL


# ---------------------------------------------------------------------------
# (a) measure: the micro-timer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,repeat", [(1, 3), (2, 2), (3, 1), (1, 5)])
def test_measure_is_the_reference(warmup, repeat):
    dts = [0.5 / (i + 1) + 0.01 * i for i in range(warmup + repeat)]
    calls = {"port": 0, "ref": 0}

    def fn(who):
        def f():
            calls[who] += 1
        return f
    got = TB.measure(fn("port"), warmup=warmup, repeat=repeat,
                     clock=FakeClock(dts), sync=None)
    want = RB.measure(fn("ref"), warmup=warmup, repeat=repeat,
                      clock=FakeClock(dts), sync=None)
    assert _fields(got) == _fields(want)
    assert (got.best_s, got.median_s) == (want.best_s, want.median_s)
    assert calls["port"] == calls["ref"] == warmup + repeat


def test_measure_default_sync_is_the_reference():
    """The default synchronisation (``torch.cuda.synchronize`` on a card's
    output, nothing on the CPU's; ``jax.block_until_ready`` in the
    reference) reads no clock."""
    got = TB.measure(lambda: torch.ones(4), clock=FakeClock())
    want = RB.measure(lambda: jax.numpy.ones(4), clock=FakeClock())
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("warmup,repeat", [(0, 3), (1, 0), (0, 0)])
def test_measure_rejects_degenerate_loops_in_both(warmup, repeat):
    for measure in (TB.measure, RB.measure):
        with pytest.raises(ValueError):
            measure(lambda: None, warmup=warmup, repeat=repeat, sync=None)


# ---------------------------------------------------------------------------
# (b) fits and (c) the table's JSON
# ---------------------------------------------------------------------------

def _grid(case, seed=0):
    """Synthetic (bytes, seconds) grids that take each branch of
    ``fit_phase``, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.uniform(1e6, 1e7, 9))
    if case == "exact_affine":
        ys = 5e-5 + xs / 2e9
    elif case == "negative_intercept":
        ys = xs / 1e9 - 2e-3 + rng.normal(0.0, 1e-5, xs.size)
    elif case == "latency_floor":
        ys = 1e-3 - 1e-12 * xs + rng.normal(0.0, 1e-7, xs.size)
    elif case == "noise_floor":
        ys = -1e-10 * xs + rng.normal(0.0, 1e-5, xs.size)
    else:
        ys = 1e-5 + xs / 3e9 * rng.uniform(0.8, 1.2, xs.size)
    return [float(x) for x in xs], [float(y) for y in ys]


def _samples(pkg, kind, xs, ys, flops_per_byte=2.0):
    return [pkg.Sample(kind, "synthetic", {"i": i}, x, flops_per_byte * x, y, 0.0)
            for i, (x, y) in enumerate(zip(xs, ys))]


FIT_CASES = ["exact_affine", "negative_intercept", "latency_floor", "noise_floor",
             "noisy_affine"]


@pytest.mark.parametrize("case", FIT_CASES)
@pytest.mark.parametrize("n", [3, 9])
def test_fit_phase_is_the_reference(case, n):
    xs, ys = _grid(case)
    xs, ys = xs[:n], ys[:n]
    got = TCo.fit_phase(_samples(TB, "decode_attn", xs, ys))
    want = RCo.fit_phase(_samples(RB, "decode_attn", xs, ys))
    assert got.to_json() == want.to_json()
    if n == 9:
        # the grid takes the branch it is named for
        signature = {"negative_intercept": (want.intercept_s == 0.0 and want.r2 > 0
                                            and want.rate_ci95_rel is not None),
                     "latency_floor": want.rate_ci95_rel is None and want.intercept_s > 0,
                     "noise_floor": want.intercept_s == 0.0 and want.r2 == 0.0}
        assert signature.get(case, True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_samples_and_build_table_are_the_reference(seed):
    ts, rs = [], []
    for j, kind in enumerate(sorted(RCo.DEFAULT_TERMS)):
        xs, ys = _grid(FIT_CASES[(seed + j) % len(FIT_CASES)], seed + j)
        ts += _samples(TB, kind, xs, ys, 1.5 + j)
        rs += _samples(RB, kind, xs, ys, 1.5 + j)
    got = TCo.fit_samples(ts)
    want = RCo.fit_samples(rs)
    assert {k: f.to_json() for k, f in got.items()} == \
        {k: f.to_json() for k, f in want.items()}
    meta = {"note": "synthetic", "seed": seed}
    t = TCo.build_table(ts, backend="cpu", meta=meta)
    r = RCo.build_table(rs, meta=meta)          # jax on the CPU: "cpu", interpret
    assert t.to_json() == r.to_json()
    assert t.error_bar_rel == r.error_bar_rel == TCa.error_bar_rel(t)


def _tables(seed=0):
    """The same synthetic table in both packages, every kind fitted."""
    ts, rs = [], []
    for j, kind in enumerate(sorted(RCo.DEFAULT_TERMS)):
        xs, ys = _grid("noisy_affine", seed + j)
        ts += _samples(TB, kind, xs, ys, 100.0 * (j + 1))
        rs += _samples(RB, kind, xs, ys, 100.0 * (j + 1))
    return (TCo.build_table(ts, backend="cuda", interpret=False, meta={"card": "x"}),
            RCo.build_table(rs, backend="cuda", interpret=False, meta={"card": "x"}))


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_table_json_loads_across_packages(direction, tmp_path):
    t, r = _tables()
    src, dst = (r, TCo) if direction == "reference_to_port" else (t, RCo)
    path = str(tmp_path / "table.json")
    src.save(path)
    loaded = dst.CalibrationTable.load(path)
    assert loaded.to_json() == src.to_json()
    assert dst.CalibrationTable.from_json(src.to_json()).to_json() == src.to_json()


@pytest.mark.parametrize("pkg", [TCo, RCo], ids=["port", "reference"])
def test_table_version_mismatch_raises(pkg):
    d = _tables()[0].to_json()
    d["version"] = TCo.CALIBRATION_VERSION + 1
    with pytest.raises(ValueError, match="re-run the profiler"):
        pkg.CalibrationTable.from_json(d)


# ---------------------------------------------------------------------------
# (d) the measured Calib and the error report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chiplets", [36, 64, 100])
@pytest.mark.parametrize("seed", [0, 3])
def test_measured_calib_and_error_report_are_the_reference(n_chiplets, seed):
    t, r = _tables(seed)
    assert _fields(TCa.measured_calib(t, n_chiplets=n_chiplets)) == \
        _fields(RCa.measured_calib(r, n_chiplets=n_chiplets))
    assert TCa.phase_error_report(t, n_chiplets=n_chiplets) == \
        RCa.phase_error_report(r, n_chiplets=n_chiplets)
    assert TCa.PLANE_MAP == RCa.PLANE_MAP


def test_measured_calib_of_a_partial_table_is_the_reference():
    xs, ys = _grid("exact_affine")
    t = TCo.build_table(_samples(TB, "decode_attn", xs, ys), backend="cpu")
    r = RCo.build_table(_samples(RB, "decode_attn", xs, ys))
    assert _fields(TCa.measured_calib(t)) == _fields(RCa.measured_calib(r))


# ---------------------------------------------------------------------------
# (e)-(g) the samplers
# ---------------------------------------------------------------------------

def _same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_json() == w.to_json()


KERNEL_GRID = dict(batches=(1,), kv_lens=(128,), kv_bits=(0, 8, 4),
                   prefill_lens=(128,), seg_len=64, qmm_shapes=((128, 256),),
                   qmm_bits=(8,), warmup=1, repeat=2)


def test_kernel_samples_are_the_reference():
    got = TB.kernel_samples(("bert-base",), **KERNEL_GRID, clock=FakeClock(),
                            device="cpu")
    want = RB.kernel_samples(("bert-base",), **KERNEL_GRID, clock=FakeClock(),
                             interpret=True)
    assert [s.kind for s in got] == ["decode_attn", "decode_attn_kv8", "decode_attn_kv4",
                                     "prefill_attn", "dequant_matmul"]
    _same_samples(got, want)


class SharedDraws:
    """The inputs a case draws, from numpy: its i-th draw is standard
    normal of the shape asked for, seeded with i, in f32 and rounded to
    the dtype asked for.  One instance for each package gives both cases
    the same q, k, v (or x and w); each builds its positions, segments
    and quantised codes itself."""

    def __init__(self):
        self.n = 0

    def __call__(self, shape):
        a = np.random.default_rng(self.n).standard_normal(shape, dtype=np.float32)
        self.n += 1
        return a


def _ref_case(kind, cfg, p):
    key = jax.random.PRNGKey(0)
    if kind.startswith("decode_attn"):
        bits = 0 if p["kv_bits"] == 16 else p["kv_bits"]
        return RB._decode_case(cfg, p["batch"], p["kv_len"], bits, interpret=True, key=key)
    if kind == "prefill_attn":
        return RB._prefill_case(cfg, p["batch"], p["seq"], seg_len=p["seg_len"],
                                interpret=True, key=key)
    return RB._qmm_case(cfg, p["m"], p["k"], p["n"], p["bits"], interpret=True, key=key)


@pytest.mark.parametrize("kind,params", [
    ("decode_attn", {"batch": 2, "kv_len": 96, "kv_bits": 16}),
    ("decode_attn_kv8", {"batch": 1, "kv_len": 128, "kv_bits": 8}),
    ("decode_attn_kv4", {"batch": 2, "kv_len": 64, "kv_bits": 4}),
    ("prefill_attn", {"batch": 1, "seq": 128, "seg_len": 64}),
    ("prefill_attn", {"batch": 2, "seq": 96, "seg_len": 32}),
    ("dequant_matmul", {"m": 8, "k": 128, "n": 256, "bits": 4}),
    ("dequant_matmul", {"m": 8, "k": 256, "n": 128, "bits": 8}),
])
def test_kernel_case_outputs_are_shaped_as_the_reference(kind, params, monkeypatch):
    """On the same drawn inputs, each case's call (the plain version on the
    CPU) gives the reference's kernel output in interpret mode within the
    bf16 bound (1e-2), shaped alike; its terms are the reference's."""
    port_draws, ref_draws = SharedDraws(), SharedDraws()
    monkeypatch.setattr(TB, "_randn", lambda generator, shape, dtype=torch.bfloat16:
                        torch.from_numpy(port_draws(shape)).to(dtype))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype:
                        jax.numpy.asarray(ref_draws(shape), dtype))
    case = TB.kernel_case(kind, port_reduce(port_config("bert-base")), params,
                          generator=torch.Generator().manual_seed(0))
    fn, bytes_term, flops_term = _ref_case(kind, ref_reduce(ref_config("bert-base")), params)
    out, want = case.call(), np.asarray(fn(), np.float32)
    assert port_draws.n == ref_draws.n > 0
    assert tuple(out.shape) == want.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    np.testing.assert_allclose(out.float().numpy(), want, atol=1e-2, rtol=1e-2)
    assert torch.equal(out, case.plain())
    assert (case.bytes_term, case.flops_term) == (bytes_term, flops_term)


def test_executor_samples_are_the_reference():
    kw = dict(batches=(1, 2), impl="ref", warmup=1, repeat=2, steps_per_call=2)
    got = TB.executor_samples(("bert-base",), **kw, clock=FakeClock(), device="cpu")
    want = RB.executor_samples(("bert-base",), **kw, clock=FakeClock())
    assert [s.params["batch"] for s in got] == [1, 2]
    _same_samples(got, want)


@pytest.mark.parametrize("call", [
    lambda: TB.kernel_samples(("bert-base",), **KERNEL_GRID),
    lambda: TB.executor_samples(("bert-base",), batches=(1,)),
    lambda: TB.interpret_default(),
    lambda: TCo.build_table([]),
], ids=["kernel_samples", "executor_samples", "interpret_default", "build_table"])
def test_without_a_card_nothing_runs_unless_the_cpu_is_asked_for(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert TB.interpret_default("cpu") is True
