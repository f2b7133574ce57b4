"""Plane B of the port (``repro_torch.core``) against the reference's
(``repro.core``), live, on the CPU.

The port's copy is the reference's numpy with only its imports changed,
so each case runs both packages on the same inputs (the port's configs and
the reference's, which are equal field by field) and compares the results
with ``==``: every float, array, placement and dataclass field, with no
tolerance.  The bridge from a measured serving run, ``cosim_from_engine``,
is driven by each package's own engine on reduced llama2-7b with the same
requests; its records are equal apart from the measured host times, which
are not compared.
"""
import dataclasses
import enum
import math

import numpy as np
import pytest

import repro.core.baselines as RB
import repro.core.cosim as RC
import repro.core.faults as RF
import repro.core.hetero as RH
import repro.core.moo as RM
import repro.core.noi as RN
import repro.core.placement as RP
import repro.core.simulator as RS
import repro.core.thermal as RT
import repro.core.traffic as RTr
import repro_torch.core.baselines as TB
import repro_torch.core.cosim as TC
import repro_torch.core.faults as TF
import repro_torch.core.hetero as TH
import repro_torch.core.moo as TM
import repro_torch.core.noi as TN
import repro_torch.core.placement as TP
import repro_torch.core.simulator as TS
import repro_torch.core.thermal as TT
import repro_torch.core.traffic as TTr
from repro.config import PAPER_ARCHS
from repro.config import get_config as ref_config
from repro_torch.config import get_config as port_config

SIZES = (36, 64, 100)


def _same(a, b, where="result"):
    """``a`` (the port's) equals ``b`` (the reference's) with ``==``, field
    by field: the two packages' classes differ, so dataclasses and objects
    are compared by their fields, enums by value."""
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        assert getattr(a, "value", a) == getattr(b, "value", b), where
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        key = lambda k: getattr(k, "value", k)  # noqa: E731
        assert sorted(map(key, a), key=repr) == sorted(map(key, b), key=repr), where
        bk = {key(k): v for k, v in b.items()}
        for k, v in a.items():
            _same(v, bk[key(k)], f"{where}[{key(k)!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), where
    elif hasattr(a, "__dict__") and not callable(a):
        assert type(a).__name__ == type(b).__name__, where
        _same(vars(a), vars(b), where)
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} != {b!r}"


def _workloads(arch, seq_len, **bits):
    return (TTr.Workload.from_config(port_config(arch), seq_len, **bits),
            RTr.Workload.from_config(ref_config(arch), seq_len, **bits))


@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_workload_from_the_port_config_is_the_reference(arch):
    for seq_len, bits in ((64, {}), (512, dict(weight_bits=8, kv_bits=8)),
                          (128, dict(weight_bits=4, kv_bits=4))):
        wt, wr = _workloads(arch, seq_len, **bits)
        _same(wt, wr, f"{arch} workload")
        assert wt.kv_frac == wr.kv_frac and wt.n_dec_layers == wr.n_dec_layers


@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_phases_are_the_reference(arch):
    """``transformer_phases``, ``prefill_phases`` and ``decode_step_phases``
    single-stream and batched (a position a slot)."""
    wt, wr = _workloads(arch, 128)
    _same(TTr.transformer_phases(wt), RTr.transformer_phases(wr), "transformer_phases")
    _same(TTr.prefill_phases(wt), RTr.prefill_phases(wr), "prefill_phases")
    for kv_pos, batch in ((200, 1), (513, 4), ([130, 300, 77, 1024, 5, 640, 900, 64], 8)):
        got = TTr.decode_step_phases(wt, kv_pos, batch=batch)
        _same(got, RTr.decode_step_phases(wr, kv_pos, batch=batch), f"decode {batch}")
        assert TTr.total_traffic_bytes(got) == RTr.total_traffic_bytes(
            RTr.decode_step_phases(wr, kv_pos, batch=batch))


@pytest.mark.parametrize("n_chiplets", SIZES)
def test_noi_evaluation_on_the_initial_placement_is_the_reference(n_chiplets):
    """``evaluate_noi`` of gpt-j's single pass and llama2-7b's batched decode
    step on ``initial_placement``, and the mesh baseline."""
    pt, pr = TP.initial_placement(n_chiplets), RP.initial_placement(n_chiplets)
    _same(pt, pr, "placement")
    for arch, phases in (("gpt-j", lambda m, w: m.transformer_phases(w)),
                         ("llama2-7b", lambda m, w: m.decode_step_phases(w, 300, batch=8))):
        wt, wr = _workloads(arch, 64)
        ph_t, ph_r = phases(TTr, wt), phases(RTr, wr)
        _same(TN.evaluate_noi(pt, ph_t), RN.evaluate_noi(pr, ph_r), f"{arch} noi")
        _same(TN.mesh_baseline_eval(n_chiplets, ph_t), RN.mesh_baseline_eval(n_chiplets, ph_r),
              f"{arch} mesh baseline")


@pytest.mark.parametrize("arch", sorted(RS.ANCHORS))
def test_table4_anchors_are_the_reference(arch):
    """The Table-4 anchors (bert-base and gpt-j at 64 tokens, on the
    simulator's chiplet counts) through ``simulate_2p5d_hi`` and both
    baselines."""
    sim = {"2.5D-HI": (TS.simulate_2p5d_hi, RS.simulate_2p5d_hi),
           "HAIMA_chiplet": (TB.simulate_haima_chiplet, RB.simulate_haima_chiplet),
           "TransPIM_chiplet": (TB.simulate_transpim_chiplet, RB.simulate_transpim_chiplet)}
    assert TS.ANCHORS == RS.ANCHORS
    _same(TS.CALIB, RS.CALIB, "calibration")
    port, ref = sim[arch]
    for model, n, chips, _target in RS.ANCHORS[arch]:
        wt, wr = _workloads(model, n)
        got = port(wt, chips)
        _same(got, ref(wr, chips), f"{arch} {model}")
        assert got.latency_s > 0


MIX = dict(episodes=[(17, 32, 3), (128, 8, 2), (384, 32, 1)], prefill_chunk=128,
           max_batch=8, active_hist={8: 40, 5: 12, 2: 3}, max_stall_tokens=256)


def _mix(C, **change):
    kw = dict(MIX, **change)
    return C.EpisodeMix([C.Episode(*e) for e in kw.pop("episodes")], **kw)


@pytest.mark.parametrize("arch,bits", [("llama2-7b", {}), ("gpt-j", {}),
                                       ("llama2-7b", dict(weight_bits=8, kv_bits=8))])
def test_cosim_mix_is_the_reference(arch, bits):
    """``cosim_mix`` of a fixed measured mix on every architecture, batched
    at the mix's occupancy and single-streamed."""
    mt, mr = _mix(TC, **bits), _mix(RC, **bits)
    for batch in (None, 1):
        _same(TC.cosim_mix(port_config(arch), mt, 64, batch=batch),
              RC.cosim_mix(ref_config(arch), mr, 64, batch=batch), f"{arch} batch={batch}")
    ot, _, pht = TC.generation_objective(port_config(arch), mt, 36)
    orf, _, phr = RC.generation_objective(ref_config(arch), mr, 36)
    _same(pht, phr, "generation phases")
    _same(ot(TP.initial_placement(36)), orf(RP.initial_placement(36)), "objective")


def test_seeded_moo_search_is_the_reference():
    """A short seeded MOO-STAGE and AMOSA over bert-base's single pass on 36
    chiplets: the same archive, PHV history and evaluations."""
    def objective(N, P, T):
        w = T.Workload.from_config((port_config if T is TTr else ref_config)("bert-base"), 64)
        phases = T.transformer_phases(w)
        mesh = N.mesh_baseline_eval(36, phases)
        return lambda p: (lambda ev: (ev.mu / mesh.mu, ev.sigma / mesh.sigma))(
            N.evaluate_noi(p, phases))
    obj_t, obj_r = objective(TN, TP, TTr), objective(RN, RP, RTr)
    ref_point = (4.0, 4.0)
    got = TM.moo_stage(36, obj_t, ref_point, iterations=2, meta_candidates=4, ls_steps=4,
                       seed=3)
    _same(got, RM.moo_stage(36, obj_r, ref_point, iterations=2, meta_candidates=4,
                            ls_steps=4, seed=3), "moo_stage")
    assert got.n_evals > 0 and got.phv_history[-1] > 0
    got = TM.amosa(36, obj_t, ref_point, steps=30, seed=5)
    _same(got, RM.amosa(36, obj_r, ref_point, steps=30, seed=5), "amosa")
    assert len(got.phv_history) == 1


def test_thermal_faults_and_hetero_are_the_reference():
    """One case each: the 3-D stack reports, gpt-j under sampled link and
    chiplet faults with a derated link, and the device-order and
    mapping studies."""
    for n in (36, 64):
        _same(TT.hi3d_stack_report(n), RT.hi3d_stack_report(n), f"hi3d {n}")
    for kind in ("haima", "transpim"):
        _same(TT.baseline_stack_report(kind), RT.baseline_stack_report(kind), kind)
    _same(TT.hbm_pim_stack_report(), RT.hbm_pim_stack_report(), "hbm pim")

    pt, pr = TP.initial_placement(36), RP.initial_placement(36)
    wt, wr = _workloads("gpt-j", 64)
    ph_t, ph_r = TTr.transformer_phases(wt), RTr.transformer_phases(wr)
    fm = dict(k_links=2, k_chiplets=1, k_derated=2, bw_derate=0.5, seed=7)
    st = TF.FaultModel(**fm).sample_scenarios(pt, 4)
    sr = RF.FaultModel(**fm).sample_scenarios(pr, 4)
    _same(st, sr, "scenarios")
    for a, b in zip(st, sr):
        _same(TN.evaluate_noi(pt, ph_t, scenario=a), RN.evaluate_noi(pr, ph_r, scenario=b),
              f"noi under {b.label}")
    _same(TF.endurance_link_weights(pt, ph_t), RF.endurance_link_weights(pr, ph_r),
          "endurance weights")

    _same(TH.compare_device_orders(8, 8), RH.compare_device_orders(8, 8), "device orders")

    def fake_eval(k):
        return (1.0 - 0.2 * k.seq_shard, 1.0 / k.accum, 0.5 * (k.remat_policy == "dots"))
    _same(TH.mapping_search(fake_eval, budget=16), RH.mapping_search(fake_eval, budget=16),
          "mapping search")


# ---------------------------------------------------------------------------
# the bridge: each package's engine into its own cosim_from_engine
# ---------------------------------------------------------------------------

PROMPT_LENS = [5, 23, 9, 12, 3, 17, 30, 8]


def test_cosim_from_engine_of_both_packages_agree():
    """Reduced llama2-7b served by each package's engine (the same
    prompts, weights and settings, a deep queue over 3 slots so the pool
    back-fills) and each run fed to its own package's
    ``cosim_from_engine`` on the full-size config, traced: equal records
    but for the measured host times."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.config import reduce_config as ref_reduce
    from repro.models import transformer as TJ
    from repro.serving.engine import EngineConfig as RefEngineConfig
    from repro.serving.engine import ServingEngine as RefEngine
    from repro_torch.config import reduce_config
    from repro_torch.convert import params_from_jax
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    settings = dict(max_batch=3, kv_len=64, prefill_chunk=16, max_new_tokens=6,
                    impl="flash", trace=True)
    cfg_r = ref_reduce(ref_config("llama2-7b"))
    cfg_t = reduce_config(port_config("llama2-7b"))
    tree = TJ.init_params(cfg_r, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    eng_r = RefEngine(cfg_r, tree, RefEngineConfig(**settings))
    eng_t = ServingEngine(cfg_t, params_from_jax(jax.device_get(tree), cfg_t, device="cpu",
                                                 dtype=torch.bfloat16),
                          EngineConfig(**settings), device="cpu")
    rng = np.random.default_rng(0)
    for n in PROMPT_LENS:
        p = rng.integers(0, cfg_t.vocab_size, size=n)
        eng_r.submit(p)
        eng_t.submit(p)
    eng_r.run_until_drained()
    eng_t.run_until_drained()
    assert eng_t.stats()["finished"] == len(PROMPT_LENS)
    rec_t = TC.cosim_from_engine(eng_t, cfg=port_config("llama2-7b"))
    rec_r = RC.cosim_from_engine(eng_r, cfg=ref_config("llama2-7b"))
    for rec in (rec_t, rec_r):
        # the host clock's readings, the only numbers that may differ
        for key in ("measured_step_s", "measured_prefill_s", "measured_d2h_s"):
            assert rec["mix"].pop(key) >= 0
    _same(rec_t, rec_r, "cosim_from_engine")
    assert set(rec_t["archs"]) == set(TC.ARCHS)
    assert rec_t["mix"]["requests"] == len(PROMPT_LENS)
    assert rec_t["mix"]["mean_active_slots"] > 1
