"""Crash-safe serving in the port (``repro_torch.serving.checkpoint``) on the
CPU: the counterparts of ``tests/test_serving_checkpoint.py``, the port's
own contracts, and a live comparison with the reference's snapshots.

Reduced qwen2.5-3b with the reference's f32 weights (stored f32 in the
port too) and the attention oracle (``impl="ref"``), as the reference's
own checkpoint tests run: a snapshot taken between two ``step()`` calls,
a journal-only submit and two steps of work the crash throws away, then a
fresh engine restored from the snapshot must finish every request with the
streams of the uninterrupted run, bit for bit.

The port's own contracts: the restore writes the pool's tensors in place
(a CUDA graph captured over them reads them by address), the generator
state goes back into the engine's own generator (and one of the other
device type is refused), and the draft model's pool, the speculative
step's draws and the host-looped baseline's host arrays survive a restore.
The front end drives a checkpointer.

Reduced mamba2-130m and recurrentgemma-9b (padded admission, the
recurrent ``conv`` and ``state``/``h`` leaves in the snapshot) are killed
and restored the same way, and their snapshots held against the
reference's.  So is reduced deepseek-v2-236b (multi-head latent
attention, padded admission): its pool's ``ckv``/``kr`` latents stay bf16
under ``kv_bits`` 8 and 4, in the pool and in the snapshot, as the
reference's do.  The reference's encoder-decoder pool round trip waits for
that stack in the port (``ROADMAP.md`` Queue 1 item 3).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduce_config as jax_reduce_config
from repro.models import transformer as TJ
from repro.serving import checkpoint as rc
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.ckpt import _storage_view, tree_items
from repro_torch.config import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T
from repro_torch.serving import checkpoint as sc
from repro_torch.serving.engine import REJECTED, EngineConfig, ServingEngine
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.scheduler import SloClass, SloScheduler
from test_torch_model import _compare_dequantised
from test_torch_serving import BF16_LOGIT_TOL, _margin

SETTINGS = dict(max_batch=3, kv_len=48, max_new_tokens=6, impl="ref", prefill_chunk=8)
# prompt 2 is longer than the chunk budget -> chunked-prefill state
PROMPT_LENS = (8, 5, 19, 11, 6)


@pytest.fixture(scope="module")
def model():
    """Reduced qwen2.5-3b: (reference cfg, params, port cfg, params), f32;
    and a 1-layer draft model of its own seed (port cfg, params)."""
    cfg_j = jax_reduce_config(jax_get_config("qwen2.5-3b"))
    params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    cfg_t = reduce_config(get_config("qwen2.5-3b"))
    params_t = params_from_jax(jax.device_get(params_j), cfg_t, device="cpu",
                               dtype=torch.float32)
    dcfg = dataclasses.replace(cfg_t, n_layers=1, name=cfg_t.name + "-draft")
    dparams = T.init_params(dcfg, torch.Generator().manual_seed(9), device="cpu",
                            dtype=torch.float32)
    return {"ref": (cfg_j, params_j), "port": (cfg_t, params_t), "draft": (dcfg, dparams)}


def _ecfg(**kw):
    return EngineConfig(**dict(SETTINGS, **kw))


def _prompts(cfg, lens=PROMPT_LENS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=n) for n in lens]


def _outputs(engine):
    out = {}
    for r in engine.finished:
        assert r.uid not in out
        out[r.uid] = list(r.output)
    return out


def _engine(model, ecfg, draft=False, **kw):
    cfg, params = model["port"]
    return ServingEngine(cfg, params, ecfg, device="cpu",
                         draft=model["draft"] if draft else None, **kw)


def _uninterrupted(model, ecfg, prompts, kill_at, draft=False):
    eng = _engine(model, ecfg, draft)
    for p in prompts[:4]:
        eng.submit(p.copy())
    for _ in range(kill_at):
        eng.step()
    eng.submit(prompts[4].copy())
    eng.run_until_drained()
    return _outputs(eng)


def _crash_and_restore(model, ecfg, prompts, kill_at, ckpt_dir, draft=False, lost_steps=2):
    eng = _engine(model, ecfg, draft)
    ck = sc.EngineCheckpointer(eng, ckpt_dir)
    for p in prompts[:4]:
        ck.submit(p.copy())
    for _ in range(kill_at):
        eng.step()
    ck.save()
    ck.submit(prompts[4].copy())          # journal-only: after the snapshot
    for _ in range(lost_steps):           # work the crash throws away
        eng.step()
    del eng                               # the crash
    cfg, params = model["port"]
    eng2 = ServingEngine.restore(cfg, params, ckpt_dir, device="cpu",
                                 draft=model["draft"] if draft else None)
    eng2.run_until_drained()
    return eng2


def _check_resumed(model, ecfg, tmp_path, kill_at, draft=False):
    prompts = _prompts(model["port"][0])
    want = _uninterrupted(model, ecfg, prompts, kill_at, draft)
    eng2 = _crash_and_restore(model, ecfg, prompts, kill_at, str(tmp_path), draft)
    assert _outputs(eng2) == want          # bit-exact, nothing lost or duplicated
    s = eng2.stats()
    assert (s["restores"], s["replayed_requests"], s["checkpoints_written"]) == (1, 1, 1)
    return eng2


@pytest.mark.parametrize("kill_at,temperature", [
    (0, 0.0),     # post-admission, before the snapshot's journal burst
    (1, 0.0),     # mid-prefill-chunk (19-token prompt, chunk 8)
    (3, 0.0),     # mid-decode
    (3, 0.8),     # mid-decode, sampling (the generator's state)
])
def test_kill_restore_bit_exact(model, tmp_path, kill_at, temperature):
    _check_resumed(model, _ecfg(temperature=temperature, seed=0), tmp_path, kill_at)


def test_mid_prefill_snapshot_carries_chunk_progress(model, tmp_path):
    cfg, params = model["port"]
    eng = _engine(model, _ecfg())
    for p in _prompts(cfg)[:4]:
        eng.submit(p.copy())
    for _ in range(10):                   # reach a 19-token prompt mid-chunk
        eng.step()
        if eng.pool.prefilling:
            break
    assert eng.pool.prefilling
    sc.save_engine(eng, str(tmp_path))
    eng2 = sc.restore_engine(cfg, params, str(tmp_path), device="cpu")
    assert eng2.pool.prefilling == eng.pool.prefilling
    eng.run_until_drained()
    eng2.run_until_drained()
    assert _outputs(eng2) == _outputs(eng)


def test_journal_replay_desync_raises(model, tmp_path):
    cfg, params = model["port"]
    eng = _engine(model, _ecfg())
    ck = sc.EngineCheckpointer(eng, str(tmp_path))
    ck.submit(_prompts(cfg)[0].copy())
    ck.save()
    # a gap in the journal's uids cannot replay to the recorded uid
    with open(os.path.join(str(tmp_path), sc.JOURNAL), "a") as f:
        f.write(json.dumps({"uid": eng._uid + 1, "prompt": [1, 2, 3],
                            "max_new_tokens": 4}) + "\n")
    with pytest.raises(RuntimeError, match="journal replay desync"):
        sc.restore_engine(cfg, params, str(tmp_path), device="cpu")


def test_torn_journal_tail_dropped(model, tmp_path):
    cfg, params = model["port"]
    prompts = _prompts(cfg)
    eng = _engine(model, _ecfg())
    ck = sc.EngineCheckpointer(eng, str(tmp_path))
    ck.submit(prompts[0].copy())
    ck.save()
    ck.submit(prompts[1].copy())
    with open(os.path.join(str(tmp_path), sc.JOURNAL), "a") as f:
        f.write('{"uid": 99, "prompt": [1,')   # crash mid-append
    eng2 = sc.restore_engine(cfg, params, str(tmp_path), device="cpu")
    assert eng2.replayed_requests == 1         # the complete line survived
    eng2.run_until_drained()
    assert len(_outputs(eng2)) == 2


def test_corrupt_newest_falls_back_to_previous(model, tmp_path):
    cfg, params = model["port"]
    eng = _engine(model, _ecfg())
    for p in _prompts(cfg)[:2]:
        eng.submit(p.copy())
    sc.save_engine(eng, str(tmp_path))
    eng.step()
    newest = sc.save_engine(eng, str(tmp_path))
    # tamper one leaf of the newest arrays blob (a valid npz, wrong bits):
    # the integrity digest must reject it
    blob = os.path.join(newest, "arrays.npz")
    arrays = sc.load_arrays(blob)
    key = sorted(arrays)[0]
    tampered = arrays[key].clone()
    tampered.view(torch.uint8).reshape(-1)[0] ^= 0xFF
    arrays[key] = tampered
    sc.save_arrays(blob, arrays)
    arrays, meta, name = sc.load_newest_intact(str(tmp_path))
    assert name == "snap_00000000"
    eng2 = sc.restore_engine(cfg, params, str(tmp_path), device="cpu")
    assert eng2.restores == 1
    eng2.run_until_drained()
    assert len(_outputs(eng2)) == 2

    # every snapshot corrupt -> an explicit FileNotFoundError
    oldest = os.path.join(str(tmp_path), name, "meta.json")
    with open(oldest, "r+") as f:
        meta = json.load(f)
        meta["digest"] = "0" * 64
        f.seek(0)
        json.dump(meta, f)
        f.truncate()
    with pytest.raises(FileNotFoundError, match="no intact snapshot"):
        sc.load_newest_intact(str(tmp_path))


def test_save_retries_transient_failures(model, tmp_path, monkeypatch):
    cfg, _ = model["port"]
    eng = _engine(model, _ecfg())
    eng.submit(_prompts(cfg)[0].copy())
    real = sc.atomic_save_dir
    fails = {"n": 2}
    sleeps = []

    def flaky(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient store hiccup")
        return real(*a, **kw)

    monkeypatch.setattr(sc, "atomic_save_dir", flaky)
    path = sc.save_engine(eng, str(tmp_path), retries=3, backoff_s=0.05, sleep=sleeps.append)
    assert os.path.isdir(path)
    assert sleeps == [0.05, 0.1]          # exponential backoff, no waiting
    assert eng.checkpoints_written == 1
    assert set(eng.save_s) == {"d2h_s", "digest_s", "write_s", "fsync_s"}

    # exhausted retries re-raise and roll the counter back
    fails["n"] = 10
    with pytest.raises(OSError):
        sc.save_engine(eng, str(tmp_path), retries=1, backoff_s=0.01, sleep=sleeps.append)
    assert eng.checkpoints_written == 1


def test_config_mismatch_rejected_policy_tolerated(model, tmp_path):
    cfg, params = model["port"]
    eng = _engine(model, _ecfg())
    eng.submit(_prompts(cfg)[0].copy())
    sc.save_engine(eng, str(tmp_path))
    with pytest.raises(ValueError, match="config mismatch on 'kv_len'"):
        sc.restore_engine(cfg, params, str(tmp_path), ecfg=_ecfg(kv_len=64), device="cpu")
    # operational policy knobs are free to change across a restart
    eng2 = sc.restore_engine(cfg, params, str(tmp_path), device="cpu",
                             ecfg=_ecfg(deadline_ms=50.0, max_queue=7))
    assert eng2.ecfg.max_queue == 7
    other = dataclasses.replace(cfg, name="other-model")
    with pytest.raises(ValueError, match="snapshot is of model"):
        sc.restore_engine(other, params, str(tmp_path), device="cpu")
    # a restore onto a mesh takes a DeviceMesh (test_torch_multidevice.py
    # restores across meshes); anything else is refused
    with pytest.raises(TypeError, match="mesh"):
        ServingEngine.restore(cfg, params, str(tmp_path), device="cpu", mesh=object())


def test_empty_dir_raises(model, tmp_path):
    cfg, params = model["port"]
    with pytest.raises(FileNotFoundError):
        sc.restore_engine(cfg, params, str(tmp_path), device="cpu")


def test_keep_bounds_snapshots_latest_survives(model, tmp_path):
    eng = _engine(model, _ecfg())
    eng.submit(_prompts(model["port"][0])[0].copy())
    for _ in range(4):
        sc.save_engine(eng, str(tmp_path), keep=2)
    assert sc.list_snapshots(str(tmp_path), sc.SNAP_PREFIX) == ["snap_00000002",
                                                                "snap_00000003"]
    assert sc.read_latest(str(tmp_path)) == "snap_00000003"
    assert eng.checkpoints_written == 4


# ---------------------------------------------------------------------------
# quantised slot-pool serialisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [8, 4])
def test_quantised_pool_kill_restore_bit_exact(model, tmp_path, kv_bits):
    """int8 / packed-int4 code and f32 scale pools snapshot and resume bit
    for bit."""
    eng2 = _check_resumed(model, _ecfg(kv_bits=kv_bits), tmp_path, kill_at=2)
    kinds = {k.split("/")[-1]: v.dtype for k, v in sc.flatten_tree(eng2.pool.cache).items()}
    assert kinds["k_q"] == torch.int8 and kinds["v_q"] == torch.int8
    assert kinds["k_s"] == torch.float32 and kinds["v_s"] == torch.float32


@pytest.mark.parametrize("arch,mqa,kv_bits", [
    ("gemma2-9b", False, 8),               # GQA, global and local (ring) layers
    ("qwen2.5-3b", True, 8),               # MQA (one shared KV head)
    ("qwen2.5-3b", False, 4),              # packed int4 codes
    ("deepseek-v2-236b", False, 8),        # MLA: the latents stay bf16
    ("deepseek-v2-236b", False, 4),
    ("bart-large", False, 8),              # enc-dec: the cross leaves stay bf16
])
def test_slot_pool_serialisation_roundtrip(tmp_path, arch, mqa, kv_bits):
    """A slot pool with content in every leaf round-trips through the npz
    with its leaf dtypes and bits; an MLA pool holds no quantised plane
    at any ``kv_bits``, nor does an encoder/decoder stack's cross cache
    (the reference's documented exceptions)."""
    cfg = reduce_config(get_config(arch))
    if mqa:
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    cache = T.init_cache(cfg, 2, 32, device="cpu", kv_bits=kv_bits)
    g = torch.Generator().manual_seed(0)
    for _, leaf in tree_items(cache):
        leaf.copy_(torch.randint(1, 5, leaf.shape, generator=g).to(leaf.dtype))
    flat = sc.flatten_tree(cache)
    path = os.path.join(str(tmp_path), "pool.npz")
    sc.save_arrays(path, flat)
    back = sc.unflatten_tree(cache, sc.load_arrays(path), cast=False)
    got, want = sc.flatten_tree(back), flat
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    if cfg.is_mla:
        assert {k.split("/")[-1]: v.dtype for k, v in flat.items()} == \
            {"ckv": torch.bfloat16, "kr": torch.bfloat16, "pos": torch.int32}
        return
    if cfg.cross_attn_decoder:
        cross = {k: v.dtype for k, v in flat.items() if "/cross/" in k}
        assert cross and set(cross.values()) == {torch.bfloat16}
        assert {k.split("/")[-1] for k in cross} == {"k", "v"}
        flat = {k: v for k, v in flat.items() if "/cross/" not in k}
    assert {"k_q", "k_s", "v_q", "v_s", "pos"} == {k.split("/")[-1] for k in flat}
    if "local" in cfg.pattern:            # rings of `window` entries beside the global pool
        assert len({v.shape[2] for k, v in flat.items() if k.endswith("/pos")}) == 2


def test_counters_surface_in_stats(model):
    s = _engine(model, _ecfg()).stats()
    assert (s["checkpoints_written"], s["restores"], s["replayed_requests"]) == (0, 0, 0)


class _TickClock:
    """A deterministic engine clock: every reading advances a fixed tick,
    so two runs of the same code path read identical timestamps."""

    def __init__(self, t: float = 100.0, dt: float = 0.01):
        self.t, self.dt = t, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def test_slo_scheduler_state_survives_kill_restore(model, tmp_path):
    """The SLO scheduler's stall estimate and deferral counter are part of
    the snapshot: the revived engine admits as the run that never crashed,
    so requests finish in the same order with the same streams."""
    cfg, params = model["port"]
    classes = {0: SloClass(), 1: SloClass(ttft_ms=50.0, tpot_ms=5.0)}

    def make_sched():
        return SloScheduler(classes, aging_s=0.5, max_defer=3)

    prompts = _prompts(cfg)
    prios = (0, 1, 0, 1, 0)
    kill_at = 3
    ref = _engine(model, _ecfg(clock=_TickClock()), scheduler=make_sched())
    for p, pr in zip(prompts, prios):
        ref.submit(p.copy(), priority=pr)
    ref.run_until_drained()
    ref_order = [r.uid for r in ref.finished]

    ecfg = _ecfg(clock=_TickClock())
    eng = _engine(model, ecfg, scheduler=make_sched())
    ck = sc.EngineCheckpointer(eng, str(tmp_path))
    for p, pr in zip(prompts, prios):
        ck.submit(p.copy(), priority=pr)
    for _ in range(kill_at):
        eng.step()
    ck.save()
    state = eng.scheduler.state_dict()
    assert state["stall_est_s"] > 0.0     # admission bursts were observed
    t_resume = ecfg.clock.t
    for _ in range(2):                    # work the crash throws away
        eng.step()
    del eng

    eng2 = sc.restore_engine(cfg, params, str(tmp_path), device="cpu",
                             ecfg=_ecfg(clock=_TickClock(t=t_resume)), scheduler=make_sched())
    assert eng2.scheduler.state_dict() == state
    eng2.run_until_drained()
    assert _outputs(eng2) == _outputs(ref)
    assert [r.uid for r in eng2.finished] == ref_order


def _rewrite_snapshot(snap, edit):
    """Apply ``edit(arrays, meta)`` to a snapshot and store it again with a
    matching digest (a snapshot intact but unlike the engine's)."""
    arrays = sc.load_arrays(os.path.join(snap, "arrays.npz"))
    with open(os.path.join(snap, "meta.json")) as f:
        meta = json.load(f)
    edit(arrays, meta)
    meta["digest"] = sc._meta_digest(arrays, meta)
    sc.save_arrays(os.path.join(snap, "arrays.npz"), arrays)
    with open(os.path.join(snap, "meta.json"), "w") as f:
        json.dump(meta, f)


def test_restore_without_scheduler_state_starts_cold(model, tmp_path):
    """A snapshot with no ``scheduler`` block leaves the fresh policy at its
    cold defaults rather than failing."""
    cfg, params = model["port"]
    eng = _engine(model, _ecfg())
    for p in _prompts(cfg)[:2]:
        eng.submit(p.copy())
    eng.step()
    snap = sc.save_engine(eng, str(tmp_path))
    _rewrite_snapshot(snap, lambda arrays, meta: meta.pop("scheduler", None))
    eng2 = sc.restore_engine(cfg, params, str(tmp_path), device="cpu",
                             scheduler=SloScheduler())
    assert eng2.scheduler._stall_est_s == 0.0
    assert eng2.scheduler._defers == 0
    eng2.run_until_drained()


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

SPEC = dict(spec_k=3, max_batch=2)


def test_load_array_tree_writes_in_place(model, tmp_path):
    """Restoring writes into the tensors the pool already holds (the CUDA
    graphs read them by address): every cache, state and draft tensor keeps
    its ``data_ptr()`` and takes the snapshot's values; a leaf of another
    shape or dtype is refused before anything is written."""
    cfg, params = model["port"]
    ecfg = _ecfg(spec_draft="model", **SPEC)
    eng = _engine(model, ecfg, draft=True)
    for p in _prompts(cfg)[:3]:
        eng.submit(p.copy())
    for _ in range(3):
        eng.step()
    snap = sc.save_engine(eng, str(tmp_path))
    arrays = sc.load_arrays(os.path.join(snap, "arrays.npz"))
    assert any(k.startswith("draft/") for k in arrays)

    fresh = _engine(model, ecfg, draft=True)
    tensors = dict(tree_items(fresh.pool.array_tree()))
    assert {k.split("/")[0] for k in tensors} == {"cache", "state", "draft"}
    ptrs = {k: t.data_ptr() for k, t in tensors.items()}
    before = {k: t.clone() for k, t in tensors.items()}
    tree = sc.unflatten_tree(fresh.pool.array_template(with_host=False), arrays, cast=False)
    bad = sc.unflatten_tree(fresh.pool.array_template(with_host=False), arrays, cast=False)
    bad["draft"]["stack"][0]["u0"]["attn"]["pos"] = torch.zeros((1, 1), dtype=torch.int32)
    bad["state"]["pos"] = bad["state"]["pos"].long()
    for wrong, where in ((bad, "state/pos"), (dict(tree, draft=bad["draft"]), "draft/stack"),
                         (dict(tree, state={}), "lacks state/")):
        with pytest.raises((ValueError, KeyError), match=where):
            fresh.pool.load_array_tree(wrong)
        assert all(torch.equal(t, before[k]) for k, t in tensors.items()), "a refused load wrote"
    fresh.pool.load_array_tree(tree)
    assert {k: t.data_ptr() for k, t in tensors.items()} == ptrs
    for k, t in tensors.items():
        assert torch.equal(t, arrays[k]), k


@pytest.mark.parametrize("draft", ["model", "self8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_kill_restore_bit_exact(model, tmp_path, draft, temperature):
    """Speculative decoding resumes bit for bit: with a draft model (whose
    pool is in the snapshot) and with an 8-bit self-draft, greedy and
    sampled (the drafts, the acceptance uniforms and the residual's draws
    all come from the restored generator)."""
    kw = dict(spec_draft="model") if draft == "model" else dict(spec_draft_bits=8)
    eng2 = _check_resumed(model, _ecfg(temperature=temperature, **SPEC, **kw), tmp_path,
                          kill_at=3, draft=draft == "model")
    assert eng2.stats()["spec_steps"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_host_loop_kill_restore_bit_exact(model, tmp_path, temperature):
    """The host-looped baseline (``fused=False``): its host arrays (position,
    budget, last token a slot) are in the snapshot."""
    prompts = _prompts(model["port"][0])
    ecfg = _ecfg(fused=False, temperature=temperature)
    want = _uninterrupted(model, ecfg, prompts, 3)
    eng2 = _crash_and_restore(model, ecfg, prompts, 3, str(tmp_path))
    assert _outputs(eng2) == want
    snap = sc.load_newest_intact(str(tmp_path))[0]
    assert {"host/slot_pos", "host/slot_budget", "host/last_token"} <= set(snap)


def test_frontend_drives_a_checkpointer(model, tmp_path):
    """``ServingFrontend(checkpointer=)``: accepted submits reach the journal
    and shed ones do not; ``maybe_save`` snapshots every ``every`` pumps; a
    front end over the restored engine drains to the uninterrupted run's
    streams."""
    cfg, params = model["port"]
    ecfg = _ecfg(max_queue=3)
    prompts = _prompts(cfg)

    plain = ServingFrontend(_engine(model, ecfg))
    for p in prompts:
        plain.submit(p.copy())
    plain.drain()
    want = _outputs(plain.engine)

    d = str(tmp_path)
    eng = _engine(model, ecfg)
    front = ServingFrontend(eng, checkpointer=sc.EngineCheckpointer(eng, d, keep=0, every=2))
    streams = [front.submit(p.copy()) for p in prompts]
    statuses = [s.status for s in streams]
    assert statuses.count(REJECTED) == 2
    journal = sc.read_journal(d)
    assert [e["uid"] for e in journal] == [s.uid for s in streams if s.status != REJECTED]
    for _ in range(5):
        front.pump()
    assert sc.list_snapshots(d, sc.SNAP_PREFIX) == ["snap_00000000", "snap_00000001"]
    del front, eng                         # the crash, a pump after the last snapshot

    eng2 = ServingEngine.restore(cfg, params, d, device="cpu")
    front2 = ServingFrontend(eng2, checkpointer=sc.EngineCheckpointer(eng2, d, every=2))
    front2.drain()
    assert _outputs(eng2) == want
    assert eng2.stats()["rejected"] == 2 and eng2.stats()["checkpoints_written"] >= 2


def test_generator_state_of_another_device_refused(model, tmp_path):
    """A snapshot's generator state of the other device type (a card's is
    16 bytes, the CPU's 5056) raises rather than loading garbage."""
    cfg, params = model["port"]
    eng = _engine(model, _ecfg(temperature=0.8))
    eng.submit(_prompts(cfg)[0].copy())
    eng.step()
    snap = sc.save_engine(eng, str(tmp_path))
    assert sc.load_arrays(os.path.join(snap, "arrays.npz"))["generator"].numel() == 5056

    def as_card(arrays, meta):
        arrays["generator"] = torch.zeros(16, dtype=torch.uint8)
    _rewrite_snapshot(snap, as_card)
    with pytest.raises(ValueError, match="16 bytes.*5056"):
        sc.restore_engine(cfg, params, str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# live parity with the reference
# ---------------------------------------------------------------------------

_TIMES = ("t_enqueue", "t_admit", "t_first_token", "t_done")


def _untimed(meta):
    """A snapshot's meta record without its times (and its digest, over
    leaves that differ in the last bits)."""
    out = {k: v for k, v in meta.items() if k != "digest"}
    for key in ("slot_req", "queue", "finished", "failed", "rejected"):
        out[key] = [None if r is None else {k: v for k, v in r.items() if k not in _TIMES}
                    for r in meta[key]]
    out["counters"] = {k: v for k, v in meta["counters"].items() if k != "prefill_time"}
    return out


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_snapshot_and_restore_match_the_reference(model, tmp_path, kv_bits):
    """The same kill schedule on both packages: the snapshots hold the same
    leaf keys, shapes and dtypes but for the port's ``generator`` in place
    of the reference's ``state/key`` and ``seed_key``; positions and state
    are equal, float leaves within 1e-2 of their scale (bf16 rows, f32
    scales), and codes dequantise within one code step and 5e-2 of their
    row (``tests/test_torch_model.py``'s bf16 rule: in bf16 the quantiser
    turns last-bit differences into code steps); the meta records are
    equal but for times.  Restored and drained, the greedy streams equal the reference's
    restored streams but at a near-tie of the reference."""
    _snapshot_and_restore_match(model, tmp_path, kv_bits)


def _snapshot_and_restore_match(model, tmp_path, kv_bits, tol=BF16_LOGIT_TOL):
    (cfg_j, params_j), (cfg_t, params_t) = model["ref"], model["port"]
    settings = dict(SETTINGS, kv_bits=kv_bits)
    prompts = _prompts(cfg_t)
    dirs = {}
    engines = {"ref": JaxServingEngine(cfg_j, params_j, JaxEngineConfig(**settings)),
               "port": ServingEngine(cfg_t, params_t, EngineConfig(**settings), device="cpu")}
    for side, eng in engines.items():
        dirs[side] = os.path.join(str(tmp_path), side)
        ck = (rc if side == "ref" else sc).EngineCheckpointer(eng, dirs[side])
        for p in prompts[:4]:
            ck.submit(p.copy())
        for _ in range(3):
            eng.step()
        ck.save()
        ck.submit(prompts[4].copy())
    arr_j, meta_j, _ = rc.load_newest_intact(dirs["ref"])
    arr_t, meta_t, _ = sc.load_newest_intact(dirs["port"])

    assert set(arr_t) - {"generator"} == set(arr_j) - {"state/key", "seed_key"}
    assert "generator" in arr_t and {"state/key", "seed_key"} <= set(arr_j)
    for k in sorted(set(arr_t) - {"generator"}):
        got, want = arr_t[k], arr_j[k]
        assert tuple(got.shape) == want.shape, k
        assert _storage_view(got)[1] == want.dtype.name, k
        if k.endswith(("/k_q", "/v_q")):
            # bf16 compute turns last-bit differences into code steps
            s = k[:-1] + "s"
            _compare_dequantised(got, arr_t[s], want, arr_j[s], kv_bits, k)
        elif got.is_floating_point():
            want = want.astype(np.float32)
            err = float(np.abs(got.float().numpy() - want).max())
            assert err <= tol * max(1.0, float(np.abs(want).max())), (k, err)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    assert _untimed(meta_t) == _untimed(meta_j)

    restored = {"ref": JaxServingEngine.restore(cfg_j, params_j, dirs["ref"]),
                "port": ServingEngine.restore(cfg_t, params_t, dirs["port"], device="cpu")}
    for eng in restored.values():
        eng.run_until_drained()
    out_j, out_t = _outputs(restored["ref"]), _outputs(restored["port"])
    assert set(out_t) == set(out_j) == set(range(len(prompts)))
    for uid, prompt in enumerate(prompts):
        a, b = out_j[uid], out_t[uid]
        assert len(a) == len(b) == SETTINGS["max_new_tokens"]
        diverged = [t for t in range(len(a)) if a[t] != b[t]]
        if diverged:
            margin = _margin(params_j, cfg_j, prompt, a, diverged[0])
            assert margin < 2 * BF16_LOGIT_TOL, (uid, diverged[0], margin)
    for key in ("restores", "replayed_requests", "checkpoints_written", "decode_steps",
                "prefill_calls", "host_transfers"):
        assert restored["port"].stats()[key] == restored["ref"].stats()[key], key


# ---------------------------------------------------------------------------
# the recurrent layer kinds: the snapshot carries the conv and state / h
# leaves of every slot
# ---------------------------------------------------------------------------

RECURRENT = ("mamba2-130m", "recurrentgemma-9b")
# float leaves of the recurrent models' snapshots, relative to their scale:
# in bf16 the two packages part by a few roundings with depth (the
# reference computes GELU and SiLU op by op in bf16, and bf16 matmuls sum
# in another order), and recurrentgemma's fourth layer (the local layer's
# K rows, behind two RG-LRU blocks and their MLPs) is 1.5% away
RECURRENT_SNAPSHOT_TOL = 2e-2


@pytest.fixture(scope="module")
def recurrent():
    """Reduced mamba2-130m and recurrentgemma-9b as ``model`` holds qwen:
    the reference's f32 tree and the port's f32 copy of it."""
    out = {}
    for arch in RECURRENT:
        cfg_j = jax_reduce_config(jax_get_config(arch))
        params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
        cfg_t = reduce_config(get_config(arch))
        out[arch] = {"ref": (cfg_j, params_j),
                     "port": (cfg_t, params_from_jax(jax.device_get(params_j), cfg_t,
                                                     device="cpu", dtype=torch.float32))}
    return out


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("kill_at", [1, 3])
def test_recurrent_kill_restore_bit_exact(recurrent, tmp_path, arch, kill_at):
    """Killed after admission and mid-decode: the restored engine finishes
    every request with the uninterrupted run's streams, bit for bit."""
    eng = _check_resumed(recurrent[arch], _ecfg(), tmp_path, kill_at)
    assert not eng._packable


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_snapshot_and_restore_match_the_reference(recurrent, tmp_path, arch):
    """The reference's snapshot of the same kill schedule: the same leaf
    names (``conv`` and ``state`` or ``h`` of every unit), shapes, dtypes
    and values, the same meta record, and restored streams equal but at a
    near-tie."""
    _snapshot_and_restore_match(recurrent[arch], tmp_path, 0, tol=RECURRENT_SNAPSHOT_TOL)
    _, meta, _ = sc.load_newest_intact(os.path.join(str(tmp_path), "port"))
    arr, _, _ = sc.load_newest_intact(os.path.join(str(tmp_path), "port"))
    leaves = {k.rsplit("/", 1)[-1] for k in arr if k.startswith("cache/")}
    assert {"conv", "state" if arch == "mamba2-130m" else "h"} <= leaves


@pytest.mark.parametrize("arch", RECURRENT)
def test_valid_len_of_a_recurrent_pool(recurrent, arch):
    """``valid_len`` reads the ``pos`` leaves: 0 where the stack has none
    (mamba2, as the reference's), the prompt's length on recurrentgemma's
    local layers once a prompt is admitted."""
    eng = _engine(recurrent[arch], _ecfg())
    assert eng.pool.valid_len(0) == 0
    eng.submit(np.arange(1, 6))
    eng.step()
    assert eng.pool.valid_len(0) == (0 if arch == "mamba2-130m" else 6)


# ---------------------------------------------------------------------------
# multi-head latent attention: the snapshot carries the latent leaves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    """Reduced deepseek-v2-236b as ``model`` holds qwen: the reference's f32
    tree and the port's f32 copy of it."""
    cfg_j = jax_reduce_config(jax_get_config("deepseek-v2-236b"))
    params_j = TJ.init_params(cfg_j, jax.random.PRNGKey(0), param_dtype=jnp.float32)
    cfg_t = reduce_config(get_config("deepseek-v2-236b"))
    return {"ref": (cfg_j, params_j),
            "port": (cfg_t, params_from_jax(jax.device_get(params_j), cfg_t, device="cpu",
                                            dtype=torch.float32))}


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_mla_kill_restore_bit_exact(mla, tmp_path, kv_bits):
    """Killed mid-decode: the restored engine finishes every request with
    the uninterrupted run's streams, bit for bit; the restored pool's
    latents are bf16 under ``kv_bits`` 8 too."""
    eng = _check_resumed(mla, _ecfg(kv_bits=kv_bits), tmp_path, kill_at=3)
    kinds = {k.split("/")[-1]: v.dtype for k, v in sc.flatten_tree(eng.pool.cache).items()}
    assert kinds == {"ckv": torch.bfloat16, "kr": torch.bfloat16, "pos": torch.int32}


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_mla_snapshot_and_restore_match_the_reference(mla, tmp_path, kv_bits):
    """The reference's snapshot of the same kill schedule: the same latent
    leaves, shapes, dtypes (bf16 under ``kv_bits`` 8) and values, the same
    meta record, and restored streams equal but at a near-tie."""
    _snapshot_and_restore_match(mla, tmp_path, kv_bits)
