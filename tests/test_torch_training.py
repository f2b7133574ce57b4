"""The port's training substrate (``repro_torch.data``, ``repro_torch.training``):
the counterparts of ``tests/test_training.py``'s 18 tests against the port
on the CPU (reduced qwen2.5-3b, ``ShapeSpec("smoke", "train", 16, 4)``),
then the port held against the live reference: pipeline batches equal,
the schedule and AdamW on random f32 trees within 1e-6, compression codes
and scales bit for bit, the AdamW state carried across by
``opt_state_from_jax``, and a checkpoint written by the reference's
``Trainer`` resumed by the port's (f32 compute), its next 3 losses within
1e-4 of the reference's own continuation.
"""
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.ckpt import flatten_tree
from repro_torch.config import SHAPES, ShapeSpec, get_config, reduce_config
from repro_torch.data.pipeline import DataConfig, LMDataPipeline
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.compression import (_quant_leaf, compress_decompress,
                                              compressed_bytes, init_error)
from repro_torch.training import optimizer as OPT
from repro_torch.training.optimizer import (OptConfig, adamw_apply_, adamw_init,
                                            adamw_prepare, adamw_update, global_norm,
                                            schedule)
from repro_torch.training.trainer import Trainer, TrainerConfig

SMALL_SHAPE = ShapeSpec("smoke", "train", 16, 4)


def _trainer(tmp_path=None, opt_cfg=OptConfig(warmup_steps=2, total_steps=50), **kw):
    cfg = reduce_config(get_config("qwen2.5-3b"))
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path) if tmp_path else "", ckpt_every=0, **kw)
    return Trainer(cfg, SMALL_SHAPE, None, opt_cfg=opt_cfg, tcfg=tcfg, device="cpu")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic_across_constructions():
    c = DataConfig(vocab_size=97, seq_len=12, global_batch=4, seed=3)
    a = LMDataPipeline(c).global_batch_at(7)
    b = LMDataPipeline(c).global_batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_data_host_sharding_matches_global():
    """The union of the per-host shards is the global batch, whatever the
    host count (the elastic-resume invariant)."""
    base = dict(vocab_size=101, seq_len=8, global_batch=8, seed=1)
    full = LMDataPipeline(DataConfig(**base)).global_batch_at(5)["tokens"]
    for n_hosts in (2, 4):
        parts = [LMDataPipeline(DataConfig(**base, n_hosts=n_hosts, host_id=h)
                                ).batch_at(5)["tokens"] for h in range(n_hosts)]
        np.testing.assert_array_equal(np.concatenate(parts), full)


def test_data_steps_differ():
    p = LMDataPipeline(DataConfig(vocab_size=97, seq_len=12, global_batch=2, seed=0))
    assert not np.array_equal(p.global_batch_at(0)["tokens"], p.global_batch_at(1)["tokens"])


def test_data_tokens_in_range():
    t = LMDataPipeline(DataConfig(vocab_size=33, seq_len=64, global_batch=4)
                       ).global_batch_at(0)["tokens"]
    assert t.min() >= 0 and t.max() < 33


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=100)
    for _ in range(60):
        params, opt, _ = adamw_update({"w": 2 * params["w"]}, opt, params, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_clips_gnorm():
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    cfg = OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    _, _, m = adamw_update({"w": torch.full((3,), 1e6)}, opt, params, cfg)
    assert float(m["gnorm"]) > 1e5  # the raw norm is reported


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_resume_bitwise(tmp_path):
    t1 = _trainer(tmp_path / "ck")
    t1.run(3)
    t1.save()
    ref = [t1.train_step(t1.pipeline.global_batch_at(t1.step))["loss"] for _ in range(2)]
    t2 = _trainer(tmp_path / "ck")          # restores from LATEST (step 3)
    assert t2.step == 3
    got = [t2.train_step(t2.pipeline.global_batch_at(t2.step))["loss"] for _ in range(2)]
    assert ref == got, (ref, got)           # a bitwise identical continuation


def test_checkpoint_atomic_latest_pointer(tmp_path):
    d = str(tmp_path / "ck")
    CKPT.save_checkpoint(d, 1, params={"w": np.arange(4, dtype=np.float32)})
    CKPT.save_checkpoint(d, 2, params={"w": np.ones(4, np.float32)})
    assert CKPT.latest_step(d) == 2
    p, _, meta = CKPT.restore_checkpoint(d, params_template={"w": torch.zeros(4)})
    np.testing.assert_array_equal(p["w"].numpy(), np.ones(4))
    assert meta["step"] == 2


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(6):
        CKPT.save_checkpoint(d, s, params={"w": np.zeros(1)}, keep=2)
    dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    CKPT.save_checkpoint(d, 0, params={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError):
        CKPT.restore_checkpoint(d, params_template={"w": torch.zeros((3, 3))})


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_step_retry_on_transient_failure():
    t = _trainer(max_retries=2, retry_backoff_s=0.01)
    calls = {"n": 0}

    def flaky(attempt):
        calls["n"] += 1
        if attempt == 0:
            raise RuntimeError("injected executor fault")

    m = t.train_step(t.pipeline.global_batch_at(0), fault_hook=flaky)
    assert m["retries"] == 1
    assert calls["n"] == 2
    assert t.step == 1


def test_step_fails_after_max_retries():
    t = _trainer(max_retries=1, retry_backoff_s=0.01)
    before = {k: v.detach().clone() for k, v in t.params["embed"].items()}

    def always(attempt):
        raise RuntimeError("hard fault")

    with pytest.raises(RuntimeError, match="failed after"):
        t.train_step(t.pipeline.global_batch_at(0), fault_hook=always)
    assert t.step == 0  # nothing committed
    assert int(t.opt_state["count"]) == 0
    for k, v in before.items():
        assert torch.equal(t.params["embed"][k], v)


@pytest.mark.parametrize("saved", [True, False])
def test_a_fault_inside_the_update_is_not_retried(tmp_path, monkeypatch, saved):
    """The update raises after it has written its first leaf: the trainer
    does not retry from that part-written state.  It restores the last
    checkpoint (parameters, moments and count bit for bit) and raises,
    and goes on from there as an uninterrupted run does; with no
    checkpoint it refuses to go on."""
    t = _trainer(tmp_path / "ck" if saved else None)
    t.run(2)
    t.save()
    kept = {k: v.detach().clone() for k, v in
            flatten_tree({"p": t.params, "m": t.opt_state["m"], "v": t.opt_state["v"]}).items()}
    real, calls = OPT._update_leaf, []

    def fails_after_one_leaf(*args):
        calls.append(len(calls))
        if len(calls) > 1:
            raise RuntimeError("injected fault inside the update")
        real(*args)

    monkeypatch.setattr(OPT, "_update_leaf", fails_after_one_leaf)
    with pytest.raises(RuntimeError, match="inside its update"):
        t.train_step(t.pipeline.global_batch_at(t.step))
    assert calls == [0, 1]          # one leaf written, then the fault: no retry
    monkeypatch.undo()
    if not saved:
        assert t.params is None
        with pytest.raises(RuntimeError, match="no checkpoint"):
            t.train_step(t.pipeline.global_batch_at(2))
        return
    assert t.step == 2 and t.pipeline.state.step == 2 and int(t.opt_state["count"]) == 2
    back = flatten_tree({"p": t.params, "m": t.opt_state["m"], "v": t.opt_state["v"]})
    for k, v in kept.items():
        assert torch.equal(back[k], v), k
    whole = _trainer()
    whole.run(2)
    assert [m["loss"] for m in t.run(2)] == [m["loss"] for m in whole.run(2)]


def test_preemption_triggers_save_and_stop(tmp_path):
    t = _trainer(tmp_path / "ck")
    t.tcfg.ckpt_every = 0
    t.preemption._on_signal(signal.SIGTERM, None)  # simulate delivery
    out = t.run(10)
    assert len(out) == 1                      # stopped at the boundary
    assert CKPT.latest_step(str(tmp_path / "ck")) == 1


def test_straggler_watchdog_counts_slow_steps():
    t = _trainer(slow_step_factor=0.0)        # every step counts as slow
    t.run(3)
    assert t.slow_steps >= 1


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_compression_roundtrip_small_error():
    g = {"a": torch.linspace(-1, 1, 1000).reshape(10, 100)}
    out, err = compress_decompress(g)
    assert float((out["a"] - g["a"]).abs().max()) < 1.0 / 127 + 1e-6


def test_compression_error_feedback_unbiased():
    """With error feedback the running sum of compressed gradients follows
    the running sum of the true ones (the bias cancels)."""
    gen = torch.Generator().manual_seed(0)
    true_sum, comp_sum, err = torch.zeros(256), torch.zeros(256), None
    for _ in range(50):
        g = torch.randn(256, generator=gen) * 0.1
        cg, err = compress_decompress({"g": g}, err)
        true_sum += g
        comp_sum += cg["g"]
    # the residual is bounded by one quantisation step, not growing with steps
    assert float((true_sum - comp_sum).abs().max()) < 0.05


def test_compression_wire_bytes_4x_smaller():
    assert compressed_bytes({"a": torch.zeros((1024, 1024))}) < 0.3 * 4 * 1024 * 1024


# ---------------------------------------------------------------------------
# trainer end to end: the loss goes down
# ---------------------------------------------------------------------------

def test_loss_decreases_over_training():
    t = _trainer(opt_cfg=OptConfig(lr=5e-3, warmup_steps=2, total_steps=40))
    ms = t.run(25)
    first = np.mean([m["loss"] for m in ms[:5]])
    last = np.mean([m["loss"] for m in ms[-5:]])
    assert last < first - 0.05, (first, last)


# ---------------------------------------------------------------------------
# the port against the live reference
# ---------------------------------------------------------------------------

def test_shapes_are_the_reference_cells():
    from repro.config import SHAPES as REF_SHAPES
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in REF_SHAPES.items()}
    assert SHAPES["train_4k"].is_serving is False and SHAPES["decode_32k"].is_serving


@pytest.mark.parametrize("seed,step,n_hosts", [(0, 0, 1), (3, 7, 1), (1, 5, 2), (11, 123, 4)])
def test_pipeline_batches_equal_the_reference(seed, step, n_hosts):
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import LMDataPipeline as JPipeline
    base = dict(vocab_size=151_936, seq_len=40, global_batch=8, seed=seed)
    np.testing.assert_array_equal(LMDataPipeline(DataConfig(**base)).global_batch_at(step)
                                  ["tokens"],
                                  JPipeline(JDataConfig(**base)).global_batch_at(step)["tokens"])
    for h in range(n_hosts):
        kw = dict(base, n_hosts=n_hosts, host_id=h)
        got = LMDataPipeline(DataConfig(**kw)).batch_at(step)["tokens"]
        want = JPipeline(JDataConfig(**kw)).batch_at(step)["tokens"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _random_tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": [(rng.standard_normal((3,)) * scale).astype(np.float32),
                  {"c": (rng.standard_normal((2, 4, 3)) * scale).astype(np.float32)}],
            "z": np.asarray(rng.standard_normal() * scale, np.float32)}


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float(np.abs(g - w).max()) <= tol * max(float(np.abs(w).max()), 1e-30)


@pytest.mark.parametrize("grad_scale", [0.01, 1e3])    # below the clip and far above
def test_schedule_and_adamw_match_the_reference(grad_scale):
    """``schedule`` at every step of a warmup and cosine, and five AdamW
    steps on a random f32 tree (the clip on or off), each within 1e-6 of
    the reference's: parameters, both moments, gnorm, lr, the count."""
    from repro.training import optimizer as OJ
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=9, weight_decay=0.1, clip_norm=1.0)
    for step in range(12):
        got = float(schedule(OptConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
        want = float(OJ.schedule(OJ.OptConfig(**cfg), jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * abs(want), step
    rng = np.random.default_rng(0)
    params_j = _random_tree(rng)
    params_t, opt_t, opt_j = _t(params_j), None, OJ.adamw_init(params_j)
    opt_t = adamw_init(params_t)
    for _ in range(5):
        grads = _random_tree(rng, grad_scale)
        params_j, opt_j, mj = OJ.adamw_update(grads, opt_j, params_j, OJ.OptConfig(**cfg))
        params_t, opt_t, mt = adamw_update(_t(grads), opt_t, params_t, OptConfig(**cfg))
        assert abs(float(mt["gnorm"]) - float(mj["gnorm"])) <= 1e-6 * float(mj["gnorm"])
        assert abs(float(global_norm(_t(grads))) - float(mj["gnorm"])) <= \
            1e-6 * float(mj["gnorm"])
        assert float(mt["lr"]) == float(mj["lr"])
        _close(params_t, params_j, 1e-6)
        _close(opt_t["m"], opt_j["m"], 1e-6)
        _close(opt_t["v"], opt_j["v"], 1e-6)
    assert int(opt_t["count"]) == int(opt_j["count"]) == 5
    assert opt_t["count"].dtype == torch.int32


def test_adamw_in_place_equals_the_functional_update():
    rng = np.random.default_rng(1)
    params = _t(_random_tree(rng))
    grads = _t(_random_tree(rng, 3.0))
    opt = adamw_init(params)
    new_p, new_o, m = adamw_update(grads, opt, params, OptConfig())
    assert not any(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(new_p),
                                                     jax.tree_util.tree_leaves(params)))
    prep = adamw_prepare(grads, opt, OptConfig())
    same_o = adamw_apply_(grads, opt, params, OptConfig(), prep)
    assert same_o["m"]["a"] is opt["m"]["a"]
    assert float(prep["gnorm"]) == float(m["gnorm"]) and float(prep["lr"]) == float(m["lr"])
    assert int(same_o["count"]) == int(new_o["count"]) == 1
    for a, b in zip(jax.tree_util.tree_leaves((new_p, new_o["m"], new_o["v"])),
                    jax.tree_util.tree_leaves((params, same_o["m"], same_o["v"]))):
        assert torch.equal(a, b)


def test_compression_codes_and_scales_equal_the_reference():
    """Codes and scales bit for bit (round half to even on both sides, ties
    included), and the round trip and its residual with them."""
    from repro.training import compression as CJ
    rng = np.random.default_rng(2)
    leaves = [rng.standard_normal((300, 7)).astype(np.float32) * 1e-3,
              # a block whose scale is 1 exactly and whose values end in .5: ties
              np.concatenate([[127.0], np.arange(-126.5, 127.0, 1.0)]).astype(np.float32),
              np.zeros(5, np.float32), rng.standard_normal(256).astype(np.float32)]
    for leaf in leaves:
        qt, st = _quant_leaf(torch.from_numpy(leaf))
        qj, sj = CJ._quant_leaf(jnp.asarray(leaf))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    tree = {"x": leaves[0], "y": [leaves[1], leaves[3]]}
    err_j = CJ.init_error(tree)
    err_t = init_error(_t(tree))
    for _ in range(3):
        gj, err_j = CJ.compress_decompress(tree, err_j)
        gt, err_t = compress_decompress(_t(tree), err_t)
        for a, b in zip(jax.tree_util.tree_leaves(gt), jax.tree_util.tree_leaves(gj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(err_t), jax.tree_util.tree_leaves(err_j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert compressed_bytes(_t(tree)) == CJ.compressed_bytes(tree)


def test_opt_state_carried_across_from_the_reference():
    """``opt_state_from_jax`` round-trips the reference's ``adamw_init`` and
    a state after one update: every moment leaf bit for bit under the
    parameters' names, f32, and the int32 count."""
    from repro.models import transformer as TJ
    from repro.training.optimizer import OptConfig as JOptConfig
    from repro.training.optimizer import adamw_init as jax_adamw_init
    from repro.training.optimizer import adamw_update as jax_adamw_update
    from repro_torch.convert import opt_state_from_jax
    from repro.ckpt import flatten_tree as jax_flatten
    from repro.config import get_config as jax_get_config
    from repro.config import reduce_config as jax_reduce_config
    cfg_j = jax_reduce_config(jax_get_config("qwen3-moe-30b-a3b"))
    cfg = reduce_config(get_config("qwen3-moe-30b-a3b"))
    params = TJ.init_params(cfg_j, jax.random.PRNGKey(0))
    opt0 = jax_adamw_init(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.sin(p * 7.0) + 0.1, params)
    _, opt1, _ = jax_adamw_update(grads, opt0, params, JOptConfig())
    for opt_j, count in ((opt0, 0), (opt1, 1)):
        opt_j = jax.device_get(opt_j)
        got = opt_state_from_jax(opt_j, cfg, device="cpu")
        assert got["count"].dtype == torch.int32 and int(got["count"]) == count
        for name in ("m", "v"):
            want = jax_flatten(opt_j[name])
            have = flatten_tree(got[name])
            assert set(have) == set(want)
            for key, w in want.items():
                assert have[key].dtype == torch.float32
                np.testing.assert_array_equal(have[key].numpy(), w)


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """The reference's ``Trainer`` (f32 compute: both ``loss_fn`` wrapped)
    trains 3 steps and saves; the port's ``Trainer`` restores that
    checkpoint (step, parameters, moments, count, data state) and its next
    3 losses match the reference's own continuation within 1e-4."""
    from repro.config import get_config as jax_get_config
    from repro.config import reduce_config as jax_reduce_config
    from repro.config import ShapeSpec as JShapeSpec
    from repro.launch.mesh import small_mesh
    from repro.models import transformer as TJ
    from repro.training.optimizer import OptConfig as JOptConfig
    from repro.training.trainer import Trainer as JTrainer
    from repro.training.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.models import transformer as TT
    monkeypatch.setattr(TJ, "loss_fn", functools.partial(TJ.loss_fn,
                                                         compute_dtype=jnp.float32))
    monkeypatch.setattr(TT, "loss_fn", functools.partial(TT.loss_fn,
                                                         compute_dtype=torch.float32))
    d = str(tmp_path / "ck")
    opt = dict(lr=5e-3, warmup_steps=2, total_steps=50)
    ref = JTrainer(jax_reduce_config(jax_get_config("qwen2.5-3b")),
                   JShapeSpec("smoke", "train", 16, 4), small_mesh(1, 1),
                   opt_cfg=JOptConfig(**opt), tcfg=JTrainerConfig(ckpt_dir=d, ckpt_every=0))
    ref.run(3)
    ref.save()
    want = [m["loss"] for m in ref.run(3)]

    port = Trainer(reduce_config(get_config("qwen2.5-3b")), SMALL_SHAPE, None,
                   opt_cfg=OptConfig(**opt),
                   tcfg=TrainerConfig(ckpt_dir=d, ckpt_every=0),
                   device="cpu")
    assert port.step == 3 and port.pipeline.state.step == 3
    assert int(port.opt_state["count"]) == 3
    assert all(t.requires_grad for t in jax.tree_util.tree_leaves(port.params))
    got = [m["loss"] for m in port.run(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # and the port's own checkpoint restores in the reference's trainer
    port.save()
    back = JTrainer(jax_reduce_config(jax_get_config("qwen2.5-3b")),
                    JShapeSpec("smoke", "train", 16, 4), small_mesh(1, 1),
                    opt_cfg=JOptConfig(**opt), tcfg=JTrainerConfig(ckpt_dir=d, ckpt_every=0))
    assert back.step == 6
    np.testing.assert_array_equal(np.asarray(back.params["embed"]["tok"]),
                                  port.params["embed"]["tok"].detach().numpy())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-large-v3", "bart-base",
                                  "llama-3.2-vision-90b"])
def test_batch_specs_match_the_reference(arch):
    from repro.config import SHAPES as JSHAPES
    from repro.config import get_config as jax_get_config
    from repro.launch.steps import batch_specs as jax_batch_specs
    from repro_torch.launch.steps import batch_specs
    for name in ("train_4k", "decode_32k"):
        got = batch_specs(get_config(arch), SHAPES[name])
        want = jax_batch_specs(jax_get_config(arch), JSHAPES[name])
        assert set(got) == set(want)
        for k, (shape, dtype) in got.items():
            assert shape == want[k].shape, (name, k)
            assert str(dtype).removeprefix("torch.") == str(want[k].dtype), (name, k)


def test_prefill_and_decode_steps_are_the_model_calls():
    """``make_prefill_step`` passes a batch's source keys to ``prefill`` by
    name, and ``make_decode_step`` calls ``decode_step``: the same logits
    and caches as the direct calls."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T
    cfg = reduce_config(get_config("whisper-large-v3"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4), generator=g),
             "frames": torch.randn((2, 16, cfg.d_model), generator=g)}
    kw = dict(impl="ref", kv_cap=8)
    logits, cache = make_prefill_step(cfg, **kw)(params, batch)
    want, want_cache = T.prefill(params, cfg, batch["tokens"], frames=batch["frames"],
                                 compute_dtype=torch.bfloat16, **kw)
    assert torch.equal(logits, want)
    tok, pos = logits.argmax(-1), torch.full((2,), 4, dtype=torch.int32)
    got, _ = make_decode_step(cfg, impl="ref")(params, cache, tok, pos)
    assert torch.equal(got, T.decode_step(params, cfg, want_cache, tok, pos, impl="ref")[0])
