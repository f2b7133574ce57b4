"""The port's atomic-checkpoint core (``repro_torch.ckpt``), the
counterparts of ``tests/test_ckpt.py`` on torch tensors, and the format
held against the reference's: an archive written by either package's
``save_arrays`` is read by the other's ``load_arrays`` bit for bit, and the
two digests agree on the same leaves."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as ref_ckpt
from repro_torch.ckpt import (DTYPE_KEY, atomic_save_dir, digest_arrays, flatten_tree, gc_dirs,
                              list_snapshots, load_arrays, read_latest, retry, save_arrays,
                              unflatten_tree)


def _leaves():
    g = torch.Generator().manual_seed(0)
    return {"bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
            "i8": torch.randint(-128, 127, (4,), generator=g, dtype=torch.int8),
            "f32": torch.randn((2, 2), generator=g),
            "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "u8": torch.arange(16, dtype=torch.uint8),
            "bool": torch.tensor([True, False, True])}


def _bits(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes() if t.dtype != torch.bool \
        else t.numpy().tobytes()


def test_bf16_npz_roundtrip_is_bit_exact(tmp_path):
    """numpy has no bfloat16: save_arrays stores its bits, load_arrays gives
    the tensor back with its dtype."""
    arrays = _leaves()
    path = os.path.join(tmp_path, "arrs.npz")
    save_arrays(path, arrays)
    back = load_arrays(path)
    assert set(back) == set(arrays)
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        assert _bits(back[k]) == _bits(arrays[k]), k


def test_reserved_dtype_key_rejected(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        save_arrays(os.path.join(tmp_path, "x.npz"), {DTYPE_KEY: torch.zeros(1)})


def test_digest_detects_corruption():
    arrays = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    d0 = digest_arrays(arrays)
    flipped = {"a": arrays["a"].clone()}
    flipped["a"][0, 0] += 1
    assert digest_arrays(flipped) != d0
    # same bytes under a different dtype/shape must not collide
    assert digest_arrays({"a": arrays["a"].view(torch.int32)}) != d0
    assert digest_arrays({"a": arrays["a"].reshape(3, 2)}) != d0
    assert digest_arrays(arrays, extra="meta") != d0
    # a tensor and the numpy array of its values digest alike
    assert digest_arrays({"a": arrays["a"].numpy()}) == d0


def test_atomic_save_dir_commit_and_latest(tmp_path):
    root = str(tmp_path)

    def write(tmp):
        with open(os.path.join(tmp, "payload"), "w") as f:
            f.write("v1")

    path = atomic_save_dir(root, "snap_00000000", write, prefix="snap_")
    assert os.path.isdir(path)
    assert read_latest(root) == "snap_00000000"

    # a writer that dies mid-flight leaves the previous commit untouched
    def boom(tmp):
        raise OSError("disk full")

    with pytest.raises(OSError):
        atomic_save_dir(root, "snap_00000001", boom, prefix="snap_")
    assert read_latest(root) == "snap_00000000"
    assert list_snapshots(root, "snap_") == ["snap_00000000"]


def test_gc_keeps_newest_and_protects(tmp_path):
    root = str(tmp_path)
    for i in range(5):
        atomic_save_dir(root, f"snap_{i:08d}", lambda t: None, prefix="snap_")
    gc_dirs(root, "snap_", keep=2, protect="snap_00000000")
    assert list_snapshots(root, "snap_") == ["snap_00000000", "snap_00000003",
                                             "snap_00000004"]


def test_list_snapshots_missing_root(tmp_path):
    assert list_snapshots(os.path.join(tmp_path, "nope"), "snap_") == []
    assert read_latest(os.path.join(tmp_path, "nope")) is None


def test_retry_backoff_and_exhaustion():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert retry(flaky, retries=4, backoff_s=0.05, sleep=sleeps.append) == "ok"
    assert sleeps == [0.05, 0.1]          # exponential backoff

    calls["n"] = -100                     # always fails within budget
    with pytest.raises(OSError, match="transient"):
        retry(flaky, retries=2, backoff_s=0.01, sleep=sleeps.append)


def test_flatten_unflatten_roundtrip_and_mismatches():
    tree = {"a": [torch.arange(3, dtype=torch.int32), torch.ones((2, 2))],
            "b": {"c": torch.zeros((2,), dtype=torch.bfloat16),
                  "h": np.arange(4, dtype=np.int32)}}
    flat = flatten_tree(tree)
    assert set(flat) == {"a/0", "a/1", "b/c", "b/h"}
    # copies: writing the tree afterwards leaves the flat dict as it was
    tree["a"][0] += 7
    tree["b"]["h"] += 7
    assert flat["a/0"].tolist() == [0, 1, 2] and flat["b/h"].tolist() == [0, 1, 2, 3]
    back = unflatten_tree(tree, flat, cast=False)
    assert back["b"]["c"].dtype == torch.bfloat16
    assert isinstance(back["b"]["h"], np.ndarray) and back["b"]["h"].dtype == np.int32
    assert isinstance(back["a"], list)
    # cast=True converts to the template dtype, cast=False keeps the stored
    stored = dict(flat)
    stored["a/1"] = flat["a/1"].double()
    assert unflatten_tree(tree, stored)["a"][1].dtype == torch.float32
    assert unflatten_tree(tree, stored, cast=False)["a"][1].dtype == torch.float64
    with pytest.raises(KeyError, match="missing leaf"):
        unflatten_tree(tree, {k: v for k, v in flat.items() if k != "a/0"})
    bad = dict(flat)
    bad["a/0"] = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        unflatten_tree(tree, bad)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_archives_cross_read_with_the_reference_bit_for_bit(tmp_path, writer):
    """The port's ``.npz`` is the reference's format: what either writes the
    other reads, with the true dtypes (bf16 as ml_dtypes' bfloat16 in the
    reference) and the same bits, and both digests agree."""
    port = _leaves()
    ref = {k: np.asarray(jnp.asarray(v.float().numpy(), jnp.bfloat16)) if k == "bf16"
           else v.numpy() for k, v in port.items()}
    path = os.path.join(tmp_path, "x.npz")
    if writer == "port":
        save_arrays(path, port)
        back = ref_ckpt.load_arrays(path)
        for k, v in port.items():
            assert back[k].dtype.name == ref[k].dtype.name, k
            assert back[k].tobytes() == _bits(v), k
    else:
        ref_ckpt.save_arrays(path, ref)
        back = load_arrays(path)
        for k, v in port.items():
            assert back[k].dtype == v.dtype, k
            assert _bits(back[k]) == ref[k].tobytes(), k
    assert digest_arrays(port, extra="m") == ref_ckpt.digest_arrays(ref, extra="m")
