"""Atomic-checkpoint core (counterpart of the reference's ``ckpt.py``): the
storage primitives under the serving engine's snapshots.

- **tree <-> flat dict** — :func:`flatten_tree` / :func:`unflatten_tree`
  join the dict keys and list indices of a nested tree of tensors and
  numpy arrays with ``/`` (``cache/stack/0/u0/attn/k``, the reference's
  keys), so a whole tree round-trips through one npz archive.  Flat
  dicts hold CPU tensors.
- **dtype-safe npz** — :func:`save_arrays` / :func:`load_arrays`: numpy
  has no bfloat16, so a bf16 leaf is stored as its uint16 bits and the
  true dtype names ride along in a reserved JSON entry (``__dtypes__``),
  the reference's format: either package reads the other's archives.
- **integrity digest** — :func:`digest_arrays`: one sha256 over every
  leaf's (key, shape, dtype name, bytes) in sorted key order, equal to the
  reference's on the same leaves.  A torn write or a flipped bit shows up
  at restore time, not as wrong tokens later.
- **atomic directory commit** — :func:`atomic_save_dir`: populate a temp
  dir, ``os.replace`` it into place, and rewrite the ``LATEST`` pointer
  last.  A process dying at any instruction leaves the previous
  checkpoint restorable.

:func:`retry` wraps transient-failure-prone IO in bounded retries with
exponential backoff.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

# reserved key inside the npz for the {leaf key: true dtype name} map —
# leaf keys are tree paths joined with "/" and never collide
DTYPE_KEY = "__dtypes__"

# numpy has no bfloat16: its leaves are stored as uint16 under this name
# (the name the reference's ml_dtypes arrays carry)
BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# tree <-> flat dict of CPU tensors
# ---------------------------------------------------------------------------

def tree_items(tree, prefix=""):
    """(``/``-joined path, leaf) of every tensor or array in ``tree``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _host_copy(leaf) -> torch.Tensor:
    """A CPU tensor copy of a tensor (any device) or numpy array."""
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.array(leaf))
    return leaf.detach().to("cpu", copy=True)


def flatten_tree(tree) -> dict[str, torch.Tensor]:
    """Flatten a nested dict/list tree into {``/``-joined path: CPU tensor
    copy} (device leaves are copied to the host, numpy leaves wrapped)."""
    return {k: _host_copy(v) for k, v in tree_items(tree)}


def unflatten_tree(template, flat: dict, *, cast: bool = True):
    """Rebuild ``template``'s structure from a flat dict.

    Missing leaves and shape mismatches raise (a checkpoint of another
    config must fail loudly, not load garbage).  ``cast=True`` converts
    each leaf to the template leaf's dtype; ``cast=False`` keeps the stored
    dtype bit for bit.  A numpy template leaf gets a numpy array, a tensor
    template leaf a CPU tensor."""
    def build(tmpl, prefix):
        if isinstance(tmpl, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tmpl.items()}
        if isinstance(tmpl, (list, tuple)):
            return type(tmpl)(build(v, f"{prefix}{i}/") for i, v in enumerate(tmpl))
        key = prefix[:-1]
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = torch.as_tensor(flat[key])
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape {tuple(arr.shape)}, "
                             f"template expects {tuple(tmpl.shape)}")
        if isinstance(tmpl, np.ndarray):
            arr = arr.numpy()
            return arr.astype(tmpl.dtype) if cast else arr
        return arr.to(tmpl.dtype) if cast else arr
    return build(template, "")


# ---------------------------------------------------------------------------
# dtype-safe npz
# ---------------------------------------------------------------------------

def _storage_view(a) -> tuple[np.ndarray, str]:
    """(npz-safe numpy array, true dtype name) of a tensor or array.
    bfloat16 (a torch tensor, or an ml_dtypes array of kind ``V``) is
    viewed as same-width uints, which npz stores losslessly."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.contiguous().view(torch.int16).numpy().view(np.uint16), BF16
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.kind == "V":
        return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize]), a.dtype.name
    return a, a.dtype.name


def save_arrays(path: str, arrays: dict) -> None:
    """``np.savez`` of tensors or arrays, bfloat16 stored as its bits."""
    if DTYPE_KEY in arrays:
        raise ValueError(f"leaf key {DTYPE_KEY!r} is reserved")
    stored, dtypes = {}, {}
    for k, a in arrays.items():
        stored[k], dtypes[k] = _storage_view(a)
    stored[DTYPE_KEY] = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8)
    np.savez(path, **stored)


def load_arrays(path: str) -> dict[str, torch.Tensor]:
    """Inverse of :func:`save_arrays` (or of the reference's): CPU tensors
    of the true dtypes."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    dtypes = {}
    if DTYPE_KEY in flat:
        dtypes = json.loads(flat.pop(DTYPE_KEY).tobytes().decode())
    out = {}
    for k, a in flat.items():
        want = dtypes.get(k, a.dtype.name)
        if want == BF16:
            out[k] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(a if a.dtype.name == want else a.view(np.dtype(want)))
    return out


def digest_arrays(arrays: dict, extra: Optional[str] = None) -> str:
    """sha256 over every leaf's (key, shape, dtype name, bytes), sorted by
    key, plus an optional ``extra`` string (canonicalised metadata): the
    integrity hash stored beside, and checked against, a snapshot."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a, name = _storage_view(arrays[k])
        a = np.ascontiguousarray(a)
        h.update(k.encode())
        h.update(repr((tuple(a.shape), name)).encode())
        h.update(a.reshape(-1).view(np.uint8))
    if extra is not None:
        h.update(extra.encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# atomic directory commit + LATEST pointer
# ---------------------------------------------------------------------------

def atomic_save_dir(root: str, name: str, writer: Callable[[str], None], *,
                    prefix: Optional[str] = None, keep: int = 0) -> str:
    """Atomically materialise ``<root>/<name>`` via ``writer(tmp_dir)``.

    The writer populates a ``tmp.<name>`` sibling; one ``os.replace``
    commits the directory and the ``LATEST`` pointer is rewritten last
    (its own tmp + replace): the commit point.  ``keep`` > 0 deletes all
    but the newest ``keep`` ``prefix``-named siblings."""
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f"tmp.{name}")
    final = os.path.join(root, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    writer(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    latest_tmp = os.path.join(root, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(root, "LATEST"))
    if keep > 0 and prefix:
        gc_dirs(root, prefix, keep, protect=name)
    return final


def read_latest(root: str) -> Optional[str]:
    """The name the ``LATEST`` pointer commits to, or None when there is no
    pointer or it names a directory that does not exist."""
    ptr = os.path.join(root, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not name or not os.path.isdir(os.path.join(root, name)):
        return None
    return name


def list_snapshots(root: str, prefix: str) -> list[str]:
    """``prefix``-named checkpoint directories under ``root``, oldest first
    (names sort chronologically: they are zero-padded)."""
    if not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root)
                  if d.startswith(prefix) and os.path.isdir(os.path.join(root, d)))


def gc_dirs(root: str, prefix: str, keep: int, protect: Optional[str] = None) -> None:
    """Delete all but the newest ``keep`` ``prefix``-dirs (never the one named
    ``protect``: the snapshot just committed)."""
    names = list_snapshots(root, prefix)
    for d in names[:-keep] if keep > 0 else []:
        if d != protect:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)


# ---------------------------------------------------------------------------
# transient-failure retry
# ---------------------------------------------------------------------------

def retry(fn: Callable, *, retries: int = 0, backoff_s: float = 0.05,
          exceptions: tuple = (OSError,), sleep: Callable = time.sleep):
    """Run ``fn()``; on a transient failure retry up to ``retries`` times
    with exponential backoff (``backoff_s``, doubling).  The last failure
    re-raises: a store that stays broken must surface.  ``sleep`` is
    injectable so tests don't wait."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions:
            if attempt >= retries:
                raise
            sleep(backoff_s * (2 ** attempt))
            attempt += 1
