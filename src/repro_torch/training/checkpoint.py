"""Atomic, resumable checkpointing for params / optimizer / data state
(counterpart of the reference's ``training/checkpoint.py``, on the port's
own storage core, :mod:`repro_torch.ckpt`).

The layout is the reference's, so either package restores the other's
checkpoints: ``<dir>/step_%08d/{params.npz, opt_state.npz, meta.json}``
and a ``LATEST`` pointer.  Each npz holds one array a leaf under its
``/``-joined tree path (``embed/tok``, ``stack/0/u0/attn/wq``,
``m/embed/tok``, ``count``), written with ``np.savez`` in the leaf's own
dtype (the trainer's leaves are f32 and the count int32).

- **Atomic**: written to ``tmp.step_<n>``, ``os.replace``d into place,
  then the ``LATEST`` pointer rewritten: a process dying mid-save leaves
  the last checkpoint restorable.
- **Bitwise resume**: params, both moments, the count and the data state
  round-trip exactly.
- **Preemption**: :class:`PreemptionHandler` turns SIGTERM into a save at
  the next step boundary.
- **Retention**: the newest ``keep`` checkpoints stay.
"""
from __future__ import annotations

import json
import os
import signal
import threading
from typing import Optional

import numpy as np

from repro_torch.ckpt import atomic_save_dir, flatten_tree, read_latest, unflatten_tree
from repro_torch.tree import tree_map


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: t.numpy() for k, t in flatten_tree(tree).items()}


def _unflatten(template, flat: dict, device):
    """``template``'s tree from ``flat``, each leaf cast to the template
    leaf's dtype (names and shapes checked) and put on ``device``."""
    tree = unflatten_tree(template, flat)
    return tree if device is None else tree_map(lambda t: t.to(device), tree)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, step: int, *, params, opt_state=None,
                    data_state: Optional[dict] = None,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomic save of trees of tensors or numpy arrays; returns the final
    checkpoint path."""
    def write(tmp: str) -> None:
        np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
        if opt_state is not None:
            np.savez(os.path.join(tmp, "opt_state.npz"), **_flatten(opt_state))
        meta = {"step": step, "data_state": data_state or {}, "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)

    return atomic_save_dir(ckpt_dir, f"step_{step:08d}", write, prefix="step_", keep=keep)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    """Where the checkpoint of ``step`` lives."""
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    name = read_latest(ckpt_dir)
    return None if name is None else int(name.split("_")[-1])


def restore_checkpoint(ckpt_dir: str, *, params_template, opt_template=None,
                       step: Optional[int] = None, device=None):
    """Restore (params, opt_state, meta) into the templates' trees (their
    leaves give names, shapes and dtypes: tensors, meta tensors included);
    the leaves land on ``device`` (default: the CPU).  A leaf missing or of
    another shape raises.  ``opt_state`` is None without a template or
    without ``opt_state.npz``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten(params_template, dict(z), device)
    opt_state = None
    opt_path = os.path.join(path, "opt_state.npz")
    if opt_template is not None and os.path.exists(opt_path):
        with np.load(opt_path) as z:
            opt_state = _unflatten(opt_template, dict(z), device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, meta


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

class PreemptionHandler:
    """SIGTERM -> save-at-next-step-boundary.  The training loop polls
    ``should_save`` once per step; the signal handler itself only flips a
    flag (async-signal-safe)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._installed = []
        for s in signals:
            try:
                prev = signal.signal(s, self._on_signal)
                self._installed.append((s, prev))
            except ValueError:  # not the main thread (tests)
                pass

    def _on_signal(self, signum, frame):
        self._flag.set()

    @property
    def should_save(self) -> bool:
        return self._flag.is_set()

    def reset(self):
        self._flag.clear()

    def uninstall(self):
        for s, prev in self._installed:
            signal.signal(s, prev)
        self._installed = []

