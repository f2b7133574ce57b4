"""Deterministic sharded LM data pipeline with exact skip-to-step resume
(the reference's ``data/pipeline.py``, copied: it is numpy alone, and the
port keeps its own copy rather than import the reference).

Production framing: every host in a multi-pod job constructs the same
pipeline object; each host materialises only its shard of the global batch
(`host_slice`), and the *data state* (a single step counter + seed) is part
of the checkpoint, so restart — on the same or a different host count — is
bitwise reproducible (counter-based stateless generation, no RNG state to
migrate).

Source: synthetic token streams (a fixed-seed mixture of Zipf-distributed
unigrams and order-2 Markov chains), which is the standard offline-
container stand-in for a tokenised corpus.  The interface (``__iter__`` /
``at_step`` / ``state``) is what a real corpus-backed pipeline would
implement; nothing downstream knows the difference.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # multi-host sharding: this host materialises rows
    # [host_id * global_batch // n_hosts, (host_id+1) * global_batch // n_hosts)
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        if not (0 <= self.host_id < self.n_hosts):
            raise ValueError("host_id out of range")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts


@dataclasses.dataclass
class DataState:
    """Everything needed to resume the stream exactly (checkpointed)."""
    step: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(step=int(d["step"]), seed=int(d["seed"]))


class LMDataPipeline:
    """Counter-based (stateless) batch generation: batch(step, row) depends
    only on (seed, step, global row index) — NOT on host count — so elastic
    re-sharding to a different host/device count replays identical tokens.
    """

    def __init__(self, cfg: DataConfig, state: Optional[DataState] = None):
        self.cfg = cfg
        self.state = state or DataState(seed=cfg.seed)
        # Zipf-ish unigram + order-2 Markov mixing weights, fixed by seed
        root = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._unigram = 1.0 / ranks ** 1.1
        self._unigram /= self._unigram.sum()
        self._mix = root.integers(1, cfg.vocab_size, size=64, dtype=np.int64)

    # -- core: one global row, pure function of (seed, step, row) ----------
    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, row]))
        toks = rng.choice(cfg.vocab_size, size=cfg.seq_len, p=self._unigram)
        # order-2 structure: x[t] correlates with a hash of the two previous
        # tokens on a fixed fraction of positions (gives a learnable signal)
        structured = rng.random(cfg.seq_len) < 0.5
        for t in range(2, cfg.seq_len):
            if structured[t]:
                h = (toks[t - 1] * 31 + toks[t - 2] * 17
                     + self._mix[t % len(self._mix)])
                toks[t] = h % cfg.vocab_size
        return toks.astype(np.int32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """This host's shard of the global batch for ``step``."""
        cfg = self.cfg
        lo = cfg.host_id * cfg.host_batch
        rows = [self._row(step, lo + i) for i in range(cfg.host_batch)]
        return {"tokens": np.stack(rows)}

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Full global batch (single-host testing / verification)."""
        rows = [self._row(step, i) for i in range(self.cfg.global_batch)]
        return {"tokens": np.stack(rows)}

    # -- iteration / resume -------------------------------------------------
    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.state.step)
            self.state.step += 1

    def at_step(self, step: int) -> "LMDataPipeline":
        """Skip-to-step resume (O(1): no stream replay needed)."""
        self.state.step = step
        return self
