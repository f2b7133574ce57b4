"""Transformer → per-phase inter-chiplet traffic F_ij(t) (paper §3.2).

The paper profiles inference workloads (nvidia-smi + PyTorch traces) to get
the traffic matrix each NoI candidate is evaluated under.  We derive the
same phase structure analytically from the model configs — the operation
counts are exact because the Plane-A models implement the same graphs.

Phases per encoder/decoder block (Fig. 2a):
  ①  input embedding (one-time)    ReRAM_i → ReRAM_{i+1} pipeline
  ②③ W_{K,Q,V} load + KQV compute  DRAM→MC→SM (many-to-few, both ways)
  ④  score (QKᵀ, softmax, ·V)      SM↔SM within cluster, SM→MC spill
  ⑤  feed-forward                   ReRAM macro pipeline; MC → ReRAM head

A workload descriptor captures exactly what the traffic model needs —
dims, heads (MQA/GQA collapse the K/V share), enc/dec structure, and the
parallel MHA-FF flag (GPT-J) which overlaps ④ and ⑤.

Beyond the single fixed-length forward pass (``transformer_phases``, the
Table-4 calibration surface — never changed by the generation model), the
module derives full *generation* episodes:

- ``prefill_phases``    — the forward pass over the prompt **plus** the
  explicit KV-cache write-back traffic (SM→MC→DRAM) that a serving run
  performs so decode can read the cache later;
- ``decode_step_phases`` — one autoregressive step at a given KV position:
  per-token KQV (N=1, weights re-streamed), score over the *cached* KV
  (DRAM→MC→SM read traffic growing linearly with position, GQA-aware via
  ``kv_frac``), cross-attention over the frozen encoder KV (enc-dec), FF
  and lm_head per token.  Decode phases repeat over the *decoder* stack
  only (``n_dec_layers``).

The decode step is **batched**: ``decode_step_phases(w, kv_pos, batch=B)``
models one engine iteration serving ``B`` active KV slots.  Weight
streaming (W_KQV, the attention output projection, the cross projection)
is paid **once per step** — the continuous-batching engine amortises it
across the batch — while everything per-slot (activations, KV-cache reads
at each slot's own position, KV row commits, FF/lm_head work) sums over
the active slots.  ``kv_pos`` may be a single position (every slot at the
same depth) or a sequence of per-slot positions; KV-read traffic is linear
in the *sum* of slot positions.  ``batch=1`` is bit-identical to the
unbatched step.

**Precision plane**: a workload carries ``weight_bits`` / ``kv_bits``
(default 16 — the paper's fp16 assumption, ``BYTES``).  Weight-streaming
terms scale with ``weight_bits`` and KV-cache terms with ``kv_bits``, so
the Plane-A quantisation plane (``repro_torch.quant``: int8 / packed-int4
weights, quantised slot-pool KV) propagates into what *bytes* move on the
fabric, not just when they move.  Quantised terms add the f32 scale
overhead the Plane-A layout actually stores (one scale per output channel
for weights, one per (token, head) KV row); at 16 bits every term is
bit-identical to the pre-quantisation model — the Table-4 calibration
contract is untouched.
"""
from __future__ import annotations

import dataclasses
import math
import numbers
from typing import Optional

from repro_torch.config import ModelConfig

BYTES = 2  # fp16 *activation* operands (the paper's 16-bit assumption);
#            weight / KV-cache terms use Workload.weight_bits / kv_bits

SCALE_BYTES = 4  # f32 quantisation scales (repro_torch.quant stores f32 planes)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    seq_len: int
    enc_dec: bool = False
    parallel_mha_ff: bool = False        # GPT-J (paper eq. 9)
    n_enc_layers: int = 0                # encoder share of n_layers (enc-dec)
    weight_bits: int = 16                # streamed-weight precision (16 = fp)
    kv_bits: int = 16                    # KV-cache precision (16 = fp)

    def __post_init__(self):
        # direct construction with enc_dec=True but no declared encoder
        # share keeps the legacy symmetric-stack assumption rather than
        # silently treating every layer as a decoder layer
        if self.enc_dec and self.n_enc_layers == 0:
            object.__setattr__(self, "n_enc_layers", self.n_layers // 2)
        for bits in (self.weight_bits, self.kv_bits):
            if bits not in (4, 8, 16):
                raise ValueError(f"precision must be 4, 8 or 16 bits, got {bits}")

    @property
    def n_dec_layers(self) -> int:
        """Decoder-stack depth — the layers that run per generated token."""
        return self.n_layers - self.n_enc_layers

    @property
    def kv_frac(self) -> float:
        """K/V share vs MHA (GQA/MQA collapse the cached heads)."""
        return self.n_kv_heads / self.n_heads

    def weight_dram_bytes(self, k_dim: int, n_dim: int) -> float:
        """DRAM bytes to stream one (k_dim, n_dim) weight matrix at this
        workload's weight precision.  Quantised weights add the f32
        per-output-channel scale plane (``repro_torch.quant`` layout); at 16 bits
        the term is bit-identical to ``k_dim * n_dim * BYTES``."""
        base = k_dim * n_dim * (self.weight_bits / 8)
        if self.weight_bits < 16:
            base += n_dim * SCALE_BYTES
        return base

    @classmethod
    def from_config(cls, cfg: ModelConfig, seq_len: int, *,
                    weight_bits: int = 16, kv_bits: int = 16) -> "Workload":
        return cls(
            name=cfg.name, d_model=cfg.d_model,
            n_layers=cfg.n_layers + cfg.n_encoder_layers,
            n_heads=max(cfg.n_heads, 1), n_kv_heads=max(cfg.n_kv_heads, 1),
            d_ff=cfg.d_ff or 4 * cfg.d_model, vocab=cfg.vocab_size,
            seq_len=seq_len, enc_dec=cfg.n_encoder_layers > 0,
            parallel_mha_ff=cfg.parallel_block,
            n_enc_layers=cfg.n_encoder_layers,
            weight_bits=weight_bits, kv_bits=kv_bits)


@dataclasses.dataclass
class Phase:
    """One execution phase with compute (by platform) and traffic terms."""
    name: str
    sm_flops: float = 0.0
    reram_flops: float = 0.0
    dram_bytes: float = 0.0          # DRAM→MC weight/act streaming
    sm_mc_bytes: float = 0.0         # many-to-few SM↔MC exchange
    reram_pipe_bytes: float = 0.0    # ReRAM_i→ReRAM_{i+1} (SFC pipeline)
    mc_reram_bytes: float = 0.0      # macro head/tail ↔ MC
    host_bytes: float = 0.0          # baseline host round-trips only
    dram_dram_bytes: float = 0.0     # DRAM→NoI→DRAM re-sharding (recovery
    #                                  KV migration off a failed chiplet —
    #                                  0 on every nominal workload phase)
    repeat: int = 1                  # executed per layer?


def transformer_phases(w: Workload) -> list[Phase]:
    N, D, F, h = w.seq_len, w.d_model, w.d_ff, w.n_heads
    hd = D // h
    kv_frac = w.n_kv_heads / w.n_heads

    phases = [Phase(
        "embed",
        reram_flops=2.0 * N * D,                       # MVM lookup+pos (eq. 1)
        reram_pipe_bytes=N * D * BYTES,
        mc_reram_bytes=N * D * BYTES,
    )]

    # ② load W_K,Q,V through MCs + ③ KQV compute on SMs (eqs 2-3)
    w_kqv = w.weight_dram_bytes(D, (1 + 2 * kv_frac) * D)  # MQA shrinks K/V
    kqv = Phase(
        "kqv",
        sm_flops=2.0 * N * D * D * (1 + 2 * kv_frac),
        dram_bytes=w_kqv + N * D * BYTES,
        sm_mc_bytes=N * D * (1 + 2 * kv_frac) * BYTES,
        repeat=w.n_layers,
    )
    # ④ score: QKᵀ + softmax + ·V + output proj (eqs 4-7), fused on SM
    score = Phase(
        "score",
        sm_flops=2.0 * N * N * D * 2 + 2.0 * N * D * D,
        sm_mc_bytes=2 * N * D * BYTES,
        dram_bytes=w.weight_dram_bytes(D, D),
        repeat=w.n_layers,
    )
    # ⑤ feed-forward on the ReRAM macro (two FC layers, weight-stationary)
    ff = Phase(
        "ff",
        reram_flops=2.0 * N * D * F * 2,
        mc_reram_bytes=2 * N * D * BYTES,
        reram_pipe_bytes=N * F * BYTES,
        repeat=w.n_layers,
    )
    phases += [kqv, score, ff]
    if w.enc_dec:
        # decoder cross-attention adds one extra attention block per
        # *decoder* layer — repeat follows the decoder stack, not half the
        # total (which was only correct for symmetric enc/dec stacks)
        cross = Phase(
            "cross",
            sm_flops=2.0 * N * N * D + 2.0 * N * D * D * (1 + 2 * kv_frac) / 2,
            sm_mc_bytes=2 * N * D * BYTES,
            dram_bytes=w.weight_dram_bytes(D, D),
            repeat=w.n_dec_layers,
        )
        phases.append(cross)
    phases.append(Phase("lm_head",
                        reram_flops=2.0 * N * D * w.vocab / max(N, 1),
                        mc_reram_bytes=D * w.vocab * BYTES / max(N, 1)))
    return phases


# ---------------------------------------------------------------------------
# generation: prefill (+KV write-back) and per-token decode phases
# ---------------------------------------------------------------------------

def kv_cache_bytes_per_layer(w: Workload, kv_len: int) -> float:
    """K + V cache rows for ``kv_len`` positions of one (decoder) layer —
    the quantity streamed DRAM→MC→SM at every decode step and written back
    during prefill.  GQA/MQA shrink it by ``kv_frac``; ``w.kv_bits``
    shrinks the element bytes (quantised rows add the per-(token, head)
    f32 scale the Plane-A pool stores; 16 bits is bit-identical to fp)."""
    base = 2.0 * kv_len * w.d_model * w.kv_frac * (w.kv_bits / 8)
    if w.kv_bits < 16:
        base += 2.0 * kv_len * w.n_kv_heads * SCALE_BYTES
    return base


def prefill_phases(w: Workload) -> list[Phase]:
    """Prompt-ingest phases of a generation episode: the single forward
    pass over ``w.seq_len`` prompt tokens **plus** the explicit KV-cache
    write-back (SM→MC→DRAM) that the fixed-length model omits.  For
    enc-dec workloads the written cache is the cross-KV projection of the
    encoder output (same N·D·kv_frac footprint per decoder layer).

    ``transformer_phases`` itself is untouched — it remains the Table-4
    calibration surface."""
    kv_bytes = kv_cache_bytes_per_layer(w, w.seq_len)
    return transformer_phases(w) + [Phase(
        "kv_write",
        sm_mc_bytes=kv_bytes,            # SM→MC hand-off of the fresh K/V
        dram_bytes=kv_bytes,             # MC→DRAM cache commit
        repeat=w.n_dec_layers,
    )]


def _decode_batch_positions(kv_pos, batch: int) -> list[int]:
    """Normalise ``decode_step_phases``'s (kv_pos, batch) arguments into the
    per-slot position list.  An int position replicates over the batch; a
    sequence gives each slot its own depth (its length must match
    ``batch`` unless batch is the default 1, which it then overrides)."""
    if isinstance(kv_pos, numbers.Number):   # incl. numpy scalars
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        return [int(kv_pos)] * batch
    positions = [int(p) for p in kv_pos]
    if not positions:
        raise ValueError("kv_pos sequence is empty")
    if batch not in (1, len(positions)):
        raise ValueError(f"batch={batch} != len(kv_pos)={len(positions)}")
    return positions


def decode_weight_stream_bytes(w: Workload) -> float:
    """DRAM weight-streaming bytes of one decode *step* — the component
    paid once per step regardless of batch (W_KQV + attention output
    projection per decoder layer, + the cross output projection for
    enc-dec stacks).  Everything else in the step scales per slot."""
    D = w.d_model
    per_layer = (w.weight_dram_bytes(D, (1 + 2 * w.kv_frac) * D)
                 + w.weight_dram_bytes(D, D))
    if w.enc_dec:
        per_layer += w.weight_dram_bytes(D, D)
    return per_layer * w.n_dec_layers


def decode_step_phases(w: Workload, kv_pos, batch: int = 1) -> list[Phase]:
    """One autoregressive decode step over ``batch`` active KV slots.

    N=1 per slot: weights are re-streamed per *step* (the memory-bound
    regime; the batch amortises them), the score phase reads each slot's
    whole cached K/V (linear in the sum of slot positions, GQA-aware),
    each slot's fresh K/V row is written back, and enc-dec stacks re-read
    the frozen cross-KV of the ``w.seq_len``-token source per slot.  All
    per-layer phases repeat over the decoder stack only.

    ``kv_pos`` is a single position (all slots at the same depth) or a
    sequence of per-slot positions.  ``batch=1`` reproduces the unbatched
    step bit-identically."""
    positions = _decode_batch_positions(kv_pos, batch)
    B, sum_pos = len(positions), sum(positions)
    D, F, k = w.d_model, w.d_ff, w.n_dec_layers
    kv_frac = w.kv_frac
    kv_read = kv_cache_bytes_per_layer(w, sum_pos)   # Σ per-slot cache reads
    kv_write = kv_cache_bytes_per_layer(w, 1)
    w_kqv = w.weight_dram_bytes(D, (1 + 2 * kv_frac) * D)  # once per step

    phases = [Phase(
        "embed_dec",                      # per-slot 1-token embedding lookup
        reram_flops=B * 2.0 * D,
        reram_pipe_bytes=B * D * BYTES,
        mc_reram_bytes=B * D * BYTES,
    )]
    phases.append(Phase(
        "kqv_dec",                        # per-slot projections + KV commit
        sm_flops=B * 2.0 * D * D * (1 + 2 * kv_frac),
        dram_bytes=w_kqv + B * D * BYTES + B * kv_write,
        sm_mc_bytes=B * D * (1 + 2 * kv_frac) * BYTES + B * kv_write,
        repeat=k,
    ))
    phases.append(Phase(
        "score_dec",                      # q·Kᵀ, softmax, ·V over each cache
        sm_flops=2.0 * sum_pos * D * 2 + B * 2.0 * D * D,
        dram_bytes=w.weight_dram_bytes(D, D) + kv_read,
        sm_mc_bytes=B * 2 * D * BYTES,
        repeat=k,
    ))
    if w.enc_dec:
        enc_kv = kv_cache_bytes_per_layer(w, w.seq_len)
        phases.append(Phase(
            "cross_dec",                  # attend over the frozen cross-KV
            sm_flops=B * (2.0 * w.seq_len * D * 2 + 2.0 * D * D),
            dram_bytes=w.weight_dram_bytes(D, D) + B * enc_kv,
            sm_mc_bytes=B * 2 * D * BYTES,
            repeat=k,
        ))
    phases.append(Phase(
        "ff_dec",                         # ReRAM-stationary: all per-slot
        reram_flops=B * 2.0 * D * F * 2,
        mc_reram_bytes=B * 2 * D * BYTES,
        reram_pipe_bytes=B * F * BYTES,
        repeat=k,
    ))
    phases.append(Phase(
        "lm_head_dec",                    # every generated token pays the head
        reram_flops=B * 2.0 * D * w.vocab,
        mc_reram_bytes=B * (D + w.vocab) * BYTES,
    ))
    return phases


# ---------------------------------------------------------------------------
# speculative decoding: k-token draft + verify steps (acceptance-amortised)
# ---------------------------------------------------------------------------

def spec_tokens_per_step(spec_k: int, acceptance: float) -> float:
    """Expected tokens committed per slot by one speculative step.

    With per-draft acceptance probability ``a`` the leading accepted run
    has length ``n`` with ``P(n >= j) = a^j``, so ``E[n] = sum a^j``; the
    verify pass always contributes one extra token (the correction /
    bonus token), hence ``E[committed] = 1 + sum_{j=1..k} a^j``.  At
    ``a=0`` this is 1 (plain decode cadence, every draft wasted); at
    ``a=1`` it is ``k+1``."""
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance must be in [0, 1], got {acceptance}")
    return 1.0 + sum(acceptance ** j for j in range(1, spec_k + 1))


def spec_decode_step_phases(w: Workload, kv_pos, batch: int = 1, *,
                            spec_k: int, draft_w: Optional[Workload] = None,
                            ) -> list[Phase]:
    """One speculative decode step: ``spec_k`` draft decode steps plus a
    single ``(spec_k+1)``-token verify pass over ``batch`` KV slots.

    The draft passes are plain ``decode_step_phases`` executions of the
    draft workload (``draft_w`` — defaults to ``w`` itself, i.e.
    self-speculation at serving precision; pass
    ``dataclasses.replace(w, weight_bits=8)`` for a quantised self-draft
    or a small-model workload for draft-model speculation) at successive
    KV depths ``pos .. pos+spec_k-1``.

    The verify pass is where speculation beats plain decode: the target
    weight stream (W_KQV + output projection per decoder layer) is paid
    **once** while activations, KV-cache reads and KV row commits scale
    with the ``spec_k+1`` in-stream tokens per slot — so the
    bytes-per-committed-token falls as acceptance rises (divide this
    step's traffic by ``batch * spec_tokens_per_step(spec_k, a)``).
    Rejected rows are invalidated host-side (index writes, no fabric
    stream), so the verify commit traffic is the same whether drafts are
    accepted or not — acceptance only changes what the step *yields*.

    ``decode_step_phases`` and ``transformer_phases`` are untouched: at
    ``spec_k=0`` with no draft this returns exactly the plain step's
    phases (Table-4 / batch-1 calibration pins are preserved)."""
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if w.enc_dec:
        raise ValueError("speculative decode models decoder-only stacks "
                         "(the serving engine's packable contract)")
    if spec_k == 0:
        return decode_step_phases(w, kv_pos, batch)
    positions = _decode_batch_positions(kv_pos, batch)
    B = len(positions)
    dw = draft_w if draft_w is not None else w
    phases: list[Phase] = []
    # -- draft: spec_k plain decode steps of the draft workload ----------
    for j in range(spec_k):
        dpos = [p + j for p in positions]
        for p in decode_step_phases(dw, dpos, B):
            phases.append(dataclasses.replace(p, name=f"draft{j}_{p.name}"))
    # -- verify: T in-stream tokens per slot, target weights once --------
    T = spec_k + 1
    sum_pos = sum(positions)
    D, F, k = w.d_model, w.d_ff, w.n_dec_layers
    kv_frac = w.kv_frac
    # row j of the in-stream block attends its slot's pos+j cached rows
    attend = T * sum_pos + B * T * (T - 1) // 2
    kv_read = kv_cache_bytes_per_layer(w, attend)
    kv_write = kv_cache_bytes_per_layer(w, T)        # T fresh rows per slot
    w_kqv = w.weight_dram_bytes(D, (1 + 2 * kv_frac) * D)  # once per step
    phases.append(Phase(
        "verify_embed",
        reram_flops=B * T * 2.0 * D,
        reram_pipe_bytes=B * T * D * BYTES,
        mc_reram_bytes=B * T * D * BYTES,
    ))
    phases.append(Phase(
        "verify_kqv",                     # weights once, T commits per slot
        sm_flops=B * T * 2.0 * D * D * (1 + 2 * kv_frac),
        dram_bytes=w_kqv + B * T * D * BYTES + B * kv_write,
        sm_mc_bytes=B * T * D * (1 + 2 * kv_frac) * BYTES + B * kv_write,
        repeat=k,
    ))
    phases.append(Phase(
        "verify_score",                   # each in-stream row reads the cache
        sm_flops=2.0 * attend * D * 2 + B * T * 2.0 * D * D,
        dram_bytes=w.weight_dram_bytes(D, D) + kv_read,
        sm_mc_bytes=B * T * 2 * D * BYTES,
        repeat=k,
    ))
    phases.append(Phase(
        "verify_ff",
        reram_flops=B * T * 2.0 * D * F * 2,
        mc_reram_bytes=B * T * 2 * D * BYTES,
        reram_pipe_bytes=B * T * F * BYTES,
        repeat=k,
    ))
    phases.append(Phase(
        "verify_lm_head",                 # logits at all T positions
        reram_flops=B * T * 2.0 * D * w.vocab,
        mc_reram_bytes=B * T * (D + w.vocab) * BYTES,
    ))
    return phases


# ---------------------------------------------------------------------------
# recovery: checkpoint write-back and KV-shard migration (crash safety)
# ---------------------------------------------------------------------------

def pool_kv_bytes_per_layer(w: Workload, kv_pos, batch: int = 1) -> float:
    """KV bytes one decoder layer holds for a ``batch``-slot pool at the
    given per-slot positions — the per-layer footprint a snapshot writes
    and a recovery re-materialises.  Linear in the *sum* of positions
    (``kv_cache_bytes_per_layer``), so it matches the decode-read
    accounting bit-for-bit."""
    positions = _decode_batch_positions(kv_pos, batch)
    return kv_cache_bytes_per_layer(w, sum(positions))


def checkpoint_phases(w: Workload, kv_pos, batch: int = 1, *,
                      every: int = 32) -> list[Phase]:
    """Per-decode-step amortised snapshot write-back stream.

    A crash-safe engine commits its full slot-pool state every ``every``
    iterations (``repro_torch.serving.checkpoint``); between snapshots the
    write-back streams SM→MC→DRAM exactly like the prefill ``kv_write``
    commit, amortised to ``1/every`` of the pool per step.  Appended to
    *generation* phase lists only — ``transformer_phases`` (the Table-4
    calibration surface) never carries it."""
    if every <= 0:
        raise ValueError(f"checkpoint period must be positive, got {every}")
    b = pool_kv_bytes_per_layer(w, kv_pos, batch) / every
    return [Phase("ckpt_write",
                  sm_mc_bytes=b,           # SM→MC hand-off of the dirty rows
                  dram_bytes=b,            # MC→DRAM snapshot commit
                  repeat=w.n_dec_layers)]


def recovery_phases(w: Workload, kv_pos, batch: int = 1, *,
                    lost_frac: float = 0.0) -> list[Phase]:
    """One-time recovery traffic after a chiplet loss (the MTTR event).

    Two streams, both priced on the *degraded* fabric (pass the same
    ``scenario=`` to the NoI evaluation that models the failure):

    - ``kv_migrate`` — the KV shards orphaned on the failed chiplet
      (``lost_frac`` of the pool: dead DRAM members / DRAM role size)
      re-materialise from their checkpoint/replica holders onto the
      surviving DRAM chiplets, DRAM→NoI→DRAM over surviving links;
    - ``ckpt_restore`` — the engine revives from its last snapshot: the
      full pool state streams DRAM→MC→SM once so decode can resume.

    ``lost_frac=0`` (a non-DRAM chiplet died) still pays the restore
    read; nominal workloads never include these phases, so the Table-4
    calibration surface is untouched."""
    if not 0.0 <= lost_frac <= 1.0:
        raise ValueError(f"lost_frac must be in [0, 1], got {lost_frac}")
    pool = pool_kv_bytes_per_layer(w, kv_pos, batch)
    phases = []
    if lost_frac > 0.0:
        phases.append(Phase("kv_migrate",
                            dram_dram_bytes=pool * lost_frac,
                            repeat=w.n_dec_layers))
    phases.append(Phase("ckpt_restore",
                        dram_bytes=pool,     # DRAM→MC snapshot read
                        sm_mc_bytes=pool,    # MC→SM re-prime of the pool
                        repeat=w.n_dec_layers))
    return phases


def phase_bytes(ph: Phase) -> float:
    """Total bytes one execution of a phase injects into the fabric."""
    return (ph.dram_bytes + ph.sm_mc_bytes + ph.reram_pipe_bytes
            + ph.mc_reram_bytes + ph.host_bytes + ph.dram_dram_bytes)


def total_traffic_bytes(phases: list[Phase]) -> float:
    """Repeat-weighted bytes injected by a whole phase list."""
    return sum(phase_bytes(p) * p.repeat for p in phases)


def rewrites_per_token(w: Workload) -> float:
    """ReRAM cell rewrites per token if attention ran on PIM (§4.4).

    K/Q/V intermediates change every token: writing N×(3·D) fp16 operand
    matrices into 2-bit cells → bit-writes per cell per token."""
    bits_per_token = 3 * w.d_model * 16          # KQV row writes
    score_bits = 2 * w.seq_len * w.n_heads * 16  # score + prob rows
    return (bits_per_token + score_bits) * w.seq_len / 2  # per 2-bit cell


# ---------------------------------------------------------------------------
# chiplet-level traffic matrices
# ---------------------------------------------------------------------------

def phase_traffic_matrix(phase: Phase, roles: dict[str, list[int]],
                         n_chiplets: int):
    """Expand a Phase into F_ij bytes between chiplet ids.

    roles: {"SM": [ids], "MC": [ids], "DRAM": [ids], "ReRAM": [ids SFC-ordered],
            "HOST": [ids]} — placement-independent logical traffic; the NoI
    evaluator maps it onto links via routing.
    """
    F = {}

    def add(i, j, b):
        if b <= 0 or i == j:
            return
        F[(i, j)] = F.get((i, j), 0.0) + b

    sms, mcs = roles.get("SM", []), roles.get("MC", [])
    drams, rerams = roles.get("DRAM", []), roles.get("ReRAM", [])
    hosts = roles.get("HOST", [])

    # DRAM→MC (point-to-point pairs) then MC→SM fan-out (many-to-few)
    if phase.dram_bytes and mcs:
        per_mc = phase.dram_bytes / len(mcs)
        for mi, m in enumerate(mcs):
            d = drams[mi % len(drams)] if drams else m
            add(d, m, per_mc)
        if sms:
            per_sm = phase.dram_bytes / len(sms)
            for s in sms:
                m = mcs[hash(s) % len(mcs)]
                add(m, s, per_sm)

    if phase.sm_mc_bytes and sms and mcs:
        per_sm = phase.sm_mc_bytes / len(sms)
        for si, s in enumerate(sms):
            m = mcs[si % len(mcs)]
            add(s, m, per_sm / 2)
            add(m, s, per_sm / 2)

    if phase.reram_pipe_bytes and len(rerams) > 1:
        # spatially-partitioned pipeline: the weights are sliced across the
        # macro, so each SFC hop carries only that stage's activation slice
        per_hop = phase.reram_pipe_bytes / len(rerams)
        for a, b in zip(rerams[:-1], rerams[1:]):
            add(a, b, per_hop)

    if phase.mc_reram_bytes and rerams and mcs:
        head, tail = rerams[0], rerams[-1]
        m = mcs[0]
        add(m, head, phase.mc_reram_bytes / 2)
        add(tail, m, phase.mc_reram_bytes / 2)

    if phase.dram_dram_bytes and len(drams) > 1:
        # recovery re-sharding: orphaned KV shards re-materialise across
        # the surviving DRAM chiplets (ring neighbours — each survivor
        # receives its share from the replica/checkpoint holder next to
        # it).  With one DRAM chiplet there is no inter-chiplet hop.
        per_hop = phase.dram_dram_bytes / len(drams)
        for di, d in enumerate(drams):
            add(d, drams[(di + 1) % len(drams)], per_hop)

    if phase.host_bytes and hosts:
        # host round trips (baselines): every SM/ReRAM talks to host
        src = sms or rerams
        per = phase.host_bytes / max(len(src), 1)
        for s in src:
            add(s, hosts[0], per / 2)
            add(hosts[0], s, per / 2)
    return F
