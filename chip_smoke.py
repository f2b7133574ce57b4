#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which must pass or the script exits non-zero:

1. device  — the card's name and power limit, as nvidia-smi reports them;
2. build   — the CUDA kernels of ``src/repro_torch/kernels/csrc`` built with
             nvcc (``repro_torch.kernels.build``);
3. kernels — each of the five kernels against its plain PyTorch version on
             the card, at the serving path's shapes (qwen2.5-3b's,
             gemma2-9b's and qwen3-moe-30b-a3b's: every projection, the
             5120-entry global pool and the 4096-entry ring at head dim
             256, qwen3-moe's 4 KV heads and its padded prefills) and at
             edge cases
             (window, softcap, an empty slot, a pad-only tile, ragged
             lengths and shapes, GQA rep 1 and 8, f32, head_dim 256, int8 and
             int4, per-channel and per-group scales, M from 1 to 1024), with
             its time (at both models' shapes), the plain version's time, one
             PyTorch call's time (a
             yardstick the port never calls: ``scaled_dot_product_attention``
             with an explicit mask for attention, ``torch.matmul`` with the
             dequantised bf16 weights for the matmuls) and its bound; each
             dequant-matmul and prefill case prints the design it ran
             (tensor cores or CUDA cores) and is checked to run the one its
             dtype, head dims and group call for; each decode case, fp and
             quantised, prints its kernel and split count (wholly masked
             splits, one split, rep 16 and rep 32 in two row groups among
             them; fp also f32 hd 256 and V rows not 16-byte aligned;
             quantised also head dims 16 and 6, code rows shorter than 16
             bytes, and rep 20 in f32) and is
             checked to run the split count of its plan; split shapes of
             the dequant-matmul and of both decodes launched on two streams
             at once must give what they give on one, bit for bit; the
             prefill also without segments at the shapes the sequential
             baseline launches (qwen2.5-3b's buckets of 8..1024 tokens,
             gemma2-9b's exact lengths up to 4600 under its window); and
             the port's own MoE expert path (``grouped_matmul.cu``: the
             grouped matmul, plain and with the gate scale, the fused
             gate/up with its activation and row gather, the combine) at
             qwen3-moe-30b-a3b's shapes (gate/up K 2048 N 768, down K 768
             N 2048; T 64, 1024 and 3072 rows routed top-8 of 128) and edge
             cases (empty experts, every row to one expert, T 1, groups
             below the M tile, N off the tile, CUDA cores for f32, odd N and
             K below the TMA box; silu, gelu and relu2; the combine at k 1,
             2 and 8, in 16-byte pieces and element by element), each
             launched twice for the same bits on the design its plan names,
             timed at decode and prefill-384 with its plain version, its
             bound and ``torch._grouped_mm`` where the card's torch has it
             (else a matmul a group; for the combine ``index_add_``), the
             fused gate/up also beside the unfused composition of the new
             product; and the paper's Table 3 models' shapes (MHA: the decode
             over a 1024-entry pool and the 128-token packed prefill of
             llama2-7b at head dim 128, gpt-j at 256, bert-large
             and bert-base at 64; llama2-7b's kv8 and kv4 decode and its int8
             projections), each timed beside its plain version, its bound and
             the library call (but bert-base's, which times as bert-large's);
             and recurrentgemma-9b's (MQA rep 16 at head dim 256: the fp and
             quantised decodes over its 2048-entry rings, wrapped and not,
             the prefill without segments at its padded lengths 128..4608
             under window 2048, its int8 projections and the RG-LRU's
             ``w_gate`` at 8..4608 rows), each timed likewise; and
             deepseek-v2-236b's (MLA's prefill at q/k head dim 192 and v
             128 over 128 heads, in the layer's (B, S, H, d)
             layout: its padded prompts of 128..384 tokens, a packed
             stream, the buckets 32 and 64; its int8 ``wo``, dense MLP,
             shared experts and 102400-column lm_head at 1..384 rows; the
             expert path at 160 experts top-6, K 5120 N 1536 and back, T
             48, 768 and 2304, the combine at k 6), each timed likewise;
             and the outputs the split routes launch them with
             (``run_split_checks``): the fp and quantised (kv8, kv4)
             decodes with their log-sum-exp at qwen2.5-3b's pool and
             gemma2-9b's ring, an empty slot's rows exact zeros and
             ``NEG_INF``, the pool cut in two halves, each launched with
             its LSE and merged in torch against the whole-pool launch
             (one card standing in for two ranks); the prefill at a query
             row offset, each quarter of a stream against the same rows
             of the whole launch, on tensor cores at hd 128 and 256 and
             on CUDA cores in f32; the LSE launch and an offset quarter
             timed, and the main-path rows read beside PERF.md's;
4. engine  — the port's serving engine on full-width qwen2.5-3b and
             gemma2-9b (its depth cut to 8 of 42 layers for the script's
             time; local 4096-entry rings and global layers, head dim 256)
             with random bf16 weights, fp and then quantised
             (``w8kv8``, ``w4kv4``): 16 requests (prompts of 4..384 tokens,
             so chunked prefill runs; gemma2-9b adds one of 4600 tokens whose
             rings wrap), greedy, 32 new tokens each, with the launch count of
             each kernel during each run, checked against the run's steps and
             calls, every quantised projection checked to have run on tensor
             cores and every prefill on the design its head dim calls for,
             and every kernel of ``qmatmul.cu``, ``decode.cu``,
             ``decode_quant.cu`` and ``prefill.cu`` it launched checked to be
             one that phase 3 held against its plain version.  The engine
             replays its three programs (fused step, packed prefill, chunk
             step) from CUDA graphs captured when it is built, and traces
             each decode step's wall time (dispatch + fetch);
4a. graphs — each engine run again with its programs run through the
             eager methods: token streams bit for bit and every launch
             count equal (a replay counts what its capture launched);
             tokens/s, TTFT, TPOT, decode-step wall time, build time and
             peak memory, eager and replayed;
4b. baselines — at fp, sequential admission (``packed=False``) on both
             models (gemma2-9b's 4600-token prompt through a batch-1 prefill
             that wraps its rings) and the host-looped step
             (``fused=False``) on qwen2.5-3b, whose streams must equal the
             sequential fused path's bit for bit;
4c. sampling — qwen2.5-3b at temperature 0.8 through the graphs: the
             same seed repeats, another does not, replays draw anew; and
             again with speculative decoding (an 8-bit self-draft);
4d. spec   — speculative decoding (``spec_k`` 4), the spec step replayed
             from its graph: qwen2.5-3b at fp with self-drafts of 0, 8 and 4
             bits, at w8kv8 with a 4-bit draft and with a draft model (its
             config cut to 4 layers, a seed of its own), gemma2-9b at fp
             with an 8-bit draft (the 4600-token prompt's rings wrap under
             verify and rollback); each against the plain replayed drain
             of its configuration: full budgets, the same streams up to a
             token where the plain logits are a near-tie (printed), an
             acceptance of at least 0.9 with the serving params, launch
             counts against the steps (draft decodes = spec steps x
             spec_k x the draft's layers, and the draft model's catch-up),
             every kernel one that phase 3 checked; one run a model
             replayed again through the eager methods (streams bit for bit,
             launches equal) and one of its steps profiled;
4e. slo    — qwen2.5-3b on the real clock: 48 requests of ``make_workload``
             at twice the rate the plain drain sustained, offered open-loop
             through ``ServingFrontend.play`` to an engine with
             ``SloScheduler`` (two classes), ``deadline_ms`` and a bounded
             queue: each request finished (with its budget), expired or
             shed, some of each; TTFT p50/p95 a class;
4f. crash  — kill and restore between two steps (``serving/checkpoint.py``):
             the engine phase's requests through an ``EngineCheckpointer``,
             steps to a kill point (before any step, a prompt between
             chunks, mid-decode), a snapshot, one more request (in the
             journal only), two steps the crash throws away, the engine
             dropped with its graphs; ``ServingEngine.restore`` into a fresh
             engine (its own graphs captured), drained: every request once,
             the streams of the uninterrupted run (the same requests at the
             same steps) bit for bit, one restore and one replayed request.
             qwen2.5-3b (cut to 6 of its 36 layers, for the script's
             time) fp greedy and at temperature 0.8 at each kill kind,
             w8kv8 at 0.8, ``spec_k`` 4 with an 8-bit self-draft at 0.8 and
             with the draft model, ``fused=False``, and a child process
             (``--crash-child``) SIGKILLed after its snapshot, restored in
             this one; gemma2-9b w4kv4 (2 slots) killed mid-decode after the
             4600-token prompt's rings wrapped.  Each case prints the snapshot's bytes,
             the save split (device-to-host, digest, write, fsync) and the
             restore split (read, engine build, load); then tokens/s of a
             ``ServingFrontend`` drain with ``EngineCheckpointer(every=16)``
             beside one without (a reading);
5. crossbar — the PIM-MVM entry point ``pim_mvm`` on the shapes of
             ``benchmarks/kernel_micro.py``, f32 x (as there) and bf16 x,
             against its oracle and the fp product, with the kernel's launch
             count, the bf16 calls checked to have run on tensor cores, in
             kernels that phase 3 checked;
6. logits  — packed prefill plus 4 decode steps at full width with
             ``impl="flash"`` against ``impl="ref"``, fp and ``w8kv8``: qwen2.5-3b,
             gemma2-9b (with a 4200-token row: windowed prefill, a wrapped
             ring), gemma3-27b and minitron-8b (depth cut to one pattern
             period plus the remainder); the sequential baseline's
             first-token logits against the packed prefill's;
7. profile — torch.profiler over 4 full-pool decode steps and 2 chunk
             steps (8 rows of a 128-token chunk), fp and ``w8kv8``, of
             qwen2.5-3b and gemma2-9b, replayed and eager: device busy time,
             wall time and kernels launched per step (read, not checked);
7a. paper — the paper's Table 3 models at full width with random bf16
             weights: llama2-7b (16 of 32 layers, MHA 32/32), gpt-j (14 of 28,
             the parallel block, head dim 256), bert-large (24, LayerNorm,
             biases, learned positions) and bert-base (12), each serving the
             engine phase's 16 requests with ``kv_len`` 1024 at fp (llama2-7b
             also ``w8kv8``), replayed and again eagerly (streams bit for bit,
             launches equal and as the run's steps and calls reckon them,
             every kernel one that phase 3 held), a profiled decode step
             (wall and busy time, idle share), tokens/s, TTFT, TPOT and peak
             memory; flash against ref logits (llama2-7b fp and w8kv8, gpt-j,
             bert-large); Plane B's ``cosim_from_engine`` (64 chiplets) after
             llama2-7b's drains and gpt-j's fp drain, turned into
             ``benchmarks/perf_cosim.py``'s per-architecture rows (every key,
             every value finite: 2.5D-HI, HAIMA_chiplet and TransPIM_chiplet
             beside the engine's measured step time), and the Table-4 anchors
             (bert-base and gpt-j at 64 tokens) beside the paper's targets;
7b. calib — the profiling plane (``repro_torch.profile``), the four
             steps of ``benchmarks/perf_calib.py`` (its file not run, no
             JSON written): ``kernel_samples`` on llama2-7b at full width
             (MHA 32/32, hd 128: the decode over 8192..32768-entry pools
             at B 4 and 8, fp, kv8 and kv4; the causal prefill at S 8192,
             12288 and 16384, one segment a row; the dequant-matmul at M 8
             over five registered (K, N) shapes, int8 and int4), every
             bytes-fitted case streaming at least 100 MB, and
             ``executor_samples`` on full-width bert-base (the captured
             fused step replayed, B 1, 2, 4, 8), each point the median
             over 3 passes (5 of the executor), each timed call checked
             to have launched its kind's kernel; the fits (rate,
             intercept, r2, CI, held-out error) through a versioned table
             and its JSON, each held out within 0.5 and its rate at most
             1.05 x the card's peak for its term; ``measured_calib``
             beside ``CALIB``, ``phase_error_report`` and gpt-j's
             generation through Plane B under both; a traced drain of
             bert-base whose ``cosim_from_engine`` carries the measured
             step time; each kind's smallest case against its plain
             version;
8. moe     — full-width qwen3-moe-30b-a3b (cut to 16 of 48 layers, 128
             experts top-8, 20.4 GB of random bf16 weights) built once every
             earlier model is freed (the memory still allocated printed and
             bounded), serving the engine phase's 16 requests at fp and
             ``w8kv8``: each prompt admitted alone, padded to a chunk
             multiple, its fused decode step (MoE layers through the
             expert path) replayed from its CUDA graph and again eagerly
             (streams bit for bit, launches equal), the fused gate/up, the
             down product and the combine each checked to launch once a
             MoE layer of every forward call, every launch of a kernel that
             phase 3 checked; ``packed=False`` at fp against the default's
             streams up to near-ties; flash against ref logits at fp and
             ``w8kv8``; a profiled decode step at both (idle share, kernels
             a step, each expert-path kernel's time and share of busy
             time);
9. recurrent — once every earlier model is freed: full-width, full-depth
             mamba2-130m (24 SSD layers; no attention, no quantised
             projection, so no kernel of the port runs) and full-width
             recurrentgemma-9b cut to 20 of 38 layers (14 RG-LRU and 6
             local MQA), each serving the engine phase's 16 requests and
             a 4600-token prompt (``kv_len`` 5120) through padded
             admission, replayed and eagerly (streams bit for bit,
             launches equal and as reckoned: attention kernels in the
             local layers only, ``w_gate`` among the quantised
             projections); mamba2 at fp, with ``packed=False`` (streams
             held to the default's up to near-ties) and ``fused=False``
             (bit for bit the sequential path's), its capture leaving the
             pool's recurrent leaves as they were, its padded prefill's
             cache held against other pads (bit for bit) and against the
             unpadded prefill (f32), the chunked scan against the
             recurrence iterated, and a kill and restore mid-decode;
             recurrentgemma at fp and ``w8kv8`` with flash against ref
             logits; each a profiled decode step with the recurrent ops'
             device time and share, tokens/s, TTFT, TPOT and peak memory.
10. mla   — once every earlier model is freed: deepseek-v2-236b at full
             width (multi-head latent attention: a 512-wide latent and 64
             RoPE dims shared by 128 heads; 160 experts of 1536 top-6 and 2
             shared) with its depth cut to 8 of 60 layers (the dense first
             layer and 7 MoE layers, ~58 GB), serving the 16 requests
             (``kv_len`` 1024) through padded admission at fp and
             ``w8kv8``, replayed and eagerly (streams bit for bit, launches
             equal and as reckoned: a prefill kernel a layer on tensor cores,
             no decode kernel, the absorbed decode being plain PyTorch);
             flash against ref logits under ``ForcedRouting``; a kill and
             restore mid-decode at fp and a snapshot's latent pool (bf16
             under ``kv_bits`` 8) restored bit for bit; a profiled decode
             step at both with the absorbed attention's device time
             (``mla_ms``) and the expert path's share.
11. cross  — once every earlier model is freed: the cross-attention
             stacks, run as the reference runs them (its engine cannot
             serve them): ``prefill`` with the source, then 32 greedy
             ``decode_step`` calls over a cache whose cross entries stay
             fixed, 8 requests of one prompt length: whisper-large-v3 at
             full width and depth (32 + 32 layers; 1500 frames, a 4-token
             prompt, ``kv_len`` 448) at fp and ``w8kv8``; bart-base and
             bart-large (512 source tokens, a 32-token prompt);
             llama-3.2-vision-90b at full width cut to 30 of 100 layers (24
             self-attention and 6 gated cross layers, its gates set
             non-zero; 1024 patch embeddings, a 64-token prompt).  Launches
             of the main path as reckoned, flash against ref logits at the
             prefill and every step, decode against a teacher-forced prefill,
             cross leaves bit for bit unchanged, a zeroed source moving the
             logits, int8 self codes beside bf16 cross leaves at ``w8kv8``,
             every kernel one that phase 3 held (phase 3 holds and times the
             prefill non-causal at whisper's encoder shape and with Sq !=
             Skv at each cross shape, Sq > Skv, Skv below one key tile and
             f32 on CUDA cores, the cross decodes with their split counts,
             whisper's int8 projections up to the encoder's 12000 rows); a
             profiled decode step of whisper and the vision stack and
             whisper's encoder pass.
12. train  — once every earlier model is freed: the port's training path,
             which runs no kernel of the port (the reference trains on its
             attention oracle; the phase checks that its steps launch
             none): qwen2.5-3b at full width and depth through
             ``Trainer.run`` (f32 master weights, bf16 compute, remat on;
             train_4k cut to 4 rows of 1024 tokens of ``LMDataPipeline``)
             for 8 steps at a stated learning rate: loss and gnorm finite,
             the mean loss of the last 3 steps below that of the first 3,
             every leaf moved; the step's wall and busy time, tokens/s,
             peak memory and 6 N tokens over the step time at 989 TFLOP/s.
             The model cut to 2 layers, f32: one batch's loss, gnorm and
             every gradient on the card against the CPU, then AdamW from
             the same gradients on both; the gradients' int8 codes and
             scales (``compress_decompress``) bit for bit on both and about
             4x below f32.  One MoE layer at qwen3-moe-30b-a3b's full width
             through the capacity path, forward and backward at 512 tokens,
             card against CPU.  The 2-layer trainer saved at step 2 and
             restored into a new ``Trainer`` (parameters, moments, count and
             data state bit for bit), both continued 2 steps bit for bit
             under deterministic algorithms.
13. mesh   — once phase train's state is freed: the parallel plane
             (``repro_torch.parallel``) over a one-rank NCCL process group
             (a ``FileStore`` under ``build/mesh``, no network) and
             ``small_mesh(1, 1)`` on the card: full-width qwen2.5-3b
             (36 layers, ``kv_len`` 1024) served with ``mesh=`` at fp and
             w8kv8 (the engine phase's 16 requests, replayed; parameters
             and pool DTensors, every kernel behind ``local_map``): streams
             bit for bit the engine phase's, launches and kernels equal, no
             grouped matmul; the planned replayed decode step's wall and
             busy time beside the one without a mesh; a snapshot mid-decode
             restored with ``ServingEngine.restore(mesh=)`` to the
             uninterrupted run's streams.  qwen3-moe-30b-a3b at full width
             cut to 4 layers through the mesh: gshard in each padded
             prefill, the capacity path in the replayed decode step,
             attention through decode.cu and prefill.cu, no grouped matmul,
             every request its budget; with the capacity raised until
             nothing drops, the planned prefill's logits the one-device
             gshard prefill's bit for bit, in f32 the dropless prefill's
             within 1e-4 of their scale, and in bf16, under the dropless
             prefill's expert choices (a choice the gshard router makes
             otherwise a near-tie, as in phase moe), within 5e-2 of it;
             one MoE layer in bf16 as near its f32 output as the dropless
             kernels.  ``allgather_matmul`` and ``reduce_scatter_matmul``
             against their oracles; 2 steps of ``Trainer(mesh=)`` on
             full-width qwen2.5-3b, each loss within 1e-6 relative of phase
             train's first two.  qwen2.5-3b's speculative drain (spec_k 4,
             the 8-bit self-draft) through the mesh, replayed: streams,
             launches and kernels those of phase spec's drain; and eager,
             the model cut to 4 layers, against the mesh-less replayed
             drain of the same cut.
14. examples — the four ``examples/*_torch.py`` on the card, each a
             subprocess with a time limit (three at once, the training
             example's two runs after each other): ``quickstart_torch.py``
             (Plane B, reduced gemma2-9b's loss and train step, prefill.cu
             and qmatmul.cu's crossbar route against their plain versions
             within the f32 tolerances), ``serve_e2e_torch.py`` (must print
             ``MATCH``), ``train_lm_torch.py --tiny`` for 10 steps and again
             to 20, the second run resuming from the first's checkpoint
             (under ``build/examples``) with its last loss under the first
             run's first, and ``noi_design_torch.py``;
15. roofline — once phase mesh's state is freed: full-width qwen2.5-3b,
             ``impl="ref"``: a decode step (8 rows over a 1024-entry
             cache), a prefill step (8 x 1024 tokens) and phase train's
             step (4 x 1024, f32 master weights, remat), each counted by
             ``repro_torch.roofline.analyze_step`` on the card's tensors
             (FLOPs, bytes), timed by the profiler's busy time, which must
             reach 0.95 of the bound ``max(FLOPs / 989e12, bytes /
             3.35e12)`` (a reading under it means the count is wrong),
             and its peak memory from the arguments up against the
             tracker's on fake tensors of the same step, within 5% + 64
             MiB.  The dry run (``python -m repro_torch.launch.dryrun
             --arch mamba2-130m --shape train_4k --mesh single``, a fake
             group of 256 ranks), started in a process of its own after
             the build, must exit 0.

Each model's weights are freed before the next is made.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits 1
and prints no result.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
L2_BYTES = 50e6                    # H100 SXM L2
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.bfloat16": 1e-2, "torch.float32": 2e-5}
# dequant-matmul: error relative to the plain version's largest magnitude
# (bf16: one output rounding after a long f32 sum in another order)
MATMUL_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}
QUANT_RUNS = {"fp": dict(), "w8kv8": dict(weight_bits=8, kv_bits=8),
              "w4kv4": dict(weight_bits=4, kv_bits=4)}
MAX_BATCH, NEW_TOKENS, N_REQUESTS, CHUNK = 8, 32, 16, 128
# phase crash's qwen2.5-3b depth, cut from 36 for the script's time (at 12
# a slow host read 1177.5 s; phase mesh's snapshot case keeps the full depth)
CRASH_QWEN_LAYERS = 6
# speculative decoding: drafts a step, and the verify's rows (8 slots x 5)
SPEC_K = 4
VERIFY_M = MAX_BATCH * (SPEC_K + 1)
# the spec phase's runs of each served model: the plain run whose streams
# they must give, the draft, and the EngineConfig fields of speculation;
# "eager" marks the run replayed again through the eager methods
SPEC_RUNS = {
    "qwen2.5-3b": [("fp", "bits0", dict(spec_draft_bits=0)),
                   ("fp", "bits8 eager", dict(spec_draft_bits=8)),
                   ("fp", "bits4", dict(spec_draft_bits=4)),
                   ("w8kv8", "bits4", dict(spec_draft_bits=4)),
                   ("fp", "model", dict(spec_draft="model"))],
    "gemma2-9b": [("fp", "bits8 eager", dict(spec_draft_bits=8))],
}
DRAFT_LAYERS, DRAFT_SEED = 4, 1     # the draft model: the target's config cut
# the crash phase's gemma2-9b case: the pool cut to 2 slots, since its chunk
# steps compute every row of the pool and the 4600-token prompt takes ~36 of
# them in each of the two runs to the kill (at 8 slots the case took 61 s,
# a 3.3 GB snapshot)
CRASH_LONG_BATCH = 2
# greedy streams may part from the plain run's where the plain logits'
# top-1/top-2 margin is under phase logits' bound (verify and decode round
# differently), relative to the logits' scale
NEAR_TIE = 5e-2
# the slo phase: requests, the offered rate over what the plain drain
# sustains, the bounded queue, and the deadline in plain decode times of a
# request's budget (1.5: at 2.0 a drain whose decode kept pace with the
# arrivals let no request expire, and the phase then did not show the
# deadlines at work)
SLO_REQUESTS, SLO_OVERLOAD, SLO_MAX_QUEUE, SLO_DEADLINE_BUDGETS = 48, 2.0, 4, 1.5
# the served models at full width: the pool's length, prompts beside the
# 16 of 4..384 tokens, a long row of the logits phase (gemma2-9b's 4600
# and 4200 wrap its 4096-entry local rings: in chunked prefill and decode,
# and in the packed prefill's insert), and a depth cut: gemma2-9b's 42
# layers to 12 (6 local/global pairs), for the script's time (22 once
# phase moe joined it, its phases 299 s of 580 at full depth; 12 once phase
# train did: at 22 its phases took 207 s of a 1188 s run on a slow host)
SERVED = {"qwen2.5-3b": dict(kv_len=1024, long_prompts=(), logits_row=0, layers=0),
          "gemma2-9b": dict(kv_len=5120, long_prompts=(4600,), logits_row=4200, layers=8)}
# logits only, full width at a cut depth: one pattern period plus the
# remainder (gemma3-27b: qk-norm at head dim 128; minitron-8b: the untied
# 256000-column lm_head, ReLU^2 without GLU)
LOGITS_ONLY = {"gemma3-27b": 8, "minitron-8b": 2}
# gemma2-9b's attention as the engine runs it: 8 slots, 16 query heads over
# 8 KV heads of dim 256, a 5120-entry global pool and 4096-entry local rings
# (window 4096), attention softcap 50
GEMMA2_DECODE = dict(B=8, Skv=5120, Hq=16, Hkv=8, hd=256, softcap=50.0)
GEMMA2_RING = dict(B=8, Skv=4096, Hq=16, Hkv=8, hd=256, window=4096, softcap=50.0,
                   ring=True)
GEMMA2_PREFILL = dict(S=128, Hq=16, Hkv=8, hd=256, window=4096, softcap=50.0)
# the MoE phase: qwen3-moe-30b-a3b at full width, its depth cut to 16 of 48
# layers (every layer MoE; 20.4 GB of bf16 weights) for the script's time
# once phases train and examples joined it (no check of the phase depends
# on depth), its
# pool's length and the precisions it serves at; the memory the earlier
# phases may leave allocated when its model is built
MOE_ARCH, MOE_LAYERS, MOE_KV_LEN, MOE_RUNS = "qwen3-moe-30b-a3b", 16, 1024, ("fp", "w8kv8")
MOE_FREE_BEFORE_GIB = 2.0
# qwen3-moe-30b-a3b's attention as the engine runs it: 8 slots, 32 query
# heads over 4 KV heads of dim 128, a 1024-entry pool; its prefills are
# batch-1 prompts padded to a chunk multiple (up to 384 tokens), or to a
# power-of-two bucket (up to 512) under packed=False
QWEN3_DECODE = dict(B=8, Skv=1024, Hq=32, Hkv=4, hd=128)
QWEN3_PREFILL = dict(Hq=32, Hkv=4, hd=128, segmented=False)
# the grouped matmul's shapes in qwen3-moe-30b-a3b: (K, N) of gate/up and
# down, over 128 experts, at T = 8 slots x top-8 (decode) and 128 / 384
# prompt tokens x top-8 (prefill)
MOE_EXPERTS, MOE_TOP_K = 128, 8
MOE_GMM_SHAPES = {"gate/up": (2048, 768), "down": (768, 2048)}
MOE_GMM_ROWS = {"decode": 64, "prefill128": 1024, "prefill384": 3072}
QWEN3_GMM = dict(label="qwen3-moe", experts=MOE_EXPERTS, k=MOE_TOP_K, shapes=MOE_GMM_SHAPES,
                 rows=MOE_GMM_ROWS)
# the paper's Table 3 models (phase paper), full width and depth (but
# llama2-7b and gpt-j at half depth since phase examples joined: the
# script's time), in the order served; the precisions each serves at,
# those whose flash logits are held against ref, and the drains fed to
# Plane B's cosim_from_engine (on the configs as served, depth cut alike)
PAPER_MODELS = ("llama2-7b", "gpt-j", "bert-large", "bert-base")
PAPER_LAYERS = {"llama2-7b": 16, "gpt-j": 14}
PAPER_KV_LEN = 1024
PAPER_RUNS = {"llama2-7b": ("fp", "w8kv8")}
PAPER_LOGITS = {"llama2-7b": ("fp", "w8kv8"), "gpt-j": ("fp",), "bert-large": ("fp",)}
PAPER_COSIM = {("llama2-7b", "fp"), ("gpt-j", "fp"), ("llama2-7b", "w8kv8")}
PAPER_CHIPLETS = 64
# the keys of a row of benchmarks/perf_cosim.py's per-architecture records
# (its _ARCH_KEYS), which phase paper builds from each cosim_from_engine
# record and its single-stream replay
COSIM_ARCH_KEYS = {"ttft_ms", "decode_step_ms", "decode_tok_s", "tokens_per_s",
                   "energy_per_token_mj", "prefill_gb", "decode_gb",
                   "decode_traffic_frac", "batch", "batch_uplift"}
# the Table-4 anchors' bounds on |log(simulated / paper)|, as the reference's
# tests hold them: the 2.5D-HI fit of two scalars to its two anchors, each
# baseline's fit of its two to its own
ANCHOR_LOG_TOL = {"2.5D-HI": 0.15, "HAIMA_chiplet": 0.02, "TransPIM_chiplet": 0.02}
# phase calib: the profiling plane (repro_torch.profile) at full width, the
# four steps of benchmarks/perf_calib.py.  Its kernel grid runs on llama2-7b
# (MHA 32/32 at hd 128: every kind stays on one kernel route, the prefill on
# the tensor-core tiles), every bytes-fitted case streaming at least
# CALIB_MIN_BYTES (twice the 50 MB L2, so min-of-k reads HBM, not the L2);
# the prefill keeps one segment a row (seg_len >= its longest S: prefill.cu
# skips tiles with no live same-segment pair, and the fit's term is S^2);
# the matmul shapes are registered configs' (llama-3.2-vision-90b's MLP,
# gpt-j's, deepseek-v2's and llama-3's heads)
CALIB_ARCH = "llama2-7b"
CALIB_GRID = dict(batches=(4, 8), kv_lens=(8192, 16384, 32768), kv_bits=(0, 8, 4),
                  prefill_lens=(8192, 12288, 16384), seg_len=16384, qmm_m=8, qmm_bits=(8, 4),
                  qmm_shapes=((8192, 28672), (28672, 8192), (4096, 50400), (5120, 102400),
                              (8192, 128256)))
CALIB_MIN_BYTES = 100e6
# the issue's prefill grid, at the prompt lengths the port serves: timed and
# fitted beside the pinned grid and printed, not pinned (there the reference's
# regressor, whose term counts the output projection, linear in S, misses
# the kernel's quadratic work), with the pinned fit's error at these lengths
CALIB_SERVED_PREFILL = dict(prefill_lens=(1024, 2048, 4096), seg_len=4096)
# the engine's captured decode step: full-width bert-base
CALIB_EXECUTOR = dict(archs=("bert-base",), impl="flash", batches=(1, 2, 4, 8), kv_len=512)
# each sampler runs CALIB_PASSES times one after another (the executor's
# CALIB_EXECUTOR_PASSES), and each point's time is its median over the
# passes: now and then, for 20 ms to a second or so, the card runs the
# replayed step 10-18% faster (the same tokens, the SM clock at 1980 MHz:
# chip_probe_calib.py), and a point whose min-of-k falls in such a spell
# bends its fit (one B 8 point turned the executor's 6% rise from B 1 to 8
# into a negative slope)
CALIB_PASSES = 3
CALIB_EXECUTOR_PASSES = 5
# benchmarks/perf_calib.py's pin on every fit for compiled backends
# (TOLERANCE_COMPILED), and no fitted rate above this share of the card's
# peak for its term
CALIB_TOLERANCE = 0.5
CALIB_PEAK_SHARE = 1.05
# steady-state calls a case (min-of-k), after one warm-up call, as
# perf_calib.py's full run takes them
CALIB_REPEAT = 5
# the replay: gpt-j's generation episode through Plane B (perf_calib.py's
# cosim_delta) under CALIB and the measured Calib; the traced drain
# (its run_engine_trace) on full-width bert-base
CALIB_COSIM = dict(arch="gpt-j", prompt_len=512, gen_len=128, batch=8)
CALIB_TRACE_PROMPTS = (6, 10, 14, 10, 22, 6, 18, 10)
CALIB_TRACE_ENGINE = dict(max_batch=4, kv_len=64, max_new_tokens=8, prefill_chunk=32)
# each kernel kind's wrapper (by its record's name) and the code bits of
# its quantised decode
CALIB_WRAPPERS = {"decode_attn": ("flash_decode", 0), "decode_attn_kv8": ("flash_decode_quant", 8),
                  "decode_attn_kv4": ("flash_decode_quant", 4),
                  "prefill_attn": ("flash_prefill", 0), "dequant_matmul": ("quant_matmul", 0)}
# the per-kernel counter of each kind (repro_torch.kernels.launches.counters)
# and the parameter by which its plain checks take the smallest case of each
# value (the decodes' batch: 2 splits at B 4, one at B 8; the weights' bits)
CALIB_COUNTERS = {"decode_attn": "decode", "decode_attn_kv8": "decode_quant",
                  "decode_attn_kv4": "decode_quant", "prefill_attn": "prefill",
                  "dequant_matmul": "qmatmul"}
CALIB_CHECK_BY = {"decode_attn": "batch", "decode_attn_kv8": "batch",
                  "decode_attn_kv4": "batch", "dequant_matmul": "bits"}
# their attention as the engine runs it: 8 slots, a 1024-entry pool, MHA
# (rep 1) at head dims 128 (llama2-7b), 256 (gpt-j) and 64 (bert); packed
# prefills of a 128-token stream
LLAMA_DECODE = dict(B=8, Skv=1024, Hq=32, Hkv=32, hd=128)
GPTJ_DECODE = dict(B=8, Skv=1024, Hq=16, Hkv=16, hd=256)
BERT_LARGE_DECODE = dict(B=8, Skv=1024, Hq=16, Hkv=16, hd=64)
BERT_BASE_DECODE = dict(B=8, Skv=1024, Hq=12, Hkv=12, hd=64)
PAPER_DECODE = {"llama2-7b": LLAMA_DECODE, "gpt-j": GPTJ_DECODE,
                "bert-large": BERT_LARGE_DECODE, "bert-base": BERT_BASE_DECODE}
PAPER_PREFILL = {arch: dict(S=128, Hq=kw["Hq"], Hkv=kw["Hkv"], hd=kw["hd"])
                 for arch, kw in PAPER_DECODE.items()}
# phase recurrent: mamba2-130m (24 SSD layers) and recurrentgemma-9b (38
# layers, 12 x (rec, rec, local) + 2 rec; cut to RGEMMA_LAYERS) at full
# width, each
# serving the engine phase's 16 requests and one of 4600 tokens (one prompt
# a call, padded to a chunk multiple: 4608 tokens, 18 SSD chunks of 256)
# over 5120-entry pools, whose 2048-entry local rings the long prompt wraps;
# the precisions recurrentgemma-9b serves at
MAMBA_ARCH, RGEMMA_ARCH = "mamba2-130m", "recurrentgemma-9b"
# recurrentgemma-9b's depth since phase examples joined (the script's
# time): 6 x (rec, rec, local) + 2 rec, the full stack's pattern and
# remainder
RGEMMA_LAYERS = 20
RECURRENT_KV_LEN, RECURRENT_LONG = 5120, (4600,)
RGEMMA_RUNS = ("fp", "w8kv8")
# recurrentgemma-9b's attention as the engine runs it: 8 slots, 16 query
# heads over one KV head (MQA: rep 16) of dim 256, 2048-entry local rings
# (window 2048), no softcap; its prefills are batch-1 prompts without
# segments, padded to a chunk multiple (128, 256, 384; 4608 for the
# 4600-token prompt)
RGEMMA_POOL = dict(B=8, Skv=2048, Hq=16, Hkv=1, hd=256, window=2048)
RGEMMA_RING = dict(RGEMMA_POOL, ring=True)
RGEMMA_PREFILL = dict(Hq=16, Hkv=1, hd=256, window=2048, segmented=False)
RGEMMA_PREFILL_LENGTHS = (128, 256, 384, 4608)
# the rows of its quantised projections: the decode step's 8 and the
# padded prefills' lengths
RGEMMA_MATMUL_ROWS = (8,) + RGEMMA_PREFILL_LENGTHS
# the bound on a chunked SSD scan's final state against the one-token
# recurrence iterated over the 4600 tokens, f32, relative to the state's
# scale: the two sum ~4600 decayed terms in other orders
SCAN_STEP_TOL = 1e-4
# the bound on mamba2-130m's padded prefill cache against the unpadded
# one, f32, each leaf relative to its scale: the 4608-row and 4600-row
# products run other cuBLAS kernels (the first layer's conv inputs already
# differ in their last bits), the scans sum in other trees, and 24 layers
# carry the differences on
UNPADDED_TOL = 1e-4
# phase mla: deepseek-v2-236b at full width (d_model 5120, 128 heads, the
# 512-wide latent and 64 RoPE dims, 160 experts of 1536 top-6 and 2 shared,
# a 102400-row vocabulary) with its depth cut to 8 of 60 layers (the dense
# first layer and 7 MoE layers: ~58 GB of bf16 weights, what the card holds
# beside the pool), its pool's length and the precisions it serves at
MLA_ARCH, MLA_LAYERS, MLA_KV_LEN, MLA_RUNS = "deepseek-v2-236b", 8, 1024, ("fp", "w8kv8")
# its prefill attention as the engine runs it: batch-1 prompts padded to a
# chunk multiple (128, 256, 384), 128 query heads over 128 KV heads, q/k
# head dim 192 (128 + 64 RoPE), v 128, in the (B, S, H, d) layout the layer
# passes; and the logits phase's packed 128-token stream and its
# sequential prefills' buckets (32, 64)
MLA_PREFILL = dict(Hq=128, Hkv=128, hd=192, hdv=128, segmented=False, bshd=True)
MLA_PREFILL_LENGTHS = (128, 256, 384)
# its expert path: (K, N) of gate/up and down over 160 experts, top-6, at
# T = 8 slots x 6 (decode) and 128 / 384 prompt tokens x 6 (prefill)
DS_EXPERTS, DS_TOP_K = 160, 6
DS_GMM_SHAPES = {"gate/up": (5120, 1536), "down": (1536, 5120)}
DS_GMM_ROWS = {"decode": 48, "prefill128": 768, "prefill384": 2304}
# its quantised projections' rows: the decode step's 8 and the padded
# prefills' lengths
DS_GMM = dict(label="deepseek-v2", experts=DS_EXPERTS, k=DS_TOP_K, shapes=DS_GMM_SHAPES,
              rows=DS_GMM_ROWS)
MLA_MATMUL_ROWS = (8,) + MLA_PREFILL_LENGTHS
# phase cross: the cross-attention stacks through prefill with their source
# and decode_step over a cache whose cross entries stay fixed, as the
# reference runs them (its engine cannot serve them): whisper-large-v3 (32
# encoder and 32 decoder layers, 1500 frames a request, a 4-token prompt,
# kv_len 448, the decoder's context) at fp and w8kv8; the paper's bart-base
# and bart-large (512 source tokens, a 32-token prompt); llama-3.2-vision-90b
# at full width with its depth cut to 30 of 100 layers (six pattern
# periods: 24 self-attention and 6 gated cross layers, ~55.5 GB of bf16
# weights, what the card holds), 1024 patch embeddings, a 64-token prompt.
# 8 requests a batch, one prompt length a batch, 32 greedy decode steps.
# Phase 3 times these prefills in this many profiler windows: one window's
# reading of a call this short has varied 3.6x between runs on one H100.
CROSS_TIMING_WINDOWS = 5
CROSS_MODELS = {
    "whisper-large-v3": dict(layers=0, runs=("fp", "w8kv8"), prompt=4, kv_len=448,
                             source=1500),
    "bart-base": dict(layers=0, runs=("fp",), prompt=32, kv_len=1024, source=512),
    "bart-large": dict(layers=0, runs=("fp",), prompt=32, kv_len=1024, source=512),
    "llama-3.2-vision-90b": dict(layers=30, runs=("fp",), prompt=64, kv_len=1024,
                                 source=1024),
}
CROSS_BATCH, CROSS_NEW_TOKENS = 8, 32
# the decode steps whose logits are held to a prefill over the longer prefix
CROSS_TF_STEPS = (0, 15, 31)
# the vision stack's gates: zero at init, where tanh(0) = 0 leaves every
# cross layer inert, so a wrong cross path would pass unseen
CROSS_GATES = {"gate_attn": 0.5, "gate_mlp": 1.0}
# the sources' scale, so that a zeroed source moves the logits past the
# flash-vs-ref bound (a model whose source moves them less cannot tell a
# dropped source from the kernels' drift): whisper's frames at unit
# scale, a conv frontend's (at 0.02 they vanish beside the sinusoidal
# positions); the vision stack's patches at 4, since random projections
# of unit-scale patches give scores of unit spread, near-uniform attention
# over the 1024 patches that averages the source away, where a trained
# layer attends to a few
CROSS_SOURCE_STD = {"audio": 1.0, "vlm": 4.0}
# the whisper encoder's projection rows: 8 requests x 1500 frames
WHISPER_ENCODER_ROWS = 8 * 1500
# profiler windows device_ms takes before it gives up on a call
PROFILE_TRIES = 3
# phase train: qwen2.5-3b at full width and depth through the port's
# Trainer (f32 master weights, bf16 compute, remat on), train_4k (4096
# tokens x 256 rows) cut to 1024 x 4 for one card and the script's time;
# its learning rate, warmup and schedule length
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = "qwen2.5-3b", 1024, 4, 8
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
# card against CPU: the model cut to 2 layers at full width, f32, one batch
# of 2 x 128 tokens; one MoE layer at qwen3-moe-30b-a3b's full width (the
# capacity path) at 512 tokens; the bounds (loss and gnorm relative,
# gradients and AdamW updates over each leaf's scale)
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 128
TRAIN_MOE_ARCH, TRAIN_MOE_TOKENS = "qwen3-moe-30b-a3b", 512
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_GRAD_TOL, TRAIN_UPDATE_TOL = 1e-5, 1e-4, 1e-4, 1e-6
# phase mesh: the runs served again through a one-rank mesh, the MoE depth,
# and the planned trainer's losses against phase train's
MESH_RUNS = ("fp", "w8kv8")
MESH_SPEC = ("fp", "bits8")        # phase spec's drain served again through the mesh
MESH_SPEC_EAGER_LAYERS = 4         # its eager drain's depth (36 took 78 s: DTensor dispatch)
# phase roofline: the model, the serving steps' batch and depth, the peak
# memory bound (relative, and absolute for the allocator's rounding and
# the libraries' workspaces), the dry run's cell and how long to wait for it
ROOFLINE_ARCH, ROOFLINE_BATCH, ROOFLINE_KV = "qwen2.5-3b", 8, 1024
ROOFLINE_PEAK_REL, ROOFLINE_PEAK_ABS = 0.05, 64 << 20
EXAMPLE_TIMEOUT_S = 300            # each example's subprocess
EXAMPLE_TRAIN_STEPS = (10, 20)     # train_lm_torch.py --tiny: a run, then its resume
ROOFLINE_DRYRUN = ("mamba2-130m", "train_4k", "single")
ROOFLINE_DRYRUN_WAIT_S = 400
MESH_MOE_LAYERS = 4
MESH_TRAIN_TOL = 1e-6
ENGINE_RUNS = {}                   # (arch, run) -> the engine phase's run_engine record
SPEC_RECORDS = {}                  # (arch, run, draft) -> the spec phase's run_engine record
PROFILES = {}                      # (arch, run) -> the graphs phase's run_profile record
TRAIN_LOSSES = []                  # phase train's losses
DEVICE = "cuda"
CARD = ""                          # nvidia-smi's name and power limit of the card


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def device_ms(fn, iters, warmup=3):
    """Mean device time of one call (ms): the kernel time torch.profiler
    records over ``iters`` calls, summed and divided by ``iters`` — what
    the card spends on a call, without the host's gaps between launches
    (CUDA events around a loop of calls this small would time the host).
    Late in a long process the profiler now and then records no kernel of
    a window at all: such a window is measured again, up to
    ``PROFILE_TRIES`` windows, and a call none of them times fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            break
        print(f"device_ms: the profiler recorded no device time in window {attempt + 1}")
    check(busy_us > 0, f"the profiler recorded no device time in {PROFILE_TRIES} windows")
    return busy_us / 1e3 / iters


def bound(nbytes, flops, dtype):
    """Least time on the card (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def decode_case(torch, rng, *, B=8, Skv=1024, Hq=16, Hkv=2, hd=128, lens=None,
                window=0, softcap=0.0, ring=False, empty=(), dtype=None, copies=1,
                hdv=None, v_offset=0):
    """Inputs of one decode call; ``copies`` distinct K/V pools (to time
    with a cold L2, as each layer's pool is); V rows of ``hdv`` (default
    hd).  ``v_offset`` > 0 makes V a view that starts that many elements
    into wider rows (V not 16-byte aligned)."""
    hdv = hdv or hd
    dtype = dtype or torch.bfloat16
    dev = DEVICE
    lens = rng.integers(64, Skv + 1, B) if lens is None else np.asarray(lens)
    kv_pos = np.full((B, Skv), -1, np.int32)
    for b, n in enumerate(lens):
        if b in empty:
            continue
        if ring:                       # a wrapped ring, scrambled, with holes
            n = Skv + int(n)
            s = np.arange(Skv)
            kv_pos[b] = n - 1 - ((n - 1 - s) % Skv)
            kv_pos[b, rng.choice(Skv, Skv // 8, replace=False)] = -1
        else:
            kv_pos[b, :n] = np.arange(n)
    q_pos = np.maximum(kv_pos.max(axis=1, keepdims=True), 0).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q = torch.randn((B, 1, Hq, hd), generator=g, device=dev).to(dtype)
    pools = [(torch.randn((B, Skv, Hkv, hd), generator=g, device=dev).to(dtype),
              torch.randn((B, Skv, Hkv, hdv + v_offset), generator=g,
                          device=dev).to(dtype)[..., v_offset:])
             for _ in range(copies)]
    return dict(q=q, pools=pools, q_pos=torch.from_numpy(q_pos).to(dev),
                kv_pos=torch.from_numpy(kv_pos).to(dev), window=window,
                softcap=softcap, kv_pos_np=kv_pos, q_pos_np=q_pos)


def prefill_case(torch, rng, *, S=128, Hq=16, Hkv=2, hd=128, lens=(37, 50, 20),
                 window=0, softcap=0.0, segmented=True, dtype=None, hdv=None, bshd=False,
                 B=1, Skv=None, causal=True):
    """Inputs of one prefill call, (B, H, S, d) each; V rows of ``hdv``
    (default hd); ``bshd``: views of (B, S, H, d) tensors, as an attention
    layer passes them (the MLA layer's q, k and v among them).  ``Skv``
    (default S) keys and values: a cross-attention prefill's source, with
    ``causal=False``.  Segments are one packed stream (B 1)."""
    dtype = dtype or torch.bfloat16
    dev = DEVICE
    Skv = Skv or S
    seg = np.full((1, S), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i
        off += n
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def randn(H, L, d):
        if bshd:
            return torch.randn((B, L, H, d), generator=g, device=dev).to(dtype).transpose(1, 2)
        return torch.randn((B, H, L, d), generator=g, device=dev).to(dtype)
    q, k, v = randn(Hq, S, hd), randn(Hkv, Skv, hd), randn(Hkv, Skv, hdv or hd)
    return dict(q=q, k=k, v=v, window=window, softcap=softcap, causal=causal,
                segments=torch.from_numpy(seg).to(dev) if segmented else None,
                seg_np=seg if segmented else None)


# the kernels of prefill.cu, decode.cu and decode_quant.cu (their wrappers'
# kernel_launches / quant_kernel_launches keys) that some case of
# run_kernel_checks / run_quant_decode_checks held against the plain version
CHECKED_PREFILL = set()
CHECKED_DECODE = set()
CHECKED_DECODE_QUANT = set()


def ran_one(counter, fn, what):
    """Call ``fn`` and return its output and the one kernel it launched, by
    the key of the wrapper's launch ``counter``."""
    before = counter.copy()
    out = fn()
    ran = list((counter - before).elements())
    check(len(ran) == 1, f"expected one {what} launch, saw {ran}")
    return out, ran[0]


def attention_kernel_name(k):
    dtype = k.dtype.split(".")[-1]
    if hasattr(k, "bits"):
        return f"int{k.bits}/{dtype}/rows{k.rows}/dims{k.dims}/splits{k.splits}"
    if hasattr(k, "splits"):
        return f"{dtype}/rows{k.rows}/dims{k.dims}/splits{k.splits}"
    return f"{k.design}/heads{k.heads}/rows{k.rows}/hd{k.hd}x{k.hdv}/{dtype}"


def masked_splits(kv_pos, sp):
    """(slot, split) pairs of a split plan whose every pool entry is empty."""
    valid, n = kv_pos >= 0, sp.tiles * 32
    return sum(int(not valid[b, s * n:(s + 1) * n].any())
               for b in range(valid.shape[0]) for s in range(sp.splits))


def two_streams(torch, calls):
    """Each of ``calls`` launched 20 times over two streams at once, in
    turns: True when every output equals what the call gives alone, bit
    for bit (each stream's split tickets are its own, and splits are
    merged in a fixed order)."""
    alone = [f() for f in calls]
    streams = [torch.cuda.Stream(device=DEVICE) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for r in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                j = (r + i) % len(calls)
                outs.append((j, calls[j]()))
    torch.cuda.synchronize()
    return len(outs), all(torch.equal(out, alone[j]) for j, out in outs)


def expected_prefill_design(dtype, hd, hdv=None):
    """Tensor cores for bf16 at the (q/k, v) head dims prefill.cu has tiles
    for (``TC_HEAD_DIMS``: 64/64, 128/128, 256/256 and MLA's 192/128;
    ``hdv`` None: ``hd``); CUDA cores otherwise."""
    import torch
    pairs = ((64, 64), (128, 128), (256, 256), (192, 128))
    return "tensor_core" if dtype == torch.bfloat16 and \
        (hd, hd if hdv is None else hdv) in pairs else "cuda_core"


def check_attention_checked(what, kernels, checked):
    """Every kernel of prefill.cu, decode.cu or decode_quant.cu that
    ``what`` launched was held against its plain version in phase 3."""
    missed = sorted(attention_kernel_name(k) for k in kernels if k not in checked)
    check(not missed, f"{what}: attention kernels launched but never checked: {missed}")


def cross_config(arch):
    """The config phase cross runs: full width, the vision stack's depth
    cut to ``CROSS_MODELS[arch]["layers"]``."""
    from repro_torch.config import get_config
    cfg, layers = get_config(arch), CROSS_MODELS[arch]["layers"]
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def cross_lengths(arch):
    """The decoder's prefill lengths in phase cross: the prompt, and the
    prefixes of the teacher-forced prefills (the prompt and the tokens up
    to each step of ``CROSS_TF_STEPS``)."""
    P = CROSS_MODELS[arch]["prompt"]
    return (P,) + tuple(P + s + 1 for s in CROSS_TF_STEPS)


def cross_attention_shapes():
    """The attention calls of phase cross, 8 requests each, as (prefill,
    decode, quantised decode) cases {name: keywords of prefill_case or
    decode_case}: each encoder's non-causal self-attention over its source;
    at each prefill length the decoder's causal self-attention and its
    cross-attention (Sq the decoder's length, Skv the source); the
    self-attention decode over the pool (quantised too at kv_bits 8) and
    the cross decode over the source, every entry valid."""
    prefill, decode, quant = {}, {}, {}
    for arch, m in CROSS_MODELS.items():
        cfg = cross_config(arch)
        heads = dict(Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.head_dim, B=CROSS_BATCH)
        tag = f"{arch} B{CROSS_BATCH} Hq{cfg.n_heads} Hkv{cfg.n_kv_heads} hd{cfg.head_dim}"
        one = dict(heads, segmented=False, bshd=True)
        src = m["source"]
        if cfg.n_encoder_layers:
            prefill[f"{tag} encoder S{src} non-causal"] = dict(one, S=src, causal=False)
        for L in cross_lengths(arch):
            prefill[f"{tag} self S{L}"] = dict(one, S=L)
            prefill[f"{tag} cross Sq{L} Skv{src}"] = dict(one, S=L, Skv=src, causal=False)
        decode[f"{tag} self Skv{m['kv_len']}"] = dict(heads, Skv=m["kv_len"])
        decode[f"{tag} cross Skv{src}"] = dict(heads, Skv=src, lens=[src] * CROSS_BATCH)
        if any(QUANT_RUNS[r].get("kv_bits") for r in m["runs"]):
            quant[f"{tag} self Skv{m['kv_len']}"] = dict(heads, Skv=m["kv_len"])
    return prefill, decode, quant


def decode_timing(torch, rng, kw):
    """Device time of the fp decode at a shape (``decode_case``'s keywords),
    cycling over pools that span twice the L2, beside its plain version, its
    bound and ``scaled_dot_product_attention`` over the same pools and mask
    (without a softcap, which it lacks)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.decode import (decode_splits,
                                                            flash_decode_fwd,
                                                            flash_decode_plain,
                                                            row_groups)
    from repro_torch.kernels.flash_attention.decode import kernel_launches as decode_launches
    from repro_torch.kernels.scratch import sm_count
    shape = dict(dict(B=8, Skv=1024, Hkv=2, hd=128), **kw)
    pool_bytes = 2 * shape["B"] * shape["Skv"] * shape["Hkv"] * shape["hd"] * 2
    c = decode_case(torch, rng, copies=cold_copies(pool_bytes), **kw)
    B, Skv, Hkv, hd = c["pools"][0][0].shape
    Hq = c["q"].shape[2]
    nxt = cycler(c["pools"])
    args = dict(q_pos=c["q_pos"], kv_pos=c["kv_pos"], window=c["window"],
                softcap=c["softcap"])
    _, kernel = ran_one(decode_launches, lambda: flash_decode_fwd(c["q"], *nxt(), **args),
                        "decode")
    sp = decode_splits(B, Hkv * row_groups(Hq // Hkv)[0], Skv, sm_count(c["q"].device))
    ms = device_ms(lambda: flash_decode_fwd(c["q"], *nxt(), **args), 200)
    plain_ms = device_ms(lambda: flash_decode_plain(c["q"], *nxt(), **args), 20)
    mask = (c["kv_pos"] >= 0) & (c["kv_pos"] <= c["q_pos"])
    if c["window"]:
        mask &= c["q_pos"] - c["kv_pos"] < c["window"]
    qt = c["q"].transpose(1, 2)
    nxt_lib = cycler([(k.transpose(1, 2), v.transpose(1, 2)) for k, v in c["pools"]])
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, *nxt_lib(), attn_mask=mask[:, None, None, :], enable_gqa=True), 100)
    valid = int(mask.sum().item())
    esz = c["q"].element_size()
    nbytes = (2 * B * Hq * hd * esz                       # q in, out
              + 2 * valid * Hkv * hd * esz                # valid K and V rows
              + c["kv_pos_np"].nbytes + c["q_pos_np"].nbytes)
    flops = 4 * valid * Hq * hd                           # QK^T and PV
    b_ms, b_by = bound(nbytes, flops, str(c["q"].dtype))
    name = attention_kernel_name(kernel)
    print(f"kernel flash_decode timing shape={[B, Skv, Hq, Hkv, hd]} kernel={name} "
          f"splits={sp.splits} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "shape": [B, Skv, Hq, Hkv, hd], "kernel": name,
            "splits": sp.splits, "valid_entries": valid, "window": c["window"],
            "softcap": c["softcap"]}


def run_kernel_checks(torch):
    from repro_torch.kernels.flash_attention.decode import (decode_splits,
                                                            flash_decode_fwd,
                                                            flash_decode_plain,
                                                            row_groups)
    from repro_torch.kernels.flash_attention.decode import kernel_launches as decode_launches
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                            flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill_launches
    from repro_torch.kernels.scratch import sm_count
    rng = np.random.default_rng(0)
    sms = sm_count(torch.device(DEVICE))
    records = {}

    def plan(k, Hq):
        B, Skv, Hkv = k.shape[:3]
        return decode_splits(B, Hkv * row_groups(Hq // Hkv)[0], Skv, sms)

    # -- decode ---------------------------------------------------------------
    cases = {
        "main B8 Skv1024 Hq16 Hkv2 hd128": dict(),
        "window256 softcap50": dict(window=256, softcap=50.0),
        "empty slots 0,5": dict(empty=(0, 5)),
        "ring scrambled with holes": dict(ring=True),
        "Skv1000 (not a multiple of 128)": dict(Skv=1000),
        "rep1 Hq8 Hkv8": dict(Hq=8, Hkv=8),
        "rep8 hd256 Skv300": dict(Hq=16, Hkv=2, hd=256, Skv=300),
        "f32 B3 Skv200 rep4": dict(B=3, Skv=200, Hq=8, Hkv=2, dtype=torch.float32),
    }
    # the split-KV cases draw from a generator of their own, so the timed
    # inputs below stay those that earlier versions of the kernel were timed on
    rng_split = np.random.default_rng(6)
    split_cases = {
        "short slots: wholly masked splits": dict(lens=[40, 90, 1, 33, 64, 100, 2, 70]),
        "B40 Hkv4: one split": dict(B=40, Hq=16, Hkv=4),
        "rep16 Hq16 Hkv1": dict(Hq=16, Hkv=1),
        "rep32 Hq32 Hkv1: two row groups": dict(Hq=32, Hkv=1),
        "f32 hd256 rep2 Skv300 (gemma2-9b heads)": dict(Skv=300, Hq=16, Hkv=8, hd=256,
                                                        dtype=torch.float32),
        "V not 16-byte aligned (2-byte)": dict(v_offset=1),
        "V not 16-byte aligned (4-byte)": dict(v_offset=2),
        "hd96 hdv64 (hd != hdv, 12 pieces a K row)": dict(hd=96, hdv=64),
        # one split of 532 tiles: the kernel walks it in two chunks of tile masks
        "one split over 17000 entries": dict(B=40, Hkv=4, Skv=17000,
                                             lens=[17000 - 400 * b for b in range(40)]),
        "gemma2-9b global B8 Skv5120 Hq16 Hkv8 hd256 softcap50": GEMMA2_DECODE,
        "gemma2-9b ring B8 Skv4096 hd256 window4096 softcap50": GEMMA2_RING,
    }
    # qwen3-moe-30b-a3b's pool (Hkv 4), from a generator of its own
    rng_moe = np.random.default_rng(8)
    moe_cases = {"qwen3-moe B8 Skv1024 Hq32 Hkv4 hd128": QWEN3_DECODE}
    # the paper's models (MHA at head dims 128, 256 and 64), from a
    # generator of their own
    rng_paper = np.random.default_rng(9)
    paper_cases = {f"{arch} B8 Skv1024 Hq{kw['Hq']} Hkv{kw['Hkv']} hd{kw['hd']}": kw
                   for arch, kw in PAPER_DECODE.items()}
    # recurrentgemma-9b's local rings (MQA, rep 16 at head dim 256), wrapped
    # and not, from a generator of their own
    rng_rg = np.random.default_rng(10)
    rg_cases = {"recurrentgemma-9b ring B8 Skv2048 Hq16 Hkv1 hd256 window2048": RGEMMA_RING,
                "recurrentgemma-9b pool B8 Skv2048 Hq16 Hkv1 hd256 window2048 (not wrapped)":
                    RGEMMA_POOL}
    # phase cross's shapes: the cross decodes over 1500, 512 and 1024
    # entries (MHA rep 1 at hd 64, rep 8 at hd 128) and the decoders' pools,
    # from a generator of their own
    rng_cross = np.random.default_rng(16)
    cross_prefill, cross_decode, _ = cross_attention_shapes()
    errs = []
    for name, kw, case_rng in ([(n, kw, rng) for n, kw in cases.items()]
                               + [(n, kw, rng_split) for n, kw in split_cases.items()]
                               + [(n, kw, rng_moe) for n, kw in moe_cases.items()]
                               + [(n, kw, rng_paper) for n, kw in paper_cases.items()]
                               + [(n, kw, rng_rg) for n, kw in rg_cases.items()]
                               + [(n, kw, rng_cross) for n, kw in cross_decode.items()]):
        c = decode_case(torch, case_rng, **kw)
        k, v = c["pools"][0]
        args = dict(q_pos=c["q_pos"], kv_pos=c["kv_pos"], window=c["window"],
                    softcap=c["softcap"])
        out, kernel = ran_one(decode_launches, lambda: flash_decode_fwd(c["q"], k, v, **args),
                              "decode")
        CHECKED_DECODE.add(kernel)
        ref = flash_decode_plain(c["q"], k, v, **args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(c["q"].dtype)]
        empty_ok = all(bool((out[b] == 0).all()) for b in kw.get("empty", ()))
        sp = plan(k, c["q"].shape[2])
        print(f"kernel flash_decode case={name!r} splits={sp.splits} tiles_a_split={sp.tiles} "
              f"wholly_masked_splits={masked_splits(c['kv_pos_np'], sp)} "
              f"kernel={attention_kernel_name(kernel)} max_abs_err={err:.3e} tol={tol:g}"
              f" empty_slots_zero={empty_ok}")
        check(np.isfinite(err) and err <= tol and empty_ok,
              f"decode kernel disagrees with its plain version ({name})")
        check(kernel.splits == sp.splits, f"decode ({name}) ran {kernel.splits} splits, "
              f"its plan {sp.splits}")
        errs.append({"case": name, "splits": sp.splits, "max_abs_err": err, "tol": tol})

    # split shapes of two kernels (bf16 rows1/dims4, f32 rows1/dims8)
    calls = []
    for kw in (dict(), dict(Skv=300, Hq=16, Hkv=8, hd=256, dtype=torch.float32)):
        c = decode_case(torch, rng_split, **kw)
        calls.append(functools.partial(flash_decode_fwd, c["q"], *c["pools"][0],
                                       q_pos=c["q_pos"], kv_pos=c["kv_pos"]))
    n, same = two_streams(torch, calls)
    print(f"kernel flash_decode two_streams launches={n} identical={same}")
    check(same, "decode split shapes on two streams differ from one stream")

    t = decode_timing(torch, rng, {})
    records["flash_decode"] = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/flash_attention/decode.py:113",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "shape", "kernel", "splits", "valid_entries")},
        "gemma2_9b": decode_timing(torch, rng_split, GEMMA2_DECODE),
        "qwen3_moe": decode_timing(torch, rng_moe, QWEN3_DECODE),
        **{arch.replace("-", "_").replace(".", "_"): decode_timing(torch, rng_paper, kw)
           for arch, kw in PAPER_DECODE.items() if arch != "bert-base"},
        "recurrentgemma_9b": decode_timing(torch, rng_rg, RGEMMA_RING),
        **{f"{arch}_cross".replace("-", "_").replace(".", "_"): decode_timing(
            torch, rng_cross, kw) for arch, kw in cross_decode_timed().items()},
        "cases": errs}

    # -- packed prefill -------------------------------------------------------
    cases = {
        "main S128 Hq16 Hkv2 hd128, 3 prompts + pad": dict(),
        "window32 softcap50": dict(window=32, softcap=50.0),
        "pad-only tiles (70 real of 128)": dict(lens=(40, 30)),
        "S100 (not a multiple of 32)": dict(S=100, lens=(60, 33)),
        "rep1 Hq16 Hkv16": dict(Hkv=16),
        "rep8 hd256": dict(Hq=8, Hkv=1, hd=256),
        "f32 rep4": dict(Hq=8, Hkv=2, dtype=torch.float32),
        # a head dim the tensor-core tiles do not take: bf16 on CUDA cores
        "bf16 rep4 hd96 (CUDA cores)": dict(Hq=8, Hkv=2, hd=96),
        "no segments, causal S256": dict(S=256, segmented=False),
        "long stream S4096 rep8": dict(S=4096, lens=(1500, 2000, 500)),
        "rep1 S2048 Hq4": dict(S=2048, Hq=4, Hkv=4, lens=(2000,)),
        "rep2 hd64": dict(Hq=4, Hkv=2, hd=64),
        "gemma2-9b S128 Hq16 Hkv8 hd256 window4096 softcap50": GEMMA2_PREFILL,
    }
    # the sequential baseline's batch-1 prefills, without segments:
    # qwen2.5-3b's power-of-two buckets, gemma2-9b's exact lengths (its 4600-
    # token prompt under the 4096 window)
    cases.update({f"non-segmented S{S} (a qwen2.5-3b bucket)": dict(S=S, segmented=False)
                  for S in (8, 16, 32, 64, 128, 256, 512, 1024)})
    # a draft model's prompt prefill, right-padded to a multiple of the chunk
    cases["non-segmented S384 (a draft prefill, chunk-padded)"] = dict(S=384, segmented=False)
    cases.update({f"non-segmented gemma2-9b S{S} window4096 softcap50":
                  dict(GEMMA2_PREFILL, S=S, segmented=False) for S in (17, 384, 4600)})
    # qwen3-moe-30b-a3b's batch-1 prefills: chunk multiples (padded
    # admission) and the sequential baseline's buckets, from a generator of
    # its own
    moe_cases = {f"non-segmented qwen3-moe S{S} Hq32 Hkv4": dict(QWEN3_PREFILL, S=S)
                 for S in (8, 16, 32, 64, 128, 256, 384, 512)}
    # the paper's models' packed prefills (a 128-token stream, MHA)
    cases.update({f"{arch} S128 Hq{kw['Hq']} Hkv{kw['Hkv']} hd{kw['hd']}": kw
                  for arch, kw in PAPER_PREFILL.items()})
    # recurrentgemma-9b's padded prefills (MQA rep 16, head dim 256, window
    # 2048; the kernel takes no length: the 4600-token prompt's 8 pad rows
    # attend causally like real ones and are never read), from rng_rg
    rg_cases = {f"non-segmented recurrentgemma-9b S{S} Hq16 Hkv1 hd256 window2048":
                dict(RGEMMA_PREFILL, S=S) for S in RGEMMA_PREFILL_LENGTHS}
    # deepseek-v2-236b's MLA prefills (hd 192, hdv 128, 128 heads): its
    # padded prompts, the logits phase's packed stream and its sequential
    # buckets, from a generator of their own
    rng_mla = np.random.default_rng(15)
    mla_cases = {f"non-segmented deepseek-v2 MLA S{S} Hq128 hd192 hdv128": dict(MLA_PREFILL, S=S)
                 for S in (32, 64) + MLA_PREFILL_LENGTHS}
    mla_cases["deepseek-v2 MLA S128 Hq128 hd192 hdv128, 3 prompts + pad"] = dict(
        MLA_PREFILL, S=128, segmented=True, lens=(30, 61, 17))
    # phase cross's prefills (non-causal, and Sq != Skv for the cross
    # prefills), and edge cases: Sq > Skv, Skv below one key tile, f32 on
    # CUDA cores; from rng_cross
    cross_cases = dict(cross_prefill)
    cross_cases.update({
        "non-causal Sq100 > Skv40 B2 Hq4 Hkv2 hd64": dict(
            B=2, S=100, Skv=40, Hq=4, Hkv=2, hd=64, segmented=False, causal=False),
        "non-causal Skv20 below one key tile B3 Sq37 Hq8 Hkv8 hd128": dict(
            B=3, S=37, Skv=20, Hq=8, Hkv=8, hd=128, segmented=False, causal=False),
        "f32 non-causal B2 Sq37 Skv300 Hq4 Hkv4 hd64 (CUDA cores)": dict(
            B=2, S=37, Skv=300, Hq=4, Hkv=4, hd=64, segmented=False, causal=False,
            dtype=torch.float32),
    })
    errs = []
    for name, kw, case_rng in ([(n, kw, rng) for n, kw in cases.items()]
                               + [(n, kw, rng_moe) for n, kw in moe_cases.items()]
                               + [(n, kw, rng_rg) for n, kw in rg_cases.items()]
                               + [(n, kw, rng_mla) for n, kw in mla_cases.items()]
                               + [(n, kw, rng_cross) for n, kw in cross_cases.items()]):
        c = prefill_case(torch, case_rng, **kw)
        args = dict(segments=c["segments"], window=c["window"], softcap=c["softcap"],
                    causal=c["causal"])
        out, kernel = ran_one(prefill_launches, lambda: flash_attention_fwd(
            c["q"], c["k"], c["v"], **args), "prefill")
        CHECKED_PREFILL.add(kernel)
        ref = flash_attention_plain(c["q"], c["k"], c["v"], **args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(c["q"].dtype)]
        pad_ok = True
        if c["seg_np"] is not None:
            pad = torch.from_numpy(c["seg_np"][0] < 0).to(DEVICE)
            pad_ok = bool((out[:, :, pad] == 0).all())
        want = expected_prefill_design(c["q"].dtype, c["q"].shape[-1], c["v"].shape[-1])
        print(f"kernel flash_prefill case={name!r} design={kernel.design} "
              f"kernel={attention_kernel_name(kernel)} max_abs_err={err:.3e} tol={tol:g}"
              f" pad_rows_zero={pad_ok}")
        check(np.isfinite(err) and err <= tol and pad_ok,
              f"prefill kernel disagrees with its plain version ({name})")
        check(kernel.design == want, f"prefill ({name}) ran on {kernel.design}, expected {want}")
        errs.append({"case": name, "design": kernel.design, "max_abs_err": err, "tol": tol})

    t = prefill_timing(torch, rng, {})
    records["flash_prefill"] = {
        "name": "flash_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefill.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:123",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "shape", "kernel", "attended_pairs")},
        "gemma2_9b": prefill_timing(torch, rng, GEMMA2_PREFILL),
        **{arch.replace("-", "_"): prefill_timing(torch, rng_paper, kw)
           for arch, kw in PAPER_PREFILL.items() if arch != "bert-base"},
        "recurrentgemma_9b": prefill_timing(torch, rng_rg, dict(RGEMMA_PREFILL, S=4608),
                                            iters=20),
        "deepseek_v2_236b": prefill_timing(torch, rng_mla, dict(MLA_PREFILL, S=384), iters=20),
        **{what: prefill_timing(torch, rng_cross, kw, iters=50, windows=CROSS_TIMING_WINDOWS)
           for what, kw in cross_prefill_timed().items()},
        "cases": errs}
    # the wide heads (hd 256, MLA's 192/128), on tensor cores: kernel,
    # scaled_dot_product_attention and bound side by side
    for what in ("gemma2_9b", "gpt_j", "recurrentgemma_9b", "deepseek_v2_236b"):
        t = records["flash_prefill"][what]
        print(f"kernel flash_prefill wide heads {what} shape={t['shape']} design={t['design']} "
              f"ms={t['ms']:.4f} sdpa_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.5f} "
              f"ms/sdpa_ms={t['ms'] / t['library_ms']:.2f}")
        check(t["design"] == "tensor_core", f"prefill timing {what} ran on {t['design']}")
    return records


def cross_decode_timed():
    """The cross decodes phase 3 times: whisper's over 1500 entries (MHA,
    hd 64) and the vision stack's over 1024 (rep 8, hd 128)."""
    _, decode, _ = cross_attention_shapes()
    return {arch: next(kw for n, kw in decode.items() if n.startswith(arch) and "cross" in n)
            for arch in ("whisper-large-v3", "llama-3.2-vision-90b")}


def cross_prefill_timed():
    """The prefills phase 3 times for phase cross: whisper's encoder
    (non-causal, S 1500), and the cross prefills of whisper (Sq 4, Skv
    1500), bart-large (Sq 32, Skv 512) and the vision stack (Sq 64, Skv
    1024, 64/8 at hd 128)."""
    prefill, _, _ = cross_attention_shapes()

    def first(arch, part):
        return next(kw for n, kw in prefill.items() if n.startswith(arch) and part in n)
    w = "whisper-large-v3"
    return {"whisper_large_v3_encoder": first(w, "encoder"),
            "whisper_large_v3_cross": first(w, "cross"),
            "bart_large_cross": first("bart-large", "cross"),
            "llama_3_2_vision_90b_cross": first("llama-3.2-vision-90b", "cross")}


def prefill_timing(torch, rng, kw, iters=200, windows=1):
    """Device time of the prefill at a shape (``prefill_case``'s keywords;
    three prompts and pad, or one causal stream without segments), beside
    its plain version, its bound and ``scaled_dot_product_attention`` with
    the same mask (without a softcap, which it lacks); ``iters`` calls of
    the kernel and the library, a tenth as many of the plain version.
    With ``windows`` > 1 the kernel and the library are each timed in that
    many profiler windows: their medians are reported beside every
    window's reading (``ms_windows``, ``library_ms_windows``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                            flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill_launches
    c = prefill_case(torch, rng, **kw)
    B, Hq, S, hd = c["q"].shape
    Hkv, Skv, hdv = c["k"].shape[1], c["k"].shape[2], c["v"].shape[-1]
    args = dict(segments=c["segments"], window=c["window"], softcap=c["softcap"],
                causal=c["causal"])
    _, kernel = ran_one(prefill_launches, lambda: flash_attention_fwd(
        c["q"], c["k"], c["v"], **args), "prefill")
    ms_windows = [device_ms(lambda: flash_attention_fwd(c["q"], c["k"], c["v"], **args),
                            iters) for _ in range(windows)]
    ms = float(np.median(ms_windows))
    plain_ms = device_ms(lambda: flash_attention_plain(c["q"], c["k"], c["v"], **args),
                         max(2, iters // 10))
    qi = torch.arange(S, device=DEVICE)[:, None]
    kj = torch.arange(Skv, device=DEVICE)[None, :]
    lib_mask = kj <= qi if c["causal"] else torch.ones((S, Skv), dtype=torch.bool,
                                                        device=DEVICE)
    if c["segments"] is not None:
        seg = c["segments"][0]
        lib_mask &= (seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
    if c["window"]:
        lib_mask &= qi - kj < c["window"]
    lib_mask = lib_mask[None, None]
    library_ms_windows = [device_ms(lambda: F.scaled_dot_product_attention(
        c["q"], c["k"], c["v"], attn_mask=lib_mask, enable_gqa=True), iters)
        for _ in range(windows)]
    library_ms = float(np.median(library_ms_windows))
    pairs = B * int(lib_mask.sum().item())                 # attended (q, k) pairs
    esz = c["q"].element_size()
    # q and k of hd, v and out of hdv; QK^T and PV
    nbytes = B * (Hq * S * (hd + hdv) + Hkv * Skv * (hd + hdv)) * esz + \
        (c["seg_np"].nbytes if c["seg_np"] is not None else 0)
    flops = 2 * pairs * Hq * (hd + hdv)
    b_ms, b_by = bound(nbytes, flops, str(c["q"].dtype))
    name = attention_kernel_name(kernel)
    shape = [B, S, Hq, Hkv, hd] + ([hdv] if hdv != hd else [])
    print(f"kernel flash_prefill timing shape={shape} Skv={Skv} kernel={name} "
          f"segmented={c['segments'] is not None} causal={c['causal']} window={c['window']} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by})"
          + ("" if windows == 1 else
             f" ms_windows={[round(x, 4) for x in ms_windows]}"
             f" library_ms_windows={[round(x, 4) for x in library_ms_windows]}"))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            **({} if windows == 1 else {"ms_windows": ms_windows,
                                        "library_ms_windows": library_ms_windows}),
            "library_ms": library_ms, "shape": shape, "Skv": Skv, "causal": c["causal"],
            "kernel": name, "design": kernel.design, "attended_pairs": pairs,
            "softcap": c["softcap"]}


def cold_copies(nbytes):
    """Distinct copies of an operand of ``nbytes`` to cycle over so that
    the copies span twice the L2: each call then reads its operand from
    HBM, as a layer's weights and pool are read once a step."""
    return max(2, -(-int(2 * L2_BYTES) // int(nbytes)))


def cycler(items):
    """A function returning the next of ``items`` on each call (to time
    with a cold L2: each layer's weights and pool are read once a step)."""
    it = iter(range(1 << 30))
    return lambda: items[next(it) % len(items)]


# the split routes' kernel cases (ops._planned_split_kv, ops._planned_rows):
# the decodes with their log-sum-exp, fp and quantised, at qwen2.5-3b's pool
# and gemma2-9b's ring (window, softcap), slot 3 empty; the prefill at a
# query row offset, a rank's quarter of a causal stream against the whole
# launch, on tensor cores at hd 128 and 256 (window, softcap, segments) and
# on CUDA cores in f32
SPLIT_DECODE = {"qwen2.5-3b B8 Skv1024 Hq16 Hkv2 hd128": dict(empty=(3,), timed=True),
                "qwen2.5-3b B8 Skv1024 Hq16 Hkv2 hd128, q x40 (scores past 88)":
                dict(empty=(3,), q_scale=40.0),
                "gemma2-9b ring B8 Skv4096 Hq16 Hkv8 hd256 window4096 softcap50":
                dict(GEMMA2_RING, empty=(3,))}
SPLIT_PREFILL = {
    "bf16 hd128 S1024 Hq16 Hkv2, 3 prompts + pad (tensor cores)":
        dict(S=1024, lens=(300, 500, 200)),
    "bf16 hd128 S1024 Hq16 Hkv2, causal (tensor cores)": dict(S=1024, segmented=False),
    "bf16 hd256 S1024 Hq16 Hkv8 window300 softcap50, 3 prompts + pad (tensor cores)":
        dict(GEMMA2_PREFILL, S=1024, window=300, lens=(300, 500, 200)),
    "f32 hd128 S512 Hq8 Hkv2 window100 softcap50, 3 prompts + pad (CUDA cores)":
        dict(S=512, Hq=8, Hkv=2, window=100, softcap=50.0, lens=(200, 150, 100),
             dtype="float32"),
}
SPLIT_RANKS = 4            # the ranks a prefill stream is cut across
LSE_TOL = 1e-4             # a log-sum-exp against the plain version's (abs and rel)
# the merged halves (the merge kept in f32) against the whole launch, in bf16
# ulps of each row's largest value: each launch rounds its rows to bf16 once;
# the bf16 cases read 1e-3 abs on an H100, where TOL's 1e-2 would pass a
# merge with slightly wrong weights
MERGE_ULPS = 2
# PERF.md section 6's main-path rows (H100 80GB HBM3, 700 W): qwen2.5-3b's
# decode, kv8 decode and packed prefill, read with no LSE and q_off 0
PERF_MD_MS = {"flash_decode": 0.0193, "flash_decode_quant": 0.0153, "flash_prefill": 0.0102}


def run_split_checks(torch, records):
    """The outputs the split routes launch the kernels with, each against
    its plain version: decode.cu and decode_quant.cu (kv8, kv4) with their
    log-sum-exp (``return_lse``), the pool cut in two halves, each launched
    with its LSE and merged in torch (``ops.merge_splits``'s formula, one
    card standing in for two ranks) against the whole-pool launch, once
    with q scaled so that the scores pass 88 (where ``exp`` overflows f32
    without the merge's max), an empty slot's rows exact zeros and
    ``NEG_INF``; prefill.cu at a query row offset
    (``q_offset``), each quarter of a stream against the same rows of the
    whole launch.  Times the LSE launches and an offset quarter beside the
    plain launches, and reads the main-path rows beside PERF.md's."""
    from repro_torch.kernels.flash_attention.common import NEG_INF
    from repro_torch.kernels.flash_attention.decode import (flash_decode_fwd,
                                                            flash_decode_plain,
                                                            flash_decode_quant_fwd,
                                                            flash_decode_quant_plain)
    from repro_torch.kernels.flash_attention.decode import kernel_launches as decode_launches
    from repro_torch.kernels.flash_attention.decode import quant_kernel_launches
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                            flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill_launches
    from repro_torch.kernels.flash_attention.ops import _merged, _weighed
    from repro_torch.quant.core import quantize_kv
    rng = np.random.default_rng(23)
    out = {"flash_decode": [], "flash_decode_quant": [], "flash_prefill": []}
    def merge_parts(outs, lses):      # ops.merge_splits's sums, in one process, kept in f32
        m = torch.stack(lses).amax(dim=0)
        return _merged(sum(_weighed(o, l, m) for o, l in zip(outs, lses)), torch.float32)

    for name, kw in SPLIT_DECODE.items():
        kw = dict(kw)
        timed, q_scale = kw.pop("timed", False), kw.pop("q_scale", 1.0)
        c = decode_case(torch, rng, **kw)
        c["q"] = c["q"] * q_scale
        k, v = c["pools"][0]
        for bits in (0, 8, 4):
            if bits:
                pool = (*quantize_kv(k, bits), *quantize_kv(v, bits))   # k_q, k_s, v_q, v_s

                def fwd(p, kv_pos, **a):
                    return flash_decode_quant_fwd(c["q"], p[0], p[1], p[2], p[3], kv_bits=bits,
                                                  q_pos=c["q_pos"], kv_pos=kv_pos,
                                                  window=c["window"], softcap=c["softcap"], **a)

                def plain(p, kv_pos, **a):
                    return flash_decode_quant_plain(c["q"], p[0], p[1], p[2], p[3],
                                                    kv_bits=bits, q_pos=c["q_pos"],
                                                    kv_pos=kv_pos, window=c["window"],
                                                    softcap=c["softcap"], **a)
                counter, rec = quant_kernel_launches, "flash_decode_quant"
            else:
                pool = (k, v)

                def fwd(p, kv_pos, **a):
                    return flash_decode_fwd(c["q"], *p, q_pos=c["q_pos"], kv_pos=kv_pos,
                                            window=c["window"], softcap=c["softcap"], **a)

                def plain(p, kv_pos, **a):
                    return flash_decode_plain(c["q"], *p, q_pos=c["q_pos"], kv_pos=kv_pos,
                                              window=c["window"], softcap=c["softcap"], **a)
                counter, rec = decode_launches, "flash_decode"
            half = k.shape[1] // 2
            cut = [(tuple(t[:, :half] for t in pool), c["kv_pos"][:, :half]),
                   (tuple(t[:, half:] for t in pool), c["kv_pos"][:, half:])]
            before = sum(counter.values())
            (whole, lse), kernel = ran_one(counter, lambda: fwd(pool, c["kv_pos"],
                                                                return_lse=True), "decode")
            alone = fwd(pool, c["kv_pos"])
            parts = [fwd(p, kp, return_lse=True) for p, kp in cut]
            launches = sum(counter.values()) - before
            merged = merge_parts([o[:, 0] for o, _ in parts], [l for _, l in parts])
            ref, ref_lse = plain(pool, c["kv_pos"], return_lse=True)
            torch.cuda.synchronize()
            tol = TOL[str(c["q"].dtype)]
            err = (whole.float() - ref.float()).abs().max().item()
            lse_err = ((lse - ref_lse).abs() / (1 + ref_lse.abs())).max().item()
            w = whole[:, 0].float()
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().amax(-1, keepdim=True)
                                                    .clamp_min(2.0 ** -10))) - 7)
            merge_err = ((merged - w).abs() / ulp).max().item()
            top = lse.max().item()
            empty = bool((whole[3] == 0).all() and (lse[3] == NEG_INF).all()
                         and (merged[3] == 0).all())
            same = torch.equal(whole, alone)
            what = f"{name} {'kv%d' % bits if bits else 'fp'}"
            print(f"kernel {rec} lse case={what!r} kernel={attention_kernel_name(kernel)} "
                  f"max_abs_err={err:.3e} lse_rel_err={lse_err:.3e} max_lse={top:.1f} "
                  f"merged_halves_ulps={merge_err:.3f} tol={tol:g} "
                  f"out_as_without_lse={same} empty_slot_zeros_and_neg_inf={empty} "
                  f"launches={launches}")
            check(err <= tol and lse_err <= LSE_TOL,
                  f"{rec} with its log-sum-exp disagrees with its plain version ({what})")
            check(merge_err <= MERGE_ULPS, f"{rec}: the merged halves disagree with the whole "
                  f"pool's launch ({what})")
            check(same, f"{rec}: the rows with the LSE differ from those without ({what})")
            check(empty, f"{rec}: the empty slot is not zeros and NEG_INF ({what})")
            check(q_scale == 1.0 or top > 88.0, f"{rec}: the scaled case's scores stay "
                  f"below 88 ({what})")
            row = {"case": what, "max_abs_err": err, "lse_rel_err": lse_err,
                   "merged_halves_ulps": merge_err, "tol": tol, "launches": launches}
            if timed:                        # the LSE launch timed beside the plain one
                row["ms"] = device_ms(lambda: fwd(pool, c["kv_pos"], return_lse=True), 200)
                row["ms_without_lse"] = device_ms(lambda: fwd(pool, c["kv_pos"]), 200)
                print(f"kernel {rec} lse timing case={what!r} ms={row['ms']:.4f} "
                      f"ms_without_lse={row['ms_without_lse']:.4f} card={CARD}")
            out[rec].append(row)

    for name, kw in SPLIT_PREFILL.items():
        kw = dict(kw)
        if kw.pop("dtype", None) == "float32":
            kw["dtype"] = torch.float32
        c = prefill_case(torch, rng, **kw)
        S = c["q"].shape[2]
        args = dict(segments=c["segments"], window=c["window"], softcap=c["softcap"],
                    causal=c["causal"])
        before = sum(prefill_launches.values())
        whole = flash_attention_fwd(c["q"], c["k"], c["v"], **args)
        tol = TOL[str(c["q"].dtype)]
        n = S // SPLIT_RANKS
        errs, same = [], []
        for r in range(SPLIT_RANKS):
            rows = c["q"][:, :, r * n:(r + 1) * n]
            got, kernel = ran_one(prefill_launches, lambda: flash_attention_fwd(
                rows, c["k"], c["v"], q_offset=r * n, **args), "prefill")
            ref = flash_attention_plain(rows, c["k"], c["v"], q_offset=r * n, **args)
            torch.cuda.synchronize()
            errs.append(max((got.float() - ref.float()).abs().max().item(),
                            (got.float() - whole[:, :, r * n:(r + 1) * n].float())
                            .abs().max().item()))
            same.append(torch.equal(got, whole[:, :, r * n:(r + 1) * n]))
        launches = sum(prefill_launches.values()) - before
        want = expected_prefill_design(c["q"].dtype, c["q"].shape[-1], c["v"].shape[-1])
        print(f"kernel flash_prefill q_offset case={name!r} design={kernel.design} "
              f"kernel={attention_kernel_name(kernel)} quarters={SPLIT_RANKS} "
              f"max_abs_err={max(errs):.3e} tol={tol:g} rows_of_the_whole_launch_bit_for_bit="
              f"{all(same)} launches={launches}")
        check(max(errs) <= tol, f"prefill at a row offset disagrees ({name})")
        check(all(same), f"prefill's rows at an offset differ from the whole launch's ({name})")
        check(kernel.design == want, f"prefill at a row offset ({name}) ran on {kernel.design}")
        row = {"case": name, "design": kernel.design, "max_abs_err": max(errs), "tol": tol,
               "bit_for_bit": all(same), "launches": launches}
        if S == 1024 and kernel.design == "tensor_core" and c["segments"] is None:
            rows = c["q"][:, :, 3 * n:]          # the last quarter: the most keys
            row["ms"] = device_ms(lambda: flash_attention_fwd(
                rows, c["k"], c["v"], q_offset=3 * n, **args), 200)
            row["ms_whole_stream"] = device_ms(lambda: flash_attention_fwd(
                c["q"], c["k"], c["v"], **args), 200)
            row["plain_ms"] = device_ms(lambda: flash_attention_plain(
                rows, c["k"], c["v"], q_offset=3 * n, **args), 20)
            print(f"kernel flash_prefill q_offset timing case={name!r} last quarter "
                  f"ms={row['ms']:.4f} whole_stream_ms={row['ms_whole_stream']:.4f} "
                  f"plain_ms={row['plain_ms']:.4f} card={CARD}")
        out["flash_prefill"].append(row)

    for rec, rows in out.items():
        records[rec]["split_routes"] = rows
        records[rec]["max_abs_err"] = max(records[rec]["max_abs_err"],
                                          *(r["max_abs_err"] for r in rows))
        print(f"kernel {rec} main row ms={records[rec]['ms']:.4f} "
              f"perf_md_ms={PERF_MD_MS[rec]} ratio={records[rec]['ms'] / PERF_MD_MS[rec]:.3f} "
              f"card={CARD}")


def run_quant_decode_checks(torch):
    """The quantised-pool decode kernel, kv8 and kv4, against its plain
    version; timed at qwen2.5-3b's and gemma2-9b's shapes."""
    from repro_torch.kernels.flash_attention.decode import (decode_splits,
                                                            flash_decode_quant_fwd,
                                                            flash_decode_quant_plain,
                                                            quant_kernel_launches,
                                                            row_groups)
    from repro_torch.kernels.scratch import sm_count
    from repro_torch.quant.core import quantize_kv
    rng = np.random.default_rng(3)
    sms = sm_count(torch.device(DEVICE))

    def quant_case(bits, copies=1, case_rng=rng, **kw):
        c = decode_case(torch, case_rng, copies=copies, **kw)
        c["qpools"] = [(*quantize_kv(k, bits), *quantize_kv(v, bits))
                       for k, v in c.pop("pools")]
        return c

    cases = {
        "main B8 Skv1024 Hq16 Hkv2 hd128": dict(),
        "window256 softcap50": dict(window=256, softcap=50.0),
        "empty slots 0,5": dict(empty=(0, 5)),
        "ring scrambled with holes": dict(ring=True),
        "Skv1000 (not a multiple of 128)": dict(Skv=1000),
        "rep1 Hq8 Hkv8": dict(Hq=8, Hkv=8),
        "rep8 hd256 Skv300": dict(Hq=16, Hkv=2, hd=256, Skv=300),
        "f32 B3 Skv200 rep4": dict(B=3, Skv=200, Hq=8, Hkv=2, dtype=torch.float32),
        "short slots: wholly masked splits": dict(lens=[40, 90, 1, 33, 64, 100, 2, 70]),
        "B40 Hkv4: one split": dict(B=40, Hq=16, Hkv=4),
        "rep16 Hq16 Hkv1": dict(Hq=16, Hkv=1),
    }
    # shapes beyond the serving ones, from a generator of their own (so the
    # timed inputs below stay those that earlier versions were timed on):
    # K code rows of 16 and 8 bytes (kv8, kv4), of 6 and 3 (byte copies, and
    # V rows not whole float4s of the merge), rep above 16, gemma2-9b's pools
    rng_new = np.random.default_rng(7)
    new_cases = {
        "hd16 (reduced configs' head dim)": dict(B=3, Skv=200, Hq=8, Hkv=2, hd=16),
        "hd6 B3 Skv200 (code rows of a few bytes)": dict(B=3, Skv=200, Hq=8, Hkv=2, hd=6),
        "rep32 Hq32 Hkv1: two row groups": dict(Hq=32, Hkv=1),
        "rep20 Hq40 Hkv2 hd16 f32: a short row group": dict(B=3, Skv=200, Hq=40, Hkv=2, hd=16,
                                                           dtype=torch.float32),
        "gemma2-9b global B8 Skv5120 Hq16 Hkv8 hd256 softcap50": GEMMA2_DECODE,
        "gemma2-9b ring B8 Skv4096 hd256 window4096 softcap50": GEMMA2_RING,
        "qwen3-moe B8 Skv1024 Hq32 Hkv4 hd128": QWEN3_DECODE,
        "llama2-7b B8 Skv1024 Hq32 Hkv32 hd128": LLAMA_DECODE,
        "recurrentgemma-9b ring B8 Skv2048 Hq16 Hkv1 hd256 window2048": RGEMMA_RING,
        "recurrentgemma-9b pool B8 Skv2048 Hq16 Hkv1 hd256 window2048 (not wrapped)":
            RGEMMA_POOL,
        **cross_attention_shapes()[2],
    }
    errs = []
    for bits in (8, 4):
        for name, kw, case_rng in ([(n, kw, rng) for n, kw in cases.items()]
                                   + [(n, kw, rng_new) for n, kw in new_cases.items()]):
            c = quant_case(bits, case_rng=case_rng, **kw)
            k_q, k_s, v_q, v_s = c["qpools"][0]
            args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"],
                        window=c["window"], softcap=c["softcap"])
            out, kernel = ran_one(quant_kernel_launches, lambda: flash_decode_quant_fwd(
                c["q"], k_q, k_s, v_q, v_s, **args), "quantised decode")
            CHECKED_DECODE_QUANT.add(kernel)
            ref = flash_decode_quant_plain(c["q"], k_q, k_s, v_q, v_s, **args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(c["q"].dtype)]
            empty_ok = all(bool((out[b] == 0).all()) for b in kw.get("empty", ()))
            B, Skv, Hkv = k_q.shape[:3]
            sp = decode_splits(B, Hkv * row_groups(c["q"].shape[2] // Hkv)[0], Skv, sms)
            print(f"kernel flash_decode_quant kv{bits} case={name!r} splits={sp.splits} "
                  f"tiles_a_split={sp.tiles} "
                  f"wholly_masked_splits={masked_splits(c['kv_pos_np'], sp)} "
                  f"kernel={attention_kernel_name(kernel)} max_abs_err={err:.3e} "
                  f"tol={tol:g} empty_slots_zero={empty_ok}")
            check(np.isfinite(err) and err <= tol and empty_ok,
                  f"quantised decode kernel disagrees with its plain version "
                  f"(kv{bits}, {name})")
            check(kernel.splits == sp.splits, f"quantised decode ({name}) ran "
                  f"{kernel.splits} splits, its plan {sp.splits}")
            errs.append({"case": f"kv{bits} {name}", "splits": sp.splits,
                         "max_abs_err": err, "tol": tol})

    # the split decode launched on two streams at once gives what it gives
    # alone, bit for bit
    calls = []
    for bits in (8, 4):
        c = quant_case(bits)
        args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"])
        calls.append(functools.partial(flash_decode_quant_fwd, c["q"], *c["qpools"][0],
                                       **args))
    n, same = two_streams(torch, calls)
    print(f"kernel flash_decode_quant two_streams launches={n} identical={same}")
    check(same, "quantised decode split shapes on two streams differ from one stream")

    t8, t4 = (quant_decode_timing(torch, rng, bits, {}) for bits in (8, 4))
    g8, g4 = (quant_decode_timing(torch, rng, bits, GEMMA2_DECODE) for bits in (8, 4))
    llama8 = quant_decode_timing(torch, np.random.default_rng(9), 8, LLAMA_DECODE)
    rgemma8 = quant_decode_timing(torch, np.random.default_rng(10), 8, RGEMMA_RING)
    return {"flash_decode_quant": {
        "name": "flash_decode_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_quant.cu",
        "replaces": "src/repro/kernels/flash_attention/decode.py:226",
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        **{k: t8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "shape", "valid_entries", "kernel")},
        "library": "scaled_dot_product_attention over the pools dequantised to bf16",
        "kv_bits": 8, "kv4": t4, "gemma2_9b": {"kv8": g8, "kv4": g4},
        "llama2_7b": {"kv8": llama8}, "recurrentgemma_9b": {"kv8": rgemma8},
        "cases": errs}}


def quant_decode_timing(torch, rng, bits, kw):
    """Device time of the quantised decode at a shape (``decode_case``'s
    keywords), cycling over pools that span twice the L2, beside its plain
    version, its bound and ``scaled_dot_product_attention`` over the pools
    dequantised to bf16 (an fp pool, which quantisation replaces; without a
    softcap, which it lacks)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.decode import (flash_decode_quant_fwd,
                                                            flash_decode_quant_plain,
                                                            quant_kernel_launches)
    from repro_torch.quant.core import dequantize_kv, quantize_kv
    shape = dict(dict(B=8, Skv=1024, Hkv=2, hd=128), **kw)
    pool_bytes = 2 * shape["B"] * shape["Skv"] * shape["Hkv"] * (shape["hd"] * bits // 8 + 4)
    c = decode_case(torch, rng, copies=cold_copies(pool_bytes), **kw)
    qpools = [(*quantize_kv(k, bits), *quantize_kv(v, bits)) for k, v in c.pop("pools")]
    B, Skv, Hkv, hdq = qpools[0][0].shape
    Hq, hd = c["q"].shape[2], c["q"].shape[3]
    args = dict(kv_bits=bits, q_pos=c["q_pos"], kv_pos=c["kv_pos"], window=c["window"],
                softcap=c["softcap"])
    nxt = cycler(qpools)
    _, kernel = ran_one(quant_kernel_launches, lambda: flash_decode_quant_fwd(
        c["q"], *nxt(), **args), "quantised decode")
    ms = device_ms(lambda: flash_decode_quant_fwd(c["q"], *nxt(), **args), 200)
    plain_ms = device_ms(lambda: flash_decode_quant_plain(c["q"], *nxt(), **args), 20)
    mask = (c["kv_pos"] >= 0) & (c["kv_pos"] <= c["q_pos"])
    if c["window"]:
        mask &= c["q_pos"] - c["kv_pos"] < c["window"]
    qt = c["q"].transpose(1, 2)
    lib_pools = [(dequantize_kv(kq, ks, bits).to(c["q"].dtype).transpose(1, 2),
                  dequantize_kv(vq, vs, bits).to(c["q"].dtype).transpose(1, 2))
                 for kq, ks, vq, vs in qpools]
    nxt_lib = cycler(lib_pools)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, *nxt_lib(), attn_mask=mask[:, None, None, :], enable_gqa=True), 100)
    valid = int(mask.sum().item())
    esz = c["q"].element_size()
    nbytes = (2 * B * Hq * hd * esz                     # q in, out
              + 2 * valid * Hkv * (hdq + 4)             # K and V codes + scales
              + c["kv_pos_np"].nbytes + c["q_pos_np"].nbytes)
    b_ms, b_by = bound(nbytes, 4 * valid * Hq * hd, str(c["q"].dtype))
    name = attention_kernel_name(kernel)
    print(f"kernel flash_decode_quant timing kv{bits} shape={[B, Skv, Hq, Hkv, hd]} "
          f"kernel={name} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "shape": [B, Skv, Hq, Hkv, hd], "kernel": name,
            "valid_entries": valid, "window": c["window"], "softcap": c["softcap"]}


def matmul_record(name, source, replaces, errs, ms, plain_ms, library_ms, nbytes,
                  flops, dtype, **extra):
    """A dequant-matmul kernel's JSON record.  Its bound takes the peak of
    x's dtype: the codes are exact in bf16, so a bf16 tensor-core product
    of x and the codes, f32 accumulation and the scales applied per column,
    group or tile compute the same function (this kernel dequantises to
    f32 on CUDA cores instead)."""
    b_ms, b_by = bound(nbytes, flops, dtype)
    print(f"kernel {name} timing ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
          + " ".join(f"{k}={v}" for k, v in extra.items()))
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": max(e["max_abs_err"] for e in errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library": "torch.matmul of x with the weights dequantised to bf16",
            **extra, "cases": errs}


# the kernels of qmatmul.cu (repro_torch.quant.kernel.Kernel) that some
# case of run_matmul_checks held against its plain version
CHECKED_KERNELS = set()


def kernel_name(k):
    return (f"{k.design}/bm{k.bm}/int{k.bits}/{k.scales}/{k.dtype.split('.')[-1]}"
            + ("/split" if k.split else ""))


def ran_kernel(torch, fn):
    """Call ``fn`` and name the kernel of ``qmatmul.cu`` it launched
    (``repro_torch.quant.kernel.kernel_launches``)."""
    from repro_torch.quant.kernel import kernel_launches
    return ran_one(kernel_launches, fn, "dequant-matmul")


def check_kernels_checked(what, kernels):
    """Every kernel of qmatmul.cu that ``what`` launched was held against
    its plain version in run_matmul_checks."""
    missed = sorted(kernel_name(k) for k in kernels if k not in CHECKED_KERNELS)
    check(not missed, f"{what}: dequant-matmul kernels launched but never checked: {missed}")


def expected_design(dtype, group):
    """Tensor cores for bf16 x with a group that is 0 or a multiple of the
    mma depth (16); CUDA cores otherwise (qmatmul.cu's make_plan)."""
    import torch
    return "tensor_core" if dtype == torch.bfloat16 and group % 16 == 0 else "cuda_core"


def check_matmul(torch, label, name, fwd, plain, x, *args, **kw):
    out, kernel = ran_kernel(torch, lambda: fwd(x, *args, **kw))
    design = kernel.design
    CHECKED_KERNELS.add(kernel)
    ref = plain(x, *args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-30)
    tol = MATMUL_TOL[str(x.dtype)]
    want = expected_design(x.dtype, kw.get("group", 0))
    print(f"kernel {label} case={name!r} design={design} kernel={kernel_name(kernel)} "
          f"max_abs_err={err:.3e} "
          f"rel_to_max={err / scale:.3e} tol={tol:g}")
    check(out.dtype == x.dtype and out.shape == ref.shape and np.isfinite(err)
          and err <= tol * scale, f"{label} kernel disagrees with its plain version ({name})")
    check(design == want, f"{label} ({name}) ran on {design}, expected {want}")
    return {"case": name, "design": design, "max_abs_err": err, "rel_to_max": err / scale,
            "tol": tol}


def projection_shapes(cfg):
    """(K, N) of each distinct dense projection of a model, named by its
    weights: q, k and v (an MLA layer's factors stay fp: none), o, the
    MLP's (gate and up, down; none where every layer is MoE), the shared
    experts' MLP, the RG-LRU's gate and an untied lm_head."""
    D, hd, hdv = cfg.d_model, cfg.head_dim, cfg.v_head_dim
    qkv = () if cfg.is_mla else (("wq", (D, cfg.n_heads * hd)),
                                 ("wk/wv", (D, cfg.n_kv_heads * hd)))
    mlp = (("w_up", (D, cfg.d_ff)), ("w_down", (cfg.d_ff, D))) \
        if not all(cfg.moe_layer_mask()) else ()
    width = cfg.n_shared_experts * cfg.d_ff_expert
    shared = (("shared w_up", (D, width)), ("shared w_down", (width, D))) if width else ()
    rec = (("rec w_gate", (D, cfg.lru_width)),) if "recurrent" in cfg.layer_kinds else ()
    shapes = {}
    for what, kn in qkv + (("wo", (cfg.n_heads * hdv, D)),) + mlp + shared + rec + \
            ((("lm_head", (D, cfg.vocab_size)),) if not cfg.tie_embeddings else ()):
        shapes.setdefault(kn, what)
    return shapes


def run_matmul_checks(torch):
    """The dequant-matmul kernel through both of its wrappers."""
    from repro_torch.kernels.pim_mvm.kernel import pim_mvm_fwd, pim_mvm_plain
    from repro_torch.quant.core import dequantize, quantize, quantize_weights
    from repro_torch.config import get_config
    from repro_torch.quant.kernel import quant_matmul_fwd, quant_matmul_plain
    g = torch.Generator(device=DEVICE).manual_seed(4)

    def operands(M, K, N, dtype=torch.bfloat16):
        x = torch.randn((M, K), generator=g, device=DEVICE).to(dtype)
        w = torch.randn((K, N), generator=g, device=DEVICE) / K ** 0.5
        return x, w

    cases = {
        "int8 per-channel (8, 2048, 11008) decode": (8, 2048, 11008, 8, 0, None),
        "int4 per-channel (8, 11008, 2048) w_down": (8, 11008, 2048, 4, 0, None),
        "int8 group128 (128, 2048, 2048)": (128, 2048, 2048, 8, 128, None),
        "int4 group128 (128, 2048, 2048)": (128, 2048, 2048, 4, 128, None),
        "int8 (1024, 2048, 256) chunk-step wk": (1024, 2048, 256, 8, 0, None),
        "ragged int8 (3, 48, 50)": (3, 48, 50, 8, 0, None),
        "ragged int4 group32 (100, 96, 200)": (100, 96, 200, 4, 32, None),
        "f32 x int8 (8, 2048, 2048)": (8, 2048, 2048, 8, 0, torch.float32),
        "f32 x int4 group128 (64, 2048, 2048)": (64, 2048, 2048, 4, 128, torch.float32),
        "int8 per-channel (1024, 2048, 11008) chunk-step w_up": (1024, 2048, 11008, 8, 0,
                                                                 None),
        "int4 group128 (1024, 11008, 2048) chunk-step w_down": (1024, 11008, 2048, 4, 128,
                                                               None),
        "int8 per-channel (128, 2048, 2048) packed prefill": (128, 2048, 2048, 8, 0, None),
        "int4 per-channel (17, 2048, 256) between the tiles": (17, 2048, 256, 4, 0, None),
        "int8 per-channel (1, 2048, 2048) one row": (1, 2048, 2048, 8, 0, None),
        "int8 group8 (64, 256, 512) CUDA cores": (64, 256, 512, 8, 8, None),
        "int4 per-channel (1024, 2048, 11008) chunk-step w_up": (1024, 2048, 11008, 4, 0,
                                                                 None),
        "int4 per-channel (1024, 11008, 2048) chunk-step w_down": (1024, 11008, 2048, 4, 0,
                                                                   None),
        "int8 per-channel (1024, 2048, 2048) chunk-step wq": (1024, 2048, 2048, 8, 0, None),
        "int4 group128 (8, 2048, 2048) decode": (8, 2048, 2048, 4, 128, None),
        "int8 group128 (1024, 2048, 11008) chunk-step w_up": (1024, 2048, 11008, 8, 128,
                                                              None),
        "minitron-8b lm_head int8 (4, 4096, 256000) decode": (4, 4096, 256000, 8, 0, None),
        "minitron-8b lm_head int8 (3, 4096, 256000) packed prefill": (3, 4096, 256000, 8, 0,
                                                                      None),
    }
    # every projection of gemma2-9b as the engine runs it: per channel, int8
    # and int4, at the decode step's 8 rows, the packed prefill's 128 and the
    # chunk step's 1024
    for (K, N), what in projection_shapes(get_config("gemma2-9b")).items():
        for M in (8, 128, 1024):
            for bits in (8, 4):
                cases[f"gemma2-9b {what} int{bits} ({M}, {K}, {N})"] = (M, K, N, bits, 0, None)
    # every projection of qwen2.5-3b at the speculative verify's 40 rows
    # (8 slots x spec_k + 1), int8 and int4
    for (K, N), what in projection_shapes(get_config("qwen2.5-3b")).items():
        for bits in (8, 4):
            cases[f"qwen2.5-3b verify {what} int{bits} ({VERIFY_M}, {K}, {N})"] = (
                VERIFY_M, K, N, bits, 0, None)
    # qwen3-moe-30b-a3b's quantised projections (attention and the untied
    # lm_head; its expert banks stay bf16) at int8, at the decode step's 8
    # rows and its padded prefills' 128, 256 and 384; the lm_head at the
    # decode step and a prefill's last row
    for (K, N), what in projection_shapes(get_config(MOE_ARCH)).items():
        for M in ((1, 8) if what == "lm_head" else (8, 128, 256, 384)):
            cases[f"qwen3-moe {what} int8 ({M}, {K}, {N})"] = (M, K, N, 8, 0, None)
    # llama2-7b's projections at int8 (phase paper's w8kv8): the decode
    # step's 8 rows, the packed prefill's 128 and the chunk step's 1024; its
    # untied lm_head at the decode step and a prefill's last rows
    for (K, N), what in projection_shapes(get_config("llama2-7b")).items():
        for M in ((1, 8) if what == "lm_head" else (8, 128, 1024)):
            cases[f"llama2-7b {what} int8 ({M}, {K}, {N})"] = (M, K, N, 8, 0, None)
    # recurrentgemma-9b's projections at int8 (its w8kv8 run): attention's
    # and the MLP's, and the RG-LRU's w_gate (4096 x 4096, q's shape), at
    # the decode step's 8 rows and the padded prefills' 128..4608
    for (K, N), what in projection_shapes(get_config(RGEMMA_ARCH)).items():
        for M in RGEMMA_MATMUL_ROWS:
            cases[f"recurrentgemma-9b {what} int8 ({M}, {K}, {N})"] = (M, K, N, 8, 0, None)
    # deepseek-v2-236b's quantised projections at int8 (phase mla's w8kv8):
    # the MLA layers' wo, the dense layer's MLP, the shared experts' and the
    # untied lm_head, at the decode step's 8 rows and the padded prefills'
    # 128, 256 and 384; the lm_head at the decode step and a prefill's last
    # row
    for (K, N), what in projection_shapes(
            dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)).items():
        for M in ((1, 8) if what == "lm_head" else MLA_MATMUL_ROWS):
            cases[f"deepseek-v2 {what} int8 ({M}, {K}, {N})"] = (M, K, N, 8, 0, None)
    # whisper-large-v3's projections at int8 (phase cross's w8kv8): the
    # decode step's 8 rows, the encoder's and the cross keys' and values'
    # 8 x 1500 source rows, and 8 rows a prefill position at each of the
    # decoder's prefill lengths
    for arch, m in CROSS_MODELS.items():
        if not any(QUANT_RUNS[r].get("weight_bits") for r in m["runs"]):
            continue
        rows = (CROSS_BATCH, CROSS_BATCH * m["source"]) + \
            tuple(CROSS_BATCH * L for L in cross_lengths(arch))
        for (K, N), what in projection_shapes(cross_config(arch)).items():
            for M in rows:
                cases[f"{arch} {what} int8 ({M}, {K}, {N})"] = (M, K, N, 8, 0, None)
    errs = []
    for name, (M, K, N, bits, group, dtype) in cases.items():
        x, w = operands(M, K, N, dtype or torch.bfloat16)
        qt = quantize(w, bits, group=group)
        errs.append(check_matmul(torch, "quant_matmul", name, quant_matmul_fwd,
                                 quant_matmul_plain, x, qt.q, qt.scale, bits=bits,
                                 group=group))

    # split shapes (a decode tile and a wide tile) launched on two streams
    # at once give what they give alone, bit for bit (split-K)
    calls = []
    for M, K, N, bits, group in ((8, 2048, 11008, 8, 0), (128, 2048, 2048, 8, 128)):
        x, w = operands(M, K, N)
        qt = quantize(w, bits, group=group)
        calls.append(functools.partial(quant_matmul_fwd, x, qt.q, qt.scale, bits=bits,
                                       group=group))
    n, same = two_streams(torch, calls)
    print(f"kernel quant_matmul two_streams launches={n} identical={same}")
    check(same, "dequant-matmul split shapes on two streams differ from one stream")

    def timed(M, K, N, bits):
        x, _ = operands(M, K, N)
        copies = cold_copies(K * N * bits // 8)
        qts = [quantize(operands(1, K, N)[1], bits) for _ in range(copies)]
        nxt = cycler(qts)
        args = lambda: (lambda qt: (qt.q, qt.scale))(nxt())  # noqa: E731
        kw = dict(bits=bits)
        _, kernel = ran_kernel(torch, lambda: quant_matmul_fwd(x, *args(), **kw))
        ms = device_ms(lambda: quant_matmul_fwd(x, *args(), **kw), 100)
        plain_ms = device_ms(lambda: quant_matmul_plain(x, *args(), **kw), 10)
        lib = [dequantize(qt).to(torch.bfloat16) for qt in qts]
        nxt_lib = cycler(lib)
        library_ms = device_ms(lambda: torch.matmul(x, nxt_lib()), 100)
        nbytes = qts[0].q.numel() + qts[0].scale.numel() * 4 + (M * K + M * N) * 2
        return ms, plain_ms, library_ms, nbytes, 2 * M * K * N, copies, kernel.design

    bf16 = str(torch.bfloat16)

    def shape_record(M, K, N, bits):
        t = timed(M, K, N, bits)
        b_ms, b_by = bound(t[3], t[4], bf16)
        print(f"kernel quant_matmul timing shape=({M}, {K}, {N}) int{bits} design={t[6]} "
              f"ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})")
        return {"shape": [M, K, N], "weight_bits": bits, "design": t[6], "ms": t[0],
                "plain_ms": t[1], "library_ms": t[2], "bound_ms": b_ms, "bound_by": b_by,
                "copies": t[5]}

    # serving's decode shape at int8 (the record's main numbers), w_down at
    # int4, and the chunk step's w_up at int8 and w_down at int4
    ms, plain_ms, library_ms, nbytes, flops, copies, design = timed(8, 2048, 11008, 8)
    records = {"quant_matmul": matmul_record(
        "quant_matmul", "src/repro_torch/kernels/csrc/qmatmul.cu",
        "src/repro/quant/kernel.py:59", errs, ms, plain_ms, library_ms, nbytes, flops,
        bf16, shape=[8, 2048, 11008], weight_bits=8, design=design, copies=copies,
        int4_w_down=shape_record(8, 11008, 2048, 4),
        chunk_step=shape_record(1024, 2048, 11008, 8),
        verify=shape_record(VERIFY_M, 2048, 11008, 8),
        chunk_step_int4_w_down=shape_record(1024, 11008, 2048, 4),
        gemma2_9b={"decode_w_up_int8": shape_record(8, 3584, 14336, 8),
                   "decode_w_down_int4": shape_record(8, 14336, 3584, 4),
                   "chunk_step_w_up_int8": shape_record(1024, 3584, 14336, 8)},
        llama2_7b={"decode_w_up_int8": shape_record(8, 4096, 11008, 8),
                   "decode_w_down_int8": shape_record(8, 11008, 4096, 8)},
        recurrentgemma_9b={"decode_w_gate_int8": shape_record(8, 4096, 4096, 8),
                           "decode_w_up_int8": shape_record(8, 4096, 12288, 8),
                           "decode_w_down_int8": shape_record(8, 12288, 4096, 8)},
        deepseek_v2_236b={"decode_wo_int8": shape_record(8, 16384, 5120, 8),
                          "prefill384_wo_int8": shape_record(384, 16384, 5120, 8),
                          "decode_shared_w_up_int8": shape_record(8, 5120, 3072, 8),
                          "decode_lm_head_int8": shape_record(8, 5120, 102400, 8)},
        whisper_large_v3={"decode_w_up_int8": shape_record(8, 1280, 5120, 8),
                          "encoder_w_up_int8": shape_record(WHISPER_ENCODER_ROWS, 1280,
                                                            5120, 8)})}

    # -- the crossbar layout --------------------------------------------------
    cases = {"kernel_micro (256, 1024, 512)": (256, 1024, 512, None),
             "kernel_micro (512, 2048, 1024)": (512, 2048, 1024, None),
             "decode (8, 2048, 11008)": (8, 2048, 11008, None),
             "f32 x (256, 1024, 512)": (256, 1024, 512, torch.float32)}
    errs = []
    for name, (M, K, N, dtype) in cases.items():
        x, w = operands(M, K, N, dtype or torch.bfloat16)
        wq, sc = quantize_weights(w)
        errs.append(check_matmul(torch, "pim_mvm", name, pim_mvm_fwd, pim_mvm_plain,
                                 x, wq, sc))
    M, K, N = 512, 2048, 1024
    x, _ = operands(M, K, N)
    planes = [quantize_weights(operands(1, K, N)[1]) for _ in range(cold_copies(K * N))]
    nxt = cycler(planes)
    _, kernel = ran_kernel(torch, lambda: pim_mvm_fwd(x, *nxt()))
    ms = device_ms(lambda: pim_mvm_fwd(x, *nxt()), 100)
    plain_ms = device_ms(lambda: pim_mvm_plain(x, *nxt()), 10)
    from repro_torch.kernels.pim_mvm.ref import dequantize_ref
    lib = [dequantize_ref(wq, sc).to(torch.bfloat16) for wq, sc in planes]
    nxt_lib = cycler(lib)
    library_ms = device_ms(lambda: torch.matmul(x, nxt_lib()), 100)
    nbytes = K * N + planes[0][1].numel() * 4 + (M * K + M * N) * 2
    records["pim_mvm"] = matmul_record(
        "pim_mvm", "src/repro_torch/kernels/csrc/qmatmul.cu",
        "src/repro/kernels/pim_mvm/kernel.py:60", errs, ms, plain_ms, library_ms,
        nbytes, 2 * M * K * N, str(x.dtype), shape=[M, K, N], design=kernel.design,
        copies=len(planes))
    return records


# the kernels of grouped_matmul.cu (repro_torch.kernels.grouped_matmul.kernel.
# Kernel: op, design, dtype) that some case of run_grouped_checks held against
# its plain version
CHECKED_GROUPED = set()


def grouped_kernel_name(k):
    return f"{k.op}/{k.design}/{k.dtype.split('.')[-1]}"


def routed_sizes(rng, tokens, experts=MOE_EXPERTS, k=MOE_TOP_K):
    """Group sizes of ``tokens`` tokens, each routed to ``k`` distinct
    experts drawn uniformly (random weights route about so)."""
    picks = np.stack([rng.choice(experts, k, replace=False) for _ in range(tokens)])
    return np.bincount(picks.reshape(-1), minlength=experts)


def routing(torch, rng, tokens, experts=MOE_EXPERTS, k=MOE_TOP_K):
    """``tokens`` tokens routed to ``k`` distinct experts each, drawn
    uniformly and in any order, sorted as the MoE layer sorts them:
    ``order`` (tokens * k,) int64, the stable argsort of the pairs by
    expert, and the offsets (E + 1,) int32, both on the card, and the group
    sizes."""
    picks = np.stack([rng.choice(experts, k, replace=False) for _ in range(tokens)])
    picks = picks.reshape(-1)
    sizes = np.bincount(picks, minlength=experts)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    order = np.argsort(picks, kind="stable").astype(np.int64)
    return (torch.from_numpy(order).to(DEVICE), torch.from_numpy(off).to(DEVICE), sizes)


def grouped_operands(torch, g, sizes, K, N, dtype, copies=1):
    """x (T, K) and ``copies`` expert banks (E, K, N), scaled as the
    model's, and the offsets of ``sizes`` on the card."""
    sizes = np.asarray(sizes)
    x = torch.randn((int(sizes.sum()), K), generator=g, device=DEVICE).to(dtype)
    ws = [(torch.randn((len(sizes), K, N), generator=g, device=DEVICE) / K ** 0.5).to(dtype)
          for _ in range(copies)]
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    return x, ws, off.to(DEVICE)


def grouped_library(torch, x, w, off):
    """One PyTorch call computing the grouped product, where the card's
    torch has one (``torch._grouped_mm``, private, a yardstick only), else a
    ``torch.matmul`` a non-empty group with the sizes read first.  Returns
    (a function of the bank and, optionally, other rows than ``x``, its
    name)."""
    if hasattr(torch, "_grouped_mm"):
        try:
            ends = off[1:].contiguous()
            want = grouped_ref_f32(torch, x, w, off)
            got = torch._grouped_mm(x, w, offs=ends).float()
            if float((got - want).abs().max()) <= 1e-2 * max(1.0, float(want.abs().max())):
                return ((lambda wb, rows=x: torch._grouped_mm(rows, wb, offs=ends)),
                        "torch._grouped_mm")
        except (RuntimeError, TypeError) as e:
            print(f"kernel grouped_matmul library torch._grouped_mm refused: {e!r:.200}")
    bounds = off.tolist()
    groups = [(e, bounds[e], bounds[e + 1]) for e in range(len(bounds) - 1)
              if bounds[e + 1] > bounds[e]]

    def loop(wb, rows=x):
        return [torch.matmul(rows[a:b], wb[e]) for e, a, b in groups]
    return loop, "torch.matmul a non-empty group (sizes read first)"


def grouped_ref_f32(torch, x, w, off):
    from repro_torch.kernels.grouped_matmul.kernel import grouped_matmul_plain
    return grouped_matmul_plain(x.float(), w.float(), off)


def expected_grouped_design(dtype, K, N):
    """TMA for bf16 with K and N multiples of 8 and at least the 64 x 64
    box (the wrapper's plan: every operand here is 16-byte aligned); CUDA
    cores otherwise."""
    import torch
    return "tma" if (dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
                     and min(K, N) >= 64) else "cuda_core"


def grouped_case(torch, what, name, fn, plain, dtype, want):
    """``fn`` (one launch of a kernel of grouped_matmul.cu) against its
    plain version ``plain``, twice for the same bits, on the design
    ``want``; the case's record."""
    from repro_torch.kernels.grouped_matmul.kernel import kernel_launches
    out, kernel = ran_one(kernel_launches, fn, what)
    CHECKED_GROUPED.add(kernel)
    again = fn()
    ref = plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-30)
    tol = MATMUL_TOL[str(dtype)]
    same = torch.equal(out, again)
    print(f"kernel {what} case={name!r} design={kernel.design} "
          f"kernel={grouped_kernel_name(kernel)} max_abs_err={err:.3e} "
          f"rel_to_max={err / scale:.3e} tol={tol:g} repeat_identical={same} "
          f"bits_equal_plain={torch.equal(out, ref)}")
    check(out.dtype == dtype and out.shape == ref.shape and np.isfinite(err)
          and err <= tol * scale, f"{what} disagrees with its plain version ({name})")
    check(same, f"{what} ({name}): a second launch gave other bits")
    check(kernel.design == want, f"{what} ({name}) ran on {kernel.design}, expected {want}")
    return {"case": name, "kernel": grouped_kernel_name(kernel), "max_abs_err": err,
            "rel_to_max": err / scale, "tol": tol}


def grouped_bank(torch, g, E, K, N, dtype):
    return (torch.randn((E, K, N), generator=g, device=DEVICE) / K ** 0.5).to(dtype)


def run_grouped_checks(torch):
    """The MoE expert path's kernels (``grouped_matmul.cu``: the product,
    plain and scaled, the fused gate/up and the combine) against their
    plain versions at qwen3-moe-30b-a3b's shapes and at edge cases, each
    on the design its plan names; timed at the shapes the MoE phase runs
    beside their bounds, plain versions, ``torch._grouped_mm`` and, for
    gate/up, the unfused composition of the new product."""
    import torch.nn.functional as F
    from repro_torch.kernels.grouped_matmul import kernel as G
    g = torch.Generator(device=DEVICE).manual_seed(11)
    rng = np.random.default_rng(11)
    bf16, f32 = torch.bfloat16, torch.float32
    (Kg, Ng), (Kd, Nd) = MOE_GMM_SHAPES["gate/up"], MOE_GMM_SHAPES["down"]
    # (sizes, K, N, dtype) of the products; the scaled product and gate/up
    # run at the same sizes
    cases = {}
    for label, m in (("qwen3-moe", QWEN3_GMM), ("deepseek-v2", DS_GMM)):
        for what, (K, N) in m["shapes"].items():
            for phase, T in m["rows"].items():
                cases[f"{label} {what} {phase} T{T} ({K}, {N})"] = (
                    routed_sizes(rng, T // m["k"], m["experts"], m["k"]), K, N, bf16)
    cases.update({
        "empty experts first, between and last (64, 200)": ([0, 5, 0, 1, 9, 0], 64, 200, bf16),
        "every row to one expert T3072 (2048, 768)": (
            [0] * 40 + [3072] + [0] * 87, Kg, Ng, bf16),
        "T1 (2048, 768)": ([0, 1, 0], Kg, Ng, bf16),
        "groups smaller than the M tile (3, 17, 1, 64, 65)": ([3, 17, 1, 64, 65], Kd, Nd,
                                                              bf16),
        "N200 not a multiple of the tile": (routed_sizes(rng, 8), Kg, 200, bf16),
        "bf16 N36: CUDA cores": ([7, 0, 3, 12], 96, 36, bf16),
        "bf16 K48 below the box: CUDA cores": ([4, 9], 48, 64, bf16),
        "f32 (2048, 768): CUDA cores": (routed_sizes(rng, 8), Kg, Ng, f32),
        "f32 groups (0, 5, 0, 17), K100 N40": ([0, 5, 0, 17], 100, 40, f32),
    })
    errs = {"grouped_matmul": [], "grouped_gate_up": [], "combine": []}
    for name, (sizes, K, N, dtype) in cases.items():
        x, (w, wu), off = grouped_operands(torch, g, sizes, K, N, dtype, copies=2)
        T = x.shape[0]
        want = expected_grouped_design(dtype, K, N)
        plan = G.plan(x, w, x.new_empty((T, N)), wu)
        print(f"kernel grouped plan case={name!r} design={plan.design} rule={plan.rule!r}")
        check(plan.design == want, f"plan ({name}): {plan.design}, expected {want}")
        errs["grouped_matmul"].append(grouped_case(
            torch, "grouped_matmul", name, lambda: G.grouped_matmul_fwd(x, w, off),
            lambda: G.grouped_matmul_plain(x, w, off), dtype, want))
        gates = torch.rand((T,), generator=g, device=DEVICE).to(dtype)
        errs["grouped_matmul"].append(grouped_case(
            torch, "grouped_matmul", f"scaled {name}",
            lambda: G.grouped_matmul_fwd(x, w, off, gates),
            lambda: G.grouped_matmul_plain(x, w, off, gates), dtype, want))
        # gate/up reads its rows through an index: T + 3 tokens, each sorted
        # row one of them, in any order
        xt = torch.randn((T + 3, K), generator=g, device=DEVICE).to(dtype)
        rows = torch.randint(0, T + 3, (T,), generator=g, device=DEVICE)
        for act in ("silu",) + (("gelu", "relu2") if "decode" in name else ()):
            errs["grouped_gate_up"].append(grouped_case(
                torch, "grouped_gate_up", f"{act} {name}",
                lambda: G.grouped_gate_up_fwd(xt, rows, w, wu, off, act),
                lambda: G.grouped_gate_up_plain(xt, rows, w, wu, off, act), dtype, want))
    # the combine: k 1, 2 and 8, each token's experts drawn in any order
    Dd = DS_GMM_SHAPES["down"][1]
    for k, tokens, D, dtype in ((8, 8, Nd, bf16), (8, 128, Nd, bf16), (8, 384, Nd, bf16),
                                (1, 64, Nd, bf16), (2, 32, Nd, bf16), (8, 8, 36, bf16),
                                (2, 16, Nd, f32), (8, 5, 37, f32),
                                (6, 8, Dd, bf16), (6, 128, Dd, bf16), (6, 384, Dd, bf16)):
        order, _, _ = routing(torch, rng, tokens, experts=DS_EXPERTS if k == 6 else MOE_EXPERTS,
                              k=k)
        ys = torch.randn((tokens * k, D), generator=g, device=DEVICE).to(dtype)
        want = "vec16" if D * ys.element_size() % 16 == 0 else "scalar"
        errs["combine"].append(grouped_case(
            torch, "combine", f"k{k} tokens{tokens} D{D} {str(dtype)[6:]}",
            lambda: G.combine_fwd(ys, order, k), lambda: G.combine_plain(ys, order, k),
            dtype, want))

    def product_timing(what, phase, scaled=False, m=None):
        """Device time at one of the MoE phase's shapes (or of the model
        ``m``), cycling over expert banks that span twice the L2 (a layer's
        bank is read once a step)."""
        m = m or QWEN3_GMM
        K, N = m["shapes"][what]
        T = m["rows"][phase]
        sizes = routed_sizes(np.random.default_rng(12), T // m["k"], m["experts"], m["k"])
        selected = int((sizes > 0).sum())
        copies = cold_copies(selected * K * N * 2)
        x, ws, off = grouped_operands(torch, g, sizes, K, N, bf16, copies)
        gates = torch.rand((T,), generator=g, device=DEVICE).to(bf16) if scaled else None
        nxt = cycler(ws)
        _, kernel = ran_one(G.kernel_launches,
                            lambda: G.grouped_matmul_fwd(x, nxt(), off, gates), "grouped matmul")
        ms = device_ms(lambda: G.grouped_matmul_fwd(x, nxt(), off, gates), 100)
        plain_ms = device_ms(lambda: G.grouped_matmul_plain(x, nxt(), off, gates), 3)
        lib, lib_name = grouped_library(torch, x, ws[0], off)
        library_ms = device_ms(lambda: lib(nxt()), 50)
        # the selected experts' weights once, x and y once, the offsets (and
        # the scales)
        nbytes = selected * K * N * 2 + T * (K + N) * 2 + off.numel() * 4 + (2 * T if scaled
                                                                            else 0)
        b_ms, b_by = bound(nbytes, 2 * T * K * N, str(bf16))
        label = ("scaled " if scaled else "") + what
        print(f"kernel grouped_matmul timing {m['label']} {label} {phase} shape=({T}, {K}, {N}) "
              f"selected_experts={selected} kernel={grouped_kernel_name(kernel)} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} ({lib_name}, unscaled) "
              f"bound_ms={b_ms:.5f} ({b_by}) weight_rate_tb_s="
              f"{selected * K * N * 2 / ms / 1e9:.3f} library_over_kernel={library_ms / ms:.3f}")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library": lib_name, "bound_ms": b_ms, "bound_by": b_by,
                "shape": [T, K, N], "selected_experts": selected,
                "kernel": grouped_kernel_name(kernel), "copies": copies}

    def gate_up_timing(phase, m=None):
        """The fused gate/up against its plain version, the library's
        composition (the gather, two ``torch._grouped_mm`` and silu * mul)
        and the same composition on the new product."""
        m = m or QWEN3_GMM
        Kg, Ng = m["shapes"]["gate/up"]
        T = m["rows"][phase]
        tokens = T // m["k"]
        order, off, sizes = routing(torch, np.random.default_rng(13), tokens, m["experts"],
                                    m["k"])
        selected = int((sizes > 0).sum())
        copies = cold_copies(2 * selected * Kg * Ng * 2)
        x = torch.randn((tokens, Kg), generator=g, device=DEVICE).to(bf16)
        rows = order // m["k"]
        pairs = [(grouped_bank(torch, g, m["experts"], Kg, Ng, bf16),
                  grouped_bank(torch, g, m["experts"], Kg, Ng, bf16)) for _ in range(copies)]
        nxt = cycler(pairs)

        def fused():
            wg, wu = nxt()
            return G.grouped_gate_up_fwd(x, rows, wg, wu, off, "silu")

        def unfused():
            wg, wu = nxt()
            xs = x[rows]
            return F.silu(G.grouped_matmul_fwd(xs, wg, off)) * G.grouped_matmul_fwd(xs, wu, off)

        def plain():
            wg, wu = nxt()
            return G.grouped_gate_up_plain(x, rows, wg, wu, off, "silu")

        _, kernel = ran_one(G.kernel_launches, fused, "grouped gate/up")
        ms = device_ms(fused, 100)
        unfused_ms = device_ms(unfused, 100)
        plain_ms = device_ms(plain, 3)
        lib, lib_name = grouped_library(torch, x[rows], pairs[0][0], off)

        def library():
            wg, wu = nxt()
            xs = x[rows]
            return F.silu(lib(wg, xs)) * lib(wu, xs)
        library_ms = device_ms(library, 50)
        # both banks' selected experts once, the token rows, the row index
        # and h once, the offsets
        nbytes = (2 * selected * Kg * Ng * 2 + tokens * Kg * 2 + T * 8 + T * Ng * 2
                  + off.numel() * 4)
        b_ms, b_by = bound(nbytes, 2 * 2 * T * Kg * Ng, str(bf16))
        print(f"kernel grouped_gate_up timing {m['label']} {phase} shape=({T}, {Kg}, {Ng}) "
              f"tokens={tokens} "
              f"selected_experts={selected} kernel={grouped_kernel_name(kernel)} ms={ms:.4f} "
              f"unfused_new_product_ms={unfused_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (x[rows], 2 x {lib_name}, silu * mul) "
              f"bound_ms={b_ms:.5f} ({b_by}) weight_rate_tb_s="
              f"{2 * selected * Kg * Ng * 2 / ms / 1e9:.3f} unfused_over_fused="
              f"{unfused_ms / ms:.3f} library_over_fused={library_ms / ms:.3f}")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library": f"x[rows], two {lib_name}, silu * mul", "unfused_ms": unfused_ms,
                "unfused": "x[rows], two grouped_matmul_fwd, silu * mul", "bound_ms": b_ms,
                "bound_by": b_by, "shape": [T, Kg, Ng], "selected_experts": selected,
                "kernel": grouped_kernel_name(kernel), "copies": copies}

    def combine_timing(phase, m=None):
        """The combine against its plain version and ``index_add_`` into
        zeros (the same sums in the order the atomics land)."""
        m = m or QWEN3_GMM
        k, Nd = m["k"], m["shapes"]["down"][1]
        T = m["rows"][phase]
        tokens = T // k
        order, _, _ = routing(torch, np.random.default_rng(14), tokens, m["experts"], k)
        yss = [torch.randn((T, Nd), generator=g, device=DEVICE).to(bf16)
               for _ in range(cold_copies(T * Nd * 2))]
        nxt = cycler(yss)
        tok = order // k
        _, kernel = ran_one(G.kernel_launches, lambda: G.combine_fwd(nxt(), order, k),
                            "combine")
        ms = device_ms(lambda: G.combine_fwd(nxt(), order, k), 100)
        plain_ms = device_ms(lambda: G.combine_plain(nxt(), order, k), 20)
        library_ms = device_ms(lambda: torch.zeros((tokens, Nd), dtype=bf16, device=DEVICE)
                               .index_add_(0, tok, nxt()), 50)
        nbytes = T * Nd * 2 + tokens * Nd * 2 + T * 8
        b_ms, b_by = bound(nbytes, T * Nd, str(bf16))
        print(f"kernel combine timing {m['label']} {phase} rows={T} tokens={tokens} k={k} D={Nd} "
              f"kernel={grouped_kernel_name(kernel)} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (zeros + index_add_) bound_ms={b_ms:.5f} ({b_by})")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library": "torch.zeros + index_add_", "bound_ms": b_ms, "bound_by": b_by,
                "shape": [T, Nd], "tokens": tokens, "kernel": grouped_kernel_name(kernel)}

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library", "shape",
            "kernel")
    source = "src/repro_torch/kernels/csrc/grouped_matmul.cu"
    note = ("no TPU kernel: the port's own kernel for jax.lax.ragged_dot, an XLA op, in "
            "the reference's dropless MoE layer")
    down = product_timing("down", "decode", scaled=True)
    gate_up = gate_up_timing("decode")
    comb = combine_timing("decode")
    return {
        "grouped_matmul": {
            "name": "grouped_matmul", "route": "cuda", "source": source,
            "replaces": "src/repro/models/moe.py:213", "replaces_note": note,
            "max_abs_err": max(e["max_abs_err"] for e in errs["grouped_matmul"]),
            **{k: down[k] for k in keys}, "timed": "scaled down product, decode",
            "scaled_down_prefill384": product_timing("down", "prefill384", scaled=True),
            "gate_up_decode": product_timing("gate/up", "decode"),
            "down_decode": product_timing("down", "decode"),
            "gate_up_prefill384": product_timing("gate/up", "prefill384"),
            "down_prefill384": product_timing("down", "prefill384"),
            "gate_up_prefill128": product_timing("gate/up", "prefill128"),
            "deepseek_v2_236b": {
                "scaled_down_decode": product_timing("down", "decode", True, DS_GMM),
                "scaled_down_prefill384": product_timing("down", "prefill384", True, DS_GMM)},
            "cases": errs["grouped_matmul"]},
        "grouped_gate_up": {
            "name": "grouped_gate_up", "route": "cuda", "source": source,
            "replaces": "src/repro/models/moe.py:211", "replaces_note": note,
            "max_abs_err": max(e["max_abs_err"] for e in errs["grouped_gate_up"]),
            **{k: gate_up[k] for k in keys}, "unfused_ms": gate_up["unfused_ms"],
            "timed": "silu, decode", "prefill384": gate_up_timing("prefill384"),
            "deepseek_v2_236b": {"decode": gate_up_timing("decode", DS_GMM),
                                 "prefill384": gate_up_timing("prefill384", DS_GMM)},
            "cases": errs["grouped_gate_up"]},
        "combine": {
            "name": "combine", "route": "cuda", "source": source,
            "replaces": "src/repro/models/moe.py:215",
            "replaces_note": "no TPU kernel: the reference's scatter-add (an XLA op) of "
                             "the weighted expert rows",
            "max_abs_err": max(e["max_abs_err"] for e in errs["combine"]),
            **{k: comb[k] for k in keys}, "timed": "decode",
            "prefill384": combine_timing("prefill384"),
            "deepseek_v2_236b": {"decode": combine_timing("decode", DS_GMM),
                                 "prefill384": combine_timing("prefill384", DS_GMM)},
            "cases": errs["combine"]}}


def check_grouped_checked(what, kernels):
    """Every kernel of grouped_matmul.cu that ``what`` launched was held
    against its plain version in run_grouped_checks."""
    missed = sorted(grouped_kernel_name(k) for k in kernels if k not in CHECKED_GROUPED)
    check(not missed, f"{what}: grouped matmul kernels launched but never checked: {missed}")


# ---------------------------------------------------------------------------
# engine and logits at full width
# ---------------------------------------------------------------------------

def reset_launches():
    """Every wrapper's launch count and per-kernel counter to 0 (a replayed
    CUDA graph adds what its capture counted: ``repro_torch.kernels.launches``)."""
    from repro_torch.kernels import launches
    for fn in launches.wrappers().values():
        fn.launches = 0
    for counter in launches.counters().values():
        counter.clear()


def read_launches():
    from repro_torch.kernels import launches
    return {name: fn.launches for name, fn in launches.wrappers().items()}


def read_kernels():
    """Launches of each kernel of qmatmul.cu since reset_launches(), and
    of each of its designs."""
    from repro_torch.quant.kernel import DESIGNS, kernel_launches
    kernels = kernel_launches.copy()
    return kernels, {d: sum(n for k, n in kernels.items() if k.design == d) for d in DESIGNS}


def tensor_bytes(tree):
    """Bytes of the tensors in a nested dict/list (a slot pool); of a
    DTensor, this rank's shard."""
    import torch
    if isinstance(tree, torch.Tensor):
        tree = tree.to_local() if hasattr(tree, "to_local") else tree
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(t) for t in tree.values())
    return sum(tensor_bytes(t) for t in tree)


def attention_layers(cfg):
    """Layers that run attention, and so launch its kernels: the global and
    local layers, not the recurrent kinds (``ssm``, ``recurrent``)."""
    return sum(k in ("global", "local") for k in cfg.layer_kinds)


def decode_attention_layers(cfg):
    """Layers whose decode runs a decode kernel: every attention layer but
    MLA's, whose absorbed decode is plain PyTorch (the reference's is
    jnp)."""
    return 0 if cfg.is_mla else attention_layers(cfg)


def attention_head_dims(cfg):
    """The (q/k, v) head dims of the prefill kernel's calls: MLA's q/k
    carries its RoPE dims (128 + 64 at deepseek-v2, v 128)."""
    return cfg.head_dim + (cfg.rope_head_dim if cfg.is_mla else 0), cfg.v_head_dim


def projections(cfg):
    """Dense projections of one forward call (each a dequant-matmul under
    ``weight_bits``): q, k, v, o in every attention layer (o alone in an
    MLA layer, whose factors stay bf16), the MLP's (three gated, two plain)
    in every layer that has one and is not MoE (the experts stay bf16; an
    SSD layer has none), the shared experts' three in every MoE layer that
    has them, the RG-LRU's ``w_gate`` in every recurrent layer (its other
    projections and Mamba's are no ``QUANT_PARAM_KEYS`` name and stay bf16),
    and an untied lm_head once."""
    kinds = cfg.layer_kinds
    mlp = (3 if cfg.glu else 2) * sum(not m and k != "ssm"
                                      for k, m in zip(kinds, cfg.moe_layer_mask()))
    shared = 3 * moe_layers(cfg) if cfg.n_shared_experts else 0
    return (1 if cfg.is_mla else 4) * attention_layers(cfg) + mlp + shared + \
        kinds.count("recurrent") + (0 if cfg.tie_embeddings else 1)


def moe_layers(cfg):
    """MoE layers of the stack: one forward call launches the fused gate/up,
    the down product and the combine once in each."""
    return sum(cfg.moe_layer_mask())


def local_positions(cfg, cache):
    """The largest position held by any local (ring) layer's pool."""
    from repro_torch.models.transformer import build_groups
    return max((int(cache["stack"][gi][f"u{ui}"]["attn"]["pos"].max())
                for gi, spec in enumerate(build_groups(cfg))
                for ui, (kind, _) in enumerate(spec.units) if kind == "local"), default=-1)


@contextlib.contextmanager
def eager_programs():
    """Engines built inside run their three programs through the eager
    methods (the functions the graphs capture), not replayed from graphs."""
    from repro_torch.serving.executor import Executor
    capture = Executor.capture
    Executor.capture = lambda self, *a, **k: None
    try:
        yield
    finally:
        Executor.capture = capture


def expected_launches(cfg, st, bits, paths, draft):
    """Launches of the decodes and the dequant-matmul that a drain with the
    stats ``st`` makes: a decode step runs every attention layer's decode
    attention and every projection; a speculative step runs ``spec_k`` draft decode
    steps in the draft's layers (the target's own, or the draft model's and
    one catch-up step), and a verify through every target projection (its
    attention takes the oracle); prefills run every target projection.
    Every forward call (a decode step or a prefill) runs the fused gate/up,
    the down product and the combine once in each MoE layer.  An MLA
    layer's decode launches no decode kernel."""
    steps, calls = st["decode_steps"], st["decode_steps"] + st["prefill_calls"]
    decode = "flash_decode_quant" if bits.get("kv_bits") else "flash_decode"
    want = {"flash_decode": 0, "flash_decode_quant": 0,
            "quant_matmul": projections(cfg) * calls if bits.get("weight_bits") else 0,
            **dict.fromkeys(("grouped_gate_up", "grouped_matmul", "combine"),
                            moe_layers(cfg) * calls)}
    k = paths.get("spec_k", 0)
    if not k:
        want[decode] = steps * decode_attention_layers(cfg)
    elif paths.get("spec_draft") == "model":
        want["flash_decode"] = steps * (k + 1) * decode_attention_layers(draft[0])
    else:
        want[decode] = steps * k * decode_attention_layers(cfg)
        # a self-draft is quantised at spec_draft_bits (default 8), or is
        # the serving params themselves
        if paths.get("spec_draft_bits", 8) or bits.get("weight_bits"):
            want["quant_matmul"] += projections(cfg) * k * steps
    return want


def run_engine(torch, cfg, params, run="fp", kv_len=1024, long_prompts=(), eager=False,
               draft=None, warm=True, after=None, mesh=None, **paths):
    """One drain of the 16 requests (and ``long_prompts``), fp or quantised
    (``QUANT_RUNS``), traced, with every kernel's launches counted over that
    drain alone.  The default path replays its programs from CUDA graphs;
    ``eager`` runs them through the eager methods; ``paths`` picks a
    baseline (``fused=False``, ``packed=False``) or speculative decoding
    (``spec_k`` and its draft; ``draft`` = (cfg, params) of a draft model).
    ``warm``: drain two requests on an engine of the same configuration
    first (cuBLAS handles, allocator pools, kernel modules); a model's later
    runs find these warm (an engine's capture runs each program once before
    it records it).  ``after``: called with the drained engine once its
    checks pass.  ``mesh``: the engine sharded over it (phase mesh)."""
    from repro_torch.kernels.launches import counters as launch_counters
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    bits = QUANT_RUNS[run]
    label = run + "".join(f" {k}={v}" for k, v in paths.items()) + (" eager" if eager else "")
    ecfg = EngineConfig(max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK,
                        max_new_tokens=NEW_TOKENS, impl="flash", trace=True, **bits, **paths)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in rng.integers(4, 385, N_REQUESTS)]
    prompts += [rng.integers(0, cfg.vocab_size, size=n) for n in long_prompts]

    with eager_programs() if eager else contextlib.nullcontext():
        if warm:
            warm_engine = ServingEngine(cfg, params, EngineConfig(
                max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK, max_new_tokens=2,
                impl="flash", **bits, **paths), device=DEVICE, draft=draft, mesh=mesh)
            for p in prompts[:2]:
                warm_engine.submit(p)
            warm_engine.run_until_drained()
            del warm_engine
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        engine = ServingEngine(cfg, params, ecfg, device=DEVICE, draft=draft, mesh=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t_build
    graphs = engine.executor.graphs
    packable = engine._packable
    check((graphs is None) == (eager or not paths.get("fused", True)),
          f"{label}: programs {'not ' if graphs is None else ''}captured")
    if graphs is not None:
        # a stack that cannot be packed (MoE) captures its fused step alone
        want = ["spec_step" if paths.get("spec_k") else "fused_step"] + (
            ["packed_prefill", "chunk_step"] if paths.get("packed", True) and packable
            else [])
        check(sorted(graphs.graphs) == sorted(want), f"{label}: captured {sorted(graphs.graphs)}")
    reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    kernels, designs = read_kernels()
    attn = {k: v.copy() for k, v in launch_counters().items()
            if k not in ("qmatmul", "grouped_matmul")}
    grouped = launch_counters()["grouped_matmul"].copy()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    qp = engine.executor.params
    params_gb = sum(tensor_bytes(t) for t in (*qp.parameters(), *qp.buffers())) / 1e9
    pool_gb = tensor_bytes(engine.pool.cache) / 1e9
    st = engine.stats()
    label += " mesh" if mesh is not None else ""
    print(f"engine run={label} arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"weight_bits={st['weight_bits']} kv_bits={st['kv_bits']} "
          f"finished={st['finished']}/{len(prompts)} tokens={st['tokens']} "
          f"tokens_per_s={st['tokens_per_s']:.2f} mean_ttft_s={st['mean_ttft_s']:.4f} "
          f"ttft_p95_s={st['ttft_p95_s']:.4f} mean_tpot_s={st['mean_tpot_s']:.5f} "
          f"decode_steps={st['decode_steps']} prefill_calls={st['prefill_calls']} "
          f"prefill_tokens={st['prefill_tokens']} wall_s={wall:.3f} build_s={build_s:.3f} "
          f"decode_step_wall_ms={st['trace_decode_step_s'] * 1e3:.3f} "
          f"decode_step_p95_ms={st['trace_decode_step_p95_s'] * 1e3:.3f} "
          f"peak_memory_gib={peak_gib:.2f} params_gb={params_gb:.3f} "
          f"pool_gb={pool_gb:.4f} "
          + "".join(f"{k}={st[k]} " for k in ("spec_steps", "spec_acceptance",
                                               "spec_tokens_per_step") if k in st)
          + f"launches={json.dumps(launches)} "
          f"qmatmul_designs={json.dumps(designs)} "
          f"qmatmul_kernels={json.dumps({kernel_name(k): n for k, n in kernels.items()})} "
          f"grouped_kernels={json.dumps({grouped_kernel_name(k): n for k, n in grouped.items()})} "
          + " ".join(f"{w}_kernels=" + json.dumps(
              {attention_kernel_name(k): n for k, n in c.items()}) for w, c in attn.items()))
    check(st["finished"] == len(prompts) and st["failed"] == 0,
          f"engine ({label}) finished {st['finished']} of {len(prompts)}")
    outs = [r.output for r in sorted(engine.finished, key=lambda r: r.uid)]
    check(all(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o)
              for o in outs), f"engine ({label}) produced malformed token streams")
    if paths.get("packed", True) and packable:
        check(any(n > CHUNK for n in st["prompt_lens"]), "no chunked prefill ran")
    elif paths.get("packed", True):
        # padded admission: one prefill a request, padded to a chunk multiple
        check(st["prefill_calls"] == len(prompts) and
              any(n > CHUNK for n in st["prompt_lens"]),
              f"{label}: {st['prefill_calls']} padded prefills for {len(prompts)} requests")
    else:
        check(st["prefill_calls"] == len(prompts), f"{label}: {st['prefill_calls']} "
              f"prefill calls for {len(prompts)} requests")
    if "local" in cfg.pattern:
        # the long prompt's slot keeps its ring: positions past the window
        held = local_positions(cfg, engine.pool.cache)
        print(f"engine run={label} local_ring_cap={min(cfg.window, kv_len)} "
              f"largest_position_held={held}")
        check(held >= min(cfg.window, kv_len), f"{label}: no local ring wrapped")
    # every decode attention and every projection of every forward call
    # (decode or speculative step, packed prefill, chunk step) went through
    # its kernel
    want = expected_launches(cfg, st, bits, paths, draft)
    for name, n in want.items():
        check(launches[name] == n, f"{label}: {name} launches {launches[name]} != {n}")
    want_mm = want["quant_matmul"]
    # the engine runs bf16: every projection on tensor cores
    check(designs == {"cuda_core": 0, "tensor_core": want_mm},
          f"{label}: qmatmul designs {designs}, want {want_mm} on tensor cores")
    check_kernels_checked(f"engine ({label})", kernels)
    check_grouped_checked(f"engine ({label})", grouped)
    # every expert product on the TMA design (bf16, K and N multiples of 8),
    # every combine in 16-byte pieces
    check(all(k.design in ("tma", "vec16") for k in grouped),
          f"{label}: grouped matmul kernels {sorted(map(grouped_kernel_name, grouped))}")
    # a draft model prefills each request's prompt once, in its own layers;
    # a stack without attention (mamba2) launches no prefill kernel
    prefills = launches["flash_prefill"] - (st["finished"] * draft[0].n_layers if draft else 0)
    n_attn = attention_layers(cfg)
    check((prefills > 0) == (n_attn > 0) and prefills % max(n_attn, 1) == 0,
          f"{label}: prefill kernel launches {launches['flash_prefill']}")
    # every packed prefill on the design its head dims call for (tensor
    # cores at 64, 128, 256 and MLA's 192/128), in kernels that phase 3
    # checked
    want_pf = expected_prefill_design(torch.bfloat16, *attention_head_dims(cfg))
    on = sum(n for k, n in attn["prefill"].items() if k.design == want_pf)
    check(on == launches["flash_prefill"],
          f"{run}: {on} of {launches['flash_prefill']} prefill launches on {want_pf}")
    if not paths.get("packed", True):
        # one non-segmented prefill a request and layer
        check(launches["flash_prefill"] == st["prefill_calls"] * n_attn,
              f"{label}: prefill launches {launches['flash_prefill']}")
    check_attention_checked(f"engine ({label}) prefill", attn["prefill"], CHECKED_PREFILL)
    check_attention_checked(f"engine ({label}) decode", attn["decode"], CHECKED_DECODE)
    check_attention_checked(f"engine ({label}) quantised decode", attn["decode_quant"],
                            CHECKED_DECODE_QUANT)
    check(launches["pim_mvm"] == 0, f"{label}: the crossbar kernel ran in serving")
    if after is not None:
        after(engine)
    return {"stats": st, "launches": launches, "designs": designs, "wall_s": wall,
            "peak_gib": peak_gib, "outputs": outs, "build_s": build_s, "prompts": prompts,
            "kernels": {"qmatmul": kernels, "grouped_matmul": grouped, **attn},
            "params_gb": params_gb, "pool_gb": pool_gb}


def run_graphs(torch, cfg, params, run, replayed, kv_len, long_prompts, draft=None,
               **paths):
    """The same drain as ``replayed`` (the engine or spec phase's, its
    programs replayed from CUDA graphs) through the eager methods: the token
    streams bit for bit, the launch counts (replays counted) and the kernels
    equal; tokens/s, TTFT, TPOT, the decode step's wall time (dispatch +
    fetch) and peak memory of both."""
    eager = run_engine(torch, cfg, params, run, kv_len=kv_len, long_prompts=long_prompts,
                       eager=True, draft=draft, **paths)
    r, e = replayed["stats"], eager["stats"]
    same_streams = replayed["outputs"] == eager["outputs"]
    run = run + "".join(f" {k}={v}" for k, v in paths.items())
    print(f"graphs arch={cfg.name} run={run} streams_identical={same_streams} "
          f"launches_equal={replayed['launches'] == eager['launches']} "
          + " ".join(f"{k}_eager={e[k]:.5f} {k}_replayed={r[k]:.5f}" for k in (
              "tokens_per_s", "mean_ttft_s", "ttft_p95_s", "mean_tpot_s",
              "trace_decode_step_s", "trace_decode_step_p95_s"))
          + f" peak_memory_gib_eager={eager['peak_gib']:.3f} "
          f"peak_memory_gib_replayed={replayed['peak_gib']:.3f} "
          f"build_s_eager={eager['build_s']:.3f} build_s_replayed={replayed['build_s']:.3f}")
    check(same_streams, f"graphs ({cfg.name} {run}): replayed and eager streams differ")
    check(replayed["launches"] == eager["launches"] and
          replayed["kernels"] == eager["kernels"],
          f"graphs ({cfg.name} {run}): launches {replayed['launches']} replayed, "
          f"{eager['launches']} eager")
    return eager


def run_sampling(torch, cfg, params, kv_len, **paths):
    """``temperature`` 0.8 through the replayed programs, whose graphs draw
    from the executor's generator (registered with each graph): an engine
    with the same seed repeats a run's streams, another seed does not, and
    each stream's tokens differ from one another (each replay draws anew).
    ``paths``: speculative decoding, whose graph draws its drafts, its
    acceptance uniforms and the residual's draws."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    runs = []
    for seed in (3, 3, 4):
        engine = ServingEngine(cfg, params, EngineConfig(
            max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK, max_new_tokens=8,
            temperature=0.8, seed=seed, **paths), device=DEVICE)
        rng = np.random.default_rng(0)
        for n in (5, 20, 40, 200):
            engine.submit(rng.integers(0, cfg.vocab_size, size=n))
        runs.append([r.output for r in sorted(engine.run_until_drained(), key=lambda r: r.uid)])
        del engine
    repeats, differs = runs[0] == runs[1], runs[0] != runs[2]
    fresh = all(len(set(o)) > 1 for o in runs[0])
    print(f"sampling arch={cfg.name} temperature=0.8 "
          + "".join(f"{k}={v} " for k, v in paths.items())
          + f"same_seed_repeats={repeats} "
          f"other_seed_differs={differs} replays_draw_anew={fresh} stream0={runs[0][0]}")
    check(repeats and differs and fresh, "sampling through the graphs is not seeded draws")


def run_baselines(torch, cfg, params, by_run, kv_len, long_prompts):
    """The engine's baselines at full width, fp, their own calls eager (one
    launch a kernel): sequential admission (``packed=False``: a batch-1
    prefill a request, right-padded to a power-of-two bucket on qwen2.5-3b,
    exact on gemma2-9b, whose 4600-token prompt fills a wrapped ring), the
    fused step replayed; and on qwen2.5-3b the host-looped step
    (``fused=False``), whose greedy streams equal the sequential fused
    path's bit for bit (the same admission, so the same prefill)."""
    drain = dict(kv_len=kv_len, long_prompts=long_prompts)
    seq = run_engine(torch, cfg, params, "fp", packed=False, **drain)
    by_run[f"{cfg.name} fp packed=False"] = seq["launches"]
    if cfg.name != "qwen2.5-3b":
        return
    host = run_engine(torch, cfg, params, "fp", fused=False, **drain)
    by_run[f"{cfg.name} fp fused=False"] = host["launches"]
    same = host["outputs"] == seq["outputs"]
    print(f"baseline arch={cfg.name} fused=False streams_equal_fused_sequential={same}")
    check(same, "the host-looped streams differ from the fused step's")


def draft_model(torch, cfg):
    """A draft model for speculative decoding: the target's config cut to
    ``DRAFT_LAYERS`` layers, random bf16 weights of a seed of its own."""
    from repro_torch.models import transformer as T
    dcfg = dataclasses.replace(cfg, n_layers=DRAFT_LAYERS, name=cfg.name + "-draft")
    return dcfg, T.init_params(dcfg, torch.Generator(device=DEVICE).manual_seed(DRAFT_SEED),
                               device=DEVICE, dtype=torch.bfloat16)


def divergences(torch, cfg, params, run, prompts, plain, spec):
    """Where each speculative stream first parts from the plain one: (request,
    token, margin, bound), the margin being the top-1 minus top-2 of the
    plain model's logits for that token (a batch-1 prefill of the prompt and
    the plain stream before it, through the kernels), the bound ``NEAR_TIE``
    of those logits' scale."""
    from repro_torch.models import transformer as T
    from repro_torch.quant.core import quantize_params
    out, target = [], None
    for uid, (prompt, a, b) in enumerate(zip(prompts, plain, spec)):
        t = next((i for i in range(len(a)) if a[i] != b[i]), None)
        if t is None:
            continue
        if target is None:
            wb = QUANT_RUNS[run].get("weight_bits")
            target = T.Transformer(cfg, quantize_params(params, wb)) if wb else params
        seq = np.concatenate([prompt, np.asarray(a[:t])]).astype(np.int32)
        with torch.no_grad():
            logits, _ = T.prefill(target, cfg, torch.from_numpy(seq[None]).to(DEVICE),
                                  impl="flash", kv_cap=seq.size)
        row = logits[0].float()
        top = torch.topk(row, 2).values
        out.append((uid, t, float(top[0] - top[1]),
                    NEAR_TIE * max(1.0, float(row.abs().max()))))
    return out


def profile_spec(torch, cfg, params, run, kv_len, draft=None, **paths):
    """Where a speculative step's time goes with every slot busy: two
    replayed steps timed on the host clock, then profiled (busy time)."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK, max_new_tokens=64,
        impl="flash", **QUANT_RUNS[run], **paths), device=DEVICE, draft=draft)
    rng = np.random.default_rng(2)
    for _ in range(MAX_BATCH):
        engine.submit(rng.integers(0, cfg.vocab_size, size=16))
    engine.step()                     # admission (one packed prefill) + a step
    engine.step()
    check(len(engine.pool.decoding()) == MAX_BATCH, "spec profile: pool not full")
    label = run + "".join(f" {k}={v}" for k, v in paths.items())
    return profiled(torch, cfg.name, label, "spec_step replayed", engine.step, 2)


def run_spec(torch, cfg, params, plain, by_run, kv_len, long_prompts):
    """Speculative decoding (``spec_k`` 4) on the engine phase's drains,
    replayed from graphs: each run of ``SPEC_RUNS`` against the plain
    replayed drain of its configuration (``plain``): every request
    finishes with its budget, every stream equals the plain one up to a
    token where the plain logits are a near-tie (printed with its margin),
    and drafting with the serving params accepts at least 0.9 of the
    drafts.  A run marked "eager" is replayed again through the eager
    methods (``run_graphs``: streams bit for bit, launches equal), and one
    of its steps profiled."""
    draft = None
    for run, name, spec in SPEC_RUNS[cfg.name]:
        paths = dict(spec_k=SPEC_K, **spec)
        model = spec.get("spec_draft") == "model"
        if model and draft is None:
            draft = draft_model(torch, cfg)
        dm = draft if model else None
        r = run_engine(torch, cfg, params, run, kv_len=kv_len, long_prompts=long_prompts,
                       draft=dm, warm=False, **paths)
        label = f"{cfg.name} {run} spec {name.split()[0]}"
        by_run[label] = r["launches"]
        SPEC_RECORDS[(cfg.name, run, name.split()[0])] = r     # phase mesh drains it again
        st, ps = r["stats"], plain[run]["stats"]
        divs = divergences(torch, cfg, params, run, r["prompts"], plain[run]["outputs"],
                           r["outputs"])
        print(f"spec arch={cfg.name} run={run} draft={name.split()[0]} spec_k={SPEC_K} "
              f"acceptance={st['spec_acceptance']:.4f} "
              f"tokens_per_step={st['spec_tokens_per_step']:.4f} "
              f"spec_steps={st['spec_steps']} plain_decode_steps={ps['decode_steps']} "
              + " ".join(f"{k}={st[k]:.5f} plain_{k}={ps[k]:.5f}" for k in (
                  "tokens_per_s", "mean_ttft_s", "ttft_p95_s", "mean_tpot_s",
                  "trace_decode_step_s"))
              + f" build_s={r['build_s']:.3f} plain_build_s={plain[run]['build_s']:.3f} "
              f"peak_memory_gib={r['peak_gib']:.3f} "
              f"plain_peak_memory_gib={plain[run]['peak_gib']:.3f} "
              f"divergences={json.dumps([[u, t, round(m, 4), round(b, 4)] for u, t, m, b in divs])}")
        check(all(m < b for _, _, m, b in divs),
              f"spec ({label}): a stream parts from the plain one away from a near-tie")
        if spec.get("spec_draft_bits") == 0:
            check(st["spec_acceptance"] >= 0.9,
                  f"spec ({label}): acceptance {st['spec_acceptance']} with the serving params")
        if name.endswith("eager"):
            run_graphs(torch, cfg, params, run, r, kv_len, long_prompts, draft=dm, **paths)
            profile_spec(torch, cfg, params, run, kv_len, draft=dm, **paths)


def run_slo(torch, cfg, params, plain, kv_len):
    """The SLO plane on the real clock: ``SLO_REQUESTS`` requests of
    ``make_workload`` (prompts of 4..384 tokens, half of them in a high
    class), Poisson arrivals at ``SLO_OVERLOAD`` times the request rate the
    plain replayed drain (``plain``) sustained, offered open-loop through
    ``ServingFrontend.play`` to an engine with ``SloScheduler`` (two classes
    with TTFT and TPOT targets), a deadline of ``SLO_DEADLINE_BUDGETS``
    times a budget's plain decode time and a queue bounded at
    ``SLO_MAX_QUEUE``.  Every request ends finished, expired or shed; each
    finished one has its budget; every stream delivered its request's
    tokens in order; some requests expired and some were shed."""
    from repro_torch.serving.engine import DONE, EngineConfig, ServingEngine
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.scheduler import SloClass, SloScheduler
    from repro_torch.serving.workload import make_workload
    ps = plain["stats"]
    rate = SLO_OVERLOAD * ps["finished"] / plain["wall_s"]
    tpot_ms = ps["mean_tpot_s"] * 1e3
    deadline_ms = SLO_DEADLINE_BUDGETS * NEW_TOKENS * tpot_ms
    classes = {1: SloClass(ttft_ms=deadline_ms / 4, tpot_ms=2 * tpot_ms),
               0: SloClass(ttft_ms=deadline_ms, tpot_ms=4 * tpot_ms)}
    wl = make_workload(SLO_REQUESTS, rate, seed=0, hi_fraction=0.5, min_len=4, max_len=384,
                       vocab=cfg.vocab_size, max_new_tokens=NEW_TOKENS)
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK, max_new_tokens=NEW_TOKENS,
        impl="flash", deadline_ms=deadline_ms, max_queue=SLO_MAX_QUEUE),
        device=DEVICE, scheduler=SloScheduler(classes))
    front = ServingFrontend(engine)
    t0 = time.perf_counter()
    streams = front.play(wl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats()
    n_fin, n_dl, n_rej = st["finished"], st["failed_deadline"], st["rejected"]
    ttft = {}
    for p in (1, 0):
        xs = [s.request.t_first_token - s.request.t_enqueue for s in streams
              if s.status == DONE and s.request.priority == p]
        ttft[p] = (len(xs), *(np.percentile(xs, (50, 95)) if xs else (float("nan"),) * 2))
    print(f"slo arch={cfg.name} requests={len(wl)} rate_rps={rate:.3f} "
          f"plain_rate_rps={rate / SLO_OVERLOAD:.3f} deadline_ms={deadline_ms:.1f} "
          f"max_queue={SLO_MAX_QUEUE} finished={n_fin} failed_deadline={n_dl} rejected={n_rej} "
          f"wall_s={wall:.3f} tokens_per_s={st.get('tokens_per_s', 0.0):.2f} "
          + " ".join(f"class{p}_finished={n} class{p}_ttft_p50_s={a:.4f} "
                     f"class{p}_ttft_p95_s={b:.4f}" for p, (n, a, b) in ttft.items()))
    check(len(streams) == SLO_REQUESTS and n_fin + n_dl + n_rej == SLO_REQUESTS
          and st["failed"] == n_dl, f"slo: {n_fin} + {n_dl} + {n_rej} of {SLO_REQUESTS}")
    check(all(len(s.tokens) == NEW_TOKENS for s in streams if s.status == DONE),
          "slo: a finished request lacks tokens of its budget")
    check(all(s.tokens == s.request.output for s in streams),
          "slo: a stream did not deliver its request's tokens in order")
    check(n_fin > 0 and n_dl > 0 and n_rej > 0,
          f"slo: finished {n_fin}, expired {n_dl}, shed {n_rej}: each must be above 0")


# ---------------------------------------------------------------------------
# crash safety
# ---------------------------------------------------------------------------

def crash_kind(engine, steps):
    """Where a kill after ``steps`` engine steps lands (the reference's
    chaos harness, ``benchmarks/perf_recovery.py``): before any step, with
    a prompt between two chunks, or with requests decoding."""
    if steps == 0:
        return "post_admission"
    if engine.pool.prefilling:
        return "mid_prefill"
    if any(r is not None for r in engine.pool.slot_req):
        return "mid_decode"
    return "drained"


def crash_workload(cfg, long_prompts=()):
    """The engine phase's 16 requests (and ``long_prompts``), and one more
    that is submitted after the snapshot: the journal's only copy."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in rng.integers(4, 385, N_REQUESTS)]
    prompts += [rng.integers(0, cfg.vocab_size, size=n) for n in long_prompts]
    return prompts, np.random.default_rng(1).integers(0, cfg.vocab_size, size=50)


def crash_ecfg(run, kv_len, **paths):
    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(**dict(dict(max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK,
                                    max_new_tokens=NEW_TOKENS, impl="flash"),
                               **QUANT_RUNS[run], **paths))


def crash_dir(name):
    """A fresh snapshot directory under the checkout's ``build/`` (ignored
    by git), with the free space of its file system."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "crash")
    path = os.path.join(root, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path, shutil.disk_usage(path).free / 1e9


def collect(torch):
    """Give back the memory of engines the caller dropped (their graphs'
    memory pools among it)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def crash_outputs(engine, n):
    """{uid: tokens} of a drained engine: every request finished once, with
    its whole budget, and none failed or shed."""
    out = {}
    for r in engine.finished:
        check(r.uid not in out, f"crash: request {r.uid} finished twice")
        out[r.uid] = list(r.output)
    check(not engine.failed and not engine.rejected and sorted(out) == list(range(n)),
          f"crash: finished {sorted(out)} of {n}, failed {len(engine.failed)}")
    check(all(len(o) == NEW_TOKENS for o in out.values()),
          "crash: a request finished without its budget")
    return out


def uninterrupted(torch, cfg, params, ecfg, prompts, extra, until, draft=None, mesh=None):
    """The run a crash must reproduce: the requests submitted at once, steps
    until ``until(engine, steps)`` first holds (the kill point), the extra
    request submitted there, then a drain.  Returns (the streams, the
    number of steps to the kill point)."""
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine(cfg, params, ecfg, device=DEVICE, draft=draft, mesh=mesh)
    for p in prompts:
        engine.submit(p)
    steps = 0
    while not until(engine, steps):
        check(engine.queue or engine.pool.occupied(), "crash: the kill point never came")
        engine.step()
        steps += 1
    engine.submit(extra)
    engine.run_until_drained()
    out = crash_outputs(engine, len(prompts) + 1)
    del engine
    collect(torch)
    return out, steps


def crash_first_half(cfg, params, ecfg, prompts, extra, kill_at, ckpt_dir, draft=None,
                     mesh=None):
    """The run that crashes: requests through an ``EngineCheckpointer``,
    ``kill_at`` steps, a snapshot, the extra request (journal only), two
    steps the crash throws away.  Returns the engine (for the caller to
    drop), the snapshot's save split and the kind of the kill point."""
    from repro_torch.serving.checkpoint import EngineCheckpointer
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine(cfg, params, ecfg, device=DEVICE, draft=draft, mesh=mesh)
    ck = EngineCheckpointer(engine, ckpt_dir)
    for p in prompts:
        ck.submit(p)
    for _ in range(kill_at):
        engine.step()
    kind = crash_kind(engine, kill_at)
    t0 = time.perf_counter()
    ck.save()
    save_s = dict(engine.save_s, save_s=time.perf_counter() - t0)
    ck.submit(extra)
    for _ in range(2):
        engine.step()
    return engine, save_s, kind


def crash_restore(torch, cfg, params, ckpt_dir, want, draft=None, mesh=None):
    """A fresh engine from the newest snapshot (its own graphs captured at
    build), drained: its streams must be ``want`` bit for bit, with one
    restore and one replayed request.  Returns the restore's split."""
    from repro_torch.serving.engine import ServingEngine
    t0 = time.perf_counter()
    engine = ServingEngine.restore(cfg, params, ckpt_dir, device=DEVICE, draft=draft,
                                   mesh=mesh)
    restore_s = dict(engine.restore_s, restore_s=time.perf_counter() - t0)
    check((engine.executor.graphs is None) == (not engine.ecfg.fused),
          "crash: the restored engine's programs were not captured")
    engine.run_until_drained()
    got = crash_outputs(engine, len(want))
    st = engine.stats()
    same = got == want
    parted = sum(got[u] != want[u] for u in want)
    del engine
    collect(torch)
    check(st["restores"] == 1 and st["replayed_requests"] == 1 and st["checkpoints_written"] == 1,
          f"crash: restores {st['restores']}, replayed {st['replayed_requests']}, "
          f"snapshots {st['checkpoints_written']}")
    return restore_s, same, parted


def print_crash(cfg, label, kind, kill_at, ckpt_dir, free_gb, save_s, restore_s, same, parted,
                case_s):
    snap = os.path.join(ckpt_dir, sorted(d for d in os.listdir(ckpt_dir)
                                         if d.startswith("snap_"))[-1])
    nbytes = sum(os.path.getsize(os.path.join(snap, f)) for f in os.listdir(snap))
    print(f"crash arch={cfg.name} run={label} kind={kind} kill_at={kill_at} "
          f"streams_identical={same} streams_parted={parted} snapshot_bytes={nbytes} "
          f"free_gb_before={free_gb:.1f} case_s={case_s:.1f} "
          + " ".join(f"{k}={v:.4f}" for k, v in {**save_s, **restore_s}.items()))
    check(same, f"crash ({cfg.name} {label} {kind}): {parted} resumed streams part from "
          f"the uninterrupted run's")


def crash_case(torch, cfg, params, run, kv_len, kind, until=None, draft=None, long_prompts=(),
               mesh=None, **paths):
    """One kill and restore of ``kind`` (the first step where it holds, or
    where ``until`` does) against the uninterrupted run with the same
    requests submitted at the same steps."""
    t0 = time.perf_counter()
    label = run + "".join(f" {k}={v}" for k, v in paths.items())
    ecfg = crash_ecfg(run, kv_len, **paths)
    prompts, extra = crash_workload(cfg, long_prompts)
    until = until or (lambda e, s: crash_kind(e, s) == kind)
    want, kill_at = uninterrupted(torch, cfg, params, ecfg, prompts, extra, until, draft, mesh)
    ckpt_dir, free_gb = crash_dir(f"{cfg.name}-{kind}")
    engine, save_s, seen = crash_first_half(cfg, params, ecfg, prompts, extra, kill_at,
                                            ckpt_dir, draft, mesh)
    check(seen == kind, f"crash ({label}): the kill at step {kill_at} is {seen}, not {kind}")
    held = local_positions(cfg, engine.pool.cache) if "local" in cfg.pattern else None
    del engine                                 # the crash
    collect(torch)
    restore_s, same, parted = crash_restore(torch, cfg, params, ckpt_dir, want, draft, mesh)
    label += " mesh" if mesh is not None else ""
    print_crash(cfg, label, kind, kill_at, ckpt_dir, free_gb, save_s, restore_s, same, parted,
                time.perf_counter() - t0)
    shutil.rmtree(ckpt_dir)
    return held


def crash_config(cfg):
    """The config phase crash runs: qwen2.5-3b cut to ``CRASH_QWEN_LAYERS``
    (a restore's bit-exactness does not depend on depth; its eleven cases
    at 36 layers took 150 s of the script), another as it is."""
    if cfg.name == "qwen2.5-3b":
        return dataclasses.replace(cfg, n_layers=CRASH_QWEN_LAYERS)
    return cfg


def crash_child(ckpt_dir, kill_at):
    """``chip_smoke.py --crash-child DIR STEPS``: the first half of a crash
    in a process of its own (qwen2.5-3b fp at temperature 0.8, the weights
    made from the same seed), which waits to be killed."""
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.config import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = crash_config(get_config("qwen2.5-3b"))
    params = make_params(torch, cfg)
    prompts, extra = crash_workload(cfg)
    engine, save_s, kind = crash_first_half(
        cfg, params, crash_ecfg("fp", SERVED[cfg.name]["kv_len"], temperature=0.8),
        prompts, extra, kill_at, ckpt_dir)
    torch.cuda.synchronize()
    print(f"crash-child ready kind={kind} " + json.dumps(save_s), flush=True)
    time.sleep(600)
    return 1


def crash_sigkill(torch, cfg, params, kv_len):
    """The first half of a crash in a child process, SIGKILLed once it has
    saved, submitted the journal-only request and stepped on; the parent
    restores and drains."""
    t0 = time.perf_counter()
    ecfg = crash_ecfg("fp", kv_len, temperature=0.8)
    prompts, extra = crash_workload(cfg)
    want, kill_at = uninterrupted(torch, cfg, params, ecfg, prompts, extra,
                                  lambda e, s: crash_kind(e, s) == "mid_decode")
    ckpt_dir, free_gb = crash_dir(f"{cfg.name}-sigkill")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--crash-child",
                             ckpt_dir, str(kill_at)], stdout=subprocess.PIPE, text=True)
    try:
        ready = ""
        for line in proc.stdout:
            print(f"  child: {line.rstrip()}")
            if line.startswith("crash-child ready"):
                ready = line
                break
        check(ready, "crash: the child exited before it was ready")
        proc.send_signal(signal.SIGKILL)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == -signal.SIGKILL, f"crash: the child ended with {rc}, not SIGKILL")
    kind = ready.split("kind=")[1].split()[0]
    save_s = json.loads(ready.split(" ", 3)[3])
    restore_s, same, parted = crash_restore(torch, cfg, params, ckpt_dir, want)
    print_crash(cfg, "fp temperature=0.8 sigkill", kind, kill_at, ckpt_dir, free_gb, save_s,
                restore_s, same, parted, time.perf_counter() - t0)
    shutil.rmtree(ckpt_dir)


def crash_cost(torch, cfg, params, kv_len):
    """What periodic snapshots cost a user: tokens/s of one front-end drain
    of the 16 requests with ``EngineCheckpointer(every=16)`` beside the same
    drain without one (a reading, not a gate)."""
    from repro_torch.serving.checkpoint import EngineCheckpointer
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.frontend import ServingFrontend
    prompts, _ = crash_workload(cfg)
    out = {}
    for every in (0, 16):
        engine = ServingEngine(cfg, params, crash_ecfg("fp", kv_len), device=DEVICE)
        ckpt_dir, _ = crash_dir(f"{cfg.name}-every{every}")
        ck = EngineCheckpointer(engine, ckpt_dir, every=every, keep=1) if every else None
        front = ServingFrontend(engine, checkpointer=ck)
        t0 = time.perf_counter()
        for p in prompts:
            front.submit(p)
        front.drain()
        torch.cuda.synchronize()
        st = engine.stats()
        out[every] = (st["tokens_per_s"], time.perf_counter() - t0, st["checkpoints_written"],
                      st["decode_steps"])
        del engine, front, ck
        collect(torch)
        shutil.rmtree(ckpt_dir)
    (tps0, wall0, _, steps), (tps1, wall1, n, _) = out[0], out[16]
    print(f"crash arch={cfg.name} frontend_every=16 tokens_per_s={tps1:.2f} wall_s={wall1:.3f} "
          f"snapshots={n} plain_tokens_per_s={tps0:.2f} plain_wall_s={wall0:.3f} "
          f"decode_steps={steps} ratio={tps1 / tps0:.4f}")
    check(n > 0, "crash: the front end's checkpointer wrote no snapshot")


def run_crash(torch, cfg, params, kv_len, long_prompts=()):
    """Phase ``crash``: kill and restore between two steps at full width,
    each resumed drain against the uninterrupted run bit for bit.  On
    qwen2.5-3b: fp greedy and at temperature 0.8 at each kill kind,
    w8kv8 at 0.8, an 8-bit self-draft at 0.8 and the draft model
    (``spec_k`` 4), ``fused=False``, a child process SIGKILLed after its
    snapshot, and the cost of ``every=16`` snapshots to a front end; on
    gemma2-9b, w4kv4 with the 4600-token prompt killed mid-decode after
    its rings wrapped, on a pool of ``CRASH_LONG_BATCH`` slots."""
    drain = dict(kv_len=kv_len, long_prompts=long_prompts)
    if cfg.name != "qwen2.5-3b":
        long_uid = N_REQUESTS                      # the first long prompt's request

        def wrapped(engine, steps):
            req = next((r for r in engine.pool.slot_req if r and r.uid == long_uid), None)
            return crash_kind(engine, steps) == "mid_decode" and req is not None \
                and len(req.output) > 1
        held = crash_case(torch, cfg, params, "w4kv4", kind="mid_decode", until=wrapped,
                          max_batch=CRASH_LONG_BATCH, **drain)
        print(f"crash arch={cfg.name} largest_position_held={held}")
        check(held >= min(cfg.window, kv_len), "crash: no local ring wrapped before the kill")
        return
    for temperature in (0.0, 0.8):
        for kind in ("post_admission", "mid_prefill", "mid_decode"):
            crash_case(torch, cfg, params, "fp", kind=kind, temperature=temperature, **drain)
    crash_case(torch, cfg, params, "w8kv8", kind="mid_decode", temperature=0.8, **drain)
    crash_case(torch, cfg, params, "fp", kind="mid_decode", temperature=0.8, spec_k=SPEC_K,
               spec_draft_bits=8, **drain)
    crash_case(torch, cfg, params, "fp", kind="mid_decode", draft=draft_model(torch, cfg),
               spec_k=SPEC_K, spec_draft="model", **drain)
    crash_case(torch, cfg, params, "fp", kind="mid_decode", fused=False, **drain)
    crash_sigkill(torch, cfg, params, kv_len)
    crash_cost(torch, cfg, params, kv_len)


def run_crossbar(torch):
    """The PIM-MVM entry point as ``examples/quickstart.py`` and
    ``benchmarks/kernel_micro.py`` drive it: program the crossbars
    (``quantize_weights``), then ``pim_mvm``, with f32 x (kernel_micro's)
    and bf16 x; checked against the oracle and against the fp product
    (quantisation error, as kernel_micro reports it)."""
    from repro_torch.kernels.pim_mvm.ops import pim_mvm, quantize_weights
    g = torch.Generator(device=DEVICE).manual_seed(5)
    shapes = [(256, 1024, 512), (512, 2048, 1024)]
    dtypes = (torch.float32, torch.bfloat16)
    inputs = []
    for M, K, N in shapes:
        x = torch.randn((M, K), generator=g, device=DEVICE)
        w = torch.randn((K, N), generator=g, device=DEVICE) / K ** 0.5
        inputs += [((M, K, N), x.to(dt), w, *quantize_weights(w)) for dt in dtypes]
    torch.cuda.synchronize()
    reset_launches()
    outs = [pim_mvm(x, wq, sc) for _, x, _, wq, sc in inputs]
    torch.cuda.synchronize()
    launches, (kernels, designs) = read_launches(), read_kernels()
    for ((M, K, N), x, w, wq, sc), out in zip(inputs, outs):
        ref = pim_mvm(x, wq, sc, impl="ref").float()
        fp = x.float() @ w
        err = float((out.float() - ref).abs().max() / ref.abs().max())
        rel = float((out.float() - fp).abs().max() / fp.abs().max())
        print(f"crossbar shape={M}x{K}x{N} dtype={x.dtype} rel_err_vs_oracle={err:.3e} "
              f"rel_err_vs_fp={rel:.3e}")
        check(np.isfinite(err) and err <= MATMUL_TOL[str(x.dtype)] and rel < 3e-2,
              f"pim_mvm {M}x{K}x{N} {x.dtype} disagrees (oracle {err:.3e}, fp {rel:.3e})")
    print(f"crossbar launches={json.dumps(launches)} qmatmul_designs={json.dumps(designs)}")
    check(launches["pim_mvm"] == len(inputs) and
          sum(launches.values()) == launches["pim_mvm"],
          f"crossbar launches {launches}")
    check(designs == {"cuda_core": len(shapes), "tensor_core": len(shapes)},
          f"crossbar: f32 x on CUDA cores, bf16 x on tensor cores; saw {designs}")
    check_kernels_checked("crossbar", kernels)
    return launches


def profiled(torch, arch, run, what, step, steps):
    """``steps`` calls of ``step`` timed on the host clock (to a
    synchronise), then torch.profiler over as many: device busy time (the
    sum of kernel times) a call, the share of the wall time the card was
    idle, kernels launched a call and the largest kernels.  The profiler
    slows the host, so its own wall time is not the engine's; it records
    the card's activity only (the host's thousands of operator events a
    step cost seconds to gather and are not read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    check(busy_ms > 0, f"profile ({arch} {run} {what}): the profiler recorded no device time")
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile arch={arch} run={run} {what} wall_ms={step_ms:.3f} busy_ms={busy_ms:.3f} "
          f"idle_share={1 - busy_ms / step_ms:.3f} wall_ms_profiled={wall_ms:.3f} "
          f"kernels_per_step={launches:.0f} top=" + json.dumps(
              [[e.key[:60], round(e.self_device_time_total / 1e3 / steps, 4), e.count // steps]
               for e in top]))
    return {"busy_ms": busy_ms, "kernels_per_step": launches, "wall_ms": step_ms,
            "wall_ms_profiled": wall_ms,
            "by_kernel_ms": {e.key: e.self_device_time_total / 1e3 / steps for e in kernels}}


def run_profile(torch, cfg, params, run="fp", kv_len=1024, steps=4, chunk_steps=2, mesh=None):
    """Where a step's time goes, with every slot of the pool busy: ``steps``
    fused decode steps, then (where the stack packs) ``chunk_steps``
    chunked-prefill steps (the
    executor's ``chunk_step``, as the engine calls it for long prompts:
    all 8 rows with a 128-token chunk, M = 1024 rows a projection; none at
    ``chunk_steps=0``); each
    replayed from its CUDA graph, as the engine runs it, and then through
    the eager method (the decode step with its fetch, as ``step`` does).
    ``mesh``: the engine sharded over it."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=MAX_BATCH, kv_len=kv_len, prefill_chunk=CHUNK,
        max_new_tokens=4 * steps + 8, impl="flash", **QUANT_RUNS[run]), device=DEVICE,
        mesh=mesh)
    run += " mesh" if mesh is not None else ""
    rng = np.random.default_rng(2)
    for _ in range(MAX_BATCH):        # 8 x 16 tokens: one packed stream
        engine.submit(rng.integers(0, cfg.vocab_size, size=16))
    engine.step()                     # admission (one packed prefill) + a step
    engine.step()
    check(len(engine.pool.decoding()) == MAX_BATCH, "profile: pool not full")
    ex, pool = engine.executor, engine.pool
    decode = profiled(torch, cfg.name, run, "decode_step replayed", engine.step, steps)
    decode_eager = profiled(torch, cfg.name, run, "decode_step eager", lambda: ex.fetch(
        ex.fused_step(pool.cache, pool.state)[2]), steps)
    if not engine._packable or not chunk_steps:
        # no chunk step: a stack that cannot be packed prefills a prompt a call
        return {"decode_step": decode, "decode_step_eager": decode_eager}

    # chunk steps over the same pool: each row's next 128 tokens at
    # positions 32..159, no row final (the slots' state is left as it is)
    B, C = MAX_BATCH, engine._chunk
    host = (rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32),
            np.broadcast_to(32 + np.arange(C, dtype=np.int32), (B, C)).copy(),
            np.full((B,), C - 1, np.int32), np.zeros((B,), bool), np.ones((B,), np.int32))
    args = [torch.from_numpy(a).to(DEVICE) for a in host]
    chunk = profiled(torch, cfg.name, run, "chunk_step replayed",
                     lambda: ex.run("chunk_step", pool, *host), chunk_steps)
    chunk_eager = profiled(torch, cfg.name, run, "chunk_step eager",
                           lambda: ex.chunk_step(pool.cache, pool.state, *args), chunk_steps)
    return {"decode_step": decode, "decode_step_eager": decode_eager,
            "chunk_step": chunk, "chunk_step_eager": chunk_eager}


class ForcedRouting:
    """The MoE layers' expert choices recorded in one run (``"record"``)
    and imposed, call by call, on the next (``"force"``), whose gates are
    its own router's probabilities at the imposed experts, renormalised.
    A top-k choice is discontinuous: where two experts' router logits are
    near a tie, a last-bit difference between two runs swaps them and the
    runs part by a whole expert's output, which grows over the layers.
    Imposing one run's choices on the other leaves the numerics of the
    kernels to compare.  Every choice the forced run's own router makes
    otherwise is counted, with the gap between its own logits of the
    experts it would have taken and those imposed, relative to the
    token's largest router logit (at least 1): each must be a near-tie."""

    def __init__(self):
        self.mode, self.recorded, self.queue, self.at = "off", [], [], 0
        self.tokens = self.swapped = 0
        self.gaps = []

    @contextlib.contextmanager
    def installed(self, torch):
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.models import moe
        from repro_torch.parallel.api import full, is_dtensor
        route = moe.route

        def routed(p, x, cfg):
            gates, idx = route(p, x, cfg)
            if self.mode == "record":
                self.recorded.append(full(idx).clone())
            elif self.mode == "force":
                forced = self.queue[self.at]
                self.at += 1
                whole = full(idx)
                if forced.shape[1] < idx.shape[1]:
                    # a padded prompt's pad rows keep their own choices
                    forced = torch.cat([forced, whole[:, forced.shape[1]:]], dim=1)
                if is_dtensor(idx):
                    # under a plan the choices are placed as the router's own
                    forced = distribute_tensor(forced, idx.device_mesh, idx.placements,
                                               src_data_rank=None)
                logits = x.float() @ p["router"].float()
                probs = torch.softmax(logits, dim=-1)
                g = torch.gather(probs, -1, forced)
                gates = (g / g.sum(dim=-1, keepdim=True)).to(x.dtype)
                # the count of choices and gaps is taken on whole tensors
                logits, probs, imposed = (full(t) for t in (logits, probs, forced))
                own = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, whole, True)
                want = torch.zeros_like(own).scatter_(-1, imposed, True)
                differ = (own != want).any(dim=-1)
                inf = torch.tensor(float("inf"), device=x.device)
                gap = torch.where(own & ~want, logits, inf).amin(-1) - \
                    torch.where(want & ~own, logits, -inf).amax(-1)
                scale = logits.abs().amax(-1).clamp_min(1.0)
                self.tokens += differ.numel()
                self.swapped += int(differ.sum())
                self.gaps += (gap / scale)[differ].tolist()
                idx = forced
            return gates, idx
        moe.route = routed
        try:
            yield self
        finally:
            moe.route = route


def run_logits(torch, cfg, params, run="fp", long_row=0, routing=None):
    """Packed prefill + 4 teacher-forced decode steps at full width,
    impl="flash" against impl="ref", each on its own slot pool.  Quantised
    (``QUANT_RUNS``), "ref" is the attention oracle over the pool
    dequantised to bf16 plus the reference's dequantise-then-matmul, whose
    weights are rounded to bf16; the kernels keep them in f32.  A
    ``long_row`` of that many prompt tokens joins the three short ones in
    the packed stream: past a local window, its prefill is windowed, its
    ring wraps in the packed insert, and the decode steps read it wrapped.
    The sequential baseline's first-token logits (a batch-1 prefill of each
    row, padded as the engine pads it) are held to the packed prefill's
    under the same bound.  ``routing`` (a :class:`ForcedRouting`, for MoE
    stacks): "ref" runs first and its expert choices are imposed on
    "flash", each choice its router would make otherwise counted and held
    to be a near-tie (``NEAR_TIE`` of the router logits' scale); each
    sequential prefill takes its row's choices of the recorded packed
    prefill."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig, _bucket_len
    from repro_torch.serving.executor import Executor
    from repro_torch.serving.pool import SlotPool

    rng = np.random.default_rng(1)
    lens = (30, 61, 17) + ((long_row,) if long_row else ())
    B, C = 4, -(-sum(lens) // CHUNK) * CHUNK
    kv_len = max(256, -(-(max(lens) + 8) // 256) * 256)
    toks = np.zeros((1, C), np.int32)
    seg = np.full((1, C), -1, np.int32)
    pos = np.zeros((1, C), np.int32)
    gather = np.zeros((B,), np.int32)
    seg_len = np.zeros((B,), np.int32)
    off = 0
    for i, n in enumerate(lens):
        toks[0, off:off + n] = rng.integers(0, cfg.vocab_size, n)
        seg[0, off:off + n], pos[0, off:off + n] = i, np.arange(n)
        gather[i], seg_len[i] = off + n - 1, n
        off += n
    active = np.arange(B) < len(lens)
    steps = rng.integers(0, cfg.vocab_size, (4, B)).astype(np.int32)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(DEVICE)  # noqa: E731

    results = {}
    for impl in ("ref", "flash") if routing else ("flash", "ref"):
        if routing and impl == "ref":
            routing.mode, routing.recorded = "record", []
        elif routing:
            routing.mode, routing.queue, routing.at = "force", routing.recorded, 0
        ecfg = EngineConfig(max_batch=B, kv_len=kv_len, impl=impl, **QUANT_RUNS[run])
        ex = Executor(cfg, params, ecfg, device=torch.device(DEVICE))
        pool = SlotPool(cfg, ecfg, device=torch.device(DEVICE))
        with torch.no_grad():
            logits, pc = T.prefill_packed(ex.params, cfg, dev(toks), dev(pos), dev(seg),
                                          dev(gather), impl=impl, kv_bits=ecfg.kv_bits)
            if impl == "flash":
                # the sequential baseline's first-token logits of each row:
                # a batch-1 prefill padded as the engine pads it
                bucketed = all(k == "global" for k in cfg.layer_kinds)
                seq = []
                for i, n in enumerate(lens):
                    a = gather[i] - n + 1
                    row = np.zeros((1, _bucket_len(n, kv_len) if bucketed else n), np.int32)
                    row[0, :n] = toks[0, a:a + n]
                    if routing:
                        # the row's choices in the recorded packed prefill
                        queue, at = routing.queue, routing.at
                        routing.queue = [r[:, a:a + n] for r in
                                         routing.recorded[:sum(cfg.moe_layer_mask())]]
                        routing.at = 0
                    seq.append(ex.prefill(dev(row), n)[0].float())
                    if routing:
                        routing.queue, routing.at = queue, at
                sequential = torch.cat(seq)
            ex.packed_insert(pool.cache, pc["stack"], dev(seg), dev(pos),
                              dev(seg_len), dev(active))
            del pc
            if long_row and "local" in cfg.pattern:
                held = local_positions(cfg, pool.cache)
                check(held >= cfg.window, f"logits ({run}): the local ring did not wrap")
            out = [logits.float()]
            for s in range(4):
                p = np.where(active, seg_len + s, -1).astype(np.int32)
                logits, _ = T.decode_step(ex.params, cfg, pool.cache, dev(steps[s]),
                                          dev(p), impl=impl)
                out.append(logits.float()[: len(lens)])
        del ex, pool
        results[impl] = out
    names = ["prefill"] + [f"decode{s}" for s in range(4)]
    scale = max(float(r.abs().max()) for r in results["ref"])
    # bound: the oracle rounds its probabilities to bf16 before the value
    # product and the kernels do not; over 36-42 bf16 layers of random
    # weights that difference may grow to a few bf16 ulps of the logits' scale
    limit = 5e-2 * max(1.0, scale)
    diffs = {n: float((a - b).abs().max()) for n, a, b in
             zip(names, results["flash"], results["ref"])}
    # sequential against packed, both through the kernels
    diffs["sequential_prefill"] = float((sequential - results["flash"][0][:len(lens)]).abs().max())
    finite = all(bool(torch.isfinite(r).all()) for r in results["flash"])
    print(f"logits run={run} arch={cfg.name} layers={cfg.n_layers} rows={list(lens)} "
          f"stream={C} kv_len={kv_len} max_abs_diff={json.dumps(diffs)} "
          f"bound={limit:.4f} ref_scale={scale:.4f} finite={finite}")
    check(finite and max(diffs.values()) <= limit,
          f"flash and ref logits ({run}) disagree beyond the bound")
    if routing:
        gap = max(routing.gaps, default=0.0)
        print(f"logits run={run} arch={cfg.name} forced_routing tokens={routing.tokens} "
              f"own_choice_differs={routing.swapped} largest_gap={gap:.4f} "
              f"near_tie={NEAR_TIE}")
        check(routing.at == len(routing.queue) and routing.tokens > 0,
              f"logits ({run}): {routing.at} forced calls of {len(routing.queue)} recorded")
        check(gap <= NEAR_TIE, f"logits ({run}): the flash router would choose other "
              f"experts {gap:.4f} of its logits' scale apart, not a near-tie")
    return diffs, limit


def run_paper(torch, by_run):
    """Phase paper: the paper's Table 3 models at full width and depth
    (``PAPER_LAYERS`` cut two), random bf16 weights (seed 0), each freed
    before the next, serving the engine phase's 16 requests (``kv_len``
    1024): each run replayed from its graphs and again eagerly (streams
    bit for bit, launches equal, as
    ``expected_launches`` reckons them, every kernel one that phase 3
    held), its decode step profiled; flash against ref logits; Plane B's
    ``cosim_from_engine`` after the drains ``PAPER_COSIM`` names, and the
    Table-4 anchors."""
    from repro_torch.config import get_config
    for arch in PAPER_MODELS:
        cfg = get_config(arch)
        if arch in PAPER_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=PAPER_LAYERS[arch])
        params = make_params(torch, cfg)
        for run in PAPER_RUNS.get(arch, ("fp",)):
            after = functools.partial(paper_cosim, cfg, run) \
                if (arch, run) in PAPER_COSIM else None
            r = run_engine(torch, cfg, params, run, kv_len=PAPER_KV_LEN, after=after)
            by_run[f"{arch} {run}"] = r["launches"]
            e = run_graphs(torch, cfg, params, run, r, kv_len=PAPER_KV_LEN, long_prompts=())
            d = run_profile(torch, cfg, params, run, kv_len=PAPER_KV_LEN,
                            chunk_steps=0)["decode_step"]
            st = r["stats"]
            print(f"paper arch={arch} run={run} layers={cfg.n_layers} d_model={cfg.d_model} "
                  f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
                  f"tokens_per_s={st['tokens_per_s']:.2f} "
                  f"tokens_per_s_eager={e['stats']['tokens_per_s']:.2f} "
                  f"mean_ttft_s={st['mean_ttft_s']:.4f} ttft_p95_s={st['ttft_p95_s']:.4f} "
                  f"mean_tpot_s={st['mean_tpot_s']:.5f} "
                  f"decode_step_wall_ms={st['trace_decode_step_s'] * 1e3:.3f} "
                  f"profiled_decode_step_wall_ms={d['wall_ms']:.3f} "
                  f"busy_ms={d['busy_ms']:.3f} idle_share={1 - d['busy_ms'] / d['wall_ms']:.3f} "
                  f"kernels_per_step={d['kernels_per_step']:.0f} "
                  f"peak_memory_gib={r['peak_gib']:.2f} "
                  f"params_gib={r['params_gb'] * 1e9 / 2**30:.3f} "
                  f"pool_gib={r['pool_gb'] * 1e9 / 2**30:.4f}")
        for run in PAPER_LOGITS.get(arch, ()):
            run_logits(torch, cfg, params, run)
        del params
        gc.collect()
    paper_anchors()
    torch.cuda.empty_cache()


def paper_cosim(cfg, run, engine):
    """Plane B on the card's host: ``cosim_from_engine`` of a drained
    engine on the config it served (its depth as cut, so that Plane B's
    step and the measured one are of one model) and the same mix
    single-streamed, turned into ``benchmarks/perf_cosim.py``'s
    per-architecture rows; every key there and every value finite, printed
    beside the engine's measured step time."""
    from repro_torch.core.cosim import ARCHS, cosim_from_engine, cosim_mix, mix_from_stats
    t0 = time.perf_counter()
    rec = cosim_from_engine(engine, cfg=cfg, n_chiplets=PAPER_CHIPLETS)
    single = cosim_mix(cfg, mix_from_stats(engine.stats()), PAPER_CHIPLETS, batch=1)
    mix = rec["mix"]
    rows = {}
    for arch in ARCHS:
        g, g1 = rec["archs"][arch], single[arch]
        tok_s = g["batch"] / max(g["decode_step_s"], 1e-30)
        rows[arch] = {
            "ttft_ms": g["ttft_s"] * 1e3, "decode_step_ms": g["decode_step_s"] * 1e3,
            "decode_tok_s": tok_s, "tokens_per_s": g["tokens_per_s"],
            "energy_per_token_mj": g["energy_per_token_j"] * 1e3,
            "prefill_gb": g["prefill_bytes"] / 2**30, "decode_gb": g["decode_bytes"] / 2**30,
            "decode_traffic_frac": g["decode_traffic_frac"], "batch": g["batch"],
            "batch_uplift": tok_s / max(g1["batch"] / max(g1["decode_step_s"], 1e-30), 1e-30)}
        check(set(rows[arch]) == COSIM_ARCH_KEYS,
              f"cosim ({cfg.name} {run}): keys {sorted(rows[arch])}")
        check(all(np.isfinite(v) for v in rows[arch].values()),
              f"cosim ({cfg.name} {run} {arch}): a value is not finite: {rows[arch]}")
    check(mix["requests"] == engine.stats()["finished"] and mix["measured_step_s"] > 0,
          f"cosim ({cfg.name} {run}): mix {mix}")
    print(f"paper cosim arch={cfg.name} layers={cfg.n_layers} run={run} "
          f"chiplets={PAPER_CHIPLETS} "
          f"requests={mix['requests']} prefill_tokens={mix['prefill_tokens']} "
          f"decode_tokens={mix['decode_tokens']} effective_batch={mix['effective_batch']} "
          f"weight_bits={mix['weight_bits']} kv_bits={mix['kv_bits']} "
          f"h100_decode_step_ms={mix['measured_step_s'] * 1e3:.3f} "
          f"h100_tokens_per_s={engine.stats()['tokens_per_s']:.2f} "
          f"seconds={time.perf_counter() - t0:.2f} "
          + " ".join(f"{a}:" + json.dumps({k: round(float(rows[a][k]), 4) for k in (
              "ttft_ms", "decode_step_ms", "tokens_per_s", "energy_per_token_mj")})
              for a in ARCHS))
    print(f"paper cosim_rows arch={cfg.name} run={run} " + json.dumps(rows))


def paper_anchors():
    """The Table-4 anchors through Plane B: ``simulate_2p5d_hi`` and the two
    baselines on bert-base and gpt-j at 64 tokens, on the simulator's
    chiplet counts, each beside its paper target and held to the bound
    the reference's tests hold it to."""
    from repro_torch.config import get_config
    from repro_torch.core.baselines import simulate_haima_chiplet, simulate_transpim_chiplet
    from repro_torch.core.simulator import ANCHORS, simulate_2p5d_hi
    from repro_torch.core.traffic import Workload
    sims = {"2.5D-HI": simulate_2p5d_hi, "HAIMA_chiplet": simulate_haima_chiplet,
            "TransPIM_chiplet": simulate_transpim_chiplet}
    for arch, rows in ANCHORS.items():
        for model, n, chips, target in rows:
            ms = sims[arch](Workload.from_config(get_config(model), seq_len=n),
                            chips).latency_s * 1e3
            err = abs(float(np.log(ms / target)))
            print(f"paper table4 arch={arch} model={model} seq_len={n} chiplets={chips} "
                  f"latency_ms={ms:.3f} paper_ms={target} abs_log_ratio={err:.4f} "
                  f"bound={ANCHOR_LOG_TOL[arch]}")
            check(np.isfinite(ms) and err < ANCHOR_LOG_TOL[arch],
                  f"table4 ({arch} {model}): {ms:.3f} ms against the paper's {target}")


def calib_passes(torch, n, sample):
    """``n`` runs of the sampler ``sample()`` one after another, and of
    each point the sample of the run whose time is the median (with every
    run's time, for the print)."""
    runs = []
    for _ in range(n):
        runs.append(sample())
        collect(torch)
    out = []
    for group in zip(*runs):
        check(len({(x.kind, json.dumps(x.params, sort_keys=True)) for x in group}) == 1,
              f"calib: passes over different points {[x.params for x in group]}")
        mid = sorted(group, key=lambda x: x.seconds)[len(group) // 2]
        out.append((mid, [x.seconds for x in group]))
    return out


def print_calib_samples(samples):
    """Each sample's terms, median seconds (each pass's beside it) and rate
    in the term its kind is fitted in; returns the samples."""
    from repro_torch.profile.costmodel import DEFAULT_TERMS
    for s, runs in samples:
        term = DEFAULT_TERMS[s.kind]
        print(f"calib sample kind={s.kind} arch={s.arch} {json.dumps(s.params)} "
              f"bytes={s.bytes_term:.0f} flops={s.flops_term:.0f} seconds={s.seconds:.6e} "
              f"passes_s=[{', '.join(f'{t:.6e}' for t in runs)}] "
              f"first_call_s={s.compile_s:.4f} "
              f"{term}_per_s={getattr(s, term + '_term') / s.seconds:.4e}")
    return [s for s, _ in samples]


def calib_samples(torch, by_run):
    """Steps 1 and 2 of phase calib, the main path: ``kernel_samples`` on
    ``CALIB_ARCH`` at full width and ``executor_samples`` on full-width
    bert-base, each launch counted, each sampler run in passes and each
    point its median (``calib_passes``).  Every timed call of a kernel case
    must launch its kind's kernel (so no plain version was timed), the
    prefill on tensor cores and the matmul too, and every replayed step of
    the executor its decode kernel a layer.  Then the prefill at
    ``CALIB_SERVED_PREFILL``, beside the table.  Returns the grid's
    samples, the executor's, the served prefill's, and the kernels that
    each of the three launched (by counter: ``launches.snapshot``)."""
    from repro_torch.config import get_config
    from repro_torch.kernels import launches as counts
    from repro_torch.kernels.flash_attention.decode import quant_kernel_launches
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill_launches
    from repro_torch.profile.bench import executor_samples, kernel_samples
    from repro_torch.profile.costmodel import DEFAULT_TERMS
    from repro_torch.quant.kernel import kernel_launches as qmm_launches
    calls = 1 + CALIB_REPEAT                        # measure's warmup + repeat
    reset_launches()
    samples = print_calib_samples(calib_passes(torch, CALIB_PASSES, lambda: kernel_samples(
        (CALIB_ARCH,), **CALIB_GRID, warmup=1, repeat=CALIB_REPEAT, device=DEVICE,
        reduce=False)))
    kernels = read_launches()
    launched = {"kernel grid": counts.snapshot().kernels}
    by_kind = {}
    for s in samples:
        by_kind.setdefault(s.kind, []).append(s)
    want = {}
    for kind, (name, bits) in CALIB_WRAPPERS.items():
        timed = len(by_kind[kind]) * calls * CALIB_PASSES
        want[name] = want.get(name, 0) + timed
        if bits:
            got = sum(n for k, n in quant_kernel_launches.items() if k.bits == bits)
            check(got == timed, f"calib: {got} int{bits} decode launches for "
                  f"{len(by_kind[kind])} cases in {CALIB_PASSES} passes")
    check(kernels == {n: want.get(n, 0) for n in kernels},
          f"calib: kernel launches {kernels}, the timed calls {want}")
    check({k.design for k in prefill_launches} == {"tensor_core"}
          and {k.design for k in qmm_launches} == {"tensor_core"},
          f"calib: designs {set(prefill_launches)} {set(qmm_launches)}")
    for s in samples:
        check(DEFAULT_TERMS[s.kind] != "bytes" or s.bytes_term >= CALIB_MIN_BYTES,
              f"calib: {s.kind} {s.params} streams {s.bytes_term:.3e} bytes, under "
              f"{CALIB_MIN_BYTES:.0e}: min-of-k would read the L2")
    by_run["calib kernels"] = kernels

    cfg = get_config(CALIB_EXECUTOR["archs"][0])
    spc = 8                                         # executor_samples' steps_per_call
    reset_launches()
    ex = print_calib_samples(calib_passes(torch, CALIB_EXECUTOR_PASSES, lambda: executor_samples(
        **CALIB_EXECUTOR, warmup=1, repeat=CALIB_REPEAT, steps_per_call=spc, device=DEVICE,
        reduce=False)))
    by_run["calib executor"] = launches = read_launches()
    launched["executor"] = counts.snapshot().kernels
    # an engine a batch and pass: the capture's warm-up runs each program
    # once eagerly (serving/graphs.py), then eng.step() a packed prefill and
    # a decode step, then the timed replays
    engines = len(CALIB_EXECUTOR["batches"]) * CALIB_EXECUTOR_PASSES
    steps, prefills = engines * (2 + spc * calls), engines * 2
    check(launches["flash_decode"] == steps * cfg.n_layers
          and launches["flash_prefill"] == prefills * cfg.n_layers
          and sum(launches.values()) == (steps + prefills) * cfg.n_layers,
          f"calib executor: launches {launches}, {steps} decode steps and {prefills} "
          f"prefills of {cfg.n_layers} layers")

    reset_launches()
    served = print_calib_samples(calib_passes(torch, CALIB_PASSES, lambda: kernel_samples(
        (CALIB_ARCH,), batches=CALIB_GRID["batches"], kv_lens=(), kv_bits=(), qmm_bits=(),
        **CALIB_SERVED_PREFILL, warmup=1, repeat=CALIB_REPEAT, device=DEVICE, reduce=False)))
    n = read_launches()
    check(n == {k: len(served) * calls * CALIB_PASSES if k == "flash_prefill" else 0
                for k in n}
          and {k.design for k in prefill_launches} == {"tensor_core"},
          f"calib served prefill: launches {n}, designs {set(prefill_launches)}")
    launched["served prefill"] = counts.snapshot().kernels
    reset_launches()
    return samples, ex, served, launched


def calib_attention_check(torch, what, out, ref):
    """An attention output against its plain version, elementwise within
    ``TOL`` of |ref| + the RMS of ref: relative where values are large (a
    prefill's first rows), and on the outputs' own scale where they are
    small (at Skv 8192 an output is about 0.02, half ``TOL``)."""
    d, r = (out.float() - ref.float()).abs(), ref.float()
    rms = r.square().mean().sqrt().item()
    worst = (d / (r.abs() + rms)).max().item()
    err, tol = d.max().item(), TOL[str(out.dtype)]
    print(f"calib check {what} shape={tuple(out.shape)} max_abs_err={err:.3e} "
          f"ref_rms={rms:.3e} ref_max={r.abs().max().item():.3e} "
          f"max_err_over_abs_ref_plus_rms={worst:.3e} tol={tol:g}")
    check(out.shape == ref.shape and np.isfinite(worst) and worst <= tol,
          f"calib: {what} disagrees with its plain version ({worst:.3e} > {tol:g})")


def calib_plain_checks(torch, samples, launched):
    """Cases of the kernel grid (``samples``) against their plain versions
    on the same inputs (launches made here are not the main path's): of
    each kind the smallest grid point by its fitted term, and the smallest
    of each value of ``CALIB_CHECK_BY``; and of every kernel that the grid
    launched (``launched``, by counter) but that no check had held yet,
    the smallest case that launches it.  Attention by
    ``calib_attention_check``, the dequant matmul within ``MATMUL_TOL`` of
    the plain version's largest magnitude, as phase kernels holds it."""
    from repro_torch.config import get_config
    from repro_torch.kernels import launches as counts
    from repro_torch.profile.bench import kernel_case
    from repro_torch.profile.costmodel import DEFAULT_TERMS
    cfg = get_config(CALIB_ARCH)
    checked = {"decode": CHECKED_DECODE, "decode_quant": CHECKED_DECODE_QUANT,
               "prefill": CHECKED_PREFILL, "qmatmul": CHECKED_KERNELS}
    for kind, name in CALIB_COUNTERS.items():
        counter, done = counts.counters()[name], checked[name]
        term = DEFAULT_TERMS[kind] + "_term"
        mine = sorted((x for x in samples if x.kind == kind), key=lambda x: getattr(x, term))
        firsts = {}
        for x in mine:
            firsts.setdefault(x.params.get(CALIB_CHECK_BY.get(kind)), x)
        firsts = {id(x) for x in firsts.values()}
        bits = CALIB_WRAPPERS[kind][1]
        missing = {k for k in launched[name] if k not in done
                   and (not bits or k.bits == bits)}
        for x in mine:
            if id(x) not in firsts and not missing:
                continue
            case = kernel_case(kind, cfg, x.params,
                               generator=torch.Generator(device=DEVICE).manual_seed(1))
            out, kernel = ran_one(counter, case.call, kind)
            if id(x) in firsts or kernel in missing:
                ref = case.plain()
                torch.cuda.synchronize()
                label = (f"kind={kind} {json.dumps(x.params)} kernel="
                         f"{kernel_name(kernel) if name == 'qmatmul' else attention_kernel_name(kernel)}")
                if name == "qmatmul":
                    err = (out.float() - ref.float()).abs().max().item()
                    scale = max(ref.float().abs().max().item(), 1e-30)
                    tol = MATMUL_TOL[str(out.dtype)]
                    print(f"calib check {label} shape={tuple(out.shape)} max_abs_err={err:.3e} "
                          f"ref_max={scale:.3e} rel_to_max={err / scale:.3e} tol={tol:g}")
                    check(out.shape == ref.shape and np.isfinite(err) and err <= tol * scale,
                          f"calib: {label} disagrees with its plain version ({err:.3e})")
                else:
                    calib_attention_check(torch, label, out, ref)
                done.add(kernel)
                missing.discard(kernel)
                del ref
            del case, out
            collect(torch)
        check(not missing, f"calib: {kind} kernels launched that no case reached: {missing}")


def calib_engine_checks(torch):
    """The attention of steps 2 and 4 against its plain versions on the
    engines' shapes (full-width bert-base, MHA at hd 64): the decode over
    each pool (max_batch slots of kv_len entries; the split plan follows
    both) and the packed prefill of one chunk (the engine's default chunk,
    min(128, kv_len), for the executor; 32 for the traced drain)."""
    from repro_torch.config import get_config
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd, flash_decode_plain
    from repro_torch.kernels.flash_attention.decode import kernel_launches as decode_launches
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                            flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill_launches
    cfg = get_config(CALIB_EXECUTOR["archs"][0])
    heads = dict(Hq=cfg.n_heads, Hkv=cfg.n_kv_heads or cfg.n_heads, hd=cfg.head_dim)
    rng = np.random.default_rng(27)
    tr, kv = CALIB_TRACE_ENGINE, CALIB_EXECUTOR["kv_len"]
    for B, Skv in ([(B, kv) for B in CALIB_EXECUTOR["batches"]]
                   + [(tr["max_batch"], tr["kv_len"])]):
        c = decode_case(torch, rng, B=B, Skv=Skv, **heads)
        k, v = c["pools"][0]
        args = dict(q_pos=c["q_pos"], kv_pos=c["kv_pos"])
        out, kernel = ran_one(decode_launches, lambda: flash_decode_fwd(c["q"], k, v, **args),
                              "decode")
        CHECKED_DECODE.add(kernel)
        calib_attention_check(torch, f"engine decode B{B} Skv{Skv} "
                              f"kernel={attention_kernel_name(kernel)}", out,
                              flash_decode_plain(c["q"], k, v, **args))
    for S in (min(128, kv), tr["prefill_chunk"]):
        c = prefill_case(torch, rng, S=S, lens=(S // 2, S // 4), **heads)
        args = dict(segments=c["segments"], causal=True)
        out, kernel = ran_one(prefill_launches, lambda: flash_attention_fwd(
            c["q"], c["k"], c["v"], **args), "prefill")
        CHECKED_PREFILL.add(kernel)
        calib_attention_check(torch, f"engine prefill S{S} kernel={attention_kernel_name(kernel)}",
                              out, flash_attention_plain(c["q"], c["k"], c["v"], **args))
    collect(torch)


def calib_fit(samples, served):
    """Step 3 of phase calib: the fitted table (the card's name and power
    limit in its meta) through a JSON round trip, each fit held to the
    pin and under the card's peak; the S range in which the prefill fit
    holds, beside the unpinned fit of the ``served`` prefill samples and
    the pinned fit's error on them; the measured ``Calib`` beside
    ``CALIB``, the error report, and gpt-j's episode through Plane B
    under both, its TTFT marked where its prompt lies outside that
    range."""
    from repro_torch.config import get_config
    from repro_torch.core.simulator import CALIB, simulate_generation
    from repro_torch.core.traffic import Workload
    from repro_torch.profile.calibrate import measured_calib, phase_error_report
    from repro_torch.profile.costmodel import CalibrationTable, build_table, fit_phase
    table = build_table(samples, backend=DEVICE, meta={
        "card": CARD, "grid": sorted({s.kind for s in samples}),
        "archs": sorted({s.arch for s in samples})})
    again = CalibrationTable.from_json(json.loads(json.dumps(table.to_json())))
    check(again.to_json() == table.to_json(), "calib: the table's JSON round trip changed it")
    check(table.backend == DEVICE and table.interpret == (DEVICE == "cpu"),
          f"calib: table of backend {table.backend}, interpret {table.interpret}")
    peak = {"bytes": HBM_BYTES_PER_S, "flops": PEAK_FLOPS["torch.bfloat16"]}
    for kind, f in table.fits.items():
        print(f"calib fit kind={kind} term={f.term} rate={f.rate:.4e} "
              f"peak_share={f.rate / peak[f.term]:.4f} intercept_us={f.intercept_s * 1e6:.2f} "
              f"r2={f.r2:.5f} rate_ci95_rel={f.rate_ci95_rel} n_train={f.n_train} "
              f"n_heldout={f.n_heldout} heldout_max_rel_err={f.heldout_max_rel_err:.4f} "
              f"heldout_mean_rel_err={f.heldout_mean_rel_err:.4f} "
              f"flops_rate={f.flops_rate:.4e} card={CARD!r}")
        check(np.isfinite(f.rate) and f.rate > 0, f"calib: {kind} rate {f.rate}")
        check(f.heldout_max_rel_err <= CALIB_TOLERANCE,
              f"calib: {kind} held-out error {f.heldout_max_rel_err:.3f} over "
              f"{CALIB_TOLERANCE}")
        check(f.rate <= CALIB_PEAK_SHARE * peak[f.term],
              f"calib: {kind} rate {f.rate:.3e} above {CALIB_PEAK_SHARE} x the card's "
              f"{f.term} peak {peak[f.term]:.3e}")
    print(f"calib error_bar_rel={table.error_bar_rel:.4f} card={CARD!r}")
    pf = table.fits["prefill_attn"]
    lens = sorted({s.params["seq"] for s in samples if s.kind == "prefill_attn"})
    un = fit_phase(served)
    miss = [abs(pf.predict(s.flops_term) / s.seconds - 1.0) for s in served]
    print(f"calib prefill_fit_range S={lens[0]}..{lens[-1]} (the pinned prefill fit, the "
          f"measured Calib's sm_efficiency and the error bar hold there only) "
          f"served S={sorted({s.params['seq'] for s in served})} unpinned fit: "
          f"rate={un.rate:.4e} intercept_us={un.intercept_s * 1e6:.2f} r2={un.r2:.5f} "
          f"heldout_max_rel_err={un.heldout_max_rel_err:.4f} pinned=false; pinned fit's "
          f"rel err at served S: max={max(miss):.4f} mean={sum(miss) / len(miss):.4f} "
          f"card={CARD!r}")
    mcal = measured_calib(table, n_chiplets=PAPER_CHIPLETS)
    print(f"calib Calib default: {json.dumps(dataclasses.asdict(CALIB))}")
    print(f"calib Calib measured: {json.dumps(dataclasses.asdict(mcal))}")
    for kind, row in phase_error_report(table, n_chiplets=PAPER_CHIPLETS).items():
        print(f"calib phase_error kind={kind} " + json.dumps(row))
        check(row["measured_s"] > 0 and row["analytical_s"] > 0, f"calib: error row {row}")
    c = CALIB_COSIM
    w = Workload.from_config(get_config(c["arch"]), seq_len=c["prompt_len"])
    rows = {}
    for name, cal in (("default", CALIB), ("measured", mcal)):
        g = simulate_generation(w, PAPER_CHIPLETS, c["prompt_len"], c["gen_len"],
                                arch="2.5D-HI", batch=c["batch"], calib=cal)
        rows[name] = {"ttft_ms": g.ttft_s * 1e3, "decode_step_ms": g.decode_step_s * 1e3,
                      "decode_tok_s": g.decode_tok_s}
        check(all(np.isfinite(v) and v > 0 for v in rows[name].values()),
              f"calib: cosim {name} {rows[name]}")
    delta = rows["measured"]["decode_step_ms"] / rows["default"]["decode_step_ms"] - 1.0
    within = lens[0] <= c["prompt_len"] <= lens[-1]
    print(f"calib cosim {json.dumps(c)} chiplets={PAPER_CHIPLETS} default={json.dumps(rows['default'])} "
          f"measured={json.dumps(rows['measured'])} decode_step_rel_delta={delta:+.4f} "
          f"measured_ttft_within_error_bar={within} (prompt {c['prompt_len']}, prefill fit "
          f"S {lens[0]}..{lens[-1]})")
    return mcal


def calib_trace(torch, mcal):
    """Step 4 of phase calib (main path): a traced drain of full-width
    bert-base, its mix through ``cosim_from_engine`` on gpt-j under the
    measured ``Calib``, which must carry the measured step time."""
    from repro_torch.config import get_config
    from repro_torch.core.cosim import cosim_from_engine
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = get_config(CALIB_EXECUTOR["archs"][0])
    params = make_params(torch, cfg)
    engine = ServingEngine(cfg, params, EngineConfig(
        **CALIB_TRACE_ENGINE, trace=True),
        device=DEVICE)
    rng = np.random.default_rng(0)
    for plen in CALIB_TRACE_PROMPTS:
        engine.submit(rng.integers(0, cfg.vocab_size, size=plen))
    engine.run_until_drained()
    st = engine.stats()
    check(st["finished"] == len(CALIB_TRACE_PROMPTS), f"calib trace: stats {st}")
    rec = cosim_from_engine(engine, cfg=get_config(CALIB_COSIM["arch"]),
                            n_chiplets=PAPER_CHIPLETS, calib=mcal)
    mix = rec["mix"]
    print("calib trace " + json.dumps({k: st[k] for k in st if k.startswith("trace_")}))
    print(f"calib trace mix measured_step_s={mix.get('measured_step_s')} "
          f"measured_prefill_s={mix.get('measured_prefill_s')} "
          f"measured_d2h_s={mix.get('measured_d2h_s')} card={CARD!r} "
          + " ".join(f"{a}:" + json.dumps({k: float(v) for k, v in g.items()
                                           if k in ("ttft_s", "decode_step_s", "tokens_per_s")})
                     for a, g in rec["archs"].items()))
    check(mix.get("measured_step_s", 0) > 0, f"calib trace: mix {mix}")
    del engine, params
    collect(torch)


def run_calib(torch, by_run):
    """Phase calib: the profiling plane on the card, the four steps of
    ``benchmarks/perf_calib.py`` (its file is not run, and no JSON is
    written): the kernels and the captured decode step timed at full width
    with their launches counted, the fits held to the reference's pin and
    the card's peaks, the measured ``Calib`` and the error report beside
    the default, gpt-j through Plane B under both, and a traced drain's
    ``cosim_from_engine``.  Then the cases against their plain versions,
    and every kernel that the phase launched held by some check."""
    from repro_torch.kernels import launches as counts
    collect(torch)
    t_phase = time.perf_counter()
    samples, ex, served, launched = calib_samples(torch, by_run)
    mcal = calib_fit(samples + ex, served)
    reset_launches()
    calib_trace(torch, mcal)
    by_run["calib trace"] = read_launches()
    launched["trace"] = counts.snapshot().kernels
    calib_plain_checks(torch, samples, launched["kernel grid"])
    calib_plain_checks(torch, served, launched["served prefill"])
    calib_engine_checks(torch)
    for what, kernels in launched.items():
        check_attention_checked(f"calib {what} decode", kernels["decode"], CHECKED_DECODE)
        check_attention_checked(f"calib {what} quantised decode", kernels["decode_quant"],
                                CHECKED_DECODE_QUANT)
        check_attention_checked(f"calib {what} prefill", kernels["prefill"], CHECKED_PREFILL)
        check_kernels_checked(f"calib {what}", kernels["qmatmul"])
    reset_launches()
    print(f"phase calib done in {time.perf_counter() - t_phase:.1f} s")


def run_moe(torch, by_run):
    """Phase moe: full-width qwen3-moe-30b-a3b (its depth cut to
    ``MOE_LAYERS`` of 48, 128 experts, top-8), random bf16 weights, after
    every earlier model, engine and graph pool is freed.  The engine
    phase's 16 requests at fp and w8kv8, replayed and again eagerly
    (streams bit for bit, launches equal), each prompt admitted alone and
    padded to a chunk multiple, the fused gate/up, the down product and the
    combine each launched once a MoE layer of every forward call; ``packed=False`` at fp (power-of-two
    buckets) against the default's streams up to near-ties; flash against
    ref logits, the ref run's expert choices imposed on the flash run
    (``ForcedRouting``); a profiled decode step (wall and busy time, idle
    share, kernels a step, each expert-path kernel's time and share of
    busy time)."""
    from repro_torch.config import get_config
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2**30
    print(f"moe memory_allocated_before_build_gib={before:.3f} "
          f"bound_gib={MOE_FREE_BEFORE_GIB}")
    check(before < MOE_FREE_BEFORE_GIB, f"moe: {before:.2f} GiB still allocated before "
          f"the model is built")
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    params = make_params(torch, cfg)
    drain = dict(kv_len=MOE_KV_LEN)
    plain = {}
    for run in MOE_RUNS:
        r = plain[run] = run_engine(torch, cfg, params, run, **drain)
        by_run[f"{MOE_ARCH} {run}"] = r["launches"]
        run_graphs(torch, cfg, params, run, r, long_prompts=(), **drain)
        st = r["stats"]
        calls = st["decode_steps"] + st["prefill_calls"]
        per_layer = {n: r["launches"][n] / (calls * moe_layers(cfg)) for n in EXPERT_PATH}
        print(f"moe run={run} forward_calls={calls} moe_layers={moe_layers(cfg)} "
              + " ".join(f"{n}_launches={r['launches'][n]}" for n in EXPERT_PATH)
              + f" launches_a_layer_a_call={json.dumps(per_layer)}")
        check(all(v == 1 for v in per_layer.values()),
              f"moe ({run}): expert-path launches a layer and call {per_layer}")
    seq = run_engine(torch, cfg, params, "fp", packed=False, **drain)
    by_run[f"{MOE_ARCH} fp packed=False"] = seq["launches"]
    divs = divergences(torch, cfg, params, "fp", seq["prompts"], plain["fp"]["outputs"],
                       seq["outputs"])
    print(f"moe packed=False streams_equal={seq['outputs'] == plain['fp']['outputs']} "
          f"divergences={json.dumps([[u, t, round(m, 4), round(b, 4)] for u, t, m, b in divs])}")
    check(all(m < b for _, _, m, b in divs),
          "moe: a packed=False stream parts from the default's away from a near-tie")
    for run in ("fp", "w8kv8"):
        routing = ForcedRouting()
        with routing.installed(torch):
            run_logits(torch, cfg, params, run, routing=routing)
    for run in MOE_RUNS:
        d = run_profile(torch, cfg, params, run, kv_len=MOE_KV_LEN)["decode_step"]
        ms = dict.fromkeys(EXPERT_PATH, 0.0)
        for key, t in d["by_kernel_ms"].items():
            if expert_kernel(key):
                ms[expert_kernel(key)] += t
        st, r = plain[run]["stats"], plain[run]
        print(f"moe profile run={run} decode_step_wall_ms={d['wall_ms']:.3f} "
              f"busy_ms={d['busy_ms']:.3f} idle_share={1 - d['busy_ms'] / d['wall_ms']:.3f} "
              f"kernels_per_step={d['kernels_per_step']:.0f} "
              + " ".join(f"{n}_ms={t:.3f} {n}_share_of_busy={t / d['busy_ms']:.3f} "
                         for n, t in ms.items())
              + f"expert_path_ms={sum(ms.values()):.3f} "
              f"expert_path_share_of_busy={sum(ms.values()) / d['busy_ms']:.3f} "
              f"params_gib={r['params_gb'] * 1e9 / 2**30:.3f} "
              f"pool_gib={r['pool_gb'] * 1e9 / 2**30:.4f} peak_memory_gib={r['peak_gib']:.2f} "
              f"tokens_per_s={st['tokens_per_s']:.2f} mean_ttft_s={st['mean_ttft_s']:.4f} "
              f"mean_tpot_s={st['mean_tpot_s']:.5f}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# the MoE layer's expert path: its wrappers, each launched once a MoE layer
# of every forward call
EXPERT_PATH = ("grouped_gate_up", "grouped_matmul", "combine")


def expert_kernel(name):
    """The expert-path wrapper whose kernel the profiler recorded as
    ``name`` (gmm_tma / gmm_cc by their mode: 2 the fused gate/up, 0 and 1
    the product), else None."""
    if "combine_kernel" in name:
        return "combine"
    m = re.search(r"gmm_tma<(\d)", name) or re.search(r"gmm_cc<[^,]+, (\d)", name)
    if m:
        return "grouped_gate_up" if m.group(1) == "2" else "grouped_matmul"
    return None


# ---------------------------------------------------------------------------
# phase recurrent: the SSD and RG-LRU layer kinds
# ---------------------------------------------------------------------------

def recurrent_leaves(cache):
    """The recurrent units' ``conv`` and ``state``/``h`` leaves of a pool."""
    return [leaf for group in cache["stack"] for unit in group.values()
            if "attn" not in unit for leaf in unit.values()]


def cache_items(cache):
    """(path, leaf) of a prefill's cache tree, in a fixed order."""
    return [(f"stack/{gi}/{u}/{name}", leaf) for gi, group in enumerate(cache["stack"])
            for u, unit in sorted(group.items()) for name, leaf in sorted(unit.items())]


def mamba_padded_prefill(torch, cfg, params):
    """Mamba2-130m's padded prefill at full width: the 4600-token prompt
    right-padded to 4608 (18 chunks of 256) with ``length`` 4600, as
    padded admission runs it.

    1. Pads never enter: the same prompt under other pad tokens gives every
       cache leaf (each layer's ``conv`` and ``state``) bit for bit, in
       bf16 as the engine runs it;
    2. against the unpadded prefill of the 4600 tokens (one chunk of 4600:
       ``ssd_scan``'s fallback), f32: every layer's ``conv`` and ``state``
       within ``UNPADDED_TOL`` of the leaf's scale.  Not bit for bit, nor
       within ``test_padded_prefill_state_exact``'s elementwise 1e-5 + 1e-3
       relative: on the card the two lengths' products run other GEMM
       kernels, so even the first layer's conv inputs part in their last
       bits (the reference's rule is for two layers of width 64 on a CPU,
       whose products do not depend on the rows beside them); item 1
       holds the pads bit for bit instead;
    3. the first layer's chunked scan (its inputs recorded in the padded f32
       prefill) against ``ssd_step`` iterated over the 4600 real tokens in
       f32: the final state within ``SCAN_STEP_TOL`` of its scale."""
    from repro_torch.models import ssm as ST
    from repro_torch.models import transformer as T
    n, pad = RECURRENT_LONG[0], -(-RECURRENT_LONG[0] // CHUNK) * CHUNK
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, n)
    rows = np.zeros((2, pad), np.int64)
    rows[:, :n] = prompt
    rows[1, n:] = rng.integers(0, cfg.vocab_size, pad - n)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    t0 = time.perf_counter()
    with torch.no_grad():
        caches = [T.prefill(params, cfg, dev(r[None]), kv_cap=pad, length=n)[1]
                  for r in rows]
        a, b = cache_items(caches[0]), cache_items(caches[1])
        pads_out = all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
        del caches, a, b
        recorded = []
        scan = ST.ssd_scan

        def recording(*args, **kw):
            out = scan(*args, **kw)
            if not recorded:
                recorded.append((args, out[1]))
            return out
        ST.ssd_scan = recording
        try:
            padded = cache_items(T.prefill(params, cfg, dev(rows[:1]), kv_cap=pad, length=n,
                                           compute_dtype=torch.float32)[1])
        finally:
            ST.ssd_scan = scan
        exact = cache_items(T.prefill(params, cfg, dev(prompt[None]), kv_cap=pad,
                                      compute_dtype=torch.float32)[1])
        first_conv = float((padded[0][1] - exact[0][1]).abs().max())
        worst = {}
        for (path, x), (_, y) in zip(padded, exact):
            name = path.rsplit("/", 1)[-1]
            rel = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
            worst[name] = max(worst.get(name, 0.0), rel)
        within = max(worst.values()) <= UNPADDED_TOL
        (x, dt, A, Bm, Cm), final = recorded[0]
        state = torch.zeros_like(final)
        for t in range(n):
            _, state = ST.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], state)
        scale = max(1.0, float(state.abs().max()))
        scan_err = float((final - state).abs().max())
    print(f"recurrent arch={cfg.name} padded_prefill length={n} stream={pad} "
          f"chunks={pad // cfg.ssm_chunk} pads_never_enter_bit_for_bit={pads_out} "
          f"first_layer_conv_max_abs_diff={first_conv:.3e} "
          f"unpadded_rel_to_scale={json.dumps(worst)} bound={UNPADDED_TOL} "
          f"scan_vs_steps_max_abs={scan_err:.3e} "
          f"state_scale={scale:.4f} scan_bound={SCAN_STEP_TOL * scale:.3e} "
          f"seconds={time.perf_counter() - t0:.2f}")
    check(pads_out, "recurrent: a pad token moved the padded prefill's cache")
    check(within, "recurrent: the padded prefill's cache parts from the unpadded prefill's")
    check(scan_err <= SCAN_STEP_TOL * scale, "recurrent: the chunked scan's final state "
          "parts from the recurrence iterated")


def recurrent_ops_ms(torch, cfg, params):
    """Device time (ms) of a decode step's recurrent ops alone: in each SSD
    layer its conv, SiLU, softplus, ``ssd_step``, the skip and the gated
    norm; in each RG-LRU layer its conv, the gates (two f32 products with
    wa and wi), the recurrence and the GELU gating: the layer's
    projections left out.  One layer timed at the pool's 8 slots, cycling
    over caches and weights that span twice the L2 (each layer reads its
    own), times the layers of the kind."""
    import torch.nn.functional as F
    from repro_torch.models import rglru as RT
    from repro_torch.models import ssm as ST
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import rmsnorm
    kind = "ssm" if "ssm" in cfg.layer_kinds else "recurrent"
    gi, ui = next((gi, ui) for gi, spec in enumerate(T.build_groups(cfg))
                  for ui, (k, _) in enumerate(spec.units) if k == kind)
    p = T._layer(params["stack"][gi], 0)[f"u{ui}"]
    g = torch.Generator(device=DEVICE).manual_seed(5)
    B, bf16 = MAX_BATCH, torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    if kind == "ssm":
        m = p["mamba"]
        d_inner, H, P, N, G = ST._dims(cfg)
        xbc, z, dt_raw = randn(B, 1, d_inner + 2 * G * N), randn(B, 1, d_inner), randn(B, 1, H)
        nbytes = tensor_bytes(ST.init_ssm_cache(cfg, B, bf16, "meta"))
        caches = [ST.init_ssm_cache(cfg, B, bf16, DEVICE) for _ in range(cold_copies(nbytes))]
        layers = [m] * len(caches)

        def step(c, m):
            u, conv = ST.causal_conv(xbc, m["conv_w"], m["conv_b"], c["conv"])
            u = F.silu(u)
            xs = u[..., :d_inner].reshape(B, 1, H, P)
            dt = F.softplus(dt_raw.float() + m["dt_bias"])
            y, st = ST.ssd_step(xs[:, 0], dt[:, 0], -torch.exp(m["A_log"]),
                                u[:, 0, d_inner:d_inner + G * N].reshape(B, G, N),
                                u[:, 0, d_inner + G * N:].reshape(B, G, N), c["state"])
            c["conv"].copy_(conv)
            c["state"].copy_(st)
            y = y[:, None] + xs * m["D"][None, None, :, None].to(bf16)
            return rmsnorm(y.reshape(B, 1, d_inner) * F.silu(z), m["norm"])
    else:
        W = cfg.lru_width
        u0, gate = randn(B, 1, W), randn(B, 1, W)
        gates_bytes = 2 * W * W * 4
        n = cold_copies(gates_bytes)
        # distinct f32 gate weights for each copy, as each layer reads its own
        layers = [dict(p["rec"], wa=randn(W, W, dtype=torch.float32) / W ** 0.5,
                       wi=randn(W, W, dtype=torch.float32) / W ** 0.5) for _ in range(n)]
        caches = [RT.init_rglru_cache(cfg, B, bf16, DEVICE) for _ in range(n)]

        def step(c, r):
            u, conv = ST.causal_conv(u0, r["conv_w"], r["conv_b"], c["conv"])
            a, b = RT._rglru_core(u, r)
            h = a[:, 0] * c["h"] + b[:, 0]
            c["conv"].copy_(conv)
            c["h"].copy_(h)
            return F.gelu(gate, approximate="tanh") * h[:, None].to(bf16)
    nxt = cycler(list(zip(caches, layers)))
    with torch.no_grad():
        ms = device_ms(lambda: step(*nxt()), 50)
    n_layers = cfg.layer_kinds.count(kind)
    return {"kind": kind, "layer_ms": ms, "layers": n_layers, "step_ms": ms * n_layers}


def run_recurrent_logits(torch, cfg, params, run="fp"):
    """Flash against ref logits of a stack that cannot be packed: each of
    four prompts (30, 61, 17 and 4600 tokens) prefilled alone, padded to a
    chunk multiple as padded admission pads it, inserted into its slot (the
    long one wraps its rings), then 4 teacher-forced decode steps; each impl
    on its own pool, held to ``run_logits``' bound (5e-2 of ref's scale)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.executor import Executor
    from repro_torch.serving.pool import SlotPool
    rng = np.random.default_rng(1)
    lens = (30, 61, 17) + RECURRENT_LONG
    B = len(lens)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    steps = rng.integers(0, cfg.vocab_size, (4, B)).astype(np.int32)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(DEVICE)  # noqa: E731
    results = {}
    for impl in ("flash", "ref"):
        ecfg = EngineConfig(max_batch=B, kv_len=RECURRENT_KV_LEN, impl=impl,
                            **QUANT_RUNS[run])
        ex = Executor(cfg, params, ecfg, device=torch.device(DEVICE))
        pool = SlotPool(cfg, ecfg, device=torch.device(DEVICE))
        out = []
        with torch.no_grad():
            first = []
            for slot, (n, prompt) in enumerate(zip(lens, prompts)):
                row = np.zeros((1, -(-n // CHUNK) * CHUNK), np.int32)
                row[0, :n] = prompt
                logits, pc = ex.prefill(dev(row), n)
                ex.insert(pool.cache, pc, slot, n)
                first.append(logits.float())
                del pc
            if "local" in cfg.pattern:
                check(local_positions(cfg, pool.cache) >= cfg.window,
                      f"logits ({run}): the local ring did not wrap")
            out.append(torch.cat(first))
            for s in range(4):
                logits, _ = T.decode_step(ex.params, cfg, pool.cache, dev(steps[s]),
                                          dev(np.asarray(lens, np.int32) + s), impl=impl)
                out.append(logits.float())
        del ex, pool
        results[impl] = out
    names = ["prefill"] + [f"decode{s}" for s in range(4)]
    scale = max(float(r.abs().max()) for r in results["ref"])
    limit = 5e-2 * max(1.0, scale)
    diffs = {n: float((a - b).abs().max()) for n, a, b in
             zip(names, results["flash"], results["ref"])}
    finite = all(bool(torch.isfinite(r).all()) for r in results["flash"])
    print(f"logits run={run} arch={cfg.name} layers={cfg.n_layers} rows={list(lens)} "
          f"padded_admission=True kv_len={RECURRENT_KV_LEN} max_abs_diff={json.dumps(diffs)} "
          f"bound={limit:.4f} ref_scale={scale:.4f} finite={finite}")
    check(finite and max(diffs.values()) <= limit,
          f"flash and ref logits ({cfg.name} {run}) disagree beyond the bound")
    return diffs, limit


def print_recurrent_profile(torch, cfg, params, run, r, ops):
    """The replayed decode step (profiled: wall, busy, idle share, kernels
    a step), the recurrent ops' share of its busy time, and the drain's
    tokens/s, TTFT, TPOT and peak memory, with the card's name and power
    limit."""
    d = run_profile(torch, cfg, params, run, kv_len=RECURRENT_KV_LEN)["decode_step"]
    st = r["stats"]
    print(f"recurrent profile arch={cfg.name} run={run} card={CARD!r} "
          f"layers={cfg.n_layers} decode_step_wall_ms={d['wall_ms']:.3f} "
          f"busy_ms={d['busy_ms']:.3f} idle_share={1 - d['busy_ms'] / d['wall_ms']:.3f} "
          f"kernels_per_step={d['kernels_per_step']:.0f} "
          f"recurrent_ops_ms={ops['step_ms']:.3f} ({ops['layers']} {ops['kind']} layers x "
          f"{ops['layer_ms']:.4f}) recurrent_ops_share_of_busy="
          f"{ops['step_ms'] / d['busy_ms']:.3f} "
          f"tokens_per_s={st['tokens_per_s']:.2f} mean_ttft_s={st['mean_ttft_s']:.4f} "
          f"ttft_p95_s={st['ttft_p95_s']:.4f} mean_tpot_s={st['mean_tpot_s']:.5f} "
          f"decode_step_wall_ms_drain={st['trace_decode_step_s'] * 1e3:.3f} "
          f"peak_memory_gib={r['peak_gib']:.2f} "
          f"params_gib={r['params_gb'] * 1e9 / 2**30:.3f} "
          f"pool_gib={r['pool_gb'] * 1e9 / 2**30:.4f}")


def run_recurrent(torch, by_run):
    """Phase recurrent: mamba2-130m and recurrentgemma-9b at full width
    (recurrentgemma-9b at ``RGEMMA_LAYERS`` of 38 layers), random bf16 weights (seed 0), once every earlier model is freed,
    each serving the engine phase's 16 requests and a 4600-token prompt
    (``kv_len`` 5120) through padded admission.

    mamba2-130m: fp replayed and eagerly (streams bit for bit, launches
    equal; no attention and no quantised projection: no kernel of the
    port runs), ``packed=False`` (exact-length prefills, the 4600-token one
    the single-chunk scan) against the default's streams up to near-ties,
    and ``fused=False`` against ``packed=False`` bit for bit; the engine's
    capture leaves the pool's recurrent leaves as they were; the padded
    prefill's cache (``mamba_padded_prefill``); a kill and restore
    mid-decode, bit for bit; a profiled decode step.

    recurrentgemma-9b: fp and w8kv8, replayed and eagerly (streams bit for
    bit, launches equal and as ``expected_launches`` reckons them: the
    decodes and prefills in its local layers, the RG-LRU's ``w_gate``
    among the quantised projections), the long prompt's rings wrapped;
    flash against ref logits at both; a profiled decode step at both.

    Each profile prints the recurrent ops' device time and share."""
    from repro_torch.config import get_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    collect(torch)
    before = torch.cuda.memory_allocated() / 2**30
    print(f"recurrent memory_allocated_before_build_gib={before:.3f} "
          f"bound_gib={MOE_FREE_BEFORE_GIB}")
    check(before < MOE_FREE_BEFORE_GIB, f"recurrent: {before:.2f} GiB still allocated")
    drain = dict(kv_len=RECURRENT_KV_LEN, long_prompts=RECURRENT_LONG)
    t0 = time.perf_counter()

    cfg = get_config(MAMBA_ARCH)
    params = make_params(torch, cfg)
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=MAX_BATCH, kv_len=RECURRENT_KV_LEN, prefill_chunk=CHUNK), device=DEVICE)
    zero = all(not bool(leaf.any()) for leaf in recurrent_leaves(engine.pool.cache))
    print(f"recurrent arch={cfg.name} captured={sorted(engine.executor.graphs.graphs)} "
          f"recurrent_leaves_zero_after_capture={zero}")
    check(zero, "recurrent: the capture moved the pool's recurrent leaves")
    del engine
    plain = run_engine(torch, cfg, params, "fp", **drain)
    by_run[f"{MAMBA_ARCH} fp"] = plain["launches"]
    run_graphs(torch, cfg, params, "fp", plain, **drain)
    seq = run_engine(torch, cfg, params, "fp", packed=False, **drain)
    host = run_engine(torch, cfg, params, "fp", fused=False, **drain)
    divs = divergences(torch, cfg, params, "fp", seq["prompts"], plain["outputs"],
                       seq["outputs"])
    same_host = host["outputs"] == seq["outputs"]
    print(f"recurrent arch={cfg.name} packed=False streams_equal={seq['outputs'] == plain['outputs']} "
          f"divergences={json.dumps([[u, t, round(m, 4), round(b, 4)] for u, t, m, b in divs])} "
          f"fused=False streams_equal_packed_false={same_host}")
    check(all(m < b for _, _, m, b in divs),
          f"recurrent ({cfg.name}): a packed=False stream parts from the default's away "
          f"from a near-tie")
    check(same_host, f"recurrent ({cfg.name}): the host-looped streams differ from the "
          f"sequential fused path's")
    mamba_padded_prefill(torch, cfg, params)
    crash_case(torch, cfg, params, "fp", kind="mid_decode", **drain)
    print_recurrent_profile(torch, cfg, params, "fp", plain,
                            recurrent_ops_ms(torch, cfg, params))
    del params, plain, seq, host
    collect(torch)
    print(f"recurrent arch={MAMBA_ARCH} done at {time.perf_counter() - t0:.1f} s")

    cfg = dataclasses.replace(get_config(RGEMMA_ARCH), n_layers=RGEMMA_LAYERS)
    params = make_params(torch, cfg)
    ops = recurrent_ops_ms(torch, cfg, params)
    for run in RGEMMA_RUNS:
        r = run_engine(torch, cfg, params, run, **drain)
        by_run[f"{RGEMMA_ARCH} {run}"] = r["launches"]
        run_graphs(torch, cfg, params, run, r, **drain)
        run_recurrent_logits(torch, cfg, params, run)
        print_recurrent_profile(torch, cfg, params, run, r, ops)
    del params
    collect(torch)
    print(f"recurrent arch={RGEMMA_ARCH} done at {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase mla: multi-head latent attention (deepseek-v2-236b)
# ---------------------------------------------------------------------------

def mla_ms(torch, cfg):
    """Device time (ms) of a decode step's absorbed MLA attention alone
    (``models.attention.mla_absorbed``: the latent queries through W_uk,
    f32 scores over the pool's latents and RoPE keys, the softmax, the
    latent context and W_uv; the layer's projections and the pool write
    left out): one layer at the pool's 8 slots over all ``MLA_KV_LEN``
    entries (the path computes every entry, valid or not), cycling over
    pools and ``wkv_b`` that span twice the L2 (each layer reads its own),
    times the layers."""
    from repro_torch.models.attention import mla_absorbed
    g = torch.Generator(device=DEVICE).manual_seed(6)
    B, S, bf16 = MAX_BATCH, MLA_KV_LEN, torch.bfloat16
    H, dn, dr, dv, kvr = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim,
                          cfg.kv_lora_rank)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * scale).to(bf16)
    q_nope, q_rope = randn(B, 1, H, dn), randn(B, 1, H, dr)
    pos = torch.full((B, 1), S - 1, dtype=torch.int32, device=DEVICE)
    kv_pos = torch.arange(S, dtype=torch.int32, device=DEVICE).expand(B, S).contiguous()
    nbytes = (B * S * (kvr + dr) + kvr * H * (dn + dv)) * 2
    layers = [({"ckv": randn(B, S, kvr), "kr": randn(B, S, dr), "pos": kv_pos},
               randn(kvr, H, dn + dv, scale=kvr ** -0.5)) for _ in range(cold_copies(nbytes))]
    nxt = cycler(layers)
    scale = (dn + dr) ** -0.5

    def step():
        cache, wkv_b = nxt()
        return mla_absorbed(q_nope, q_rope, cache, pos, wkv_b, scale)
    with torch.no_grad():
        ms = device_ms(step, 50)
    return {"layer_ms": ms, "layers": cfg.n_layers, "step_ms": ms * cfg.n_layers,
            "bytes_a_layer": nbytes}


def mla_snapshot_latents(torch, cfg, params, run):
    """A snapshot taken mid-decode restored into a fresh engine (its graphs
    captured at build): every pool leaf (``ckv``, ``kr`` in bf16 at every
    ``kv_bits``, ``pos``) and the decode state bit for bit the snapshotted
    engine's."""
    from repro_torch.serving.checkpoint import EngineCheckpointer
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.pool import cache_leaves
    prompts, _ = crash_workload(cfg)
    ckpt_dir, _ = crash_dir(f"{cfg.name}-latents-{run}")
    engine = ServingEngine(cfg, params, crash_ecfg(run, MLA_KV_LEN), device=DEVICE)
    ck = EngineCheckpointer(engine, ckpt_dir)
    for p in prompts[:MAX_BATCH]:
        ck.submit(p)
    for _ in range(2):
        engine.step()
    check(crash_kind(engine, 2) == "mid_decode", "mla: the snapshot is not mid-decode")
    ck.save()
    restored = ServingEngine.restore(cfg, params, ckpt_dir, device=DEVICE)
    pairs = list(zip(cache_leaves(engine.pool.cache), cache_leaves(restored.pool.cache)))
    same = all(torch.equal(a, b) for (_, a), (_, b) in pairs) and \
        all(torch.equal(engine.pool.state[k], restored.pool.state[k]) for k in engine.pool.state)
    dtypes = sorted({f"{n}:{str(a.dtype).split('.')[-1]}" for (n, a), _ in pairs})
    held = int(sum((a >= 0).sum() for (n, a), _ in pairs if n == "pos"))
    print(f"mla snapshot run={run} kv_bits={engine.ecfg.kv_bits} leaves={dtypes} "
          f"valid_entries={held} restored_bit_for_bit={same}")
    check(same and held > 0 and dtypes == ["ckv:bfloat16", "kr:bfloat16", "pos:int32"],
          f"mla ({run}): the restored latent pool differs from the snapshotted one")
    del engine, restored, ck
    collect(torch)
    shutil.rmtree(ckpt_dir)


def run_mla(torch, by_run):
    """Phase mla: deepseek-v2-236b at full width, its depth cut to
    ``MLA_LAYERS`` (the dense first layer and 7 MoE layers of 160 experts),
    random bf16 weights, once every earlier model is freed.  The engine
    phase's 16 requests at fp and w8kv8 (``kv_len`` 1024) through padded
    admission, replayed and again eagerly (streams bit for bit, launches
    equal and as ``expected_launches`` reckons them: a prefill kernel a
    layer on tensor cores at head dims 192/128, no decode kernel, ``wo``, the
    dense MLP, the shared experts and ``lm_head`` on the dequant-matmul at
    w8kv8, the expert path in each MoE layer); flash against ref logits
    with the ref run's expert choices imposed (``ForcedRouting``); a kill
    and restore mid-decode at fp, and a snapshot's latent pool restored bit
    for bit at w8kv8; a profiled decode step at both, with the absorbed
    attention's device time (``mla_ms``) and the expert path's share."""
    from repro_torch.config import get_config
    collect(torch)
    before = torch.cuda.memory_allocated() / 2**30
    print(f"mla memory_allocated_before_build_gib={before:.3f} bound_gib={MOE_FREE_BEFORE_GIB}")
    check(before < MOE_FREE_BEFORE_GIB, f"mla: {before:.2f} GiB still allocated")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    params = make_params(torch, cfg)
    drain = dict(kv_len=MLA_KV_LEN)
    plain = {}
    for run in MLA_RUNS:
        r = plain[run] = run_engine(torch, cfg, params, run, **drain)
        by_run[f"{MLA_ARCH} {run}"] = r["launches"]
        run_graphs(torch, cfg, params, run, r, long_prompts=(), **drain)
    print(f"mla engine done at {time.perf_counter() - t0:.1f} s")
    for run in MLA_RUNS:
        routing = ForcedRouting()
        with routing.installed(torch):
            run_logits(torch, cfg, params, run, routing=routing)
    crash_case(torch, cfg, params, "fp", kind="mid_decode", **drain)
    mla_snapshot_latents(torch, cfg, params, "w8kv8")
    print(f"mla logits and crash done at {time.perf_counter() - t0:.1f} s")
    ops = mla_ms(torch, cfg)
    for run in MLA_RUNS:
        d = run_profile(torch, cfg, params, run, kv_len=MLA_KV_LEN)["decode_step"]
        ms = dict.fromkeys(EXPERT_PATH, 0.0)
        for key, t in d["by_kernel_ms"].items():
            if expert_kernel(key):
                ms[expert_kernel(key)] += t
        st, r = plain[run]["stats"], plain[run]
        print(f"mla profile arch={cfg.name} run={run} card={CARD!r} layers={cfg.n_layers} "
              f"decode_step_wall_ms={d['wall_ms']:.3f} busy_ms={d['busy_ms']:.3f} "
              f"idle_share={1 - d['busy_ms'] / d['wall_ms']:.3f} "
              f"kernels_per_step={d['kernels_per_step']:.0f} "
              f"mla_ms={ops['step_ms']:.3f} ({ops['layers']} layers x {ops['layer_ms']:.4f}) "
              f"mla_share_of_busy={ops['step_ms'] / d['busy_ms']:.3f} "
              f"expert_path_ms={sum(ms.values()):.3f} "
              f"expert_path_share_of_busy={sum(ms.values()) / d['busy_ms']:.3f} "
              + " ".join(f"{n}_ms={t:.3f}" for n, t in ms.items())
              + f" tokens_per_s={st['tokens_per_s']:.2f} mean_ttft_s={st['mean_ttft_s']:.4f} "
              f"ttft_p95_s={st['ttft_p95_s']:.4f} mean_tpot_s={st['mean_tpot_s']:.5f} "
              f"decode_step_wall_ms_drain={st['trace_decode_step_s'] * 1e3:.3f} "
              f"peak_memory_gib={r['peak_gib']:.2f} "
              f"params_gib={r['params_gb'] * 1e9 / 2**30:.3f} "
              f"pool_gib={r['pool_gb'] * 1e9 / 2**30:.4f}")
    del params, plain
    collect(torch)
    print(f"mla arch={MLA_ARCH} done at {time.perf_counter() - t0:.1f} s")


def cross_source(torch, cfg, g):
    """The source of phase cross's 8 requests, on the card, by the keyword
    ``prefill`` takes: frames (whisper) and patch embeddings (the vision
    stack) normal at ``CROSS_SOURCE_STD``, bart's encoder tokens uniform
    ids."""
    shape = (CROSS_BATCH, CROSS_MODELS[cfg.name]["source"])
    if cfg.family in ("audio", "vlm"):
        x = torch.randn(shape + (cfg.d_model,), generator=g,
                        device=DEVICE) * CROSS_SOURCE_STD[cfg.family]
        return {"frames" if cfg.family == "audio" else "image_embeds": x}
    return {"encoder_tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                            device=DEVICE, dtype=torch.int32)}


def cross_units(cfg, cache):
    """(self, cross) leaves of a decoder cache, {path: tensor}: a cross
    unit's bare {"k", "v"} and a decoder unit's "cross" are cross leaves,
    its "attn" self leaves."""
    from repro_torch.models.transformer import build_groups
    own, cross = {}, {}
    for gi, spec in enumerate(build_groups(cfg)):
        for ui, (kind, _) in enumerate(spec.units):
            unit = cache["stack"][gi][f"u{ui}"]
            parts = {"cross": unit} if kind == "cross" else unit
            for part, leaves in parts.items():
                for name, t in leaves.items():
                    (cross if part == "cross" else own)[f"{gi}/u{ui}/{part}/{name}"] = t
    return own, cross


def cross_expected_launches(cfg, run):
    """Launches of phase cross's main path (a prefill, then
    ``CROSS_NEW_TOKENS`` decode steps): the prefill runs the prefill kernel
    in every encoder layer (non-causal), every self-attention layer
    (causal) and every cross-attention (non-causal, Sq != Skv); each decode
    step a decode in each of them but the encoder's, the self-attention's
    on the quantised pool at kv_bits 8; at weight_bits 8 every projection
    runs the dequant-matmul: q, k, v, o of the encoder's, self and cross
    attention at the prefill, q and o of a cross-attention at a decode step
    (its keys and values are cached), the MLP of every layer (the gated
    cross layers' too), and an untied lm_head."""
    kinds = cfg.layer_kinds
    own = kinds.count("global")
    cross = kinds.count("cross") + (own if cfg.cross_attn_decoder else 0)
    enc, steps = cfg.n_encoder_layers, CROSS_NEW_TOKENS
    bits = QUANT_RUNS[run]
    want = {"flash_prefill": enc + own + cross,
            "flash_decode": steps * (cross + (0 if bits.get("kv_bits") else own)),
            "flash_decode_quant": steps * own if bits.get("kv_bits") else 0}
    if bits.get("weight_bits"):
        mlp, head = (3 if cfg.glu else 2), (0 if cfg.tie_embeddings else 1)
        prefill = 4 * (enc + own + cross) + mlp * (enc + len(kinds)) + head
        step = 4 * own + 2 * cross + mlp * len(kinds) + head
        want["quant_matmul"] = prefill + steps * step
    return want


def run_cross_model(torch, cfg, params, run, by_run):
    """One workload of phase cross: 8 requests of one prompt length and
    their source through ``prefill`` (``kv_cap`` the model's ``kv_len``),
    then ``CROSS_NEW_TOKENS`` greedy ``decode_step`` calls, with
    ``impl="flash"``: the main path, its launches counted from 0 and held
    to ``cross_expected_launches``, timed on the host clock.  Then: the
    same steps with ``impl="ref"`` fed the flash run's tokens, logits within
    5e-2 of their scale at the prefill and every step; the decode steps of
    ``CROSS_TF_STEPS`` against a prefill over the longer prefix (the
    reference's ``_decode_matches_prefill``), the same bound; every cross
    leaf bit for bit what the prefill wrote; at w8kv8 the self leaves int8
    codes and the cross leaves bf16; at fp a zeroed source moving the
    logits by more than the flash-vs-ref bound; and every kernel the model launched one that phase 3 held
    against its plain version."""
    from repro_torch.kernels.flash_attention.decode import kernel_launches as decode_kernels
    from repro_torch.kernels.flash_attention.decode import quant_kernel_launches
    from repro_torch.kernels.flash_attention.kernel import kernel_launches as prefill_kernels
    from repro_torch.models import transformer as T
    from repro_torch.quant.core import quantize_params
    from repro_torch.quant.kernel import kernel_launches as qmatmul_kernels
    m, bits = CROSS_MODELS[cfg.name], QUANT_RUNS[run]
    if bits.get("weight_bits"):
        params = T.Transformer(cfg, quantize_params(params, bits["weight_bits"]))
    g = torch.Generator(device=DEVICE).manual_seed(0)
    B, P, steps = CROSS_BATCH, m["prompt"], CROSS_NEW_TOKENS
    toks = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=DEVICE,
                         dtype=torch.int32)
    src = cross_source(torch, cfg, g)
    kw = dict(kv_cap=m["kv_len"], kv_bits=bits.get("kv_bits", 0))
    positions = [torch.full((B,), P + s, dtype=torch.int32, device=DEVICE)
                 for s in range(steps + 1)]

    # -- the main path, counted ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, toks, impl="flash", **kw, **src)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flash, fed = [logits.float()], []
        for s in range(steps):
            fed.append(logits.argmax(-1).int())
            logits, cache = T.decode_step(params, cfg, cache, fed[-1], positions[s],
                                          impl="flash")
            flash.append(logits.float())
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    by_run[f"{cfg.name} {run}"] = launches
    want = cross_expected_launches(cfg, run)
    wrong = {n: (c, want.get(n, 0)) for n, c in launches.items() if c != want.get(n, 0)}
    print(f"cross launches arch={cfg.name} run={run} {json.dumps(launches)}")
    check(not wrong, f"cross ({cfg.name} {run}): launches (got, reckoned) {wrong}")
    own, cross = cross_units(cfg, cache)
    if bits.get("kv_bits"):
        check(all(t.dtype == torch.int8 for n, t in own.items() if n.endswith("_q")) and
              any(n.endswith("_q") for n in own),
              f"cross ({cfg.name} {run}): the self-attention pool is not int8 codes")
    check(cross and all(t.dtype == torch.bfloat16 for t in cross.values()),
          f"cross ({cfg.name} {run}): the cross leaves are not bf16")

    # -- checks ------------------------------------------------------------
    with torch.no_grad():
        # the cross leaves after the decode steps against a fresh prefill's
        # (the prefill is deterministic: the same kernels on the same inputs)
        _, again = T.prefill(params, cfg, toks, impl="flash", **kw, **src)
        same_cross = all(torch.equal(t, cross_units(cfg, again)[1][n]) for n, t in cross.items())
        del again
        logits, ref_cache = T.prefill(params, cfg, toks, impl="ref", **kw, **src)
        ref = [logits.float()]
        for s in range(steps):
            logits, ref_cache = T.decode_step(params, cfg, ref_cache, fed[s], positions[s],
                                              impl="ref")
            ref.append(logits.float())
        del ref_cache
        tf = {}
        for s in CROSS_TF_STEPS:
            prefix = torch.cat([toks, torch.stack(fed[:s + 1], dim=1)], dim=1)
            tf[s] = T.prefill(params, cfg, prefix, impl="flash", **kw, **src)[0].float()
        moved = None
        if not bits:
            zero = {k: torch.zeros_like(v) for k, v in src.items()}
            moved = float((T.prefill(params, cfg, toks, impl="flash", **kw, **zero)[0].float()
                           - flash[0]).abs().max())
    scale = max(float(r.abs().max()) for r in ref)
    limit = 5e-2 * max(1.0, scale)
    ref_diff = max(float((a - b).abs().max()) for a, b in zip(flash, ref))
    tf_diff = max(float((flash[s + 1] - t).abs().max()) for s, t in tf.items())
    finite = all(bool(torch.isfinite(x).all()) for x in flash)
    print(f"cross logits arch={cfg.name} run={run} layers={cfg.n_layers}+{cfg.n_encoder_layers} "
          f"prompt={P} source={m['source']} steps={steps} flash_vs_ref={ref_diff:.4f} "
          f"decode_vs_teacher_forced={tf_diff:.4f} bound={limit:.4f} ref_scale={scale:.4f} "
          f"cross_leaves_unchanged={same_cross} finite={finite}"
          + ("" if moved is None else f" zeroed_source_moves={moved:.4f}"))
    check(finite and ref_diff <= limit, f"cross ({cfg.name} {run}): flash and ref logits "
          f"{ref_diff:.4f} apart, bound {limit:.4f}")
    check(tf_diff <= limit, f"cross ({cfg.name} {run}): decode and teacher-forced prefill "
          f"{tf_diff:.4f} apart, bound {limit:.4f}")
    check(same_cross, f"cross ({cfg.name} {run}): decode changed a cross leaf")
    check(moved is None or moved > limit,
          f"cross ({cfg.name} {run}): a zeroed source left the logits ({moved})")
    check_attention_checked(f"cross {cfg.name} {run}", prefill_kernels, CHECKED_PREFILL)
    check_attention_checked(f"cross {cfg.name} {run}", decode_kernels, CHECKED_DECODE)
    check_attention_checked(f"cross {cfg.name} {run}", quant_kernel_launches,
                            CHECKED_DECODE_QUANT)
    check_kernels_checked(f"cross {cfg.name} {run}", qmatmul_kernels)

    out = {"prefill_ms": (t1 - t0) * 1e3, "decode_step_ms": (t2 - t1) * 1e3 / steps,
           "tokens_per_s": B * steps / (t2 - t1), "peak_gib": torch.cuda.max_memory_allocated()
           / 2**30, "pool_gib": tensor_bytes(own) / 2**30,
           "cross_gib": tensor_bytes(cross) / 2**30}
    if run == "fp" and cfg.family in ("audio", "vlm"):
        with torch.no_grad():
            step = functools.partial(T.decode_step, params, cfg, cache, fed[-1],
                                     positions[steps], impl="flash")
            d = profiled(torch, cfg.name, run, "decode_step", step, 4)
            out.update(decode_busy_ms=d["busy_ms"], decode_wall_ms=d["wall_ms"],
                       decode_kernels=d["kernels_per_step"])
            if cfg.n_encoder_layers:
                e = profiled(torch, cfg.name, run, "encoder", functools.partial(
                    T.run_encoder, params, cfg, **src), 2)
                out.update(encoder_busy_ms=e["busy_ms"], encoder_wall_ms=e["wall_ms"])
    print(f"cross arch={cfg.name} run={run} card={CARD!r} "
          + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def run_cross(torch, by_run):
    """Phase cross: once every earlier model is freed, each model of
    ``CROSS_MODELS`` with random bf16 weights (seed 0; the vision stack's
    gates set to ``CROSS_GATES``) through ``run_cross_model`` at each of
    its precisions, then freed."""
    collect(torch)
    before = torch.cuda.memory_allocated() / 2**30
    print(f"cross memory_allocated_before_build_gib={before:.3f} bound_gib={MOE_FREE_BEFORE_GIB}")
    check(before < MOE_FREE_BEFORE_GIB, f"cross: {before:.2f} GiB still allocated")
    for arch, m in CROSS_MODELS.items():
        t0 = time.perf_counter()
        cfg = cross_config(arch)
        params = make_params(torch, cfg)
        with torch.no_grad():
            for gi, spec in enumerate(params["stack"]):
                for unit in spec.values():
                    for name, value in CROSS_GATES.items():
                        if name in unit:
                            unit[name].fill_(value)
        for run in m["runs"]:
            run_cross_model(torch, cfg, params, run, by_run)
        del params
        collect(torch)
        print(f"cross arch={arch} done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase train
# ---------------------------------------------------------------------------

def train_flat(tree):
    """{``/``-joined path: tensor} of a tree of tensors (no copy)."""
    from repro_torch.ckpt import tree_items
    return dict(tree_items(tree))


def train_close(torch, what, got, want, tol):
    """Every leaf of ``got`` finite and within ``tol`` of its scale (its
    largest magnitude) in ``want``, both {path: tensor}, compared in f32 on
    ``got``'s device; returns the largest error over scale."""
    check(set(got) == set(want), f"train {what}: leaves differ")
    worst = 0.0
    for key, w in want.items():
        g = got[key].detach().float()
        w = w.detach().to(g.device).float()
        check(bool(torch.isfinite(g).all()), f"train {what}: {key} not finite")
        scale, err = float(w.abs().max()), float((g - w).abs().max())
        check(err <= tol * scale, f"train {what}: {key} off by {err:.3e} at scale {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def train_full(torch):
    """The full model through ``Trainer.run``: ``TRAIN_STEPS`` steps, then
    one host-timed and one profiled step; the checks and the readings."""
    from repro_torch.config import ShapeSpec, get_config
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ShapeSpec("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH),
                      opt_cfg=OptConfig(**TRAIN_OPT), tcfg=TrainerConfig(remat=True),
                      seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(trainer.params))
    print(f"train arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"params={n_params} master=f32 compute=bf16 remat=True batch={TRAIN_BATCH} "
          f"seq={TRAIN_SEQ} opt={json.dumps(TRAIN_OPT)} built in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    before = {k: v.detach().to("cpu", copy=True) for k, v in train_flat(trainer.params).items()}
    ms = trainer.run(TRAIN_STEPS)
    losses, gnorms = [m["loss"] for m in ms], [m["gnorm"] for m in ms]
    TRAIN_LOSSES[:] = losses                   # phase mesh trains again
    print(f"train losses={json.dumps(losses)} gnorms={json.dumps(gnorms)} "
          f"lrs={json.dumps([m['lr'] for m in ms])} "
          f"step_s={json.dumps([round(m['dt'], 4) for m in ms])}")
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), "train: a loss or gnorm "
          "is not finite")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(last < first, f"train: the loss did not fall ({first:.4f} -> {last:.4f})")
    prof = profiled(torch, cfg.name, "bf16", "train_step",
                    lambda: trainer.train_step(trainer.pipeline.global_batch_at(trainer.step)),
                    1)
    after = train_flat(trainer.params)
    still = [k for k, v in before.items() if torch.equal(v.to(DEVICE), after[k].detach())]
    check(not still, f"train: leaves that did not move: {still}")
    step_s = float(np.mean([m["dt"] for m in ms[1:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    mfu = 6 * n_params * tokens / (step_s * PEAK_FLOPS["torch.bfloat16"])
    print(f"train step_wall_s={step_s:.4f} (mean of steps 2..{TRAIN_STEPS}) "
          f"busy_s={prof['busy_ms'] / 1e3:.4f} idle_share={1 - prof['busy_ms'] / prof['wall_ms']:.3f} "
          f"kernels_per_step={prof['kernels_per_step']:.0f} tokens_per_s={tokens / step_s:.1f} "
          f"peak_memory_gib={peak:.2f} six_n_tokens_over_peak={mfu:.4f} "
          f"loss_first3={first:.4f} loss_last3={last:.4f} leaves_moved={len(before)}/"
          f"{len(before)} card={CARD}")
    del before, after
    train_breakdown(torch, trainer, prof)
    del trainer
    collect(torch)


def train_breakdown(torch, trainer, prof):
    """Where the profiled step's busy time goes: the optimizer (global
    norm and the in-place AdamW) timed alone on the trainer's full state
    with random gradients; ``attention_ref`` timed alone at the step's
    shapes, forward and backward for one layer, scaled to the step (each
    layer's forward runs twice under remat); the kernels whose names are
    the library's GEMMs (the projections', and attention's own); the
    rest.  The two are timed with CUDA events over a few calls: each call
    runs for milliseconds, so the host stays ahead of the card (and no
    further profiler window is opened).  Run after the checks: it writes
    the trainer's state."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.training.optimizer import adamw_apply_, adamw_prepare
    from repro_torch.tree import tree_map
    cfg, opt = trainer.cfg, trainer.opt_cfg

    def event_ms(fn, iters):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    grads = tree_map(lambda p: torch.randn(p.shape, device=p.device), trainer.params)
    opt_ms = event_ms(lambda: adamw_apply_(grads, trainer.opt_state, trainer.params, opt,
                                           adamw_prepare(grads, trainer.opt_state, opt)), 3)
    del grads
    g = torch.Generator(device=DEVICE).manual_seed(4)
    B, S, hd = TRAIN_BATCH, TRAIN_SEQ, cfg.head_dim
    q, k, v = (torch.randn((B, S, h, hd), generator=g, device=DEVICE, dtype=torch.bfloat16,
                           requires_grad=True) for h in (cfg.n_heads, cfg.n_kv_heads,
                                                         cfg.n_kv_heads))
    out = attention(q, k, v, causal=True, impl="ref")
    dy = torch.randn_like(out)
    fwd_ms = event_ms(lambda: attention(q, k, v, causal=True, impl="ref"), 5)
    bwd_ms = event_ms(lambda: torch.autograd.grad(out, (q, k, v), dy, retain_graph=True), 5)
    del q, k, v, out, dy
    attn_ms = cfg.n_layers * (2 * fwd_ms + bwd_ms)
    gemm_ms = sum(ms for name, ms in prof["by_kernel_ms"].items()
                  if any(w in name.lower() for w in ("gemm", "xmma", "cutlass", "nvjet",
                                                      "cublas")))
    busy = prof["busy_ms"]
    print(f"train breakdown busy_s={busy / 1e3:.4f} optimizer_s={opt_ms / 1e3:.4f} "
          f"attention_ref_s={attn_ms / 1e3:.4f} (a layer: forward {fwd_ms:.3f} ms, "
          f"backward {bwd_ms:.3f} ms, x{cfg.n_layers} layers, forward twice) "
          f"gemm_kernels_s={gemm_ms / 1e3:.4f} rest_s={(busy - opt_ms - attn_ms) / 1e3:.4f} "
          f"card={CARD}")


def train_grads(torch, cfg, params, tokens):
    """(loss, gradient tree) of ``loss_fn`` in f32 on ``params``' device."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten
    dev = tree_leaves(params)[0].device
    loss, _ = T.loss_fn(params, cfg, {"tokens": torch.from_numpy(tokens).to(dev)},
                        compute_dtype=torch.float32)
    return loss.detach(), tree_unflatten(params, list(torch.autograd.grad(
        loss, tree_leaves(params))))


def train_card_against_cpu(torch):
    """The model cut to ``TRAIN_CHECK_LAYERS`` layers at full width, f32
    compute: one batch's loss, gnorm and gradients on the card against the
    same step on the CPU, then AdamW from the card's gradients on both.
    Returns the card's gradients (for the compression check)."""
    from repro_torch.config import get_config
    from repro_torch.data.pipeline import DataConfig, LMDataPipeline
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update, global_norm
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CHECK_LAYERS)
    card = T.trainable(T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(1),
                                     device=DEVICE, dtype=torch.float32))
    host = tree_map(lambda t: t.detach().cpu().requires_grad_(True), card)
    tokens = LMDataPipeline(DataConfig(cfg.vocab_size, TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH,
                                       seed=1)).global_batch_at(0)["tokens"]
    t0 = time.perf_counter()
    loss_c, grads_c = train_grads(torch, cfg, card, tokens)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_h, grads_h = train_grads(torch, cfg, host, tokens)
    cpu_s = time.perf_counter() - t0
    gn_c, gn_h = float(global_norm(grads_c)), float(global_norm(grads_h))
    loss_err = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    gnorm_err = abs(gn_c - gn_h) / gn_h
    check(loss_err <= TRAIN_LOSS_TOL, f"train card vs cpu: loss {float(loss_c)} vs "
          f"{float(loss_h)}")
    check(gnorm_err <= TRAIN_GNORM_TOL, f"train card vs cpu: gnorm {gn_c} vs {gn_h}")
    grad_err = train_close(torch, "card vs cpu gradients", train_flat(grads_c),
                           train_flat(grads_h), TRAIN_GRAD_TOL)
    opt = OptConfig(**TRAIN_OPT)
    same = tree_map(lambda g: g.cpu(), grads_c)
    new_c, opt_c, _ = adamw_update(grads_c, adamw_init(card), card, opt)
    new_h, opt_h, _ = adamw_update(same, adamw_init(host), host, opt)
    upd_err = max(train_close(torch, f"card vs cpu AdamW {name}", train_flat(a),
                              train_flat(b), TRAIN_UPDATE_TOL)
                  for name, a, b in (("params", new_c, new_h), ("m", opt_c["m"], opt_h["m"]),
                                     ("v", opt_c["v"], opt_h["v"])))
    print(f"train card_vs_cpu arch={cfg.name} layers={cfg.n_layers} batch={TRAIN_CHECK_BATCH}x"
          f"{TRAIN_CHECK_SEQ} f32 loss={float(loss_c):.6f}/{float(loss_h):.6f} "
          f"loss_rel_err={loss_err:.3e} (tol {TRAIN_LOSS_TOL}) gnorm={gn_c:.6f}/{gn_h:.6f} "
          f"gnorm_rel_err={gnorm_err:.3e} (tol {TRAIN_GNORM_TOL}) "
          f"worst_grad_err_over_scale={grad_err:.3e} (tol {TRAIN_GRAD_TOL}) "
          f"worst_adamw_err_over_scale={upd_err:.3e} (tol {TRAIN_UPDATE_TOL}) "
          f"card_s={card_s:.2f} cpu_s={cpu_s:.2f}")
    return grads_c


def train_moe_layer(torch):
    """One MoE layer at ``TRAIN_MOE_ARCH``'s full width through the
    capacity path (``apply_moe(mode="train")`` plus the router aux loss),
    f32, forward and backward on the card against the CPU at
    ``TRAIN_MOE_TOKENS`` tokens: the routing equal, the loss within
    ``TRAIN_LOSS_TOL``, the output and every gradient (router, the three
    expert banks, x) within ``TRAIN_GRAD_TOL`` of its scale."""
    from repro_torch.config import get_config
    from repro_torch.models import moe as MoE
    cfg = get_config(TRAIN_MOE_ARCH)
    g = torch.Generator(device=DEVICE).manual_seed(2)
    bank = MoE.init_moe(g, cfg, repeats=1, dtype=torch.float32, device=DEVICE)
    card = {"router": bank["router"][0].clone(),
            "experts": {k: v[0].clone() for k, v in bank["experts"].items()}}
    del bank
    x_c = torch.randn((1, TRAIN_MOE_TOKENS, cfg.d_model), generator=g, device=DEVICE)
    w_c = torch.randn((1, TRAIN_MOE_TOKENS, cfg.d_model), generator=g, device=DEVICE)

    def run(p, x, w):
        leaves = [p["router"], *p["experts"].values(), x]
        for t in leaves:
            t.requires_grad_(True)
        y = MoE.apply_moe(p, x, cfg, mode="train")
        loss = (y * w).sum() + MoE.router_aux_loss(p, x, cfg)
        grads = torch.autograd.grad(loss, leaves)
        names = ["router", *(f"experts/{k}" for k in p["experts"]), "x"]
        return loss.detach(), y.detach(), dict(zip(names, grads))
    host = {"router": card["router"].cpu(), "experts": {k: v.cpu() for k, v in
                                                        card["experts"].items()}}
    x_h, w_h = x_c.cpu(), w_c.cpu()
    with torch.no_grad():
        gates_c, idx_c = MoE.route(card, x_c, cfg)
        gates_h, idx_h = MoE.route(host, x_h, cfg)
        probs = torch.softmax(x_h.float() @ host["router"], dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        margin = float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min())
    check(torch.equal(idx_c.cpu(), idx_h), f"train moe: the card routes otherwise than the "
          f"CPU (smallest top-{cfg.top_k} margin {margin:.3e})")
    C = MoE._capacity(TRAIN_MOE_TOKENS, cfg)
    _, _, _, keep, _ = MoE._dispatch(x_h, gates_h, idx_h, cfg.n_experts, C)
    t0 = time.perf_counter()
    loss_c, y_c, g_c = run(card, x_c, w_c)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    loss_h, y_h, g_h = run(host, x_h, w_h)
    loss_err = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    check(loss_err <= TRAIN_LOSS_TOL, f"train moe: loss {float(loss_c)} vs {float(loss_h)}")
    y_err = train_close(torch, "moe output", {"y": y_c}, {"y": y_h}, TRAIN_GRAD_TOL)
    grad_err = train_close(torch, "moe gradients", g_c, g_h, TRAIN_GRAD_TOL)
    print(f"train moe arch={cfg.name} d_model={cfg.d_model} experts={cfg.n_experts} "
          f"top_k={cfg.top_k} d_ff_expert={cfg.d_ff_expert} tokens={TRAIN_MOE_TOKENS} "
          f"capacity={C} dropped_pairs={int((~keep).sum())}/{keep.numel()} f32 "
          f"top_k_margin={margin:.3e} loss_rel_err={loss_err:.3e} "
          f"output_err_over_scale={y_err:.3e} worst_grad_err_over_scale={grad_err:.3e} "
          f"(tol {TRAIN_GRAD_TOL}) card_s={card_s:.2f}")
    del card, g_c, y_c, x_c, w_c
    collect(torch)


def train_resume(torch):
    """The model cut to ``TRAIN_CHECK_LAYERS`` layers trained 2 steps and
    saved; a new ``Trainer`` restores it (parameters, moments, count and
    data state bit for bit the saved ones); then both take 2 more steps,
    whose losses and parameters must be equal bit for bit.  Deterministic
    algorithms are on for this check only (the embedding's backward sums
    with atomics otherwise)."""
    from repro_torch.config import ShapeSpec, get_config
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CHECK_LAYERS)
    shape = ShapeSpec("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    free_gb = shutil.disk_usage(path).free / 1e9
    deterministic = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        def trainer(seed):
            return Trainer(cfg, shape, opt_cfg=OptConfig(**TRAIN_OPT),
                           tcfg=TrainerConfig(ckpt_dir=path, ckpt_every=0, remat=True),
                           seed=seed, device=DEVICE)
        a = trainer(3)
        a.run(2)
        t0 = time.perf_counter()
        a.save()
        save_s = time.perf_counter() - t0
        ckpt_gb = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path)
                      for f in fs) / 1e9
        t0 = time.perf_counter()
        b = trainer(3)          # restores: its state (not its init) must equal a's
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(b.step == a.step == 2, f"train resume: restored at step {b.step}")
        check(b.pipeline.state.to_dict() == a.pipeline.state.to_dict(),
              "train resume: data state differs")
        saved = train_flat({"params": a.params, "opt": a.opt_state})
        restored = train_flat({"params": b.params, "opt": b.opt_state})
        check(set(saved) == set(restored), "train resume: leaves differ")
        bad = [k for k, v in saved.items() if not (v.dtype == restored[k].dtype
                                                   and torch.equal(v, restored[k]))]
        check(not bad, f"train resume: restored leaves differ from the saved: {bad[:5]}")
        la = [m["loss"] for m in a.run(2)]
        lb = [m["loss"] for m in b.run(2)]
        check(la == lb, f"train resume: continued losses {lb} vs uninterrupted {la}")
        after_a, after_b = train_flat(a.params), train_flat(b.params)
        moved = [k for k in after_a if not torch.equal(after_a[k], after_b[k])]
        check(not moved, f"train resume: continued parameters differ: {moved[:5]}")
        print(f"train resume arch={cfg.name} layers={cfg.n_layers} saved_at_step=2 "
              f"ckpt_gb={ckpt_gb:.3f} save_s={save_s:.2f} restore_s={restore_s:.2f} "
              f"free_gb={free_gb:.1f} restored_leaves_bit_for_bit={len(saved)} "
              f"continued_losses={json.dumps(lb)} equal_bit_for_bit=True (deterministic "
              f"algorithms)")
    finally:
        torch.use_deterministic_algorithms(deterministic)
        shutil.rmtree(path, ignore_errors=True)
    del a, b
    collect(torch)


def train_compression(torch, grads):
    """The int8 codes and f32 scales that ``compress_decompress`` sends for
    the card's gradients against those of the same call on their CPU copy,
    bit for bit, and the round trip's residuals finite; ``compressed_bytes``
    about 4x below f32."""
    from repro_torch.training.compression import (_quant_leaf, compress_decompress,
                                                  compressed_bytes)
    from repro_torch.tree import tree_leaves
    for key, g in train_flat(grads).items():
        q_c, s_c = _quant_leaf(g)
        q_h, s_h = _quant_leaf(g.cpu())
        check(torch.equal(q_c.cpu(), q_h) and torch.equal(s_c.cpu(), s_h),
              f"train compression: codes or scales of {key} differ")
    _, err = compress_decompress(grads)
    check(all(bool(torch.isfinite(e).all()) for e in tree_leaves(err)),
          "train compression: a residual is not finite")
    n = sum(g.numel() for g in tree_leaves(grads))
    wire = compressed_bytes(grads)
    ratio = 4 * n / wire
    check(3.9 < ratio <= 4.0, f"train compression: {ratio:.3f}x below f32")
    print(f"train compression leaves={len(tree_leaves(grads))} values={n} "
          f"wire_bytes={wire} f32_bytes={4 * n} ratio={ratio:.4f} codes_equal=True")


def run_train(torch, by_run):
    """Phase train: once every earlier model is freed, the port's training
    path on the card (it runs no kernel of the port: the reference trains
    on its attention oracle, and the step is checked to launch none)."""
    collect(torch)
    t_phase = time.perf_counter()
    before = torch.cuda.memory_allocated() / 2**30
    print(f"train memory_allocated_before_build_gib={before:.3f} bound_gib={MOE_FREE_BEFORE_GIB}")
    check(before < MOE_FREE_BEFORE_GIB, f"train: {before:.2f} GiB still allocated")
    reset_launches()
    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = round(time.perf_counter() - t0, 1)
        return out
    part("full", train_full, torch)
    by_run["train"] = read_launches()
    check(not any(by_run["train"].values()),
          f"train: the training path launched a kernel of the port: {by_run['train']}")
    grads = part("card_vs_cpu", train_card_against_cpu, torch)
    part("compression", train_compression, torch, grads)
    del grads
    collect(torch)
    part("moe", train_moe_layer, torch)
    part("resume", train_resume, torch)
    print(f"phase train done in {time.perf_counter() - t_phase:.1f} s: {json.dumps(parts)}")


# ---------------------------------------------------------------------------
# phase mesh
# ---------------------------------------------------------------------------

def mesh_init(torch):
    """A one-rank NCCL process group from a ``FileStore`` under the
    checkout's ``build/`` (no network), and ``small_mesh(1, 1)`` on the
    card."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import small_mesh
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    kind = torch.device(DEVICE).type
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"file://{root}/store", rank=0, world_size=1)
    return small_mesh(1, 1, device_type=kind)


def mesh_serving(torch, mesh, by_run):
    """Full-width qwen2.5-3b served through the mesh at fp and w8kv8 (the
    engine phase's 16 requests, replayed): the engine phase's streams bit
    for bit and its launches, a kernel at a time; the planned replayed
    decode step's wall and busy time beside the one without a mesh; a
    snapshot mid-drain restored onto the mesh, drained to the
    uninterrupted run's streams."""
    from repro_torch.config import get_config
    from repro_torch.kernels.launches import counters as launch_counters
    arch = "qwen2.5-3b"
    cfg = get_config(arch)
    params = make_params(torch, cfg)
    kv_len = SERVED[arch]["kv_len"]
    for run in MESH_RUNS:
        # the engine phase warmed this model's kernels and handles
        r = run_engine(torch, cfg, params, run, kv_len=kv_len, mesh=mesh, warm=False)
        by_run[f"{arch} {run} mesh"] = r["launches"]
        want = ENGINE_RUNS[(arch, run)]
        check(r["outputs"] == want["outputs"],
              f"mesh {run}: streams differ from the engine phase's")
        check(r["launches"] == want["launches"],
              f"mesh {run}: launches {r['launches']} != {want['launches']}")
        for name in ("qmatmul", "prefill", "decode", "decode_quant"):
            check(r["kernels"][name] == want["kernels"][name],
                  f"mesh {run}: {name} kernels differ from the engine phase's")
        check(not any(launch_counters()["grouped_matmul"].values()),
              f"mesh {run}: the grouped matmul ran")
        # beside the replayed decode step phase graphs profiled without a mesh
        a = PROFILES[(arch, run)]["decode_step"]
        b = run_profile(torch, cfg, params, run, kv_len=kv_len, chunk_steps=0,
                        mesh=mesh)["decode_step"]
        print(f"mesh parallel arch={arch} run={run} streams_equal=True launches_equal=True "
              f"decode_step_wall_ms={b['wall_ms']:.3f} decode_step_busy_ms={b['busy_ms']:.3f} "
              f"plain_wall_ms={a['wall_ms']:.3f} plain_busy_ms={a['busy_ms']:.3f} "
              f"kernels_per_step={b['kernels_per_step']:.0f} "
              f"plain_kernels_per_step={a['kernels_per_step']:.0f} card={CARD}")
        collect(torch)
    mesh_spec(torch, cfg, params, mesh, by_run)
    reset_launches()
    crash_case(torch, cfg, params, "fp", kv_len, "mid_decode", mesh=mesh)
    by_run[f"{arch} crash mesh"] = read_launches()
    del params
    collect(torch)


def mesh_spec(torch, cfg, params, mesh, by_run):
    """Phase spec's drain with the 8-bit self-draft (``MESH_SPEC``) through
    the mesh, replayed (the spec step the fourth captured graph): its
    streams, launches and kernels those of phase spec's mesh-less replayed
    drain.  Through the eager methods the planned spec step spends ~2.8 s
    of host dispatch a step at 36 layers (78.3 s a drain), so the eager drain
    runs the model cut to ``MESH_SPEC_EAGER_LAYERS`` layers, against the
    mesh-less replayed drain of the same cut."""
    run, draft = MESH_SPEC
    kv_len = SERVED[cfg.name]["kv_len"]
    paths = dict(spec_k=SPEC_K, spec_draft_bits=8)
    cut = dataclasses.replace(cfg, n_layers=MESH_SPEC_EAGER_LAYERS)
    cut_params = make_params(torch, cut)
    for eager in (False, True):
        model, weights = (cut, cut_params) if eager else (cfg, params)
        want = SPEC_RECORDS[(cfg.name, run, draft)] if not eager else run_engine(
            torch, cut, cut_params, run, kv_len=kv_len, **paths)
        r = run_engine(torch, model, weights, run, kv_len=kv_len, mesh=mesh, warm=False,
                       eager=eager, **paths)
        label = f"{cfg.name} {run} spec {draft}{' eager' if eager else ''} mesh"
        if eager:
            by_run[f"{cfg.name} {run} spec {draft} {model.n_layers} layers"] = want["launches"]
        by_run[label] = r["launches"]
        check(r["outputs"] == want["outputs"], f"{label}: streams differ from the mesh-less run's")
        check(r["launches"] == want["launches"],
              f"{label}: launches {r['launches']} != {want['launches']}")
        for name in ("qmatmul", "prefill", "decode", "decode_quant"):
            check(r["kernels"][name] == want["kernels"][name],
                  f"{label}: {name} kernels differ from the mesh-less run's")
        st = r["stats"]
        print(f"mesh spec arch={cfg.name} layers={model.n_layers} run={run} draft={draft} "
              f"eager={eager} streams_equal=True launches_equal=True "
              f"spec_steps={st['spec_steps']} acceptance={st['spec_acceptance']:.4f} "
              f"tokens_per_s={st['tokens_per_s']:.2f} "
              f"plain_tokens_per_s={want['stats']['tokens_per_s']:.2f} "
              f"wall_s={r['wall_s']:.3f} plain_wall_s={want['wall_s']:.3f} card={CARD}")
        collect(torch)
    del cut_params
    collect(torch)


def mesh_moe(torch, mesh, by_run):
    """qwen3-moe-30b-a3b at full width, its depth cut to ``MESH_MOE_LAYERS``,
    served through the mesh: gshard in each padded prefill, the capacity
    path in the replayed decode step, attention through decode.cu and
    prefill.cu behind local_map and no grouped matmul; every request its
    budget.  With the capacity raised until nothing drops, a planned
    prefill's logits the one-device gshard prefill's bit for bit; in f32
    the dropless prefill's within 1e-4 of their scale; in bf16, with the
    dropless prefill's expert choices imposed (each choice the gshard
    router would make otherwise a near-tie), within ``run_logits``' bound
    of the dropless prefill's; and one layer on its own, one routing, in
    bf16 as near the f32 layer as the dropless kernels."""
    from repro_torch.config import get_config
    from repro_torch.kernels.launches import counters as launch_counters
    from repro_torch.models import transformer as T
    from repro_torch.parallel.api import activate_plan, full
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MESH_MOE_LAYERS)
    params = make_params(torch, cfg)
    ecfg = EngineConfig(max_batch=MAX_BATCH, kv_len=MOE_KV_LEN, prefill_chunk=CHUNK,
                        max_new_tokens=NEW_TOKENS, impl="flash")
    engine = ServingEngine(cfg, params, ecfg, device=DEVICE, mesh=mesh)
    graphs = engine.executor.graphs
    check(graphs is not None and sorted(graphs.graphs) == ["fused_step"],
          "mesh moe: the fused step was not captured")
    prompts, _ = crash_workload(cfg)
    reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    by_run[f"{MOE_ARCH} mesh"] = launches
    attn = {k: v.copy() for k, v in launch_counters().items()
            if k in ("prefill", "decode")}
    st = engine.stats()
    outs = [r.output for r in engine.finished]
    check(st["finished"] == len(prompts) and all(len(o) == NEW_TOKENS for o in outs),
          f"mesh moe: {st['finished']} of {len(prompts)} finished with their budgets")
    n_attn = attention_layers(cfg)
    check(launches["flash_prefill"] == st["prefill_calls"] * n_attn,
          f"mesh moe: prefill launches {launches['flash_prefill']}")
    check(launches["flash_decode"] > 0 and launches["flash_decode"] % n_attn == 0,
          f"mesh moe: decode launches {launches['flash_decode']}")
    check(not any(launches[k] for k in ("grouped_matmul", "grouped_gate_up", "combine")),
          f"mesh moe: the grouped matmul ran under the plan: {launches}")
    check_attention_checked("mesh moe prefill", attn["prefill"], CHECKED_PREFILL)
    check_attention_checked("mesh moe decode", attn["decode"], CHECKED_DECODE)
    print(f"mesh moe arch={cfg.name} layers={cfg.n_layers} finished={st['finished']} "
          f"tokens={st['tokens']} decode_steps={st['decode_steps']} "
          f"prefill_calls={st['prefill_calls']} wall_s={wall:.3f} "
          f"launches={json.dumps(launches)} card={CARD}")
    plan, engine_ctx = engine.executor._plan, engine.executor.shard_ctx
    planned = engine.executor.params
    del engine
    collect(torch)
    # nothing dropped: every token fits its experts (capacity = the group)
    wide = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)).to(DEVICE)
    kw = dict(kv_cap=256, length=200)
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.api import AbstractMesh, Plan
    from repro_torch.tree import tree_map
    # the same weights in f32 (the expert path's kernels take the banks in
    # x's dtype), planned as the bf16 ones
    params32 = T.Transformer(wide, tree_map(lambda t: t.float(), T.param_tree(params)))
    planned32 = SH.distribute_params(params32, engine_ctx)
    f32 = dict(compute_dtype=torch.float32, **kw)
    mesh_moe_layer(torch, wide, params, params32)
    routing = ForcedRouting()
    with torch.no_grad():
        with activate_plan(plan):
            got = full(T.prefill(planned, wide, tokens, **kw)[0]).float()
            got32 = full(T.prefill(planned32, wide, tokens, **f32)[0]).float()
        with activate_plan(Plan(AbstractMesh((1, 1), ("data", "model")), {})):
            alone = T.prefill(params, wide, tokens, **kw)[0].float()
        want32 = T.prefill(params32, wide, tokens, **f32)[0].float()
        # the dropless prefill's expert choices imposed on the planned
        # gshard prefill, as phase moe imposes the oracle's on the kernels':
        # a near-tie swapped by a last-bit difference moves a whole expert
        with routing.installed(torch):
            routing.mode = "record"
            want = T.prefill(params, wide, tokens, **kw)[0].float()
            routing.mode, routing.queue = "force", routing.recorded
            with activate_plan(plan):
                forced = full(T.prefill(planned, wide, tokens, **kw)[0]).float()
    del params32, planned32
    # the plan changes no value: the planned gshard prefill is the one-device
    # gshard prefill bit for bit; with nothing dropped gshard computes the
    # dropless layer's function: their f32 logits agree to f32 sums'
    # reordering, and in bf16 under one routing within run_logits' bound
    scale = float(want32.abs().max())
    d32 = float((got32 - want32).abs().max())
    d16 = float((forced - want).abs().max())
    limit = 5e-2 * max(1.0, float(want.abs().max()))
    d_gs, d_dl = (float((a - want32).abs().max()) for a in (got, want))
    gap = max(routing.gaps, default=0.0)
    print(f"mesh moe logits planned_equals_one_device_gshard={torch.equal(got, alone)} "
          f"f32_gshard_vs_dropless={d32:.3e} bound={1e-4 * max(1.0, scale):.3e} "
          f"bf16_gshard_vs_dropless_one_routing={d16:.4f} bf16_bound={limit:.4f} "
          f"own_choice_differs={routing.swapped} of {routing.tokens} largest_gap={gap:.4f} "
          f"near_tie={NEAR_TIE} own_routing: bf16_gshard_vs_dropless="
          f"{float((got - want).abs().max()):.4f} bf16_gshard_vs_f32={d_gs:.4f} "
          f"bf16_dropless_vs_f32={d_dl:.4f} scale={scale:.4f} "
          f"finite={bool(torch.isfinite(got).all())} card={CARD}")
    check(bool(torch.isfinite(got).all()) and torch.equal(got, alone),
          "mesh moe: the planned gshard prefill differs from the one-device gshard prefill")
    check(d32 <= 1e-4 * max(1.0, scale),
          f"mesh moe: f32 gshard logits {d32:.3e} from the dropless ones")
    check(routing.at == len(routing.queue) == sum(wide.moe_layer_mask()) and routing.tokens > 0,
          f"mesh moe: {routing.at} forced calls of {len(routing.queue)} recorded")
    check(gap <= NEAR_TIE, f"mesh moe: the gshard router would choose other experts "
          f"{gap:.4f} of its logits' scale apart, not a near-tie")
    check(d16 <= limit, f"mesh moe: bf16 gshard logits {d16:.4f} from the dropless ones "
          f"under one routing (bound {limit:.4f})")
    del params, planned
    collect(torch)


def mesh_moe_layer(torch, cfg, params, params32):
    """The first MoE layer at full width on one bf16 x (1, 256, D) of unit
    scale, one routing: gshard (one group) and the dropless kernels in
    bf16, each against the dropless layer in f32.  The CPU tests find the
    reference's two layers part from f32 alike; so must the port's here,
    the bf16 gshard within ``TOL`` of the scale and twice the dropless
    layer's distance."""
    from repro_torch.models import moe as MT
    from repro_torch.models import transformer as T
    g = next(i for i, grp in enumerate(params["stack"]) if "moe" in grp["u0"])
    p16, p32 = (T._layer(p["stack"][g]["u0"]["moe"], 0) for p in (params, params32))
    x = torch.randn((1, 256, cfg.d_model), generator=torch.Generator(device=DEVICE).manual_seed(5),
                    device=DEVICE).bfloat16()
    with torch.no_grad():
        gates, idx = MT.route(p16, x, cfg)
        gates32, idx32 = MT.route(p32, x.float(), cfg)
        check(torch.equal(idx, idx32), "mesh moe layer: bf16 and f32 routings differ")
        want = MT._apply_dropless(p32, x.float(), gates32, idx32, cfg)
        d = {name: float((fn(p16, x, gates, idx, cfg).float() - want).abs().max())
             for name, fn in (("gshard", MT._apply_gshard), ("dropless", MT._apply_dropless))}
        d["gshard_f32"] = float((MT._apply_gshard(p32, x.float(), gates32, idx32, cfg) - want)
                                .abs().max())
    scale = float(want.abs().max())
    print(f"mesh moe layer d_model={cfg.d_model} experts={cfg.n_experts} top_k={cfg.top_k} "
          f"tokens=256 scale={scale:.4f} bf16_gshard_vs_f32={d['gshard']:.4e} "
          f"bf16_dropless_vs_f32={d['dropless']:.4e} f32_gshard_vs_f32={d['gshard_f32']:.3e} "
          f"card={CARD}")
    check(d["gshard"] <= TOL["torch.bfloat16"] * max(1.0, scale),
          f"mesh moe layer: bf16 gshard {d['gshard']:.3e} from f32 (scale {scale:.4f})")
    check(d["gshard_f32"] <= 1e-4 * max(1.0, scale),
          f"mesh moe layer: f32 gshard {d['gshard_f32']:.3e} from f32 dropless")
    check(d["gshard"] <= 2 * d["dropless"], f"mesh moe layer: bf16 gshard {d['gshard']:.3e} "
          f"from f32, the dropless layer {d['dropless']:.3e}")


def mesh_overlap(torch, mesh):
    """The ring collective matmuls on the one-rank mesh against their
    oracles (qwen2.5-3b's MLP shapes, bf16)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.parallel import overlap as O
    g = torch.Generator(device=DEVICE).manual_seed(0)
    for name, fn, ref, xp, wp, k, n in (
            ("allgather_matmul", O.allgather_matmul, O.allgather_matmul_ref, Shard(0),
             Replicate(), 2048, 11008),
            ("reduce_scatter_matmul", O.reduce_scatter_matmul, O.reduce_scatter_matmul_ref,
             Shard(1), Shard(0), 11008, 2048)):
        x = torch.randn(512, k, generator=g, device=DEVICE, dtype=torch.bfloat16)
        w = torch.randn(k, n, generator=g, device=DEVICE, dtype=torch.bfloat16) / k ** 0.5
        y = fn(distribute_tensor(x, mesh, (Replicate(), xp), src_data_rank=None),
               distribute_tensor(w, mesh, (Replicate(), wp), src_data_rank=None), mesh)
        want = ref(x, w).float()
        err = float((y.full_tensor().float() - want).abs().max()) / float(want.abs().max())
        print(f"mesh overlap {name} m=512 k={k} n={n} max_err_over_scale={err:.3e}")
        check(err < TOL["torch.bfloat16"], f"mesh overlap {name}: off by {err:.3e}")


def mesh_train(torch, mesh):
    """Two steps of ``Trainer(mesh=)`` on full-width qwen2.5-3b, as phase
    train's: each loss within ``MESH_TRAIN_TOL`` relative of its first two."""
    from repro_torch.config import ShapeSpec, get_config
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, ShapeSpec("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH), mesh,
                      opt_cfg=OptConfig(**TRAIN_OPT), tcfg=TrainerConfig(remat=True),
                      seed=0, device=DEVICE)
    ms = trainer.run(2)
    losses = [m["loss"] for m in ms]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, TRAIN_LOSSES[:2])]
    print(f"mesh train losses={json.dumps(losses)} phase_train={json.dumps(TRAIN_LOSSES[:2])} "
          f"rel_err={json.dumps(errs)} step_s={json.dumps([round(m['dt'], 4) for m in ms])} "
          f"peak_memory_gib={torch.cuda.max_memory_allocated() / 2**30:.2f} card={CARD}")
    check(len(TRAIN_LOSSES) >= 2 and max(errs) <= MESH_TRAIN_TOL,
          f"mesh train: losses {losses} against {TRAIN_LOSSES[:2]}")
    del trainer
    collect(torch)


def run_mesh(torch, by_run):
    """Phase mesh: the parallel plane (``repro_torch.parallel``) on a
    one-rank NCCL mesh, once phase train's state is freed."""
    import torch.distributed as dist
    collect(torch)
    t_phase = time.perf_counter()
    before = torch.cuda.memory_allocated() / 2**30
    check(before < MOE_FREE_BEFORE_GIB, f"mesh: {before:.2f} GiB still allocated")
    mesh = mesh_init(torch)
    parts = {}
    for name, fn, args in (("serving", mesh_serving, (torch, mesh, by_run)),
                           ("moe", mesh_moe, (torch, mesh, by_run)),
                           ("overlap", mesh_overlap, (torch, mesh)),
                           ("train", mesh_train, (torch, mesh))):
        t0 = time.perf_counter()
        fn(*args)
        parts[name] = round(time.perf_counter() - t0, 1)
    dist.destroy_process_group()
    print(f"phase mesh done in {time.perf_counter() - t_phase:.1f} s: {json.dumps(parts)}")


# ---------------------------------------------------------------------------
# phase examples
# ---------------------------------------------------------------------------

def start_example(root, name, *args):
    """``examples/<name>_torch.py`` in a process of its own, on the card (its
    default; ``--device cpu`` where ``DEVICE`` is the CPU, but for the NoI
    walkthrough, which runs numpy alone), its output into a log under
    ``root``.  Returns (name, process, log path, start time)."""
    script = os.path.join(os.path.dirname(SRC), "examples", f"{name}_torch.py")
    device = ("--device", "cpu") if DEVICE == "cpu" and name != "noi_design" else ()
    log = os.path.join(root, f"{name}{len(os.listdir(root))}.txt")
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, script, *map(str, args), *device],
                                stdout=out, stderr=subprocess.STDOUT, cwd=root,
                                env=dict(os.environ, PYTHONPATH=SRC))
    return name, proc, log, time.perf_counter()


def finish_example(started):
    """Wait for an example's process (its time limit counted from its
    start); it must exit 0.  Returns its output."""
    name, proc, log, t0 = started
    try:
        rc = proc.wait(timeout=max(EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    with open(log) as f:
        out = f.read()
    print(f"examples {name} rc={rc} s={time.perf_counter() - t0:.1f}")
    check(rc == 0, f"examples: {name} exited {rc}: {out[-3000:]}")
    return out


def example_lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def run_examples(torch):
    """Phase examples: the four example scripts of the port run on the card
    as a user runs them, each checked by what it prints."""
    collect(torch)
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(SRC), "build", "examples")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ckpt = os.path.join(root, "train_ckpt")
    train = ("train_lm", "--tiny", "--ckpt-dir", ckpt, "--steps")
    running = [start_example(root, "quickstart"), start_example(root, "serve_e2e"),
               start_example(root, "noi_design"), start_example(root, *train,
                                                                EXAMPLE_TRAIN_STEPS[0])]
    try:
        quick, serve, noi, first = (finish_example(r) for r in running[:4])
        running.append(start_example(root, *train, EXAMPLE_TRAIN_STEPS[1]))
        second = finish_example(running[-1])
    finally:
        for _, proc, _, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for ln in quick.splitlines():
        print(f"examples quickstart | {ln}")
    planes = example_lines(quick, "[plane ")
    check(len(example_lines(quick, "  ")) >= 3 and len(planes) == 3,
          f"examples: quickstart printed {quick[-2000:]}")
    attn = example_lines(quick, "[kernels] flash attention")
    pim = example_lines(quick, "[kernels] PIM-MVM int8-crossbar kernel rel err vs plain")
    attn_err = float(attn[0].split()[-1]) if attn else float("nan")
    pim_err = float(pim[0].split()[-1].rstrip("%")) / 100 if pim else float("nan")
    if DEVICE != "cpu":
        check(len(attn) == 1 and "vs plain version" in attn[0]
              and attn_err <= TOL["torch.float32"],
              f"examples: quickstart's prefill kernel against its plain version: {attn}")
        check(len(pim) == 1 and pim_err <= MATMUL_TOL["torch.float32"],
              f"examples: quickstart's crossbar kernel against its plain version: {pim}")
    print(f"examples serve_e2e | {serve.strip().splitlines()[-1]}")
    check(serve.rstrip().endswith("incremental-vs-teacher-forced greedy decode: MATCH"),
          f"examples: serve_e2e printed {serve[-2000:]}")
    check("min-EDP design" in noi and "3D-HI stack peak temp" in noi,
          f"examples: noi_design printed {noi[-2000:]}")
    done = [example_lines(out, "done: loss") for out in (first, second)]
    resumed = f"resumed from checkpoint at step {EXAMPLE_TRAIN_STEPS[0]}"
    check(all(len(d) == 1 for d in done) and resumed in second and resumed not in first,
          f"examples: train_lm printed {first[-1500:]} then {second[-1500:]}")
    losses = [[float(x) for x in d[0].split()[2:5:2]] for d in done]
    print(f"examples train_lm first_run={losses[0]} resumed_run={losses[1]}")
    check(losses[1][1] < losses[0][0],
          f"examples: train_lm's loss did not fall: {losses[0]} then {losses[1]}")
    print(f"phase examples done in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase roofline
# ---------------------------------------------------------------------------

def start_dryrun():
    """The dry run of one cell (``ROOFLINE_DRYRUN``) in a process of its own,
    into a fresh directory under ``build/``: it needs the CPU alone, so it
    runs beside the card's phases.  Returns (process, its log path)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dryrun")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    log = os.path.join(root, "log.txt")
    arch, shape, mesh = ROOFLINE_DRYRUN
    env = dict(os.environ, REPRO_TORCH_DRYRUN_DIR=root, PYTHONPATH=SRC)
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--force"], stdout=out, stderr=subprocess.STDOUT,
            env=env, cwd=root)
    return proc, log


def roofline_steps(torch, cfg):
    """The three steps of the phase on full-width ``cfg`` (``impl="ref"``):
    name -> (step, shape, a function making its arguments on ``device``).
    The decode step reads 8 rows over a cache of ``ROOFLINE_KV`` entries
    at position ``ROOFLINE_KV - 24``; the train step is phase train's
    (f32 master weights, remat), without the trainer's pipeline."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import OptConfig, adamw_init
    from repro_torch.tree import tree_map
    B, S = ROOFLINE_BATCH, ROOFLINE_KV
    i32 = torch.int32

    def weights(dtype, device):
        # N(0, 0.02) in every leaf: the counts read shapes, the timing data
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
                        .normal_(0.0, 0.02), ST.params_specs(cfg, dtype))

    def decode_args(device):
        return (weights(torch.bfloat16, device),
                T.init_cache(cfg, B, S, dtype=torch.bfloat16, device=device),
                torch.zeros(B, dtype=i32, device=device),
                torch.full((B,), S - 24, dtype=i32, device=device))

    def prefill_args(device):
        return (weights(torch.bfloat16, device),
                {"tokens": torch.zeros((B, S), dtype=i32, device=device)})

    def train_args(device):
        params = tree_map(lambda t: t.requires_grad_(True), weights(torch.float32, device))
        return (params, adamw_init(params),
                {"tokens": torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=i32, device=device)})
    return {
        "decode": (ST.make_decode_step(cfg, impl="ref"), ShapeSpec("decode", "decode", S, B),
                   decode_args),
        "prefill": (ST.make_prefill_step(cfg, impl="ref", kv_cap=S),
                    ShapeSpec("prefill", "prefill", S, B), prefill_args),
        "train": (ST.make_train_step(cfg, opt_cfg=OptConfig(**TRAIN_OPT)),
                  ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH), train_args),
    }


def roofline_step(torch, cfg, name, step, shape, make_args):
    """One step of the phase: counted, timed, its memory measured and
    predicted; the checks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import model_flops_for
    from repro_torch.roofline import analyze_step, roofline_terms
    args = make_args(DEVICE)
    cost = analyze_step(step, *args)          # on the card's tensors; warms the step
    torch.cuda.synchronize()
    # the peak from the arguments up: what else is allocated (the libraries'
    # workspaces, made by the warm-up) taken out
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - before + cost.argument_bytes
    prof = profiled(torch, cfg.name, "ref", f"roofline {name}", lambda: step(*args),
                    1 if name == "train" else 3)
    del args
    collect(torch)
    with FakeTensorMode():
        predicted = analyze_step(step, *make_args(DEVICE))
    rep = roofline_terms(cost, arch=cfg.name, shape=name, mesh_name="one card", n_devices=1,
                         model_flops=model_flops_for(cfg, shape))
    bound_ms = max(cost.flops / PEAK_FLOPS["torch.bfloat16"],
                   cost.bytes_hbm / HBM_BYTES_PER_S) * 1e3
    share = bound_ms / prof["busy_ms"]
    gap = abs(predicted.peak_bytes - card_peak)
    print(f"roofline arch={cfg.name} step={name} flops={cost.flops:.6e} "
          f"bytes={cost.bytes_hbm:.6e} n_ops={cost.n_ops} bound_ms={bound_ms:.4f} "
          f"bound_by={rep.bottleneck} busy_ms={prof['busy_ms']:.4f} "
          f"roofline_share={share:.4f} roofline_frac={rep.roofline_frac:.4f} "
          f"compute_ms={rep.compute_s * 1e3:.4f} memory_ms={rep.memory_s * 1e3:.4f} "
          f"useful_ratio={rep.useful_ratio:.4f} argument_gib={cost.argument_bytes / 2**30:.3f} "
          f"peak_gib={card_peak / 2**30:.3f} predicted_peak_gib={predicted.peak_bytes / 2**30:.3f} "
          f"peak_gap_mib={gap / 2**20:.1f} card={CARD}")
    check(prof["busy_ms"] >= 0.95 * bound_ms,
          f"roofline {name}: busy {prof['busy_ms']:.4f} ms under 0.95 of the bound "
          f"{bound_ms:.4f} ms: the count is wrong")
    check(predicted.flops == cost.flops and predicted.argument_bytes == cost.argument_bytes,
          f"roofline {name}: fake tensors count {predicted.flops} FLOPs, "
          f"{predicted.argument_bytes} argument bytes; the card's {cost.flops}, "
          f"{cost.argument_bytes}")
    check(gap <= ROOFLINE_PEAK_REL * card_peak + ROOFLINE_PEAK_ABS,
          f"roofline {name}: predicted peak {predicted.peak_bytes} B, the card's {card_peak} B")


def run_roofline(torch, by_run, dryrun):
    """Phase roofline: the three steps of full-width qwen2.5-3b counted,
    timed and their memory predicted (``roofline_step``), launching no
    kernel of the port (``impl="ref"``); then the dry run started after
    the build must have exited 0 with an ``ok`` record."""
    from repro_torch.config import get_config
    collect(torch)
    t_phase = time.perf_counter()
    before = torch.cuda.memory_allocated() / 2**30
    check(before < MOE_FREE_BEFORE_GIB, f"roofline: {before:.2f} GiB still allocated")
    from repro_torch.roofline import H100
    print(f"roofline card total_memory={torch.cuda.get_device_properties(0).total_memory} "
          f"H100.hbm_bytes={H100.hbm_bytes:.0f} card={CARD}")
    cfg = get_config(ROOFLINE_ARCH)
    reset_launches()
    parts = {}
    for name, (step, shape, make_args) in roofline_steps(torch, cfg).items():
        t0 = time.perf_counter()
        roofline_step(torch, cfg, name, step, shape, make_args)
        parts[name] = round(time.perf_counter() - t0, 1)
    by_run["roofline"] = read_launches()
    check(not any(by_run["roofline"].values()),
          f"roofline: the ref steps launched a kernel of the port: {by_run['roofline']}")
    proc, log = dryrun
    t0 = time.perf_counter()
    rc = proc.wait(timeout=ROOFLINE_DRYRUN_WAIT_S)
    with open(log) as f:
        out = f.read()
    print(f"roofline dryrun rc={rc} waited_s={time.perf_counter() - t0:.1f} "
          + " ".join(ln for ln in out.splitlines() if " OK " in ln or "ERROR" in ln))
    check(rc == 0, f"roofline: the dry run exited {rc}: {out[-2000:]}")
    arch, shape, mesh = ROOFLINE_DRYRUN
    with open(os.path.join(os.path.dirname(log), f"{arch}__{shape}__{mesh}.json")) as f:
        rec = json.load(f)
    check(rec["status"] == "ok" and rec["n_devices"] == 256,
          f"roofline: dry run record {rec['status']} on {rec.get('n_devices')} devices")
    r = rec["roofline"]
    print(f"roofline dryrun arch={arch} shape={shape} mesh={mesh} n_devices={rec['n_devices']} "
          f"t_trace_s={rec['t_trace_s']} n_ops={rec['n_ops']} "
          f"compute_s={r['compute_s']:.6e} memory_s={r['memory_s']:.6e} "
          f"collective_s={r['collective_s']:.6e} bottleneck={r['bottleneck']} "
          f"live_gib={rec['memory']['live_bytes'] / 2**30:.3f} "
          f"fits_h100={rec['memory']['fits_h100']}")
    print(f"phase roofline done in {time.perf_counter() - t_phase:.1f} s: {json.dumps(parts)}")


def make_params(torch, cfg):
    """Random bf16 weights (seed 0) on the card, after the last model's are
    freed."""
    from repro_torch.models import transformer as T
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"params: arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"{n_params} in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return params


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--crash-child"]:
        return crash_child(sys.argv[2], int(sys.argv[3]))
    sys.path.insert(0, SRC)
    from repro_torch.config import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    global CARD
    CARD = smi
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    b = build.build()
    ptxas = [ln.strip() for ln in b.log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    print(f"build: {b.seconds:.2f} s, libraries {sorted(b.libs)}")
    for ln in ptxas:
        print(f"build ptxas: {ln}")
    dryrun = start_dryrun()
    try:
        return smoke(torch, get_config, dryrun)
    finally:
        if dryrun[0].poll() is None:
            dryrun[0].kill()
            dryrun[0].wait()


def smoke(torch, get_config, dryrun):
    """The phases after the build (``dryrun``: phase roofline's process,
    started after the build)."""
    t_kernels = time.perf_counter()
    records = run_kernel_checks(torch)
    records.update(run_quant_decode_checks(torch))
    run_split_checks(torch, records)
    records.update(run_matmul_checks(torch))
    records.update(run_grouped_checks(torch))
    print(f"phase kernels done in {time.perf_counter() - t_kernels:.1f} s")

    start = time.perf_counter()

    def done(what):
        print(f"phase {what} done at {time.perf_counter() - start:.1f} s")
    by_run = {}            # launches of each main-path run, counted from 0 before it
    for arch, serve in SERVED.items():
        cfg = get_config(arch)
        if serve["layers"]:
            cfg = dataclasses.replace(cfg, n_layers=serve["layers"])
        params = make_params(torch, cfg)
        drain = dict(kv_len=serve["kv_len"], long_prompts=serve["long_prompts"])
        plain = {}
        for run in QUANT_RUNS:
            r = plain[run] = run_engine(torch, cfg, params, run, **drain)
            by_run[f"{arch} {run}"] = r["launches"]
            ENGINE_RUNS[(arch, run)] = r              # phase mesh serves them again
            run_graphs(torch, cfg, params, run, r, **drain)
            if run == "fp":
                run_baselines(torch, cfg, params, by_run, **drain)
        done(f"engine, graphs and baselines of {arch}")
        run_spec(torch, cfg, params, plain, by_run, **drain)
        done(f"spec of {arch}")
        if arch == "qwen2.5-3b":
            run_sampling(torch, cfg, params, serve["kv_len"])
            run_sampling(torch, cfg, params, serve["kv_len"], spec_k=SPEC_K, spec_draft_bits=8)
            run_slo(torch, cfg, params, plain["fp"], serve["kv_len"])
            done(f"sampling and slo of {arch}")
        reset_launches()
        crash_cfg = crash_config(cfg)
        crash_params = params if crash_cfg is cfg else make_params(torch, crash_cfg)
        run_crash(torch, crash_cfg, crash_params, **drain)
        del crash_params
        by_run[f"{arch} crash"] = read_launches()
        done(f"crash of {arch}")
        if arch == "qwen2.5-3b":
            by_run["crossbar"] = run_crossbar(torch)
        for run in ("fp", "w8kv8"):
            run_logits(torch, cfg, params, run, long_row=serve["logits_row"])
        done(f"logits of {arch}")
        for run in ("fp", "w8kv8"):
            PROFILES[(arch, run)] = run_profile(torch, cfg, params, run, kv_len=serve["kv_len"])
        del params
        print(f"phases of {arch} done at {time.perf_counter() - start:.1f} s")
    for arch, layers in LOGITS_ONLY.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        params = make_params(torch, cfg)
        for run in ("fp", "w8kv8"):
            run_logits(torch, cfg, params, run)
        del params
        print(f"phases of {arch} done at {time.perf_counter() - start:.1f} s")
    run_paper(torch, by_run)
    print(f"phases of the paper's models done at {time.perf_counter() - start:.1f} s")
    run_calib(torch, by_run)
    print(f"phase calib done at {time.perf_counter() - start:.1f} s")
    run_moe(torch, by_run)
    print(f"phases of {MOE_ARCH} done at {time.perf_counter() - start:.1f} s")
    run_recurrent(torch, by_run)
    print(f"phases of the recurrent models done at {time.perf_counter() - start:.1f} s")
    run_mla(torch, by_run)
    print(f"phases of {MLA_ARCH} done at {time.perf_counter() - start:.1f} s")
    run_cross(torch, by_run)
    print(f"phases of the cross-attention models done at {time.perf_counter() - start:.1f} s")
    run_train(torch, by_run)
    print(f"phases of training done at {time.perf_counter() - start:.1f} s")
    run_mesh(torch, by_run)
    print(f"phase mesh done at {time.perf_counter() - start:.1f} s")
    run_examples(torch)
    print(f"phase examples done at {time.perf_counter() - start:.1f} s")
    run_roofline(torch, by_run, dryrun)
    print(f"phase roofline done at {time.perf_counter() - start:.1f} s")

    for name, rec in records.items():
        rec["launches"] = sum(n[name] for n in by_run.values())
        rec["launches_by_run"] = {run: n[name] for run, n in by_run.items() if n[name]}
        check(rec["launches"] > 0, f"kernel {name} never launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: rec[k] for k in keys}, **{k: v for k, v in rec.items() if k not in keys}}
        for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
