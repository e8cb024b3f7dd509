#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent PARENT_TREE]

Phases (any failure raises, and the run exits non-zero):

1. build — compile every CUDA kernel of the port from ``src/`` with nvcc
   for sm_90a (one nvcc per source, in parallel); print the build
   seconds and the card's name, power limit and maximum SM clock;
2. kernels — each kernel against its plain PyTorch version on the card at
   the served paths' shapes: the flat and grouped gather kernels at every
   rank-0 shape of gemma-2b, mamba2-370m and gemma3-1b (dense sites,
   attn.qk / attn.pv, ssm.scan; gemma3-1b's against its window ring and
   global cache, in its 600-token prefill and in one 2048-query block of
   its chunked prefill; ``gather_shapes``) bit for bit at border 8 (int16
   table) and border 14 (int32 table, products beyond int16), one launch a
   call, with the profiler's device time (``device_ms``), the launch plan
   and, at border 8, the device time of the same plan on the other table
   route (staged in shared memory or read through L1); at gemma-2b's and
   gemma3-1b's shapes, the low-rank kernel within 1e-5 * max_mn sum_k
   (|a b| + sum_r |u v|) of its plain version and within K * sigma_{r+1}
   (plus that slack) of the bit-exact table sums, the circuit-replay
   kernel bit for bit against its plain version and against the gather
   kernel on the same operands at border 8 and 14 (and, at the decode
   shapes, on the border-6 schedule), and against the float64 integer
   product on the exact schedule (border None), every replay program on
   the build's LOP3 immediates alone (``generic_ops`` 0, printed); time
   kernel, plain version and, for the low-rank kernel, one
   ``torch.matmul`` on the prebuilt augmented operands (the yardstick),
   both also as device time under ``torch.profiler`` (``device_ms``: at N
   = 256 the wrapper's host time holds the event times); the SSD
   chunked-scan kernel within ``ssd_scan.ref.ssd_error_bound`` of its
   plain version, per output, in full and split mode, at the mamba2-370m
   prefill shape (S = 16 in a 256-row chunk), at S = 1024 (4 chunks) and
   at S = 2048 (8 chunks) with the model's dt, and at S = 1024 and 2048
   with dt scaled so that the state carried from chunk to chunk exceeds
   the bound a hundredfold (the model's dt decays it to 0 within a chunk,
   where no check can see it), with event and device ms; the SSD backward
   kernel (``ssd_scan_bwd``) against the plain backward (autograd through
   the plain scan), in full and split mode, every gradient within
   ``ssd_scan.ref.ssd_grad_rtol`` of its max, at mamba2-370m's widths (S =
   16, 1024 and its training shape 4 x 2048) and zamba2-1.2b's (its
   training shape 2 x 1024), with the model's dt and with dt scaled so
   that the gradient the reverse join carries across chunks exceeds the
   tolerance a hundredfold; event and device ms beside the forward's at
   the same shape (``ssd_bwd_kernel_rows``); the grouped gather and replay
   kernels at moonshot-v1-16b-a3b's expert sites (64 experts; C = 6, 12
   and 96 capacity rows: a decode token's dispatch, 2 tokens, a 16-token
   prefill; (2048, 1408) and (1408, 2048)) at border 8 and 14, the gather
   bit for bit against its plain version and the replay against the
   gather on every expert and against its plain version on 2
   (``moe_expert_kernel_rows``); kernels 1-4 at this slice's shapes
   (``FRONTEND_SHAPES``: whisper-small's decode cross K / V at M = 3000,
   its encoder's attn.qk / attn.pv over 24 groups of 1500 x 1500, a decode
   step's cross attn.qk; internvl2-76b's MLP at decode and prefill;
   moonshot-v1-16b-a3b's training expert buffers, C = 120, and its rank-8
   attention), each against its plain version on 2 groups or rows
   (``frontend_kernel_rows``); the row mean-square kernel of every norm
   (``NORM_SHAPES``: a decode step's and a prefill's, gemma3-1b's q_norm,
   whisper-small's encoder, internvl2-76b's prefill, moonshot's training
   batch) within one float32 ulp of its plain version (float64 sums of
   the squares on both), a row alone bit for bit the same row in the
   batch (``norm_kernel_rows``).  The norm kernel
   launches in every served and trained run below; its count is held
   above zero, not to a formula;
2b. A/B, with ``--parent`` (a tree of the parent commit, for example
   ``git archive`` unpacked under ``build/``): the gather kernels (border
   8) at the gemma-2b and mamba2-370m rank-0 paths' shapes, the low-rank
   kernel, the replay kernel (border 8) and the fused attention LUT and
   inject kernels (served decode and prefill, long decode and prefill) at
   the gemma-2b path's shapes, the SSD kernel at S = 16, 1024 and 2048
   in split and full mode at mamba2-370m's widths, and its backward at
   mamba2-370m's training shape (4 x 2048, split and full), one sequence
   of 1024 and zamba2-1.2b's training shape (2 x 1024), parent, change,
   change, parent,
   each run a process of its own that builds its tree's kernels: the event
   time (where a call takes less than 0.2 ms, the median of 5 windows of
   200 calls, with the host time beside it: the wrapper's checks, plan and
   launch) and the device time, side by side.  Then the served rank-0
   runs of gemma-2b (4 x 16), mamba2-370m (4 x 16) and gemma3-1b (2 x
   600) through ``ServeEngine``, parent, change, change, parent, a
   process each (``time_serve``): decode ms a step, prefill and wall
   seconds, the medians of 3 runs after a warm one (``phase_ab_serve``);
3. reference — reduced gemma-2b in float32 on the card (kernels) and on
   the CPU (plain versions), same weights, under amr_kernel rank 0 and 8
   and amr_inject, reduced mamba2-370m under exact (SSD kernel in full
   mode) and amr_kernel rank 0 (split mode), and reduced gemma3-1b under
   rank 0 and amr_inject (one more prompt, of 11 tokens, past its window
   of 8), reduced zamba2-1.2b under exact and rank 0, and reduced
   dbrx-132b and moonshot-v1-16b-a3b under exact and rank 0 in both MoE
   dispatch forms (replicate: the experts through the numerics; local:
   exact experts): tokens equal, logits within 1e-3 * max|logit| or,
   where not, phase 9a's trace rule over every quantization of the run
   (the first moved int8 index at a rounding tie, the log names it:
   reduced gemma3-1b at rank 0 and under amr_inject, one value at 56.5
   within 4e-6 int8 steps, quantization 396 of 1224); and on
   the card reduced dbrx-132b (replicate) under amr_inject gives its rank-0
   tokens and logits bit for bit; then reduced whisper-small and
   internvl2-76b under exact and rank 0 through their model-level entry
   points (``generate``: encode, prefill with the frames or patches,
   greedy decode steps; the forward and ``encode`` too), tokens equal and
   float outputs within 1e-3 of the max; one training step of reduced
   moonshot-v1-16b-a3b at rank 0 in both forms by phase 9a's rank-0 rules,
   and two backward passes on the card at 2 x 1100 tokens bit for bit
   (``phase_reference_frontends``);
4. attn_fused — the fused AMR attention op (``kernels/attn_fused``), which
   no served step dispatches (the models run the unfused seam, as the JAX
   package's do), at gemma-2b's attention width (8 heads, 1 KV head,
   head_dim 256, folded as the seam folds them: G = batch, M = 8 S, D = P =
   256): the served decode (2 slots, capacity 24, ragged lengths) and
   prefill (16 tokens, causal) on the full-width model's own layer-0 q, k,
   v, a causal long prefill (S = 1024 for lut, 256 for inject) and a decode
   over gemma-2b's 8192-token context on seeded operands; at border 8 and
   14 (int16 and int32 tables), inject also on a registered border-6
   schedule (a DSE candidate).  Each kernel equals its plain version bit
   for bit at three row tiles, at T slices of one word and of all of T
   and, where one block takes a whole row tile, through the split join
   (inject also at the other items count, lut with the table on the other
   route: staged in shared memory or read through L1); at border 8 each of
   these is timed; and the op is within
   ``attn_fused.ref.flip_tolerance`` of the unfused seam composition
   (``fused_attention_reference``, torch.softmax); per case the kernel's,
   the op's, the plain version's and the unfused seam's ms, the bound, the
   max difference to the seam and the share of flipped probability
   indices.  The op at the long-decode case, border 8, is the path whose
   launches the kernels line reports: one per op call;
5. serve — full-width gemma-2b (18 layers, d_model 2048, vocab 256000,
   random weights from seed 0) through ``ServeEngine``: under
   ``AMRNumerics("amr_kernel", border=8)`` at rank 0 and at rank 8 (4
   requests, 2 slots, prompt 16, 8 new tokens) and under
   ``AMRNumerics("amr_inject", border=8)`` (2 requests, 2 slots, prompt
   16, 4 new tokens) and under ``AMRNumerics("amr_noise", border=8)`` (4 x
   8: no hand kernel; before it, the draw's standardized error at a
   gemma-2b decode site and a moonshot expert site within 5 standard
   errors of ``lut.error_stats(8)``'s moments, ``noise_moments``).  Then
   full-width mamba2-370m (48 layers, d_model
   1024, 32 SSM heads, d_state 128, vocab 50280, random weights from seed
   0) under rank 0 (4 requests x 8 tokens) and amr_inject (2 x 4).  Launch
   counts are set to 0 just before each run and read just after: for
   gemma-2b rank 0 must launch both gather kernels and no other, rank 8
   the low-rank kernel only, amr_inject the replay kernel only; for
   mamba2-370m rank 0 both gather kernels and the SSD kernel, amr_inject
   the replay kernel and the SSD kernel, the SSD kernel 48 times per
   prefill (once per layer) and never in decode, the fused attention
   kernels never;
6. batched vs solo — request 0 served alone (1 slot) gives the same tokens
   and the same logits, bit for bit, as in the batched run: gemma-2b at
   rank 0, rank 8 and under amr_inject and amr_noise, mamba2-370m at rank
   0 and under amr_inject;
7. profile — one more run of 2 requests at rank 0, at rank 8 and under
   amr_inject for gemma-2b, and at rank 0 for mamba2-370m, under
   ``torch.profiler``: device time by kernel and by kernel family (every
   template instance of a hand kernel), and the device's idle share;
8. gemma3-1b — full width (26 layers, 5 window layers to 1 global, window
   512, d_model 1152, 4 heads, 1 KV head, head_dim 256, d_ff 6912, vocab
   262144, random weights from seed 0) through ``ServeEngine``, as in
   phases 5-7: rank 0 with 2 prompts of 600 tokens, 8 new tokens each,
   capacity 640 (its window rings roll in prefill and wrap in decode:
   checked from the engine's cache), rank 8 (4 x 8) and amr_inject (2 x 4)
   with 16-token prompts; the gathers, the low-rank and the replay kernel
   launched and no other; batched vs solo bit for bit and a profile of
   each.  Then one attention layer of each kind prefilled at S = 16384
   under rank 0: the entry point takes the chunked form (8 query blocks,
   two grouped gather launches each), whose output equals the one-block
   form's bit for bit.  Phase 2 holds the kernels at gemma3-1b's shapes
   too, and phase 3 serves reduced gemma3-1b (window 8) on card and CPU;
8b. zamba2-1.2b — full width (38 layers: 2 groups of 18 Mamba2 blocks and
   one application of the shared attention + MLP block, d_model 2048, 32
   heads of 64, d_ff 8192 geglu, d_state 64, vocab 32000, random weights
   from seed 0) through ``ServeEngine`` at rank 0 and rank 8 (4 x 8) and
   under amr_inject (2 x 4): the gathers, the low-rank or the replay
   kernel with the SSD kernel and no other, the SSD kernel 36 times per
   prefill and never in decode; batched vs solo bit for bit in each; a
   profile at rank 0;
8c. moonshot-v1-16b-a3b — full width (48 layers, d_model 2048, 16 heads
   of 128, 64 experts top-6, d_ff_expert 1408, vocab 163840, untied head;
   28.05 G random bf16 parameters from seed 0, drawn a layer at a time,
   after every earlier model is freed) through ``ServeEngine``, 2 slots,
   16-token prompts: as registered (``dispatch_shard="local"``: exact
   expert products) at rank 0 and rank 8 (2 x 8), the attention sites on
   the gathers or the low-rank kernel and the experts on no hand kernel;
   in the replicate form (the ``MoEConfig`` default: every expert site one
   grouped AMR product) at rank 0 (2 x 8: the grouped gather at each
   expert site, three a layer per dispatch, one dispatch a prefill and one
   a slot and step; the counts checked exactly, ``_moe_launches``) and
   under amr_inject (2 requests of 4 tokens, 2 new, on MOON_INJECT_LAYERS
   of the 48 layers: the replay kernel only); batched vs solo bit for bit
   in each; rank 0 of each form
   profiled; prefill and decode seconds, ms per decode step, peak memory;
8d. whisper-small — full width (12 encoder and 12 decoder layers, d_model
   768, 12 heads of 64, d_ff 3072 gelu, vocab 51865, tied; random bf16
   weights from seed 0) through its model-level entry points, as the
   conformance decode arm drives them (``generate``: ``encode`` of the
   frames, ``prefill_with_cache`` with them, greedy ``decode_step``s with
   the encoder output; every decoder layer projects the cross K and V of
   the frames anew each step): 2 requests of 1500 random frames and 16-token
   prompts, WHISPER_GEN new tokens, under exact, rank 0 and rank 8; the launches of
   each kernel in the prefill and in each decode step checked exactly;
   batched == solo bit for bit; rank 0 profiled; then in float32 (where
   both quantizers agree) 2 requests of 4 tokens, 2 new, under amr_inject
   (the replay kernel only), whose tokens and logits equal rank 0's bit
   for bit (``phase_whisper``);
8e. internvl2-76b — full width (d_model 8192, 64 heads, 8 KV heads of 128,
   d_ff 28672, vocab 128256, untied) with its depth cut to VLM_LAYERS of 80
   layers (16: 27.4 GB of layers and 4.2 GB of embedding and head; its 141
   GB do not fit the card), random bf16 weights: 2 requests of 256 random patch
   embeddings (the exact ``vision.proj``, prepended) and 16-token prompts,
   8 new tokens, the KV capacity widened by the prefix, under exact and
   rank 0, launches checked, batched == solo bit for bit, rank 0 profiled
   (``phase_vlm``);
8f. the rest of the dense family (``phase_dense_rest``), after every
   earlier model is freed: minitron-8b at full width and depth (32 layers,
   d_model 4096, GQA 32 heads over 8 KV heads of 128, d_ff 16384, vocab
   256000, untied; 9.88 G random bf16 parameters from seed 0) and
   qwen3-32b at full width and QWEN_LAYERS of its 64 layers (d_model 5120,
   64 heads and 8 KV heads of 128, qk-norm, rope theta 1e6, d_ff 25600,
   vocab 151936, untied; 32.8 G parameters, 61.1 GiB), each through
   ``ServeEngine`` at rank 0, 2 requests of 16 tokens, 8 new, 2 slots: the
   launches per prefill and per decode step checked exactly (7 flat and 2
   grouped gathers a layer; 2 norms a layer, 4 with qk-norm, and the final
   one), batched == solo bit for bit, minitron-8b profiled, qwen3-32b's
   peak memory under DENSE_PEAK_GIB; then reduced minitron-8b and qwen3-32b
   (rank 0, and qwen3-32b at rank 8) card vs CPU as in phase 3;
9. train — (a) reduced amr-paper-100m in float32 trained on the card
   (kernels) and on the CPU (plain versions) from the same weights on the
   same ``SyntheticLM`` batches under its four training policies
   (amr_lowrank border 8 rank 16, amr_kernel rank 0 and rank 8, amr_inject):
   one step's gradients and two AdamW steps' losses (rank 0 and amr_inject,
   integer products: loss within 1e-4 relative, each gradient leaf within
   1e-3 of its max; rank 8 and amr_lowrank, whose float sums may put an
   int8 index at a rounding tie and move every later layer: loss within
   1e-2 relative, gradients by the correlation rule of
   tests/test_torch_gemma3.py); in every mode the forward's int8
   quantizations call by call: the indices agree until the first call
   where one moves, and the rounded values within 1e-3 int8 steps until
   and at it; the same mode at border 0 (no error lanes) must fail that
   rule on the CPU; (b) full-width
   amr-paper-100m (12 layers, d_model 768, vocab 32000) at batch 8, seq 256
   under the four policies, and full-width gemma3-1b at rank 8, batch 2, seq
   512, remat "block" and "none" (and amr-paper-100m under amr_noise, which
   launches no hand kernel): a warm step and 3 timed ones, launch
   counts set to 0 before and read after (rank 0 the two gathers, rank 8 the
   low-rank kernel, amr_inject the replay kernel, amr_lowrank none; each a
   step one forward's count, twice under "block"), finite losses and
   gradient norms, ms per step, tokens/s, peak memory and the idle share of
   one profiled step; (c) ``FaultTolerantLoop`` on amr-paper-100m at full
   width and AMR_RESTART_LAYERS of its 12 layers under amr_inject and
   under amr_noise (its draws follow the restored
   step), 4 steps straight and 2 + a raised failure + a restore + 2: the
   float32 losses and every leaf of the final state bit for bit;
   and for the SSM and hybrid families: (a) reduced mamba2-370m and
   zamba2-1.2b in float32, card vs CPU, under exact and rank 0 (loss 1e-4
   relative, each gradient leaf within 1e-3 of its max, the unread leaves
   zero); (b) full-width mamba2-370m at rank 0 and rank 8 (4 x 2048; rank
   8 on MAMBA_R8_TRAIN_LAYERS of its 48 layers) and zamba2-1.2b at rank 8
   (2 x 1024, ZAMBA_R8_TRAIN_GROUPS of its 2 groups), remat "block": the
   SSD kernel twice per Mamba2 layer a step, its backward once; (c) the
   restart on mamba2-370m at full width and MAMBA_RESTART_LAYERS of its
   48 layers, rank 0 (2 x 2048);
   and for MoE training and the audio family: (b) full-width whisper-small
   at rank 0 and rank 8 on 2 x 1500 frames and 2 x 448 tokens (the
   encoder's launches once a step: no encoder layer is recomputed), and
   moonshot-v1-16b-a3b at full width with its depth cut to 4 of 48 layers
   (2 x 512 tokens, 6144 routes over 64 experts of capacity 120: drops) as
   registered (local) at rank 8 and in the replicate form at rank 0, where
   two backward passes on the first batch must give the same bits; (c) the
   restart on moonshot-v1-16b-a3b, MOON_RESTART_LAYERS layer at full
   width, replicate form at rank 0 (2 x 512);
   (d) with phase 2, the gathers, the low-rank and the replay kernel at
   amr-paper-100m's training shapes (M = 2048; (768, 768), (768, 3072),
   (3072, 768); attn.qk / attn.pv over 96 groups of 256 x 64 x 256), border
   8, against their plain versions (``training_kernel_rows``).
10. conformance — the port's conformance matrix on the card
   (``phase_conformance``, ``repro_torch.conformance``): the train and
   decode-parity arms of each representative arch and of reduced
   minitron-8b and qwen3-32b under every registered mode (48 rows each),
   the inject audit of every arch of ``families()`` and of the dense
   representative on a registered DSE candidate (``DSE_CANDIDATE``), the
   noise arm of each representative and the restart arm (gemma-2b,
   amr_inject) under both preemption protocols: train rows finite and
   non-degenerate, audits bit-exact with the family's activation sites
   among them, noise reproducible and decorrelated, restarts bit for bit
   with the debris cleaned, parity within ``PARITY_TOL`` or held by
   ``parity_cause`` (the decode on the forward's own cache equal to the
   forward, the first differing cache layer named); one summary line, a
   line per failed row, and the phase raises if any failed.
11. core — the Monte-Carlo engine and the rest of ``repro_torch.core``
   (``phase_core``; torch ops on the card, no hand kernel of its own): the
   engine's exact (lo, hi) splits equal numpy's at 2, 4 and 8 digits
   (borders None, 4, 8 and the 15 Table I points); Table I at the paper's
   own sample counts (50 K, 500 K, 1 M) through ``AMRMultiplier(...,
   engine="torch").monte_carlo`` with MRED / MARED / NMED, seconds and
   samples/s beside the paper's MARED; the int8 tables of borders None and
   0-14 built on the card equal to the served numpy tables; the port's own
   DSE (``search_assignments`` giving ``DSE_CANDIDATE``, a ``pareto_sweep``
   at 4 and 8 digits whose frontier points' metrics equal a direct
   one-schedule replay's, ``select_border`` under an error budget); and the
   engine's products over all 65,536 int8 pairs equal to the CUDA replay
   kernel's (a third evaluator of the same lowering).

``--only dense,conformance,core`` runs the build and those phases alone (no
kernels line): a quick check of those slices' paths.

Bounds: the larger of the bytes over 3.35 TB/s and the operations over the
peak rate of their type: float32 67 T/s (the H100 SXM data sheet, an FMA
counted as two), integer and logic 64 results per clock per SM (the CUDA
C++ Programming Guide's throughput table for compute capability 9.0) x the
SMs x the maximum SM clock that nvidia-smi reports.  The SSD kernel's
operations are counted over the rows the input holds (a 16-token prompt is
16 rows, not the 256 of its padded chunk): the lower triangle of C B^T and
of its product with x dt, the readout C h in full mode for every chunk
after the first (h is 0 before it), and the state update.  The fused
attention kernels count their operands as they take them (int8 q, k, v,
float32 scales, the int32 mask, the table for lut) and the float32 output;
the lut kernel 2 operations (a gather, an add) per product of QK^T and of
PV, the inject kernel ``replay_ops`` for both products; QK^T only where
the mask keeps the score (per 32-column word for inject), PV over every
column, since AMR(0, v) is not 0.  The SSD backward counts each product
it needs once (``ssd_bwd_work``; the kernel also computes the diagonal
tiles' upper triangles, which the mask zeroes).

The last lines are the card's name and power limit, one JSON object with
the kernels' numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_FLOAT_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_FLOAT64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (data sheet)
INT_OPS_PER_CLOCK_PER_SM = 64  # 32-bit integer and logic, compute capability 9.0
L2_BYTES = 50 * 2**20
BORDER, RANK = 8, 8
SLOTS, PROMPT_LEN, GEN, REQUESTS = 2, 16, 8, 4
SSD_LONG = 1024  # the longer SSD shape: 4 chunks of 256
SSD_CONTEXT = 2048  # the Mamba2 models' training context: 8 chunks, more blocks than SMs
MAMBA_TRAIN_BATCH = 4                   # mamba2-370m training: 4 x 2048 tokens a step
ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ = 2, 1024  # zamba2-1.2b training: 2 x 1024
GRAD_NAMES = ("dx", "ddt", "da_log", "db", "dc")
INJECT_GEN, INJECT_REQUESTS = 4, 2
CAPACITY = PROMPT_LEN + GEN
G3_PROMPT, G3_CAPACITY = 600, 640  # gemma3-1b's long rank-0 run: past its 512-token window
G3_CHUNKED_S = 16384               # gemma3-1b's chunked prefill: 8 query blocks of 2048
TRANSPOSE_OPS = 5 * 16 * 6  # 32x32 bit transpose: 5 levels x 16 word pairs x 6 ops
PLAIN_REPLAY_PAIRS = 1 << 24  # the plain replay's chunk on the card (memory knob only)
GATHERS = {"amr_matmul_int8_lut", "amr_matmul_int8_lut_grouped"}
# every model's norms: launched in every served and trained run, under any
# numerics; its counts are not held to a formula (the final norm is outside
# the rematerialised blocks)
NORM_KERNEL = "row_mean_square"
MOE_EXPERT_M = (6, 12, 96)  # C at top-6: a decode token, 2 tokens, a 16-token prompt
MOON_INJECT_PROMPT, MOON_INJECT_GEN = 4, 2  # moonshot's amr_inject run: 2 requests of these
MOON_INJECT_LAYERS = 6                      # ... on 6 of its 48 layers
NOISE_SIGMAS = 5.0  # the amr_noise moment gate: mean 0 and std 1 within 5 standard errors
WHISPER_PROMPT, WHISPER_GEN = 16, 8            # phase 8d: 2 requests of 1500 frames each
WHISPER_INJECT_PROMPT, WHISPER_INJECT_GEN = 4, 2
VLM_LAYERS, VLM_PROMPT, VLM_GEN = 16, 16, 8    # phase 8e: internvl2-76b, 16 of its 80 layers
WHISPER_TRAIN_SEQ = 448                        # phase 9b: whisper's target length
# phase 2: kernels 1-4 at this slice's shapes, (kind, model, site, (G or 0, M, K, N))
FRONTEND_SHAPES = [
    ("gather", "whisper-small", "xattn.wk/wv, a decode step", (0, 3000, 768, 768)),
    ("gather", "whisper-small", "encoder attn.qk", (24, 1500, 64, 1500)),
    ("gather", "whisper-small", "encoder attn.pv", (24, 1500, 1500, 64)),
    ("gather", "whisper-small", "cross attn.qk, a decode step", (24, 1, 64, 1500)),
    ("gather", "internvl2-76b", "mlp.w_gate/w_up, a decode step", (0, 2, 8192, 28672)),
    ("gather", "internvl2-76b", "mlp.w_gate/w_up, prefill", (0, 544, 8192, 28672)),
    ("gather", "moonshot-v1-16b-a3b", "training experts w_gate/w_up", (64, 120, 2048, 1408)),
    ("gather", "moonshot-v1-16b-a3b", "training experts w_down", (64, 120, 1408, 2048)),
    ("lowrank", "whisper-small", "xattn.wk/wv, a decode step", (0, 3000, 768, 768)),
    ("lowrank", "moonshot-v1-16b-a3b", "training attn.wq", (0, 1024, 2048, 2048)),
    ("replay", "whisper-small", "xattn.wk/wv, a decode step", (0, 3000, 768, 768)),
    ("replay", "whisper-small", "encoder attn.qk", (24, 1500, 64, 1500)),
]
MOON_TRAIN_LAYERS, MOON_TRAIN_SEQ = 4, 512     # phase 9b: moonshot, 4 of its 48 layers
# phase_conformance: a DSE candidate's recorded decisions, (stage, column, posibits,
# negabits, cells): the whole-multiplier assignment the JAX package's
# search_assignments(2, 8, k=1, beam_width=8, branch_cap=4, max_nodes=2000)
# returns (tests/test_torch_conformance.py holds it to that), expected error 1
DSE_CANDIDATE = (
    (0, 2, 3, 0, (("FA_PP", 3, 0),)),
    (0, 3, 4, 0, (("FA_PP", 3, 0),)),
    (0, 4, 5, 2, (("FA_PN1", 2, 1), ("FA_PN2", 2, 1))),
    (0, 5, 6, 2, (("FA_NP1", 1, 2), ("FA_PP", 3, 0))),
    (0, 6, 7, 2, (("FA_PN1", 2, 1), ("FA_PN2", 2, 1), ("FA_PP", 3, 0))),
    (0, 7, 8, 2, (("FA_PN1", 2, 1), ("FA_PN2", 2, 1), ("FA_PP", 3, 0))),
    (0, 8, 8, 4, (("FA", 0, 3), ("FA", 2, 1), ("FA", 3, 0), ("FA", 3, 0))),
    (1, 3, 3, 0, (("FA_PP", 3, 0),)),
    (1, 4, 2, 2, (("FA_NP1", 1, 2),)),
    (1, 5, 5, 0, (("FA_PP", 3, 0),)),
    (1, 6, 3, 3, (("FA_NN", 0, 3), ("FA_PP", 3, 0))),
    (1, 7, 5, 2, (("FA_NP1", 1, 2), ("FA_PP", 3, 0))),
    (1, 8, 5, 2, (("FA", 1, 2), ("FA", 3, 0))),
    (2, 4, 3, 0, (("FA_PP", 3, 0),)),
    (2, 5, 2, 1, (("FA_PN1", 2, 1),)),
    (2, 6, 3, 1, (("FA_PN2", 2, 1),)),
    (2, 7, 4, 1, (("FA_PN1", 2, 1),)),
    (2, 8, 4, 1, (("FA", 2, 1),)),
    (3, 6, 2, 1, (("FA_PN1", 2, 1),)),
    (3, 7, 2, 1, (("FA_PN1", 2, 1),)),
    (3, 8, 3, 1, (("FA_PN2", 2, 1),)),
    (4, 8, 2, 1, (("FA_PN1", 2, 1),)),
)
MOON_RESTART_LAYERS = 1                        # phase 9c
# phase 11 (``phase_core``): the paper's Table I design points and its MARED
# there (AMR-MUL, Table I), and its Monte-Carlo sample counts (§IV)
TABLE1_MARED = {
    2: {6: 2.98e-2, 7: 4.37e-2, 8: 1.06e-1, 9: 2.68e-1, 10: 5.97e-1},
    4: {12: 2.71e-4, 15: 3.88e-3, 18: 2.50e-2, 21: 1.51e-1, 24: 5.33e-1},
    8: {45: 9.29e-4, 48: 7.09e-3, 50: 1.61e-2, 53: 1.58e-1, 55: 5.18e-1},
}
TABLE1_SAMPLES = {2: 50_000, 4: 500_000, 8: 1_000_000}
CORE_CHUNK = 32768                             # (a): monte_carlo's chunk, the pairs checked
CORE_NUMPY_WORKERS = 6                         # (a), (d): processes for the numpy checks
# (d): the card's whole-multiplier DSE, per digit width: borders, Monte-Carlo
# samples (16384 a chunk), one candidate a border; the search at dse_bench's
# quick sizes; select_border's error budget over the 4-digit borders
CORE_SWEEP = {4: ((12, 18, 24), 65536), 8: ((50,), 32768)}
CORE_SEARCH = dict(beam_width=16, branch_cap=4, max_nodes=8000)
CORE_BUDGET = ("mared", 1e-2)
# depth cuts that keep the script within its time (PERF.md §4)
MOON_SERVE_REQUESTS = SLOTS                    # phase 8c: moonshot's served runs, 7 decode steps
MAMBA_R8_TRAIN_LAYERS = 16                     # phase 9b: mamba2-370m rank 8, 16 of 48 layers
ZAMBA_R8_TRAIN_GROUPS = 1                      # phase 9b: zamba2-1.2b rank 8, 1 of 2 groups
AMR_RESTART_LAYERS = 4                         # phase 9c: amr-paper-100m, 4 of 12 layers
MAMBA_RESTART_LAYERS = 16                      # phase 9c: mamba2-370m, 16 of 48 layers
DENSE_REQUESTS, DENSE_GEN = 2, 8              # phase 8f: minitron-8b and qwen3-32b
QWEN_LAYERS = 64                               # ... qwen3-32b at full depth
DENSE_PEAK_GIB = 76.0                          # ... the peak each must stay under


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def int_ops_per_s(device) -> float:
    """64 integer results per clock per SM x SMs x the maximum SM clock."""
    import torch

    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6


def time_ms(fn, arg_sets, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls (CUDA events), cycling
    through ``arg_sets`` so that operands larger than L2 come from HBM."""
    import torch

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_windows(body, what: str, setup=lambda: None) -> tuple:
    """``body(setup())`` with ``body`` under torch.profiler, again in a window
    of its own (at most PROFILE_WINDOWS) while the profiler records no device
    time: it now and then records no kernel of a window, several windows in
    a row, on the card's machine.  Returns (``body``'s last result, the
    window's ``device_rows``), with no rows where every window came back
    empty."""
    from torch.profiler import ProfilerActivity, profile

    for window in range(PROFILE_WINDOWS):
        arg = setup()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = body(arg)
        rows = device_rows(prof)
        if rows:
            return out, rows
        log(f"[profile] {what}: no device time recorded in window {window + 1} of "
            f"{PROFILE_WINDOWS}")
        time.sleep(0.5)
    return out, []


PROFILE_WINDOWS = 5


def warm_profiler(device) -> None:
    """Open the profiler on a trivial kernel until a window records device
    time, so that the measured windows do not pay for its first start."""
    import torch

    x = torch.ones(1 << 20, device=device)
    _, rows = profile_windows(lambda _: (x * 2, torch.cuda.synchronize()), "warm-up")
    log(f"[profile] warm-up: {'recorded' if rows else 'no'} device time")


def device_ms(fn, arg_sets, reps: int) -> float:
    """Mean device ms per call: the time of every CUDA kernel that ``reps``
    calls launch under torch.profiler, over ``reps`` (the host's share of a
    call, which ``time_ms`` includes when calls are short, is left out).
    Where the profiler records no device time in PROFILE_WINDOWS windows,
    the CUDA-event time of ``time_ms`` instead, which the log says: an upper
    bound on the device time."""
    import torch

    fn(*arg_sets[0])
    torch.cuda.synchronize()

    def body(_):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()

    name = getattr(fn, "__name__", repr(fn))
    _, rows = profile_windows(body, f"device_ms of {name}")
    if rows:
        return sum(r[0] for r in rows) / reps / 1e3
    ms = time_ms(fn, arg_sets, reps)
    log(f"[profile] device_ms of {name}: not measured by the profiler; CUDA-event time "
        f"{ms} ms per call in its place")
    return ms


def host_ms(fn, arg_sets, reps: int) -> float:
    """Mean host ms per call: the wall time of ``reps`` back-to-back calls
    before the card is waited on.  The launches queue, so where the device
    keeps up this is the host's share of a call (checks, launch plan,
    allocation, launch)."""
    import torch

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def call_times(fn, arg_sets, reps: int) -> dict:
    """``ms`` by CUDA events over ``reps`` calls and ``device_ms``; below 0.2
    ms, where the host may hold the event time, ``ms`` and ``host_ms`` each
    the median of 5 windows of 200 calls (the host's clock, which the card's
    machine shares, moves a lone window by tens of per cent)."""
    ms = time_ms(fn, arg_sets, reps)
    if ms >= 0.2:
        return dict(ms=ms, device_ms=device_ms(fn, arg_sets, reps))
    return dict(ms=float(np.median([time_ms(fn, arg_sets, 200) for _ in range(5)])),
                device_ms=device_ms(fn, arg_sets, 50),
                host_ms=float(np.median([host_ms(fn, arg_sets, 200) for _ in range(5)])))


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """Least ms for the work: bytes over the memory rate or operations over
    ``ops_per_s``, the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def replay_ops(inj, words_k: int, out_words: int) -> int:
    """Integer and logic operations a bit-sliced replay needs: per 32-pair
    word one LOP3 per PP gate, two per reduction cell (sum and carry) and a
    full adder (two LOP3s) per final bit into a carry-save accumulator; per
    output word one 32x32 bit transpose to turn the bit slices into sums."""
    lw = inj.lowered
    per_word = (lw.x_idx.shape[0] + 2 * sum(st.in3.shape[0] for st in lw.stages)
                + 2 * len(lw.final_ids))
    return per_word * words_k + TRANSPOSE_OPS * out_words


def copies(nbytes: int) -> int:
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


# ------------------------------------------------------------------ phases
def phase_build() -> None:
    from repro_torch.kernels.amr_matmul import kernel
    from repro_torch.kernels.attn_fused import kernel as akernel
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.inject_replay import kernel as rkernel
    from repro_torch.kernels.rms_norm import kernel as nkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel

    t0 = time.perf_counter()
    records = build_all(list(kernel.LIBRARIES) + list(rkernel.LIBRARIES)
                        + list(skernel.LIBRARIES) + list(akernel.LIBRARIES)
                        + list(nkernel.LIBRARIES))
    log(f"[build] {len(records)} CUDA sources in {time.perf_counter() - t0:.1f}s wall "
        + ", ".join(f"{k} {v.seconds:.1f}s" for k, v in records.items()))
    for name, rec in records.items():
        for line in rec.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[card] {card_line()}, max SM clock {nvidia_smi('clocks.max.sm')}")


def _int8(shape, gen, device):
    import torch

    return torch.randint(-128, 128, shape, generator=gen, device=device, dtype=torch.int8)


def path_shapes(cfg) -> tuple[list, list, dict]:
    """The kernels' shapes on the serve path: M of the dense sites (decode over
    the slots, prefill over one prompt), their (K, N), and the grouped
    (G, M, K, N) of attn.qk / attn.pv, where the query heads of a kv head
    fold into the rows."""
    g = cfg.n_heads // cfg.n_kv_heads
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    dense_kn = list(dict.fromkeys([(cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model),
                                   (cfg.d_model, kv * hd), (cfg.d_model, cfg.n_heads * hd),
                                   (cfg.n_heads * hd, cfg.d_model)]))
    grouped = {"decode qk": (SLOTS * kv, g, hd, CAPACITY),
               "decode pv": (SLOTS * kv, g, CAPACITY, hd),
               "prefill qk": (kv, g * PROMPT_LEN, hd, PROMPT_LEN),
               "prefill pv": (kv, g * PROMPT_LEN, PROMPT_LEN, hd)}
    return [SLOTS, PROMPT_LEN], dense_kn, grouped


def g3_grouped_shapes(cfg) -> dict:
    """gemma3-1b's attn.qk / attn.pv (G, M, K, N) on its long rank-0 path:
    decode over the slots against a window ring and a global cache, the
    prefill of one long prompt, and one query block of the chunked prefill."""
    from repro_torch.models.attention import _Q_CHUNK as q

    g, hd, w = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.sliding_window
    return {"decode qk swa": (SLOTS, g, hd, w), "decode pv swa": (SLOTS, g, w, hd),
            "decode qk full": (SLOTS, g, hd, G3_CAPACITY),
            "decode pv full": (SLOTS, g, G3_CAPACITY, hd),
            "prefill qk": (1, g * G3_PROMPT, hd, G3_PROMPT),
            "prefill pv": (1, g * G3_PROMPT, G3_PROMPT, hd),
            "chunk qk": (1, g * q, hd, G3_CHUNKED_S), "chunk pv": (1, g * q, G3_CHUNKED_S, hd)}


def gather_shapes(cfg, mamba_cfg, g3_cfg=None) -> list[tuple]:
    """(model, site, G, M, K, N, grouped) of the gather kernels on the rank-0
    serve paths: gemma-2b's dense sites and attn.qk / attn.pv, then
    mamba2-370m's dense sites (wz/wx, wb/wc, wdt, out_proj) and its
    ssm.scan readout, at decode over the slots (one row a slot and head)
    and in a prefill of one prompt (one chunk of rows, those past the
    prompt zero); with ``g3_cfg``, gemma3-1b's dense sites at decode and in
    the long prompt's prefill and its ``g3_grouped_shapes``."""
    from repro_torch.models.ssm import ssm_dims

    dense_m, dense_kn, grouped = path_shapes(cfg)
    out = [("gemma-2b", "dense", 1, m, k, n, False) for m in dense_m for k, n in dense_kn]
    out += [("gemma-2b", site, *shape, True) for site, shape in grouped.items()]
    dims = ssm_dims(mamba_cfg.d_model, mamba_cfg.ssm)
    d, di, H = mamba_cfg.d_model, dims["d_inner"], dims["n_heads"]
    kn = [(d, di), (d, dims["d_bc"]), (d, H), (di, d)]
    out += [("mamba2-370m", "dense", 1, m, k, n, False) for m in dense_m for k, n in kn]
    N, P = mamba_cfg.ssm.d_state, mamba_cfg.ssm.head_dim
    out += [("mamba2-370m", "decode ssm.scan", SLOTS * H, 1, N, P, True),
            ("mamba2-370m", "prefill ssm.scan", H, mamba_cfg.ssm.chunk, N, P, True)]
    if g3_cfg is not None:
        out += [("gemma3-1b", "dense", 1, m, k, n, False) for m in (SLOTS, G3_PROMPT)
                for k, n in path_shapes(g3_cfg)[1]]
        out += [("gemma3-1b", site, *shape, True)
                for site, shape in g3_grouped_shapes(g3_cfg).items()]
    return out


def phase_kernels(device, cfg, mamba_cfg, g3_cfg, zamba_cfg) -> dict:
    """Every kernel against its plain version at the main paths' shapes:
    gemma-2b's and gemma3-1b's (``cfg``, ``g3_cfg``), mamba2-370m's and, for
    the SSD backward, zamba2-1.2b's."""
    import torch

    from repro_torch.core import lut
    from repro_torch.kernels.amr_matmul import kernel, ref

    gen = torch.Generator(device=device).manual_seed(0)
    rows: dict[str, list[dict]] = {"lowrank": [], "replay": [], "ssd": [], "ssd_bwd": []}
    int_rate = int_ops_per_s(device)
    log(f"[kernel] integer rate {int_rate / 1e12:.2f} T/s, float32 rate "
        f"{PEAK_FLOAT_OPS_PER_S / 1e12:.0f} T/s, memory {PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
    warm_profiler(device)

    # the gather kernels: dense sites and grouped products at rank 0, all three models
    rows = {**gather_kernel_rows(device, cfg, mamba_cfg, g3_cfg, gen, int_rate), **rows}

    # low-rank kernel: dense sites at rank 8, gemma-2b's then gemma3-1b's
    u, v = lut.factor_tensors(BORDER, RANK, device)
    sigma = lut.lowrank_factor(BORDER, RANK).sigma_next
    table32 = lut.table_tensor(BORDER, device)
    cases = [(c.name, m, k, n) for c in (cfg, g3_cfg)
             for m in path_shapes(c)[0] for k, n in path_shapes(c)[1]]
    for model, m, k, n in cases:
        a = _int8((m, k), gen, device)
        bs = [_int8((k, n), gen, device) for _ in range(min(copies(k * n), 64))]
        got = kernel.amr_matmul_int8(a, bs[0], u, v)
        want = ref.lowrank_matmul_ref(a, bs[0], u, v)
        fa, fb = a.float(), bs[0].float()
        scale = float((fa.abs() @ fb.abs() + ref.lowrank_matmul_ref(a, bs[0], u.abs(), v.abs())
                       - fa @ fb).max())
        err = float((got - want).abs().max())
        if not err <= 1e-5 * scale:
            raise AssertionError(f"low-rank kernel off its plain version at {(m, k, n)}: "
                                 f"{err} > 1e-5 * {scale}")
        exact = ref.lut_matmul_ref(a, bs[0], table32).double()
        gap = float((got.double() - exact).abs().max())
        if not gap <= k * sigma + 1e-5 * scale:
            raise AssertionError(f"low-rank kernel beyond K*sigma_(r+1) at {(m, k, n)}: "
                                 f"{gap} > {k * sigma}")
        # library yardstick: one float32 matmul on the prebuilt augmented operands
        ua, vb = u[a.long() + 128], v[bs[0].long() + 128]
        a_aug = torch.cat([fa[..., None], ua], -1).reshape(m, k * (1 + RANK))
        b_aug = torch.cat([fb[:, None, :], vb.transpose(1, 2)], 1).reshape(k * (1 + RANK), n)
        nbytes = m * k + k * n + 2 * u.numel() * 4 + 4 * m * n
        b_ms, b_by = bound(nbytes, 2 * m * n * k * (1 + RANK), PEAK_FLOAT_OPS_PER_S)
        args = [(a, b, u, v) for b in bs]
        rows["lowrank"].append(dict(
            model=model, border=BORDER, rank=RANK, shape=(m, k, n), max_abs_err=err,
            gap_vs_exact=gap, k_sigma=k * sigma, bound_ms=b_ms, bound_by=b_by,
            ms=time_ms(kernel.amr_matmul_int8, args, 50),
            plain_ms=time_ms(ref.lowrank_matmul_ref, [(a, bs[0], u, v)], 2),
            library_ms=time_ms(torch.matmul, [(a_aug, b_aug)], 50),
            device_ms=device_ms(kernel.amr_matmul_int8, args, 20),
            library_device_ms=device_ms(torch.matmul, [(a_aug, b_aug)], 20)))
        del ua, vb, a_aug, b_aug
    rows["replay"] = [dict(model=c.name, **r) for c in (cfg, g3_cfg)
                      for r in replay_kernel_rows(device, *path_shapes(c), int_rate)]
    rows["ssd"] = ssd_kernel_rows(device, mamba_cfg)
    rows["ssd_bwd"] = ssd_bwd_kernel_rows(device, mamba_cfg, zamba_cfg)
    rows["train_shapes"] = training_kernel_rows(device, int_rate)
    from repro_torch.configs import moonshot_16b_a3b

    rows["moe_expert"] = moe_expert_kernel_rows(device, moonshot_16b_a3b.CONFIG, int_rate)
    rows["frontend"] = frontend_kernel_rows(device, int_rate)
    rows["norm"] = norm_kernel_rows(device)
    for name, rs in rows.items():
        if name in ("train_shapes", "moe_expert", "frontend", "norm"):
            continue
        for r in rs:
            log(f"[kernel] {name} " + json.dumps(r))
    return rows


def gather_kernel_rows(device, cfg, mamba_cfg, g3_cfg, gen, int_rate) -> dict:
    """The flat and grouped gather kernels at every shape of
    ``gather_shapes``, at border 8 (int16 table) and 14 (int32): bit for bit
    against the plain version, one launch a call; event ms (operand copies
    past L2), device ms under the profiler, the plain version's ms, the
    launch plan, and at border 8 the device ms of the same plan on the
    other table route (staged or through L1), which ``lut_launch_plan``
    chose against."""
    import torch

    from repro_torch.core import lut
    from repro_torch.kernels.amr_matmul import kernel, ops, ref

    rows: dict[str, list[dict]] = {"lut": [], "grouped": []}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for border in (8, 14):
        table = ops.kernel_table(border, device)
        table32 = lut.table_tensor(border, device)
        int16 = table.dtype == torch.int16
        for model, site, g, m, k, n, grouped_b in gather_shapes(cfg, mamba_cfg, g3_cfg):
            lead = (g,) if grouped_b else ()
            fn = kernel.amr_matmul_int8_lut_grouped if grouped_b else kernel.amr_matmul_int8_lut
            a = _int8((*lead, m, k), gen, device)
            bs = [_int8((*lead, k, n), gen, device)
                  for _ in range(min(copies(g * k * n), 64))]
            kern = kernel.LUT_GROUPED if grouped_b else kernel.LUT
            before = kern.launches
            got = fn(a, bs[0], table)
            want = ref.lut_matmul_ref(a, bs[0], table32)
            torch.cuda.synchronize()
            if kern.launches != before + 1:
                raise AssertionError(f"{kern.name}: {kern.launches - before} launches in a call")
            if not torch.equal(got, want):
                raise AssertionError(f"{kern.name} differs from plain at border {border}, "
                                     f"{model} {site} {(g, m, k, n)}: "
                                     f"{(got - want).abs().max().item()}")
            plan = kernel.lut_launch_plan(g, m, n, k, sms, int16)
            nbytes = g * (m * k + k * n + 4 * m * n) + table.numel() * table.element_size()
            b_ms, b_by = bound(nbytes, 2 * g * m * n * k, int_rate)
            args = [(a, b, table) for b in bs]
            row = dict(model=model, site=site, border=border,
                       shape=(g, m, k, n) if grouped_b else (m, k, n),
                       table=str(table.dtype).split(".")[-1],
                       route="staged" if plan.staged else "global",
                       plan=dict(rt=plan.rt, cg=plan.cg, k_chunk=plan.k_chunk,
                                 splits=plan.splits, tiles=plan.tiles),
                       max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       ms=time_ms(fn, args, 20), device_ms=device_ms(fn, args, 20),
                       plain_ms=time_ms(ref.lut_matmul_ref, [(a, bs[0], table32)], 2))
            if int16:
                other = plan._replace(staged=not plan.staged)
                flipped = kernel.lut_matmul_with_plan(a, bs[0], table, other)
                torch.cuda.synchronize()
                if not torch.equal(flipped, want):
                    raise AssertionError(f"{kern.name} on the other route differs from plain "
                                         f"at {model} {site} {(g, m, k, n)}")
                row["other_route_device_ms"] = device_ms(
                    lambda *x: kernel.lut_matmul_with_plan(*x, other), args, 20)
            rows["grouped" if grouped_b else "lut"].append(row)
    return rows


def replay_kernel_rows(device, dense_m, dense_kn, grouped, int_rate) -> list[dict]:
    """The circuit-replay kernel at every dense and grouped shape of the
    amr_inject path: bit for bit against its plain version and against the
    gather kernel (the same schedule's table) at border 8 and 14, and at
    the decode shapes on the border-6 schedule, and against the float64
    integer product on the exact schedule.  Every program runs on the
    build's LOP3 immediates alone (generic_ops 0)."""
    import torch

    from repro_torch.core import engine, reduction
    from repro_torch.kernels.amr_matmul import kernel, ops
    from repro_torch.kernels.inject_replay import kernel as rkernel
    from repro_torch.kernels.inject_replay import ref as rref

    gen = torch.Generator(device=device).manual_seed(1)

    def idx(shape):
        return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.int32)

    cases = [(1, m, k, n, False) for m in dense_m for k, n in dense_kn]
    cases += [(g, m, k, n, True) for g, m, k, n in grouped.values()]
    exact = engine.compile_injector(reduction.get_schedule(2, None))
    if exact.max_abs_product != 128 * 128:
        raise AssertionError(f"exact schedule: max|product| {exact.max_abs_product}")
    for border in (None, 6, 8, 14):
        inj = exact if border is None else engine.get_injector(2, border)
        prog = rkernel.program_tensors(inj, device)[0]
        log(f"[kernel] replay program, border {border}: {prog.n_ops} ops in {prog.n_runs} runs, "
            f"{prog.n_slots} wire slots, generic_ops {prog.generic_ops} (cells whose truth-table "
            f"pair is not among the build's {len(rkernel.CELL_PAIRS)} LOP3 immediate pairs)")
        if prog.generic_ops != 0:
            raise AssertionError(f"replay program, border {border}: {prog.generic_ops} cells "
                                 f"outside the kernel's LOP3 immediates")
    out = []
    for g, m, k, n, grouped_b in cases:
        ia = idx((g, m, k))
        ib = idx((g, k, n) if grouped_b else (k, n))
        got = rkernel.inject_replay_int32(exact, ia, ib)
        want = torch.matmul((ia - 128).double(), (ib - 128).double())
        torch.cuda.synchronize()
        if not torch.equal(got.double(), want):
            raise AssertionError(f"replay kernel, exact schedule, {(g, m, k, n)}: differs from "
                                 f"the integer product")
        # border 6, the schedule phase 4 registers as a DSE candidate, at the decode shapes
        decode = m == SLOTS if not grouped_b else (g, m, k, n) in (grouped["decode qk"],
                                                                   grouped["decode pv"])
        for border in (8, 14, 6) if decode else (8, 14):
            inj = engine.get_injector(2, border)
            got = rkernel.inject_replay_int32(inj, ia, ib)
            want = rref.replay_matmul_ref(inj, ia, ib, max_pairs=PLAIN_REPLAY_PAIRS)
            table = ops.kernel_table(border, device)
            a8, b8 = (ia - 128).to(torch.int8), (ib - 128).to(torch.int8)
            lut_out = (kernel.amr_matmul_int8_lut_grouped(a8, b8, table) if grouped_b
                       else kernel.amr_matmul_int8_lut(a8[0], b8, table)[None])
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"replay kernel differs from plain at border {border}, "
                                     f"{(g, m, k, n)}: {(got - want).abs().max().item()}")
            if not torch.equal(got, lut_out):
                raise AssertionError(f"replay kernel differs from the gather kernel at border "
                                     f"{border}, {(g, m, k, n)}")
            out_words = g * m * math.ceil(n / 32)
            b_ms, b_by = bound(4 * (ia.numel() + ib.numel() + g * m * n),
                               replay_ops(inj, out_words * k, out_words), int_rate)
            n_copies = min(copies(4 * ib.numel()), 16)
            args = [(inj, ia, ib)] + [(inj, ia, idx(tuple(ib.shape))) for _ in range(n_copies - 1)]
            k_chunk, wpb, rpb, items = rkernel.launch_plan(inj, ia.device, g, m, n, k,
                                                           grouped_b)[1][-4:]
            launch = dict(items=items, wpb=wpb, rpb=rpb, k_chunk=k_chunk,
                          blocks=g * math.ceil(math.ceil(n / 32) / wpb) * math.ceil(m / rpb)
                          * math.ceil(k / k_chunk),
                          blocks_per_sm=rkernel.blocks_per_sm(
                              items, rkernel.program_tensors(inj, device)[0], wpb, rpb))
            out.append(dict(
                border=border, shape=(g, m, k, n), launch=launch, max_abs_err=0.0, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, ms=time_ms(rkernel.inject_replay_int32, args, 10),
                device_ms=device_ms(rkernel.inject_replay_int32, args, 10),
                plain_ms=time_ms(lambda *a: rref.replay_matmul_ref(
                    *a, max_pairs=PLAIN_REPLAY_PAIRS), [(inj, ia, ib)], 1)))
    return out


def moe_expert_kernel_rows(device, cfg, int_rate) -> list[dict]:
    """The grouped gather and replay kernels at moonshot-v1-16b-a3b's expert
    sites (G = 64 experts; M = C, the capacity rows of one dispatch:
    ``MOE_EXPERT_M``; (K, N) of w_gate / w_up and of w_down), border 8 and 14:
    the gather bit for bit against its plain version on every group, the
    replay bit for bit against the gather kernel on every group and against
    its plain version on the first 2 groups (on the card the plain replay
    takes about 0.76 s for 2 groups at C = 96, so 24 s for all 64; every
    group runs the same code); event and device ms, the plain versions' ms
    (``plain_groups``: over how many groups), the bound."""
    import torch

    from repro_torch.core import engine, lut
    from repro_torch.kernels.amr_matmul import kernel, ops, ref
    from repro_torch.kernels.inject_replay import kernel as rkernel
    from repro_torch.kernels.inject_replay import ref as rref

    gen = torch.Generator(device=device).manual_seed(2)
    G, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    sub = 2
    out = []
    for border in (8, 14):
        table, table32 = ops.kernel_table(border, device), lut.table_tensor(border, device)
        inj = engine.get_injector(2, border)
        for k, n in ((D, F), (F, D)):
            b = _int8((G, k, n), gen, device)
            ib = b.to(torch.int32) + 128
            for m in MOE_EXPERT_M:
                a = _int8((G, m, k), gen, device)
                ia = a.to(torch.int32) + 128
                before = (kernel.LUT_GROUPED.launches, rkernel.REPLAY.launches)
                got = kernel.amr_matmul_int8_lut_grouped(a, b, table)
                rep = rkernel.inject_replay_int32(inj, ia, ib)
                want = ref.lut_matmul_ref(a, b, table32)
                rep_plain = rref.replay_matmul_ref(inj, ia[:sub], ib[:sub],
                                                   max_pairs=PLAIN_REPLAY_PAIRS)
                torch.cuda.synchronize()
                if (kernel.LUT_GROUPED.launches, rkernel.REPLAY.launches) != (before[0] + 1,
                                                                             before[1] + 1):
                    raise AssertionError("moe expert rows: not one launch a call")
                if not torch.equal(got, want):
                    raise AssertionError(f"grouped gather differs from plain at the expert "
                                         f"shape {(G, m, k, n)}, border {border}")
                if not torch.equal(rep, got) or not torch.equal(rep[:sub], rep_plain):
                    raise AssertionError(f"replay kernel differs from the gather kernel or its "
                                         f"plain version at the expert shape {(G, m, k, n)}, "
                                         f"border {border}")
                g_bytes = G * (m * k + k * n + 4 * m * n) + table.numel() * table.element_size()
                g_ms, g_by = bound(g_bytes, 2 * G * m * n * k, int_rate)
                out_words = G * m * math.ceil(n / 32)
                r_ms, r_by = bound(4 * (ia.numel() + ib.numel() + G * m * n),
                                   replay_ops(inj, out_words * k, out_words), int_rate)
                gather_args, replay_args = [(a, b, table)], [(inj, ia, ib)]
                for kind, fn, args, b_ms, b_by, plain in (
                        ("gather", kernel.amr_matmul_int8_lut_grouped, gather_args, g_ms, g_by,
                         lambda: time_ms(ref.lut_matmul_ref, [(a, b, table32)], 1)),
                        ("replay", rkernel.inject_replay_int32, replay_args, r_ms, r_by,
                         lambda: time_ms(lambda *x: rref.replay_matmul_ref(
                             *x, max_pairs=PLAIN_REPLAY_PAIRS), [(inj, ia[:sub], ib[:sub])], 1))):
                    reps = 10 if m < 96 else 3
                    out.append(dict(kernel=kind, site="w_down" if k == F else "w_gate/w_up",
                                    border=border, shape=(G, m, k, n), max_abs_err=0.0,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                    ms=time_ms(fn, args, reps), device_ms=device_ms(fn, args, reps),
                                    plain_ms=plain(), plain_groups=G if kind == "gather" else sub))
                del a, ia, got, rep, want, rep_plain
            del b, ib
    for r in out:
        log("[kernel] moe expert " + json.dumps(r))
    return out


# (model, what, rows, d) of the row mean-square kernel: a served decode
# step's and a 16-token prefill's norms (gemma-2b), gemma3-1b's q_norm over a
# 600-token prefill, whisper-small's encoder norms over 2 x 1500 frames,
# internvl2-76b's over a 2 x 272-token prefill and moonshot-v1-16b-a3b's over
# its 2 x 512-token training batch
NORM_SHAPES = [("gemma-2b", "decode", REQUESTS, 2048), ("gemma-2b", "prefill", PROMPT_LEN, 2048),
               ("gemma3-1b", "q_norm prefill", 600 * 4, 256),
               ("whisper-small", "encoder", 2 * 1500, 768),
               ("internvl2-76b", "prefill", 2 * 272, 8192),
               ("moonshot-v1-16b-a3b", "training", 2 * 512, 2048)]


def norm_kernel_rows(device) -> list[dict]:
    """The row mean-square kernel at ``NORM_SHAPES`` against its plain
    version (the float64 mean of the squares, rounded to float32), within
    one float32 ulp of it (both sums within d 2^-53 of the exact one), and
    each of the first 3 rows alone, and the first 3 together, bit for bit
    the batch's rows: the property the kernel is there for.  No PyTorch
    call computes a row's mean square alone (``library_ms`` null).  The
    bound counts float64 multiply-adds at PEAK_FLOAT64_OPS_PER_S."""
    import torch

    from repro_torch.kernels.rms_norm import kernel as nkernel
    from repro_torch.kernels.rms_norm.ref import mean_square_ref

    gen = torch.Generator(device=device).manual_seed(3)
    out = []
    for model, what, n, d in NORM_SHAPES:
        xs = [torch.randn((n, d), generator=gen, device=device)
              for _ in range(min(copies(4 * n * d), 64))]
        got = nkernel.mean_square(xs[0])
        want = mean_square_ref(xs[0])
        err = (got - want).abs()
        ulp = torch.nextafter(want, torch.full_like(want, math.inf)) - want
        if not bool((err <= ulp).all()):
            raise AssertionError(f"row mean square off its plain version at {(n, d)}: "
                                 f"{float((err / ulp).max())} ulp")
        alone = [nkernel.mean_square(xs[0][i:i + 1].clone()) for i in range(min(n, 3))]
        if not (all(torch.equal(a, got[i:i + 1]) for i, a in enumerate(alone))
                and torch.equal(nkernel.mean_square(xs[0][:3].clone()), got[:3])):
            raise AssertionError(f"row mean square at {(n, d)}: a row alone differs from "
                                 f"the same row in the batch")
        b_ms, b_by = bound(4 * n * d + 4 * n, 2 * n * d, PEAK_FLOAT64_OPS_PER_S)
        args = [(x,) for x in xs]
        out.append(dict(model=model, what=what, shape=(n, d), max_abs_err=float(err.max()),
                        bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        **call_times(nkernel.mean_square, args, 50),
                        plain_ms=time_ms(mean_square_ref, args, 50),
                        plain_device_ms=device_ms(mean_square_ref, args, 20)))
        log("[kernel] norm " + json.dumps(out[-1]))
    return out


def frontend_kernel_rows(device, int_rate: float) -> list[dict]:
    """Kernels 1-4 at the shapes this slice's paths give them, border 8
    (``FRONTEND_SHAPES``): whisper-small's decode cross-attention K and V
    (M = 2 x 1500 frames), its encoder's bidirectional attn.qk / attn.pv
    (24 groups of 1500 x 1500 over 64) and a decode step's cross attn.qk;
    internvl2-76b's MLP at decode and at its 2 x 272-row prefill; the
    expert buffers of moonshot-v1-16b-a3b's training batch (C = 120) and
    its attention at rank 8.  Each kernel against its plain version on the
    first ``sub`` groups (grouped) or rows (flat), which the kernels compute
    independently of the rest: the gathers and the replay bit for bit (the
    replay also equal to the gather on the whole), the low-rank kernel
    within 1e-5 of its float32 scale; event and device ms, the plain
    version's ms on the subset, the bound."""
    import torch

    from repro_torch.core import engine, lut
    from repro_torch.kernels.amr_matmul import kernel, ops, ref
    from repro_torch.kernels.inject_replay import kernel as rkernel
    from repro_torch.kernels.inject_replay import ref as rref

    gen = torch.Generator(device=device).manual_seed(3)
    table, table32 = ops.kernel_table(BORDER, device), lut.table_tensor(BORDER, device)
    inj = engine.get_injector(2, BORDER)
    u, v = lut.factor_tensors(BORDER, RANK, device)
    out = []
    for kind, model, site, (g, m, k, n) in FRONTEND_SHAPES:
        grouped = g > 0
        lead = (g,) if grouped else ()
        a = _int8((*lead, m, k), gen, device)
        bs = [_int8((*lead, k, n), gen, device) for _ in range(min(copies(max(g, 1) * k * n), 8))]
        sub = 2
        part = (a[:sub], bs[0][:sub]) if grouped else (a[:sub], bs[0])
        reps = 3 if max(g, 1) * m * n * k > 2e10 else 10
        if kind == "lowrank":
            fn, args = kernel.amr_matmul_int8, [(a, b, u, v) for b in bs]
            got = fn(a, bs[0], u, v)[:sub]
            want = ref.lowrank_matmul_ref(*part, u, v)
            fa, fb = part[0].float(), part[1].float()
            scale = float((fa.abs() @ fb.abs() + ref.lowrank_matmul_ref(*part, u.abs(), v.abs())
                           - fa @ fb).max())
            err = float((got - want).abs().max())
            if not err <= 1e-5 * scale:
                raise AssertionError(f"low-rank kernel off its plain version at {model} {site}: "
                                     f"{err} > 1e-5 * {scale}")
            b_ms, b_by = bound(m * k + k * n + 2 * u.numel() * 4 + 4 * m * n,
                               2 * m * n * k * (1 + RANK), PEAK_FLOAT_OPS_PER_S)
            ua, vb = u[a.long() + 128], v[bs[0].long() + 128]
            a_aug = torch.cat([a.float()[..., None], ua], -1).reshape(m, k * (1 + RANK))
            b_aug = torch.cat([bs[0].float()[:, None, :], vb.transpose(1, 2)], 1).reshape(
                k * (1 + RANK), n)
            library = time_ms(torch.matmul, [(a_aug, b_aug)], reps)
            plain = time_ms(ref.lowrank_matmul_ref, [(*part, u, v)], 1)
            del ua, vb, a_aug, b_aug
        elif kind == "gather":
            fn = kernel.amr_matmul_int8_lut_grouped if grouped else kernel.amr_matmul_int8_lut
            args = [(a, b, table) for b in bs]
            got = fn(a, bs[0], table)
            if not torch.equal(got[:sub], ref.lut_matmul_ref(*part, table32)):
                raise AssertionError(f"gather kernel differs from plain at {model} {site}")
            err, library = 0.0, None
            b_ms, b_by = bound(max(g, 1) * (m * k + k * n + 4 * m * n)
                               + table.numel() * table.element_size(),
                               2 * max(g, 1) * m * n * k, int_rate)
            plain = time_ms(ref.lut_matmul_ref, [(*part, table32)], 1)
        else:
            ia = (a if grouped else a[None]).to(torch.int32) + 128     # (G or 1, M, K)
            ibs = [b.to(torch.int32) + 128 for b in bs]
            fn, args = rkernel.inject_replay_int32, [(inj, ia, ib) for ib in ibs]
            got = fn(inj, ia, ibs[0])
            lut_out = (kernel.amr_matmul_int8_lut_grouped(a, bs[0], table) if grouped
                       else kernel.amr_matmul_int8_lut(a, bs[0], table)[None])
            rpart = (ia[:sub], ibs[0][:sub]) if grouped else (ia[:, :sub], ibs[0])
            got_part = got[:sub] if grouped else got[:, :sub]
            if not torch.equal(got, lut_out) or not torch.equal(
                    got_part, rref.replay_matmul_ref(inj, *rpart, max_pairs=PLAIN_REPLAY_PAIRS)):
                raise AssertionError(f"replay kernel differs from the gather kernel or its "
                                     f"plain version at {model} {site}")
            err, library = 0.0, None
            out_words = max(g, 1) * m * math.ceil(n / 32)
            b_ms, b_by = bound(4 * (ia.numel() + ibs[0].numel() + max(g, 1) * m * n),
                               replay_ops(inj, out_words * k, out_words), int_rate)
            plain = time_ms(lambda *x: rref.replay_matmul_ref(*x, max_pairs=PLAIN_REPLAY_PAIRS),
                            [(inj, *rpart)], 1)
        torch.cuda.synchronize()
        row = dict(kernel=kind, model=model, site=site, border=BORDER,
                   shape=(g, m, k, n) if grouped else (m, k, n), max_abs_err=err,
                   bound_ms=b_ms, bound_by=b_by, ms=time_ms(fn, args, reps),
                   device_ms=device_ms(fn, args, reps), plain_ms=plain,
                   plain_on=f"{sub} {'groups' if grouped else 'rows'}", library_ms=library)
        out.append(row)
        log("[kernel] new shape " + json.dumps(row))
        del a, bs, args, got
        torch.cuda.empty_cache()
    return out


def ssd_work(B: int, S: int, H: int, P: int, N: int, chunk: int, split: bool) -> int:
    """Float32 operations the SSD scan needs for S rows (an FMA counted as
    two): per chunk of L rows and head, the lower triangle's L (L + 1) / 2
    pairs take a C.B dot over N and a row of P into y; the state update
    takes L N P; the readout C h (full mode, after the first chunk) L N P."""
    ops = 0
    for ci in range(math.ceil(S / chunk)):
        L = min(chunk, S - ci * chunk)
        per_head = L * (L + 1) // 2 * 2 * (N + P) + 2 * L * N * P
        if not split and ci > 0:
            per_head += 2 * L * N * P
        ops += B * H * per_head
    return ops


def ssd_kernel_rows(device, mcfg) -> list[dict]:
    """The SSD kernel against its plain version, in full and split mode,
    every output within ``ssd_error_bound`` (the float32 roundings of sums
    and of the cumulative log decay, relative to the same function of |x|,
    |b|, |c|, per batch, chunk and head).  Inputs at the mamba2-370m
    widths (bf16 x, b, c as the conv outputs are): one 16-token prompt (the
    served prefill), S = 1024 (4 chunks, fewer blocks than SMs) and S =
    2048 (8 chunks, the Mamba2 models' training context, more blocks than
    SMs), with dt as the model makes it; and at 1024 and 2048 with dt
    scaled per head so that a chunk decays the state by exp(-0.5) on
    average.  With the model's dt a chunk's decay underflows to 0, so only
    the scaled inputs show the state carried from chunk to chunk: there the
    carried part of each output (``ssd_carried``) must exceed its bound a
    hundredfold somewhere, so that a kernel that dropped or mis-scaled the
    carry would fail.  Each row has the event ms and the device ms."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan import ref as sref

    H, P, N, G, Q = ssd_widths(mcfg)
    gen = torch.Generator(device=device).manual_seed(2)
    out = []
    for S, inputs in ((PROMPT_LEN, "model dt"), (SSD_LONG, "model dt"), (SSD_LONG, "carry"),
                      (SSD_CONTEXT, "model dt"), (SSD_CONTEXT, "carry")):
        args = ssd_inputs(device, gen, S, H, P, N, G, Q, carry=inputs == "carry")
        for split in (False, True):
            got = skernel.ssd_scan(*args, Q, split=split)
            want = sref.ssd_ref(*args, Q, split=split)
            bounds = sref.ssd_error_bound(*args, Q, split=split)
            carried = sref.ssd_carried(*args, Q, split=split)
            torch.cuda.synchronize()
            err, ratio, carry = 0.0, 0.0, []
            for g, w, bd, cr in zip(got, want, bounds, carried):
                if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"SSD kernel S={S} split={split}: shape {g.shape} vs "
                                         f"{w.shape} or non-finite output")
                err = max(err, float((g - w).abs().max()))
                ratio = max(ratio, float(((g - w).abs() / bd).max()))
                carry.append(float((cr.abs() / bd).max()))
            if not ratio <= 1.0:
                raise AssertionError(f"SSD kernel S={S} split={split}: beyond its bound of the "
                                     f"plain version ({ratio:.3g} x the bound)")
            # full mode: y and h_final carry; split mode: h_prev and h_final
            if inputs == "carry" and not min(carry[1:] if split else carry) >= 100.0:
                raise AssertionError(f"SSD check S={S} split={split}: the carried state is "
                                     f"not visible above the bound ({carry})")
            nbytes = sum(t.numel() * t.element_size() for t in args + tuple(got))
            b_ms, b_by = bound(nbytes, ssd_work(1, S, H, P, N, Q, split), PEAK_FLOAT_OPS_PER_S)

            def kern(*a, split=split):
                return skernel.ssd_scan(*a, Q, split=split)

            plan = skernel.ssd_launch_plan(1, S, H, P, N, Q, torch.cuda.get_device_properties(
                device).multi_processor_count)
            out.append(dict(
                shape=(1, S, H, P, N), inputs=inputs, mode="split" if split else "full",
                plan=dict(p_block=plan.p_block, blocks=plan.blocks),
                max_abs_err=err, err_over_bound=ratio, carried_over_bound=carry, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, **call_times(kern, [args], 50),
                plain_ms=time_ms(lambda *a: sref.ssd_ref(*a, Q, split=split), [args], 5)))
    return out


def ssd_bwd_work(B: int, S: int, H: int, P: int, N: int, chunk: int, split: bool) -> int:
    """Float32 operations the SSD backward needs for S rows (an FMA counted
    as two), each product once, as ``ssd_work`` counts the forward's: per
    chunk of L rows and head, the lower triangle's L (L + 1) / 2 pairs take
    the C.B and dy.u dots (N + P) and the products into dC, dB and du (2 N
    + P); the state terms u D^T and B D take 2 L N P; in full mode, after
    the first chunk, the readout's C^T dy and dy h^T 2 L N P more."""
    ops = 0
    for ci in range(math.ceil(S / chunk)):
        L = min(chunk, S - ci * chunk)
        per_head = L * (L + 1) // 2 * 2 * (3 * N + 2 * P) + 2 * 2 * L * N * P
        if not split and ci > 0:
            per_head += 2 * 2 * L * N * P
        ops += B * H * per_head
    return ops


def ssd_bwd_kernel_rows(device, mcfg, zcfg) -> list[dict]:
    """The SSD backward kernel against the plain backward (torch autograd
    through ``ref.ssd_ref``), in full and split mode: every gradient within
    ``ref.ssd_grad_rtol`` of its largest |value| (1e-4, plus the relative
    error of a decay factor when the two sides round the cumulative log
    decay in other orders, plus one bf16 step on a bf16 gradient).  At
    mamba2-370m's widths a 16-token prompt, S = 1024 and its training shape
    (4 x 2048), and at zamba2-1.2b's (H 64, P 64, N 64) its training shape
    (2 x 1024), with the model's dt and, but at S = 16, with dt scaled so
    that a chunk decays the state by exp(-0.5): there the part of dx, ddt,
    da_log and db that the reverse join carries across chunks
    (``ssd_carried_grads``) must exceed the tolerance a hundredfold, which
    the model's dt (a chunk decays the state to 0) hides.  Each row has the
    backward's event and device ms, the forward's at the same shape (keeping
    its states, as under autograd), the wrapper's head sum of db and dc
    (``head_sum_ms``, inside ``ms``), the plain backward's ms and the bound."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan import ref as sref

    gen = torch.Generator(device=device).manual_seed(3)
    out = []
    cases = [(mcfg, 1, PROMPT_LEN, "model dt"), (mcfg, 1, SSD_LONG, "model dt"),
             (mcfg, 1, SSD_LONG, "carry"), (mcfg, MAMBA_TRAIN_BATCH, SSD_CONTEXT, "model dt"),
             (mcfg, MAMBA_TRAIN_BATCH, SSD_CONTEXT, "carry"),
             (zcfg, ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ, "model dt"),
             (zcfg, ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ, "carry")]
    for cfg, B, S, inputs in cases:
        H, P, N, G, Q = ssd_widths(cfg)
        args = ssd_inputs(device, gen, S, H, P, N, G, Q, carry=inputs == "carry", batch=B)
        nc = math.ceil(S / Q)
        rtol = sref.ssd_grad_rtol(args[1], args[2], Q)
        for split in (False, True):
            dy = torch.randn((B, S, H, P), generator=gen, device=device)
            dh_final = torch.randn((B, H, N, P), generator=gen, device=device)
            dh_prev = torch.randn((B, nc, H, N, P), generator=gen, device=device) if split \
                else None
            _, h_prev, _ = skernel._scan_cuda(*args, Q, split, keep_states=True)
            bwd_args = (*args, h_prev, dy, dh_prev, dh_final, Q)
            got = skernel.ssd_scan_bwd(*bwd_args)
            grads = (dy, dh_prev, dh_final) if split else (dy, dh_final)
            want = sref.ssd_ref_grads(*args, Q, grads, split=split)
            torch.cuda.synchronize()
            excess = {}
            for name, g, w in zip(GRAD_NAMES, got, want):
                if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"SSD backward {cfg.name} S={S} split={split}: {name} "
                                         f"shape {tuple(g.shape)} vs {tuple(w.shape)} or "
                                         f"non-finite")
                excess[name] = sref.ssd_grad_excess(g, w, rtol)
            if not max(excess.values()) <= 1.0:
                raise AssertionError(f"SSD backward {cfg.name} S={S} split={split} {inputs}: "
                                     f"beyond the tolerance of the plain backward {excess}")
            carried = {}
            if inputs == "carry":
                parts = sref.ssd_carried_grads(*args, Q, grads, split=split)
                for name, cr, w in zip(GRAD_NAMES[:4], parts, want):
                    carried[name] = float(cr.abs().max()) / (rtol * float(w.float().abs().max()))
                if not min(carried.values()) >= 100.0:
                    raise AssertionError(f"SSD backward check {cfg.name} S={S} split={split}: "
                                         f"the reverse join is not visible above the "
                                         f"tolerance {carried}")
            nbytes = sum(t.numel() * t.element_size() for t in
                         (*args, h_prev, dy, dh_final, *got) + ((dh_prev,) if split else ()))
            b_ms, b_by = bound(nbytes, ssd_bwd_work(B, S, H, P, N, Q, split),
                               PEAK_FLOAT_OPS_PER_S)
            times = call_times(skernel.ssd_scan_bwd, [bwd_args], 20)
            fwd = call_times(lambda *a: skernel._scan_cuda(*a, Q, split, keep_states=True),
                             [args], 20)
            # the wrapper's sum of the per-head db and dc over each group's heads
            per_head = torch.randn((B, S, H, N), generator=gen, device=device)
            head_sum_ms = 2 * time_ms(lambda t: t.view(B, S, G, H // G, N).sum(dim=3).to(
                args[3].dtype), [(per_head,)], 20)
            out.append(dict(
                model=cfg.name, shape=(B, S, H, P, N), inputs=inputs,
                mode="split" if split else "full", max_abs_err=max(
                    float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)),
                excess=excess, rtol=rtol, carried_over_tol=carried, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, **times, fwd_ms=fwd["ms"],
                fwd_device_ms=fwd["device_ms"], head_sum_ms=head_sum_ms,
                plain_ms=time_ms(lambda *a: sref.ssd_ref_grads(*a, Q, grads, split=split),
                                 [args], 3)))
            del got, want, h_prev, per_head
    return out


def ssd_widths(mcfg) -> tuple[int, int, int, int, int]:
    """(H, P, N, G, chunk) of a Mamba2 config's SSD scan."""
    from repro_torch.models.ssm import ssm_dims

    dims = ssm_dims(mcfg.d_model, mcfg.ssm)
    return (dims["n_heads"], mcfg.ssm.head_dim, mcfg.ssm.d_state, mcfg.ssm.n_groups,
            mcfg.ssm.chunk)


def ssd_inputs(device, gen, S, H, P, N, G, Q, carry=False, batch=1) -> tuple:
    """(x, dt, a_log, b, c) of ``batch`` sequences: bf16 x, b, c; a_log at
    its init; dt the softplus of a projection, or with ``carry`` scaled per
    head so that a chunk of Q rows decays the state by exp(-0.5) on
    average."""
    import torch

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    if carry:
        dt = torch.rand((batch, S, H), generator=gen, device=device) / (torch.exp(a_log) * Q)
    else:
        dt = torch.nn.functional.softplus(normal(batch, S, H))
    return (normal(batch, S, H, P).bfloat16(), dt, a_log, normal(batch, S, G, N).bfloat16(),
            normal(batch, S, G, N).bfloat16())


def time_kernels() -> dict:
    """Times (``call_times``) of the gather kernels (border 8, int16 table)
    at the gemma-2b and mamba2-370m rank-0 paths' shapes, of the low-rank
    kernel, the replay kernel (border 8) and the fused attention LUT and
    inject kernels (border 8: served decode and prefill, long decode and
    prefill) at the gemma-2b path's shapes, of the SSD scan at mamba2-370m's
    widths (S = 16, 1024, 2048, split and full) and of its backward
    (mamba2-370m's 4 x 2048 split and full, 1 x 1024 split; zamba2-1.2b's 2
    x 1024 split), from whichever ``repro_torch`` is first on sys.path: the
    same calls with the same seeded operands in this tree and in a
    parent's."""
    import torch

    from repro_torch.configs import gemma_2b, mamba2_370m, zamba2_1p2b
    from repro_torch.core import engine, lut
    from repro_torch.kernels.amr_matmul import kernel, ops
    from repro_torch.kernels.attn_fused import kernel as akernel
    from repro_torch.kernels.inject_replay import kernel as rkernel

    device = torch.device("cuda")
    warm_profiler(device)
    gen = torch.Generator(device=device).manual_seed(5)
    dense_m, dense_kn, grouped = path_shapes(gemma_2b.CONFIG)
    from repro_torch.kernels.ssd_scan import kernel as skernel

    out: dict[str, dict] = {"lut": {}, "grouped": {}, "lowrank": {}, "replay": {},
                            "attn_fused_lut": {}, "attn_fused_inject": {}, "ssd": {},
                            "ssd_bwd": {}}
    table = ops.kernel_table(BORDER, device)
    for model, site, g, m, k, n, grouped_b in gather_shapes(gemma_2b.CONFIG, mamba2_370m.CONFIG):
        lead = (g,) if grouped_b else ()
        a = _int8((*lead, m, k), gen, device)
        args = [(a, _int8((*lead, k, n), gen, device), table)
                for _ in range(min(copies(g * k * n), 64))]
        fn = kernel.amr_matmul_int8_lut_grouped if grouped_b else kernel.amr_matmul_int8_lut
        key = f"{model} {(g, m, k, n) if grouped_b else (m, k, n)}"
        out["grouped" if grouped_b else "lut"][key] = call_times(fn, args, 20)
    u, v = lut.factor_tensors(BORDER, RANK, device)
    for m in dense_m:
        for k, n in dense_kn:
            a = _int8((m, k), gen, device)
            args = [(a, _int8((k, n), gen, device), u, v) for _ in range(min(copies(k * n), 64))]
            out["lowrank"][str((m, k, n))] = call_times(kernel.amr_matmul_int8, args, 20)
    inj = engine.get_injector(2, BORDER)

    def idx(shape):
        return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.int32)

    cases = [(1, m, k, n, False) for m in dense_m for k, n in dense_kn]
    cases += [(g, m, k, n, True) for g, m, k, n in grouped.values()]
    for g, m, k, n, grouped_b in cases:
        ia = idx((g, m, k))
        n_copies = min(copies(4 * k * n * (g if grouped_b else 1)), 16)
        args = [(inj, ia, idx((g, k, n) if grouped_b else (k, n))) for _ in range(n_copies)]
        out["replay"][str((g, m, k, n))] = call_times(rkernel.inject_replay_int32, args, 10)
    D = P = gemma_2b.CONFIG.head_dim
    fused = {"lut": lambda *a: akernel.attn_fused_lut(*a, table, scale=D ** 0.5),
             "inject": lambda *a: akernel.attn_fused_inject(inj, *a, scale=D ** 0.5)}
    for method, kern in fused.items():
        for label, (G, M, T) in (("served decode", (SLOTS, 8, CAPACITY)),
                                 ("served prefill", (1, 8 * PROMPT_LEN, PROMPT_LEN)),
                                 ("long decode", (SLOTS, 8, ATTN_CONTEXT)),
                                 ("long prefill", (1, 8 * ATTN_LONG_PREFILL[method],
                                                   ATTN_LONG_PREFILL[method]))):
            if label.endswith("prefill"):
                mask = _causal(1, 8, T, device)
            else:
                lens = torch.tensor([T - T // 8, T], device=device)
                mask = (torch.arange(T, device=device) < lens[:, None, None]).int().expand(
                    G, M, T).contiguous()
            args = (_int8((G, M, D), gen, device), _int8((G, D, T), gen, device),
                    _int8((G, T, P), gen, device),
                    torch.rand((G, M, 1), generator=gen, device=device) / 127,
                    torch.rand((G, 1, T), generator=gen, device=device) / 127,
                    torch.rand((G, 1, P), generator=gen, device=device) / 127, mask)
            out[f"attn_fused_{method}"][label] = call_times(kern, [args], _reps(kern, args))
    H, P, N, G, Q = ssd_widths(mamba2_370m.CONFIG)
    for S in (PROMPT_LEN, SSD_LONG, SSD_CONTEXT):
        args = ssd_inputs(device, gen, S, H, P, N, G, Q)
        for split in (False, True):
            out["ssd"][f"S={S} {'split' if split else 'full'}"] = call_times(
                lambda *a, split=split: skernel.ssd_scan(*a, Q, split=split), [args], 50)
    # the backward on the forward's states (keep_states, as under autograd) and
    # seeded output gradients: mamba2-370m's training shape in both modes, one
    # sequence of 1024, zamba2-1.2b's training shape
    for cfg, B, S, split in ((mamba2_370m.CONFIG, MAMBA_TRAIN_BATCH, SSD_CONTEXT, True),
                             (mamba2_370m.CONFIG, MAMBA_TRAIN_BATCH, SSD_CONTEXT, False),
                             (mamba2_370m.CONFIG, 1, SSD_LONG, True),
                             (zamba2_1p2b.CONFIG, ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ, True)):
        H, P, N, G, Q = ssd_widths(cfg)
        args = ssd_inputs(device, gen, S, H, P, N, G, Q, batch=B)
        nc = math.ceil(S / Q)
        _, h_prev, _ = skernel._scan_cuda(*args, Q, split, keep_states=True)
        dy = torch.randn((B, S, H, P), generator=gen, device=device)
        dh_prev = torch.randn((B, nc, H, N, P), generator=gen, device=device) if split else None
        dh_final = torch.randn((B, H, N, P), generator=gen, device=device)
        key = f"{cfg.name} {(B, S)} {'split' if split else 'full'}"
        out["ssd_bwd"][key] = call_times(
            skernel.ssd_scan_bwd, [(*args, h_prev, dy, dh_prev, dh_final, Q)], 20)
        del h_prev, dy, dh_prev, dh_final
    return out


def phase_ab(parent: Path) -> dict:
    """The gather, low-rank, replay, fused LUT and inject and SSD kernels of
    this tree against a parent tree's on one card: parent, change, change, parent, each a
    process of its own that builds its tree's kernels (``--time-kernels``).
    Prints each shape's four times of each kind (event, device, and below
    0.2 ms host) and the parent / change ratio of the means."""
    runs = []
    for label, src in (("parent", parent / "src"), ("change", ROOT / "src"),
                       ("change", ROOT / "src"), ("parent", parent / "src")):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--time-kernels", str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"[ab] {label} run failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        log(f"[ab] {label} run from {src} in {time.perf_counter() - t0:.1f}s")
    table = {}
    for kind in ("lut", "grouped", "lowrank", "replay", "attn_fused_lut", "attn_fused_inject",
                 "ssd", "ssd_bwd"):
        for key, times in runs[1][1][kind].items():
            for what in times:
                parent_ms = [r[kind].get(key, {}).get(what) for lab, r in runs if lab == "parent"]
                change_ms = [r[kind][key].get(what) for lab, r in runs if lab == "change"]
                ratio = (sum(parent_ms) / sum(change_ms)
                         if None not in parent_ms + change_ms else None)
                table[f"{kind} {key} {what}"] = dict(parent_ms=parent_ms, change_ms=change_ms,
                                                     parent_over_change=ratio)
                log(f"[ab] {kind} {key} {what}: parent {parent_ms}, change {change_ms}, "
                    f"parent/change {ratio}")
    return table


# (label, config module, prompts, prompt length, capacity) of the served A/B:
# the rank-0 runs of phase 5 and gemma3-1b's long one
AB_SERVE_RUNS = [("gemma-2b rank 0", "gemma_2b", REQUESTS, PROMPT_LEN, CAPACITY),
                 ("mamba2-370m rank 0", "mamba2_370m", REQUESTS, PROMPT_LEN, CAPACITY),
                 ("gemma3-1b rank 0", "gemma3_1b", SLOTS, G3_PROMPT, G3_CAPACITY)]
AB_SERVE_REPEATS = 3  # timed runs of each, after a warm one


def time_serve() -> dict:
    """Served runs (``AB_SERVE_RUNS``, rank 0, border 8, GEN new tokens a
    request, SLOTS slots) through ServeEngine from whichever ``repro_torch``
    is first on sys.path: per run a warm run, then AB_SERVE_REPEATS timed
    ones, each with its decode ms a step, prefill seconds and wall
    seconds.  The same calls and seeded weights and prompts in this tree
    and in a parent's."""
    import importlib

    import torch

    from repro_torch.numerics import AMRNumerics
    from repro_torch.serve import Request, ServeEngine

    device = torch.device("cuda")
    out = {}
    for label, module, reqs, prompt_len, capacity in AB_SERVE_RUNS:
        config = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
        cfg = dataclasses.replace(config, numerics=AMRNumerics("amr_kernel", border=BORDER,
                                                               rank=0))
        params = model_params(device, config)
        times = []
        for _ in range(1 + AB_SERVE_REPEATS):
            eng = ServeEngine(cfg, params, n_slots=SLOTS, capacity=capacity, device=device)
            for p in model_prompts(config, prompt_len)[:reqs]:
                eng.submit(Request(prompt=p, max_new_tokens=GEN))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            times.append(dict(wall_s=time.perf_counter() - t0, prefill_s=eng.prefill_seconds,
                              decode_ms_per_step=1e3 * eng.decode_seconds / eng.steps_done))
        out[label] = times[1:]
        del params, eng
        torch.cuda.empty_cache()
    return out


def phase_ab_serve(parent: Path) -> dict:
    """The served rank-0 runs (``time_serve``) of this tree against a parent
    tree's on one card: parent, change, change, parent, each a process of
    its own that builds its tree's kernels (``--time-serve``).  Logs each
    run's decode ms a step, prefill and wall seconds (the medians of
    AB_SERVE_REPEATS runs) and the parent / change ratio of the means."""
    runs = []
    for label, src in (("parent", parent / "src"), ("change", ROOT / "src"),
                       ("change", ROOT / "src"), ("parent", parent / "src")):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--time-serve", str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"[ab-serve] {label} run failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        log(f"[ab-serve] {label} run from {src} in {time.perf_counter() - t0:.1f}s")
    table = {}
    for run_label in runs[0][1]:
        for what in ("decode_ms_per_step", "prefill_s", "wall_s"):
            med = {lab: [] for lab in ("parent", "change")}
            for lab, r in runs:
                med[lab].append(float(np.median([t[what] for t in r[run_label]])))
            ratio = sum(med["parent"]) / sum(med["change"])
            table[f"{run_label} {what}"] = dict(parent=med["parent"], change=med["change"],
                                                parent_over_change=ratio)
            log(f"[ab-serve] {run_label} {what}: parent {med['parent']}, change "
                f"{med['change']}, parent/change {ratio:.3f}")
    return table


def phase_reference(device) -> None:
    """Reduced gemma-2b, mamba2-370m, gemma3-1b and zamba2-1.2b, float32: the
    card's kernels against the CPU's plain versions.  gemma3-1b's window of
    8 tokens: one prompt of 11 rolls its ring in prefill, the others wrap it
    in decode.  Tokens equal; logits within 1e-3 of the largest, or, where
    they are not, phase 9a's trace rule on every quantization of the run
    (``_trace_rule``: the rounded values within PARITY_TRACE_TOL int8
    steps until and at the first moved index, so the logits part at a
    rounding tie; the log names it)."""
    from repro_torch.configs import (dbrx_132b, gemma3_1b, mamba2_370m, moonshot_16b_a3b,
                                     zamba2_1p2b)
    from repro_torch.configs.gemma_2b import reduced
    from repro_torch.numerics import AMRNumerics

    cases = [(reduced(), AMRNumerics("amr_kernel", border=BORDER, rank=0)),
             (reduced(), AMRNumerics("amr_kernel", border=BORDER, rank=RANK)),
             (reduced(), AMRNumerics("amr_inject", border=BORDER)),
             (mamba2_370m.reduced(), AMRNumerics("exact")),
             (mamba2_370m.reduced(), AMRNumerics("amr_kernel", border=BORDER, rank=0)),
             (gemma3_1b.reduced(), AMRNumerics("amr_kernel", border=BORDER, rank=0)),
             (gemma3_1b.reduced(), AMRNumerics("amr_inject", border=BORDER)),
             (zamba2_1p2b.reduced(), AMRNumerics("exact")),
             (zamba2_1p2b.reduced(), AMRNumerics("amr_kernel", border=BORDER, rank=0))]
    # the MoE family in both dispatch forms: the registered local one (exact
    # experts) and the replicate one (experts through the numerics)
    for moe_cfg in (dbrx_132b.reduced(), moonshot_16b_a3b.reduced()):
        for form in ("replicate", "local"):
            base = dataclasses.replace(moe_cfg, moe=dataclasses.replace(moe_cfg.moe,
                                                                        dispatch_shard=form))
            cases += [(base, AMRNumerics("exact")),
                      (base, AMRNumerics("amr_kernel", border=BORDER, rank=0))]
    for cfg, params, card in reference_served(device, cases):
        if cfg.moe is not None and cfg.moe.dispatch_shard == "replicate" and \
                cfg.name == "dbrx-132b" and not cfg.numerics.is_exact():
            inject_equals_rank0(device, cfg, params, REFERENCE_PROMPTS, card)


REFERENCE_PROMPTS = [(5, 9, 2, 7), (3, 11, 4, 1, 8, 6), (13, 2), (9, 7, 9, 1, 2)]


def reference_served(device, cases: list):
    """Each (reduced config, numerics) of ``cases`` in float32, served on
    the CPU and on the card from the same weights: tokens equal, logits
    within 1e-3 of the largest or, where not, phase 9a's trace rule (the
    log names the tie); the SSD kernel launched exactly where the config
    has an SSM.  Yields each case's config, CPU weights and card
    completions."""
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.models import init_params
    from repro_torch.models.tree import tree_map
    from repro_torch.numerics.quant import record_quantizations
    from repro_torch.serve import Request, ServeEngine

    prompts = REFERENCE_PROMPTS
    for base, nm in cases:
        cfg = dataclasses.replace(base, dtype="float32", numerics=nm)
        params = init_params(cfg, 0, device="cpu")
        out, traces = {}, {}
        skernel.SSD.launches = 0
        for dev in ("cpu", device):
            eng = ServeEngine(cfg, tree_map(lambda t: t.to(dev), params), n_slots=2,
                              capacity=24, record_logits=True, device=dev)
            window = [(5, 9, 2, 7, 1, 3, 8, 4, 6, 2, 11)] if base.sliding_window else []
            for prompt in prompts + window:
                eng.submit(Request(prompt=prompt, max_new_tokens=5))
            with record_quantizations() as rec:
                out[str(dev)] = eng.run()
            traces[str(dev)] = [(xs.cpu(), q.cpu()) for xs, q in rec]
        cpu, card = out["cpu"], out[str(device)]
        if [c.tokens for c in cpu] != [c.tokens for c in card]:
            raise AssertionError(f"reduced model under {nm}: card tokens differ from CPU")
        diff = max(float(np.abs(x - y).max()) for c, d in zip(cpu, card)
                   for x, y in zip(c.logits, d.logits))
        top = max(float(np.abs(x).max()) for c in cpu for x in c.logits)
        if not diff <= 1e-3 * top:
            trace = _trace_rule(traces[str(device)], traces["cpu"])
            if trace["first_moved"] is None or not trace["ok"]:
                raise AssertionError(f"reduced model under {nm}: logits differ by {diff}; "
                                     f"quantization trace {trace}")
            log(f"[reference] reduced {cfg.name} f32 {nm}: logits {diff:.3g} apart (max "
                f"|logit| {top:.3g}) from a rounding tie: trace {json.dumps(trace)}")
        if (cfg.ssm is not None) != (skernel.SSD.launches > 0):
            raise AssertionError(f"reduced {cfg.name} under {nm}: SSD kernel launched "
                                 f"{skernel.SSD.launches} times")
        form = f" {cfg.moe.dispatch_shard} form" if cfg.moe is not None else ""
        log(f"[reference] reduced {cfg.name}{form} f32 {nm}: tokens equal, "
            f"max |logit diff| card vs CPU {diff:.3g} (max |logit| {top:.3g}); SSD kernel "
            f"launches {skernel.SSD.launches}")
        yield cfg, params, card


def phase_reference_frontends(device) -> None:
    """Phase 3 for the audio and VLM families and MoE training.  Reduced
    whisper-small and internvl2-76b in float32 on the card (kernels) and on
    the CPU (plain versions), the same weights (``init_params`` on the CPU,
    moved) and inputs, under exact and rank 0: the forward's logits with the
    frames or patches, ``encode`` (whisper), and ``generate`` (prefill with
    them, then 4 greedy decode steps): tokens equal, every float output
    within 1e-3 of the CPU's max |value| (the rule of ``phase_reference``).
    Then one training step of reduced moonshot-v1-16b-a3b in both dispatch
    forms at rank 0, card vs CPU by phase 9a's rank-0 rules (loss within
    PARITY_LOSS_RTOL relative, each gradient leaf within PARITY_GRAD_TOL of
    its max), and the gradients of one step computed twice on the card, at
    2 x 1100 tokens (T K = 4400: the batch dispatched at once with JAX's
    capacity), bit for bit."""
    import torch

    from repro_torch.configs import internvl2_76b, moonshot_16b_a3b, whisper_small
    from repro_torch.data import SyntheticLM
    from repro_torch.models import encode, forward, init_params
    from repro_torch.models.tree import tree_items, tree_map
    from repro_torch.numerics import AMRNumerics
    from repro_torch.train.steps import make_grads_step

    cpu = torch.device("cpu")
    modes = (AMRNumerics("exact"), AMRNumerics("amr_kernel", border=BORDER, rank=0))
    for base in (whisper_small.reduced(), internvl2_76b.reduced()):
        for nm in modes:
            cfg = dataclasses.replace(base, dtype="float32", numerics=nm)
            params = init_params(cfg, 0, device="cpu")
            tokens, extra = frontend_inputs(cfg, 2, 8, cpu)
            out = []
            for dev in (cpu, device):
                p = tree_map(lambda t: t.to(dev), params)
                t, e = tokens.to(dev), extra.to(dev)
                with torch.inference_mode():
                    res = generate(cfg, p, t, e, 5)
                    res["forward"] = forward(cfg, p, t, e)[0].cpu()
                    if cfg.encoder_layers:
                        res["encode"] = encode(cfg, p, e).cpu()
                out.append(res)
            a, b = out
            if not np.array_equal(a["tokens"], b["tokens"]):
                raise AssertionError(f"reduced {cfg.name} under {nm}: card tokens "
                                     f"{b['tokens'].tolist()} differ from CPU's "
                                     f"{a['tokens'].tolist()}")
            worst = {}
            for key in ("forward", "encode", "logits"):
                if key not in a:
                    continue
                xs, ys = (a[key], b[key]) if key == "logits" else ([a[key]], [b[key]])
                top = max(float(np.abs(np.asarray(x)).max()) for x in xs)
                diff = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                           for x, y in zip(xs, ys))
                if not diff <= 1e-3 * top:
                    raise AssertionError(f"reduced {cfg.name} under {nm}: {key} card vs CPU "
                                         f"{diff} > 1e-3 * {top}")
                worst[key] = diff / top
            log(f"[reference] reduced {cfg.name} f32 {nm}: tokens equal "
                f"{b['tokens'].tolist()}; max |card - CPU| / max |CPU| {worst}")

    base = dataclasses.replace(moonshot_16b_a3b.reduced(), dtype="float32",
                               numerics=AMRNumerics("amr_kernel", border=BORDER, rank=0))
    for form in ("replicate", "local"):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, dispatch_shard=form))
        data = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=2, seed=0)
        params = init_params(cfg, 0, device="cpu")
        t_cpu, g_cpu, l_cpu = _parity_run(cfg, params, data, cpu)
        t_card, g_card, l_card = _parity_run(cfg, params, data, device)
        failed = _loss_and_grad_rules(l_card, l_cpu, g_card, g_cpu, PARITY_LOSS_RTOL, False)
        if failed:
            raise AssertionError(f"[train] parity reduced {cfg.name} {form}: {failed}")
        want = dict(tree_items(g_cpu))
        worst = max(_leaf_rule(g, want[k], False)[1] for k, g in tree_items(g_card))
        long = SyntheticLM(vocab=cfg.vocab, seq_len=1100, batch=2, seed=0)
        p = tree_map(lambda t: t.to(device), params)
        batch = _train_batch(long, 0, device)
        first, again = (make_grads_step(cfg)(p, batch) for _ in range(2))
        moved = [k for (k, x), (_, y) in zip(tree_items(first), tree_items(again))
                 if not torch.equal(x, y)]
        if moved:
            raise AssertionError(f"reduced {cfg.name} {form}: two backward passes on the card "
                                 f"differ in {moved}")
        log(f"[train] parity reduced {cfg.name} {form} form f32 rank 0: quantizations card vs "
            f"CPU {_trace_rule(t_card, t_cpu)}; losses card {l_card} vs CPU {l_cpu} (rtol "
            f"{PARITY_LOSS_RTOL}); gradients: max over leaves of max |diff| / max |CPU| "
            f"{worst:.3g} (<= {PARITY_GRAD_TOL}); two backward passes at 2 x 1100 tokens on "
            f"the card bit for bit ({len(tree_items(first))} leaves)")


def inject_equals_rank0(device, cfg, params, prompts, rank0) -> None:
    """Reduced dbrx-132b (float32, replicate form) on the card under
    amr_inject: the replay kernel at every AMR site, the expert sites
    grouped, gives the rank-0 run's (``rank0``: completions) tokens and
    logits bit for bit (the same products of the same schedule; float32
    inputs quantize alike under both quantizers)."""
    from repro_torch.kernels.inject_replay import kernel as rkernel
    from repro_torch.models.tree import tree_map
    from repro_torch.numerics import AMRNumerics
    from repro_torch.serve import Request, ServeEngine

    c = dataclasses.replace(cfg, numerics=AMRNumerics("amr_inject", border=BORDER))
    eng = ServeEngine(c, tree_map(lambda t: t.to(device), params), n_slots=2, capacity=24,
                      record_logits=True, device=device)
    for prompt in prompts:
        eng.submit(Request(prompt=prompt, max_new_tokens=5))
    before = rkernel.REPLAY.launches
    done = eng.run()
    same = all(a.tokens == b.tokens and all(np.array_equal(x, y) for x, y in
                                            zip(a.logits, b.logits))
               for a, b in zip(done, rank0))
    if not same or rkernel.REPLAY.launches == before:
        raise AssertionError(f"reduced {cfg.name} on the card: amr_inject differs from rank 0 "
                             f"or launched no replay ({rkernel.REPLAY.launches - before})")
    log(f"[reference] reduced {cfg.name} replicate form on the card: amr_inject == rank 0 bit "
        f"for bit (tokens and logits), {rkernel.REPLAY.launches - before} replay launches")


ATTN_LONG_PREFILL = {"lut": 1024, "inject": 256}  # S of the causal long prefills
ATTN_CONTEXT = 8192                               # gemma-2b's context: the long decode's T
ATTN_DECODE_LENGTHS = (17, CAPACITY)              # the served decode's ragged slot lengths


def _fold(q, k, v):
    """(B, S, 8, 256) queries, (B, T, 1, 256) keys and values -> the seam's
    (B, 8 S, 256), (B, 256, T), (B, T, 256), in float32."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qa = q.reshape(B, S, Hkv, g, D).permute(0, 2, 3, 1, 4).reshape(B * Hkv, g * S, D)
    return (qa.float().contiguous(), k.permute(0, 2, 3, 1).reshape(B * Hkv, D, T).float(),
            v.permute(0, 2, 1, 3).reshape(B * Hkv, T, D).float().contiguous())


def _causal(G, g, S, device):
    import torch

    return torch.tril(torch.ones(S, S, dtype=torch.int32, device=device)).repeat(g, 1).expand(
        G, g * S, S).contiguous()


def attn_cases(device, cfg, params) -> dict:
    """label -> (q, kt, v, mask, methods): the served decode and prefill on
    the full-width model's layer-0 q, k, v (its attention projections under
    amr_kernel rank 0, bf16, cast to float32), the long cases on seeded
    normal operands at the same widths."""
    import torch

    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import embed, rms_norm
    from repro_torch.numerics import AMRNumerics

    g = cfg.n_heads // cfg.n_kv_heads
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (SLOTS, CAPACITY)))
    layer = {k: t[0] for k, t in params["layers"][0]["attn"].items()}
    h = rms_norm(embed(params["embed"], tokens.to(device)), params["layers"][0]["ln1"][0],
                 cfg.norm_eps)
    positions = torch.arange(CAPACITY, device=device).expand(SLOTS, CAPACITY)
    q, k, v = _project_qkv(layer, h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, positions,
                           cfg.rope_theta, cfg.qk_norm,
                           AMRNumerics("amr_kernel", border=BORDER, rank=0), cfg.norm_eps)
    lengths = torch.tensor(ATTN_DECODE_LENGTHS, device=device)
    q_dec = torch.stack([q[b, n - 1] for b, n in enumerate(ATTN_DECODE_LENGTHS)])[:, None]
    dec_mask = (torch.arange(CAPACITY, device=device) < lengths[:, None, None]).int()
    cases = {
        "served decode": (*_fold(q_dec, k, v), dec_mask.expand(SLOTS, g, CAPACITY).contiguous(),
                          ("lut", "inject")),
        "served prefill": (*_fold(q[:1, :PROMPT_LEN], k[:1, :PROMPT_LEN], v[:1, :PROMPT_LEN]),
                           _causal(1, g, PROMPT_LEN, device), ("lut", "inject")),
    }
    gen = torch.Generator(device=device).manual_seed(4)
    D = cfg.head_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    for method, S in ATTN_LONG_PREFILL.items():
        cases[f"long prefill {method}"] = (normal(1, g * S, D), normal(1, D, S), normal(1, S, D),
                                           _causal(1, g, S, device), (method,))
    lens = torch.tensor([ATTN_CONTEXT - 1000, ATTN_CONTEXT], device=device)
    cases["long decode"] = (normal(SLOTS, g, D), normal(SLOTS, D, ATTN_CONTEXT),
                            normal(SLOTS, ATTN_CONTEXT, D),
                            (torch.arange(ATTN_CONTEXT, device=device) < lens[:, None, None])
                            .int().expand(SLOTS, g, ATTN_CONTEXT).contiguous(), ("lut", "inject"))
    return cases


def _row_tiles(M: int, default: int) -> list[int]:
    """The default row tile and the first two other divisors of M of 1, 2, 4, 8, 16, 32."""
    return [default] + [b for b in (1, 2, 4, 8, 16, 32) if M % b == 0 and b != default][:2]


def phase_attn_fused(device, cases: dict, int_rate: float) -> tuple[list, dict]:
    """Both fused attention kernels at every case: bit for bit against their
    plain versions at three row tiles and under other plans (T splits, the
    split join in place of a whole block; inject the other items count, lut
    the other table route), one launch of its kernel per op call,
    within the flip tolerance of the unfused seam composition; times and
    bounds.  Returns the rows and the launch counts of the op's call at the
    long-decode case, border 8."""
    import torch

    from repro_torch.core import lut, reduction
    from repro_torch.kernels.amr_matmul import ops as mops
    from repro_torch.kernels.amr_matmul.ref import lut_matmul_ref
    from repro_torch.kernels.attn_fused import kernel as akernel
    from repro_torch.kernels.attn_fused import ops as aops
    from repro_torch.kernels.attn_fused import ref as aref
    from repro_torch.kernels.inject_replay import kernel as rkernel
    from repro_torch.numerics import AMRNumerics, injection
    from repro_torch.numerics.quant import quantize_int8

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    dse = injection.register_schedule(reduction.get_schedule(2, 6), name="chip_smoke:b6")
    schedules = {"lut": [(8, None), (14, None)], "inject": [(8, None), (14, None), (6, dse)]}
    rows, counts = [], {}
    for label, (q, kt, v, mask, methods) in cases.items():
        G, M, D = q.shape
        T, P = kt.shape[-1], v.shape[-1]
        scale = float(D) ** 0.5
        for method in methods:
            for border, handle in schedules[method]:
                kw = dict(border=border, method=method, schedule_ref=handle)
                q8, k8, v8, sq, sk, sv = aops.quantize_operands(q, kt, v, method)
                if method == "lut":
                    table = mops.kernel_table(border, device)
                    table_bytes = table.numel() * table.element_size()
                    products = lut.table_tensor(border, device)
                    inj = None

                    def kern(*a, bm=None):
                        return akernel.attn_fused_lut(*a, table, scale=scale, bm=bm)

                    def plain(*a):
                        return aref.attn_fused_lut_ref(*a, products, scale)
                else:
                    inj = injection.get_injector(AMRNumerics("amr_inject", border=border,
                                                             schedule_ref=handle))
                    table_bytes = 0
                    products = inj.products(*torch.meshgrid(
                        torch.arange(256, device=device), torch.arange(256, device=device),
                        indexing="ij"))

                    def kern(*a, bm=None):
                        return akernel.attn_fused_inject(inj, *a, scale=scale, bm=bm)

                    def plain(*a):
                        return aref.attn_fused_inject_ref(inj, *a, scale,
                                                          max_pairs=PLAIN_REPLAY_PAIRS)
                args = (q8, k8, v8, sq, sk, sv, mask)
                want = plain(*args)
                default = akernel.default_row_tile(G, M, method, T, sms)
                tile_ms = {}  # at border 8: ms of each row tile
                timed = border == BORDER and handle is None
                for bm in _row_tiles(M, default):
                    got = kern(*args, bm=bm)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"attn_fused {method} {label} border {border} bm {bm}: kernel "
                            f"differs from plain by {float((got - want).abs().max())}")
                    if timed:
                        tile_ms[bm] = time_ms(lambda *a, bm=bm: kern(*a, bm=bm), [args], 5)
                # other plans, bit for bit too and timed at border 8.  inject: the
                # other T splits (one word a slice, one slice), the other items
                # count and, with one slice, the split join instead of a whole
                # block; lut: the same T splits and join, and the table staged
                # in shared memory instead of read through L1 (or the reverse)
                n_words = math.ceil(T / 32)
                if method == "inject":
                    prog = rkernel.program_tensors(inj, device)[0]
                    plan = akernel.inject_launch_plan(G, M, D, T, P, default, sms, prog.n_slots,
                                                      prog.n_opbits, prog.ops.shape[0])
                    others = {f"slice_words={w}": plan._replace(
                        slice_words=w, slices=math.ceil(n_words / w), whole=False)
                        for w in sorted({1, n_words} - {plan.slice_words})}
                    others[f"items={rkernel.ITEMS + 1 - plan.items}"] = plan._replace(
                        items=rkernel.ITEMS + 1 - plan.items)
                    if plan.whole:
                        others["whole=False"] = plan._replace(whole=False)

                    def with_plan(*a, plan):
                        return akernel.attn_fused_inject_with_plan(inj, *a, scale=scale, plan=plan)
                else:
                    plan = akernel.lut_attn_launch_plan(G, M, D, T, P, default, sms,
                                                        table.dtype == torch.int16)

                    def variant(**change):
                        return akernel.lut_attn_plan(G, M, D, T, P, default, sms, **{
                            "slice_words": plan.slice_words, "staged": plan.staged,
                            "whole": plan.whole, **change})

                    others = {f"slice_words={w}": variant(slice_words=w, whole=False)
                              for w in sorted({1, n_words} - {plan.slice_words})}
                    if plan.slices == 1:  # the split join in place of a whole tile, or the reverse
                        flip = variant(whole=not plan.whole)
                        if flip.smem <= akernel.SMEM_LIMIT:
                            others[f"whole={flip.whole}"] = flip
                    if table.dtype == torch.int16:
                        flip = variant(staged=not plan.staged)
                        if flip.smem > akernel.SMEM_LIMIT:
                            flip = variant(staged=not plan.staged, whole=False)
                        others[f"staged={flip.staged}, whole={flip.whole}"] = flip

                    def with_plan(*a, plan):
                        return akernel.attn_fused_lut_with_plan(*a, table, scale=scale, plan=plan)
                variants = {}
                for name, other in others.items():
                    got = with_plan(*args, plan=other)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"attn_fused {method} {label} border {border}, {name}: kernel "
                            f"differs from plain by {float((got - want).abs().max())}")
                    if timed:
                        variants[name] = time_ms(lambda *a, other=other: with_plan(
                            *a, plan=other), [args], 5)
                for k_ in akernel.KERNELS:
                    k_.launches = 0
                out = aops.fused_attention(q, kt, v, mask, **kw)
                torch.cuda.synchronize()
                launched = {k_.name: k_.launches for k_ in akernel.KERNELS}
                if launched != {k_.name: int(k_.name == f"attn_fused_{method}")
                                for k_ in akernel.KERNELS}:
                    raise AssertionError(f"attn_fused {method} {label}: one op call launched "
                                         f"{launched}")
                if label == "long decode" and border == BORDER and handle is None:
                    counts[method] = launched
                seam = aops.fused_attention_reference(q, kt, v, mask, **kw)
                # the plain chain's probabilities (a schedule's replay gives its table's products)
                qp, ps = aref.softmax_requant(lut_matmul_ref(q8, k8, products), sq, sk, mask, scale)
                rqp, rps = quantize_int8(aops.reference_probabilities(q, kt, mask, **kw), axis=-1)
                torch.cuda.synchronize()
                if out.shape != (G, M, P) or not bool(torch.isfinite(out).all()) \
                        or not torch.equal(out, want):
                    raise AssertionError(f"attn_fused {method} {label} border {border}: the op "
                                         f"is not its kernel's plain version")
                flips = (qp.int() - rqp.int()).abs()
                share = float((flips != 0).float().mean())
                tol = aref.flip_tolerance(qp, rqp, ps, rps, sv, aref.index_step(products), seam)
                gap = float((out - seam).abs().max())
                if int(flips.max()) > 1 or share > 0.01 or not bool(((out - seam).abs() <= tol)
                                                                     .all()):
                    raise AssertionError(
                        f"attn_fused {method} {label} border {border}: beyond the flip "
                        f"tolerance of the seam (flipped share {share}, max step "
                        f"{int(flips.max())}, max |diff| {gap})")
                nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * out.numel() \
                    + table_bytes
                # QK^T only where the mask keeps the score (a masked score is
                # overwritten by NEG_INF); PV over every column (AMR(0, v) != 0)
                if method == "lut":
                    ops_ = 2 * (int(torch.count_nonzero(mask)) * D + G * M * T * P)
                else:
                    tw, pw = math.ceil(T / 32), G * M * math.ceil(P / 32)
                    live = int(torch.nn.functional.pad(mask != 0, (0, 32 * tw - T))
                               .view(G, M, tw, 32).any(-1).sum())
                    ops_ = replay_ops(inj, live * D, live) + replay_ops(inj, pw * T, pw)
                b_ms, b_by = bound(nbytes, ops_, int_rate)
                # operand copies rotated past L2, as the other phases time
                n_sets = min(copies(nbytes), 16)
                sets = [args] + [tuple(t.clone() for t in args) for _ in range(n_sets - 1)]
                fsets = [(q, kt, v, mask)] + [(q.clone(), kt.clone(), v.clone(), mask.clone())
                                              for _ in range(n_sets - 1)]
                reps = _reps(kern, args)
                rows.append(dict(
                    method=method, case=label, border=border, schedule=handle or "default",
                    shape=(G, M, D, T, P), bm=default,
                    t_split=plan._asdict(),
                    row_tile_ms=tile_ms or None, other_plan_ms=variants or None,
                    max_abs_err=float((out - want).abs().max()),
                    gap_to_seam=gap,
                    flipped_share=share, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    ms=time_ms(kern, sets, reps),
                    op_ms=time_ms(lambda *a: aops.fused_attention(*a, **kw), fsets, reps),
                    plain_ms=time_ms(plain, sets, _reps(plain, args)),
                    unfused_ms=time_ms(lambda *a: aops.fused_attention_reference(*a, **kw),
                                       fsets, reps)))
                del sets, fsets
                log(f"[attn_fused] " + json.dumps(rows[-1]))
    return rows, counts


def _reps(fn, args, budget_ms: float = 100.0) -> int:
    """Back-to-back calls that fill about budget_ms, from one timed call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return int(min(50, max(2, budget_ms / max(1e-3, (time.perf_counter() - t0) * 1e3))))


def model_params(device, config) -> dict:
    """Full-width ``config``'s random weights from seed 0, on the card."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.models.tree import tree_map

    t0 = time.perf_counter()
    params = init_params(config, 0, device=device)
    torch.cuda.synchronize()
    sizes: list[int] = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    log(f"[serve] {config.name}: {sum(sizes) / 1e9:.3f} G parameters on {device} in "
        f"{time.perf_counter() - t0:.1f}s")
    return params


def all_kernels() -> tuple:
    from repro_torch.kernels.amr_matmul import kernel
    from repro_torch.kernels.attn_fused import kernel as akernel
    from repro_torch.kernels.inject_replay import kernel as rkernel
    from repro_torch.kernels.rms_norm import kernel as nkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel

    return kernel.KERNELS + rkernel.KERNELS + skernel.KERNELS + akernel.KERNELS + nkernel.KERNELS


class Run(NamedTuple):
    """One served run of ``serve_model``: its numerics, requests, new tokens
    a request, the kernels it must launch (every other kernel must launch
    no time), the prompt length and the slot capacity."""
    numerics: object
    requests: int
    gen: int
    uses: set
    prompt_len: int = PROMPT_LEN
    capacity: int = CAPACITY
    expect: object = None  # counts, prefills, decode steps -> the exact launch counts, or None


def model_prompts(config, n_tokens: int) -> list[tuple]:
    """REQUESTS prompts of n_tokens random tokens from seed 0."""
    rng = np.random.default_rng(0)
    return [tuple(int(t) for t in rng.integers(0, config.vocab, n_tokens))
            for _ in range(REQUESTS)]


def ring_state(config, eng, run: Run) -> str:
    """The sliding-window layers' rings after a run (KV leaves whose slots are
    fewer than the run's capacity): slots and the slots' positions.  Raises
    where a request ran past the window and no ring shows it."""
    rings = [c for c in eng.cache if hasattr(c, "k") and c.k.shape[2] < run.capacity]
    if not rings:
        return "no window ring"
    slots, last = rings[0].k.shape[2], int(rings[0].length.max())
    if run.prompt_len + run.gen - 1 > config.sliding_window and last <= slots:
        raise AssertionError(f"{config.name}: {run.prompt_len + run.gen - 1} positions in "
                             f"a {slots}-slot ring, which never wrapped")
    return (f"{len(rings)} window rings x {rings[0].k.shape[0]} copies of {slots} slots, "
            f"slot positions {rings[0].length[0].tolist()} "
            f"({'rolled in prefill, ' if run.prompt_len > slots else ''}"
            f"{'wrapped' if last > slots else 'not wrapped'})")


def serve_model(device, card: str, config, params, runs: dict, solo: tuple, profiled: tuple,
                per_prefill: dict, stats: dict | None = None) -> dict:
    """Serve full-width ``config`` (weights ``params``) through ServeEngine
    under each ``Run`` of ``runs`` (by label); the labels in ``solo`` again
    with request 0 alone, and those in ``profiled`` once more under the
    profiler.  ``per_prefill`` names kernels that must launch exactly that
    many times per prefill.  Returns each run's launch counts; ``stats``,
    where given, receives each run's prefill seconds, ms per decode step and
    peak GiB by label."""
    import torch

    from repro_torch.serve import Request, ServeEngine

    kernels = all_kernels()

    def serve(run: Run, reqs: int, n_slots: int):
        eng = ServeEngine(dataclasses.replace(config, numerics=run.numerics), params,
                          n_slots=n_slots, capacity=run.capacity, record_logits=True,
                          device=device)
        for p in model_prompts(config, run.prompt_len)[:reqs]:
            eng.submit(Request(prompt=p, max_new_tokens=run.gen))
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run()
        wall = time.perf_counter() - t0
        return eng, done, wall, {k.name: k.launches for k in kernels}

    launches, batched = {}, {}
    for label, run in runs.items():
        eng, done, wall, counts = serve(run, run.requests, SLOTS)
        launches[label] = counts
        batched[label] = done[0]
        reqs, gen = run.requests, run.gen
        if len(done) != reqs or any(len(c.tokens) != gen for c in done):
            raise AssertionError(f"{config.name} {label}: expected {reqs} completions of "
                                 f"{gen} tokens")
        if any(not 0 <= t < config.vocab for c in done for t in c.tokens):
            raise AssertionError(f"{config.name} {label}: token out of range")
        if not all(np.isfinite(x).all() and x.shape == (config.vocab,)
                   for c in done for x in c.logits):
            raise AssertionError(f"{config.name} {label}: non-finite or misshapen logits")
        for name, n in counts.items():
            if (name in run.uses or name == NORM_KERNEL) != (n > 0):
                raise AssertionError(f"{config.name} {label}: kernel {name} launched {n} times")
        for name, n in per_prefill.items():
            if counts[name] != n * reqs:
                raise AssertionError(f"{config.name} {label}: kernel {name} launched "
                                     f"{counts[name]} times in {reqs} prefills, not {n} each")
        if run.expect is not None:
            want = run.expect(reqs, eng.steps_done)
            if any(counts[name] != n for name, n in want.items()):
                raise AssertionError(f"{config.name} {label}: launches {counts}, expected "
                                     f"{want} in {reqs} prefills and {eng.steps_done} steps")
        tokens = sum(len(c.tokens) for c in done)
        if stats is not None:
            stats[label] = {"prefill_s": eng.prefill_seconds,
                            "ms_per_step": 1e3 * eng.decode_seconds / eng.steps_done,
                            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"[serve] {config.name} {label} on {card}: {len(done)} requests, {tokens} tokens "
            f"in {wall:.3f}s ({tokens / wall:.2f} tok/s end to end); prefill "
            f"{eng.prefill_tokens} prompt tokens in {eng.prefill_seconds:.3f}s "
            f"({eng.prefill_tokens / eng.prefill_seconds:.1f} tok/s); decode "
            f"{eng.decode_tokens} tokens in {eng.steps_done} steps, {eng.decode_seconds:.3f}s "
            f"({eng.decode_tokens / eng.decode_seconds:.2f} tok/s, "
            f"{1e3 * eng.decode_seconds / eng.steps_done:.1f} ms/step); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {ring_state(config, eng, run)}; "
            f"stats {eng.stats()}; launches {counts}")

    # batched vs solo: request 0 alone in a one-slot engine, the same bits
    for label in solo:
        _, [one], _, _ = serve(runs[label], 1, 1)
        diff = max(float(np.abs(x - y).max()) for x, y in zip(batched[label].logits, one.logits))
        if one.tokens != batched[label].tokens or diff != 0.0:
            raise AssertionError(f"{config.name} {label} request 0: batched "
                                 f"{batched[label].tokens} vs solo {one.tokens}, "
                                 f"max |logit diff| {diff}")
        log(f"[batched-vs-solo] {config.name} {label} request 0: tokens identical "
            f"{list(one.tokens)}; max |logit diff| {diff}")
    for label in profiled:
        run = runs[label]
        profile_serve(device, card, dataclasses.replace(config, numerics=run.numerics), params,
                      model_prompts(config, run.prompt_len), run.gen, run.capacity)
    return launches


def phase_serve(device, card: str, gemma, gemma_params, mamba) -> dict:
    """Full-width gemma-2b (weights ``gemma_params``, emptied afterwards) at
    rank 0, rank 8, under amr_inject and under amr_noise (no hand kernel),
    and full-width mamba2-370m at rank 0 and under amr_inject."""
    from repro_torch.numerics import AMRNumerics

    rank0 = AMRNumerics("amr_kernel", border=BORDER, rank=0)
    inject = AMRNumerics("amr_inject", border=BORDER)
    gemma_runs = {
        "rank 0": Run(rank0, REQUESTS, GEN, GATHERS),
        f"rank {RANK}": Run(AMRNumerics("amr_kernel", border=BORDER, rank=RANK), REQUESTS, GEN,
                            {"amr_matmul_int8"}),
        "amr_inject": Run(inject, INJECT_REQUESTS, INJECT_GEN, {"inject_replay"}),
        "amr_noise": Run(AMRNumerics("amr_noise", border=BORDER), REQUESTS, GEN, set()),
    }
    launches = {"gemma-2b": serve_model(device, card, gemma, gemma_params, gemma_runs,
                                        tuple(gemma_runs), ("rank 0", f"rank {RANK}",
                                                            "amr_inject"), {})}
    gemma_params.clear()  # free gemma-2b's weights: mamba2-370m's peak memory is its own
    mamba_runs = {
        "rank 0": Run(rank0, REQUESTS, GEN, GATHERS | {"ssd_scan"}),
        "amr_inject": Run(inject, INJECT_REQUESTS, INJECT_GEN, {"inject_replay", "ssd_scan"}),
    }
    launches["mamba2-370m"] = serve_model(device, card, mamba, model_params(device, mamba),
                                          mamba_runs, ("rank 0", "amr_inject"), ("rank 0",),
                                          {"ssd_scan": mamba.n_layers})
    return launches


def phase_gemma3(device, card: str, cfg) -> dict:
    """Full-width gemma3-1b (26 layers, 5:1 window:global, window 512):
    served at rank 0 with 2 prompts of 600 tokens at capacity 640 (its
    window rings roll in prefill and wrap in decode), at rank 8 (4 x 8) and
    under amr_inject (2 x 4) with 16-token prompts; each run again with
    request 0 alone and under the profiler.  Then its chunked prefill
    (``chunked_prefill``).  Returns each run's launch counts."""
    from repro_torch.numerics import AMRNumerics

    runs = {
        "rank 0": Run(AMRNumerics("amr_kernel", border=BORDER, rank=0), SLOTS, GEN, GATHERS,
                      G3_PROMPT, G3_CAPACITY),
        f"rank {RANK}": Run(AMRNumerics("amr_kernel", border=BORDER, rank=RANK), REQUESTS, GEN,
                            {"amr_matmul_int8"}),
        "amr_inject": Run(AMRNumerics("amr_inject", border=BORDER), INJECT_REQUESTS, INJECT_GEN,
                          {"inject_replay"}),
    }
    params = model_params(device, cfg)
    launches = serve_model(device, card, cfg, params, runs, tuple(runs), tuple(runs), {})
    chunked_prefill(device, card, cfg, params)
    return launches


def phase_zamba2(device, card: str, cfg) -> dict:
    """Full-width zamba2-1.2b (38 layers: 2 groups of 18 Mamba2 blocks and
    one application of the shared attention + MLP block, d_model 2048, 32
    heads of 64, d_ff 8192 geglu, d_state 64, vocab 32000, random weights
    from seed 0) through ``ServeEngine``: rank 0 and rank 8 (4 requests x 8
    tokens), amr_inject (2 x 4); each run again with request 0 alone (the
    same bits), and rank 0 under the profiler.  Rank 0 launches the gathers
    and the SSD kernel, rank 8 the low-rank kernel and the SSD kernel,
    amr_inject the replay and the SSD kernel, and no other (the fused
    attention kernels never); the SSD kernel once per Mamba2 layer per
    prefill (36) and never in decode.  Returns each run's launch counts."""
    from repro_torch.numerics import AMRNumerics

    runs = {
        "rank 0": Run(AMRNumerics("amr_kernel", border=BORDER, rank=0), REQUESTS, GEN,
                      GATHERS | {"ssd_scan"}),
        f"rank {RANK}": Run(AMRNumerics("amr_kernel", border=BORDER, rank=RANK), REQUESTS, GEN,
                            {"amr_matmul_int8", "ssd_scan"}),
        "amr_inject": Run(AMRNumerics("amr_inject", border=BORDER), INJECT_REQUESTS, INJECT_GEN,
                          {"inject_replay", "ssd_scan"}),
    }
    n_ssm = cfg.pattern.kinds.count("ssm") * cfg.pattern.n_repeat
    params = model_params(device, cfg)
    launches = serve_model(device, card, cfg, params, runs, tuple(runs), ("rank 0",),
                           {"ssd_scan": n_ssm})
    params.clear()
    return launches


def noise_moments(device, card: str, gemma, moon) -> dict:
    """The amr_noise draw on the card at two served shapes, border 8: a
    gemma-2b decode site (2 x 2048 @ 2048 x 16384, a key batch of 2
    requests) and a moonshot expert site (64 x 6 x 2048 @ 64 x 2048 x 1408,
    one key): the standardized error (out / scales - exact - K mu) /
    (sqrt(K) sigma) against ``lut.error_stats(8)`` must have mean 0 and
    standard deviation 1 within NOISE_SIGMAS standard errors."""
    import importlib

    import torch

    from repro_torch.core import lut

    am = importlib.import_module("repro_torch.numerics.approx_matmul")
    stats = lut.error_stats(BORDER)
    gen = torch.Generator(device=device).manual_seed(3)
    shapes = {"gemma-2b decode mlp.w_gate": ((2, 1, gemma.d_model), (gemma.d_model, gemma.d_ff),
                                             (11, 12)),
              "moonshot expert w_gate": ((moon.moe.n_experts, moon.moe.top_k, moon.d_model),
                                         (moon.moe.n_experts, moon.d_model, moon.moe.d_ff_expert),
                                         5)}
    out = {}
    for name, (ashape, bshape, key) in shapes.items():
        a = torch.randn(ashape, generator=gen, device=device, dtype=torch.bfloat16)
        b = torch.randn(bshape, generator=gen, device=device, dtype=torch.bfloat16)
        with torch.inference_mode():
            got = am.matmul_amr_noise(a, b, BORDER, key)
            qa, sa = am.quantize_int8_ste(a, axis=-1)
            qb, sb = am.quantize_int8_ste(b, axis=-2)
            exact = torch.matmul(qa.double(), qb.double())
            K = ashape[-1]
            z = ((got.double() / (sa.double() * sb.double()) - exact - K * stats["mean"])
                 / (math.sqrt(K) * stats["std"])).reshape(-1)
        n = z.numel()
        mean, std = float(z.mean()), float(z.std())
        se_mean, se_std = 1 / math.sqrt(n), math.sqrt(1 / (2 * n))
        out[name] = dict(n=n, mean=mean, std=std, mean_in_se=mean / se_mean,
                         std_in_se=(std - 1) / se_std)
        if abs(mean) > NOISE_SIGMAS * se_mean or abs(std - 1) > NOISE_SIGMAS * se_std:
            raise AssertionError(f"amr_noise moments at {name}: {out[name]}")
        log(f"[noise] {name} on {card}: {n} draws, standardized error mean {mean:.3g} "
            f"({mean / se_mean:+.2f} SE), std {std:.5f} ({(std - 1) / se_std:+.2f} SE) against "
            f"error_stats({BORDER}) mu {stats['mean']:.4f} sigma {stats['std']:.4f}")
    return out


def _moe_launches(cfg, dispatches_per_step: int):
    """The gathers' launches a served run of ``cfg`` at rank 0 must make:
    per prefill and per decode step 4 flat (wq, wk, wv, wo) and 2 grouped
    (attn.qk, attn.pv) a layer, and in the replicate form 3 grouped a layer
    for each dispatch (one a prefill; one a slot and step, the MoE layer
    dispatching each request of a decode step alone)."""
    L = cfg.n_layers
    experts = cfg.moe.dispatch_shard != "local"

    def expect(prefills: int, steps: int) -> dict:
        grouped = 2 * L * (prefills + steps)
        if experts:
            grouped += 3 * L * (prefills + steps * dispatches_per_step)
        return {"amr_matmul_int8_lut": 4 * L * (prefills + steps),
                "amr_matmul_int8_lut_grouped": grouped}
    return expect


def phase_moonshot(device, card: str, cfg) -> dict:
    """Phase 8c: full-width moonshot-v1-16b-a3b (48 layers, d_model 2048, 16
    heads of 128, 64 experts top-6, d_ff_expert 1408, vocab 163840, untied
    head; random bf16 weights from seed 0, 28.05 G parameters) through
    ``ServeEngine``, 2 slots, 16-token prompts.  The registered form
    (``dispatch_shard="local"``: exact expert products) at rank 0 and rank 8
    (MOON_SERVE_REQUESTS x 8): the attention sites launch the gathers or the
    low-rank kernel, the experts nothing.  The replicate form (the
    ``MoEConfig`` default, the experts through the numerics) at rank 0
    (MOON_SERVE_REQUESTS x 8: the grouped gather at every expert site) and
    under amr_inject (2 requests of MOON_INJECT_PROMPT tokens,
    MOON_INJECT_GEN new: the replay kernel only), the latter on the first
    MOON_INJECT_LAYERS of the 48 layers (the same weights; the script's
    time went to later phases).  Each run again with request 0 alone (the same bits); rank 0
    of each form under the profiler.  Returns each run's launch counts."""
    import torch

    from repro_torch.models.tree import tree_map
    from repro_torch.numerics import AMRNumerics

    rank0 = AMRNumerics("amr_kernel", border=BORDER, rank=0)
    replicate = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                 dispatch_shard="replicate"))
    torch.cuda.empty_cache()
    params = model_params(device, cfg)
    log(f"[serve] {cfg.name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights on "
        f"the card")
    launches = {}
    registered = {
        "local rank 0": Run(rank0, MOON_SERVE_REQUESTS, GEN, GATHERS,
                            expect=_moe_launches(cfg, SLOTS)),
        f"local rank {RANK}": Run(AMRNumerics("amr_kernel", border=BORDER, rank=RANK),
                                  MOON_SERVE_REQUESTS, GEN, {"amr_matmul_int8"}),
    }
    launches.update(serve_model(device, card, cfg, params, registered, tuple(registered),
                                ("local rank 0",), {}))
    replicated = {
        "replicate rank 0": Run(rank0, MOON_SERVE_REQUESTS, GEN, GATHERS,
                                expect=_moe_launches(replicate, SLOTS)),
    }
    t0 = time.perf_counter()
    launches.update(serve_model(device, card, replicate, params, replicated, tuple(replicated),
                                ("replicate rank 0",), {}))
    cut = dataclasses.replace(replicate, n_layers=MOON_INJECT_LAYERS)
    inject = {f"replicate amr_inject, {MOON_INJECT_LAYERS} layers": Run(
        AMRNumerics("amr_inject", border=BORDER), INJECT_REQUESTS, MOON_INJECT_GEN,
        {"inject_replay"}, MOON_INJECT_PROMPT, MOON_INJECT_PROMPT + MOON_INJECT_GEN)}
    log(f"[serve] {cfg.name} replicate amr_inject: depth cut to {MOON_INJECT_LAYERS} of "
        f"{cfg.n_layers} layers (the first layers' weights)")
    launches.update(serve_model(device, card, cut, {**params, "layers": tree_map(
        lambda t: t[:MOON_INJECT_LAYERS], params["layers"])}, inject, tuple(inject), (), {}))
    log(f"[serve] {cfg.name} replicate form: {time.perf_counter() - t0:.1f}s")
    params.clear()
    torch.cuda.empty_cache()
    return launches


class FrontRun(NamedTuple):
    """One run of ``serve_frontend``: its numerics, prompt length and new
    tokens a request, the kernels it must launch (every other kernel none),
    the launches each must make in one decode step, and in the encode and
    prefill before the first step."""
    numerics: object
    prompt_len: int
    gen: int
    uses: set
    per_step: dict
    per_prefill: dict


def frontend_inputs(cfg, n_requests: int, prompt_len: int, device, seed: int = 0) -> tuple:
    """(tokens (n, prompt_len), extra (n, T, D)): random prompts from
    ``seed`` and the stub frontend's output, standard normals in
    ``cfg.dtype`` from ``seed + 1`` on the card: a whisper's
    ``encoder_frames`` frames, a VLM's ``vision_prefix`` patches."""
    import torch

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (n_requests, prompt_len))).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    extra = torch.randn((n_requests, cfg.encoder_frames or cfg.vision_prefix, cfg.d_model),
                        generator=gen, device=device).to(getattr(torch, cfg.dtype))
    return tokens, extra


def generate(cfg, params, tokens, extra, gen: int) -> dict:
    """The model-level entry points as the conformance decode arm drives
    them: ``encode`` (an audio model), ``prefill_with_cache`` of the prompts
    with the extra embeddings at capacity prompt + gen (+ the prefix), then
    gen - 1 greedy ``decode_step``s (the first new token is the prefill's),
    the encoder output passed to each.  Returns the new tokens (B, gen),
    each new token's float32 logits (B, V) on the host, the seconds of the
    prefill (encode included) and of the decode steps, and the launches of
    each."""
    import torch

    from repro_torch.models import decode_step, encode, prefill_with_cache

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    B, S = tokens.shape
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode(cfg, params, extra) if cfg.encoder_layers else None
        logits, cache = prefill_with_cache(cfg, params, tokens, S + gen + cfg.vision_prefix,
                                           extra_embeddings=extra)
        last = logits[:, -1].float()
        tok = torch.argmax(last, dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill = {k.name: k.launches for k in kernels}
        toks, lgs = [tok], [last.cpu().numpy()]
        for _ in range(gen - 1):
            logits, cache = decode_step(cfg, params, tok[:, None], cache, enc)
            last = logits[:, -1].float()
            tok = torch.argmax(last, dim=-1)
            toks.append(tok)
            lgs.append(last.cpu().numpy())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return dict(tokens=torch.stack(toks, 1).cpu().numpy(), logits=lgs, prefill_s=t1 - t0,
                decode_s=t2 - t1, prefill=prefill,
                decode={k.name: k.launches - prefill[k.name] for k in kernels})


def serve_frontend(device, card: str, config, params, runs: dict, profiled: tuple,
                   n_requests: int = 2) -> dict:
    """Serve full-width ``config`` (an audio or VLM model, weights
    ``params``) through its model-level entry points (``generate``) under
    each ``FrontRun`` of ``runs``: ``n_requests`` prompts with their frames
    or patches in one batch, then request 0 alone, which must give the same
    tokens and logits bit for bit.  Each kernel in ``uses`` launches, no
    other, at the counts the run states; new tokens in range, logits finite.
    The labels in ``profiled`` once more under the profiler.  Returns each
    run's launches per decode step, and its results by label."""
    import torch

    out, launches = {}, {}
    for label, run in runs.items():
        cfg = dataclasses.replace(config, numerics=run.numerics)
        tokens, extra = frontend_inputs(cfg, n_requests, run.prompt_len, device)
        torch.cuda.reset_peak_memory_stats()
        res = generate(cfg, params, tokens, extra, run.gen)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = run.gen - 1
        for name in res["prefill"]:
            n = res["prefill"][name] + res["decode"][name]
            if (name in run.uses or name == NORM_KERNEL) != (n > 0):
                raise AssertionError(f"{cfg.name} {label}: kernel {name} launched {n} times")
            if name == NORM_KERNEL:
                continue
            if res["decode"][name] != run.per_step.get(name, 0) * steps or \
                    res["prefill"][name] != run.per_prefill.get(name, 0):
                raise AssertionError(f"{cfg.name} {label}: kernel {name} launched "
                                     f"{res['prefill'][name]} times in the prefill and "
                                     f"{res['decode'][name]} in {steps} steps, expected "
                                     f"{run.per_prefill.get(name, 0)} and "
                                     f"{run.per_step.get(name, 0)} a step")
        if not ((0 <= res["tokens"]) & (res["tokens"] < cfg.vocab)).all() or not all(
                np.isfinite(x).all() and x.shape == (n_requests, cfg.vocab)
                for x in res["logits"]):
            raise AssertionError(f"{cfg.name} {label}: tokens out of range or logits "
                                 f"non-finite or misshapen")
        solo = generate(cfg, params, tokens[:1], extra[:1], run.gen)
        diff = max(float(np.abs(x[:1] - y).max()) for x, y in zip(res["logits"], solo["logits"]))
        if not np.array_equal(solo["tokens"], res["tokens"][:1]) or diff != 0.0:
            raise AssertionError(f"{cfg.name} {label} request 0: batched {res['tokens'][0]} vs "
                                 f"solo {solo['tokens'][0]}, max |logit diff| {diff}")
        per_step = {k: n // steps for k, n in res["decode"].items() if n}
        launches[label] = per_step
        out[label] = res
        n_prompt = n_requests * run.prompt_len
        log(f"[serve] {cfg.name} {label} on {card}: {n_requests} requests of "
            f"{run.prompt_len} tokens and {extra.shape[1]} "
            f"{'frames' if cfg.encoder_layers else 'patches'}, {run.gen} new tokens each; "
            f"prefill{' (encode and the prefill own encoder pass included)' if cfg.encoder_layers else ''} "
            f"{n_prompt} prompt tokens in {res['prefill_s']:.3f}s; "
            f"decode {n_requests * steps} tokens in {steps} steps, {res['decode_s']:.3f}s "
            f"({n_requests * steps / res['decode_s']:.2f} tok/s, "
            f"{1e3 * res['decode_s'] / steps:.1f} ms/step); peak memory {peak:.2f} GiB; "
            f"launches in the prefill {dict((k, n) for k, n in res['prefill'].items() if n)}, "
            f"a decode step {per_step}; batched == solo bit for bit (request 0 tokens "
            f"{solo['tokens'][0].tolist()})")
    for label in profiled:
        run = runs[label]
        cfg = dataclasses.replace(config, numerics=run.numerics)
        tokens, extra = frontend_inputs(cfg, n_requests, run.prompt_len, device)

        def body(_):
            t0 = time.perf_counter()
            generate(cfg, params, tokens, extra, run.gen)
            return (time.perf_counter() - t0) * 1e3

        wall, rows = profile_windows(body, f"{cfg.name} {label}")
        busy = sum(r[0] for r in rows) / 1e3 if rows else None
        ours = sum(r[0] for r in rows if "amr_" in r[2] or "inject_replay" in r[2]
                   or "row_mean_square" in r[2]) / 1e3
        top = [(round(us / 1e3, 1), n, name[:60]) for us, n, name in rows[:6]]
        log(f"[profile] {cfg.name} {label} on {card}: prefill + {run.gen - 1} decode steps, "
            f"{wall:.1f} ms wall, {busy_text(busy, wall)}, hand kernels {ours:.1f} ms; most "
            f"device ms, launches: {top}")
    return launches, out


def _site_counts(cfg, flat: int, grouped: int, encoder: bool = False) -> tuple[int, int]:
    """(flat, grouped) AMR sites of one pass of ``cfg``'s decoder (or, with
    ``encoder``, its encoder): per decoder layer the attention's wq, wk, wv,
    wo and the MLP's three, with cross-attention xattn's four more, and
    attn.qk / attn.pv (twice with cross-attention); per encoder layer its
    attention's four, its MLP's three, attn.qk and attn.pv."""
    cross = bool(cfg.encoder_layers) and not encoder
    layers = cfg.encoder_layers if encoder else cfg.n_layers
    return layers * (flat + 4 * cross), layers * (grouped + 2 * cross)


def phase_whisper(device, card: str, cfg) -> dict:
    """Phase 8d: full-width whisper-small (12 encoder and 12 decoder layers,
    d_model 768, 12 heads of 64, d_ff 3072 gelu, vocab 51865, tied; random
    bf16 weights from seed 0) through its model-level entry points (encode,
    prefill with the frames, greedy decode steps with the encoder output:
    ``generate``): 2 requests of 1500 random frames and WHISPER_PROMPT-token
    prompts, WHISPER_GEN new tokens, under exact, rank 0 and rank 8, each
    batched == solo bit for bit, rank 0 profiled.  The decoder's layers
    project the cross-attention K and V of the 1500 frames at every step
    (xattn.wk / wv at M = 3000), as the JAX package's decode step does.
    Then, in float32 (where the straight-through quantizer of amr_inject
    and the gather's agree on every operand, as in phase 3's dbrx check),
    amr_inject on 2 requests of WHISPER_INJECT_PROMPT tokens, WHISPER_INJECT_GEN
    new: the replay kernel at every AMR site, and its tokens and logits equal
    rank 0's on the same weights and inputs bit for bit.  Returns each run's
    launches per decode step."""
    import torch

    from repro_torch.numerics import AMRNumerics

    rank0 = AMRNumerics("amr_kernel", border=BORDER, rank=0)
    flat, grouped = _site_counts(cfg, 7, 2)
    e_flat, e_grouped = _site_counts(cfg, 7, 2, encoder=True)
    # encode() and the prefill's own encoder pass, then the decoder's prefill
    pre_flat, pre_grouped = 2 * e_flat + flat, 2 * e_grouped + grouped
    lut = {"amr_matmul_int8_lut": flat, "amr_matmul_int8_lut_grouped": grouped}
    lut_pre = {"amr_matmul_int8_lut": pre_flat, "amr_matmul_int8_lut_grouped": pre_grouped}
    runs = {
        "exact": FrontRun(AMRNumerics("exact"), WHISPER_PROMPT, WHISPER_GEN, set(), {}, {}),
        "rank 0": FrontRun(rank0, WHISPER_PROMPT, WHISPER_GEN, GATHERS, lut, lut_pre),
        f"rank {RANK}": FrontRun(AMRNumerics("amr_kernel", border=BORDER, rank=RANK),
                                 WHISPER_PROMPT, WHISPER_GEN, {"amr_matmul_int8"},
                                 {"amr_matmul_int8": flat}, {"amr_matmul_int8": pre_flat}),
    }
    params = model_params(device, cfg)
    launches, _ = serve_frontend(device, card, cfg, params, runs, ("rank 0",))
    del params
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = model_params(device, f32)
    replay = {"inject_replay": flat + grouped}
    inject_runs = {
        "f32 rank 0": FrontRun(rank0, WHISPER_INJECT_PROMPT, WHISPER_INJECT_GEN, GATHERS, lut,
                               lut_pre),
        "f32 amr_inject": FrontRun(AMRNumerics("amr_inject", border=BORDER),
                                   WHISPER_INJECT_PROMPT, WHISPER_INJECT_GEN,
                                   {"inject_replay"}, replay,
                                   {"inject_replay": pre_flat + pre_grouped}),
    }
    more, res = serve_frontend(device, card, f32, params, inject_runs, ())
    launches.update(more)
    a, b = res["f32 rank 0"], res["f32 amr_inject"]
    if not np.array_equal(a["tokens"], b["tokens"]) or not all(
            np.array_equal(x, y) for x, y in zip(a["logits"], b["logits"])):
        raise AssertionError(f"{cfg.name} float32: amr_inject tokens or logits differ from "
                             f"rank 0's")
    log(f"[serve] {cfg.name} float32 on {card}: amr_inject == rank 0 bit for bit (tokens "
        f"{b['tokens'].tolist()} and logits of every new token)")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_vlm(device, card: str, cfg) -> dict:
    """Phase 8e: internvl2-76b at full width (d_model 8192, 64 heads of 128,
    8 KV heads, d_ff 28672 swiglu, vocab 128256, untied, a 256-patch
    prefix) with its depth cut to VLM_LAYERS of 80 layers (its 141 GB of
    bf16 weights do not fit the card; 16 layers are 27.4 GB, with 4.2 GB of
    embedding and head; 24 until the script's time went to later phases),
    random bf16 weights from seed 0, through its
    model-level entry points: 2 requests of 256 random patch embeddings and
    VLM_PROMPT-token prompts, VLM_GEN new tokens, the KV capacity widened by
    the prefix; under exact and rank 0, each batched == solo bit for bit,
    rank 0 profiled.  Returns each run's launches per decode step."""
    import torch

    from repro_torch.numerics import AMRNumerics

    cut = dataclasses.replace(cfg, n_layers=VLM_LAYERS)
    flat, grouped = _site_counts(cut, 7, 2)
    lut = {"amr_matmul_int8_lut": flat, "amr_matmul_int8_lut_grouped": grouped}
    runs = {
        "exact": FrontRun(AMRNumerics("exact"), VLM_PROMPT, VLM_GEN, set(), {}, {}),
        "rank 0": FrontRun(AMRNumerics("amr_kernel", border=BORDER, rank=0), VLM_PROMPT,
                           VLM_GEN, GATHERS, lut, lut),
    }
    torch.cuda.empty_cache()
    log(f"[serve] {cfg.name}: depth cut to {VLM_LAYERS} of {cfg.n_layers} layers (its "
        f"{cfg.n_layers} layers do not fit one card in bf16), full width")
    params = model_params(device, cut)
    log(f"[serve] {cfg.name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights on "
        f"the card")
    launches, _ = serve_frontend(device, card, cut, params, runs, ("rank 0",))
    del params
    torch.cuda.empty_cache()
    return launches


def _dense_launches(cfg):
    """The launches a served dense run of ``cfg`` at rank 0 must make, per
    prefill and per decode step: 7 flat gathers a layer (wq, wk, wv, wo,
    w_gate, w_up, w_down), 2 grouped (attn.qk, attn.pv), and 2 norms a layer
    (ln1, ln2), 2 more with qk-norm (q_norm, k_norm: one launch each over
    every head), and the final norm."""
    L = cfg.n_layers
    norms = (4 if cfg.qk_norm else 2) * L + 1

    def expect(prefills: int, steps: int) -> dict:
        n = prefills + steps
        return {"amr_matmul_int8_lut": 7 * L * n, "amr_matmul_int8_lut_grouped": 2 * L * n,
                NORM_KERNEL: norms * n}
    return expect


def phase_dense_rest(device, card: str) -> dict:
    """Phase 8f: the rest of the dense family at full width, random bf16
    weights from seed 0, each after every earlier model is freed: minitron-8b
    (32 layers, d_model 4096, 32 heads and 8 KV heads of 128, d_ff 16384,
    vocab 256000, untied; 9.87 G parameters) and qwen3-32b (64 layers,
    d_model 5120, 64 heads and 8 KV heads of 128 (a query width of 8192),
    qk-norm, rope theta 1e6, d_ff 25600, vocab 151936, untied; 32.8 G
    parameters, 61.0 GiB) at QWEN_LAYERS of its 64 layers.  Each through
    ``ServeEngine`` at rank 0, DENSE_REQUESTS requests of PROMPT_LEN tokens,
    DENSE_GEN new, 2 slots: the launches checked exactly (``_dense_launches``),
    batched == solo bit for bit (tokens and float32 logits), minitron-8b
    profiled (idle share); prefill seconds, ms per decode step, peak memory
    and launches per decode step printed; qwen3-32b's peak held under
    DENSE_PEAK_GIB.  Then reduced minitron-8b and qwen3-32b card vs CPU
    (``reference_served``: tokens equal, logits within 1e-3 or the trace
    rule at a named tie) at rank 0, and qwen3-32b at rank 8.  Returns each
    run's launch counts."""
    import torch

    from repro_torch.configs import minitron_8b, qwen3_32b
    from repro_torch.numerics import AMRNumerics

    rank0 = AMRNumerics("amr_kernel", border=BORDER, rank=0)
    launches = {}
    for cfg, layers, profiled in ((minitron_8b.CONFIG, minitron_8b.CONFIG.n_layers, ("rank 0",)),
                                  (qwen3_32b.CONFIG, QWEN_LAYERS, ())):
        cut = dataclasses.replace(cfg, n_layers=layers)
        expect = _dense_launches(cut)
        runs = {"rank 0": Run(rank0, DENSE_REQUESTS, DENSE_GEN, GATHERS, expect=expect)}
        torch.cuda.empty_cache()
        if layers < cfg.n_layers:
            log(f"[serve] {cfg.name}: depth cut to {layers} of {cfg.n_layers} layers, full width")
        params = model_params(device, cut)
        log(f"[serve] {cfg.name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights "
            f"on the card")
        stats = {}
        launches[cfg.name] = serve_model(device, card, cut, params, runs, tuple(runs), profiled,
                                         {}, stats=stats)
        st = stats["rank 0"]
        log(f"[dense] {cfg.name} ({layers} of {cfg.n_layers} layers) rank 0 on {card}: prefill "
            f"{st['prefill_s']:.3f}s, {st['ms_per_step']:.1f} ms a decode step, peak "
            f"{st['peak_gib']:.2f} GiB; launches a decode step {expect(0, 1)}, a prefill "
            f"{expect(1, 0)} (checked exactly)")
        if st["peak_gib"] > DENSE_PEAK_GIB:
            raise AssertionError(f"{cfg.name}: peak {st['peak_gib']:.2f} GiB over "
                                 f"{DENSE_PEAK_GIB} GiB")
        del params
        torch.cuda.empty_cache()
    for _ in reference_served(device, [
            (minitron_8b.reduced(), rank0), (qwen3_32b.reduced(), rank0),
            (qwen3_32b.reduced(), AMRNumerics("amr_kernel", border=BORDER, rank=RANK))]):
        pass
    return launches


def parity_cause(arch: str, mode: str, device, seq: int = 12, batch: int = 2,
                 seed: int = 0) -> dict:
    """Why a conformance decode-parity row (``run_decode_parity``'s
    arguments) is past ``PARITY_TOL``, and whether the arm holds without it.

    The forward quantizes a column of V (``attn.pv``'s per-column operand)
    over every position of its pass, the prefill of S - 1 tokens over those
    S - 1: where position S - 1 changes a column's scale, the prefill's
    outputs at earlier positions, and the cache built from them, differ from
    the forward's (JAX's quantization is the same).  So the arm is held
    where (1) the decode of token S - 1 on the forward's own cache (a
    prefill of all S tokens, rewound one position) gives the forward's last
    logits bit for bit, or, where a window ring quantizes V over the window
    alone, within ``PARITY_TOL``; and (2) the first layer whose cache
    differs between the two prefills at their shared positions is named:
    the leaf, the position, the difference.  An SSM state cannot be
    rewound: such a row is not held."""
    import torch

    from repro_torch import conformance as conf
    from repro_torch.models import (decode_step, encode, forward, group_structure,
                                    init_params, prefill_with_cache)
    from repro_torch.models.attention import KVCache

    cfg = conf.tiny_config(arch, mode)
    kinds, n_repeat = group_structure(cfg)
    params = init_params(cfg, seed, device=device)
    inputs = conf.make_inputs(cfg, batch, seq, seed, device=device)
    toks, extra = inputs["tokens"], inputs.get("extra")
    cap = seq + cfg.vision_prefix
    with torch.inference_mode():
        enc_out = encode(cfg, params, extra) if cfg.encoder_layers else None
        ref = forward(cfg, params, toks, extra)[0][:, -1].float()
        _, short = prefill_with_cache(cfg, params, toks[:, :-1], capacity=cap,
                                      extra_embeddings=extra)
        _, full = prefill_with_cache(cfg, params, toks, capacity=cap, extra_embeddings=extra)
        if not all(isinstance(c, KVCache) for c in full):
            return {"held": False, "why": "an SSM state cannot be rewound"}
        rewound = tuple(dataclasses.replace(c, length=c.length - 1) for c in full)
        got = decode_step(cfg, params, toks[:, -1:], rewound, enc_out)[0][:, 0].float()
    own = float((got - ref).abs().max())
    ring = any(c.k.shape[2] < cap for c in full)
    first = None
    last = cfg.vision_prefix + seq - 1  # the positions both prefills hold: < last
    for g in range(n_repeat):
        for i, (a, b) in enumerate(zip(short, full)):
            C = a.k.shape[2]
            pos = list(range(max(0, last - C + 1) if C < cap else 0, last))
            slots = torch.tensor([p % C for p in pos], device=a.k.device)
            for leaf in ("k", "v"):
                d = (getattr(a, leaf)[g][:, slots].float()
                     - getattr(b, leaf)[g][:, slots].float()).abs()
                if first is None and float(d.max()) > 0:
                    where = int(d.amax(dim=(0, 2, 3)).argmax())
                    first = {"layer": g * len(kinds) + i, "kind": kinds[i], "leaf": leaf,
                             "position": pos[where], "max_abs_diff": float(d.max())}
    held = (own <= conf.PARITY_TOL[mode] if ring else own == 0.0) and first is not None
    return {"held": held, "decode_on_own_cache_diff": own, "window_ring": ring,
            "first_differing_cache": first}


def phase_conformance(device) -> dict:
    """Phase 10: the port's conformance matrix (``repro_torch.conformance``)
    on the card, its reduced models on the hand kernels: ``run_train_arm``
    and ``run_decode_parity`` for each ``REPRESENTATIVE`` arch and for
    reduced minitron-8b and qwen3-32b under every registered mode;
    ``run_inject_audit`` for every arch of ``families()`` and once more on
    the dense representative with a registered DSE candidate
    (``DSE_CANDIDATE``, its oracle table by ``core/dse/export.
    lut_from_schedule``); ``run_noise_decorrelation`` for every
    representative; ``run_restart_arm`` (gemma-2b, amr_inject) under both
    preemption protocols (the loop's event and a real SIGTERM).  Every train
    row finite and non-degenerate, every audit bit-exact with the family's
    ``ACTIVATION_SITES`` among its sites, every parity row within
    ``PARITY_TOL``, noise reproducible and decorrelated, both restarts bit
    for bit with the debris cleaned.  Prints one line of counts and one a
    failed row, then raises if any failed.  Returns the launches of each
    kernel over the phase."""
    from repro_torch import conformance as conf
    from repro_torch.configs import families
    from repro_torch.core.dse import ColumnChoice, materialize_choices
    from repro_torch.numerics import injection, mode_names

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    family = {a: f for f, archs in families().items() for a in archs}
    rows, failed, held = [], [], []

    def check(row: dict, ok: bool) -> None:
        rows.append(row)
        if not ok:
            failed.append(row)
            log(f"[conformance] FAILED {json.dumps(row)}")

    t0 = time.perf_counter()
    for arch in [*conf.REPRESENTATIVE.values(), "minitron-8b", "qwen3-32b"]:
        for mode in mode_names():
            row = conf.run_train_arm(arch, mode, device=device)
            check(row, row["loss_finite"] and row["grad_finite"] and row["nondegenerate"])
            row = conf.run_decode_parity(arch, mode, device=device)
            if not row["within_tol"]:
                row["cause"] = parity_cause(arch, mode, device)
                held.append(row)
                log(f"[conformance] parity past its tolerance: {json.dumps(row)}")
            check(row, row["within_tol"] or row["cause"]["held"])
    t1 = time.perf_counter()
    dse = injection.register_schedule(
        materialize_choices(2, BORDER, [ColumnChoice(*c) for c in DSE_CANDIDATE]),
        name="chip_smoke:dse")
    audits = [(a, None) for a in family] + [(conf.REPRESENTATIVE["dense"], dse)]
    for arch, ref in audits:
        row = conf.run_inject_audit(arch, schedule_ref=ref, device=device)
        check(row, row["bit_exact"]
              and conf.ACTIVATION_SITES[family[arch]] <= set(row["site_diffs"]))
    for arch in conf.REPRESENTATIVE.values():
        row = conf.run_noise_decorrelation(arch, device=device)
        check(row, row["reproducible"] and row["steps_decorrelated"])
    t2 = time.perf_counter()
    for use_signal in (False, True):
        row = conf.run_restart_arm("gemma-2b", use_signal=use_signal, device=device)
        row["protocol"] = "sigterm" if use_signal else "event"
        check(row, row["bit_exact"] and row["tmp_cleaned"])
    t3 = time.perf_counter()
    kinds: dict = {}
    for row in rows:
        kinds[row["kind"]] = kinds.get(row["kind"], 0) + 1
    worst = max((r["parity_diff"] / r["tol"], r["arch"], r["mode"]) for r in rows
                if r["kind"] == "decode_parity" and r["applicable"])
    counts = {k.name: k.launches for k in kernels}
    for name in sorted(GATHERS | {"inject_replay", "ssd_scan", "ssd_scan_bwd", NORM_KERNEL}):
        if not counts[name]:
            check({"kind": "launches", "kernel": name}, False)
    log(f"[conformance] {len(rows)} rows ({json.dumps(kinds)}), {len(failed)} failed; "
        f"train + parity {t1 - t0:.1f}s, audits + noise {t2 - t1:.1f}s, restarts "
        f"{t3 - t2:.1f}s; widest parity {worst[0]:.3f} of its tolerance ({worst[1]}, "
        f"{worst[2]}); {len(held)} parity rows past it held by ``parity_cause``; audits "
        f"{sum(r['calls'] for r in rows if r['kind'] == 'inject_audit')} call sites; "
        f"launches {counts}")
    if failed:
        raise AssertionError(f"[conformance] {len(failed)} of {len(rows)} rows failed")
    return counts


def _digits_bits(n_digits: int, batch: int, seed: int) -> tuple:
    """Seeded random MRSD operands: (x digits, y digits, x bits, y bits)."""
    from repro_torch.core import mrsd, ppgen

    rng = np.random.default_rng(seed)
    xd, yd = mrsd.random_digits(rng, n_digits, batch), mrsd.random_digits(rng, n_digits, batch)
    return xd, yd, ppgen.flatten_operand_bits(xd), ppgen.flatten_operand_bits(yd)


def _same_split(what: str, got: tuple, want: tuple) -> None:
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError(f"[core] {what}: the card's (lo, hi) differ from numpy's")


def _numpy_split(job: tuple) -> tuple:
    """A worker's numpy replay: (schedule, x bits, y bits) -> (lo, hi)."""
    from repro_torch.core import reduction

    return reduction.evaluate_split(*job)


def _numpy_splits(jobs: list) -> list:
    """``reduction.evaluate_split`` of each (schedule, x bits, y bits), in
    CORE_NUMPY_WORKERS spawned processes (the 8-digit replays take seconds
    each on the host), all stopped before it returns."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(CORE_NUMPY_WORKERS) as pool:
        return pool.map(_numpy_split, jobs, chunksize=1)


def _chunk_breakdown(m, device, card: str, reps: int = 4) -> dict:
    """Where one 32768-sample Monte-Carlo chunk of ``m`` goes: ms of the
    host's draw, its bit flattening (``monte_carlo`` flattens for the
    approximate and the exact multiplier both), one engine call (pack, copy
    in, replay, copy out), the float64 sums; and the device busy ms and
    idle share of ``reps`` chunks of ``monte_carlo`` under the profiler."""
    import torch

    from repro_torch.core import engine, metrics, mrsd, ppgen

    n, rng = m.cfg.n_digits, np.random.default_rng(1)
    eng = engine.get_engine(n, m.cfg.border, device)
    ms: dict = {}

    def timed(name, fn):
        t = time.perf_counter()
        for _ in range(reps):
            res = fn()
        ms[name] = (time.perf_counter() - t) / reps * 1e3
        return res

    xd, yd = timed("draw", lambda: (mrsd.random_digits(rng, n, 32768),
                                    mrsd.random_digits(rng, n, 32768)))
    xb, yb = timed("flatten", lambda: (ppgen.flatten_operand_bits(xd),
                                       ppgen.flatten_operand_bits(yd)))
    lo, hi = timed("engine", lambda: eng.evaluate_split(xb, yb))
    acc = metrics.ErrorAccumulator(max_abs=1.0)
    timed("sums", lambda: acc.update_split(lo, hi, lo, hi))
    def body(_):
        t = time.perf_counter()
        m.monte_carlo(reps * 32768, seed=1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    wall, prof = profile_windows(body, "core monte_carlo")
    busy = sum(r[0] for r in prof) / 1e3 if prof else None
    log(f"[core] (b) a 32768-sample chunk at ({n}, {m.cfg.border}), ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()) + f"; monte_carlo of {reps} chunks under the "
        f"profiler: {busy_text(busy, wall)} of {wall:.1f} ms wall, "
        f"{sum(r[1] for r in prof)} device events ({card})")
    return dict(ms, busy_ms=busy, wall_ms=wall)


def _direct_metrics(schedule, n_samples: int, device, chunk: int = 16384) -> dict:
    """``measure_candidates``' protocol with each chunk replayed by the
    candidate's own engine and the exact one's, one schedule a call (the
    JAX package's ``dse_bench`` replay_match oracle)."""
    from repro_torch.core import engine, metrics, mrsd, ppgen

    n = schedule.n_digits
    eng, exact = engine.compile_schedule(schedule, device), engine.get_engine(n, None, device)
    acc = metrics.ErrorAccumulator(max_abs=(16.0 ** n * (16.0 / 15.0)) ** 2)
    rng = np.random.default_rng(0)
    remaining = n_samples
    while remaining > 0:
        b = min(chunk, remaining)
        xb = ppgen.flatten_operand_bits(mrsd.random_digits(rng, n, b))
        yb = ppgen.flatten_operand_bits(mrsd.random_digits(rng, n, b))
        acc.update_split(*eng.evaluate_split(xb, yb), *exact.evaluate_split(xb, yb))
        remaining -= b
    return acc.result()


def phase_core(device, card: str) -> dict:
    """Phase 11: the Monte-Carlo engine and the rest of ``core/`` on the card
    (``repro_torch.core``; no hand kernel: the engine is torch ops).

    (a) On each width's first Monte-Carlo chunk (``monte_carlo``'s: seed 0,
    CORE_CHUNK pairs), the torch engine's exact (lo, hi) splits equal the
    numpy ``reduction.evaluate_split``'s (replayed in CORE_NUMPY_WORKERS
    processes) bit for bit at n_digits {2, 4, 8} x border {None, 4, 8} and
    the 15 Table I points, and ``evaluate_split_many`` and a
    ``CandidateBatch`` equal the one-schedule calls.  (b) Table I at the
    paper's own sample counts (TABLE1_SAMPLES) through
    ``AMRMultiplier(...).monte_carlo`` on the card at every point: MRED /
    MARED / NMED, seconds and samples/s beside the paper's MARED; where one
    chunk's time goes at (8, 50) (``_chunk_breakdown``).  (c)
    ``build_int8_luts`` on the card equal to the numpy tables that serving
    reads, for None and borders 0-14.  (d) The port's
    ``search_assignments(2, 8, ...)`` gives ``DSE_CANDIDATE``;
    ``pareto_sweep`` at CORE_SWEEP's sizes with
    ``energy.literal_energy_proxy``, every frontier point's measured metrics
    equal to a direct one-schedule replay's (``_direct_metrics``: replay
    match), and the sweep's candidate batch on its first chunk (every
    candidate and the exact schedule) equal to numpy's; ``select_border``
    over the two widest 4-digit borders under CORE_BUDGET equal to the
    cheapest swept point of those within it.  (e) At 2 digits over all
    65,536 int8 pairs, the engine's products equal the CUDA replay kernel's
    (``kernels/inject_replay``; its launches here are comparisons, not
    counted) and the numpy table, for the exact schedule, border 8 and the
    DSE candidate.  Raises on any mismatch.  Returns the phase's figures."""
    import torch

    from repro_torch.core import AMRMultiplier, dse, energy, engine, lut, reduction
    from repro_torch.core.engine import compile_injector, get_injector
    from repro_torch.kernels.inject_replay.ops import inject_replay_matmul

    out: dict = {}
    # (a) bit-exact engine, on each width's first Monte-Carlo chunk
    t0 = time.perf_counter()
    mults, jobs, card_splits = {}, [], []
    for n, points in TABLE1_MARED.items():
        xd, yd, xb, yb = _digits_bits(n, CORE_CHUNK, seed=0)
        borders = tuple(dict.fromkeys((None, 4, 8, *points)))
        singles = {}
        for b in borders:
            m = mults[n, b] = AMRMultiplier(n, b, device=device)
            singles[b] = m.multiply_digits_split(xd, yd)
            card_splits.append((f"({n}, {b}) chunk 1", singles[b]))
            jobs.append((m.schedule, xb, yb))
        many = engine.evaluate_split_many(n, borders, xb, yb, device)
        batch = engine.compile_candidates([mults[n, b].schedule for b in borders], device)
        for b, got in zip(borders, batch.evaluate_split(xb, yb)):
            _same_split(f"({n}, {b}) evaluate_split_many", many[b], singles[b])
            _same_split(f"({n}, {b}) CandidateBatch", got, singles[b])
    for (what, got), want in zip(card_splits, _numpy_splits(jobs)):
        _same_split(what, got, want)
    out["a_s"] = time.perf_counter() - t0
    log(f"[core] (a) {len(jobs)} design points on each width's first Monte-Carlo chunk "
        f"({CORE_CHUNK} pairs): the card's splits equal numpy's, evaluate_split_many and "
        f"CandidateBatch the one-schedule calls ({out['a_s']:.1f}s, schedules built and "
        f"numpy replays included; {card})")

    # (b) Table I at the paper's sample counts
    t1 = time.perf_counter()
    rows = []
    for n, points in TABLE1_MARED.items():
        exact = mults[n, None]
        for b, paper in points.items():
            m = mults[n, b]
            ts = time.perf_counter()
            r = m.monte_carlo(TABLE1_SAMPLES[n], seed=0, exact_ref=exact)
            s = time.perf_counter() - ts
            if r["n_samples"] != TABLE1_SAMPLES[n] or not all(map(math.isfinite, r.values())):
                raise AssertionError(f"[core] Table I ({n}, {b}): {r}")
            row = dict(n_digits=n, border=b, mred=r["mred"], mared=r["mared"], nmed=r["nmed"],
                       paper_mared=paper, samples=TABLE1_SAMPLES[n], seconds=s,
                       samples_per_s=TABLE1_SAMPLES[n] / s)
            rows.append(row)
            log(f"[core] (b) Table I {n} digits, border {b}: MRED {r['mred']:+.4e}, MARED "
                f"{r['mared']:.4e} (paper {paper:.2e}, ratio {r['mared'] / paper:.3f}), NMED "
                f"{r['nmed']:+.4e}; {TABLE1_SAMPLES[n]} samples in {s:.3f}s, "
                f"{TABLE1_SAMPLES[n] / s:.4g} samples/s ({card})")
    head = next(r for r in rows if (r["n_digits"], r["border"]) == (8, 50))
    log(f"[core] (b) headline: 8 digits at border 50, MARED {head['mared']:.4e} against the "
        f"paper's {head['paper_mared']:.2e} ({card})")
    out["table1"], out["b_s"] = rows, time.perf_counter() - t1
    out["chunk_ms"] = _chunk_breakdown(mults[8, 50], device, card)

    # (c) LUT builds on the card against the served numpy tables
    t2 = time.perf_counter()
    borders = (None, *range(15))
    built = lut.build_int8_luts(borders, device=device)
    c_build = time.perf_counter() - t2
    for b in borders:
        rec = lut.lut_record(b, "torch", device)
        if rec.device != torch.device(device) or rec.table is not built[b]:
            raise AssertionError(f"[core] (c) border {b}: provenance {rec.engine}, {rec.device}")
        if not np.array_equal(built[b], lut.build_int8_lut(b, engine="numpy")):
            raise AssertionError(f"[core] (c) border {b}: the card's table differs from numpy's")
    out["c_build_s"] = c_build
    log(f"[core] (c) {len(borders)} int8 tables built on the card in {c_build:.3f}s, each "
        f"equal to the served numpy table ({card})")

    # (d) the whole-multiplier DSE
    t3 = time.perf_counter()
    [cand] = dse.search_assignments(2, BORDER, k=1, beam_width=8, branch_cap=4, max_nodes=2000)
    if [dataclasses.astuple(c) for c in cand.choices] != [tuple(c) for c in DSE_CANDIDATE]:
        raise AssertionError("[core] (d) the port's search no longer gives DSE_CANDIDATE")
    sweep, jobs, card_splits = {}, [], []
    for n, (borders, samples) in CORE_SWEEP.items():
        ts = time.perf_counter()
        points = dse.pareto_sweep(n, borders, k=1, n_samples=samples, chunk=16384,
                                  cost_fn=energy.literal_energy_proxy, device=device,
                                  **CORE_SEARCH)
        s = time.perf_counter() - ts
        sweep[n] = points
        for pt in points:
            match = (_direct_metrics(pt.schedule, samples, device) == pt.measured
                     if pt.frontier else None)
            log(f"[core] (d) {n} digits, border {pt.border}, candidate {pt.candidate}: "
                f"expected error {float(pt.assignment.expected_error):+.6g}, MRED "
                f"{pt.measured['mred']:+.4e}, MARED {pt.measured['mared']:.4e}, energy "
                f"{pt.energy:.0f}, nodes {pt.assignment.nodes}, complete "
                f"{pt.assignment.complete}, frontier {pt.frontier}, replay_match {match}")
            if match is False:
                raise AssertionError(f"[core] (d) ({n}, {pt.border}, {pt.candidate}): the "
                                     f"candidate batch's metrics differ from a direct replay")
        log(f"[core] (d) {n} digits: {len(points)} candidates, "
            f"{sum(p.frontier for p in points)} on the frontier, {samples} samples each; "
            f"search + measure {s:.1f}s ({card})")
        # the sweep's candidate batch (its candidates, then the exact
        # schedule, as measure_candidates compiles it) on its first chunk
        scheds = [*(pt.schedule for pt in points), reduction.get_schedule(n, None)]
        _, _, xb, yb = _digits_bits(n, min(16384, samples), seed=0)
        outs = engine.compile_candidates(scheds, device).evaluate_split(xb, yb)
        for i, (sched, got) in enumerate(zip(scheds, outs)):
            card_splits.append((f"(d) {n} digits, candidate batch entry {i}", got))
            jobs.append((sched, xb, yb))
    for (what, got), want in zip(card_splits, _numpy_splits(jobs)):
        _same_split(what, got, want)
    log(f"[core] (d) the sweeps' candidate batches on their first chunk equal numpy's: "
        f"{len(jobs)} schedules, each width's exact one included")
    key, budget = CORE_BUDGET
    n, (borders, samples) = 4, CORE_SWEEP[4]
    borders = borders[-2:]  # the two widest borders, the cheapest
    chosen = dse.select_border(n, borders, max_err=budget, err_key=key, n_samples=samples,
                               chunk=16384, cost_fn=energy.literal_energy_proxy,
                               device=device, **CORE_SEARCH)
    ok = [p for p in sweep[n] if p.border in borders and abs(p.measured[key]) <= budget]
    want = min(ok, key=lambda p: (p.energy, p.border)).border if ok else None
    if chosen != want:
        raise AssertionError(f"[core] (d) select_border gave {chosen}, the sweep {want}")
    out["d_s"] = time.perf_counter() - t3
    log(f"[core] (d) select_border({n}, {borders}, |{key}| <= {budget}) = {chosen}; DSE "
        f"{out['d_s']:.1f}s ({card})")

    # (e) a third evaluator: the CUDA replay kernel over every int8 pair
    t4 = time.perf_counter()
    ia = torch.arange(256, dtype=torch.int32, device=device).reshape(256, 1)
    ib = torch.arange(256, dtype=torch.int32, device=device).reshape(1, 256)
    xb, yb = lut._int8_operand_bits()
    for label, sched in (("exact", reduction.get_schedule(2, None)),
                         (f"border {BORDER}", reduction.get_schedule(2, BORDER)),
                         ("DSE candidate", dse.materialize(cand))):
        inj = (get_injector(2, sched.border) if sched is reduction.get_schedule(2, sched.border)
               else compile_injector(sched))
        kernel = inject_replay_matmul(inj, ia, ib).cpu().numpy().astype(np.int64)
        lo, hi = engine.compile_schedule(sched, device).evaluate_split(xb, yb)
        products = (lo + (hi << 32)).reshape(256, 256)
        if not (np.array_equal(products, kernel)
                and np.array_equal(products, dse.lut_from_schedule(sched))):
            raise AssertionError(f"[core] (e) {label}: engine, replay kernel and numpy table "
                                 f"disagree")
    out["e_s"] = time.perf_counter() - t4
    log(f"[core] (e) the engine's products equal the replay kernel's and the numpy table "
        f"over all 65536 int8 pairs: exact, border {BORDER}, the DSE candidate "
        f"({out['e_s']:.1f}s; {card})")
    log("[core] seconds: " + json.dumps({k: round(v, 3) for k, v in out.items()
                                         if isinstance(v, float)}) + f" ({card})")
    return out


def chunked_prefill(device, card: str, cfg, params) -> None:
    """One full-width gemma3-1b attention layer prefilled at S = 16384 under
    rank 0, its first window layer (512) and its first global layer: the
    entry point (``attend_prefill``) takes the chunked form, 8 query blocks
    of 2048 (two grouped gather launches a block, four flat ones for the
    projections), and the chunked form equals the one-block form bit for
    bit (the integer products are exact, and Q and P quantize per row, K
    and V per column, over the same D and S in both).  Times and peak
    memory of both forms."""
    import torch

    from repro_torch.kernels.amr_matmul import kernel
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import dense, embed, rms_norm
    from repro_torch.numerics import AMRNumerics

    nm = AMRNumerics("amr_kernel", border=BORDER, rank=0)
    S = G3_CHUNKED_S
    if not attn.takes_chunked_path(S):
        raise AssertionError(f"S = {S} does not take the chunked path")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (1, S)))
    x = embed(params["embed"], tokens.to(device))
    positions = torch.arange(S, device=device).expand(1, S)
    kinds = cfg.pattern.kinds
    for i in (kinds.index("swa"), kinds.index("full")):
        window = cfg.sliding_window if kinds[i] == "swa" else 0
        layer = {k: t[0] for k, t in params["layers"][i]["attn"].items()}
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                  theta=cfg.rope_theta, qk_norm=cfg.qk_norm, numerics=nm, eps=cfg.norm_eps)
        with torch.inference_mode():
            h = rms_norm(x, params["layers"][i]["ln1"][0], cfg.norm_eps)
            for kern in kernel.KERNELS:
                kern.launches = 0
            out, cache = attn.attend_prefill(layer, h, min(S, window) if window else S,
                                             window=window, **kw)
            torch.cuda.synchronize()
            counts = {kern.name: kern.launches for kern in kernel.KERNELS}
            want = {"amr_matmul_int8_lut": 4, "amr_matmul_int8_lut_grouped": 2 * S // attn._Q_CHUNK,
                    "amr_matmul_int8": 0}
            if counts != want:
                raise AssertionError(f"gemma3-1b layer {i} prefill at S = {S}: launches "
                                     f"{counts}, expected {want}")
            q, k, v = attn._project_qkv(layer, h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                        positions, cfg.rope_theta, cfg.qk_norm, nm, cfg.norm_eps)
            forms, ms, peak = {}, {}, {}
            for form, fn in (("chunked", lambda: attn._chunked_attention(
                                  q, k, v, window, x.dtype, nm)),
                             ("one block", lambda: attn._attend_rows(
                                  q, k, v, torch.arange(S, device=device), window, x.dtype,
                                  nm))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                forms[form] = fn()
                torch.cuda.synchronize()
                ms[form] = (time.perf_counter() - t0) * 1e3
                peak[form] = torch.cuda.max_memory_allocated() / 2**30
            equal = torch.equal(forms["chunked"], forms["one block"])
            entry = dense(forms["chunked"].reshape(1, S, -1), layer["wo"], nm, site="attn.wo")
            if not equal or not torch.equal(entry, out):
                diff = float((forms["chunked"].float() - forms["one block"].float()).abs().max())
                raise AssertionError(f"gemma3-1b layer {i} at S = {S}: chunked and one-block "
                                     f"attention differ (max |diff| {diff}), or the entry "
                                     f"point's output is not the chunked form's")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"gemma3-1b layer {i} at S = {S}: non-finite output")
        log(f"[chunked] gemma3-1b layer {i} ({kinds[i]}, window {window}) on {card}: prefill "
            f"of {S} tokens at rank 0, entry point launches {counts}; chunked == one block bit "
            f"for bit; attention ms chunked {ms['chunked']:.1f}, one block "
            f"{ms['one block']:.1f}; peak memory chunked {peak['chunked']:.2f} GiB, one block "
            f"{peak['one block']:.2f} GiB; cache {tuple(cache.k.shape)}")
        del forms, out, cache, q, k, v, h


# ------------------------------------------------------------------ training
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 3  # amr-paper-100m: 2048 tokens a step
G3_TRAIN_BATCH, G3_TRAIN_SEQ = 2, 512            # gemma3-1b: 1024 tokens a step
# phase 9a, card vs CPU: the loss, relative, where the AMR products are integer
# sums (rank 0, amr_inject) and where they are float sums whose int8 indices
# may sit at a rounding tie (rank 8, amr_lowrank: the card sums in another
# order, and a moved index moves every later layer); a gradient leaf's max
# |card - CPU| over its max |CPU| (integer sums; float sums take the
# correlation rule).  In every mode the forward's quantizations, call by
# call: the rounded values x / scale within PARITY_TRACE_TOL int8 steps
# until and at the first call where an index moves (``_trace_rule``)
PARITY_LOSS_RTOL, PARITY_LOSS_RTOL_FLOAT_SUMS = 1e-4, 1e-2
PARITY_GRAD_TOL = 1e-3
PARITY_TRACE_TOL = 1e-3


def train_policies(amr_cfg) -> dict:
    """amr-paper-100m's four training policies: its own (amr_lowrank, border
    8, rank 16) and amr_kernel rank 0, rank 8 and amr_inject at border 8:
    (numerics, the hand kernels it must launch and no other, whether its
    products are float sums whose int8 indices may sit at a rounding tie)."""
    from repro_torch.numerics import AMRNumerics

    return {"amr_lowrank r16": (amr_cfg.numerics, set(), True),
            "rank 0": (AMRNumerics("amr_kernel", border=BORDER, rank=0), GATHERS, False),
            f"rank {RANK}": (AMRNumerics("amr_kernel", border=BORDER, rank=RANK),
                             {"amr_matmul_int8"}, True),
            "amr_inject": (AMRNumerics("amr_inject", border=BORDER), {"inject_replay"}, False)}


def _train_batch(data, i: int, device) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}


def _leaf_rule(got, want, statistical: bool) -> tuple[bool, float, str]:
    """A gradient leaf card vs CPU: max |diff| <= PARITY_GRAD_TOL * max |CPU|,
    or, for the float products whose int8 indices may sit at a rounding tie
    (rank 8, amr_lowrank: other summation orders on the card), the
    correlation rule of tests/test_torch_gemma3.py (correlation >= 0.98,
    mean |diff| <= 0.15 mean |CPU|).  Returns (held, max |diff| / max
    |CPU|, what was read)."""
    g, w = got.detach().float().cpu().numpy().ravel(), want.detach().float().numpy().ravel()
    diff = np.abs(g - w)
    rel = float(diff.max()) / max(float(np.abs(w).max()), 1e-30)
    if not np.isfinite(g).all():
        return False, rel, "non-finite gradient"
    if statistical:
        corr = float(np.corrcoef(g, w)[0, 1]) if w.std() > 0 else 1.0
        return (corr >= 0.98 and diff.mean() <= 0.15 * np.abs(w).mean(), rel,
                f"correlation {corr}, mean |diff| {diff.mean()} vs mean |CPU| {np.abs(w).mean()}")
    return rel <= PARITY_GRAD_TOL, rel, f"max |diff| {rel} of max |CPU|"


def _trace_rule(got: list, want: list) -> dict:
    """Two ``record_quantizations`` traces of one forward, call by call: the
    int8 indices agree until the first call where one moves, and the
    rounded values differ by at most PARITY_TRACE_TOL int8 steps in every
    call until and at that one, so a moved index sat within that distance
    of a rounding tie.  Returns ``ok`` and what was read: the calls, the
    first with a moved index (None: none moved), its moved indices and the
    largest distance of their CPU values from a tie, the largest difference
    of rounded values up to it, and the calls with a moved index; for the
    first moved index its call's shape, its coordinates and its values
    (``want``'s, then ``got``'s)."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} quantizations against {len(want)}")
    out = {"calls": len(want), "first_moved": None, "moved": 0, "tie_distance": None,
           "max_step_diff": 0.0,
           "calls_moved": sum(bool((qg != qw).any()) for (_, qg), (_, qw) in zip(got, want))}
    for i, ((xg, qg), (xw, qw)) in enumerate(zip(got, want)):
        if xg.shape != xw.shape:
            raise AssertionError(f"quantization {i}: shapes {tuple(xg.shape)} vs {tuple(xw.shape)}")
        out["max_step_diff"] = max(out["max_step_diff"], float((xg - xw).abs().max()))
        moved = qg != qw
        if moved.any():
            at = xw[moved]
            out.update(first_moved=i, moved=int(moved.sum()),
                       tie_distance=float(((at - at.floor()) - 0.5).abs().max()),
                       first_moved_shape=list(xw.shape),
                       first_moved_at=moved.nonzero()[0].tolist(),
                       values=[float(xw[moved][0]), float(xg[moved][0])])
            break
    out["ok"] = out["max_step_diff"] <= PARITY_TRACE_TOL
    return out


def _parity_run(cfg, params, data, dev) -> tuple[list, object, list]:
    """Reduced ``cfg`` on ``dev`` from a copy of ``params``: the quantization
    trace of one forward (no grad) on batch 0, the gradients of one step on
    it, and the losses of two AdamW steps on batches 0 and 1."""
    import torch

    from repro_torch.models.tree import tree_map
    from repro_torch.numerics.quant import record_quantizations
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import TrainState, loss_fn, make_grads_step, make_train_step

    p = tree_map(lambda t: t.to(dev, copy=True), params)
    batch = _train_batch(data, 0, dev)
    with torch.no_grad(), record_quantizations() as rec:
        loss_fn(cfg, p, batch["tokens"], batch["targets"])
    trace = [(xs.cpu(), q.cpu()) for xs, q in rec]
    grads = make_grads_step(cfg)(p, batch)
    state = TrainState(p, adamw_init(p), torch.zeros((), dtype=torch.int32, device=dev))
    step = make_train_step(cfg, peak_lr=3e-3, warmup=1, total_steps=10)
    losses = []
    for i in range(2):
        state, m = step(state, _train_batch(data, i, dev))
        losses.append(float(m["loss"]))
    return trace, grads, losses


def _loss_and_grad_rules(l_got, l_want, g_got, g_want, rtol: float,
                         statistical: bool) -> list[str]:
    """The loss and gradient rules of phase 9a: what failed (empty: held)."""
    from repro_torch.models.tree import tree_items

    failed = [f"losses {l_got} vs {l_want}" for a, b in zip(l_got, l_want)
              if not (math.isfinite(a) and abs(a - b) <= rtol * abs(b))][:1]
    want = dict(tree_items(g_want))
    for key, g in tree_items(g_got):
        held, _, detail = _leaf_rule(g, want[key], statistical)
        if not held:
            failed.append(f"{key}: {detail}")
    return failed


def phase_train_parity(device) -> None:
    """Phase 9a: reduced amr-paper-100m in float32 on the card (kernels) and
    on the CPU (plain versions), the same weights (``init_params`` on the CPU,
    moved) and the same ``SyntheticLM`` batches, under each training policy:
    the quantizations of one forward (``_trace_rule``), the gradients of one
    step and the losses of two AdamW steps.  For the float-sum modes a
    control on the CPU, the same mode at border 0 (no error lanes: exact
    int8 products), must fail the trace rule, which shows that the rule
    tells the two apart; whether the loss and gradient rules alone would
    have passed it is printed."""
    import torch

    from repro_torch.configs import amr_paper
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.models.tree import tree_items

    cfg = dataclasses.replace(amr_paper.reduced(), dtype="float32")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    params = init_params(cfg, 0, device="cpu")
    cpu = torch.device("cpu")
    for label, (nm, _, statistical) in train_policies(amr_paper.CONFIG).items():
        c = dataclasses.replace(cfg, numerics=nm)
        t_cpu, g_cpu, l_cpu = _parity_run(c, params, data, cpu)
        t_card, g_card, l_card = _parity_run(c, params, data, device)
        trace = _trace_rule(t_card, t_cpu)
        if not trace["ok"]:
            raise AssertionError(f"[train] parity {label}: quantizations card vs CPU {trace}")
        rtol = PARITY_LOSS_RTOL_FLOAT_SUMS if statistical else PARITY_LOSS_RTOL
        failed = _loss_and_grad_rules(l_card, l_cpu, g_card, g_cpu, rtol, statistical)
        if failed:
            raise AssertionError(f"[train] parity {label}: {failed}")
        want = dict(tree_items(g_cpu))
        worst = max(_leaf_rule(g, want[k], statistical)[1] for k, g in tree_items(g_card))
        log(f"[train] parity reduced amr-paper-100m f32 {label}: quantizations card vs CPU "
            f"{trace}; losses card {l_card} vs CPU {l_cpu} (rtol {rtol}); gradients: max over "
            f"leaves of max |diff| / max |CPU| {worst:.3g} "
            f"({'correlation rule' if statistical else f'<= {PARITY_GRAD_TOL}'})")
        if statistical:
            control = dataclasses.replace(cfg, numerics=dataclasses.replace(nm, border=0))
            t_ctl, g_ctl, l_ctl = _parity_run(control, params, data, cpu)
            ctl = _trace_rule(t_ctl, t_cpu)
            if ctl["ok"]:
                raise AssertionError(f"[train] parity {label}: the trace rule passes the border-0 "
                                     f"control {ctl}")
            ctl_failed = _loss_and_grad_rules(l_ctl, l_cpu, g_ctl, g_cpu, rtol, statistical)
            log(f"[train] parity {label} control at border 0 on the CPU: quantizations vs "
                f"border {nm.border} {ctl} (rejected); the loss and gradient rules alone "
                f"{'reject it: ' + '; '.join(ctl_failed[:3]) if ctl_failed else 'would pass it'} "
                f"(losses {l_ctl})")


def phase_train_parity_ssm(device) -> None:
    """Phase 9a for the SSM and hybrid families: reduced mamba2-370m and
    zamba2-1.2b in float32 on the card (the SSD kernel and its backward) and
    on the CPU (plain versions, autograd through the plain scan), the same
    weights and ``SyntheticLM`` batches of 40 tokens (a ragged third chunk
    of 16), under exact (the scan in full mode) and rank 0 (split mode),
    by the rank-0 rules: one step's gradients (each leaf within
    PARITY_GRAD_TOL of its max; the unread leaves zero on both) and two
    AdamW steps' losses (PARITY_LOSS_RTOL).  The quantizations of one
    forward are printed (``_trace_rule``), not held to its 1e-3 steps:
    the SSD scan's float32 sums run in another order on the card and move
    the values that later sites quantize by more (an index moving at a tie
    would show in the gradients).  The card launches the SSD kernel and
    its backward."""
    import torch

    from repro_torch.configs import mamba2_370m, zamba2_1p2b
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.models import init_params, unread_params
    from repro_torch.models.tree import tree_items
    from repro_torch.numerics import AMRNumerics

    cpu = torch.device("cpu")
    for base in (mamba2_370m.reduced(), zamba2_1p2b.reduced()):
        cfg = dataclasses.replace(base, dtype="float32")
        data = SyntheticLM(vocab=cfg.vocab, seq_len=40, batch=2, seed=0)
        params = init_params(cfg, 0, device="cpu")
        unread = unread_params(cfg)
        for nm in (AMRNumerics("exact"), AMRNumerics("amr_kernel", border=BORDER, rank=0)):
            c = dataclasses.replace(cfg, numerics=nm)
            t_cpu, g_cpu, l_cpu = _parity_run(c, params, data, cpu)
            skernel.SSD.launches = skernel.SSD_BWD.launches = 0
            t_card, g_card, l_card = _parity_run(c, params, data, device)
            launched = (skernel.SSD.launches, skernel.SSD_BWD.launches)
            if not min(launched) > 0:
                raise AssertionError(f"[train] parity {cfg.name} {nm.mode}: SSD launches "
                                     f"{launched}")
            trace = _trace_rule(t_card, t_cpu)
            failed = _loss_and_grad_rules(l_card, l_cpu, g_card, g_cpu, PARITY_LOSS_RTOL, False)
            failed += [k for g in (g_card, g_cpu) for k, leaf in tree_items(g)
                       if k in unread and leaf.any()]
            if failed:
                raise AssertionError(f"[train] parity {cfg.name} {nm.mode}: {failed} {trace}")
            want = dict(tree_items(g_cpu))
            worst = max(_leaf_rule(g, want[k], False)[1] for k, g in tree_items(g_card))
            log(f"[train] parity reduced {cfg.name} f32 {nm.mode} rank {nm.rank}: quantizations "
                f"card vs CPU {trace}; losses card {l_card} vs CPU {l_cpu} (rtol "
                f"{PARITY_LOSS_RTOL}); gradients: max over leaves of max |diff| / max |CPU| "
                f"{worst:.3g} (<= {PARITY_GRAD_TOL}), {len(unread)} unread leaves zero; "
                f"SSD forward and backward launches {launched}")


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(device us, launches, name) of each kernel, copy and memset of a
    profile, most time first, summed from the profiler's raw device events.
    ``key_averages()`` gives the same sums but first parses every host event
    into a tree, which took up to 164 s for one training step of hundreds of
    thousands of ops; where a profile holds at most MAX_PARSED_EVENTS events
    the two are held together."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    by_name: dict[str, list] = {}
    for ev in events:
        if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation():
            row = by_name.setdefault(ev.name(), [0.0, 0])
            row[0] += ev.duration_ns() / 1e3
            row[1] += 1
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items() if us > 0), reverse=True)
    if len(events) <= MAX_PARSED_EVENTS:
        parsed = sum(ev.self_device_time_total for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA)
        raw = sum(r[0] for r in rows)
        if not abs(parsed - raw) <= 1e-2 * max(raw, 1.0):
            raise AssertionError(f"device time from the raw events {raw} us, from "
                                 f"key_averages {parsed} us")
    return rows


MAX_PARSED_EVENTS = 50_000


def _profiled_step(step, state, batch) -> tuple:
    """One more train step under torch.profiler (a step more for each window
    in which the profiler recorded no device time): (state, wall ms, device
    busy ms, the kernels that took most device time), busy ms None where no
    window recorded device time."""
    import torch

    torch.cuda.synchronize()
    box = [state]

    def body(_):
        t0 = time.perf_counter()
        box[0], _ = step(box[0], batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall, rows = profile_windows(body, "train step")
    busy = sum(r[0] for r in rows) / 1e3 if rows else None
    top = [(round(us / 1e3, 1), n, name[:60]) for us, n, name in rows[:4]]
    return box[0], wall, busy, top


def busy_text(busy, wall: float) -> str:
    """The device busy ms and idle share of a profiled step, or that the
    profiler measured neither."""
    if busy is None:
        return "device busy and idle share not measured (no window recorded device time)"
    return f"device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f}"


# a backward kernel and the forward kernel it differentiates: per step it
# launches as often as one forward launches its forward kernel
BACKWARD_OF = {"ssd_scan_bwd": "ssd_scan"}


def _frontend_batch(cfg, data, i: int, device) -> dict:
    """Batch ``i`` of ``data`` on the card, with the stub frontend's output
    as ``extra`` for an audio or VLM config (standard normals in
    ``cfg.dtype`` from seed ``i``: a whisper's encoder frames, a VLM's
    patches)."""
    import torch

    b = _train_batch(data, i, device)
    n = cfg.encoder_frames or cfg.vision_prefix
    if n:
        gen = torch.Generator(device=device).manual_seed(i)
        b["extra"] = torch.randn((b["tokens"].shape[0], n, cfg.d_model), generator=gen,
                                 device=device).to(getattr(torch, cfg.dtype))
    return b


def train_run(device, card: str, cfg, label: str, uses: set, batch: int, seq: int,
              twice: bool = False) -> tuple[dict, dict]:
    """One training run of full-width ``cfg`` (random weights from seed 0):
    a warm step and TRAIN_STEPS timed steps on SyntheticLM batches (with
    frames for an audio model, ``_frontend_batch``).  The launch counts are
    set to 0 before the run and read after it: the kernels in ``uses``
    launch, no other; each launches, per step, the count of one forward
    (run alone, under no_grad, on the first batch) times 2 under
    ``remat="block"`` (the recompute) and times 1 under ``"none"``, less
    the encoder's count once under "block" (the JAX package recomputes no
    encoder layer, nor does the port), and a backward kernel
    (``BACKWARD_OF``) as often as one forward launches its forward kernel.
    Losses and gradient norms finite.  With ``twice``, the gradients of the
    first batch computed twice must agree bit for bit.  Then one more step
    under the profiler.  Returns the launches per step and in the run, by
    kernel."""
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.models import encode, forward
    from repro_torch.models.tree import tree_items, tree_map
    from repro_torch.train.steps import make_grads_step, make_train_state, make_train_step

    t_run = time.perf_counter()
    kernels = all_kernels()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
    state = make_train_state(cfg, 0, device=device)
    step = make_train_step(cfg)
    first = _frontend_batch(cfg, data, 0, device)
    per_encoder = {k.name: 0 for k in kernels}
    for k in kernels:
        k.launches = 0
    with torch.no_grad():
        if cfg.encoder_layers:
            encode(cfg, state.params, first["extra"])
            torch.cuda.synchronize()
            per_encoder = {k.name: k.launches for k in kernels}
        forward(cfg, state.params, first["tokens"], first.get("extra"))
    torch.cuda.synchronize()
    per_forward = {k.name: k.launches - per_encoder[k.name] for k in kernels}
    deterministic = ""
    if twice:
        grads = tree_map(lambda g: g.cpu(), make_grads_step(cfg)(state.params, first))
        again = make_grads_step(cfg)(state.params, first)
        moved = [k for (k, g), (_, h) in zip(tree_items(grads), tree_items(again))
                 if not torch.equal(g, h.cpu())]
        if moved:
            raise AssertionError(f"[train] {cfg.name} {label}: two backward passes differ in "
                                 f"{moved}")
        deterministic = f"; two backward passes bit for bit ({len(tree_items(grads))} leaves)"
        del grads, again
        torch.cuda.empty_cache()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms = [], [], []
    for i in range(1 + TRAIN_STEPS):
        b = _frontend_batch(cfg, data, i, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    mult = 2 if cfg.remat == "block" else 1
    for name, n in counts.items():
        want = (per_forward[BACKWARD_OF[name]] if name in BACKWARD_OF
                else mult * per_forward[name] - (mult - 1) * per_encoder[name])
        if name == NORM_KERNEL:
            if n == 0:
                raise AssertionError(f"[train] {cfg.name} {label}: no norm kernel launched")
        elif (name in uses) != (n > 0) or n != (1 + TRAIN_STEPS) * want:
            raise AssertionError(f"[train] {cfg.name} {label} remat {cfg.remat}: kernel {name} "
                                 f"launched {n} times in {1 + TRAIN_STEPS} steps, not "
                                 f"{1 + TRAIN_STEPS} x {want}; one forward launches "
                                 f"{per_forward}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"[train] {cfg.name} {label}: losses {losses}, grad norms {norms}")
    ms = float(np.median(times[1:])) * 1e3
    state, wall, busy, top = _profiled_step(step, state,
                                            _frontend_batch(cfg, data, 1 + TRAIN_STEPS, device))
    per_step = {k: n // (1 + TRAIN_STEPS) for k, n in counts.items() if n}
    log(f"[train] {cfg.name} {label} remat {cfg.remat} on {card}: {batch} x {seq} tokens a step, "
        f"{ms:.1f} ms per step (median of {TRAIN_STEPS} after a warm step of "
        f"{times[0] * 1e3:.0f} ms), {batch * seq / (ms / 1e3):.0f} tokens/s, peak memory "
        f"{peak:.2f} GiB; profiled step {wall:.1f} ms wall, {busy_text(busy, wall)} (most "
        f"device ms, launches: {top}); losses "
        f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]}; "
        f"launches per step {per_step}{deterministic}; run {time.perf_counter() - t_run:.1f}s")
    del state
    torch.cuda.empty_cache()
    return per_step, counts


def phase_train_full(device, card: str) -> tuple[dict, dict]:
    """Phase 9b: full-width amr-paper-100m (12 layers, d_model 768, vocab
    32000) at batch 8, seq 256 under its four training policies; full-width
    gemma3-1b at rank 8, batch 2, seq 512, remat "block" and "none";
    full-width mamba2-370m at rank 0 and rank 8, batch 4, seq 2048 (8
    chunks a sequence), and full-width zamba2-1.2b at rank 8, batch 2, seq
    1024, both under remat "block": the SSD kernel twice per Mamba2 layer a
    step (the forward and the recompute), its backward once; full-width
    whisper-small at rank 0 and rank 8 on 2 x 1500 frames and 2 x
    WHISPER_TRAIN_SEQ decoder tokens; moonshot-v1-16b-a3b at full width with
    its depth cut to MOON_TRAIN_LAYERS of 48 layers, 2 x MOON_TRAIN_SEQ
    tokens (T K = 6144 > 4096: the batch dispatched at once, C = 120, some
    assignments dropped), as registered (local, exact experts) at rank 8 and
    in the replicate form at rank 0 (the grouped gather at the expert sites
    and its straight-through backward), where two backward passes must give
    the same bits; all under remat "block".  Returns each run's launches per
    step, and in the run, by label."""
    from repro_torch.configs import (amr_paper, gemma3_1b, mamba2_370m, moonshot_16b_a3b,
                                     whisper_small, zamba2_1p2b)
    from repro_torch.numerics import AMRNumerics

    rank8 = AMRNumerics("amr_kernel", border=BORDER, rank=RANK)
    ssd = {"ssd_scan", "ssd_scan_bwd"}
    zamba2 = dataclasses.replace(zamba2_1p2b.CONFIG, pattern=dataclasses.replace(
        zamba2_1p2b.CONFIG.pattern, n_repeat=ZAMBA_R8_TRAIN_GROUPS))
    log(f"[train] depth cuts: mamba2-370m rank {RANK} on {MAMBA_R8_TRAIN_LAYERS} of 48 layers, "
        f"zamba2-1.2b rank {RANK} on {zamba2.pattern.n_layers} of 38 (full width)")
    plan = [(f"amr-paper-100m {label}", dataclasses.replace(amr_paper.CONFIG, numerics=nm),
             label, uses, TRAIN_BATCH, TRAIN_SEQ)
            for label, (nm, uses, _) in train_policies(amr_paper.CONFIG).items()]
    plan += [(f"gemma3-1b rank {RANK} remat {remat}",
              dataclasses.replace(gemma3_1b.CONFIG, remat=remat, numerics=rank8), f"rank {RANK}",
              {"amr_matmul_int8"}, G3_TRAIN_BATCH, G3_TRAIN_SEQ) for remat in ("block", "none")]
    plan += [("mamba2-370m rank 0", dataclasses.replace(
                 mamba2_370m.CONFIG, numerics=AMRNumerics("amr_kernel", border=BORDER, rank=0)),
              "rank 0", GATHERS | ssd, MAMBA_TRAIN_BATCH, SSD_CONTEXT),
             (f"mamba2-370m rank {RANK}, {MAMBA_R8_TRAIN_LAYERS} layers", dataclasses.replace(
                 mamba2_370m.CONFIG, n_layers=MAMBA_R8_TRAIN_LAYERS, numerics=rank8),
              f"rank {RANK}", {"amr_matmul_int8"} | ssd, MAMBA_TRAIN_BATCH, SSD_CONTEXT),
             (f"zamba2-1.2b rank {RANK}, {ZAMBA_R8_TRAIN_GROUPS} group", dataclasses.replace(
                 zamba2, n_layers=zamba2.pattern.n_layers, numerics=rank8),
              f"rank {RANK}", {"amr_matmul_int8"} | ssd, ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ)]
    plan.insert(4, ("amr-paper-100m amr_noise", dataclasses.replace(
        amr_paper.CONFIG, numerics=AMRNumerics("amr_noise", border=BORDER)), "amr_noise", set(),
        TRAIN_BATCH, TRAIN_SEQ))
    rank0 = AMRNumerics("amr_kernel", border=BORDER, rank=0)
    plan += [(f"whisper-small {label}", dataclasses.replace(whisper_small.CONFIG, numerics=nm),
              label, uses, 2, WHISPER_TRAIN_SEQ)
             for label, nm, uses in (("rank 0", rank0, GATHERS),
                                     (f"rank {RANK}", rank8, {"amr_matmul_int8"}))]
    moon = dataclasses.replace(moonshot_16b_a3b.CONFIG, n_layers=MOON_TRAIN_LAYERS)
    moon_replicate = dataclasses.replace(moon, numerics=rank0, moe=dataclasses.replace(
        moon.moe, dispatch_shard="replicate"))
    plan += [(f"moonshot-v1-16b-a3b local rank {RANK}", dataclasses.replace(moon, numerics=rank8),
              f"local rank {RANK}", {"amr_matmul_int8"}, 2, MOON_TRAIN_SEQ),
             ("moonshot-v1-16b-a3b replicate rank 0", moon_replicate, "replicate rank 0", GATHERS,
              2, MOON_TRAIN_SEQ)]
    log(f"[train] moonshot-v1-16b-a3b: depth cut to {MOON_TRAIN_LAYERS} of 48 layers, full "
        f"width (its 48 layers' weights and AdamW state do not fit one card)")
    per_step, totals = {}, {}
    for key, cfg, label, uses, batch, seq in plan:
        per_step[key], totals[key] = train_run(device, card, cfg, label, uses, batch, seq,
                                               twice=cfg is moon_replicate)
    return per_step, totals


def phase_train_restart(device) -> None:
    """Phase 9c: ``FaultTolerantLoop`` at full width with the depth cut (the
    script's time): amr-paper-100m on AMR_RESTART_LAYERS of 12
    layers under amr_inject and amr_noise (2 x 256 tokens), mamba2-370m on
    MAMBA_RESTART_LAYERS of 48 at rank 0 (2 x 2048: the SSD kernel and its
    backward) and moonshot-v1-16b-a3b on MOON_RESTART_LAYERS of 48,
    replicate form at rank 0 (2 x 512: the dispatch with drops; 3 steps,
    the straight run without the loop: its 20 GB state writes at about 0.9
    GB/s), checkpoints every
    2 steps: 4 steps straight through, then 2 steps, a raised failure, a
    restore from the step-2 checkpoint and 2 more.  The float32 losses and
    every leaf of the final states equal bit for bit."""
    from repro_torch.configs import amr_paper, mamba2_370m, moonshot_16b_a3b
    from repro_torch.numerics import AMRNumerics

    amr = dataclasses.replace(amr_paper.CONFIG, n_layers=AMR_RESTART_LAYERS)
    restart_run(device, dataclasses.replace(amr, numerics=AMRNumerics("amr_inject", border=BORDER)),
                f"amr_inject, {AMR_RESTART_LAYERS} of 12 layers", 2, TRAIN_SEQ)
    # the draws follow the restored step: the same noise after the restore
    restart_run(device, dataclasses.replace(amr, numerics=AMRNumerics("amr_noise", border=BORDER)),
                f"amr_noise, {AMR_RESTART_LAYERS} of 12 layers", 2, TRAIN_SEQ)
    restart_run(device, dataclasses.replace(
        mamba2_370m.CONFIG, n_layers=MAMBA_RESTART_LAYERS,
        numerics=AMRNumerics("amr_kernel", border=BORDER, rank=0)),
        f"rank 0, {MAMBA_RESTART_LAYERS} of 48 layers", 2, SSD_CONTEXT)
    moon = dataclasses.replace(moonshot_16b_a3b.CONFIG, n_layers=MOON_RESTART_LAYERS)
    restart_run(device, dataclasses.replace(
        moon, numerics=AMRNumerics("amr_kernel", border=BORDER, rank=0),
        moe=dataclasses.replace(moon.moe, dispatch_shard="replicate")),
        f"replicate rank 0, {MOON_RESTART_LAYERS} of 48 layers", 2, MOON_TRAIN_SEQ, steps=3,
        loop_straight=False)


def restart_run(device, cfg, label: str, batch: int, seq: int, steps: int = 4,
                loop_straight: bool = True) -> None:
    """``steps`` steps of ``cfg`` straight and 2 + a raised failure + a
    restore + the rest through ``FaultTolerantLoop`` (checkpoints every 2
    steps, and at the end): the same losses and final state, bit for bit.
    With ``loop_straight`` False the straight run takes the train steps
    alone, without the loop's checkpoints (a large state writes at about
    0.9 GB/s on the card's machine).  The straight run's final state waits
    on the host while the restarted one runs."""
    import tempfile

    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.models.tree import tree_items, tree_map
    from repro_torch.runtime import FaultTolerantLoop
    from repro_torch.train.steps import make_train_state, make_train_step

    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
    step = make_train_step(cfg)

    def run(fail: bool):
        losses, failed = {}, []

        def step_fn(state, batch):
            i = int(state.step)
            if fail and i == 2 and not failed:
                failed.append(i)
                raise RuntimeError("injected node failure")
            state, m = step(state, batch)
            losses[i] = float(m["loss"])
            return state, m

        t0 = time.perf_counter()
        if not (fail or loop_straight):
            state = make_train_state(cfg, 0, device=device)
            for i in range(steps):
                state, _ = step_fn(state, _train_batch(data, i, device))
            return state, losses, time.perf_counter() - t0
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
            loop = FaultTolerantLoop(
                ckpt_dir=ckpt, make_state=lambda: make_train_state(cfg, 0, device=device),
                step_fn=step_fn, batch_at=lambda i: _train_batch(data, i, device),
                ckpt_every=2, keep=1)
            res = loop.run(steps, log=log)
            seconds = time.perf_counter() - t0
        if res.steps_done != steps or res.restarts != int(fail) or res.preempted:
            raise AssertionError(f"[restart] {res.steps_done} steps, {res.restarts} restarts")
        return res.final_state, losses, seconds

    straight, l_straight, s1 = run(False)
    straight = tree_map(lambda t: t.cpu(), straight)
    torch.cuda.empty_cache()
    restarted, l_restarted, s2 = run(True)
    if l_straight != l_restarted:
        raise AssertionError(f"[restart] losses straight {l_straight} vs restarted {l_restarted}")
    items = dict(tree_items(restarted))
    for key, a in tree_items(straight):
        if not torch.equal(a, items[key].cpu()):
            raise AssertionError(f"[restart] leaf {key} differs after the restart")
    log(f"[restart] {cfg.name} {label}, {batch} x {seq} tokens a step: {steps} steps straight "
        f"({'through the loop' if loop_straight else 'train steps alone'}, {s1:.1f}s) and 2 + "
        f"failure + restore + {steps - 2} ({s2:.1f}s): losses {l_straight} bit for bit, all "
        f"{len(items)} leaves of the final state bit for bit")
    del straight, restarted, items
    torch.cuda.empty_cache()


def training_kernel_rows(device, int_rate: float) -> list[dict]:
    """Phase 9d (printed with phase 2): the gathers (flat and grouped), the
    low-rank kernel (rank 8) and the replay kernel (flat and grouped) at
    amr-paper-100m's training shapes, border 8: M = 8 x 256 = 2048 rows of
    (768, 768), (768, 3072) and (3072, 768), and attn.qk / attn.pv over
    (batch x 12 heads, 256 queries, 64, 256).  The gathers and the replay
    bit for bit against their plain versions (the replay also against the
    gather kernel), the low-rank kernel within 1e-5 * max_mn sum_k (|a b| +
    sum_r |u v|) of its plain version and K * sigma_(r+1) of the exact sums;
    event ms of the kernel, ms of the one plain call, and the bound."""
    import torch

    from repro_torch.configs import amr_paper
    from repro_torch.core import engine, lut
    from repro_torch.kernels.amr_matmul import kernel, ops, ref
    from repro_torch.kernels.inject_replay import kernel as rkernel
    from repro_torch.kernels.inject_replay import ref as rref

    cfg = amr_paper.CONFIG
    gen = torch.Generator(device=device).manual_seed(9)
    M, hd, H = TRAIN_BATCH * TRAIN_SEQ, cfg.head_dim, cfg.n_heads
    d, f = cfg.d_model, cfg.d_ff
    dense = [(1, M, d, d, False), (1, M, d, f, False), (1, M, f, d, False)]
    grouped = [(TRAIN_BATCH * H, TRAIN_SEQ, hd, TRAIN_SEQ, True),
               (TRAIN_BATCH * H, TRAIN_SEQ, TRAIN_SEQ, hd, True)]
    table, table32 = ops.kernel_table(BORDER, device), lut.table_tensor(BORDER, device)
    u, v = lut.factor_tensors(BORDER, RANK, device)
    sigma = lut.lowrank_factor(BORDER, RANK).sigma_next
    inj = engine.get_injector(2, BORDER)

    def plain_ms(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    rows = []
    for g, m, k, n, grouped_b in dense + grouped:
        lead = (g,) if grouped_b else ()
        a, b = _int8((*lead, m, k), gen, device), _int8((*lead, k, n), gen, device)
        shape = (g, m, k, n) if grouped_b else (m, k, n)
        # the gathers
        fn = kernel.amr_matmul_int8_lut_grouped if grouped_b else kernel.amr_matmul_int8_lut
        got = fn(a, b, table)
        want, p_ms = plain_ms(ref.lut_matmul_ref, a, b, table32)
        if not torch.equal(got, want):
            raise AssertionError(f"[train shapes] gather {shape} differs from plain")
        nbytes = g * (m * k + k * n + 4 * m * n) + table.numel() * table.element_size()
        b_ms, b_by = bound(nbytes, 2 * g * m * n * k, int_rate)
        rows.append(dict(kernel="grouped" if grouped_b else "lut", shape=shape, max_abs_err=0.0,
                         ms=time_ms(fn, [(a, b, table)], 10), plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by))
        # the replay, against its plain version and the gather kernel
        ia, ib = a.int() + 128, b.int() + 128
        got = rkernel.inject_replay_int32(inj, ia if grouped_b else ia[None], ib)
        want, p_ms = plain_ms(lambda x, y: rref.replay_matmul_ref(
            inj, x, y, max_pairs=PLAIN_REPLAY_PAIRS), ia if grouped_b else ia[None], ib)
        lut_out = fn(a, b, table) if grouped_b else fn(a, b, table)[None]
        if not torch.equal(got, want) or not torch.equal(got, lut_out):
            raise AssertionError(f"[train shapes] replay {shape} differs from plain or gathers")
        out_words = g * m * math.ceil(n / 32)
        b_ms, b_by = bound(4 * (ia.numel() + ib.numel() + g * m * n),
                           replay_ops(inj, out_words * k, out_words), int_rate)
        rows.append(dict(kernel="replay", shape=shape, max_abs_err=0.0, bound_ms=b_ms,
                         bound_by=b_by, plain_ms=p_ms,
                         ms=time_ms(rkernel.inject_replay_int32,
                                    [(inj, ia if grouped_b else ia[None], ib)], 5)))
        if grouped_b:
            continue
        # the low-rank kernel at the dense sites
        got = kernel.amr_matmul_int8(a, b, u, v)
        want, p_ms = plain_ms(ref.lowrank_matmul_ref, a, b, u, v)
        fa, fb = a.float(), b.float()
        scale = float((fa.abs() @ fb.abs() + ref.lowrank_matmul_ref(a, b, u.abs(), v.abs())
                       - fa @ fb).max())
        err = float((got - want).abs().max())
        gap = float((got.double() - ref.lut_matmul_ref(a, b, table32).double()).abs().max())
        if not (err <= 1e-5 * scale and gap <= k * sigma + 1e-5 * scale):
            raise AssertionError(f"[train shapes] low-rank {shape}: {err} vs 1e-5 * {scale}, "
                                 f"gap {gap} vs K*sigma {k * sigma}")
        b_ms, b_by = bound(m * k + k * n + 2 * u.numel() * 4 + 4 * m * n,
                           2 * m * n * k * (1 + RANK), PEAK_FLOAT_OPS_PER_S)
        rows.append(dict(kernel="lowrank", shape=shape, max_abs_err=err, gap_vs_exact=gap,
                         k_sigma=k * sigma, ms=time_ms(kernel.amr_matmul_int8, [(a, b, u, v)], 10),
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by))
    for r in rows:
        log("[kernel] train shape " + json.dumps(r))
    return rows


# kernel families of the profile, by a part of their names: every template
# instance of a hand kernel, and the memsets of all ops (a parent tree's
# gather wrappers zero-filled their outputs with one a call)
PROFILE_FAMILIES = {"gather kernels": "amr_lut", "low-rank kernel": "amr_lowrank",
                    "replay kernel": "inject_replay", "SSD scan": "ssd_scan",
                    "norm kernel": "row_mean_square", "memsets": "Memset"}


def profile_serve(device, card: str, cfg, params, prompts, gen: int, capacity: int) -> None:
    """Device time by kernel over one engine run of SLOTS requests (their
    prefills and decode steps) under torch.profiler, and the device's idle
    share of the run's wall time (which the profiler's own host cost
    lengthens)."""
    import torch

    from repro_torch.serve import Request, ServeEngine

    def setup():
        eng = ServeEngine(cfg, params, n_slots=SLOTS, capacity=capacity, device=device)
        for p in prompts[:SLOTS]:
            eng.submit(Request(prompt=p, max_new_tokens=gen))
        torch.cuda.synchronize()
        return eng

    def body(eng):
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return eng, (time.perf_counter() - t0) * 1e6

    (eng, wall_us), rows = profile_windows(body, f"{cfg.name} serve", setup)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log(f"[profile] {cfg.name} {cfg.numerics} on {card}: {SLOTS} prefills + "
            f"{eng.steps_done} decode steps, {wall_us / 1e3:.2f} ms wall, device busy and "
            f"idle share not measured (no window recorded device time)")
        return
    ours = sum(r[0] for r in rows
               if "amr_" in r[2] or "inject_replay" in r[2] or "ssd_scan" in r[2]
               or "row_mean_square" in r[2])
    log(f"[profile] {cfg.name} {cfg.numerics} on {card}: {SLOTS} prefills + "
        f"{eng.steps_done} decode steps, {wall_us / 1e3:.2f} ms wall, "
        f"device busy {busy_us / 1e3:.2f} ms "
        f"(idle share {1 - busy_us / wall_us:.3f}), hand kernels {ours / 1e3:.2f} ms")
    for family, tag in PROFILE_FAMILIES.items():
        mine = [r for r in rows if tag in r[2]]
        if mine:
            log(f"[profile]   {family}: {sum(r[0] for r in mine) / 1e3:.3f} ms over "
                f"{sum(r[1] for r in mine)} launches")
    for i, (dev_us, count, key) in enumerate(rows):
        if i < 12 or "ssd_scan" in key:
            log(f"[profile]   {dev_us / 1e3:9.3f} ms  {count:6d} calls  {key[:100]}")



# the phases ``--only`` runs, each on its own after the build
ONLY_PHASES = {"dense": lambda device, card: phase_dense_rest(device, card),
               "conformance": lambda device, card: phase_conformance(device),
               "core": lambda device, card: phase_core(device, card)}

def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a parent tree of the repo (git archive): time its kernels against "
                             "this tree's in this call")
    parser.add_argument("--time-kernels", type=Path, default=None, metavar="SRC",
                        help=argparse.SUPPRESS)  # one timing process of --parent's A/B
    parser.add_argument("--time-serve", type=Path, default=None, metavar="SRC",
                        help=argparse.SUPPRESS)  # one serving process of --parent's A/B
    parser.add_argument("--only", default=None, metavar="PHASES",
                        help="comma-separated phases to run after the build (" +
                             ", ".join(ONLY_PHASES) + "); prints no kernels line")
    args = parser.parse_args(argv)
    for src in (args.time_kernels, args.time_serve):
        if src is not None:
            sys.path.insert(0, str(src.resolve()))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: repro_torch not found under {ROOT / 'src'}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    torch.backends.cudnn.allow_tf32 = False
    if args.time_kernels is not None:
        print(json.dumps(time_kernels()), flush=True)
        return 0
    if args.time_serve is not None:
        print(json.dumps(time_serve()), flush=True)
        return 0
    if args.parent is not None and not (args.parent / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: --parent {args.parent} holds no src/repro_torch", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t_start = time.perf_counter()
    if args.only is not None:
        phases = args.only.split(",")
        unknown = sorted(set(phases) - set(ONLY_PHASES))
        if unknown:
            print(f"chip_smoke: unknown phases {unknown}; known: {list(ONLY_PHASES)}",
                  file=sys.stderr)
            return 1
        phase_build()
        card = card_line()
        for name in phases:
            t0 = time.perf_counter()
            ONLY_PHASES[name](device, card)
            log(f"[{name}] phase {time.perf_counter() - t0:.1f}s")
        log(f"[done] {time.perf_counter() - t_start:.1f}s (--only {args.only}: no kernels line)")
        print(card, flush=True)
        return 0

    from repro_torch.configs import (gemma3_1b, gemma_2b, internvl2_76b, mamba2_370m,
                                     moonshot_16b_a3b, whisper_small, zamba2_1p2b)

    phase_build()
    card = card_line()
    t0 = time.perf_counter()
    rows = phase_kernels(device, gemma_2b.CONFIG, mamba2_370m.CONFIG, gemma3_1b.CONFIG,
                         zamba2_1p2b.CONFIG)
    log(f"[kernel] phase {time.perf_counter() - t0:.1f}s")
    if args.parent is not None:
        t0 = time.perf_counter()
        phase_ab(args.parent.resolve())
        phase_ab_serve(args.parent.resolve())
        log(f"[ab] phase {time.perf_counter() - t0:.1f}s")
    else:
        log("[ab] no --parent tree: the same-call A/B against the parent's kernels is not run")
    t0 = time.perf_counter()
    phase_reference(device)
    phase_reference_frontends(device)
    log(f"[reference] phase {time.perf_counter() - t0:.1f}s")
    gemma_params = model_params(device, gemma_2b.CONFIG)
    t0 = time.perf_counter()
    rows["attn_fused"], attn_launches = phase_attn_fused(
        device, attn_cases(device, gemma_2b.CONFIG, gemma_params), int_ops_per_s(device))
    log(f"[attn_fused] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches = phase_serve(device, card, gemma_2b.CONFIG, gemma_params, mamba2_370m.CONFIG)
    log(f"[serve] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches["gemma3-1b"] = phase_gemma3(device, card, gemma3_1b.CONFIG)
    log(f"[gemma3-1b] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches["zamba2-1.2b"] = phase_zamba2(device, card, zamba2_1p2b.CONFIG)
    log(f"[zamba2-1.2b] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    noise = noise_moments(device, card, gemma_2b.CONFIG, moonshot_16b_a3b.CONFIG)
    launches["moonshot-v1-16b-a3b"] = phase_moonshot(device, card, moonshot_16b_a3b.CONFIG)
    log(f"[moonshot-v1-16b-a3b] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches["whisper-small"] = phase_whisper(device, card, whisper_small.CONFIG)
    log(f"[whisper-small] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches["internvl2-76b"] = phase_vlm(device, card, internvl2_76b.CONFIG)
    log(f"[internvl2-76b] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dense = phase_dense_rest(device, card)
    launches.update(dense)
    log(f"[dense] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_train_parity(device)
    phase_train_parity_ssm(device)
    train, launches["train"] = phase_train_full(device, card)
    phase_train_restart(device)
    log(f"[train] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    conformance = phase_conformance(device)
    log(f"[conformance] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_core(device, card)
    log(f"[core] phase {time.perf_counter() - t0:.1f}s")

    src = "src/repro_torch/kernels/amr_matmul/csrc/"
    # the gemma-2b decode shape each AMR kernel spends most time on at border
    # 8, and the SSD kernel at the mamba2-370m prefill shape in split mode
    # (the served path under rank 0); launches from that model's run
    picks = {
        "amr_matmul_int8_lut": (rows["lut"][0], src + "lut_matmul.cu",
                                "src/repro/kernels/amr_matmul/kernel.py:137",
                                ("gemma-2b", "rank 0")),
        "amr_matmul_int8_lut_grouped": (rows["grouped"][0], src + "lut_matmul.cu",
                                        "src/repro/kernels/amr_matmul/kernel.py:175",
                                        ("gemma-2b", "rank 0")),
        "amr_matmul_int8": (rows["lowrank"][0], src + "lowrank_matmul.cu",
                            "src/repro/kernels/amr_matmul/kernel.py:47",
                            ("gemma-2b", f"rank {RANK}")),
        "inject_replay": (rows["replay"][0],
                          "src/repro_torch/kernels/inject_replay/csrc/inject_replay.cu",
                          "src/repro/kernels/inject_replay/kernel.py:81",
                          ("gemma-2b", "amr_inject")),
        "ssd_scan": (rows["ssd"][1], "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:25", ("mamba2-370m", "rank 0")),
        # the backward at mamba2-370m's training shape in split mode (rank 0's
        # path); launches from that training run
        "ssd_scan_bwd": (next(r for r in rows["ssd_bwd"]
                              if r["shape"][:2] == (MAMBA_TRAIN_BATCH, SSD_CONTEXT)
                              and r["inputs"] == "model dt" and r["mode"] == "split"),
                         "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
                         "none: no Pallas kernel; the JAX package differentiates its jnp scan "
                         "(src/repro/models/ssm.py:76) with jax.grad",
                         ("train", "mamba2-370m rank 0")),
        # the norms of a gemma-2b decode step (4 rows of 2048); launches from
        # that model's rank-0 run
        "row_mean_square": (rows["norm"][0],
                            "src/repro_torch/kernels/rms_norm/csrc/row_mean_square.cu",
                            "none: no Pallas kernel; the JAX package's rms_norm computes "
                            "jnp.mean(x * x) (src/repro/models/layers.py:44) and XLA fuses it",
                            ("gemma-2b", "rank 0")),
    }
    # the fused attention kernels: the op at the long-decode case, border 8;
    # launches from that op call, and their launches in every served run of
    # phase 5 (0: no model dispatches the op)
    served = {name: sum(c.get(name, 0) for model, runs in launches.items() if model != "train"
                        for c in runs.values())
              for name in ("attn_fused_lut", "attn_fused_inject")}
    launches["attn_fused"] = attn_launches
    asrc = "src/repro_torch/kernels/attn_fused/csrc/"
    for name, method, line in (("attn_fused_lut", "lut", 76), ("attn_fused_inject", "inject", 123)):
        row = next(r for r in rows["attn_fused"] if r["case"] == "long decode"
                   and r["method"] == method and r["border"] == BORDER
                   and r["schedule"] == "default")
        picks[name] = (row, asrc + name + ".cu", f"src/repro/kernels/attn_fused/kernel.py:{line}",
                       ("attn_fused", method))
    out = []
    for k in all_kernels():
        row, source, replaces, (model, label) = picks[k.name]
        entry = {"name": k.name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[model][label][k.name], "max_abs_err": row["max_abs_err"],
                 "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                 "shape": row["shape"],
                 "launches_gemma3_1b": {label: counts[k.name]
                                        for label, counts in launches["gemma3-1b"].items()},
                 "launches_zamba2_1p2b": {label: counts[k.name]
                                          for label, counts in launches["zamba2-1.2b"].items()},
                 "launches_moonshot": {label: counts[k.name] for label, counts
                                       in launches["moonshot-v1-16b-a3b"].items()},
                 "launches_per_step_whisper_small": {
                     label: counts.get(k.name, 0)
                     for label, counts in launches["whisper-small"].items()},
                 "launches_per_step_internvl2_76b": {
                     label: counts.get(k.name, 0)
                     for label, counts in launches["internvl2-76b"].items()},
                 "launches_per_train_step": {label: per_step.get(k.name, 0)
                                             for label, per_step in train.items()},
                 "launches_dense_rest": {f"{model} {label}": counts[k.name]
                                         for model, runs in dense.items()
                                         for label, counts in runs.items()},
                 "launches_conformance": conformance[k.name]}
        if model == "attn_fused":
            entry.update(unfused_ms=row["unfused_ms"], op_ms=row["op_ms"],
                         launches_in_served_runs=served[k.name])
        out.append(entry)
    log("[noise] moments " + json.dumps(noise))
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
