#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails; each
prints its wall seconds:

1. environment: card name and power limit, torch and CUDA versions; TF32
   off for matmuls and convolutions;
2. build: compile the eight kernel libraries (fused MLP, its backward,
   window pack, masked attention, its backward, causal flash attention in
   float32 (3xTF32 on mma.sync) and in bfloat16 (wgmma, TMA), chunked
   SSD in three kernels) with nvcc (sm_90a),
   one nvcc per source, started together; then phase 14's parity checks;
3. fused-MLP parity: the kernel against its plain PyTorch version at every
   DFP layer shape, M in {1, 2, 4, 8, 16} (the M <= 16 kernel) and {17, 33,
   37, 64, 65, 128} (the 64-row kernel), and at the attention encoder's
   four (K, N) at M 8,255 and 8,256, all four activations, float32 (rtol =
   atol = 2e-4) and bfloat16 (2e-2); two launches with a K split (M = 64,
   the 11410 x 4000 layer) bit-equal;
4. window-pack parity: the standalone pack (``pack_window``) against its
   plain version, bit for bit, over shapes (N, J, F, W) up to (512, 2048,
   4, 10) and waiting densities 0, 0.05, 0.4 and 1;
5. timing: each kernel, its plain version and (fused MLP only)
   ``torch.addmm`` + activation (the library yardstick, which the port
   never calls) at the main paths' shapes, each beside its bound: the 13
   DFP layers at M = 1, 8, 16 and 64 and the attention encoder's four
   (K, N) at M = 8,256; the whole 13-layer DFP forward at M = 1, 8, 16
   and 64;
6. service path: a paper-width MRSch agent (state_dim 11410, random
   weights from a seed) behind a ``DecisionService(max_batch=16)``
   replays full-scale Theta S1 traces, one alone and eight from
   concurrent client threads; the fused-MLP launch count must be 13 per
   forward, and sampled served rows must score the same on the kernel and
   the plain backend; then a host/device breakdown of one client;
7. device-engine parity: ``DeviceSimulator`` against the sequential
   ``Simulator`` at full Theta width — FCFS over 8 traces as 8
   environments, the paper-width agent over one trace, and the decoded
   event trace of an integer-time trace;
8. device-engine path: greedy ``DeviceSimulator.rollout()`` of the
   paper-width agent over 64 full-scale S1 traces (warm-up, then one
   timed rollout), with the round's fused front (``pack_decision_rows``:
   queued mask, free counts, window pack and decision rows in one launch,
   counted as ``window_pack``) launched once and the fused MLP 13 times
   per deciding round, a ``torch.profiler`` busy share (device activity
   only) and device operations per round, and one epsilon-greedy
   collection rollout; then one more rollout records every round's front
   operands, holds the kernel against its plain composite on each (bit
   for bit but the summed goal columns, within atol 1e-6, rtol 1e-5) and
   times both on the median round;
9. fused-MLP backward parity: the dgrad and wgrad kernels against their
   plain versions at the 13 DFP layer shapes, M in {1, 16, 37, 64, 128},
   and at the attention encoder's (K, N) in {(4, 64), (64, 64), (64, 128),
   (128, 64)}, M in {8192, 8255, 8256} (the wgrad split along M), all four
   activations, float32 (rtol 1e-3, atol 1e-4) and bfloat16 (2e-2); two
   launches on the same inputs give bit-equal dx (dgrad) and dW and db
   (wgrad);
10. training path: a second paper-width agent (paper defaults: batch 64,
   64 gradient steps per episode, lr 1e-4, clip 10) runs ``train_agent``
   over three full-scale S1 traces; exactly 13 forward, 10 dgrad and 13
   wgrad launches per train step, finite losses and norms, every
   parameter moved; one step's loss and gradients on the kernel and the
   plain backend; a greedy ``evaluate`` on both backends; step wall and
   device time, a ``torch.profiler`` breakdown of one burst, collection
   decisions/s; then the dgrad and wgrad held against their plain
   versions and timed on the operands of one train step of the path,
   each beside its bound, its plain version and ``torch.mm`` on the
   act'-scaled gradient (the library yardstick, which the port never
   calls);
11. masked-attention parity (phase 2 builds its two libraries):
   ``mha_fwd`` and the two backward kernels against their
   plain versions over (BH, S, dh) up to (256, 129, 16) and dh 8-64, S
   from 1 to 600 (tiled beyond one block a batch-head, stages in a ring),
   lengths 0, 1, S//2, S, 15, 16 and 17 among them, a fully masked case,
   and two calls of each kernel bit-equal at (256, 129, 16);
12. the attention state module (``state_module="attention"``, Q = 128,
   the reference's default attention agent, 1,383,428 parameters) on
   traces of full-scale S1 at 400 jobs/day for one day, whose queues
   reach past Q: the service path of 6 (25 fused-MLP and 2 ``mha``
   launches per forward; every served decision against the plain
   backend under a top-2-margin guard), device-engine parity and the
   device-engine path of 7-8 (25, 2 and 1 ``window_pack`` per deciding
   round, the front packing K = Q; the median of three timed rollouts, no
   collection rollout), the training path of 10 (25 forward, 21
   dgrad, 25 wgrad, 2 of each attention kernel per step; 60 gradient
   leaves on both backends);
13. the attention kernels, and the round's front at K = Q, on the operands
   one more device rollout and a train step give them: held against their
   plain versions (the front bit for bit but the summed goal and mean-TTF
   columns) and timed beside
   their bounds (over the valid keys, and dense), their plain versions
   and ``scaled_dot_product_attention`` with the same key mask and its
   backward (the library yardstick, which the port never calls); B5 also
   at the service's BH = 4 (one batch row of the rollout's call);
14. the LM zoo's kernels (right after the build): the causal flash
   attention B7 against its plain version over the reference tests'
   grid, every instantiated dh (16-256) and Sq != Sk, float32 (rtol =
   atol = 2e-4; the 3xTF32 kernel) and bfloat16 (2e-2; the wgmma
   kernel), causal and full, and in both dtypes at zamba2-7b's shape (B =
   1, S = 4096, 32 heads of 112, causal); the chunked SSD B8
   against the exact recurrence and its plain chunked version over the
   reference tests' grid and the LM configs' (P, N, chunk), float32
   (1e-3) and bfloat16 (5e-2), and with float32 y against the plain
   version at 1e-4 for both (on the LM paths' operands too), two calls
   bit-equal;
15. LM prefill: zamba2-7b at full width and depth (6.96 B parameters,
   random from seed 0), ``make_prefill_step`` on both backends in
   float32 at B = 2 of S = 4096 and S = 3000: exactly 13 B7 and 81 B8
   launches per forward (81 of each of B8's three kernels), last-token
   logits within 1e-3 of the largest
   and argmax equal, B7 and B8 held against their plain versions (B8
   also the exact recurrence) on the first shared block's and Mamba2
   layer's operands, the float32 step's wall and device time, and
   float32 ``generate`` (the SSM states and the shared blocks' KV slots)
   of 16 tokens after 64 of the batch's, with no B1-B8 launch, each new
   token its step's argmax, every step's logits within 2e-3 of the
   forward over the generated sequence (teacher forcing); then in
   bfloat16 the step's wall and device time, a
   profiled breakdown by kernel group, and both kernels timed on the
   step's operands (B8 also pass by pass, in both dtypes) beside their
   bounds, plain versions and (B7) SDPA
   with ``is_causal`` (the library yardstick, which the port never calls);
   then the same ``generate`` in bfloat16, its logits against the forward
   at the bfloat16 limit, decode tokens/s, synchronising calls (``torch.cuda.set_sync_debug_mode``)
   and one step's device operations;
16. LM widths: gemma-2b (dh 256, MQA; depth cut to 2 of 18 layers) and
   mamba2-1.3b (N 128; 4 of 48) at full width through the checks of 15,
   and in float32 ``generate`` of 8 tokens after 32 held as 15's within
   2e-3 (the reference's decode tolerance);
17. the lockstep engine (run after 13): ``run_traces`` of a paper-width
   agent (seed 0, as in 6) over the full-scale S1 traces of seeds 1-8 as
   eight lanes, against the sequential ``run_trace`` of each (every
   ``SimResult``, each job's start and end, equal); exactly 13 fused-MLP
   launches a round; ``VectorStats``; both engines' decisions/s; then
   every batched row's action values (B1 at M = the round's rows padded
   to 1, 2, 4 or 8) equal to the M = 1 forward's bit for bit, under a
   top-2-margin guard;
18. lockstep replay through the service: ``ServiceSim.run_traces`` over
   the same traces (results equal to 17's), its batch-size mix, and
   sampled served rows on the kernel and the plain backend as in 6;
19. vectorised training: ``train_agent_vectorized`` of a fresh
   paper-width agent (paper defaults) over ``build_train_mix`` of S1-S4
   x seeds 1-2 (2 days at 160 jobs/day) on eight lanes at 1.0, 0.75 and
   0.5 of the cluster: exactly 13 forward, 10 dgrad and 13 wgrad
   launches a step plus 13 forward launches a round with an exploiting
   row (found by replaying each round's epsilon draws on a copy of the
   rng), finite losses and norms, every parameter moved, one step on
   both backends as in 10, collection decisions/s beside 10's sequential
   figure;
20. attention vectorised training: the attention agent of 12 (starting
   at epsilon 0.5, so rounds mix exploring and exploiting rows) on four
   lanes of 12's traces (seeds 1-4) with a train step every round, the
   checks of 19 with 25/21/25 + 2/2/2 launches a step and 25 + 2 a
   forward; 19 and 20 also fill a ``MetricsRegistry``, whose episode and
   decision totals must equal the ``TrainLog``'s;
21. checkpoint, hot reload and telemetry: a second paper-width agent
   (seed 13) saved with ``CheckpointManager.save_async`` (the caller's
   copy timed, then the background write) and restored onto the card bit
   for bit with no kernel launched; then the seed-0 agent serves one
   client's S1 replay (as 6) behind a ``DecisionService`` with a metrics
   registry and a recording tracer while a started ``CheckpointWatcher``
   swaps in the seed-13 step, published midway by renaming it into the
   watched directory: every decision before the swap equals the seed-0
   agent's greedy choice and every one after it the seed-13 agent's
   (top-2-margin guard as 6), 13 fused-MLP launches a forward, registry
   requests equal to the decisions and one reload, one ``ckpt.reload``
   event; the ms from the commit to the first decision on the new
   weights; a profiler capture of one service forward shows 13
   ``mrsch.kernel.fused_mlp`` ranges;
22. policies, baselines and the tournament, at full Theta width on the
   cells S1 and bursty-campaigns x seeds 1-2 (1 day at 160 jobs/day):
   ``run_tournament`` of ``zoo_policies`` (FCFS, GA, ScalarRL, the
   seed-0 paper-width MRSch agent on the kernel backend, PRB-EWT,
   CP-Dispatch, DRAS, CoSchedRL) with vector 4: no failed cell, 32 rows,
   7 batched entrants, the committed baselines' columns and entrants;
   the MRSch entrant 13 B1 launches a batched forward, every batched row
   equal to the M = 1 forward bit for bit, and each cell's events and row
   equal to the sequential ``run_trace``'s; its ``goal_log`` one goal a
   decision; the leaderboard and each entrant's decisions/s; then
   PRB-EWT, DRAS, CoSchedRL and ScalarRL each on ``DeviceSimulator``
   over the four cells as four environments (one ``window_pack`` launch
   a deciding round, none of B1: their networks are plain) against their
   sequential runs (top-2-margin guard), rounds/s and decisions/s;
   ScalarRL (hidden 512, 128) trains one episode: a finite loss, every
   leaf moved, the step within rtol 1e-4 (loss) and rtol 1e-3, atol 1e-4
   (parameters) of the same step on the CPU; the CNN agent
   (``state_module="cnn"``: convs 1 -> 8 -> 16, proj 11,424 -> 512; the
   convs and projection plain, TF32 off): the kernel backend's forward
   within 2e-4 of the torch backend's with 10 B1 launches, the device
   rollout against the sequential run, one ``train_agent`` episode with
   exactly 10/8/10 B1/B2/B3 launches a step and one step on both
   backends;
23. LM MoE (run after 16): deepseek-v2-lite-16b (MLA, 64 routed experts
   of 1408 + 2 shared, top 6, a dense first layer).  In float32 at full
   width, depth cut to the dense layer and 3 MoE layers, the prefill
   step on both backends at B = 2, S = 4096 (4 B7 launches, all
   ``flash_fwd``; logits as 15) and B7 against its plain version on the
   first MLA layer's operands; then at full width and depth in bfloat16
   (15,706,484,224 parameters from seed 0): the prefill step on both
   backends (27 B7 launches, all ``flash_fwd_sm90``, none on the torch
   backend), B7 held against its plain version and timed on the first
   MLA layer's operands (q and k of 192, v padded from 128 to 192)
   beside its bound and SDPA on the same padded call, the step's wall and
   device time and profiled breakdown, and ``generate`` of 32 tokens
   after 64 (capacity factor 16, dropless) checked as 15's; last the same
   draws in float32 at full depth: the prefill step on both backends (27
   B7 launches, all ``flash_fwd``; logits within 1e-3 as 15),
   ``generate`` held within 2e-3, and the bfloat16 run's forward and
   decode logits against the float32 forward of its tokens;
24. LM training (run after 23; float32, TF32 off, the "torch" backend:
   no kernel launches, so no entry in the kernels line): (a) gemma-2b at
   full width cut to 2 of its 18 layers, the same weights on the card
   and on the CPU, one ``make_train_step`` (AdamW, lr 1e-3, weight decay
   0.1, 2 microbatches) at B = 2, S = 128: the loss within rtol 1e-5,
   the norm within 1e-4, every parameter and moment as
   ``hold_train_step`` says; (b) gemma-2b whole (2.51 B parameters):
   a 4-step ``train_loop`` at B = 1, S = 4096 with finite losses, then
   4 steps at a constant lr of 1e-4 on one batch, the loss falling at
   each, step wall and device time, tokens/s, busy share, peak memory
   and the last step profiled by group (matmuls, attention scan,
   cross-entropy with the logits, AdamW, remat recompute: the port's
   ``mrsch.lm.*`` profiler ranges, each asserted present); (c) the cut
   model's ``train_loop`` with a factored state and a bfloat16 first
   moment, stopped at step 2 and resumed to 4 from its checkpoint in a
   temporary directory, equal to the uninterrupted run (rtol 1e-6); (d)
   deepseek-v2-lite-16b (3 layers) and zamba2-7b (6 layers, one use of a
   shared block) at full width, B = 1, S = 4096: finite losses and
   gradients, each expert's gradient nonzero exactly when a kept choice
   routed it a token, 2 train steps; (e) the kernel backend's forward
   with grad on raises B7's and B8's ``RuntimeError``;
25. the fleet scheduler (``launch/scheduler.py``) at ``main``'s defaults
   on the card: ``make_fleet_agent`` (400 jobs, 6 episodes) trains the
   fleet agent, which then schedules 150 jobs (seed 1000) of
   ``FleetSpec()``; B1, B2 and B3 counted from 0 over both and asserted
   launched, 64 sampled greedy rows held against the plain version as
   6's (``check_served_rows``), one training step's loss and gradient
   leaves on both backends (``check_step_parity``, 13/10/13 launches),
   and B1 (M 1, 16, 48), B2 and B3 (M 48) at the fleet net's layer
   shapes against their plain versions; the training wall, decisions/s, the
   MRSch, FCFS and GA metrics rows, and the job mix's demand vectors with
   the card's own memory and power limit in ``FleetSpec``;
26. the multi-card layer on a one-card mesh: (a) a world-size-1 NCCL
   group and ``make_host_mesh()``; (b) gemma-2b at full width, 2 layers,
   float32, one ``make_train_step`` under ``default_rules`` (DTensor
   parameters, state and batch) against the same step without rules,
   every parameter within 1e-6 relative, both timed, and one step under
   each sequence-parallel rule set (``opt``, ``serve``) bit-equal to it;
   (c) its prefill step and one decode step from a filled cache under
   ``serve_rules``, bit-equal to the steps without rules; (d)
   deepseek-v2-lite-16b's MoE layer at full width (64 experts) through
   ``_moe_small_t`` under ``serve_rules`` against the no-mesh layer; (e)
   ``python -m repro_torch.launch.dryrun`` for gemma-2b x prefill_32k and
   deepseek-v2-lite-16b x decode_32k on the 16 x 16 mesh (a fake world
   of 256 ranks, no card), each record ``ok`` and printed;
27. the LM entry points on a one-card mesh (the host mesh of a world-1
   NCCL group, as ``torchrun`` forms it): (a) gemma-2b whole, float32,
   B = 1, S = 4096: a 3-step ``train_loop`` without a group (the plain
   path), then the same under the mesh (``default_rules``, the weights
   drawn module by module onto it): its losses within 1e-6 relative of
   the plain ones, each run's step walls and peak memory; (b) gemma-2b
   cut to 2 layers, B = 2, S = 128, on the mesh (a factored state with a
   bfloat16 m): a 4-step ``train_loop`` against a 2-step one that
   checkpoints its step 2 and a second that resumes from it (restored
   from 2, 2 steps run, losses within 1e-6 relative), the checkpoints'
   gather, write and restore seconds; (c) deepseek-v2-lite-16b whole in
   bfloat16: ``generate`` of 8 tokens after 16 (B = 2, dropless) without
   rules, then under ``default_rules`` and under ``serve_rules`` (the
   cache's positions over "model") from ``init_sharded_params`` of the
   same seed: the same tokens, ms a decode step of each; (d) ``torchrun
   --nproc_per_node 1 -m repro_torch.launch.train --arch stablelm-1.6b
   --smoke --steps 3`` in a subprocess (NCCL on the card): its last line
   the reference's JSON.

The line before the last is a JSON summary of the kernels (B1's times
are the 13 DFP layers' at M = 64; B1, B2, B3, B5 and B6 count the
launches of 17-22 too, B1-B3 also 25's; ``window_pack``'s times are the fused round
front's on the MLP path's median round, its plain time the composite's,
its launches both device paths' and 22's), B7 as two
entries: ``flash_attention`` (``flash_fwd_sm90.cu``, bfloat16; its launches
are the bfloat16 prefill steps' of 15 and 23, its times zamba2-7b's)
and ``flash_attention_f32`` (``flash_fwd.cu``; the float32 prefill
steps' of 15, 16 and 23); the last line is
``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing either.
"""
from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 rate outside the
# tensor cores (the kernel runs float32 FMAs on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAKS = "H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32 (700 W)"

DFP_SHAPES = [(11410, 4000), (4000, 1000), (1000, 512), (2, 128), (128, 128),
              (768, 512), (512, 12), (512, 120)]
# M <= 16 runs fused_mlp_fwd_kernel, M > 16 fused_mlp_fwd_m64_kernel
# (kernel.forward_plan): 17, 33, 37, 65 and 128 leave ragged 64-row tiles.
PARITY_M = (1, 2, 4, 8, 16, 17, 33, 37, 64, 65, 128)
TIMING_M = (1, 8, 16, 64)
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}

KERNEL_SOURCE = "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu"
KERNEL_REPLACES = "src/repro/kernels/fused_mlp/kernel.py:85"
BWD_SOURCE = "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp_bwd.cu"
DGRAD_REPLACES = "src/repro/kernels/fused_mlp/kernel.py:135"
WGRAD_REPLACES = "src/repro/kernels/fused_mlp/kernel.py:183"
# The JAX package's gradient tolerance (tests/test_kernels.py:79), and
# bfloat16's.
BWD_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
BWD_PARITY_M = (1, 16, 37, 64, 128)
# The attention encoder's token layers (K, N) at M up to 64 x 129, where the
# wgrad splits M across blocks and the forward runs 129 tiles of 64 rows.
ENCODER_WGRAD = [(4, 64), (64, 64), (64, 128), (128, 64)]
ENCODER_M = (8192, 8255, 8256)
ENCODER_FWD_M = (8255, 8256)     # the forward's parity rows at those layers
# Their activations in the encoder (tok; q, k, v, wo; the MLP's two layers).
ENCODER_ACT = {(4, 64): "linear", (64, 64): "linear",
               (64, 128): "leaky_relu", (128, 64): "linear"}
# Kernels before their redesign, quoted from PERF.md section 6 (NVIDIA H100
# 80GB HBM3, 700 W) on a log line of their own, not measured here: B3
# summed over the MLP train step's 13 layers; B1 over the 13 DFP layers at
# M = 64; B2 over the MLP train step's 10 layers; B7 at B = 2, S = 4096, 32
# heads of 112, causal, in bfloat16 (flash_attention) and float32
# (flash_attention_f32); B8 at B = 2, S = 4096, 112 heads of 64, N 64,
# chunk 256, bfloat16 in and float32 y; B4 the standalone window pack at
# (64, 358, 4, 10), before it became the round's fused front.
PRIOR_MS = {"fused_mlp_wgrad": 0.3603, "fused_mlp_forward": 0.5125,
            "fused_mlp_dgrad": 0.1480, "flash_attention": 9.7836,
            "flash_attention_f32": 9.6996, "ssd": 4.0991, "mha_fwd": 0.0431,
            "mha_bwd_dq": 0.0455, "mha_bwd_dkv": 0.0811,
            "window_pack": 0.0076}
TRAIN_SEEDS = (1, 2, 3)          # full-scale S1 traces of the training path
WP_SOURCE = "src/repro_torch/kernels/window_pack/csrc/window_pack.cu"
WP_REPLACES = "src/repro/kernels/window_pack/kernel.py:37"

# Synthetic window-pack shapes (N, J, F, W).  The device engine's main path
# runs N = 64 environments, J = 358 jobs, F = R + 2 = 4 features, W = 10;
# phase_window_pack_main_path checks and times the kernel on its own inputs.
WP_PARITY = [(1, 40, 4, 10), (3, 50, 7, 10), (64, 330, 4, 10),
             (512, 2048, 4, 10), (8, 1000, 4, 64), (5, 33, 3, 10),
             (2, 1, 4, 10)]
WP_DENSITIES = (0.0, 0.05, 0.4, 1.0)
WP_TIMING = [(64, 358, 4, 10), (512, 2048, 4, 10)]
# The round's front (pack_decision_rows): its summed row columns (the goal,
# the attention context's mean TTF) are sums over the job or unit axis in
# another order than the plain composite's, so they agree within these;
# every other output is bit-equal.
FRONT_SUMMED_ATOL, FRONT_SUMMED_RTOL = 1e-6, 1e-5
# The front's operands that are fixed for a rollout (not cloned per round).
ROLLOUT_CONSTANT = ("feats", "walltime", "demands", "caps_f")
DEVICE_ENVS = 64                 # environments of the device-engine path

MHA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/mha.cu"
MHA_BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/mha_bwd.cu"
MHA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:125"
MHA_BWD_REPLACES = "src/repro/kernels/flash_attention/kernel.py:216"
# (BH, S, dh): the attention state module's (4 heads x batch rows, 1 + Q,
# 16) at batch 1, 8 and 64, and the other instantiated head dims; then the
# kernels' edges: one row, one and two 16-row warps, a single 8-key group
# short of 128, more rows than one block holds (257) and a tiled query
# side with a ring of key stages (600; at dh 64 a ring on both sides).
MHA_GRID = [(4, 129, 16), (32, 129, 16), (256, 129, 16), (8, 49, 8),
            (8, 257, 32), (8, 65, 64), (8, 1, 16), (8, 16, 8), (8, 17, 16),
            (8, 128, 16), (8, 257, 16), (8, 600, 16), (8, 600, 64)]
MHA_REPEAT = (256, 129, 16)     # two calls of each kernel compared bit for bit
MHA_TOL = {"mha_fwd": 2e-5, "mha_bwd_dq": 1e-4, "mha_bwd_dkv": 1e-4}
# B7's two kernels, by dtype (kernel.flash_plan): bfloat16 on wgmma, float32
# in 3xTF32 on mma.sync; each has its entry in the kernels line.
FLASH_SM90_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_fwd_sm90.cu")
FLASH_F32_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:281"
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
SSD_REPLACES = "src/repro/kernels/ssd/kernel.py:62"
# B7: the reference tests' (B, S, H, KV, dh) (tests/test_kernels.py:126),
# then every dh the kernel is instantiated for at a ragged S, with GQA;
# (B, Sq, Sk, H, KV, dh) with Sq != Sk (the causal mask top-left aligned).
FLASH_GRID = [(1, 128, 2, 2, 64), (2, 200, 4, 2, 64), (1, 384, 8, 1, 128),
              (2, 256, 6, 6, 32)] + [(1, 203, 4, 2, dh) for dh in
                                     (16, 32, 64, 112, 128, 192, 256)]
FLASH_CROSS = [(2, 100, 260, 4, 4, 64), (2, 260, 100, 4, 2, 112)]
FLASH_ZAMBA = (1, 4096, 4096, 32, 32, 112)      # both dtypes, causal
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# At FLASH_ZAMBA the rows past about 2,000 average to |o| near 0.03, so an
# absolute limit of 2e-2 would let a wrong late key tile pass: there the
# relative 2e-2 holds with an absolute 1e-3 (sound rows round off near
# 1e-4).
FLASH_ZAMBA_ATOL = 1e-3
# B8: the reference tests' (B, S, H, P, N, chunk) with one group per head
# (tests/test_kernels.py:244), then zamba2-7b's and mamba2-1.3b's (P, N,
# chunk) at a ragged S with one group over 8 heads; tolerances against
# the exact recurrence.
SSD_GRID = [(1, 64, 2, 16, 8, 16, 2), (2, 100, 3, 16, 8, 32, 3),
            (1, 256, 4, 32, 16, 64, 4), (1, 600, 8, 64, 64, 256, 1),
            (1, 600, 8, 64, 128, 256, 1)]
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# B8 with float32 y against its plain chunked version, whatever x's dtype:
# the plain version computes in float32; the kernels' bfloat16 products
# take their float32 operands in three bfloat16 parts (about 24 bits) and
# float32 ones run in 3xTF32, so the two differ by more than the order of
# their sums, still well inside this limit (the measured error is logged).
SSD_PLAIN_TOL = 1e-4
# The LM prefill: zamba2-7b at B = 2, S = 4096 (past the dense threshold
# of 2048; a multiple of the chunk) and S = 3000 (keys masked past Sk in
# B7's last tile, B8's last chunk ragged); last-token logits of the two
# backends within LM_TOL of the largest logit.
LM_PREFILL_S = (4096, 3000)
LM_TOL = 1e-3
LM_PREFILL = {"flash_attention": 13, "ssd": 81}
# (arch, depth, B, S, launches per forward) at full width.
LM_WIDTHS = (("gemma-2b", 2, 1, 4096, {"flash_attention": 2}),
             ("mamba2-1.3b", 4, 2, 3000, {"ssd": 4}))
# Decode (generate) after a prompt of 64 tokens: 32 new (deepseek) or 16
# (zamba2-7b) in phases 15 and 23; 8 after 32 in 16.  Each decode step's
# logits are held against the forward over the generated sequence: in
# float32 at the reference's decode tolerance (tests/test_models.py::
# test_decode_matches_forward), relative to max(1, |logit|).
GEN_PROMPT, GEN_NEW, ZAMBA_GEN_NEW = 64, 32, 16
WIDTHS_PROMPT, WIDTHS_NEW = 32, 8
GEN_CAPACITY = 16.0              # MoE capacity factor of the decode checks
DECODE_TOL = 2e-3
# bfloat16 logits of a deep stack against another bfloat16 computation of
# them that rounds differently (B7 against the scan; absorbed MLA decode
# against the decompressed forward): bfloat16 rounds every layer's output
# to 8 bits of mantissa, and over tens of layers of random weights the
# rounding compounds (and flips top-6 routing choices), so the two differ
# by a sizeable share of the logit scale.  This limit catches a wrong
# layer, slot or mask, whose logits are unrelated (errors of the order of
# the scale), not rounding; float32 carries the tight checks.
LM_BF16_TOL = 0.5
# deepseek-v2-lite-16b (phase 23, cell (o)): full width and depth in
# bfloat16, B7 once per MLA layer (27) at S = 4096; float32 at full width
# with depth cut to the dense layer and 3 MoE layers.  MOE_PARAMS counts
# every leaf (``param_count()`` leaves out the 126,464 norm scales).
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_PREFILL = {"flash_attention": 27}
MOE_F32_DEPTH = 4
MOE_PARAMS = 15_706_484_224
# LM training (phase 24): gemma-2b at full width, float32 (TF32 off), on
# the "torch" backend (B7 and B8 are forward-only).  (a) cut to 2 of its 18
# layers, one step with 2 microbatches of B = 2, S = 128 on the card and
# on the CPU; (b) whole at B = 1, S = 4096, a 4-step train_loop and then
# 4 steps at a constant lr on one batch, the last one profiled; (c) the
# cut model's train_loop resumed on the card; (d) the other families at
# full width, depth cut, at B = 1, S = 4096; (e) B7 and B8 refuse a graph.
TRAIN_ARCH, TRAIN_CUT = "gemma-2b", 2
TRAIN_PARITY_B, TRAIN_PARITY_S = 2, 128
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 4096, 4
TRAIN_FALL_LR = 1e-4
TRAIN_FAMILIES = (("deepseek-v2-lite-16b", 3), ("zamba2-7b", 6))
# Card against CPU, one step: the loss and the norm (float32 sums in
# another order); every moment within 1e-3 (v, squared: 2e-3) relative
# and 1e-3 of its leaf's largest; the parameters within rtol 1e-4, atol
# 1e-6, but where |g| is below 1e-3 of its leaf's largest (the first
# step's u = m / (sqrt(v) + eps) there is sensitive to g's last digits),
# held to the bound of one step, |new - old| <= 2 lr, and to the CPU's new
# value within TRAIN_SMALL_G_TOL lr: an update of the wrong sign is off by
# up to 2 lr |u|, and |u| is about 1 where |g| is well above eps.
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-4
TRAIN_RESUME_RTOL = 1e-6
TRAIN_SMALL_G_TOL = 1 / 8
# The training step's profiler ranges (the port's ``mrsch.lm.*``: opened
# by ``make_train_step``, ``transformer.loss``, each block and the
# attention core) and the group each names.  Backward kernels take their
# forward op's range (by autograd sequence number); block forwards run
# inside the backward are the remat recompute.
TRAIN_SCOPES = {"mrsch.lm.adamw": "AdamW update",
                "mrsch.lm.logits_ce": "cross-entropy with the logits",
                "mrsch.lm.attention": "attention scan"}
TRAIN_BLOCK_SCOPE = "mrsch.lm.block"
MATMUL_KERNELS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")
PEAK_BF16_FLOP_PER_S = 989e12
# TF32 on the tensor cores (dense): B7's float32 kernel does each product as
# three TF32 products (3xTF32), so its least time is 3 flops / this rate.
PEAK_TF32_FLOP_PER_S = 495e12
PEAKS_BF16 = ("H100 SXM data sheet: 3.35 TB/s HBM3, 989 TFLOP/s bfloat16 "
              "(tensor cores, dense), 67 TFLOP/s float32 (700 W)")

# Launches per unit of work, by kernel.  A forward of the paper-width MLP
# agent runs B1 13 times; one of the attention agent 25 times (tok, ctx,
# 6 per encoder layer x 2, out; 3 + 3 + 2 + 2 in the other modules) and
# B5 twice (one per encoder layer).  A train step adds the backward: dx
# for every layer but the three (MLP) or four (attention: tok, ctx and
# the measurement and goal input layers) whose input needs none.
KERNELS = ("forward", "dgrad", "wgrad", "window_pack", "mha", "mha_bwd_dq",
           "mha_bwd_dkv", "flash_attention", "ssd")
MLP_FORWARD = {"forward": 13}
ATTN_FORWARD = {"forward": 25, "mha": 2}
MLP_STEP = {"forward": 13, "dgrad": 10, "wgrad": 13}
ATTN_STEP = {"forward": 25, "dgrad": 21, "wgrad": 25, "mha": 2,
             "mha_bwd_dq": 2, "mha_bwd_dkv": 2}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phases
def phase_env() -> str:
    card = gpu_name_and_power_limit()
    log(card)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def timed(name: str, fn, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def phase_build() -> None:
    """The eight kernel libraries, one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_mlp import kernel as fm
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.window_pack import kernel as wp
    builds = (fm.build, fm.build_backward, wp.build, fa.build,
              fa.build_backward, fa.build_flash, fa.build_flash_sm90,
              sk.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = [pool.submit(b) for b in builds]
        infos = [f.result() for f in futures]
    for load in (fm._library, fm._backward_library, wp._library,
                 fa._library, fa._backward_library, fa._flash_library,
                 fa._flash_sm90_library, sk._library):
        load()
    for info in infos:
        log(f"[build] {info.library.name}: {info.seconds:.3f} s of nvcc")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")


def phase_parity() -> float:
    """Kernel vs plain version on the card; returns the worst float32
    absolute error."""
    from repro_torch.kernels.fused_mlp import (ACTIVATIONS, fused_mlp,
                                               fused_mlp_layer_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    grid = ([(k, n_out, ENCODER_FWD_M) for k, n_out in ENCODER_WGRAD]
            + [(k, n_out, PARITY_M) for k, n_out in DFP_SHAPES[::-1]])
    for k, n_out, ms in grid:       # the 11410 x 4000 layer last: w32, b32
        w32 = torch.randn(k, n_out, generator=gen, device="cuda") / math.sqrt(k)
        b32 = 0.1 * torch.randn(n_out, generator=gen, device="cuda")
        for dtype, tol in TOL.items():
            w, b = w32.to(dtype), b32.to(dtype)
            for m in ms:
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                for act in ACTIVATIONS:
                    with torch.no_grad():
                        y = fused_mlp(x, w, b, activation=act).float()
                        r = fused_mlp_layer_ref(x, w, b, act).float()
                    torch.cuda.synchronize()
                    err = (y - r).abs()
                    bad = err > tol + tol * r.abs()
                    if bad.any():
                        raise AssertionError(
                            f"[parity] K={k} N={n_out} M={m} {dtype} {act}: "
                            f"{int(bad.sum())} elements off, max abs err "
                            f"{float(err.max())}")
                    worst[dtype] = max(worst[dtype], float(err.max()))
                    n += 1
    # The 11410 x 4000 layer at M = 64 splits K into 17 ranges: two
    # launches add the partial sums in the same order.
    k, n_out = DFP_SHAPES[0]
    x = torch.randn(64, k, generator=gen, device="cuda")
    with torch.no_grad():
        ys = [fused_mlp(x, w32, b32) for _ in range(2)]
    what = f"M=64 K={k} N={n_out} ({fused_mlp_plan(64, k, n_out)})"
    if not torch.equal(*ys):
        raise AssertionError(f"[parity] two launches at {what} differ")
    log(f"[parity] {n} cases pass; worst abs err float32 "
        f"{worst[torch.float32]!r} (tol 2e-4), bfloat16 "
        f"{worst[torch.bfloat16]!r} (tol 2e-2); two launches at {what} "
        f"bit-equal")
    return worst[torch.float32]


def fused_mlp_plan(m: int, k: int, n: int) -> str:
    from repro_torch.kernels.fused_mlp import kernel as fm
    name, _, splits, chunk = fm.forward_plan(
        m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
    return f"{name}, {splits} K splits of {chunk}"


def wp_inputs(n: int, j: int, f: int, density: float, gen) -> tuple:
    """Waiting mask and features on the card; the first row is made to
    hold fewer than W waiting jobs (here: three), and J is ragged."""
    waiting = (torch.rand(n, j, generator=gen, device="cuda")
               < density).float()
    if density > 0.0:
        waiting[0] = 0.0
        waiting[0, :min(3, j)] = 1.0
    feats = torch.randn(n, j, f, generator=gen, device="cuda")
    return waiting, feats


def wp_check(waiting, feats, w: int, what: str) -> float:
    """Kernel vs plain version on one input, bit for bit; returns the
    largest absolute difference over the three outputs (0.0 when equal)."""
    from repro_torch.kernels.window_pack import (pack_window,
                                                 pack_window_reference)
    out = pack_window(waiting, feats, window=w)
    ref = pack_window_reference(waiting, feats, window=w)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("win_feats", "win_idx", "win_valid"), out, ref):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"[window_pack parity] {what}: {name} "
                                 f"differs")
        err = max(err, float((a.float() - b.float()).abs().max()))
    return err


def phase_window_pack_parity() -> float:
    """Kernel vs plain version on the card, bit for bit, at synthetic
    shapes; returns the largest absolute difference."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases, err = 0, 0.0
    for n, j, f, w in WP_PARITY:
        for density in WP_DENSITIES:
            waiting, feats = wp_inputs(n, j, f, density, gen)
            err = max(err, wp_check(waiting, feats, w,
                                    f"N={n} J={j} F={f} W={w} "
                                    f"density={density}"))
            cases += 1
    log(f"[window_pack parity] {cases} cases bit-identical (torch.equal on "
        f"features, indices and validity); max abs err {err!r}")
    return err


def mha_case(bh: int, s: int, dh: int, gen) -> tuple:
    """q, k, v, do (BH, S, dh) on the card and lengths 0, 1, S//2, S, 15,
    16 and 17, then random (BH < 7 takes the first BH of those)."""
    q, k, v, do = (torch.randn(bh, s, dh, generator=gen, device="cuda")
                   for _ in range(4))
    lens = torch.randint(0, s + 1, (bh,), generator=gen,
                         device="cuda").float()
    head = torch.tensor([0.0, 1.0, s // 2, s, 15.0, 16.0, 17.0],
                        device="cuda")[:bh]
    lens[:len(head)] = head
    return q, k, v, do, lens


def mha_check(q, k, v, do, lens, what: str) -> dict:
    """B5 and both B6 kernels against their plain versions on one input
    (the backward from the plain forward's lse and delta); returns each
    kernel's largest absolute difference.  Rows of length 0 and keys past
    a row's length must come out exactly 0, and everything finite."""
    from repro_torch.kernels.flash_attention import (mha_bwd_dkv, mha_bwd_dq,
                                                     mha_bwd_ref, mha_fwd,
                                                     mha_fwd_ref)
    o, lse = mha_fwd(q, k, v, lens)
    ro, rlse = mha_fwd_ref(q, k, v, lens)
    delta = (do * ro).sum(-1)
    dq = mha_bwd_dq(q, k, v, do, rlse, delta, lens)
    dk, dv = mha_bwd_dkv(q, k, v, do, rlse, delta, lens)
    rdq, rdk, rdv = mha_bwd_ref(q, k, v, do, rlse, delta, lens)
    torch.cuda.synchronize()
    valid = lens > 0
    kmask = torch.arange(k.shape[1], device="cuda")[None, :] >= lens[:, None]
    errs = {}
    for name, got, ref, zero in (
            ("mha_fwd", (o, lse[valid]), (ro, rlse[valid]), (o[~valid],)),
            ("mha_bwd_dq", (dq,), (rdq,), (dq[~valid],)),
            ("mha_bwd_dkv", (dk, dv), (rdk, rdv), (dk[kmask], dv[kmask]))):
        err = max(float((a - b).abs().max()) if a.numel() else 0.0
                  for a, b in zip(got, ref))
        if not err <= MHA_TOL[name]:
            raise AssertionError(f"[mha parity] {name} {what}: max abs err "
                                 f"{err} > {MHA_TOL[name]}")
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"[mha parity] {name} {what}: non-finite")
        if any(t.numel() and t.abs().max() != 0 for t in zero):
            raise AssertionError(f"[mha parity] {name} {what}: masked "
                                 f"rows or keys not exactly 0")
        errs[name] = err
    if not (torch.isfinite(lse).all() and (lse[~valid] < -1e29).all()):
        raise AssertionError(f"[mha parity] {what}: lse of masked rows")
    return errs


def phase_mha_parity() -> dict:
    """The attention kernels against their plain versions over MHA_GRID,
    then a fully masked case through ``mha`` and its gradient; returns
    each kernel's worst absolute error."""
    from repro_torch.kernels.flash_attention import mha
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = dict.fromkeys(MHA_TOL, 0.0)
    for bh, s, dh in MHA_GRID:
        errs = mha_check(*mha_case(bh, s, dh, gen), f"BH={bh} S={s} dh={dh}")
        worst = {k: max(worst[k], errs[k]) for k in worst}
    q, k, v, _, _ = mha_case(8, 129, 16, gen)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = mha(q, k, v, torch.zeros(8, device="cuda"))
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    torch.cuda.synchronize()
    for t in (out, *grads):
        assert torch.isfinite(t).all() and not t.abs().max(), \
            "[mha parity] a fully masked case is not exactly 0"
    mha_repeat(gen)
    log(f"[mha parity] {len(MHA_GRID)} shapes (BH, S, dh) {MHA_GRID}, "
        f"lengths 0, 1, S//2, S, 15, 16, 17 and random: worst abs err "
        f"mha_fwd {worst['mha_fwd']!r} (tol 2e-5), mha_bwd_dq "
        f"{worst['mha_bwd_dq']!r}, mha_bwd_dkv {worst['mha_bwd_dkv']!r} "
        f"(tol 1e-4); masked rows and keys exactly 0; a fully masked "
        f"(8, 129, 16) output and its three gradients exactly 0; two calls "
        f"of each kernel at {MHA_REPEAT} bit-equal")
    return worst


def mha_repeat(gen) -> None:
    """Each masked-attention kernel called twice on the same inputs at
    MHA_REPEAT must give the same bits (no atomics, a fixed order)."""
    from repro_torch.kernels.flash_attention import (mha_bwd_dkv, mha_bwd_dq,
                                                     mha_fwd)
    q, k, v, do, lens = mha_case(*MHA_REPEAT, gen)
    runs = []
    for _ in range(2):
        o, lse = mha_fwd(q, k, v, lens)
        delta = (do * o).sum(-1)
        runs.append((o, lse, mha_bwd_dq(q, k, v, do, lse, delta, lens),
                     *mha_bwd_dkv(q, k, v, do, lse, delta, lens)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        if not torch.equal(a, b):
            raise AssertionError(f"[mha parity] two calls at {MHA_REPEAT} "
                                 f"differ in {name}")


def wp_bound(waiting: torch.Tensor, f: int, w: int) -> tuple:
    """(bytes, operations) times of one window pack, in ms, for this
    data: each row's waiting mask read up to its W-th waiting job (all of
    it when fewer wait), the selected feature rows read once, the outputs
    (features, int32 index, byte validity) written once; one compare per
    mask entry read, over the float32 rate.  Bytes bound it."""
    n, j = waiting.shape
    csum = torch.cumsum((waiting > 0.5).int(), dim=1)
    hit = csum >= w
    first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1,
                        torch.full_like(csum[:, 0], j))
    read = int(first.sum())
    selected = int(csum[:, -1].clamp_max(w).sum())
    nbytes = 4 * read + 4 * f * selected + n * w * (4 * f + 4 + 1)
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            read / PEAK_F32_FLOP_PER_S * 1e3)


def phase_window_pack_timing() -> None:
    from repro_torch.kernels.window_pack import (pack_window,
                                                 pack_window_reference)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n, j, f, w in WP_TIMING:
        waiting, feats = wp_inputs(n, j, f, 0.4, gen)
        t_k = device_ms(lambda: pack_window(waiting, feats, window=w), flush)
        t_p = device_ms(lambda: pack_window_reference(waiting, feats,
                                                      window=w), flush)
        b_ms, o_ms = wp_bound(waiting, f, w)
        by = "bytes" if b_ms >= o_ms else "operations"
        log(f"[window_pack timing] N={n} J={j} F={f} W={w} (density 0.4): "
            f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  bound "
            f"{max(b_ms, o_ms):.6f} ms ({by}); no single PyTorch call "
            f"computes it")


def front_bound(spec, args: dict, out) -> tuple:
    """(bytes, operations) times of one call of the round's front, in ms,
    for this data: each input read once where the outputs depend on it,
    each output written once.  The job flags, ``now`` and ``release`` (and
    ``owner`` with drains) are read whole; where the rows carry the goal,
    walltime only of the waiting jobs, est_end only of the running ones
    (started, not finished), demands only of their union (every other
    job's goal weight is 0), and feature rows only of the selected jobs.
    Per job 4 compares and, for a job in the goal, 3 + 2R flops; per unit
    6 (compare, clamp, scale, sums); per selected slot 2; over the float32
    rate.  Bytes bound it."""
    n, j = args["ready"].shape
    R, U, K = spec.n_resources, spec.n_units, spec.k
    rows = spec.mode != "mask"
    selected = int(out.valid.sum())
    read = n * (j * (4 + 3) + 4 + 4 * U) + 4 * R
    if spec.has_drains:
        read += 4 * n * U
    ops = n * j * 4 + 6 * n * U + 2 * selected
    if rows:
        waiting = out.waiting > 0.5
        running = args["started"] & ~args["finished"]
        in_goal = int((waiting | running).sum())
        read += (4 * int(waiting.sum()) + 4 * int(running.sum())
                 + 4 * R * in_goal + 4 * (R + 2) * selected)
        ops += (3 + 2 * R) * in_goal
    written = n * (4 * j + 4 + 4 * R + 4 * K + K + 4 * spec.row_dim)
    return ((read + written) / PEAK_BYTES_PER_S * 1e3,
            ops / PEAK_F32_FLOP_PER_S * 1e3)


def front_check(spec, args: dict, what: str) -> tuple:
    """The fused front against its plain composite on one round: every
    output bit for bit but the summed columns of the rows (the goal, the
    attention context's mean TTF: sums over the job or unit axis in
    another order), which must agree within FRONT_SUMMED_ATOL/RTOL.
    Returns the largest absolute difference (0.0 when equal) and the
    number of waiting jobs over the environments."""
    from repro_torch.kernels.window_pack import (pack_decision_rows,
                                                 pack_decision_rows_reference)
    out = pack_decision_rows(spec, **args)
    ref = pack_decision_rows_reference(spec, **args)
    summed = torch.zeros(spec.row_dim, dtype=torch.bool, device="cuda")
    summed[list(spec.summed_columns)] = True
    err = 0.0
    for name, a, b in zip(out._fields, out, ref):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"[front] {what}: {name} is {a.dtype} "
                                 f"{tuple(a.shape)}, plain {b.dtype} "
                                 f"{tuple(b.shape)}")
        if name == "obs":
            if not torch.allclose(a[:, summed], b[:, summed],
                                  rtol=FRONT_SUMMED_RTOL,
                                  atol=FRONT_SUMMED_ATOL):
                raise AssertionError(f"[front] {what}: summed columns "
                                     f"differ beyond the tolerance")
            err = max(err, float((a[:, summed] - b[:, summed]).abs().max()
                                 if summed.any() else 0.0))
            a, b = a[:, ~summed], b[:, ~summed]
        if not torch.equal(a, b):
            raise AssertionError(f"[front] {what}: {name} differs")
    return err, int(out.n_waiting.sum())


def host_ms(fn, reps: int = 15) -> float:
    """Median host time to issue ``fn`` (the card idle before each)."""
    walls = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(walls[2:]) * 1e3


def phase_window_pack_main_path(sim, tag="window_pack main path") -> dict:
    """The round's front (``pack_decision_rows``, the fused window-pack
    kernel) on the inputs the device engine's main path gives it: one more
    greedy rollout records every deciding round's operands; each round is
    held against the plain composite (``front_check``), and the round with
    the median number of waiting jobs is timed (L2 flushed): the kernel,
    the composite with one event pair around it, and the host time to
    issue each.  The front packs K = W slots, or K = Q for the attention
    layout.  The launches made here are not counted: the main path's count
    was read before."""
    from repro_torch.kernels.window_pack import (pack_decision_rows,
                                                 pack_decision_rows_reference)
    from repro_torch.sim import device as device_mod
    calls = []

    def recording(spec, **args):
        calls.append((spec, {k: v if v is None or k in ROLLOUT_CONSTANT
                             else v.clone() for k, v in args.items()}))
        return pack_decision_rows(spec, **args)

    device_mod.pack_decision_rows = recording
    try:
        sim.rollout()
    finally:
        device_mod.pack_decision_rows = pack_decision_rows
    lay = sim.layout
    assert len(calls) == sim.stats.rounds > 0, (len(calls), sim.stats)
    err, n_wait = 0.0, []
    for t, (spec, args) in enumerate(calls):
        e, waiting = front_check(spec, args, f"{tag} round {t}")
        err = max(err, e)
        n_wait.append(waiting)
    t_med = int(np.argsort(n_wait)[len(calls) // 2])
    spec, args = calls[t_med]
    n, j = args["ready"].shape
    k = lay.queue_cap if lay.state_module == "attention" else lay.window
    assert (n, j, spec.k, spec.mode) == (lay.n_envs, lay.n_jobs, k,
                                         lay.state_module), (spec, lay)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def run():
        return pack_decision_rows(spec, **args)

    def plain():
        return pack_decision_rows_reference(spec, **args)

    t_k, t_p = device_ms(run, flush), device_ms(plain, flush)
    h_k, h_p = host_ms(run), host_ms(plain)
    b_ms, o_ms = front_bound(spec, args, run())
    by = "bytes" if b_ms >= o_ms else "operations"
    log(f"[{tag}] {len(calls)} rounds at N={n} J={j} K={spec.k} "
        f"U={spec.n_units}, rows of {spec.row_dim} ({spec.mode}): the "
        f"fused front equals its plain composite bit for bit but the "
        f"{len(spec.summed_columns)} summed columns (max abs err {err!r}, "
        f"limits atol {FRONT_SUMMED_ATOL} rtol {FRONT_SUMMED_RTOL})")
    log(f"[{tag}] round {t_med} ({int(n_wait[t_med])} jobs waiting, the "
        f"median): kernel {t_k:.4f} ms  composite {t_p:.4f} ms (one event "
        f"pair)  bound {max(b_ms, o_ms):.6f} ms ({by}); host issue: "
        f"kernel {h_k:.4f} ms, composite {h_p:.4f} ms; no single PyTorch "
        f"call computes it")
    return {"shape": (n, j, spec.k), "rounds": len(calls),
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": max(b_ms, o_ms), "bound_by": by, "host_ms": h_k,
            "plain_host_ms": h_p}


def forward_layers(net) -> list:
    """(K, N, activation) of the 13 dense layers of one DFP forward."""
    out = []
    for name, final in (("state", "leaky_relu"), ("measurement", "leaky_relu"),
                        ("goal", "leaky_relu"), ("expectation", "linear"),
                        ("action", "linear")):
        layers = getattr(net, name).layers
        for i, layer in enumerate(layers):
            k, n = layer.w.shape
            out.append((k, n, "leaky_relu" if i < len(layers) - 1 else final))
    return out


def bound_ms(m: int, k: int, n: int) -> tuple:
    """(bytes, operations) times of one float32 layer, in ms: x, W, b read
    once and y written once over the HBM rate; 2MKN flops over the
    float32 rate.  The bound is the larger of the two."""
    byte_s = 4.0 * (m * k + k * n + n + m * n) / PEAK_BYTES_PER_S
    flop_s = 2.0 * m * k * n / PEAK_F32_FLOP_PER_S
    return byte_s * 1e3, flop_s * 1e3


@dataclass
class DeviceOp:
    """One name's device events: what ``key_averages()`` gives per name."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0          # microseconds


def device_events(prof) -> list:
    """The profile's events that ran on the card (kernels, copies, fills),
    summed by name.  Only these are summed: an operator's own entry also
    carries the device time of the kernels it launched, so summing every
    entry counts those kernels twice.  They are read from the profiler's
    raw records: ``key_averages()`` first builds the event tree of every
    record, host and device, whose cost grows with the record count (a
    device rollout issues 300,000-500,000 device operations)."""
    from torch.autograd import DeviceType
    ops = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or getattr(e, "is_hidden_event", lambda: False)()
                or e.name().startswith("[")):       # [memory] records
            continue
        op = ops.setdefault(e.name(), DeviceOp(e.name()))
        op.count += 1
        op.self_device_time_total += e.duration_ns() / 1e3
    return list(ops.values())


def device_ms(fn, flush: torch.Tensor, reps: int = 15,
              sleep_cycles: int = 2_000_000) -> float:
    """Median device time of one call of ``fn``, timed with CUDA events,
    with L2 flushed before each call (a forward finds each layer's W cold:
    the 182.6 MB first layer evicts the rest).  A device-side sleep after
    the flush keeps the card busy while the host enqueues ``fn``, so the
    host's time to prepare the launches is not counted."""
    pairs = []
    for _ in range(reps + 2):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs[2:])


def phase_timing(agent) -> dict:
    from repro_torch.core.dfp import action_values
    from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_layer_ref
    log(f"[timing] bounds from {PEAKS}; card: {gpu_name_and_power_limit()}")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    layers = forward_layers(agent.net)
    per_shape = {}
    for k, n in DFP_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        b = 0.1 * torch.randn(n, generator=gen, device="cuda")
        for act in sorted({a for kk, nn_, a in layers if (kk, nn_) == (k, n)}):
            for m in TIMING_M:
                x = torch.randn(m, k, generator=gen, device="cuda")
                lib_act = ((lambda y: F.leaky_relu(y, 0.2))
                           if act == "leaky_relu" else (lambda y: y))
                with torch.no_grad():
                    t_k = device_ms(lambda: fused_mlp(x, w, b, activation=act),
                                    flush)
                    t_p = device_ms(lambda: fused_mlp_layer_ref(x, w, b, act),
                                    flush)
                    t_l = device_ms(lambda: lib_act(torch.addmm(b, x, w)),
                                    flush)
                b_ms, o_ms = bound_ms(m, k, n)
                per_shape[(k, n, act, m)] = (t_k, t_p, t_l, b_ms, o_ms)
                log(f"[timing] layer K={k:5d} N={n:4d} {act:10s} M={m:2d}: "
                    f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
                    f"addmm+act {t_l:.4f} ms  bound {max(b_ms, o_ms):.4f} ms "
                    f"({'bytes' if b_ms >= o_ms else 'operations'})")
    # The attention encoder's token layers at M = 64 x 129 rows.
    m = ENCODER_FWD_M[-1]
    encoder = {}
    for (k, n), act in ENCODER_ACT.items():
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        b = 0.1 * torch.randn(n, generator=gen, device="cuda")
        x = torch.randn(m, k, generator=gen, device="cuda")
        lib_act = ((lambda y: F.leaky_relu(y, 0.2))
                   if act == "leaky_relu" else (lambda y: y))
        with torch.no_grad():
            t_k = device_ms(lambda: fused_mlp(x, w, b, activation=act), flush)
            t_p = device_ms(lambda: fused_mlp_layer_ref(x, w, b, act), flush)
            t_l = device_ms(lambda: lib_act(torch.addmm(b, x, w)), flush)
        b_ms, o_ms = bound_ms(m, k, n)
        encoder[(k, n)] = (t_k, t_p, t_l, b_ms, o_ms)
        log(f"[timing] encoder layer K={k:3d} N={n:3d} {act:10s} M={m}: "
            f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  addmm+act {t_l:.4f} "
            f"ms  bound {max(b_ms, o_ms):.4f} ms "
            f"({'bytes' if b_ms >= o_ms else 'operations'}); "
            f"{fused_mlp_plan(m, k, n)}")
    sums = {}
    for m in TIMING_M:
        rows = [per_shape[(k, n, a, m)] for k, n, a in layers]
        t_k, t_p, t_l, b_ms, o_ms = (sum(r[i] for r in rows)
                                     for i in range(5))
        by = "bytes" if b_ms >= o_ms else "operations"
        sums[m] = (t_k, t_p, t_l, max(b_ms, o_ms), by)
        log(f"[timing] 13 layers at M={m:2d}, summed: kernel {t_k:.4f} ms  "
            f"plain {t_p:.4f} ms  addmm+act {t_l:.4f} ms  bound "
            f"{max(b_ms, o_ms):.4f} ms ({by}); "
            f"{fused_mlp_plan(m, *DFP_SHAPES[0])} on the widest layer")
    # The whole forward (``action_values``, 13 dense layers plus the dueling
    # and goal arithmetic), W streaming from HBM: its device time, then
    # back to back as a loop of calls (what the host sustains), then one
    # call waited for (what a request sees).  Runs in the order kernel,
    # torch, torch, kernel.
    dfp_torch = replace(agent.dfp, backend="torch")
    sd, nm = agent.dfp.state_dim, agent.dfp.n_measurements
    forward = {}
    for m in TIMING_M:
        state = torch.rand(m, sd, generator=gen, device="cuda")
        meas = torch.rand(m, nm, generator=gen, device="cuda")
        goal = torch.softmax(torch.rand(m, nm, generator=gen, device="cuda"),
                             -1)
        runs = {"kernel": [], "torch": []}
        for dfp in (agent.dfp, dfp_torch, dfp_torch, agent.dfp):
            fwd = lambda: action_values(agent.net, dfp, state, meas, goal)
            dev = device_ms(fwd, flush, reps=10, sleep_cycles=20_000_000)
            reps = 30
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fwd()
            e1.record()
            torch.cuda.synchronize()
            loop = e0.elapsed_time(e1) / reps
            lat = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fwd()
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            runs[dfp.backend].append((dev, loop, statistics.median(lat)))
        forward[m] = runs
        for be, r in runs.items():
            log(f"[timing] whole forward M={m:2d} {be:6s}: device "
                f"{r[0][0]:.4f}/{r[1][0]:.4f} ms  back-to-back "
                f"{r[0][1]:.4f}/{r[1][1]:.4f} ms  waited-for call "
                f"{r[0][2]:.4f}/{r[1][2]:.4f} ms  (bound {sums[m][3]:.4f} ms)")
    return {"sums": sums, "forward": forward, "encoder": encoder}


class SampledPolicy:
    """ServicePolicy that also keeps every ``every``-th served row and the
    action the service gave it, and every decision's queue length."""

    def __init__(self, service, sink: list, every: int):
        from repro_torch.serve import ServicePolicy
        self._inner = ServicePolicy(service, track_latency=True)
        self.latencies_s = self._inner.latencies_s
        self.service, self.sink, self.every, self.n = service, sink, every, 0
        self.queue_lens: list = []

    def select(self, ctx) -> int:
        action = self._inner.select(ctx)
        if self.n % self.every == 0:
            self.sink.append((self.service._encode(ctx), action))
        self.queue_lens.append(ctx.queue_len)
        self.n += 1
        return action


def check_served_rows(agent, sampled: list) -> tuple:
    """Served rows ``(row, action)`` scored on the kernel and the plain
    backend on the card, in service-sized batches: the values within 2e-4
    of the largest, and where the top-2 margin exceeds that tolerance the
    same argmax, which the service also served.  Returns (max abs error,
    tolerance, rows with a decisive margin)."""
    from repro_torch.core.dfp import action_values
    sd, m = agent.enc.state_dim, agent.enc.n_resources
    dfp_torch = replace(agent.dfp, backend="torch")
    rows = torch.from_numpy(np.stack([r for r, _ in sampled])).to(agent.device)
    served = np.asarray([a for _, a in sampled])
    u_k, u_t = [], []
    for i in range(0, rows.shape[0], 16):            # service-sized batches
        chunk = rows[i:i + 16]
        args = (chunk[:, :sd].contiguous(), chunk[:, sd:sd + m].contiguous(),
                chunk[:, sd + m:sd + 2 * m].contiguous())
        u_k.append(action_values(agent.net, agent.dfp, *args))
        u_t.append(action_values(agent.net, dfp_torch, *args))
    valid = rows[:, sd + 2 * m:] > 0.5
    u_k = torch.where(valid, torch.cat(u_k), -torch.inf).cpu().numpy()
    u_t = torch.where(valid, torch.cat(u_t), -torch.inf).cpu().numpy()
    fin = np.isfinite(u_t)
    assert (np.isfinite(u_k) == fin).all()
    scale = max(1.0, float(np.abs(u_t[fin]).max()))
    tol = 2e-4 * scale
    err = float(np.abs(u_k[fin] - u_t[fin]).max())
    assert err <= tol, f"kernel vs torch action values: {err} > {tol}"
    top2 = np.sort(np.where(fin, u_t, -np.inf), axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]                 # inf with one valid slot
    decisive = margin > tol
    assert (u_k.argmax(1)[decisive] == u_t.argmax(1)[decisive]).all()
    assert (served[decisive] == u_t.argmax(1)[decisive]).all()
    return err, tol, int(decisive.sum())


def phase_main_path(agent, trace=None, per_forward=MLP_FORWARD,
                    every=(25, 50), tag="main") -> dict:
    """The decision service: one client replays the trace of seed 0, then
    eight client threads the traces of seeds 1-8 (``trace(seed)``, by
    default ``s1_trace``); ``every`` sets which served rows of each are
    held against the plain backend."""
    from repro_torch.serve import DecisionService, ServeConfig, ServiceSim

    trace = trace or s1_trace
    res, jobs_a = trace(0)
    traces_b = [trace(seed)[1] for seed in range(1, 9)]
    sampled: list = []

    svc = DecisionService(agent, ServeConfig(max_batch=16))
    reset_launch_counts()
    t0 = time.perf_counter()
    svc.start()                                      # warm-up forwards
    warm_s = time.perf_counter() - t0

    # (a) one trace, one client
    ssim = ServiceSim(svc, res)
    ssim.policy = SampledPolicy(svc, sampled, every=every[0])
    t0 = time.perf_counter()
    res_a = ssim.run_trace(jobs_a)
    wall_a = time.perf_counter() - t0
    lat_a = list(ssim.policy.latencies_s)
    qlens = list(ssim.policy.queue_lens)
    hist_a = svc.stats()["batch_hist"]

    # (b) eight clients, one trace each, concurrently
    results_b, lat_b, errors = [None] * 8, [], []

    def client(i: int) -> None:
        try:
            sim = ServiceSim(svc, res)
            sim.policy = SampledPolicy(svc, sampled, every=every[1])
            results_b[i] = sim.run_trace(traces_b[i])
            lat_b.extend(sim.policy.latencies_s)
            qlens.extend(sim.policy.queue_lens)
        except BaseException as e:                   # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_b = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert all(not t.is_alive() for t in threads), "client threads hung"
    svc.stop()
    torch.cuda.synchronize()
    counts = launch_counts()
    stats = svc.stats()

    # Launches: ``per_forward`` of each kernel per forward, one forward per
    # dispatch (warm-up widths + served batches).
    forwards = stats["buckets"]["dispatches"]
    assert forwards == len(svc._buckets.widths) + stats["batches"], stats
    assert forwards > 0 and counts == times(per_forward, forwards), \
        (counts, forwards)
    launches = counts["forward"]

    dec_a = res_a.decisions
    dec_b = sum(r.decisions for r in results_b)
    assert dec_a == len(lat_a) and dec_b == len(lat_b)
    assert stats["requests"] == dec_a + dec_b
    for r in [res_a, *results_b]:
        row = r.metrics.as_row()
        assert r.decisions > 0 and r.n_unstarted == 0, (r.decisions,
                                                        r.n_unstarted)
        assert all(math.isfinite(v) for v in row.values()), row
    hist_b = {w: c - hist_a.get(w, 0) for w, c in stats["batch_hist"].items()
              if c - hist_a.get(w, 0)}

    err, tol, decisive = check_served_rows(agent, sampled)
    lat = np.asarray(lat_a + lat_b) * 1e3
    out = {
        "launches": launches, "counts": counts, "forwards": forwards,
        "queue_mean": float(np.mean(qlens)), "queue_max": int(max(qlens)),
        "batches": stats["batches"], "warmup_s": warm_s,
        "decisions_a": dec_a, "wall_a_s": wall_a,
        "decisions_b": dec_b, "wall_b_s": wall_b,
        "dps_a": dec_a / wall_a, "dps_b": dec_b / wall_b,
        "p50_a_ms": float(np.percentile(np.asarray(lat_a) * 1e3, 50)),
        "p99_a_ms": float(np.percentile(np.asarray(lat_a) * 1e3, 99)),
        "p50_b_ms": float(np.percentile(np.asarray(lat_b) * 1e3, 50)),
        "p99_b_ms": float(np.percentile(np.asarray(lat_b) * 1e3, 99)),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "batch_hist_a": hist_a, "batch_hist_b": hist_b,
        "sampled": len(sampled), "decisive": decisive,
        "u_err": err, "u_tol": tol, "metrics_a": res_a.metrics.as_row(),
    }
    per = ", ".join(f"{k} {v}" for k, v in per_forward.items())
    log(f"[{tag}] warm-up {warm_s:.3f} s; launches {json.dumps(counts)} = "
        f"({per}) x {forwards} forwards ({len(svc._buckets.widths)} warm-up "
        f"+ {stats['batches']} batches)")
    log(f"[{tag}] queue length over {len(qlens)} decisions: mean "
        f"{out['queue_mean']:.2f}, max {out['queue_max']}")
    log(f"[{tag}] (a) 1 client: {dec_a} decisions in {wall_a:.3f} s = "
        f"{out['dps_a']:.1f} decisions/s; latency p50 {out['p50_a_ms']:.3f} "
        f"ms p99 {out['p99_a_ms']:.3f} ms; batch sizes {hist_a}")
    log(f"[{tag}] (b) 8 clients: {dec_b} decisions in {wall_b:.3f} s = "
        f"{out['dps_b']:.1f} decisions/s; latency p50 {out['p50_b_ms']:.3f} "
        f"ms p99 {out['p99_b_ms']:.3f} ms; batch sizes {hist_b}")
    log(f"[{tag}] sampled {out['sampled']} served rows: kernel vs torch "
        f"action values max abs err {err!r} (tol {tol!r}); argmax equal on "
        f"all {out['decisive']} rows with top-2 margin > tol")
    log(f"[{tag}] (a) ScheduleMetrics {json.dumps(res_a.metrics.as_row())}")
    return out


def phase_breakdown(agent, n_decisions: int = 300) -> dict:
    """Where one client's decision time goes: the first ``n_decisions`` of
    the (a) trace, stepped by hand at width 1 — simulator, row encoding,
    and the forward (host-to-device copy, 13 kernel launches, argmax,
    device-to-host copy and wait).  A second, identical pass under
    ``torch.profiler`` sums the device's kernel time; the busy share is
    that over the first pass's wall time (the profiler slows the host).
    Runs after the main path's launches are read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import DecisionService, ServeConfig
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.workloads import ThetaConfig, build_scenarios

    cfg = ThetaConfig(duration_days=2.0, jobs_per_day=160.0, seed=0)
    jobs = build_scenarios(cfg, ("S1",))["S1"]
    svc = DecisionService(agent, ServeConfig(max_batch=16))
    svc.warmup()

    def steps():
        sim = Simulator(cfg.resources(), jobs, None, SimConfig.for_engine())
        t = np.zeros(3)
        n = 0
        wall0 = time.perf_counter()
        while n < n_decisions:
            t0 = time.perf_counter()
            ctx = sim.next_decision()
            t1 = time.perf_counter()
            if ctx is None:
                break
            row = svc._encode(ctx)
            t2 = time.perf_counter()
            action = svc._process([row])[0]
            t3 = time.perf_counter()
            sim.post_action(action)
            t[:] += ((t1 - t0) + (time.perf_counter() - t3), t2 - t1, t3 - t2)
            n += 1
        return n, time.perf_counter() - wall0, t * 1e3 / max(n, 1)

    n, wall, (sim_ms, enc_ms, fwd_ms) = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
    events = device_events(prof)
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    out = {"decisions": n, "wall_ms": wall * 1e3, "sim_ms": sim_ms,
           "encode_ms": enc_ms, "forward_ms": fwd_ms,
           "device_busy_ms": kernel_ms,
           "device_busy_share": kernel_ms / (wall * 1e3)}
    log(f"[breakdown] {n} decisions at width 1 in {wall * 1e3:.1f} ms: per "
        f"decision simulator {sim_ms:.4f} ms, encode {enc_ms:.4f} ms, "
        f"forward (copy, launches, wait) {fwd_ms:.4f} ms")
    log(f"[breakdown] device kernels (torch.profiler, second pass) "
        f"{kernel_ms:.3f} ms = busy share {out['device_busy_share']:.4f} of "
        f"the first pass's wall time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[breakdown]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")
    return out


def s1_trace(seed: int, days: float = 2.0, per_day: float = 160.0):
    """Full-scale Theta S1, by default 2 days at 160 jobs/day (the MLP
    agent's traces)."""
    from repro_torch.workloads import ThetaConfig, build_scenarios
    cfg = ThetaConfig(duration_days=days, jobs_per_day=per_day, seed=seed)
    return cfg.resources(), build_scenarios(cfg, ("S1",))["S1"]


def attn_trace(seed: int):
    """Full-scale Theta S1, 1 day at 400 jobs/day: the attention agent's
    traces, whose queues reach past Q = 128."""
    return s1_trace(seed, days=1.0, per_day=400.0)


class Recorder:
    """Wrap a policy so the sequential engine's action sequence is kept."""

    def __init__(self, policy):
        self.policy, self.actions = policy, []

    def select(self, ctx) -> int:
        a = int(self.policy.select(ctx))
        self.actions.append(a)
        return a


def env_actions(ro, i: int) -> list:
    return [int(a) for a, d in zip(ro.actions[:, i], ro.decided[:, i]) if d]


def assert_results_close(a, b, rtol=1e-5, atol=1e-2) -> None:
    """Host (f64 clock) vs device (f32 clock) results: the same schedule,
    metrics equal to float32 precision (the rule of the JAX package's
    tests/test_device.py)."""
    assert a.decisions == b.decisions, (a.decisions, b.decisions)
    assert a.n_unstarted == b.n_unstarted, (a.n_unstarted, b.n_unstarted)
    ra, rb = a.metrics.as_row(), b.metrics.as_row()
    assert set(ra) == set(rb)
    for k in ra:
        assert np.isclose(ra[k], rb[k], rtol=rtol, atol=atol), \
            (k, ra[k], rb[k])
    for ja, jb in zip(a.jobs, b.jobs):
        assert ja.jid == jb.jid and ja.started == jb.started
        if ja.started:
            assert np.isclose(ja.start, jb.start, rtol=1e-6, atol=1e-2), \
                (ja.jid, ja.start, jb.start)


def phase_device_parity(agent) -> dict:
    """The device engine against the sequential engine at full width."""
    from repro_torch.core import FCFSPolicy
    from repro_torch.obs.trace import BufferTracer, canonical_events
    from repro_torch.sim import DeviceSimulator, SimConfig, Simulator

    # (a) FCFS, 8 traces as 8 environments.
    traces = [s1_trace(seed) for seed in range(1, 9)]
    res = traces[0][0]
    ro = DeviceSimulator(res, [j for _, j in traces], FCFSPolicy()).rollout()
    for i, (_, jobs) in enumerate(traces):
        rec = Recorder(FCFSPolicy())
        seq = Simulator(res, jobs, rec, SimConfig()).run()
        assert env_actions(ro, i) == rec.actions, f"FCFS env {i} actions"
        assert_results_close(seq, ro.results[i])
    log(f"[device parity] (a) FCFS, {len(traces)} environments: actions "
        f"and results match the sequential engine ({ro.stats.decisions} "
        f"decisions, {ro.stats.rounds_run} rounds)")

    # (b) the paper-width agent (kernel backend), one environment.
    res, jobs = traces[0]
    n_cmp, n_dec = agent_device_parity(agent, res, jobs,
                                       "(b) paper-width agent")

    # (c) the decoded event trace, FCFS on an integer-time trace.
    int_jobs = []
    for job in jobs:
        job = job.copy()
        job.submit = float(round(job.submit))
        job.runtime = float(max(1, round(job.runtime)))
        job.walltime = float(max(round(job.walltime), job.runtime))
        int_jobs.append(job)
    t_seq, t_dev = BufferTracer(), BufferTracer()
    Simulator(res, int_jobs, FCFSPolicy(), SimConfig(), tracer=t_seq).run()
    ds = DeviceSimulator(res, [int_jobs], FCFSPolicy())
    ds.emit_trace(ds.rollout(trace=True), t_dev)
    ev_seq = canonical_events(t_seq.events)
    assert len(ev_seq) > 0 and ev_seq == canonical_events(t_dev.events), \
        "device trace differs from the sequential engine's"
    log(f"[device parity] (c) emit_trace: {len(ev_seq)} canonical events "
        f"equal to the sequential engine's")
    return {"agent_compared": n_cmp, "agent_decisions": n_dec}


def agent_device_parity(agent, res, jobs, what: str, tag="device parity"):
    """The agent (kernel backend) over one trace on the sequential engine
    and on the device engine as one environment: equal actions up to the
    first decision whose top-2 margin on the plain backend is within the
    tolerance, and close results when the whole sequences are equal."""
    from repro_torch.core.dfp import action_values
    from repro_torch.sim import DeviceSimulator, SimConfig, Simulator
    rec = Recorder(agent)
    seq = Simulator(res, jobs, rec, SimConfig()).run()
    dev = DeviceSimulator(res, [jobs], agent)
    ro = dev.rollout(collect=True)
    dev_actions = env_actions(ro, 0)
    rows = torch.from_numpy(np.stack([row for _, _, row, _ in
                                      ro.transitions()])).to("cuda")
    sd, m = agent.enc.state_dim, agent.enc.n_resources
    dfp_torch = replace(agent.dfp, backend="torch")
    u = []
    for i in range(0, rows.shape[0], 64):
        chunk = rows[i:i + 64]
        u.append(action_values(agent.net, dfp_torch,
                               chunk[:, :sd].contiguous(),
                               chunk[:, sd:sd + m].contiguous(),
                               chunk[:, sd + m:sd + 2 * m].contiguous()))
    u = torch.where(rows[:, sd + 2 * m:] > 0.5, torch.cat(u),
                    -torch.inf).cpu().numpy()
    fin = np.isfinite(u)
    tol = 2e-4 * max(1.0, float(np.abs(u[fin]).max()))
    top2 = np.sort(u, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]              # inf with one valid slot
    ties = np.flatnonzero(margin <= tol)
    n_cmp = int(ties[0]) if len(ties) else len(dev_actions)
    assert n_cmp > 0 and dev_actions[:n_cmp] == rec.actions[:n_cmp], \
        "agent actions"
    full = dev_actions == rec.actions
    if full:
        assert_results_close(seq, ro.results[0])
    log(f"[{tag}] {what}, 1 environment: "
        f"{n_cmp} of {len(dev_actions)} decisions compared (first top-2 "
        f"margin <= tol {tol!r}: "
        f"{'none' if not len(ties) else int(ties[0])}); actions equal; "
        + ("whole sequences equal and results close" if full else
           "sequences part after a near-tie, results not compared"))
    return n_cmp, len(dev_actions)


def phase_device_main(agent, trace=None, per_forward=MLP_FORWARD,
                      tag="device", reps=3, collect=True) -> dict:
    """Greedy rollouts of the agent over 64 full-scale S1 traces
    (``trace(seed)`` for seeds 1-64, by default ``s1_trace``): the device
    engine's main path, one warm-up and the median of ``reps``; one more
    under the profiler (device activity only: with the host's operators
    too, the profile's summary alone took 215.6 s of the MLP agent's
    rollout); with ``collect``, an epsilon-greedy collection rollout."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim import DeviceSimulator

    trace = trace or s1_trace
    traces = [trace(seed) for seed in range(1, DEVICE_ENVS + 1)]
    res = traces[0][0]
    t0 = time.perf_counter()
    sim = DeviceSimulator(res, [j for _, j in traces], agent)
    pack_s = time.perf_counter() - t0
    lay = sim.layout
    sim.rollout()                                    # warm-up
    walls, launches = [], None
    for rep in range(reps):
        torch.cuda.synchronize()
        if rep == 0:
            reset_launch_counts()
        t0 = time.perf_counter()
        ro = sim.rollout()
        walls.append(time.perf_counter() - t0)
        if rep == 0:
            launches = launch_counts()
    st = ro.stats
    # window_pack counts the fused round front (pack_decision_rows); the
    # standalone pack is off the main path.
    per_round = {**per_forward, "window_pack": 1}
    assert st.rounds > 0 and launches == times(per_round, st.rounds), \
        (launches, st)
    assert standalone_packs() == 0, standalone_packs()
    results = ro.results
    for r in results:
        row = r.metrics.as_row()
        assert r.decisions > 0 and r.n_unstarted == 0, (r.decisions,
                                                        r.n_unstarted)
        assert all(math.isfinite(v) for v in row.values()), row
    wall = statistics.median(walls)
    out = {"envs": lay.n_envs, "jobs": lay.n_jobs, "units": lay.n_units,
           "rounds_run": st.rounds_run, "deciding_rounds": st.rounds,
           "decisions": st.decisions, "wall_s": wall, "walls_s": walls,
           "dps": st.decisions / wall, "rps": st.rounds_run / wall,
           "syncs_per_round": st.host_syncs / st.rounds_run,
           "launches": launches, "pack_s": pack_s}
    log(f"[{tag}] N={lay.n_envs} environments, J={lay.n_jobs} jobs, "
        f"U={lay.n_units} units, state_dim {lay.state_dim}; packed in "
        f"{pack_s:.3f} s; round budget {lay.rounds}")
    log(f"[{tag}] greedy rollout (median of {reps}, {', '.join(f'{w:.3f}' for w in walls)} s): "
        f"{st.rounds_run} rounds ({st.rounds} deciding), {st.decisions} "
        f"decisions in {wall:.3f} s = {out['dps']:.1f} decisions/s, "
        f"{out['rps']:.1f} rounds/s; host syncs {st.host_syncs} = "
        f"{out['syncs_per_round']:.3f} per round")
    per = ", ".join(f"{k} {v}" for k, v in per_round.items())
    log(f"[{tag}] launches in one rollout: {json.dumps(launches)} = ({per})"
        f" x {st.rounds} deciding rounds")
    log(f"[{tag}] env 0 ScheduleMetrics "
        f"{json.dumps(results[0].metrics.as_row())}")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.rollout()
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    out["device_busy_ms"] = busy_ms
    out["device_busy_share"] = busy_ms / (wall * 1e3)
    # Device operations (kernels, copies, fills) the host issued: what
    # each round costs the host to launch.
    issued = sum(e.count for e in events)
    out["device_ops_per_round"] = issued / sim.stats.rounds_run
    log(f"[{tag}] device kernels (torch.profiler, device activity, one "
        f"more rollout: {time.perf_counter() - t0:.1f} s with the profile's "
        f"summary) "
        f"{busy_ms:.3f} ms = busy share {out['device_busy_share']:.4f} of "
        f"the median rollout's wall time; {issued} device operations "
        f"issued = {out['device_ops_per_round']:.1f} per round")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")

    if not collect:
        return out, sim
    # Collection mode: epsilon-greedy with the decision rows kept.
    t0 = time.perf_counter()
    ro = sim.rollout(eps=0.1, seed=0, collect=True)
    collect_s = time.perf_counter() - t0
    assert all(r.n_unstarted == 0 for r in ro.results)
    width = lay.state_dim + 2 * lay.n_resources + lay.window
    n_rows = 0
    for t, i, row, a in ro.transitions():
        assert row.shape == (width,) and 0 <= a < lay.window
        n_rows += 1
    assert n_rows == ro.stats.decisions > 0, (n_rows, ro.stats)
    log(f"[{tag}] collection rollout (eps 0.1): every job of every "
        f"environment scheduled; {n_rows} transitions of width {width} in "
        f"{collect_s:.3f} s")
    return out, sim


def grad_bound_ms(kind: str, m: int, k: int, n: int) -> tuple:
    """(bytes, operations) times of one float32 dgrad or wgrad, in ms: g
    and y (M, N) and the third operand (W (K, N) or x (M, K)) read once,
    the results (dx (M, K), or dW (K, N) and db (N,)) written once; 2MKN
    flops (and the wgrad's MN for db) at each kernel's float32 route: the
    dgrad's 3xTF32 (three TF32 products a product at 495 TFLOP/s), the
    wgrad's FMAs on the CUDA cores (67 TFLOP/s)."""
    nbytes = 2 * m * n + k * n + m * k + (n if kind == "wgrad" else 0)
    flops = 2.0 * m * k * n + (m * n if kind == "wgrad" else 0)
    byte_s = 4.0 * nbytes / PEAK_BYTES_PER_S
    flop_s = (3 * flops / PEAK_TF32_FLOP_PER_S if kind == "dgrad"
              else flops / PEAK_F32_FLOP_PER_S)
    return byte_s * 1e3, flop_s * 1e3


def bwd_check(name: str, got, ref, dtype, what: str) -> float:
    """allclose at BWD_TOL, for one output or a tuple of them (the wgrad's
    dW and db); returns the largest absolute difference."""
    rtol, atol = BWD_TOL[dtype]
    worst = 0.0
    for a, b in zip(*((got, ref) if isinstance(got, tuple)
                      else ((got,), (ref,)))):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        bad = err > atol + rtol * b.abs()
        if bad.any():
            raise AssertionError(f"[backward parity] {name} {what}: "
                                 f"{int(bad.sum())} elements off, max abs "
                                 f"err {float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def layer_grad_cases(layers, ms, gen, worst: dict, where: str = "") -> int:
    """dgrad and wgrad against their plain versions on the card at each
    ``(K, N, _)`` of ``layers`` and each M of ``ms``, both dtypes, all
    activations; folds the largest absolute errors into ``worst`` and
    returns the number of cases."""
    from repro_torch.kernels.fused_mlp import (ACTIVATIONS, fused_mlp_dgrad,
                                               fused_mlp_dgrad_ref,
                                               fused_mlp_wgrad,
                                               fused_mlp_wgrad_ref)
    from repro_torch.kernels.fused_mlp.ref import apply_activation
    cases = 0
    for k, n, _ in layers:
        w32 = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        for m in ms:
            x32 = torch.randn(m, k, generator=gen, device="cuda")
            g32 = torch.randn(m, n, generator=gen, device="cuda")
            pre = torch.randn(m, n, generator=gen, device="cuda")
            for dtype in BWD_TOL:
                x, g, w = x32.to(dtype), g32.to(dtype), w32.to(dtype)
                for act in ACTIVATIONS:
                    y = apply_activation(pre, act, 0.2).to(dtype)
                    what = f"{where}K={k} N={n} M={m} {dtype} {act}"
                    dx = fused_mlp_dgrad(g, y, w, activation=act)
                    dw_db = fused_mlp_wgrad(x, g, y, activation=act)
                    errs = (bwd_check("dgrad", dx,
                                      fused_mlp_dgrad_ref(g, y, w, act),
                                      dtype, what),
                            bwd_check("wgrad", dw_db,
                                      fused_mlp_wgrad_ref(x, g, y, act),
                                      dtype, what))
                    for kind, err in zip(("dgrad", "wgrad"), errs):
                        worst[kind, dtype] = max(worst[kind, dtype], err)
                    cases += 1
    return cases


def phase_backward_parity(agent) -> dict:
    """dgrad and wgrad against their plain versions on the card at the 13
    DFP layer shapes; returns the worst absolute error per kernel and
    dtype."""
    from repro_torch.kernels.fused_mlp import (ACTIVATIONS, fused_mlp_dgrad,
                                               fused_mlp_dgrad_ref,
                                               fused_mlp_wgrad,
                                               fused_mlp_wgrad_ref)
    from repro_torch.kernels.fused_mlp.ref import apply_activation
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {(k, d): 0.0 for k in ("dgrad", "wgrad") for d in BWD_TOL}
    cases = layer_grad_cases(forward_layers(agent.net), BWD_PARITY_M, gen,
                             worst)
    # The attention encoder's layers, whose wgrad splits M across blocks;
    # two wgrad launches on the same inputs must give the same bits.
    encoder = 0
    for k, n in ENCODER_WGRAD:
        w32 = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        for m in ENCODER_M:
            x32 = torch.randn(m, k, generator=gen, device="cuda")
            g32 = torch.randn(m, n, generator=gen, device="cuda")
            pre = torch.randn(m, n, generator=gen, device="cuda")
            for dtype in BWD_TOL:
                x, g, w = x32.to(dtype), g32.to(dtype), w32.to(dtype)
                for act in ACTIVATIONS:
                    y = apply_activation(pre, act, 0.2).to(dtype)
                    what = f"encoder K={k} N={n} M={m} {dtype} {act}"
                    dw_db = fused_mlp_wgrad(x, g, y, activation=act)
                    again = fused_mlp_wgrad(x, g, y, activation=act)
                    if not all(torch.equal(a, b)
                               for a, b in zip(dw_db, again)):
                        raise AssertionError(f"[backward parity] wgrad "
                                             f"{what}: two launches differ")
                    dx = fused_mlp_dgrad(g, y, w, activation=act)
                    if not torch.equal(dx, fused_mlp_dgrad(g, y, w,
                                                           activation=act)):
                        raise AssertionError(f"[backward parity] dgrad "
                                             f"{what}: two launches differ")
                    errs = (bwd_check("dgrad", dx,
                                      fused_mlp_dgrad_ref(g, y, w, act),
                                      dtype, what),
                            bwd_check("wgrad", dw_db,
                                      fused_mlp_wgrad_ref(x, g, y, act),
                                      dtype, what))
                    for kind, err in zip(("dgrad", "wgrad"), errs):
                        worst[kind, dtype] = max(worst[kind, dtype], err)
                    cases += 1
                    encoder += 1
    torch.cuda.synchronize()
    log(f"[backward parity] {cases} cases (13 layers x M {BWD_PARITY_M} x "
        f"2 dtypes x 4 activations, and {encoder} at the encoder's (K, N) "
        f"{ENCODER_WGRAD} x M {ENCODER_M}, each dgrad and wgrad launched "
        f"twice with bit-equal results) pass for dgrad and wgrad; worst abs "
        f"err "
        f"float32 dgrad {worst['dgrad', torch.float32]!r}, wgrad "
        f"{worst['wgrad', torch.float32]!r} (rtol 1e-3, atol 1e-4); "
        f"bfloat16 dgrad {worst['dgrad', torch.bfloat16]!r}, wgrad "
        f"{worst['wgrad', torch.bfloat16]!r} (2e-2)")
    return {kind: worst[kind, torch.float32] for kind in ("dgrad", "wgrad")}


def _counted() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.flash_attention import (flash_attention, mha,
                                                     mha_bwd_dkv, mha_bwd_dq)
    from repro_torch.kernels.fused_mlp import (fused_mlp, fused_mlp_dgrad,
                                               fused_mlp_wgrad)
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.window_pack import pack_decision_rows
    return dict(zip(KERNELS, (fused_mlp, fused_mlp_dgrad, fused_mlp_wgrad,
                              pack_decision_rows, mha, mha_bwd_dq,
                              mha_bwd_dkv, flash_attention, ssd)))


def launch_counts() -> dict:
    return {k: w.launches for k, w in _counted().items()}


def standalone_packs() -> int:
    """Launches of the standalone window pack (``pack_window``)."""
    from repro_torch.kernels.window_pack import pack_window
    return pack_window.launches


def flash_kernel_launches() -> dict:
    """B7's launches by kernel: ``flash_fwd`` (float32) and
    ``flash_fwd_sm90`` (bfloat16)."""
    from repro_torch.kernels.flash_attention import flash_attention
    return dict(flash_attention.kernel_launches)


def ssd_kernel_launches() -> dict:
    """B8's launches by kernel: each of its three passes."""
    from repro_torch.kernels.ssd import ssd
    return dict(ssd.kernel_launches)


def reset_launch_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.window_pack import pack_window
    for w in (*_counted().values(), pack_window):
        w.launches = 0
    flash_attention.kernel_launches = dict.fromkeys(
        flash_attention.kernel_launches, 0)
    ssd.kernel_launches.update(dict.fromkeys(ssd.kernel_launches, 0))


def times(per: dict, n: int) -> dict:
    """Expected launch counts of every kernel for ``n`` units of work that
    launch ``per`` each (kernels not named launch none)."""
    return {k: per.get(k, 0) * n for k in KERNELS}


def time_bursts(agent) -> list:
    """Wrap ``agent.train_steps`` (until ``del agent.train_steps``) so
    every burst's steps, wall time, loss, gradient norm and launches are
    kept in the returned list."""
    bursts = []
    train_steps = agent.train_steps

    def timed_burst(steps: int):
        c0 = launch_counts()
        t0 = time.perf_counter()
        loss = train_steps(steps)          # ends in the burst's host read
        c1 = launch_counts()
        bursts.append({"steps": steps, "wall_s": time.perf_counter() - t0,
                       "loss": loss, "grad_norm": agent.last_grad_norm,
                       "launches": {k: c1[k] - c0[k] for k in c1}})
        return loss

    agent.train_steps = timed_burst
    return bursts


def phase_training(config=None, trace=None, per_step=MLP_STEP,
                   per_forward=MLP_FORWARD, tag="train") -> tuple:
    """Sequential DFP training at full width: the training path, by default
    of the paper-width MLP agent on ``s1_trace``.  Returns the path's
    launch counts, the trained agent and its collection decisions/s."""
    from repro_torch.convert import leaves
    from repro_torch.core import AgentConfig, MRSchAgent, train_agent
    trace = trace or s1_trace
    traces = [trace(seed) for seed in TRAIN_SEEDS]
    res = traces[0][0]
    agent = MRSchAgent(res, config or AgentConfig(seed=0))
    cfg = agent.config
    assert (cfg.batch_size, cfg.grad_steps_per_episode, cfg.lr,
            cfg.grad_clip) == (64, 64, 1e-4, 10.0), cfg
    before = [p.detach().clone() for _, p in leaves(agent.net)]
    bursts = time_bursts(agent)
    torch.cuda.synchronize()
    reset_launch_counts()
    log_ = train_agent(agent, res, [j for _, j in traces])
    torch.cuda.synchronize()
    launches = launch_counts()
    del agent.train_steps

    steps = sum(b["steps"] for b in bursts)
    assert len(bursts) == len(traces) and steps == int(agent.opt_state.step)
    for b in bursts:
        assert b["launches"] == times(per_step, b["steps"]), b
        assert math.isfinite(b["loss"]) and math.isfinite(b["grad_norm"]), b
    # The rest are the greedy decisions' forwards.
    greedy = launches["forward"] - per_step["forward"] * steps
    n_greedy = greedy // per_forward["forward"]
    assert greedy >= 0 and launches == {
        k: times(per_step, steps)[k] + times(per_forward, n_greedy)[k]
        for k in KERNELS}, launches
    assert log_.episode_losses == [b["loss"] for b in bursts]
    moved = [not torch.equal(a, p) for a, (_, p) in zip(before,
                                                        leaves(agent.net))]
    assert all(moved), f"{moved.count(False)} parameters did not move"
    del before
    collect_s = log_.wall_seconds - sum(b["wall_s"] for b in bursts)
    log(f"[{tag}] train_agent over {len(traces)} full-scale S1 traces (seeds "
        f"{TRAIN_SEEDS}): {log_.decisions} decisions, {steps} train steps in "
        f"{len(bursts)} bursts, {log_.wall_seconds:.3f} s; epsilon now "
        f"{agent.epsilon!r}")
    per = ", ".join(f"{k} {v}" for k, v in per_step.items())
    log(f"[{tag}] launches: {json.dumps(launches)} = ({per}) x {steps} "
        f"steps + {n_greedy} greedy forwards; every burst exactly ({per}) "
        f"per step")
    for i, b in enumerate(bursts):
        log(f"[{tag}] burst {i}: {b['steps']} steps in {b['wall_s']:.4f} s "
            f"({b['wall_s'] / b['steps'] * 1e3:.4f} ms per step, sampling "
            f"and copy included); loss {b['loss']!r}, grad norm "
            f"{b['grad_norm']!r}")
    log(f"[{tag}] collection: {log_.decisions} decisions in {collect_s:.3f} "
        f"s = {log_.decisions / collect_s:.1f} decisions/s; all "
        f"{len(moved)} parameters moved")
    return launches, agent, log_.decisions / collect_s


def batch_tensors(agent, rng) -> dict:
    """One replay minibatch on the card, as ``train_steps`` makes it."""
    sample = agent.replay.sample(rng, agent.config.batch_size)
    return {k: torch.from_numpy(v).to(agent.device) for k, v in sample.items()}


def check_step_parity(agent, per_step: dict, tag: str) -> None:
    """One train step's loss and gradients on the kernel and the plain
    backend, from the same weights and a replay minibatch: the kernel
    step launches ``per_step``; the loss within rtol 1e-4 and every
    gradient leaf within rtol 1e-3, atol 1e-4."""
    from repro_torch.convert import leaves
    from repro_torch.core.dfp import loss_fn
    batch = batch_tensors(agent, np.random.default_rng(11))
    params = [p for _, p in leaves(agent.net)]
    dfp_torch = replace(agent.dfp, backend="torch")
    reset_launch_counts()
    loss_k = loss_fn(agent.net, agent.dfp, batch)
    grads_k = torch.autograd.grad(loss_k, params)
    torch.cuda.synchronize()
    assert launch_counts() == times(per_step, 1), launch_counts()
    loss_t = loss_fn(agent.net, dfp_torch, batch)
    grads_t = torch.autograd.grad(loss_t, params)
    torch.testing.assert_close(loss_k, loss_t, rtol=1e-4, atol=0.0)
    grad_err = 0.0
    for (name, _), gk, gt in zip(leaves(agent.net), grads_k, grads_t):
        torch.testing.assert_close(gk, gt, rtol=1e-3, atol=1e-4, msg=name)
        grad_err = max(grad_err, float((gk - gt).abs().max()))
    log(f"[{tag}] one step, kernel vs torch backend: loss "
        f"{loss_k.item()!r} vs {loss_t.item()!r}; {len(params)} gradient "
        f"leaves within rtol 1e-3, atol 1e-4 (max abs diff {grad_err!r})")


def phase_training_parity(agent, trace=None, per_step=MLP_STEP,
                          tag="train parity") -> None:
    """One train step's loss and gradients on the kernel and the plain
    backend (``check_step_parity``); then a greedy ``evaluate`` of the
    trained agent on both backends, on the trace of the next seed
    (``trace``, by default ``s1_trace``)."""
    from repro_torch.core import evaluate
    from repro_torch.core.dfp import action_values
    from repro_torch.core.encoding import (decision_row_dim,
                                           encode_decision_row)
    check_step_parity(agent, per_step, tag)
    dfp_torch = replace(agent.dfp, backend="torch")
    res, jobs = (trace or s1_trace)(TRAIN_SEEDS[-1] + 1)
    w = agent.config.window
    runs = {}
    for backend in ("kernel", "torch"):
        agent.set_backend(backend)
        rows, actions = [], []
        select = agent.select

        def recording(ctx):
            row = np.zeros(decision_row_dim(agent.enc, w), np.float32)
            encode_decision_row(agent.enc, ctx, w, out=row)
            rows.append(row)
            actions.append(select(ctx))
            return actions[-1]

        agent.select = recording
        result = evaluate(agent, res, jobs, window=w)
        del agent.select
        runs[backend] = (result, rows, actions)
    agent.set_backend("kernel")
    rows = torch.from_numpy(np.stack(runs["torch"][1])).to("cuda")
    sd, m = agent.enc.state_dim, agent.enc.n_resources
    u = torch.cat([action_values(agent.net, dfp_torch,
                                 c[:, :sd].contiguous(),
                                 c[:, sd:sd + m].contiguous(),
                                 c[:, sd + m:sd + 2 * m].contiguous())
                   for c in rows.split(64)])
    u = torch.where(rows[:, sd + 2 * m:] > 0.5, u, -torch.inf).cpu().numpy()
    fin = np.isfinite(u)
    tol = 2e-4 * max(1.0, float(np.abs(u[fin]).max()))
    top2 = np.sort(u, axis=1)[:, -2:]
    ties = np.flatnonzero(top2[:, 1] - top2[:, 0] <= tol)
    a_k, a_t = runs["kernel"][2], runs["torch"][2]
    n_cmp = int(ties[0]) if len(ties) else len(a_t)
    assert a_k[:n_cmp] == a_t[:n_cmp], "greedy actions differ"
    full = a_k == a_t
    r_k, r_t = runs["kernel"][0], runs["torch"][0]
    assert r_k.n_unstarted == r_t.n_unstarted == 0
    if full:
        assert r_k.metrics.as_row() == r_t.metrics.as_row()
    log(f"[{tag}] evaluate (greedy, seed {TRAIN_SEEDS[-1] + 1}): "
        f"{n_cmp} of {len(a_t)} decisions compared (first top-2 margin <= tol "
        f"{tol!r}: {'none' if not len(ties) else int(ties[0])}); actions "
        f"equal; " + ("whole sequences and metrics equal" if full else
                      "sequences part after a near-tie"))
    log(f"[{tag}] kernel-backend ScheduleMetrics "
        f"{json.dumps(r_k.metrics.as_row())}")


BURST_GROUPS = (("forward (B1)", ("fused_mlp_fwd_kernel",
                                  "fused_mlp_fwd_m64_kernel",
                                  "splitk_epilogue_kernel")),
                ("dgrad (B2)", ("dgrad_kernel",)),
                ("wgrad (B3)", ("wgrad_",)),
                ("attention (B5)", ("mha_fwd_kernel",)),
                ("attention dq, dkv (B6)", ("mha_bwd_dq_kernel",
                                            "mha_bwd_dkv_kernel")),
                ("gradient norm", ("norm",)),
                ("Adam", ("multi_tensor_apply",)),
                ("host-to-device copy", ("memcpy htod",)))


def phase_training_timing(agent, tag="train timing") -> None:
    """Where a train step's time goes, on the trained agent: waited-for
    single steps on each backend, a burst's wall time and host sampling,
    and one profiled burst (device time by kernel group, host time by
    operator)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # A waited-for step (one minibatch sampled, copied, trained on) on each
    # backend, in turns kernel, torch, torch, kernel after one warm-up.
    agent.train_steps(1)
    per = {"kernel": [], "torch": []}
    for backend in ("kernel", "torch", "torch", "kernel"):
        agent.set_backend(backend)
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            agent.train_steps(1)               # ends in its host read
            per[backend].append((time.perf_counter() - t0) * 1e3)
    agent.set_backend("kernel")
    log(f"[{tag}] a waited-for train step (train_steps(1)), median of "
        f"20 in turns: kernel backend {statistics.median(per['kernel']):.4f} "
        f"ms, torch backend {statistics.median(per['torch']):.4f} ms wall")
    k = agent.config.grad_steps_per_episode
    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    for _ in range(k):
        agent.replay.sample(rng, agent.config.batch_size)
    sample_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.train_steps(k)
    burst_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        agent.train_steps(k)
    events = device_events(prof)
    device_ms_ = sum(e.self_device_time_total for e in events) / 1e3
    assert device_ms_ > 0, "the profiled burst shows no device time"
    groups = {name: 0.0 for name, _ in BURST_GROUPS}
    groups["other"] = 0.0
    for e in events:
        key = e.key.lower()
        name = next((g for g, keys in BURST_GROUPS
                     if any(s in key for s in keys)), "other")
        groups[name] += e.self_device_time_total / 1e3
    log(f"[{tag}] a burst of {k} steps: {burst_ms:.3f} ms wall "
        f"({burst_ms / k:.4f} ms per step), of which sampling {k} minibatches "
        f"on the host {sample_ms:.3f} ms; device {device_ms_:.3f} ms "
        f"(profiled burst) = {device_ms_ / k:.4f} ms per step, busy share "
        f"{device_ms_ / burst_ms:.4f}")
    for name, ms in groups.items():
        log(f"[{tag}]   {name:24s} {ms:9.3f} ms per burst = "
            f"{ms / k:.4f} ms per step ({ms / device_ms_:.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:5d}  {e.key[:90]}")
    # Host side of the same burst: the operators with the most own host
    # time (inflated by the profiler; read as shares).
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and not e.is_user_annotation]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"[{tag}]   host {e.self_cpu_time_total / 1e3:9.3f} ms "
            f"({e.self_cpu_time_total / 1e3 / host_ms:.3f}) x{e.count:5d}  "
            f"{e.key[:80]}")


def phase_backward_main_path(agent, per_step=MLP_STEP, tag="") -> dict:
    """dgrad and wgrad on the operands the training path gives them: one
    more train step's backward records each call's operands; each is held
    against its plain version, then timed beside its bound, its plain
    version and ``torch.mm`` on the act'-scaled gradient.  The launches
    made here are not counted: the path's count was read before.  ``tag``
    prefixes the log lines of another path than the MLP agent's."""
    from repro_torch.convert import leaves
    from repro_torch.core.dfp import loss_fn
    from repro_torch.kernels.fused_mlp import kernel as fm
    calls = {"dgrad": [], "wgrad": []}
    launch_dgrad, launch_wgrad = fm.fused_mlp_dgrad, fm.fused_mlp_wgrad

    def rec_dgrad(g, y, w, activation, slope):
        calls["dgrad"].append((g.clone(), y, w, activation))
        return launch_dgrad(g, y, w, activation, slope)

    def rec_wgrad(x, g, y, activation, slope):
        calls["wgrad"].append((x, g.clone(), y, activation))
        return launch_wgrad(x, g, y, activation, slope)

    params = [p for _, p in leaves(agent.net)]
    fm.fused_mlp_dgrad, fm.fused_mlp_wgrad = rec_dgrad, rec_wgrad
    try:
        batch = batch_tensors(agent, np.random.default_rng(13))
        torch.autograd.grad(loss_fn(agent.net, agent.dfp, batch), params)
    finally:
        fm.fused_mlp_dgrad, fm.fused_mlp_wgrad = launch_dgrad, launch_wgrad
    assert {k: len(v) for k, v in calls.items()} == {
        k: per_step[k] for k in calls}, {k: len(v) for k, v in calls.items()}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    sms = fm._sm_count(0)
    out = {}
    with torch.no_grad():            # y is a saved output that needs grad
        for kind in ("dgrad", "wgrad"):
            rows, err = [], 0.0
            for call in calls[kind]:
                run, ref, lib, (m, k, n), act = grad_closures(kind, *call)
                got = run()
                what = f"main path K={k} N={n} M={m} {act}"
                err = max(err, bwd_check(kind, got, ref(), torch.float32,
                                         what))
                again = run()
                if not all(torch.equal(a, b) for a, b in zip(
                        *((got, again) if kind == "wgrad"
                          else ((got,), (again,))))):
                    raise AssertionError(f"[{tag}{kind} main path] {what}: "
                                         f"two launches differ")
                t_k, t_p, t_l = (device_ms(f, flush) for f in (run, ref, lib))
                b_ms, o_ms = grad_bound_ms(kind, m, k, n)
                rows.append((t_k, t_p, t_l, b_ms, o_ms))
                if kind == "dgrad":
                    tm, tk, splits, _ = fm.dgrad_plan(m, k, n, sms)
                    plan = (f"tile {tm}x{tk}, {splits} splits, cluster "
                            f"{splits}")
                else:
                    plan = (f"tile {fm.wgrad_tile(m, k, n, sms)}, "
                            f"{fm.wgrad_split_plan(m, k, n, sms)[0]} splits")
                log(f"[{tag}{kind} main path] K={k:5d} N={n:4d} M={m} {act:10s}: "
                    f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  torch.mm "
                    f"{t_l:.4f} ms  bound {max(b_ms, o_ms):.4f} ms "
                    f"({'bytes' if b_ms >= o_ms else 'operations'}); {plan}; "
                    f"two launches bit-equal")
            t_k, t_p, t_l, b_ms, o_ms = (sum(r[i] for r in rows)
                                         for i in range(5))
            by = "bytes" if b_ms >= o_ms else "operations"
            out[kind] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_l, "bound_ms": max(b_ms, o_ms),
                         "bound_by": by, "layers": len(rows)}
            log(f"[{tag}{kind} main path] {len(rows)} layers of one train step, "
                f"summed: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  torch.mm "
                f"{t_l:.4f} ms  bound {max(b_ms, o_ms):.4f} ms ({by}); max "
                f"abs err {err!r} against the plain version")
    return out


def grad_closures(kind: str, a, b, c, act: str) -> tuple:
    """For one recorded dgrad (g, y, w) or wgrad (x, g, y) call: the kernel,
    its plain version and ``torch.mm`` on the act'-scaled gradient (made
    beforehand, untimed, as is the wgrad's column of ones), as closures;
    (M, K, N); the activation."""
    from repro_torch.kernels.fused_mlp import (fused_mlp_dgrad,
                                               fused_mlp_dgrad_ref,
                                               fused_mlp_wgrad,
                                               fused_mlp_wgrad_ref)
    from repro_torch.kernels.fused_mlp.ref import scaled_grad_ref
    if kind == "dgrad":
        g, y, w = a, b, c
        gm = scaled_grad_ref(g, y, act, 0.2)
        return (lambda: fused_mlp_dgrad(g, y, w, activation=act),
                lambda: fused_mlp_dgrad_ref(g, y, w, act),
                lambda: torch.mm(gm, w.t()),
                (g.shape[0], w.shape[0], g.shape[1]), act)
    x, g, y = a, b, c
    gm = scaled_grad_ref(g, y, act, 0.2)
    # [x | 1]^T @ gm gives dW and, as its last row, db: one library call
    # for the wgrad's two results.
    x1 = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    return (lambda: fused_mlp_wgrad(x, g, y, activation=act),
            lambda: fused_mlp_wgrad_ref(x, g, y, act),
            lambda: torch.mm(x1.t(), gm),
            (x.shape[0], x.shape[1], g.shape[1]), act)


def mha_bound_ms(kind: str, lengths: torch.Tensor, sq: int, sk: int,
                 dh: int, dense: bool = False) -> tuple:
    """(bytes, operations) times, in ms, of one call of ``mha_fwd`` or of a
    B6 kernel over the keys each row's length keeps (every key with
    ``dense``): q (and do, lse and delta for the backward) read once, k
    and v read for the kept keys only, the outputs written once (o and
    lse; dq; dk and dv in full); two flops per FMA over the float32 rate,
    with 2 FMAs of dh per (query, kept key) for the forward (q.k, p v),
    3 for dq and 4 for dkv.  The exp per pair is not counted."""
    bh = lengths.numel()
    nk = (bh * sk if dense
          else int(torch.ceil(lengths.clamp(0, sk)).sum()))
    rows = bh * sq
    kv = 2 * nk * dh + bh
    if kind == "mha_fwd":
        nbytes, fmas = rows * dh + kv + rows * dh + rows, 2 * sq * nk * dh
    elif kind == "mha_bwd_dq":
        nbytes = 2 * rows * dh + 2 * rows + kv + rows * dh
        fmas = 3 * sq * nk * dh
    else:
        nbytes = 2 * rows * dh + 2 * rows + kv + 2 * bh * sk * dh
        fmas = 4 * sq * nk * dh
    return (4.0 * nbytes / PEAK_BYTES_PER_S * 1e3,
            2.0 * fmas / PEAK_F32_FLOP_PER_S * 1e3)


def mha_closures(kind: str, args: tuple) -> tuple:
    """For one recorded call of a masked-attention kernel: the kernel, its
    plain version (for B6 the whole ``mha_bwd_ref``, which computes dq, dk
    and dv together) and ``scaled_dot_product_attention`` with the same key
    mask (for B6 its autograd backward, one call for dq, dk and dv, on a
    graph built beforehand), as closures; and the largest absolute
    difference of the kernel from its plain version."""
    from repro_torch.kernels.flash_attention import (mha_bwd_dkv, mha_bwd_dq,
                                                     mha_bwd_ref, mha_fwd,
                                                     mha_fwd_ref)
    q, k, v = args[:3]
    lengths = args[-1]
    mask = (torch.arange(k.shape[1], device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]     # (BH, 1, 1, Sk)
    if kind == "mha_fwd":
        run = lambda: mha_fwd(*args)
        ref = lambda: mha_fwd_ref(*args)
        lib = lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], attn_mask=mask)
        got, want = run(), ref()
    else:
        do = args[3]
        run = (lambda: mha_bwd_dq(*args)) if kind == "mha_bwd_dq" else \
            (lambda: mha_bwd_dkv(*args))
        ref = lambda: mha_bwd_ref(*args)
        leaves_ = [t.detach()[:, None].clone().requires_grad_()
                   for t in (q, k, v)]
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves_, attn_mask=mask)
        lib = lambda: torch.autograd.grad(out, leaves_, do[:, None],
                                          retain_graph=True)
        got = run()
        got = (got,) if kind == "mha_bwd_dq" else got
        want = ref()[:1] if kind == "mha_bwd_dq" else ref()[1:]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return run, ref, lib, err


def phase_attention_main_path(agent, sim) -> dict:
    """The attention kernels (and window_pack at K = Q) on the operands the
    attention paths give them.  (1) One more greedy device rollout: every
    ``mha_fwd`` call is held against its plain version as it is made, and
    every 16th call's operands are kept; the kept call with the median
    total length is timed, and so are its first 4 batch-heads (one batch
    row: the service's BH = 4); ``phase_window_pack_main_path`` records
    and checks the same rollout's window packs.  (2) One train step: its
    two ``mha_fwd``, two ``mha_bwd_dq`` and two ``mha_bwd_dkv`` calls are
    recorded, each held against its
    plain version and timed (L2 flushed) beside its bound, its plain
    version and ``scaled_dot_product_attention``; the step's sums are the
    kernels line's.  The launches made here are not counted: the paths'
    counts were read before.  Returns the three kernels' figures and
    window_pack's."""
    from repro_torch.convert import leaves
    from repro_torch.core.dfp import loss_fn
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import mha_fwd_ref
    attr = {"mha_fwd": "mha_forward", "mha_bwd_dq": "mha_backward_dq",
            "mha_bwd_dkv": "mha_backward_dkv"}      # launches in kernel.py
    launch = {kind: getattr(fa, name) for kind, name in attr.items()}
    kept, err_t, n_calls = [], torch.zeros((), device="cuda"), 0

    def rollout_fwd(q, k, v, lengths):
        nonlocal err_t, n_calls
        o, lse = launch["mha_fwd"](q, k, v, lengths)
        ro, rlse = mha_fwd_ref(q, k, v, lengths)
        err_t = torch.maximum(err_t, torch.maximum((o - ro).abs().max(),
                                                   (lse - rlse).abs().max()))
        if n_calls % 16 == 0:
            kept.append((q, k, v, lengths))
        n_calls += 1
        return o, lse

    fa.mha_forward = rollout_fwd
    try:                 # the same rollout records window_pack's inputs
        wp_out = phase_window_pack_main_path(sim,
                                             "window_pack attention path")
    finally:
        fa.mha_forward = launch["mha_fwd"]
    rollout_err = float(err_t)
    assert n_calls == 2 * sim.stats.rounds > 0, (n_calls, sim.stats)
    assert rollout_err <= MHA_TOL["mha_fwd"], rollout_err

    calls = {kind: [] for kind in launch}

    def recorder(kind):
        def rec(*args):                 # a backward's do (args[3]) is cloned
            calls[kind].append(args if kind == "mha_fwd" else
                               (*args[:3], args[3].clone(), *args[4:]))
            return launch[kind](*args)
        return rec

    for kind, name in attr.items():
        setattr(fa, name, recorder(kind))
    try:
        params = [p for _, p in leaves(agent.net)]
        batch = batch_tensors(agent, np.random.default_rng(14))
        torch.autograd.grad(loss_fn(agent.net, agent.dfp, batch), params)
    finally:
        for kind, name in attr.items():
            setattr(fa, name, launch[kind])
    assert all(len(c) == 2 for c in calls.values()), \
        {k: len(c) for k, c in calls.items()}

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    log(f"[attn kernels] bounds from {PEAKS}; card: "
        f"{gpu_name_and_power_limit()}")
    one = torch.empty(1, device="cuda")
    log(f"[attn kernels] timing floor: a 1-element fill_ takes "
        f"{device_ms(lambda: one.fill_(1.0), flush):.4f} ms the same way "
        f"(launch and events; every kernel time below includes it)")

    def measure(kind, args, what):
        run, ref, lib, err = mha_closures(kind, args)
        if not err <= MHA_TOL[kind]:
            raise AssertionError(f"[attn kernels] {kind} {what}: max abs "
                                 f"err {err} > {MHA_TOL[kind]}")
        t_k, t_p, t_l = (device_ms(f, flush) for f in (run, ref, lib))
        bh, sq, dh = args[0].shape
        sk = args[1].shape[1]
        b_ms, o_ms = mha_bound_ms(kind, args[-1], sq, sk, dh)
        db_ms, do_ms = mha_bound_ms(kind, args[-1], sq, sk, dh, dense=True)
        log(f"[attn kernels] {kind:11s} {what}: BH={bh} S={sq} dh={dh}, "
            f"mean length {float(args[-1].mean()):.2f}: kernel {t_k:.4f} ms  "
            f"plain {t_p:.4f} ms  sdpa {t_l:.4f} ms  bound "
            f"{max(b_ms, o_ms):.6f} ms "
            f"({'bytes' if b_ms >= o_ms else 'operations'}), dense "
            f"{max(db_ms, do_ms):.6f} ms; max abs err {err!r}")
        return t_k, t_p, t_l, b_ms, o_ms, err

    total = [float(a[-1].sum()) for a in kept]
    med = kept[int(np.argsort(total)[len(kept) // 2])]
    measure("mha_fwd", med, f"device rollout (median of {len(kept)} kept "
            f"of {n_calls} calls, all {n_calls} within {rollout_err!r})")
    measure("mha_fwd", tuple(t[:4].contiguous() for t in med),
            "service shape (batch 1: the first 4 batch-heads of that call)")
    out = {}
    with torch.no_grad():
        for kind in launch:
            rows = [measure(kind, args, f"train step call {i}")
                    for i, args in enumerate(calls[kind])]
            t_k, t_p, t_l, b_ms, o_ms = (sum(r[i] for r in rows)
                                         for i in range(5))
            err = max(r[5] for r in rows)
            if kind == "mha_fwd":
                err = max(err, rollout_err)
            by = "bytes" if b_ms >= o_ms else "operations"
            out[kind] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_l, "bound_ms": max(b_ms, o_ms),
                         "bound_by": by}
            log(f"[attn kernels] {kind}: the train step's {len(rows)} calls "
                f"summed: kernel {t_k:.4f} ms  plain {t_p:.4f} ms  sdpa "
                f"{t_l:.4f} ms  bound {max(b_ms, o_ms):.6f} ms ({by})")
    return out, wp_out


# ------------------------------------------------------- LM zoo: B7 and B8
# --------------------------------------------- the lockstep (vector) engine
VECTOR_SEEDS = tuple(range(1, 9))      # the eight S1 lanes of phases 17-18
VECTOR_MIX = dict(scenarios=("S1", "S2", "S3", "S4"), seeds=(1, 2), n_envs=8,
                  resource_scales=(1.0, 0.75, 0.5))
ATTN_VECTOR_SEEDS = (1, 2, 3, 4)       # phase 20's lanes (attn_trace)
# Phase 20's agent starts mid-curriculum: at the paper's eps_start of 1.0
# almost every row explores, and no round would run a batched forward.
ATTN_VECTOR_EPSILON = 0.5


def same_results(a, b) -> bool:
    """The metrics row, decisions, unstarted jobs and every job's start
    and end."""
    return (a.metrics.as_row() == b.metrics.as_row()
            and a.decisions == b.decisions
            and a.n_unstarted == b.n_unstarted
            and [(j.jid, j.start, j.end) for j in a.jobs]
            == [(j.jid, j.start, j.end) for j in b.jobs])


def packed_values(agent, rows: torch.Tensor) -> torch.Tensor:
    """Action values of packed decision rows on the agent's backend, the
    invalid slots at -inf."""
    from repro_torch.core.dfp import action_values
    sd, m = agent.enc.state_dim, agent.enc.n_resources
    u = action_values(agent.net, agent.dfp, rows[:, :sd].contiguous(),
                      rows[:, sd:sd + m].contiguous(),
                      rows[:, sd + m:sd + 2 * m].contiguous())
    return torch.where(rows[:, sd + 2 * m:] > 0.5, u, -torch.inf)


def check_batched_rows(agent, rounds: list) -> tuple:
    """Each batched row (``rounds``: the rows of every batched forward, as
    ``_greedy_rows`` received them) at its round's width against the M = 1
    forward the sequential engine runs: bit for bit, and no top-2 margin
    within their difference.  Returns the rows compared, every row's
    top-2 margin and the largest finite value."""
    from repro_torch.core.encoding import pad_decision_rows
    worst, diffs, margins, n_rows = 0.0, [], [], 0
    with torch.no_grad():
        for rows in rounds:
            n = len(rows)
            width = 1 << max(n - 1, 0).bit_length()
            packed = torch.from_numpy(
                pad_decision_rows(rows, width, agent.enc)).to(agent.device)
            u_b = packed_values(agent, packed)[:n]
            u_1 = torch.cat([packed_values(agent, packed[i:i + 1])
                             for i in range(n)])
            fin = torch.isfinite(u_b)
            assert torch.equal(fin, torch.isfinite(u_1))
            d = torch.where(fin, (u_b - u_1).abs(), 0.0).amax(1)
            top2 = torch.topk(u_b, 2, dim=1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu())
            diffs.append(d.cpu())
            worst = max(worst, float(u_b[fin].abs().max()))
            n_rows += n
    margins, diffs = torch.cat(margins).numpy(), torch.cat(diffs).numpy()
    flips = np.flatnonzero(margins <= diffs)
    assert not len(flips), (f"near-tie: {len(flips)} batched rows whose "
                            f"top-2 margin is within their M = 1 difference, "
                            f"first {int(flips[0])}")
    assert not diffs.any(), (
        f"batched rows differ from the M = 1 forward: max {diffs.max()!r} "
        f"over {int((diffs > 0).sum())} rows")
    return n_rows, margins, worst


def phase_vector_replay(agent) -> tuple:
    """Greedy lockstep replay: the eight S1 traces of seeds 1-8 as eight
    lanes of the engine ``run_traces`` builds, against the sequential
    ``run_trace`` of each; then every batched row's values at its round's
    width against the M = 1 forward the sequential engine runs, under a
    top-2-margin guard.  Returns the launches, the vector results and
    both engines' decisions/s."""
    from repro_torch.sim import SimConfig, VectorSimulator, run_trace
    traces = [s1_trace(seed) for seed in VECTOR_SEEDS]
    res, jobsets = traces[0][0], [j for _, j in traces]
    rounds: list = []
    greedy_rows = agent._greedy_rows

    def recording(rows):
        rounds.append(rows.copy())
        return greedy_rows(rows)

    agent._greedy_rows = recording
    vec = VectorSimulator.from_jobsets(res, jobsets, agent,
                                       SimConfig.for_engine("vector"))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = vec.run()
    wall_v = time.perf_counter() - t0
    del agent._greedy_rows
    torch.cuda.synchronize()
    counts_v = launch_counts()
    st = vec.stats
    assert st.rounds == st.policy_calls == len(rounds), (st, len(rounds))
    assert st.decisions == sum(len(r) for r in rounds) == \
        sum(r.decisions for r in results)
    assert st.max_batch == max(len(r) for r in rounds) == len(jobsets), st
    assert counts_v == times(MLP_FORWARD, st.rounds), (counts_v, st.rounds)

    reset_launch_counts()
    t0 = time.perf_counter()
    seq = [run_trace(res, jobs, agent) for jobs in jobsets]
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts_s = launch_counts()
    assert counts_s == times(MLP_FORWARD, st.decisions), counts_s
    for i, (a, b) in enumerate(zip(results, seq)):
        assert same_results(a, b), f"lane {i}: vector != sequential"
        assert a.decisions > 0 and a.n_unstarted == 0, (i, a.n_unstarted)

    n_rows, margins, worst = check_batched_rows(agent, rounds)
    tol = 2e-4 * max(1.0, worst)
    contested = np.isfinite(margins)
    widths = np.bincount([len(r) for r in rounds]).tolist()
    out = {"launches": counts_v["forward"] + counts_s["forward"],
           "results": results, "dps_vector": st.decisions / wall_v,
           "dps_sequential": st.decisions / wall_s}
    log(f"[vector replay] run_traces over {len(jobsets)} full-scale S1 traces "
        f"(seeds {VECTOR_SEEDS}) as {len(jobsets)} lanes: stats "
        f"{json.dumps(st.as_dict())}; round widths (count by width) "
        f"{widths}")
    log(f"[vector replay] launches {json.dumps(counts_v)} = (forward 13) x "
        f"{st.rounds} rounds; sequential run_trace of each: "
        f"{json.dumps(counts_s)} = (forward 13) x {st.decisions} decisions")
    log(f"[vector replay] every lane's SimResult (metrics, decisions, "
        f"n_unstarted, each job's start and end) equals the sequential "
        f"engine's; {st.decisions} decisions in {wall_v:.3f} s = "
        f"{out['dps_vector']:.1f} decisions/s vector, {wall_s:.3f} s = "
        f"{out['dps_sequential']:.1f} decisions/s sequential "
        f"({out['dps_vector'] / out['dps_sequential']:.2f}x)")
    log(f"[vector replay] all {n_rows} batched rows equal the M = 1 forward "
        f"bit for bit; top-2 margin min {float(margins[contested].min())!r} "
        f"over {int(contested.sum())} rows with two or more valid slots, "
        f"{int((margins[contested] <= tol).sum())} of them within 2e-4 of the "
        f"largest value ({tol!r})")
    return out


def phase_vector_service(agent, expect: list, every: int = 20) -> dict:
    """Lockstep replay through the decision service: ``ServiceSim
    .run_traces`` over phase 17's eight traces, each round's requests one
    ``decide_many``; the results equal phase 17's, and every ``every``-th
    served row scores the same on the kernel and the plain backend."""
    from repro_torch.serve import DecisionService, ServeConfig, ServiceSim
    jobsets = [s1_trace(seed)[1] for seed in VECTOR_SEEDS]
    res = s1_trace(VECTOR_SEEDS[0])[0]
    svc = DecisionService(agent, ServeConfig(max_batch=16))
    reset_launch_counts()
    svc.start()                                      # warm-up forwards
    hist_warm = dict(svc.stats()["batch_hist"])
    ssim = ServiceSim(svc, res)
    assert ssim.sim_cfg.engine == "vector"
    sampled, n_rows = [], [0]
    select_batch = ssim.policy.select_batch

    def sampling(ctxs):
        actions = select_batch(ctxs)
        for c, a in zip(ctxs, actions):
            if n_rows[0] % every == 0:
                sampled.append((svc._encode(c), int(a)))
            n_rows[0] += 1
        return actions

    ssim.policy.select_batch = sampling
    t0 = time.perf_counter()
    results = ssim.run_traces(jobsets)
    wall = time.perf_counter() - t0
    svc.stop()
    torch.cuda.synchronize()
    counts = launch_counts()
    stats = svc.stats()
    forwards = stats["buckets"]["dispatches"]
    assert forwards == len(svc._buckets.widths) + stats["batches"], stats
    assert counts == times(MLP_FORWARD, forwards), (counts, forwards)
    for i, (a, b) in enumerate(zip(results, expect, strict=True)):
        assert same_results(a, b), f"lane {i}: service != direct lockstep"
    decisions = sum(r.decisions for r in results)
    assert stats["requests"] == decisions == n_rows[0]
    hist = {w: c - hist_warm.get(w, 0) for w, c in stats["batch_hist"].items()
            if c - hist_warm.get(w, 0)}
    err, tol, decisive = check_served_rows(agent, sampled)
    log(f"[vector service] ServiceSim.run_traces over the {len(jobsets)} "
        f"traces: every SimResult equals the direct lockstep replay's; "
        f"{decisions} decisions in {wall:.3f} s = {decisions / wall:.1f} "
        f"decisions/s; batch sizes {hist}; launches {json.dumps(counts)} = "
        f"(forward 13) x {forwards} forwards")
    log(f"[vector service] sampled {len(sampled)} served rows: kernel vs "
        f"torch action values max abs err {err!r} (tol {tol!r}); argmax equal "
        f"on all {decisive} rows with top-2 margin > tol")
    return {"launches": counts["forward"]}


def phase_vector_training(agent, slots, config, per_step=MLP_STEP,
                          per_forward=MLP_FORWARD, tag="vector train",
                          seq_dps=None) -> tuple:
    """``train_agent_vectorized`` over ``slots``: exactly ``per_step`` per
    train step plus ``per_forward`` per round with an exploiting row
    (found by replaying each round's ε draws on a copy of the agent's
    rng), finite losses and norms, every parameter moved, one step held
    on the kernel and the plain backend; a ``MetricsRegistry`` on the run
    whose episode and decision totals equal the log's.  Returns (launch
    counts, the training log)."""
    from repro_torch.convert import leaves
    from repro_torch.core import train_agent_vectorized
    from repro_torch.obs import MetricsRegistry
    cfg = agent.config
    assert (cfg.batch_size, cfg.grad_steps_per_episode, cfg.lr,
            cfg.grad_clip) == (64, 64, 1e-4, 10.0), cfg
    before = [p.detach().clone() for _, p in leaves(agent.net)]
    bursts = time_bursts(agent)
    widths, exploiting = [], [0]
    select_batch = agent.select_batch

    def counting(ctxs, slots=None):
        rng = copy.deepcopy(agent.rng)
        greedy = False
        for c in ctxs:
            if rng.uniform() < agent.epsilon:
                rng.integers(0, min(len(c.window), cfg.window))
            else:
                greedy = True
        exploiting[0] += greedy
        widths.append(len(ctxs))
        return select_batch(ctxs, slots=slots)

    agent.select_batch = counting
    torch.cuda.synchronize()
    reset_launch_counts()
    registry = MetricsRegistry()
    log_ = train_agent_vectorized(agent, slots, config, registry=registry)
    torch.cuda.synchronize()
    launches = launch_counts()
    del agent.train_steps, agent.select_batch
    snap = registry.snapshot()
    episodes = sum(snap["train_episodes_total"].values())
    decisions = sum(snap["train_decisions_total"].values())
    assert episodes == len(log_.episodes) and decisions == log_.decisions, (
        snap["train_episodes_total"], snap["train_decisions_total"])
    lanes = [s for s in slots if s.jobsets]
    assert sorted(snap["train_episodes_total"]) == sorted(
        f'{{lane="{s.tag or f"env{i}"}"}}' for i, s in enumerate(lanes))
    assert snap["train_epsilon"][""] == agent.epsilon

    # A per-round step before the buffer fills a minibatch runs nothing.
    idle = [b for b in bursts if b["loss"] is None]
    bursts = [b for b in bursts if b["loss"] is not None]
    assert all(b["launches"] == times({}, 0) for b in idle), idle
    steps = sum(b["steps"] for b in bursts)
    assert steps == int(agent.opt_state.step) > 0
    assert log_.rounds == len(widths) > 0
    for b in bursts:
        assert b["launches"] == times(per_step, b["steps"]), b
        assert math.isfinite(b["loss"]) and math.isfinite(b["grad_norm"]), b
    expect = {k: times(per_step, steps)[k]
              + times(per_forward, exploiting[0])[k] for k in KERNELS}
    assert launches == expect, (launches, expect)
    assert log_.episode_losses and all(map(math.isfinite,
                                           log_.episode_losses))
    assert all(map(math.isfinite, log_.round_losses))
    assert len(log_.episodes) == sum(len(s.jobsets) for s in slots)
    moved = [not torch.equal(a, p) for a, (_, p) in zip(before,
                                                        leaves(agent.net))]
    assert all(moved), f"{moved.count(False)} parameters did not move"
    del before
    check_step_parity(agent, per_step, tag + " parity")
    burst_s = sum(b["wall_s"] for b in bursts)
    collect_s = log_.wall_seconds - burst_s
    full = [b for b in bursts if b["steps"] == cfg.grad_steps_per_episode]
    per = ", ".join(f"{k} {v}" for k, v in per_step.items())
    log(f"[{tag}] train_agent_vectorized over {len(slots)} lanes "
        f"({', '.join(s.tag for s in slots)}): {len(log_.episodes)} episodes, "
        f"{log_.decisions} decisions in {log_.rounds} rounds (widest "
        f"{max(widths)}; {exploiting[0]} rounds with an exploiting row), "
        f"{steps} train steps in {len(bursts)} bursts, "
        f"{log_.wall_seconds:.3f} s; epsilon now {agent.epsilon!r}")
    log(f"[{tag}] launches: {json.dumps(launches)} = ({per}) x {steps} steps "
        f"+ {exploiting[0]} forwards; every burst exactly ({per}) per step; "
        f"all {len(moved)} parameters moved")
    log(f"[{tag}] registry: {episodes:.0f} episodes and {decisions:.0f} "
        f"decisions over {len(snap['train_episodes_total'])} lanes, equal to "
        f"the TrainLog's; train_loss {snap['train_loss']['']!r}, "
        f"train_grad_norm {snap['train_grad_norm']['']!r}")
    if full:
        ms = [b["wall_s"] / b["steps"] * 1e3 for b in full]
        log(f"[{tag}] {len(full)} episode bursts of "
            f"{cfg.grad_steps_per_episode} steps: {statistics.median(ms):.4f} "
            f"ms per step (median; min {min(ms):.4f}, max {max(ms):.4f}; "
            f"sampling and copy included); losses {log_.episode_losses!r}")
    if log_.round_losses:
        log(f"[{tag}] {len(log_.round_losses)} per-round steps, all finite: "
            f"first {log_.round_losses[0]!r}, last {log_.round_losses[-1]!r}")
    beside = ("" if seq_dps is None else
              f" (sequential train_agent in this run: {seq_dps:.1f})")
    log(f"[{tag}] collection: {log_.decisions} decisions in {collect_s:.3f} "
        f"s = {log_.decisions / collect_s:.1f} decisions/s{beside}; "
        f"bursts {burst_s:.3f} s")
    return launches, log_


RELOAD_STEP = 23          # phase 21's checkpoint step of agent B
RELOAD_AT = 100           # decisions served on agent A before the commit
RELOAD_HOLD = 250         # decisions after the commit before the client
                          # waits for the swap (of the trace's ~500)
RELOAD_WAIT_S = 120.0     # how long it waits before the phase fails


class ReloadPolicy:
    """ServicePolicy that keeps every served row with its action and the
    service's ``params_step`` read just before and just after the request,
    and at decision ``commit_at`` publishes a committed checkpoint step by
    renaming it into the watched directory (as the store commits).

    The watcher's restore competes with the serving threads for the host,
    so on a slow host it can land after the trace's last request.  If the
    service still runs on the old weights ``hold_after`` decisions after
    the commit, the client therefore stops sending until ``step`` is
    swapped in (at most ``RELOAD_WAIT_S``), and ``held_s`` says how long:
    the rest of the trace is then served on the new weights."""

    def __init__(self, service, commit_at: int, src: str, dst: str,
                 step: int, hold_after: int):
        from repro_torch.serve import ServicePolicy
        self._inner = ServicePolicy(service)
        self.service, self.commit_at, self.src, self.dst = (
            service, commit_at, src, dst)
        self.step, self.hold_at = step, commit_at + hold_after
        self.rows: list = []
        self.t_commit = None
        self.held_s = 0.0

    def select(self, ctx) -> int:
        if len(self.rows) == self.commit_at:
            os.rename(self.src, self.dst)
            self.t_commit = time.perf_counter()
        elif (len(self.rows) == self.hold_at
              and self.service.params_step != self.step):
            t0 = time.perf_counter()
            while self.service.params_step != self.step:
                if time.perf_counter() - t0 > RELOAD_WAIT_S:
                    raise RuntimeError(
                        f"the watcher did not swap in step {self.step} "
                        f"within {RELOAD_WAIT_S} s of decision "
                        f"{self.hold_at}")
                time.sleep(0.002)
            self.held_s = time.perf_counter() - t0
        before = self.service.params_step
        action = self._inner.select(ctx)
        self.rows.append((self.service._encode(ctx), action, before,
                          self.service.params_step, time.perf_counter()))
        return action


def greedy_plain(agent, rows: np.ndarray) -> np.ndarray:
    """Greedy actions of packed rows on the plain backend (on the card)."""
    from repro_torch.core.dfp import action_values
    sd, m = agent.enc.state_dim, agent.enc.n_resources
    x = torch.from_numpy(rows).to(agent.device)
    u = action_values(agent.net, replace(agent.dfp, backend="torch"),
                      x[:, :sd].contiguous(), x[:, sd:sd + m].contiguous(),
                      x[:, sd + m:sd + 2 * m].contiguous())
    return torch.where(x[:, sd + 2 * m:] > 0.5, u, -torch.inf).argmax(1) \
        .cpu().numpy()


def phase_checkpoint_reload() -> dict:
    """Checkpoint, hot reload and telemetry at paper width: agent B (seed
    13) saved with ``save_async`` and restored onto the card bit for bit
    (no kernel launched); then agent A (seed 0) serves one client's S1
    replay behind a ``DecisionService`` with a registry and a tracer while
    a started ``CheckpointWatcher`` swaps in B's step, published midway:
    every decision before the swap is A's greedy choice and every one
    after it B's (phase 6's top-2-margin guard), 13 B1 launches a forward,
    registry totals equal to the requests, one ``ckpt.reload``; then a
    profiler capture of one service forward shows 13
    ``mrsch.kernel.fused_mlp`` ranges."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import CheckpointManager, restore_pytree
    from repro_torch.convert import leaves
    from repro_torch.core import AgentConfig, MRSchAgent
    from repro_torch.obs import BufferTracer, MetricsRegistry
    from repro_torch.serve import (CheckpointWatcher, DecisionService,
                                   ServeConfig, ServiceSim)
    from repro_torch.workloads import ThetaConfig

    card = gpu_name_and_power_limit()
    res, jobs = s1_trace(0)
    agent_a = MRSchAgent(ThetaConfig().resources(), AgentConfig(seed=0))
    agent_b = MRSchAgent(ThetaConfig().resources(), AgentConfig(seed=13))
    n_params = sum(p.numel() for p in agent_b.net.parameters())
    assert n_params == 51079500, n_params
    with tempfile.TemporaryDirectory() as tmp:
        saved, watched = os.path.join(tmp, "saved"), os.path.join(tmp, "w")
        mgr = CheckpointManager(saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save_async(agent_b.net, RELOAD_STEP)
        t1 = time.perf_counter()
        mgr.wait()
        t2 = time.perf_counter()
        step_dir = os.path.join(saved, f"step_{RELOAD_STEP:08d}")
        mb = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir)) / 1e6
        save_ms, bg_s = (t1 - t0) * 1e3, t2 - t1

        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net, manifest = restore_pytree(agent_a.net, saved, RELOAD_STEP)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        assert launch_counts() == times({}, 0), launch_counts()
        assert manifest["step"] == RELOAD_STEP and net is not agent_a.net
        got, want = leaves(net), leaves(agent_b.net)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, p), (_, q) in zip(got, want):
            assert p.device == q.device and p.dtype == q.dtype, name
            assert torch.equal(p, q), f"{name} differs after restore"
        del net, got

        # Hot reload under load.
        os.makedirs(watched)
        reg, tracer = MetricsRegistry(), BufferTracer()
        svc = DecisionService(agent_a, ServeConfig(max_batch=16),
                              registry=reg, tracer=tracer)
        watcher = CheckpointWatcher(svc, watched, poll_interval_s=0.02)
        policy = ReloadPolicy(svc, RELOAD_AT, step_dir,
                              os.path.join(watched, os.path.basename(
                                  step_dir)), RELOAD_STEP, RELOAD_HOLD)
        reset_launch_counts()
        svc.start()
        watcher.start()
        ssim = ServiceSim(svc, res)
        ssim.policy = policy
        t0 = time.perf_counter()
        result = ssim.run_trace(jobs)
        wall = time.perf_counter() - t0
        watcher.stop()
        svc.stop()
        torch.cuda.synchronize()
        counts = launch_counts()
    stats = svc.stats()
    forwards = stats["buckets"]["dispatches"]
    assert forwards == len(svc._buckets.widths) + stats["batches"], stats
    assert counts == times(MLP_FORWARD, forwards), (counts, forwards)
    assert stats["reloads"] == 1 and svc.params_step == RELOAD_STEP, stats
    assert watcher.stats() == {"loaded_step": RELOAD_STEP, "rejected": 0,
                               "transient_errors": 0}, watcher.stats()
    reloads = [e for e in tracer.events if e["ev"] == "ckpt.reload"]
    assert [e["step"] for e in reloads] == [RELOAD_STEP], reloads
    n = len(policy.rows)
    snap = reg.snapshot()
    assert result.decisions == n == stats["requests"] > policy.hold_at, (
        result.decisions, n, stats["requests"])
    assert snap["serve_requests_total"][""] == n, snap["serve_requests_total"]
    assert snap["serve_reloads_total"][""] == 1.0, snap["serve_reloads_total"]
    assert snap["serve_batches_total"][""] == stats["batches"]
    assert result.n_unstarted == 0 and all(
        math.isfinite(v) for v in result.metrics.as_row().values())

    # A request whose "before" read saw the step was served on B; one
    # whose "after" read did not see it was served on A, but for the
    # request just before the first that saw it (the swap sets the network
    # a moment before the step): that one and any in flight across the
    # swap may be either.
    k = next(i for i, (*_, c, _t) in enumerate(policy.rows)
             if c == RELOAD_STEP)
    rows = [(r, a) for i, (r, a, b, c, _) in enumerate(policy.rows)
            if c is None and i != k - 1]
    rows_b = [(r, a) for r, a, b, c, _ in policy.rows if b == RELOAD_STEP]
    mixed = [(r, a) for i, (r, a, b, c, _) in enumerate(policy.rows)
             if i == k - 1 or (b is None and c == RELOAD_STEP)]
    assert len(rows) + len(rows_b) + len(mixed) == n and len(mixed) <= 2
    assert rows and rows_b, (len(rows), len(rows_b))
    err_a, tol_a, dec_a = check_served_rows(agent_a, rows)
    err_b, tol_b, dec_b = check_served_rows(agent_b, rows_b)
    for r, a in mixed:                # in flight across the swap: A or B
        x = r[None]
        assert a in (greedy_plain(agent_a, x)[0], greedy_plain(agent_b, x)[0])
    first_b = next(t for _, _, b, _, t in policy.rows if b == RELOAD_STEP)
    reload_ms = (first_b - policy.t_commit) * 1e3

    # A profiler capture of one service forward.
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc._process([policy.rows[-1][0]])
    ranges = sum(e.name == "mrsch.kernel.fused_mlp" for e in prof.events())
    assert ranges == 13 == launch_counts()["forward"], (ranges,
                                                        launch_counts())
    out = {"launches": counts["forward"], "forwards": forwards,
           "save_async_ms": save_ms, "save_bg_s": bg_s, "save_mb": mb,
           "restore_ms": restore_ms, "reload_ms": reload_ms,
           "held_s": policy.held_s, "decisions": n, "before": len(rows),
           "after": len(rows_b)}
    log(f"[ckpt] {card}: save_async of agent B ({n_params} parameters) "
        f"{save_ms:.3f} ms on the caller's thread; background save "
        f"{bg_s:.3f} s, {mb:.1f} MB on disk; restore onto the card "
        f"{restore_ms:.3f} ms, bit-equal, 0 kernel launches")
    log(f"[reload] {card}: {n} decisions in {wall:.3f} s, step "
        f"{RELOAD_STEP} committed after {RELOAD_AT}: {len(rows)} served on "
        f"A, {len(rows_b)} on B, {len(mixed)} across the swap; commit to "
        f"the first decision on the new weights {reload_ms:.3f} ms; the "
        f"client held {policy.held_s:.3f} s for the swap after decision "
        f"{policy.hold_at}")
    log(f"[reload] launches {json.dumps(counts)} = (forward 13) x "
        f"{forwards} forwards; A's rows: max abs err {err_a!r} (tol "
        f"{tol_a!r}), {dec_a} decisive; B's rows: {err_b!r} (tol "
        f"{tol_b!r}), {dec_b} decisive; registry requests "
        f"{snap['serve_requests_total']['']!r}, reloads "
        f"{snap['serve_reloads_total']['']!r}, batches "
        f"{snap['serve_batches_total']['']!r}; one ckpt.reload event; "
        f"profiler: {ranges} mrsch.kernel.fused_mlp ranges in one forward")
    return out


# Phase 22: the comparison policies, the baseline zoo, the tournament and
# the CNN state module, at full Theta scale on 1-day traces.
POLICY_SCENARIOS = ("S1", "bursty-campaigns")
POLICY_SEEDS = (1, 2)
POLICY_DAYS, POLICY_PER_DAY = 1.0, 160.0
ZOO_ON_DEVICE = ("PRB-EWT", "DRAS", "CoSchedRL", "ScalarRL")
# The CNN agent: its convs and projection are plain PyTorch (cuDNN and a
# matmul), as the reference keeps them on plain XLA ops; the ten head
# layers run B1.  The measurement and goal modules' first layers take no
# input gradient, so a step runs eight dgrad launches.
CNN_FORWARD = {"forward": 10}
CNN_STEP = {"forward": 10, "dgrad": 8, "wgrad": 10}
SCALAR_RL_TRAIN_HIDDEN = (512, 128)   # benchmarks/common.py's ScalarRL


def window_margins(policy, rows: np.ndarray, tol_scale: float) -> tuple:
    """Slot scores of a network policy's decision rows in float64 on the
    card (a float64 copy of its network; invalid slots -inf), each row's
    top-2 margin and the tolerance ``tol_scale`` x the largest score."""
    net = copy.deepcopy(policy.init_state()).double()
    x = torch.from_numpy(rows.astype(np.float64)).to("cuda")
    w = policy.enc.window
    with torch.no_grad():
        s = policy.score_window(net, x)
    s = torch.where(x[:, -w:] > 0.5, s, -torch.inf).cpu().numpy()
    top2 = np.sort(s, axis=1)[:, -2:]
    tol = tol_scale * max(1.0, float(np.abs(s[np.isfinite(s)]).max()))
    return top2[:, 1] - top2[:, 0], tol


def phase_policies() -> dict:
    """Phase 22: the tournament of the eight entrants, the zoo on the
    device engine, ScalarRL training and the CNN agent at paper width;
    returns the launches of the phase's runs by kernel."""
    from repro_torch.convert import leaves
    from repro_torch.core import AgentConfig, MRSchAgent, train_agent
    from repro_torch.core.encoding import (decision_row_dim,
                                           encode_decision_row)
    from repro_torch.core.policies import (ScalarRLConfig, ScalarRLPolicy,
                                           _pg_step)
    from repro_torch.eval import (TournamentConfig, render_leaderboard,
                                  run_tournament, zoo_policies)
    from repro_torch.eval.matrix import _row
    from repro_torch.nn import adam_init, count_params
    from repro_torch.obs.trace import BufferTracer, canonical_events
    from repro_torch.sim import DeviceSimulator, SimConfig, Simulator
    from repro_torch.workloads import ThetaConfig
    from repro_torch.workloads.registry import build_jobs, get_scenario

    card = gpu_name_and_power_limit()
    theta = ThetaConfig(duration_days=POLICY_DAYS,
                        jobs_per_day=POLICY_PER_DAY)
    res = theta.resources()
    cells = [(s, seed) for s in POLICY_SCENARIOS for seed in POLICY_SEEDS]
    traces = [build_jobs(s, theta, seed=seed) for s, seed in cells]
    faults = [get_scenario(s).faults for s, _ in cells]
    total = {k: 0 for k in KERNELS}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            total[k] += v

    # (1) The tournament: 8 entrants x 4 cells, the MRSch entrant the
    # seed-0 paper-width agent of phase 6 (kernel backend).
    agent = MRSchAgent(res, AgentConfig(seed=0))
    pols = zoo_policies(res, agent=agent)
    rounds: list = []
    greedy_rows = agent._greedy_rows

    def recording(rows):
        rounds.append(rows.copy())
        return greedy_rows(rows)

    agent._greedy_rows = recording
    tracer = BufferTracer()
    cfg = TournamentConfig(scenarios=POLICY_SCENARIOS, seeds=POLICY_SEEDS,
                           vector=4)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    t = run_tournament(pols, res, theta, cfg, tracer=tracer)
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    counts = launch_counts()
    del agent._greedy_rows
    summary = t["summary"]
    assert summary["failures"] == [] and summary["n_failed_cells"] == 0, \
        summary["failures"]
    assert summary["n_policies"] == 8 and len(t["rows"]) == 32 == \
        summary["n_cells"], summary
    assert summary["batched_policies"] == 7, summary   # all but GA
    committed = json.loads((ROOT / "benchmarks" / "baselines"
                            / "tournament.json").read_text())
    matrix = json.loads((ROOT / "benchmarks" / "baselines"
                         / "matrix.json").read_text())
    assert t["columns"] == matrix["columns"], t["columns"]
    assert t["config"]["policies"] == committed["config"]["policies"]
    for p, metrics in committed["per_policy"].items():
        assert list(t["per_policy"][p]) == list(metrics), p
    assert counts == times(MLP_FORWARD, len(rounds)), (counts, len(rounds))
    add(counts)
    n_rows, margins, worst = check_batched_rows(agent, rounds)
    mrsch_rows = {(r["scenario"], r["seed"]): r for r in t["rows"]
                  if r["policy"] == "MRSch"}
    assert n_rows == sum(r["decisions"] for r in mrsch_rows.values())
    # (5) The goal log: one goal per decision of the greedy run above.
    assert len(agent.goal_log) == n_rows, (len(agent.goal_log), n_rows)
    goals = np.stack(agent.goal_log)
    assert goals.shape == (n_rows, len(res)) and np.isfinite(goals).all()
    n_goals = len(agent.goal_log)

    # The MRSch entrant against the sequential engine, job by job: every
    # scheduling and job event of each cell's environment.
    envs = tracer.meta["envs"]
    ids = {(v["scenario"], v["seed"]): int(e) for e, v in envs.items()
           if v["policy"] == "MRSch"}
    reset_launch_counts()
    n_seq, n_events = 0, 0
    for (scenario, seed), jobs, f in zip(cells, traces, faults):
        eid = ids[(scenario, seed)]
        seq_tracer = BufferTracer()
        result = Simulator(res, jobs, agent, SimConfig(), faults=f,
                           tracer=seq_tracer, env=eid).run()
        ev_seq = canonical_events(seq_tracer.events)
        ev_vec = canonical_events([e for e in tracer.events
                                   if e["env"] == eid])
        assert ev_seq == ev_vec, f"MRSch {scenario} seed {seed}: events"
        assert _row("MRSch", scenario, seed, result, res) == \
            mrsch_rows[(scenario, seed)], (scenario, seed)
        n_seq += result.decisions
        n_events += len(ev_seq)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == times(MLP_FORWARD, n_seq), counts
    add(counts)
    spans = {e["name"][len("policy:"):]: e["dur_s"] for e in tracer.events
             if e["ev"] == "prof.span"}
    decisions = {}
    for r in t["rows"]:
        decisions[r["policy"]] = decisions.get(r["policy"], 0) + r["decisions"]
    contested = np.isfinite(margins)
    log(f"[tournament] {card}: run_tournament of {summary['n_policies']} "
        f"entrants x {len(cells)} cells ({', '.join(POLICY_SCENARIOS)}; "
        f"seeds {POLICY_SEEDS}; full-scale Theta, {POLICY_DAYS:g} day at "
        f"{POLICY_PER_DAY:g} jobs/day: {[len(j) for j in traces]} jobs) "
        f"with vector 4 in {t_wall:.3f} s; {summary['n_cells']} rows, no "
        f"failed cell, {summary['batched_policies']} batched entrants; "
        f"columns equal benchmarks/baselines/matrix.json's, entrants and "
        f"per-policy metrics tournament.json's")
    log(f"[tournament] MRSch: {len(rounds)} batched forwards, 13 B1 "
        f"launches each; all {n_rows} batched rows equal the M = 1 "
        f"forward bit for bit (top-2 margin min "
        f"{float(margins[contested].min())!r}); each cell's {n_events} "
        f"canonical events in all and its row equal the sequential "
        f"run_trace's ({n_seq} decisions, 13 B1 launches each); goal_log "
        f"held {n_goals} goals after the tournament, one per decision")
    for name in t["config"]["policies"]:
        log(f"[tournament] {card}: {name}: {decisions[name]} decisions in "
            f"{spans[name]:.3f} s = {decisions[name] / spans[name]:.1f} "
            f"decisions/s")
    for line in render_leaderboard(t).splitlines():
        log(f"[tournament] {line}")
    del rounds, tracer

    # (2) The zoo on the device engine: the four cells as four
    # environments, each against its sequential run.
    zoo = {name: pols[name]() for name in ZOO_ON_DEVICE}
    assert zoo["ScalarRL"].config.hidden == (256, 64)
    device_rows = {}
    for name, policy in zoo.items():
        sim = DeviceSimulator(res, traces, policy, faults=faults)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        ro = sim.rollout(collect=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st = ro.stats
        assert st.rounds > 0 and counts == times({"window_pack": 1},
                                                  st.rounds), (counts, st)
        assert standalone_packs() == 0
        add(counts)
        rows = {i: [] for i in range(len(traces))}
        for _, i, row, _ in ro.transitions():
            rows[i].append(row)
        compared = []
        for i, (jobs, f) in enumerate(zip(traces, faults)):
            rec = Recorder(policy)
            seq = Simulator(res, jobs, rec, SimConfig(), faults=f).run()
            acts = env_actions(ro, i)
            n_cmp = len(acts)
            if name != "PRB-EWT":
                # A network's M = 4 rows against its M = 1 row: equal up
                # to the first top-2 margin within 2e-4 of the largest
                # score.  PRB-EWT has no network and must agree in full.
                m, tol = window_margins(policy, np.stack(rows[i]), 2e-4)
                ties = np.flatnonzero(m <= tol)
                n_cmp = int(ties[0]) if len(ties) else len(acts)
            assert n_cmp > 0 and acts[:n_cmp] == rec.actions[:n_cmp], \
                (name, i, n_cmp)
            if acts == rec.actions:
                assert_results_close(seq, ro.results[i])
            compared.append(f"{len(acts)} equal in full" if acts ==
                            rec.actions else f"{n_cmp} of {len(acts)}")
        device_rows[name] = {"rounds": st.rounds_run, "deciding": st.rounds,
                             "decisions": st.decisions, "wall_s": wall}
        log(f"[zoo device] {card}: {name}: DeviceSimulator.rollout(collect="
            f"True) over the 4 cells as N = 4 environments: "
            f"{st.rounds_run} rounds ({st.rounds} deciding), {st.decisions} "
            f"decisions in {wall:.3f} s = {st.rounds_run / wall:.1f} "
            f"rounds/s, {st.decisions / wall:.1f} decisions/s; launches "
            f"{json.dumps(counts)} = (window_pack 1) x {st.rounds} deciding "
            f"rounds; each environment's decisions against its sequential "
            f"run_trace: {', '.join(compared)}")

    # (3) ScalarRL training at paper width: one episode, one REINFORCE
    # step, held against the same step on the CPU.
    rl = ScalarRLPolicy(res, ScalarRLConfig(hidden=SCALAR_RL_TRAIN_HIDDEN))
    before = [p.detach().clone() for _, p in leaves(rl.params)]
    rl.training = True
    reset_launch_counts()
    step_ms, losses = [], []
    for i, jobs in enumerate(traces[:2]):      # S1, seeds 1 and 2
        t0 = time.perf_counter()
        Simulator(res, jobs, rl, SimConfig()).run()
        if i == 0:
            collect_s = time.perf_counter() - t0
            batch = rl.episode_batch()
            net_cpu = copy.deepcopy(rl.params).cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(rl.end_episode())     # ends in the loss's host read
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            after = [p.detach().clone() for _, p in leaves(rl.params)]
    torch.cuda.synchronize()
    assert launch_counts() == times({}, 0), launch_counts()
    assert all(x is not None and math.isfinite(x) for x in losses), losses
    loss = losses[0]
    moved = [not torch.equal(a, p) for a, p in zip(before, after)]
    assert all(moved), f"{moved.count(False)} ScalarRL leaves did not move"
    _, loss_cpu = _pg_step(
        net_cpu, adam_init([p for _, p in leaves(net_cpu)]),
        {k: torch.from_numpy(v) for k, v in batch.items()}, rl.config.lr,
        rl.config.entropy_coef)
    assert math.isclose(loss, float(loss_cpu), rel_tol=1e-4), \
        (loss, float(loss_cpu))
    p_err = 0.0
    for (name, _), p, (_, q) in zip(leaves(rl.params), after,
                                    leaves(net_cpu)):
        torch.testing.assert_close(p.cpu(), q.detach(), rtol=1e-3,
                                   atol=1e-4, msg=name)
        p_err = max(p_err, float((p.cpu() - q.detach()).abs().max()))
    log(f"[scalar rl train] {card}: ScalarRL hidden "
        f"{SCALAR_RL_TRAIN_HIDDEN} ({count_params(rl.params)} parameters) "
        f"over {cells[0][0]} seed {cells[0][1]}: {len(batch['action'])} "
        f"sampled decisions in {collect_s:.3f} s; end_episode "
        f"{step_ms[0]:.3f} ms (the first: warm-up included), "
        f"{step_ms[1]:.3f} ms on seed {cells[1][1]}'s episode; loss "
        f"{loss!r}, the CPU's {float(loss_cpu)!r}; all {len(moved)} leaves "
        f"moved, within rtol 1e-3, atol 1e-4 of the CPU step (max abs "
        f"diff {p_err!r}); 0 kernel launches (plain network)")
    del rl, net_cpu, after, zoo, pols, agent

    # (4) The CNN agent at paper width.
    cnn = MRSchAgent(res, AgentConfig(state_module="cnn", seed=0))
    net = cnn.net.state
    shapes = ([tuple(c.w.shape) for c in net.convs], tuple(net.proj.w.shape))
    assert cnn.enc.state_dim == 11410 and shapes == (
        [(9, 1, 8), (9, 8, 16)], (11424, 512)), (cnn.enc.state_dim, shapes)
    sim = Simulator(res, traces[0], None, SimConfig())
    rows = []
    while len(rows) < 64 and (ctx := sim.next_decision()) is not None:
        row = np.zeros(decision_row_dim(cnn.enc, 10), np.float32)
        encode_decision_row(cnn.enc, ctx, 10, out=row)
        rows.append(row)
        sim.post_action(0)
    rows = torch.from_numpy(np.stack(rows)).to("cuda")
    fwd_err = 0.0
    for m in (1, len(rows)):
        reset_launch_counts()
        u_k = packed_values(cnn, rows[:m])
        torch.cuda.synchronize()
        assert launch_counts() == times(CNN_FORWARD, 1), launch_counts()
        cnn.set_backend("torch")
        u_t = packed_values(cnn, rows[:m])
        cnn.set_backend("kernel")
        fin = torch.isfinite(u_t)
        torch.testing.assert_close(u_k, u_t, rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])
        fwd_err = max(fwd_err, float((u_k[fin] - u_t[fin]).abs().max()))
    reset_launch_counts()
    cnn.goal_log.clear()
    n_cmp, n_dec = agent_device_parity(cnn, res, traces[0], "CNN agent",
                                       "cnn device parity")
    torch.cuda.synchronize()
    counts = launch_counts()
    n_seq = len(cnn.goal_log)         # the sequential run's decisions
    assert counts == {**times(CNN_FORWARD, n_seq + n_dec),
                      "window_pack": n_dec}, (counts, n_seq, n_dec)
    add(counts)
    before = [p.detach().clone() for _, p in leaves(cnn.net)]
    bursts = time_bursts(cnn)
    torch.cuda.synchronize()
    reset_launch_counts()
    log_ = train_agent(cnn, res, [traces[0]])
    torch.cuda.synchronize()
    counts = launch_counts()
    del cnn.train_steps
    steps = sum(b["steps"] for b in bursts)
    assert len(bursts) == 1 and steps == int(cnn.opt_state.step) == 64
    for b in bursts:
        assert b["launches"] == times(CNN_STEP, b["steps"]), b
        assert math.isfinite(b["loss"]) and math.isfinite(b["grad_norm"]), b
    greedy = counts["forward"] - CNN_STEP["forward"] * steps
    assert greedy % CNN_FORWARD["forward"] == 0 and counts == {
        **times(CNN_STEP, steps), "forward": counts["forward"]}, counts
    add(counts)
    moved = [not torch.equal(a, p) for a, (_, p) in zip(before,
                                                        leaves(cnn.net))]
    assert all(moved), f"{moved.count(False)} CNN leaves did not move"
    check_step_parity(cnn, CNN_STEP, "cnn train parity")
    phase_training_timing(cnn, "cnn train timing")
    b = bursts[0]
    log(f"[cnn] {card}: CNN agent (state_dim {cnn.enc.state_dim}, convs "
        f"1 -> 8 -> 16 of width 9, stride 4, proj {shapes[1][0]} -> "
        f"{shapes[1][1]}; {count_params(cnn.net)} parameters): kernel "
        f"backend forward within {TOL[torch.float32]} of the torch "
        f"backend's at M = 1 and {len(rows)} (max abs diff {fwd_err!r}), "
        f"10 B1 launches a forward; device rollout against the sequential "
        f"run: {n_cmp} of {n_dec} decisions compared")
    log(f"[cnn] {card}: train_agent over one S1 episode: "
        f"{log_.decisions} decisions, {steps} steps in {b['wall_s']:.4f} s "
        f"= {b['wall_s'] / steps * 1e3:.4f} ms a step (sampling and copy "
        f"included); launches {json.dumps(counts)} = (forward 10, dgrad 8, "
        f"wgrad 10) x {steps} + {greedy // 10} greedy forwards; loss "
        f"{b['loss']!r}; all {len(moved)} leaves moved")
    del cnn, before
    return {"launches": total, "tournament_s": t_wall,
            "devices": device_rows}


def flash_inputs(b, sq, sk, h, kv, dh, dtype, gen) -> tuple:
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((b, sq, h, dh), (b, sk, kv, dh),
                               (b, sk, kv, dh)))


def within(got, want, tol: float, atol: float = None) -> tuple:
    """(ok, max abs err): |got - want| <= atol + tol * |want| everywhere,
    the reference tests' ``assert_allclose(rtol=tol, atol=tol)`` unless
    ``atol`` is given."""
    err = (got.float() - want.float()).abs()
    atol = tol if atol is None else atol
    return bool((err <= atol + tol * want.float().abs()).all()), \
        float(err.max())


def phase_flash_parity() -> dict:
    """B7 against its plain version over the reference tests' grid, every
    instantiated dh and unequal lengths, float32 and bfloat16, causal and
    full, and in both dtypes at zamba2-7b's shape; returns the worst
    absolute error by dtype."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(b, s, s, h, kv, dh) for b, s, h, kv, dh in FLASH_GRID] + \
        FLASH_CROSS
    for b, sq, sk, h, kv, dh in cases:
        for dtype, tol in FLASH_TOL.items():
            q, k, v = flash_inputs(b, sq, sk, h, kv, dh, dtype, gen)
            for causal in (True, False):
                out = flash_attention(q, k, v, causal=causal)
                ok, err = within(out, flash_attention_ref(q, k, v, causal),
                                 tol)
                if not ok:
                    raise AssertionError(
                        f"[flash parity] B={b} Sq={sq} Sk={sk} H={h} KV={kv} "
                        f"dh={dh} {dtype} causal={causal}: max abs err {err}")
                worst[dtype] = max(worst[dtype], err)
    # bfloat16 (the wgmma kernel) at zamba2-7b's shape.
    b, sq, sk, h, kv, dh = FLASH_ZAMBA
    q, k, v = flash_inputs(b, sq, sk, h, kv, dh, torch.bfloat16, gen)
    ok, zamba = within(flash_attention(q, k, v, causal=True),
                       flash_attention_ref(q, k, v, True),
                       FLASH_TOL[torch.bfloat16], FLASH_ZAMBA_ATOL)
    if not ok:
        raise AssertionError(f"[flash parity] bfloat16 at {FLASH_ZAMBA}: max "
                             f"abs err {zamba}")
    worst[torch.bfloat16] = max(worst[torch.bfloat16], zamba)
    # float32 (3xTF32 on mma.sync) at the same shape: 64 key tiles of
    # accumulation in the rows past 4,000.
    q, k, v = flash_inputs(b, sq, sk, h, kv, dh, torch.float32, gen)
    ok, zamba32 = within(flash_attention(q, k, v, causal=True),
                         flash_attention_ref(q, k, v, True),
                         FLASH_TOL[torch.float32])
    if not ok:
        raise AssertionError(f"[flash parity] float32 at {FLASH_ZAMBA}: max "
                             f"abs err {zamba32}")
    worst[torch.float32] = max(worst[torch.float32], zamba32)
    del q, k, v
    torch.cuda.synchronize()
    log(f"[flash parity] {len(cases) * 4 + 2} cases pass; worst abs err "
        f"float32 {worst[torch.float32]!r} (rtol = atol = 2e-4), bfloat16 "
        f"{worst[torch.bfloat16]!r} (2e-2); at (B, Sq, Sk, H, KV, dh) = "
        f"{FLASH_ZAMBA}, causal: bfloat16 {zamba!r} (rtol 2e-2 atol "
        f"{FLASH_ZAMBA_ATOL}), float32 {zamba32!r} (2e-4)")
    return worst


def ssd_inputs(b, s, h, p, n, g, dtype, gen) -> tuple:
    """The reference test's distributions: x normal, dt softplus(normal),
    dA = -dt exp(0.3 normal per head), B and C 0.3 normal per group."""
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    dt = F.softplus(r(b, s, h))
    dA = -dt * torch.exp(r(h) * 0.3)
    return (r(b, s, h, p).to(dtype), dt, dA, (r(b, s, g, n) * 0.3).to(dtype),
            (r(b, s, g, n) * 0.3).to(dtype))


def ssd_oracle(x, dt, dA, bm, cm):
    """``ssd_ref`` (the exact sequential recurrence) in the models' layout,
    with the groups repeated per head; float32."""
    from repro_torch.kernels.ssd import ssd_ref
    b, s, h, p = x.shape

    def flat(t):
        t = t.repeat_interleave(h // t.shape[2], dim=2) if t.dim() == 4 \
            else t[..., None]
        return t.transpose(1, 2).reshape(b * h, s, t.shape[-1]).float()

    y = ssd_ref(flat(x), flat(dt), flat(dA), flat(bm), flat(cm))
    return y.reshape(b, h, s, p).transpose(1, 2)


def phase_ssd_parity() -> float:
    """B8 against the exact recurrence ``ssd_ref`` (y in x's dtype) and its
    plain chunked version (y float32, as the models take it) over the
    reference tests' grid and the LM configs' (N, P, chunk) at a ragged S,
    float32 and bfloat16; returns the worst float32 absolute error."""
    from repro_torch.kernels.ssd import ssd, ssd_plain
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst = {(dtype, what): 0.0 for dtype in SSD_TOL
             for what in ("vs ssd_ref", "float32 out vs the plain version")}
    for b, s, h, p, n, chunk, g in SSD_GRID:
        for dtype, tol in SSD_TOL.items():
            args = ssd_inputs(b, s, h, p, n, g, dtype, gen)
            oracle = ssd_oracle(*args)
            checks = (
                ("vs ssd_ref", ssd(*args, chunk=chunk), oracle, tol),
                ("float32 out vs the plain version",
                 ssd(*args, chunk=chunk, out_dtype=torch.float32),
                 ssd_plain(*args, chunk=chunk, out_dtype=torch.float32),
                 SSD_PLAIN_TOL))
            for what, got, want, bound in checks:
                ok, err = within(got, want, bound)
                if not ok:
                    raise AssertionError(
                        f"[ssd parity] B={b} S={s} H={h} P={p} N={n} "
                        f"chunk={chunk} G={g} {dtype} {what}: max abs err "
                        f"{err}")
                worst[dtype, what] = max(worst[dtype, what], err)
            if not torch.equal(checks[1][1], ssd(*args, chunk=chunk,
                                                 out_dtype=torch.float32)):
                raise AssertionError(f"[ssd parity] B={b} S={s} H={h} "
                                     f"{dtype}: two calls differ")
    torch.cuda.synchronize()
    log(f"[ssd parity] {len(SSD_GRID) * 4} cases pass, two calls bit-equal "
        f"in each of the {len(SSD_GRID) * 2}; worst abs err " + ", ".join(
            f"{str(dtype)[6:]} {what} {err!r}"
            for (dtype, what), err in worst.items())
        + f" (rtol = atol = 1e-3 and 5e-2 vs ssd_ref in x's dtype, "
        f"{SSD_PLAIN_TOL} vs the plain version with float32 y)")
    return max(worst[torch.float32, what] for _, what in worst)


class FirstCalls:
    """Within the block, keeps the arguments of the first call the models
    make to ``flash_attention`` (B7, from attention or MLA) and to ``ssd``
    (B8), and passes every call through to the wrapper (which launches and
    counts as usual)."""

    def __enter__(self):
        from repro_torch.models import attention, mamba2, mla
        self.calls = {}
        self.sites = ((attention, "flash_attention"),
                      (mla, "flash_attention"), (mamba2, "ssd"))
        self.saved = [getattr(m, name) for m, name in self.sites]
        for (mod, name), fn in zip(self.sites, self.saved):
            def rec(*args, _fn=fn, _name=name, **kw):
                self.calls.setdefault(_name, (args, kw))
                return _fn(*args, **kw)
            setattr(mod, name, rec)
        return self.calls

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)


def lm_kernel_closures(calls: dict, dv: int | None = None) -> dict:
    """For each recorded call: the kernel, its plain version and the
    library yardstick (SDPA with ``is_causal`` for B7; none computes B8) as
    closures; the float32 plain output's tolerance; and the bound.  ``dv``:
    the columns of B7's v that the model uses where the recorded v is
    zero-padded to q's width (MLA); the bound counts only those, in the
    P V product and in v's and o's bytes."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.ssd import ssd, ssd_plain
    out = {}
    if "flash_attention" in calls:
        (q, k, v), kw = calls["flash_attention"]
        causal = kw.get("causal", True)
        b, sq, h, dh = q.shape
        sk, kv = k.shape[1], k.shape[2]
        dv = dv or dh
        lib_args = [t.transpose(1, 2) for t in (q, k, v)]
        pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                 else sq * sk)
        out["flash_attention"] = dict(
            run=lambda: flash_attention(q, k, v, causal=causal),
            ref=lambda: flash_attention_ref(q, k, v, causal),
            lib=lambda: F.scaled_dot_product_attention(
                *lib_args, is_causal=causal, enable_gqa=kv != h),
            tol=FLASH_TOL[q.dtype],
            shape=(f"B={b} S={sq} H={h} KV={kv} dh={dh} "
                   + (f"dv={dv} padded to {dh} " if dv != dh else "")
                   + str(q.dtype)),
            nbytes=q.element_size() * (q.numel() + k.numel()
                                       + b * (sk * kv + sq * h) * dv),
            flops=2.0 * b * h * pairs * (dh + dv), dtype=q.dtype)
    if "ssd" in calls:
        (x, dt, dA, bm, cm), kw = calls["ssd"]
        chunk, odt = kw["chunk"], kw.get("out_dtype") or x.dtype
        b, s, h, p = x.shape
        n = bm.shape[-1]
        sp = -(-s // chunk) * chunk
        # Per (b, h) and chunk: the causal half of C B^T and of W x, then
        # C h and the state update (2 flops per FMA).
        fmas = b * h * (sp // chunk) * (chunk * (chunk + 1) // 2 * (n + p)
                                        + 2 * chunk * n * p)
        nbytes = (x.element_size() * (x.numel() + bm.numel() + cm.numel())
                  + 4 * (dt.numel() + dA.numel())
                  + torch.empty(0, dtype=odt).element_size() * x.numel())
        out["ssd"] = dict(
            run=lambda: ssd(x, dt, dA, bm, cm, chunk=chunk, out_dtype=odt),
            ref=lambda: ssd_plain(x, dt, dA, bm, cm, chunk=chunk,
                                  out_dtype=odt),
            lib=None, ref_tol=SSD_TOL[x.dtype],
            tol=SSD_PLAIN_TOL if odt == torch.float32 else SSD_TOL[x.dtype],
            shape=f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} {x.dtype}",
            nbytes=nbytes, flops=2.0 * fmas, dtype=x.dtype)
    for name, c in out.items():
        b_ms = c["nbytes"] / PEAK_BYTES_PER_S * 1e3
        c["fma_bound_ms"] = max(b_ms, c["flops"] / PEAK_F32_FLOP_PER_S * 1e3)
        if c["dtype"] == torch.bfloat16:
            o_ms = c["flops"] / PEAK_BF16_FLOP_PER_S * 1e3
        else:                               # both kernels' route: 3xTF32
            o_ms = 3 * c["flops"] / PEAK_TF32_FLOP_PER_S * 1e3
        c["bound_ms"] = max(b_ms, o_ms)
        c["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
    return out


def check_recorded(calls: dict, tag: str) -> dict:
    """Each recorded kernel call against its plain version, at the
    kernel's tolerance; B8's also against the exact recurrence.  Returns
    the largest absolute errors."""
    errs = {}
    for name, c in lm_kernel_closures(calls).items():
        ok, err = within(c["run"](), c["ref"](), c["tol"])
        if not ok:
            raise AssertionError(f"[{tag}] {name} on the path's operands "
                                 f"({c['shape']}): max abs err {err}")
        errs[name] = err
        extra = ""
        if name == "ssd":
            (x, dt, dA, bm, cm), _ = calls["ssd"]
            ok, e2 = within(c["run"]().float(), ssd_oracle(x, dt, dA, bm, cm),
                            c["ref_tol"])
            if not ok:
                raise AssertionError(f"[{tag}] ssd vs ssd_ref on the path's "
                                     f"operands: max abs err {e2}")
            errs[name] = max(err, e2)
            extra = (f"; vs the exact recurrence {e2!r} (tol "
                     f"{c['ref_tol']})")
        log(f"[{tag}] {name} on the path's first operands ({c['shape']}): "
            f"max abs err vs its plain version {err!r} (tol {c['tol']})"
            f"{extra}")
    torch.cuda.synchronize()
    return errs


def prefill_parity(cfg, params, batch, expect: dict, tag: str,
                   tol: float = LM_TOL) -> tuple:
    """One prefill step on each backend, each with the launch counts set
    to 0 just before and read just after: the kernel backend's every B7
    launch on the kernel of the parameters' dtype (``flash_fwd`` for
    float32, ``flash_fwd_sm90`` for bfloat16), the torch backend's none;
    the last-token logits compared within ``tol`` of the largest.
    Returns (counts, recorded first calls, max abs err)."""
    from repro_torch.launch import make_prefill_step
    b7 = ("flash_fwd_sm90" if params.embed.table.dtype == torch.bfloat16
          else "flash_fwd")
    # clone(): the step's last-token logits are a view of the whole
    # sequence's (3.4 GB for deepseek at B = 2, S = 4096); keep only them.
    reset_launch_counts()
    with FirstCalls() as calls:
        got = make_prefill_step(cfg, "kernel")(params, batch).clone()
        torch.cuda.synchronize()
    counts, by_kernel = launch_counts(), flash_kernel_launches()
    by_pass = ssd_kernel_launches()
    reset_launch_counts()
    want = make_prefill_step(cfg, "torch")(params, batch).clone()
    torch.cuda.synchronize()
    plain_counts = launch_counts()
    want_b7 = {"flash_fwd": 0, "flash_fwd_sm90": 0}
    want_b7[b7] = counts["flash_attention"]
    if counts != times(expect, 1) or by_kernel != want_b7 \
            or by_pass != dict.fromkeys(SSD_PASSES, counts["ssd"]) \
            or any(plain_counts.values()):
        raise AssertionError(f"[{tag}] launches per forward {counts}, B7 by "
                             f"kernel {by_kernel}, B8 by kernel {by_pass}, "
                             f"torch backend {plain_counts}; expected "
                             f"{times(expect, 1)}, all B7 on {b7}, each B8 "
                             f"kernel once a call, none on the torch backend")
    b = got.shape[0]
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"[{tag}] logits {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = got.argmax(-1) == want.argmax(-1)
    log(f"[{tag}] B={b} S={batch['tokens'].shape[1]}: last-token logits "
        f"{tuple(got.shape)}, max |logit| {scale:.4f}, kernel vs torch "
        f"backend max abs err {err!r}; argmax agree on "
        f"{int(agree.sum())}/{b} rows ({int(decisive.sum())} decisive); "
        f"launches per forward {counts}; B8 by kernel {by_pass}; "
        f"{params.embed.table.dtype}, tol {tol} of max(1, |logit|)")
    if err > tol * max(1.0, scale) or not bool(agree[decisive].all()):
        raise AssertionError(f"[{tag}] kernel backend disagrees with the "
                             f"torch backend: max abs err {err}")
    return counts, calls, err


def free_cuda() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


SSD_PASSES = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
LM_GROUPS = (("B7 flash attention", ("flash_fwd_kernel",
                                     "flash_fwd_sm90_kernel")),
             ("B8 ssd", SSD_PASSES),
             ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
             # MoE routing, dispatch and combine: the top-k, the stable
             # sort and search of _positions_in_expert, the scatter into
             # the expert buffer and the gather back (ahead of
             # "elementwise": aten names its indexing kernels
             # index_elementwise_kernel).
             ("index, sort, top-k", ("index", "scatter", "gather", "sort",
                                     "radix", "searchsorted", "topk")),
             ("elementwise", ("elementwise", "vectorized", "unrolled")),
             ("reduce", ("reduce",)))


def ssd_pass_ms(calls: dict, flush: torch.Tensor, what: str) -> dict:
    """B8's three kernels timed one by one on the recorded call's operands
    (the wrapper's preparation of dt and l made beforehand, as are the
    states each pass reads); logs them beside the sum and the wrapper's
    preparation.  It runs after the main path's counts were read."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ref import prepare
    (x, dt, dA, bm, cm), kw = calls["ssd"]
    chunk, odt = kw["chunk"], kw.get("out_dtype") or x.dtype
    b, s, h, p = x.shape
    dtp, l = prepare(dt, dA, s, chunk)
    states = torch.empty(sk.workspace_shape(b, s, h, bm.shape[-1], p, chunk),
                         dtype=torch.float32, device="cuda")

    def states_ready():
        sk.chunk_state(x, dtp, l, bm, chunk, states)
        sk.state_pass(states, l, chunk)

    t = {"ssd_chunk_state": device_ms(
        lambda: sk.chunk_state(x, dtp, l, bm, chunk, states), flush, reps=5)}
    sk.chunk_state(x, dtp, l, bm, chunk, states)
    t["ssd_state_pass"] = device_ms(lambda: sk.state_pass(states, l, chunk),
                                    flush, reps=5)
    states_ready()
    t["ssd_chunk_scan"] = device_ms(
        lambda: sk.chunk_scan(x, dtp, l, bm, cm, chunk, states, odt), flush,
        reps=5)
    prep = device_ms(lambda: prepare(dt, dA, s, chunk), flush, reps=5)
    log(f"[lm prefill] ssd {what} by kernel: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; sum {sum(t.values()):.4f} ms; the wrapper's preparation of dt "
        f"and l {prep:.4f} ms")
    return t


def float32_step_time(cfg, params, batch, reps: int = 2) -> dict:
    """Wall and device time of the float32 prefill step on the kernel
    backend, already warmed up by the parity check: each of ``reps`` calls
    waited for, with CUDA events around it (a step of seconds dwarfs the
    host's time to enqueue it, so no sleep is needed ahead of it)."""
    from repro_torch.launch import make_prefill_step
    step = make_prefill_step(cfg, "kernel")
    walls, devs = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        step(params, batch)
        e1.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        devs.append(e0.elapsed_time(e1))
    wall, dev = statistics.median(walls), statistics.median(devs)
    b, s = batch["tokens"].shape
    log(f"[lm prefill] float32 step, B={b} S={s}: wall {wall:.2f} ms "
        f"(median of {reps}; {', '.join(f'{w:.2f}' for w in walls)}), "
        f"device {dev:.2f} ms (CUDA events), busy share {dev / wall:.4f}; "
        f"{b * s / wall * 1e3:.0f} prompt tokens/s")
    return {"wall_ms": wall, "device_ms": dev}


def phase_lm_prefill() -> dict:
    """zamba2-7b at full width and depth (D 3584, 81 Mamba2 layers, 13
    uses of 2 shared attention blocks, vocab 32,000), random weights from
    seed 0: the prefill step on both backends in float32 at B = 2 of
    S = 4096 and S = 3000 (13 B7 and 81 B8 launches per forward on the
    kernel backend), B7 and B8 held against their plain versions on the
    first shared block's and Mamba2 layer's operands, and ``generate`` held
    against the forward at the decode tolerance; then in bfloat16 the
    step's wall and device time, a profiled breakdown by kernel group,
    both kernels timed on the operands the step gives them, and
    ``generate`` again."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import init_params
    cfg = get_config("zamba2-7b")
    shapes = [InputShape("prefill", s, 2, "prefill") for s in LM_PREFILL_S]
    batches = [make_batch(cfg, sh, step=i, device="cuda")
               for i, sh in enumerate(shapes)]
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[lm prefill] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} "
        f"Mamba2 layers (H {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim}"
        f", P {cfg.ssm.head_dim}, N {cfg.ssm.d_state}, chunk "
        f"{cfg.ssm.chunk}), {cfg.hybrid.n_shared_blocks} shared blocks "
        f"({cfg.hybrid.shared_n_heads} heads of "
        f"{cfg.d_model // cfg.hybrid.shared_n_heads}), vocab "
        f"{cfg.vocab_size}: {n_params} parameters ({4 * n_params / 1e9:.2f} "
        f"GB float32), made in {time.perf_counter() - t0:.1f} s")
    out = {"launches": {"flash_attention": 0, "ssd": 0}, "err": {},
           "f32": {}}
    for i, batch in enumerate(batches):
        counts, calls, err = prefill_parity(cfg, params, batch, LM_PREFILL,
                                            "lm prefill")
        for k in out["launches"]:
            out["launches"][k] += counts[k]
        out["err"]["logits"] = max(out["err"].get("logits", 0.0), err)
        for k, e in check_recorded(calls, "lm prefill").items():
            out["err"][k] = max(out["err"].get(k, 0.0), e)
        if i == 0:                  # float32 step and kernel times at S = 4096
            out["f32_step"] = float32_step_time(cfg, params, batch)
            flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                device="cuda")
            for name, c in lm_kernel_closures(calls).items():
                t = {k: device_ms(c[k], flush, reps=5) if c[k] else None
                     for k in ("run", "ref", "lib")}
                out["f32"][name] = {
                    "ms": t["run"], "plain_ms": t["ref"],
                    "library_ms": t["lib"], "bound_ms": c["bound_ms"],
                    "bound_by": c["bound_by"]}
                lib = "none" if t["lib"] is None else f"{t['lib']:.4f} ms"
                log(f"[lm prefill] {name} float32 ({c['shape']}): kernel "
                    f"{t['run']:.4f} ms ({c['flops'] / t['run'] / 1e9:.2f} "
                    f"TFLOP/s of {c['flops'] / 1e9:.1f} GFLOP)  plain "
                    f"{t['ref']:.4f} ms  library {lib}  bound "
                    f"{c['bound_ms']:.4f} ms ({c['bound_by']}, 3xTF32 at 495 "
                    f"TFLOP/s TF32; "
                    f"on the CUDA cores {c['fma_bound_ms']:.4f} ms)")
            out["f32"]["ssd_passes"] = ssd_pass_ms(calls, flush, "float32")
        del calls
    # Decode in float32 (the SSM states and the shared blocks' KV slots) at
    # the reference's decode tolerance; the bfloat16 run below times it.
    out["generate_f32"] = generate_check(
        cfg, params, batches[0]["tokens"][:, :GEN_PROMPT], ZAMBA_GEN_NEW,
        DECODE_TOL, "lm prefill generate")
    del params
    free_cuda()

    # bfloat16: the same draws rounded (init draws float32, then casts).
    params = init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda", dtype=torch.bfloat16)
    batch = batches[0]
    step = make_prefill_step(cfg, "kernel")
    reset_launch_counts()
    with FirstCalls() as calls:
        logits = step(params, batch)          # warm-up, and the operands
    torch.cuda.synchronize()
    counts, by_kernel = launch_counts(), flash_kernel_launches()
    by_pass = ssd_kernel_launches()
    if not torch.isfinite(logits).all():
        raise AssertionError("[lm prefill] bfloat16 logits not finite")
    want = {"flash_fwd": 0, "flash_fwd_sm90": LM_PREFILL["flash_attention"]}
    if counts != times(LM_PREFILL, 1) or by_kernel != want \
            or by_pass != dict.fromkeys(SSD_PASSES, LM_PREFILL["ssd"]):
        raise AssertionError(f"[lm prefill] bfloat16 step: launches per "
                             f"forward {counts}, B7 by kernel {by_kernel}, B8 "
                             f"by kernel {by_pass}; expected "
                             f"{times(LM_PREFILL, 1)}, {want}, "
                             f"{LM_PREFILL['ssd']} of each B8 kernel")
    out["bf16_launches"] = {"flash_attention": by_kernel["flash_fwd_sm90"],
                            "ssd": counts["ssd"]}
    out["bf16_err"] = {}
    log(f"[lm prefill] bfloat16 step, B=2 S={LM_PREFILL_S[0]}: launches per "
        f"forward {counts}; B7 by kernel {by_kernel}; B8 by kernel {by_pass}")
    out["bf16_step"] = step_report(step, params, batch, "lm prefill")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    log(f"[lm prefill] kernel times in bfloat16 on the step's first "
        f"operands; bounds from {PEAKS_BF16}; card: "
        f"{gpu_name_and_power_limit()}")
    for name, t in recorded_times(calls, flush, "lm prefill").items():
        out["bf16_err"][name] = t.pop("max_abs_err")
        out[name] = t
    out["ssd_passes"] = ssd_pass_ms(calls, flush, "bfloat16 in")
    del calls, flush
    # Decode in bfloat16, for its time (float32 carries the tight check).
    out["generate"] = generate_check(
        cfg, params, batch["tokens"][:, :GEN_PROMPT], ZAMBA_GEN_NEW,
        LM_BF16_TOL, "lm prefill generate")
    del params
    free_cuda()
    return out


def step_report(step, params, batch, tag: str) -> dict:
    """Wall (median of 3 waited-for calls) and device time (CUDA events,
    L2 flushed) of a warmed-up prefill step, and a profiled breakdown of
    one call by kernel group (``LM_GROUPS``) with its busiest kernels."""
    from torch.profiler import ProfilerActivity, profile
    b, s = batch["tokens"].shape
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    dev = device_ms(lambda: step(params, batch), flush, reps=3)
    del flush
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    events = device_events(prof)
    prof_ms = sum(e.self_device_time_total for e in events) / 1e3
    assert prof_ms > 0, "the profiled step shows no device time"
    wall = statistics.median(walls)
    log(f"[{tag}] {params.embed.table.dtype} step, B={b} S={s}: wall "
        f"{wall:.2f} ms (median of 3; {', '.join(f'{w:.2f}' for w in walls)})"
        f", device {dev:.2f} ms (CUDA events, L2 flushed, median of 3), "
        f"profiled device time {prof_ms:.2f} ms, busy share "
        f"{prof_ms / wall:.4f}; {b * s / wall * 1e3:.0f} prompt tokens/s; "
        f"card {gpu_name_and_power_limit()}")
    groups = {name: 0.0 for name, _ in LM_GROUPS}
    groups["other"] = 0.0
    for e in events:
        key = e.key.lower()
        name = next((g for g, keys in LM_GROUPS
                     if any(k in key for k in keys)), "other")
        groups[name] += e.self_device_time_total / 1e3
    for name, ms in groups.items():
        log(f"[{tag}]   {name:28s} {ms:10.3f} ms ({ms / prof_ms:.3f})")
    if groups["B8 ssd"]:
        b8 = {k: sum(e.self_device_time_total for e in events
                     if k in e.key.lower()) / 1e3 for k in SSD_PASSES}
        log(f"[{tag}]   B8 by kernel: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in b8.items())
            + f"; sum {sum(b8.values()):.3f} ms against the group's "
            f"{groups['B8 ssd']:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:10.3f} ms "
            f"x{e.count:5d}  {e.key[:90]}")
    return {"wall_ms": wall, "device_ms": dev, "profiled_ms": prof_ms,
            "groups": groups}


def recorded_times(calls: dict, flush: torch.Tensor, tag: str,
                   dv: int | None = None) -> dict:
    """Each recorded kernel call held against its plain version (B8 also
    two calls bit-equal), then timed beside its plain version, the library
    yardstick and its bound (``dv`` as in ``lm_kernel_closures``) ->
    {name: ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err}."""
    out = {}
    for name, c in lm_kernel_closures(calls, dv).items():
        ok, err = within(c["run"](), c["ref"](), c["tol"])
        if not ok:
            raise AssertionError(f"[{tag}] {name} on the path's operands "
                                 f"({c['shape']}): max abs err {err}")
        if name == "ssd" and not torch.equal(c["run"](), c["run"]()):
            raise AssertionError(f"[{tag}] ssd on the path's operands: two "
                                 f"calls differ")
        t = {k: device_ms(c[k], flush, reps=5) if c[k] else None
             for k in ("run", "ref", "lib")}
        out[name] = {"ms": t["run"], "plain_ms": t["ref"],
                     "library_ms": t["lib"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "max_abs_err": err}
        lib = "none" if t["lib"] is None else f"{t['lib']:.4f} ms"
        log(f"[{tag}] {name} ({c['shape']}): kernel {t['run']:.4f} ms "
            f"({c['flops'] / t['run'] / 1e9:.2f} TFLOP/s)  "
            f"plain {t['ref']:.4f} ms  library {lib}  bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}); max abs err vs plain "
            f"{err!r} (tol {c['tol']})")
    return out


class StepLogits:
    """Within the block, keeps a copy of the last position's logits of
    every decode step (``transformer.decode_step``, which the decode step
    of ``make_decode_step`` calls), in order."""

    def __enter__(self):
        from repro_torch.models import transformer
        self.mod, self.saved, self.logits = transformer, \
            transformer.decode_step, []

        def rec(*args, **kw):
            logits, cache = self.saved(*args, **kw)
            self.logits.append(logits[:, -1].clone())
            return logits, cache
        transformer.decode_step = rec
        return self.logits

    def __exit__(self, *exc):
        self.mod.decode_step = self.saved


def generate_check(cfg, params, prompts, new: int, tol: float,
                   tag: str) -> dict:
    """Greedy ``generate`` of ``new`` tokens after ``prompts``, its cache
    in the parameters' dtype: no B1-B8 launch (decode runs none); the
    synchronising CUDA calls it makes (``torch.cuda.set_sync_debug_mode``);
    each new token the argmax of its step's logits; every step's logits
    (prompt and new tokens) held against ``forward`` over the generated
    sequence (teacher forcing) within ``tol`` of the largest, argmax equal
    on the decisive rows; then one decode step profiled for its device
    operations and time."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import make_decode_step
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward, init_cache
    dtype = params.embed.table.dtype
    b, s0 = prompts.shape
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                StepLogits() as steps:
            warnings.simplefilter("always")
            gen = generate(cfg, params, prompts, max_new_tokens=new,
                           dtype=dtype)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    counts = launch_counts()
    tokens = gen["tokens"]
    got = torch.stack(steps, dim=1)                       # (B, S, V)
    if any(counts.values()) or tuple(tokens.shape) != (b, s0 + new) \
            or got.shape[1] != s0 + new:
        raise AssertionError(f"[{tag}] launches {counts}, tokens "
                             f"{tuple(tokens.shape)}, {got.shape[1]} steps")
    if not torch.equal(tokens[:, s0:], got[:, s0 - 1:-1].argmax(-1)):
        raise AssertionError(f"[{tag}] a new token is not its step's argmax")
    want = forward(params, cfg, {"tokens": tokens})
    rows = (got - want).abs().amax(-1)
    err, scale = float(rows.max()), float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * rows
    agree = got.argmax(-1) == want.argmax(-1)
    ms_step = 1e3 * b / gen["decode_tps"]
    log(f"[{tag}] {cfg.name} {dtype}, B={b}, prompt {s0}, {new} new: "
        f"decode {gen['decode_tps']:.1f} tokens/s, {ms_step:.3f} ms a step "
        f"({ms_step / b:.3f} ms a token); {syncs} synchronising calls in "
        f"{s0 + new} steps ({syncs / new:.3f} per new token); each step's "
        f"logits vs the teacher-forced forward: max abs err {err!r} (max "
        f"|logit| {scale:.4f}, tol {tol} of max(1, |logit|)); argmax agree "
        f"on {int(agree.sum())}/{agree.numel()} rows "
        f"({int(decisive.sum())} decisive)")
    if not torch.isfinite(got).all() or err > tol * max(1.0, scale) \
            or not bool(agree[decisive].all()):
        raise AssertionError(f"[{tag}] decode disagrees with the forward: "
                             f"max abs err {err}")
    step = make_decode_step(cfg)
    cache = init_cache(cfg, b, s0 + new, dtype, device="cuda")
    nxt = {"tokens": tokens[:, -1:]}
    step(params, nxt, cache, s0 + new - 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, nxt, cache, s0 + new - 1)
        torch.cuda.synchronize()
    events = device_events(prof)
    ops = sum(e.count for e in events)
    dev = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[{tag}] one decode step (pos {s0 + new - 1}): {ops} device "
        f"operations, {dev:.3f} ms of device time against {ms_step:.3f} ms "
        f"of wall (busy {dev / ms_step:.4f}); B1-B8 launches 0")
    return {"decode_tps": gen["decode_tps"], "ms_step": ms_step,
            "syncs": syncs, "err": err, "ops_step": ops, "device_ms": dev,
            "tokens": tokens, "steps": got, "forward": want}


def phase_lm_widths() -> dict:
    """Two more configurations at full width, depth cut: gemma-2b (dh 256,
    MQA, gelu, tied 256,000 vocab) and mamba2-1.3b (N 128): the prefill
    step on both backends in float32, launch counts per forward, and B7 or
    B8 held against its plain version on the first call's operands."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import make_batch
    from repro_torch.models import init_params
    out = {"launches": {"flash_attention": 0, "ssd": 0}, "err": {}}
    for arch, depth, b, s, expect in LM_WIDTHS:
        full = get_config(arch)
        cfg = replace(full, n_layers=depth)
        log(f"[lm widths] {arch}: full width (d_model {cfg.d_model}), depth "
            f"cut from {full.n_layers} to {depth} layers; B={b} S={s}")
        params = init_params(cfg, generator=torch.Generator(
            "cuda").manual_seed(1), device="cuda", dtype=torch.float32)
        batch = make_batch(cfg, InputShape("prefill", s, b, "prefill"),
                           device="cuda")
        counts, calls, err = prefill_parity(cfg, params, batch, expect,
                                            "lm widths")
        for k in out["launches"]:
            out["launches"][k] += counts[k]
        for k, e in check_recorded(calls, "lm widths").items():
            out["err"][k] = max(out["err"].get(k, 0.0), e)
        del calls
        generate_check(cfg, params, batch["tokens"][:, :WIDTHS_PROMPT],
                       WIDTHS_NEW, DECODE_TOL, "lm widths generate")
        del params
        free_cuda()
    return out


def phase_lm_moe() -> dict:
    """deepseek-v2-lite-16b (cell (o)): MLA and MoE.  First at full width
    cut to its dense layer and 3 MoE layers in float32: the prefill step
    on both backends at B = 2, S = 4096 (B7 ``flash_fwd`` once a layer),
    B7 held against its plain version on the first MLA layer's operands.
    Then at full width and depth in bfloat16, weights from seed 0: the
    prefill step on both backends (27 B7 launches, all
    ``flash_fwd_sm90``), B7 held against its plain version and timed on
    the first MLA layer's operands (dh 192, v padded from 128), the step's
    wall and device time and profiled breakdown, and ``generate`` of 32
    tokens after a 64-token prompt, each step held against the forward.
    Last the same weights in float32 at full depth: the prefill step on
    both backends, ``generate`` held against the forward at the
    reference's decode tolerance, and the
    bfloat16 run's logits against the float32 forward of its tokens."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import forward, init_params
    full = get_config(MOE_ARCH)
    batch = make_batch(full, InputShape("prefill", LM_PREFILL_S[0], 2,
                                        "prefill"), device="cuda")
    prompts = batch["tokens"][:, :GEN_PROMPT]
    out = {"err": {}}

    def made(cfg, dtype):
        gen = torch.Generator("cuda").manual_seed(0)
        return init_params(cfg, generator=gen, device="cuda", dtype=dtype)

    cfg = replace(full, n_layers=MOE_F32_DEPTH)
    params = made(cfg, torch.float32)
    log(f"[lm moe] {cfg.name} float32, depth cut from {full.n_layers} to "
        f"{cfg.n_layers} layers ({cfg.moe.first_dense_layers} dense, "
        f"{cfg.n_layers - cfg.moe.first_dense_layers} MoE) at full width")
    counts, calls, err = prefill_parity(
        cfg, params, batch, {"flash_attention": MOE_F32_DEPTH}, "lm moe")
    out["f32_launches"] = counts["flash_attention"]
    out["err"]["logits_f32"] = err
    out["err"]["flash_attention_f32"] = check_recorded(
        calls, "lm moe")["flash_attention"]
    del params, calls
    free_cuda()

    t0 = time.perf_counter()
    params = made(full, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    m, e = full.mla, full.moe
    log(f"[lm moe] {full.name}: d_model {full.d_model}, {full.n_layers} "
        f"layers ({e.first_dense_layers} dense), {full.n_heads} MLA heads "
        f"(kv rank {m.kv_lora_rank}, q/k {m.qk_nope_head_dim} + "
        f"{m.qk_rope_head_dim}, v {m.v_head_dim}), {e.n_routed} experts of "
        f"{e.d_expert} + {e.n_shared} shared, top {e.top_k}, vocab "
        f"{full.vocab_size}: {n_params} parameters "
        f"({2 * n_params / 1e9:.2f} GB bfloat16; param_count() "
        f"{full.param_count()[0]} leaves out the norm scales), made in "
        f"{time.perf_counter() - t0:.1f} s")
    if n_params != MOE_PARAMS:
        raise AssertionError(f"[lm moe] {n_params} parameters, expected "
                             f"{MOE_PARAMS}")
    counts, calls, err = prefill_parity(full, params, batch, MOE_PREFILL,
                                        "lm moe", tol=LM_BF16_TOL)
    out["bf16_launches"] = counts["flash_attention"]
    out["err"]["logits_bf16"] = err
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    log(f"[lm moe] B7 on the first MLA layer's operands (v padded to q's "
        f"192 columns; SDPA on the same padded call; the bound counts v's "
        f"{m.v_head_dim} columns); bounds from "
        f"{PEAKS_BF16}; card: {gpu_name_and_power_limit()}")
    out["flash_attention"] = recorded_times(
        calls, flush, "lm moe", dv=m.v_head_dim)["flash_attention"]
    del calls, flush
    out["bf16_step"] = step_report(make_prefill_step(full, "kernel"), params,
                                   batch, "lm moe")
    gen = generate_check(dropless(full), params, prompts, GEN_NEW,
                         LM_BF16_TOL, "lm moe generate")
    del params
    free_cuda()

    params = made(full, torch.float32)
    log(f"[lm moe] {full.name} float32 at full depth: "
        f"{4 * n_params / 1e9:.2f} GB")
    counts, calls, err = prefill_parity(full, params, batch, MOE_PREFILL,
                                        "lm moe")
    out["f32_launches"] += counts["flash_attention"]
    out["err"]["logits_f32"] = max(out["err"]["logits_f32"], err)
    del calls
    out["f32_generate"] = generate_check(dropless(full), params, prompts,
                                         GEN_NEW, DECODE_TOL,
                                         "lm moe generate")
    want = forward(params, dropless(full), {"tokens": gen["tokens"]})
    log(f"[lm moe] the bfloat16 run's logits against the float32 forward of "
        f"its tokens (the same draws, unrounded): forward max abs err "
        f"{float((gen['forward'] - want).abs().max())!r}, decode steps "
        f"{float((gen['steps'] - want).abs().max())!r} (max |logit| "
        f"{float(want.abs().max()):.4f})")
    out["generate"] = {k: v for k, v in gen.items()
                       if not isinstance(v, torch.Tensor)}
    del params, gen, want
    free_cuda()
    return out


def tree_items(tree) -> list:
    """(dotted path, leaf) of a tree of nested dicts and lists."""
    from repro_torch.convert import _flatten
    out = {}
    _flatten(tree, "", out, leaf=lambda t: t)
    return list(out.items())


def hold_train_step(params, state, want_params, want_state, before,
                    lr: float, tag: str) -> dict:
    """The card's parameters and AdamW state after one step against the
    CPU's, at the tolerances above ``TRAIN_LOSS_RTOL``, compared on the
    card (``before``: the parameters' tree before the step, there too);
    |g| is read from the CPU's first moment (0.1 g times the clip scale
    after one step).  Returns the largest relative errors by kind."""
    from repro_torch.convert import lm_params_to_tree
    got = dict(tree_items(state))
    want = dict(tree_items(want_state))
    if got.keys() != want.keys() or int(got["step"]) != int(want["step"]):
        raise AssertionError(f"[{tag}] the states' trees or steps differ")
    worst = {}
    for path, w in want.items():
        if path == "step":
            continue
        kind = path.rsplit(".", 1)[1]
        g, w = got[path].float(), w.to("cuda", torch.float32)
        atol = 1e-3 * float(w.abs().max())
        rtol = 2e-3 if kind in ("v", "vr", "vc") else 1e-3
        err = (g - w).abs()
        if not bool((err <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"[{tag}] {path}: max abs err "
                                 f"{float(err.max())} (atol {atol})")
        worst[kind] = max(worst.get(kind, 0.0),
                          float((err / (atol + w.abs())).max()))
    moved = dict(tree_items(lm_params_to_tree(params)))
    n_small, small_err = 0, 0.0
    for path, w in tree_items(lm_params_to_tree(want_params)):
        g, w = moved[path].float(), w.to("cuda", torch.float32)
        m = want[f"leaves.{path}.m"].to("cuda").abs()
        small = m < 1e-3 * m.max()
        n_small += int(small.sum())
        err = (g - w).abs()
        ok = torch.where(small, err <= TRAIN_SMALL_G_TOL * lr,
                         err <= 1e-6 + 1e-4 * w.abs())
        if not bool(ok.all()) or not bool(
                ((g - before[path]).abs()[small] <= 2 * lr).all()):
            raise AssertionError(f"[{tag}] parameter {path}: max abs err "
                                 f"{float(err[~small].max())}, where |g| "
                                 f"is small {float(err[small].max())}")
        worst["params"] = max(worst.get("params", 0.0),
                              float(err[~small].max()))
        if small.any():
            small_err = max(small_err, float(err[small].max()))
    worst["small_g_elements"] = n_small
    worst["small_g_params"] = small_err
    return worst


def lm_train_parity() -> dict:
    """(a) gemma-2b at full width cut to 2 layers, the same float32 weights
    on the card and on the CPU: one ``make_train_step`` step (AdamW, lr
    1e-3, weight decay 0.1, 2 microbatches) at B = 2, S = 128, the card
    against the CPU."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.convert import lm_params_to_tree
    from repro_torch.data import make_batch
    from repro_torch.launch import make_train_step
    from repro_torch.models import LM, init_params
    from repro_torch.optim import OptConfig, opt_init
    cfg = replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CUT)
    opt = OptConfig(lr=1e-3, weight_decay=0.1)
    card = init_params(cfg, generator=torch.Generator("cuda").manual_seed(2),
                       device="cuda", dtype=torch.float32)
    cpu = LM(cfg, torch.float32, "cpu")
    cpu.load_state_dict(card.state_dict())
    before = {k: v.clone() for k, v in tree_items(lm_params_to_tree(card))}
    batch = make_batch(cfg, InputShape("train", TRAIN_PARITY_S,
                                       TRAIN_PARITY_B, "train"), device="cpu")
    step = make_train_step(cfg, opt, microbatches=2)
    out = {}
    for name, lm in (("card", card), ("cpu", cpu)):
        device = next(lm.parameters()).device
        state = opt_init(lm, opt)
        t0 = time.perf_counter()
        _, state, m = step(lm, state, {k: v.to(device)
                                       for k, v in batch.items()})
        out[name] = (float(m["loss"]), float(m["grad_norm"]), state,
                     time.perf_counter() - t0)
    (loss, gnorm, state, dt_card), (want_loss, want_norm, want_state,
                                    dt_cpu) = out["card"], out["cpu"]
    worst = hold_train_step(card, state, cpu, want_state, before, opt.lr,
                            "lm train parity")
    log(f"[lm train parity] {cfg.name} at full width, {cfg.n_layers} of 18 "
        f"layers ({sum(p.numel() for p in cpu.parameters())} parameters), "
        f"B={TRAIN_PARITY_B} S={TRAIN_PARITY_S}, 2 microbatches, one step: "
        f"loss card {loss!r} cpu {want_loss!r} (rel err "
        f"{abs(loss / want_loss - 1):.3e}, tol {TRAIN_LOSS_RTOL}); grad "
        f"norm card {gnorm!r} cpu {want_norm!r} (rel err "
        f"{abs(gnorm / want_norm - 1):.3e}, tol {TRAIN_NORM_RTOL}); worst "
        f"state and parameter errors {worst} (small_g_params: the largest "
        f"|card - cpu| of a new parameter where |g| is small, limit "
        f"{TRAIN_SMALL_G_TOL * opt.lr!r}); step {dt_card:.2f} s on the "
        f"card, {dt_cpu:.2f} s on the CPU")
    if abs(loss / want_loss - 1) > TRAIN_LOSS_RTOL \
            or abs(gnorm / want_norm - 1) > TRAIN_NORM_RTOL:
        raise AssertionError("[lm train parity] loss or norm off")
    return {"loss": loss, "grad_norm": gnorm, **worst}


def train_breakdown(prof) -> dict:
    """Device ms of a profiled training step by group: AdamW (kernels
    launched inside its range), the remat recompute (block forwards run
    inside the backward), cross-entropy with the logits and the attention
    scan (forward kernels inside their ranges, backward kernels whose
    autograd node's forward op was), then the rest by kernel name
    (matmul, other); plus the forward/backward/AdamW split and the
    matmuls of every group."""
    from torch.autograd import DeviceType
    bwd_prefix = "autograd::engine::evaluate_function"
    fwd_scope, launched = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        names, bwd, p = [], None, e.cpu_parent
        while p is not None:
            names.append(p.name)
            if bwd is None and p.name.startswith(bwd_prefix):
                bwd = p
            p = p.cpu_parent
        scope = next((n for n in names if n in TRAIN_SCOPES), None)
        if bwd is None and e.sequence_nr >= 0 and scope is not None:
            fwd_scope.setdefault(e.sequence_nr, scope)
        if e.kernels:
            launched.append((e, names, bwd, scope))
    groups, phases = {}, {"forward": 0.0, "backward": 0.0, "AdamW": 0.0}
    matmul_all = 0.0
    for e, names, bwd, scope in launched:
        if "mrsch.lm.adamw" in names:
            group, phase = TRAIN_SCOPES["mrsch.lm.adamw"], "AdamW"
        elif bwd is not None and TRAIN_BLOCK_SCOPE in names:
            group, phase = "remat recompute", "backward"
        elif bwd is not None:
            group = TRAIN_SCOPES.get(fwd_scope.get(bwd.sequence_nr))
            phase = "backward"
        else:
            group, phase = TRAIN_SCOPES.get(scope), "forward"
        for k in e.kernels:
            if k.name in TRAIN_SCOPES or k.name == TRAIN_BLOCK_SCOPE:
                continue                # a range's device-side copy
            ms = k.duration / 1e3
            is_mm = any(key in k.name.lower() for key in MATMUL_KERNELS)
            name = group or ("matmul" if is_mm else "other")
            groups[name] = groups.get(name, 0.0) + ms
            phases[phase] += ms
            matmul_all += ms if is_mm else 0.0
    return {"groups": groups, "phases": phases, "matmul_all": matmul_all}


def lm_train_whole() -> dict:
    """(b) gemma-2b whole: a 4-step ``train_loop`` at B = 1, S = 4096
    (every loss finite), then 4 ``make_train_step`` steps at a constant lr
    of 1e-4 on one batch (the loss falls at every step), the first three
    timed, the last profiled and broken down by group; peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_params
    from repro_torch.optim import OptConfig, opt_init
    cfg = get_config(TRAIN_ARCH)
    shape = InputShape("train", TRAIN_S, TRAIN_B, "train")
    card = gpu_name_and_power_limit()
    t0 = time.perf_counter()
    run = train_loop(cfg, shape, steps=TRAIN_STEPS, ckpt_dir=None,
                     log_every=1)
    loop_s = time.perf_counter() - t0
    log(f"[lm train] train_loop of {cfg.name} ({cfg.n_layers} layers), "
        f"B={TRAIN_B} "
        f"S={TRAIN_S}, {run.steps} steps (cosine, warmup 1, peak 1e-3): "
        f"losses {run.losses}, {loop_s:.1f} s with the parameters' "
        f"initialisation; card {card}")
    if run.steps != TRAIN_STEPS or len(run.losses) != TRAIN_STEPS \
            or not all(math.isfinite(x) for x in run.losses):
        raise AssertionError(f"[lm train] train_loop: {run}")
    free_cuda()
    params = init_params(cfg, generator=torch.Generator("cuda").manual_seed(1),
                         device="cuda", dtype=torch.float32)
    n_params = sum(p.numel() for p in params.parameters())
    opt = OptConfig(lr=TRAIN_FALL_LR)
    state = opt_init(params, opt)
    step = make_train_step(cfg, opt)
    batch = make_batch(cfg, shape, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, devs = [], [], []
    prof = None
    for i in range(TRAIN_STEPS):
        profiled = i == TRAIN_STEPS - 1
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        e0.record()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, state, m = step(params, state, batch)
                torch.cuda.synchronize()
        else:
            params, state, m = step(params, state, batch)
        e1.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        devs.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    from torch.autograd import DeviceType
    ranges = [e.name for e in prof.events()       # not the device copies
              if e.device_type == DeviceType.CPU
              and e.name.startswith("mrsch.lm.")]
    opened = {n: ranges.count(n) for n in (*TRAIN_SCOPES, TRAIN_BLOCK_SCOPE)}
    log(f"[lm train] the profiled step's ranges: {opened}")
    if not all(opened.values()) \
            or opened[TRAIN_BLOCK_SCOPE] != 2 * cfg.n_layers:
        raise AssertionError(f"[lm train] a range of the step is missing "
                             f"from the profile (each block's twice: "
                             f"forward and recompute): {opened}")
    wall, dev = statistics.median(walls[:-1]), statistics.median(devs[:-1])
    kernels_ms = sum(e.self_device_time_total
                     for e in device_events(prof)) / 1e3
    split = train_breakdown(prof)
    attributed = sum(split["groups"].values())
    log(f"[lm train] {cfg.name} whole: {n_params} parameters "
        f"({4 * n_params / 1e9:.2f} GB float32; with gradients, m and v "
        f"{16 * n_params / 1e9:.2f} GB), B={TRAIN_B} S={TRAIN_S}, remat on, "
        f"lr {TRAIN_FALL_LR} constant, one batch: losses {losses}; step wall "
        f"{wall:.2f} ms (median of steps 0-{TRAIN_STEPS - 2}: "
        f"{', '.join(f'{w:.2f}' for w in walls[:-1])}), device "
        f"{dev:.2f} ms (CUDA events around the step), "
        f"{TRAIN_B * TRAIN_S / wall * 1e3:.1f} tokens/s; profiled step "
        f"{walls[-1]:.2f} ms wall, its kernels {kernels_ms:.2f} ms, busy "
        f"share {kernels_ms / wall:.4f} of the unprofiled step's wall; peak "
        f"memory {peak} bytes ({peak / 2**30:.2f} GiB, "
        f"torch.cuda.max_memory_allocated); card {card}")
    log(f"[lm train]   by phase: " + ", ".join(
        f"{k} {v:.3f} ms ({v / kernels_ms:.3f})"
        for k, v in split["phases"].items())
        + f"; matmul kernels in every phase {split['matmul_all']:.3f} ms "
        f"({split['matmul_all'] / kernels_ms:.3f})")
    for name, ms in sorted(split["groups"].items(), key=lambda kv: -kv[1]):
        log(f"[lm train]   {name:32s} {ms:10.3f} ms ({ms / kernels_ms:.3f})")
    log(f"[lm train]   attributed {attributed:.3f} ms of the kernels' "
        f"{kernels_ms:.3f} ms (the host ops' linked kernels against the "
        f"trace's device records)")
    for e in sorted(device_events(prof),
                    key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[lm train]   {e.self_device_time_total / 1e3:10.3f} ms "
            f"x{e.count:5d}  {e.key[:90]}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"[lm train] the loss did not fall at every "
                             f"step: {losses}")
    del params, state, prof
    return {"losses": losses, "wall_ms": wall, "device_ms": dev,
            "kernels_ms": kernels_ms, "peak_bytes": peak,
            "tokens_per_s": TRAIN_B * TRAIN_S / wall * 1e3, **split}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def lm_train_resume() -> dict:
    """(c) the cut gemma-2b of (a), AdamW factored with a bfloat16 first
    moment: an uninterrupted 4-step ``train_loop`` (checkpoints every 2
    steps) against 2 steps, then a second ``train_loop`` to 4 steps that
    resumes from the first's checkpoint: restored from step 2, 2 steps
    run, losses at steps 2 and 3 within ``TRAIN_RESUME_RTOL``."""
    import shutil
    import tempfile

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import OptConfig
    cfg = replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CUT)
    shape = InputShape("train", TRAIN_PARITY_S, TRAIN_PARITY_B, "train")
    opt = OptConfig(factored=True, m_dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as root:
        a, b = os.path.join(root, "a"), os.path.join(root, "b")
        t0 = time.perf_counter()
        whole = train_loop(cfg, shape, steps=4, ckpt_dir=a, ckpt_every=2,
                           opt=opt, log_every=1)
        t_whole = time.perf_counter() - t0
        size = dir_bytes(os.path.join(a, "step_00000004"))
        shutil.rmtree(a)
        t0 = time.perf_counter()
        first = train_loop(cfg, shape, steps=2, ckpt_dir=b, ckpt_every=2,
                           opt=opt, log_every=1)
        t1 = time.perf_counter()
        resumed = train_loop(cfg, shape, steps=4, ckpt_dir=b, ckpt_every=2,
                             opt=opt, log_every=1)
        t2 = time.perf_counter()
    errs = [abs(x / y - 1) for x, y in zip(resumed.losses, whole.losses[2:])]
    log(f"[lm train resume] {cfg.name} at {cfg.n_layers} layers, factored "
        f"v, bfloat16 m: a checkpoint is {size} bytes ({size / 2**30:.2f} "
        f"GiB); uninterrupted 4 steps {t_whole:.1f} s (2 checkpoints), "
        f"2 steps {t1 - t0:.1f} s, resumed 2 steps {t2 - t1:.1f} s "
        f"(restored from {resumed.restored_from}, {resumed.steps} steps); "
        f"losses {whole.losses} against {first.losses} + {resumed.losses}: "
        f"max rel err {max(errs):.3e} (tol {TRAIN_RESUME_RTOL}); card "
        f"{gpu_name_and_power_limit()}")
    if resumed.restored_from != 2 or resumed.steps != 2 \
            or first.losses != whole.losses[:2] \
            or max(errs) > TRAIN_RESUME_RTOL:
        raise AssertionError("[lm train resume] the resumed run differs")
    return {"bytes": size, "max_rel_err": max(errs)}


def lm_train_families() -> dict:
    """(d) deepseek-v2-lite-16b (its dense layer and 2 MLA + MoE layers)
    and zamba2-7b (6 Mamba2 layers, one use of a shared block) at full
    width, B = 1, S = 4096: the loss and every gradient finite, a leaf the
    forward does not reach without one (zamba2-7b's second shared block),
    the router's gradient nonzero and each expert's nonzero exactly when
    a kept choice routed a token to it; then 2 ``make_train_step`` steps
    with finite losses."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import make_train_step
    from repro_torch.models import init_params, moe, transformer
    from repro_torch.optim import OptConfig, opt_init
    out = {}
    for arch, depth in TRAIN_FAMILIES:
        cfg = replace(get_config(arch), n_layers=depth)
        params = init_params(cfg, generator=torch.Generator(
            "cuda").manual_seed(3), device="cuda", dtype=torch.float32)
        batch = make_batch(cfg, InputShape("train", TRAIN_S, TRAIN_B,
                                           "train"), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        routed = {}
        apply = moe.moe_apply

        def record(p, x, mcfg, *args, **kw):
            with torch.no_grad():
                flat = x.reshape(-1, x.shape[-1])
                _, idx = moe.route(p.router, flat, mcfg)
                keep = moe._positions_in_expert(idx, mcfg.n_routed) \
                    < moe._default_capacity(flat.shape[0], mcfg)
                routed[id(p)] = (p, set(idx[keep].unique().tolist()))
            return apply(p, x, mcfg, *args, **kw)
        params.requires_grad_(True)
        named = list(params.named_parameters())
        moe.moe_apply = record
        try:
            t0 = time.perf_counter()
            loss = transformer.loss(params, cfg, batch)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True)
            torch.cuda.synchronize()
            t_grad = time.perf_counter() - t0
        finally:
            moe.moe_apply = apply
        n_moe = sum(isinstance(m, moe.MoE) for m in params.modules())
        if len(routed) != n_moe:
            raise AssertionError(f"[lm train families] {arch}: routing read "
                                 f"in {len(routed)} of {n_moe} MoE layers")
        by_param = {id(p): g for (_, p), g in zip(named, grads)}
        unreached = [n for (n, _), g in zip(named, grads) if g is None]
        bad = [n for (n, _), g in zip(named, grads)
               if g is not None and not bool(torch.isfinite(g).all())]
        experts = []
        for p, used in routed.values():
            if not bool(by_param[id(p.router)].abs().max() > 0):
                bad.append("router")
            for w in (p.w_up, p.w_gate, p.w_down):
                nonzero = by_param[id(w)].flatten(1).abs().amax(1) > 0
                got = set(torch.nonzero(nonzero).flatten().tolist())
                if got != used:
                    bad.append(f"experts {sorted(got ^ used)}")
            experts.append(len(used))
        n_params = sum(p.numel() for _, p in named)
        del grads, by_param, routed
        opt = OptConfig()
        state = opt_init(params, opt)
        step = make_train_step(cfg, opt)
        losses = [float(loss.detach())]
        for _ in range(2):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        log(f"[lm train families] {cfg.name} at full width, {depth} layers "
            f"({n_params} parameters), B={TRAIN_B} S={TRAIN_S}: loss "
            f"{losses[0]!r}, gradients finite but {bad or 'none'}, "
            f"{len(unreached)} leaves unreached {unreached[:4]}; experts "
            f"with tokens per MoE layer {experts or 'no MoE'}; loss and "
            f"gradients {t_grad:.2f} s; 2 train steps' losses "
            f"{losses[1:]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
            f"{gpu_name_and_power_limit()}")
        if bad or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[lm train families] {arch}: {bad}, "
                                 f"{losses}")
        out[arch] = {"losses": losses, "unreached": unreached}
        del params, state, loss
        free_cuda()
    return out


def lm_train_guard() -> None:
    """(e) with grad mode on and parameters that require grad, the kernel
    backend's forward raises B7's (gemma-2b, one layer, S = 4096) and B8's
    (mamba2-1.3b, one layer, S = 256) ``RuntimeError`` before launching."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import make_batch
    from repro_torch.models import forward, init_params
    for arch, s, kernel in (("gemma-2b", TRAIN_S, "B7"),
                            ("mamba2-1.3b", 256, "B8")):
        cfg = replace(get_config(arch), n_layers=1)
        params = init_params(cfg, device="cuda", dtype=torch.float32)
        params.requires_grad_(True)
        batch = make_batch(cfg, InputShape("prefill", s, 1, "prefill"),
                           device="cuda")
        reset_launch_counts()
        try:
            forward(params, cfg, batch, backend="kernel")
        except RuntimeError as e:
            if f"{kernel} is forward-only" not in str(e):
                raise
            msg = str(e)
        else:
            raise AssertionError(f"[lm train guard] {arch}: no error")
        counts = launch_counts()
        if any(counts.values()):
            raise AssertionError(f"[lm train guard] launches {counts}")
        log(f"[lm train guard] {arch} forward on the kernel backend with "
            f"grad on: RuntimeError ({msg}); 0 launches")
        del params
        free_cuda()


def phase_lm_train() -> dict:
    """Phase 24: LM training on the card (``TRAIN_*``): (a) card against
    CPU, (b) gemma-2b whole, (c) resume, (d) the other families, (e) the
    guard.  The card is freed after each part, whose seconds it logs."""
    out = {}
    for name, part in (("parity", lm_train_parity), ("whole", lm_train_whole),
                       ("resume", lm_train_resume),
                       ("families", lm_train_families),
                       ("guard", lm_train_guard)):
        t0 = time.perf_counter()
        out[name] = part()
        free_cuda()
        log(f"[lm train] part {name}: {time.perf_counter() - t0:.1f} s")
    return out


def dropless(cfg):
    """``cfg`` with MoE capacity factor 16, dropless at the decode checks'
    sizes: which choices are dropped depends on how many tokens a call
    routes, so it would differ between a step of B tokens and a forward of
    B x S (the reference's test_decode_matches_forward does the same)."""
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=GEN_CAPACITY))


# ------------------------------------------------ phase 25: the fleet
FLEET_KERNELS = {"fused_mlp_forward": "forward", "fused_mlp_dgrad": "dgrad",
                 "fused_mlp_wgrad": "wgrad"}
FLEET_JOBS, FLEET_SEED = 150, 1000          # scheduler.main's defaults
FLEET_SAMPLED = 64
# The M the fleet path gives B1 (one decision, a service-sized batch, a
# minibatch of ``fleet_agent_config``'s 48) and B2/B3 (the minibatch).
FLEET_FWD_M, FLEET_BWD_M = (1, 16, 48), (48,)


def sample_greedy_rows(agent, every: int = 5) -> list:
    """Wrap ``agent.select`` (until ``del agent.select``) so every
    ``every``-th greedy decision's packed row and served action are kept,
    up to ``FLEET_SAMPLED``."""
    from repro_torch.core.encoding import (decision_row_dim,
                                           encode_decision_row)
    sampled, n = [], [0]
    select = agent.select

    def recording(ctx):
        action = select(ctx)
        n[0] += 1
        if n[0] % every == 0 and len(sampled) < FLEET_SAMPLED:
            w = agent.config.window
            row = np.zeros(decision_row_dim(agent.enc, w), np.float32)
            encode_decision_row(agent.enc, ctx, w, out=row)
            sampled.append((row, action))
        return action

    agent.select = recording
    return sampled


def check_fleet_layers(agent) -> dict:
    """B1 at the fleet net's layer shapes (``forward_layers``) and the
    path's M (``FLEET_FWD_M``), within ``TOL``, and B2/B3 at its
    minibatch (``FLEET_BWD_M``), within ``BWD_TOL``, against their plain
    versions on the card, both dtypes, all activations; returns the worst
    float32 absolute error per kind."""
    from repro_torch.kernels.fused_mlp import (ACTIVATIONS, fused_mlp,
                                               fused_mlp_layer_ref)
    gen = torch.Generator(device="cuda").manual_seed(25)
    layers = forward_layers(agent.net)
    fwd = {dtype: 0.0 for dtype in TOL}
    cases = 0
    for k, n, _ in layers:
        w32 = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        b32 = 0.1 * torch.randn(n, generator=gen, device="cuda")
        for dtype, tol in TOL.items():
            w, b = w32.to(dtype), b32.to(dtype)
            for m in FLEET_FWD_M:
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                for act in ACTIVATIONS:
                    with torch.no_grad():
                        y = fused_mlp(x, w, b, activation=act).float()
                        r = fused_mlp_layer_ref(x, w, b, act).float()
                    err = (y - r).abs()
                    bad = err > tol + tol * r.abs()
                    if bad.any():
                        raise AssertionError(
                            f"[fleet parity] forward K={k} N={n} M={m} "
                            f"{dtype} {act}: {int(bad.sum())} elements off, "
                            f"max abs err {float(err.max())}")
                    fwd[dtype] = max(fwd[dtype], float(err.max()))
                    cases += 1
    worst = {(k, d): 0.0 for k in ("dgrad", "wgrad") for d in BWD_TOL}
    bwd = layer_grad_cases(layers, FLEET_BWD_M, gen, worst, "fleet ")
    torch.cuda.synchronize()
    shapes = sorted({(k, n) for k, n, _ in layers})
    log(f"[fleet parity] the fleet net's {len(layers)} layers {shapes}: "
        f"{cases} forward cases (M {FLEET_FWD_M}) and {bwd} dgrad/wgrad "
        f"cases (M {FLEET_BWD_M}), 2 dtypes x 4 activations, pass; worst "
        f"abs err float32 forward {fwd[torch.float32]!r} (tol 2e-4), dgrad "
        f"{worst['dgrad', torch.float32]!r}, wgrad "
        f"{worst['wgrad', torch.float32]!r} (rtol 1e-3, atol 1e-4); "
        f"bfloat16 forward {fwd[torch.bfloat16]!r}, dgrad "
        f"{worst['dgrad', torch.bfloat16]!r}, wgrad "
        f"{worst['wgrad', torch.bfloat16]!r} (2e-2)")
    return {"forward": fwd[torch.float32],
            **{kind: worst[kind, torch.float32] for kind in ("dgrad", "wgrad")}}


def phase_fleet() -> dict:
    """Phase 25: MRSch as the fleet scheduler at ``scheduler.main``'s
    defaults on the card (module docstring)."""
    from repro_torch.launch import scheduler as fs
    fleet = fs.FleetSpec()
    jobs = fs.synth_fleet_trace(fleet, FLEET_JOBS, seed=FLEET_SEED)
    reset_launch_counts()
    t0 = time.perf_counter()
    agent = fs.make_fleet_agent(fleet)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = launch_counts()
    sampled = sample_greedy_rows(agent)
    t0 = time.perf_counter()
    result = fs.schedule_fleet(jobs, fleet, "mrsch", agent=agent)
    eval_s = time.perf_counter() - t0
    del agent.select
    launches = launch_counts()
    assert agent.device.type == "cuda" and agent.dfp.backend == "kernel"
    for kind in ("forward", "dgrad", "wgrad"):
        assert trained[kind] > 0, f"fleet training launched no {kind}"
    assert launches["forward"] > trained["forward"], "no B1 while deciding"
    assert all(launches[k] == 0 for k in KERNELS
               if k not in ("forward", "dgrad", "wgrad")), launches
    log(f"[fleet] make_fleet_agent: {train_s:.2f} s wall, "
        f"{len(agent.losses)} bursts, replay {agent.replay.rows} rows, "
        f"launches B1 {trained['forward']} B2 {trained['dgrad']} "
        f"B3 {trained['wgrad']}")
    log(f"[fleet] schedule_fleet mrsch: {result.decisions} decisions in "
        f"{eval_s:.3f} s ({result.decisions / eval_s:.1f} decisions/s), "
        f"B1 {launches['forward'] - trained['forward']}")
    err, tol, decisive = check_served_rows(agent, sampled)
    log(f"[fleet] {len(sampled)} sampled greedy rows against the plain "
        f"version: max abs err {err!r} (tol {tol!r}), {decisive} decisive "
        f"rows with the same action")
    check_step_parity(agent, MLP_STEP, "fleet train parity")
    errs = check_fleet_layers(agent)
    errs["forward"] = max(errs["forward"], err)
    rows = {"mrsch": result.metrics.as_row()}
    for policy in ("fcfs", "ga"):
        t0 = time.perf_counter()
        rows[policy] = fs.schedule_fleet(jobs, fleet, policy).metrics.as_row()
        log(f"[fleet] schedule_fleet {policy}: "
            f"{time.perf_counter() - t0:.2f} s (host)")
    for policy, row in rows.items():
        log(f"[fleet] {policy} " + json.dumps(
            {"policy": policy, **{k: round(v, 4) for k, v in row.items()}}))
    hbm_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    watts = float(gpu_name_and_power_limit().split(",")[1].split()[0])
    card_fleet = replace(fleet, hbm_gb_per_chip=hbm_gb, watts_per_chip=watts)
    from repro_torch.configs import ARCH_NAMES
    for arch in ARCH_NAMES:
        demands = {s: (fs.job_demands(arch, s, fleet),
                       fs.job_demands(arch, s, card_fleet))
                   for s in ("train_4k", "prefill_32k", "decode_32k")}
        log(f"[fleet] demands {arch} (FleetSpec() -> {hbm_gb:.1f} GB, "
            f"{watts:.0f} W): " + "; ".join(
                f"{s} {a} -> {b}" for s, (a, b) in demands.items()))
    free_cuda()
    return {"launches": launches, "err": errs, "rows": rows,
            "train_s": train_s, "decisions_per_s": result.decisions / eval_s}


# ------------------------------------------------ phase 26: the mesh
MESH_SEQ, MESH_BATCH = 1024, 2
MOE_TOKENS = (8, 16)                     # B, S: small T (<= 4096)


def mesh_train_step(cfg, batch, mesh, rules_fn=None, reps: int = 3):
    """One gemma-2b step from seed-0 weights, under the rules
    ``rules_fn(mesh)`` or without rules (None); returns (parameters after
    the first step, loss, step walls)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import OptConfig, opt_init
    opt = OptConfig(lr=1e-4)
    params = transformer.init_params(
        cfg, dtype=torch.float32,
        generator=torch.Generator("cuda").manual_seed(0))
    state = opt_init(params, opt)
    fn = steps.make_train_step(cfg, opt)
    sharded = rules_fn is not None
    if sharded:
        rules = rules_fn(mesh)
        pspecs = sh.param_pspecs(params, rules)
        state = sh.distribute_tree(
            state, steps.param_pspecs_for_opt(state, pspecs), mesh)
        sh.distribute_params(params, rules, pspecs)
        batch = sh.distribute_tree(batch, steps.batch_pspec(rules, batch),
                                   mesh)
        fn = steps._bind_rules(fn, rules)
    walls = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = fn(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            first = {n: (p.full_tensor() if sharded else p).detach().clone()
                     for n, p in params.named_parameters()}
            loss = metrics["loss"]
            loss = float(loss.full_tensor() if sharded else loss)
    return first, loss, walls


def phase_mesh() -> dict:
    """Phase 26: the multi-card layer on a one-card mesh (module
    docstring)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            torch.cuda.set_device(0)
            mesh = make_host_mesh()
            assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
            log(f"[mesh] world 1 on nccl: {mesh}")
            cfg = replace(get_config("gemma-2b"), n_layers=2)
            batch = make_batch(cfg, InputShape("t", MESH_SEQ, MESH_BATCH,
                                               "train"), 0)
            p0, l0, w0 = mesh_train_step(cfg, batch, mesh)
            p1, l1, w1 = mesh_train_step(cfg, batch, mesh, sh.default_rules)
            rel = max(float((p1[n] - p0[n]).abs().max()
                            / p0[n].abs().max().clamp_min(1e-30))
                      for n in p0)
            assert rel <= 1e-6, f"sharded step: relative error {rel!r}"
            assert abs(l1 - l0) <= 1e-6 * abs(l0), (l0, l1)
            out["train"] = {"rel": rel, "plain_s": w0, "sharded_s": w1}
            log(f"[mesh] gemma-2b 2 layers float32 B={MESH_BATCH} "
                f"S={MESH_SEQ}: loss {l0!r} / {l1!r} under default_rules, "
                f"parameters within {rel!r} relative; step wall plain "
                f"{statistics.median(w0[1:]) * 1e3:.2f} ms, sharded "
                f"{statistics.median(w1[1:]) * 1e3:.2f} ms (walls "
                f"{[round(w, 4) for w in w0]} / {[round(w, 4) for w in w1]})")
            del p1
            free_cuda()
            # Sequence parallelism: act_seq and kv_seq over "model".
            for name in ("opt", "serve"):
                p2, l2, _ = mesh_train_step(cfg, batch, mesh,
                                            sh.RULE_SETS[name], reps=1)
                same = l2 == l0 and all(torch.equal(p2[n], p0[n])
                                        for n in p0)
                assert same, f"the step under {name} rules is not the plain one"
                log(f"[mesh] gemma-2b 2 layers one step under {name} rules "
                    f"(act_seq over model): bit-equal to the plain step, "
                    f"loss {l2!r}")
                del p2
                free_cuda()
            del p0
            out["serve"] = mesh_serve(cfg, mesh)
            out["moe"] = mesh_moe(mesh)
        finally:
            dist.destroy_process_group()
    out["dryrun"] = mesh_dryrun()
    return out


def mesh_serve(cfg, mesh) -> dict:
    """Phase 26(c): gemma-2b's prefill step and one decode step under
    ``serve_rules`` (the residual stream's sequence and the cache's
    positions over "model"; the decode from a cache filled before its
    position) against the same steps without rules, bit for bit."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    gen = torch.Generator("cuda").manual_seed(0)
    params = transformer.init_params(cfg, dtype=torch.float32, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (MESH_BATCH, MESH_SEQ),
                           generator=gen, device="cuda")
    pos = MESH_SEQ // 2 + 1
    cache = transformer.init_cache(cfg, MESH_BATCH, MESH_SEQ, torch.float32)
    for leaf in cache["stack"].values():
        leaf[:, :, :pos].normal_(generator=gen)
    plain_cache = {"stack": {k: t.clone() for k, t in cache["stack"].items()}}
    prefill = steps.make_prefill_step(cfg, backend="torch")
    decode = steps.make_decode_step(cfg)
    batch, token = {"tokens": tokens}, {"tokens": tokens[:, :1]}
    want_p = prefill(params, batch)
    want_d, _ = decode(params, token, plain_cache, pos)
    rules = sh.serve_rules(mesh)
    sh.distribute_params(params, rules, sh.param_pspecs(params, rules))
    batch, token = (sh.distribute_tree(b, steps.batch_pspec(rules, b), mesh)
                    for b in (batch, token))
    cache = sh.distribute_tree(cache, steps.cache_pspecs(cache, rules), mesh)
    got_p = steps._bind_rules(prefill, rules)(params, batch).full_tensor()
    got_d, _ = steps._bind_rules(decode, rules)(params, token, cache, pos)
    got_d = got_d.full_tensor()
    assert torch.equal(got_p, want_p), "prefill under serve rules differs"
    assert torch.equal(got_d, want_d), "decode under serve rules differs"
    log(f"[mesh] gemma-2b 2 layers prefill B={MESH_BATCH} S={MESH_SEQ} "
        f"under serve rules: last logits bit-equal to the plain step "
        f"(largest {float(want_p.abs().max())!r})")
    log(f"[mesh] gemma-2b 2 layers decode at position {pos} of a cache of "
        f"{MESH_SEQ} under serve rules (its positions over model): logits "
        f"bit-equal to the plain step (largest {float(want_d.abs().max())!r})")
    del params, cache, plain_cache
    free_cuda()
    return {"prefill_max": float(want_p.abs().max()),
            "decode_max": float(want_d.abs().max())}


def mesh_moe(mesh) -> dict:
    """Phase 26(d): deepseek-v2-lite-16b's MoE layer at full width through
    ``_moe_small_t`` under ``serve_rules`` against the no-mesh layer."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-lite-16b")
    gen = torch.Generator("cuda").manual_seed(0)
    params = moe.moe_init(cfg.d_model, cfg.moe, cfg.glu, torch.float32,
                          generator=gen, device="cuda")
    B, S = MOE_TOKENS
    x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda")
    calls = []
    small_t = moe._moe_small_t

    def counting(*a, **k):
        calls.append(1)
        return small_t(*a, **k)

    with torch.no_grad():
        want = moe.moe_apply(params, x, cfg.moe, cfg.act, cfg.glu)
        rules = sh.serve_rules(mesh)
        sh.distribute_params(params, rules,
                             sh.param_pspecs(params, rules, "stack/moe/"))
        xd = distribute_tensor(x, mesh, sh.placements(
            rules.spec(("batch", None, None), x.shape), mesh))
        moe._moe_small_t = counting
        try:
            with sh.use_rules(rules):
                got = moe.moe_apply(params, xd, cfg.moe, cfg.act,
                                    cfg.glu).full_tensor()
        finally:
            moe._moe_small_t = small_t
    assert calls, "the small-T path did not run"
    err = float((got - want).abs().max())
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert err <= tol, f"MoE under serve_rules: {err!r} > {tol!r}"
    log(f"[mesh] deepseek-v2-lite-16b MoE ({cfg.moe.n_routed} experts, "
        f"d_model {cfg.d_model}, d_expert {cfg.moe.d_expert}) on "
        f"{B * S} tokens through _moe_small_t under serve_rules: max abs "
        f"err {err!r} against the no-mesh layer (tol {tol!r})")
    del params, x, xd
    free_cuda()
    return {"err": err}


DRYRUN_CELLS = (("gemma-2b", "prefill_32k"),
                ("deepseek-v2-lite-16b", "decode_32k"))


def mesh_dryrun() -> dict:
    """Phase 26(e): the dry run of two cells on a fake 16 x 16 world, each
    in a process of its own, the two at once; each record ``ok``,
    printed."""
    import tempfile
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", tmp,
             "--force"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            for arch, shape in DRYRUN_CELLS]
        outs = [p.communicate(timeout=300) for p in procs]
        for (arch, shape), p, (_, err) in zip(DRYRUN_CELLS, procs, outs):
            assert p.returncode == 0, err[-3000:]
            with open(os.path.join(tmp, f"{arch}__{shape}__single.json")) as f:
                rec = json.load(f)
            assert rec["status"] == "ok", rec
            recs[arch, shape] = rec
            log(f"[mesh] dryrun {arch} x {shape}: " + json.dumps(rec))
        log(f"[mesh] dryrun: both cells in {time.perf_counter() - t0:.1f} s")
    return recs


# ------------------------------------- phase 27: the entry points on a mesh
ENTRY_STEPS = 3
ENTRY_RTOL = 1e-6
SERVE_ARCH, SERVE_PROMPT, SERVE_NEW, SERVE_B = (
    "deepseek-v2-lite-16b", 16, 8, 2)


def timed_train_steps(walls: list):
    """A ``make_train_step`` for ``launch.train`` whose steps append their
    wall seconds (the card synchronised around each) to ``walls``."""
    from repro_torch.launch import train as train_mod
    make = train_mod.make_train_step

    def timed_make(*a, **k):
        fn = make(*a, **k)

        def step(*b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out
        return step
    return timed_make


def entry_train(name: str, **kw) -> tuple:
    """``train_loop`` of gemma-2b whole (``kw`` its other arguments) with
    its steps timed -> (run, step walls, peak bytes, wall seconds)."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import train as train_mod
    cfg = get_config(TRAIN_ARCH)
    walls = []
    make = train_mod.make_train_step
    train_mod.make_train_step = timed_train_steps(walls)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        run = train_mod.train_loop(
            cfg, InputShape("train", TRAIN_S, TRAIN_B, "train"),
            steps=ENTRY_STEPS, log_every=1, **kw)
    finally:
        train_mod.make_train_step = make
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[mesh entry] {name} train_loop of {cfg.name} whole "
        f"({cfg.n_layers} layers, float32) B={TRAIN_B} S={TRAIN_S}: "
        f"losses {run.losses}; step walls "
        f"{[round(w * 1e3, 2) for w in walls]} ms; peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB); {total:.1f} s with the weights' draw; "
        f"card {gpu_name_and_power_limit()}")
    free_cuda()
    return run, walls, peak, total


class TimedManager:
    """Wall seconds of ``CheckpointManager``'s calls in ``train_loop``:
    ``save_async`` (the gather onto the host, on the caller's thread),
    ``wait`` (the background write and the barrier) and
    ``restore_latest``."""

    def __init__(self):
        from repro_torch.checkpoint import CheckpointManager
        times = self.times = {"save_async": [], "wait": [],
                              "restore_latest": []}

        class Timed(CheckpointManager):
            pass

        for name in times:
            def wrap(fn, name=name):
                def call(self, *a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    try:
                        return fn(self, *a, **k)
                    finally:
                        times[name].append(time.perf_counter() - t0)
                return call
            setattr(Timed, name, wrap(getattr(CheckpointManager, name)))
        self.cls = Timed


def entry_checkpoint(mesh) -> dict:
    """(b) the checkpoint cycle on the mesh (module docstring)."""
    import tempfile

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import OptConfig
    cfg = replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CUT)
    shape = InputShape("train", TRAIN_PARITY_S, TRAIN_PARITY_B, "train")
    # Phase 24's resume: a factored state (vr, vc) and a bfloat16 m.
    opt = OptConfig(factored=True, m_dtype=torch.bfloat16)
    timed_cls = TimedManager()
    kept = train_mod.CheckpointManager
    train_mod.CheckpointManager = timed_cls.cls
    try:
        with tempfile.TemporaryDirectory() as b:
            whole = train_mod.train_loop(cfg, shape, steps=4, log_every=1,
                                         mesh=mesh, opt=opt)
            first = train_mod.train_loop(cfg, shape, steps=2, ckpt_dir=b,
                                         ckpt_every=2, log_every=1,
                                         mesh=mesh, opt=opt)
            size = dir_bytes(os.path.join(b, "step_00000002"))
            resumed = train_mod.train_loop(cfg, shape, steps=4, ckpt_dir=b,
                                           ckpt_every=2, log_every=1,
                                           mesh=mesh, opt=opt)
    finally:
        train_mod.CheckpointManager = kept
    times = timed_cls.times
    # The waits that joined a write (the others find none in flight).
    times["wait"] = [t for t in times["wait"] if t > 1e-3]
    errs = [abs(x / y - 1) for x, y in zip(resumed.losses, whole.losses[2:])]
    log(f"[mesh entry] checkpoint cycle of {cfg.name} at {cfg.n_layers} "
        f"layers on the mesh, B={TRAIN_PARITY_B} S={TRAIN_PARITY_S}: a step "
        f"is {size} bytes; losses {whole.losses} against {first.losses} + "
        f"{resumed.losses} (restored from {resumed.restored_from}, "
        f"{resumed.steps} steps): max rel err {max(errs)!r} (tol "
        f"{ENTRY_RTOL}); seconds: save_async's gather "
        f"{[round(t, 4) for t in times['save_async']]}, wait (write and "
        f"barrier) {[round(t, 4) for t in times['wait']]}, restore_latest "
        f"{[round(t, 4) for t in times['restore_latest']]}; card "
        f"{gpu_name_and_power_limit()}")
    if resumed.restored_from != 2 or resumed.steps != 2 \
            or first.losses != whole.losses[:2] or max(errs) > ENTRY_RTOL:
        raise AssertionError("[mesh entry] the resumed run differs")
    return {"bytes": size, "max_rel_err": max(errs), "times": times}


def entry_generate(mesh) -> dict:
    """(c) ``generate`` of deepseek-v2-lite-16b whole in bfloat16, plain
    and under two rule sets (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer
    cfg = dropless(get_config(SERVE_ARCH))
    dtype = torch.bfloat16
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=torch.Generator("cuda").manual_seed(1),
                            device="cuda")
    out = {}
    for name in ("plain", "baseline", "serve"):
        gen = torch.Generator("cuda").manual_seed(0)
        if name == "plain":
            rules = None
            params = transformer.init_params(cfg, generator=gen,
                                             device="cuda", dtype=dtype)
        else:
            rules = sh.RULE_SETS[name](mesh)
            params = steps.init_sharded_params(cfg, rules, generator=gen,
                                               dtype=dtype)
        res = serve.generate(cfg, params, prompts, max_new_tokens=SERVE_NEW,
                             rules=rules, dtype=dtype)
        ms = 1e3 * SERVE_B / res["decode_tps"]
        out[name] = {"tokens": res["tokens"], "ms_per_step": ms}
        log(f"[mesh entry] generate {cfg.name} whole (bfloat16) "
            f"{SERVE_NEW} tokens after {SERVE_PROMPT}, B={SERVE_B}, "
            f"{'no rules' if rules is None else name + ' rules'}: "
            f"{ms:.3f} ms a decode step; tokens "
            f"{res['tokens'][:, SERVE_PROMPT:].tolist()}; card "
            f"{gpu_name_and_power_limit()}")
        del params, res
        free_cuda()
    for name in ("baseline", "serve"):
        if not torch.equal(out[name]["tokens"], out["plain"]["tokens"]):
            raise AssertionError(f"[mesh entry] generate under {name} "
                                 f"rules gives other tokens")
    return {k: v["ms_per_step"] for k, v in out.items()}


def entry_cli() -> dict:
    """(d) the training command line under ``torchrun`` on the card."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "repro_torch.launch.train", "--arch",
           "stablelm-1.6b", "--smoke", "--steps", "3"]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"[mesh entry] torchrun: {p.stderr[-3000:]}")
    last = json.loads(p.stdout.strip().splitlines()[-1])
    if last.keys() != {"steps", "final_loss", "wall_s"} \
            or last["steps"] != 3 or not math.isfinite(last["final_loss"]):
        raise AssertionError(f"[mesh entry] torchrun printed {last}")
    log(f"[mesh entry] {' '.join(cmd[1:])}: {wall:.1f} s; last line "
        f"{json.dumps(last)}; card {gpu_name_and_power_limit()}")
    return last


def phase_mesh_entry() -> dict:
    """Phase 27: the LM entry points on a one-card mesh (module
    docstring)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import debug

    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    assert not dist.is_initialized()
    # Phase 26's world is gone; its meshes compare equal to this one's,
    # so DTensor's cached specs could hand an op its process groups (as
    # the dry run's fake_world, which empties the caches too).
    debug._clear_sharding_prop_cache()
    plain = entry_train("plain", device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            torch.cuda.set_device(0)
            mesh = make_host_mesh()
            # mesh=None: the host mesh of the initialised group.
            meshed = entry_train("mesh", mesh=None)
            errs = [abs(x / y - 1) for x, y in zip(meshed[0].losses,
                                                    plain[0].losses)]
            log(f"[mesh entry] gemma-2b losses on the mesh against the "
                f"plain loop: max rel err {max(errs)!r} (tol {ENTRY_RTOL}); "
                f"median step wall plain "
                f"{statistics.median(plain[1][1:]) * 1e3:.2f} ms, mesh "
                f"{statistics.median(meshed[1][1:]) * 1e3:.2f} ms; peak "
                f"{plain[2] / 2**30:.2f} / {meshed[2] / 2**30:.2f} GiB; card "
                f"{gpu_name_and_power_limit()}")
            if len(errs) != ENTRY_STEPS or max(errs) > ENTRY_RTOL:
                raise AssertionError("[mesh entry] the mesh train_loop's "
                                     "losses differ from the plain loop's")
            out["train"] = {"plain": plain[1:], "mesh": meshed[1:],
                            "max_rel_err": max(errs)}
            out["ckpt"] = entry_checkpoint(mesh)
            out["serve"] = entry_generate(mesh)
        finally:
            dist.destroy_process_group()
    out["cli"] = entry_cli()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = timed("environment", phase_env)
    timed("build", phase_build)
    flash_worst = timed("flash parity", phase_flash_parity)
    ssd_worst = timed("ssd parity", phase_ssd_parity)
    kernels = scheduling_paths()
    lm = timed("lm prefill", phase_lm_prefill)
    widths = timed("lm widths", phase_lm_widths)
    moe = timed("lm moe", phase_lm_moe)
    timed("lm train", phase_lm_train)
    fleet = timed("fleet", phase_fleet)
    timed("mesh", phase_mesh)
    timed("mesh entry points", phase_mesh_entry)
    for entry in kernels:                 # phase 25's path runs B1-B3
        kind = FLEET_KERNELS.get(entry["name"])
        if kind is not None:
            entry["launches"] += fleet["launches"][kind]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       fleet["err"][kind])
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels += [{
        # B7 in bfloat16: the bfloat16 prefill steps' launches (zamba2-7b's
        # and deepseek's); the times at zamba2-7b's shape.
        "name": "flash_attention", "route": "cuda",
        "source": FLASH_SM90_SOURCE, "replaces": FLASH_REPLACES,
        "launches": (lm["bf16_launches"]["flash_attention"]
                     + moe["bf16_launches"]),
        "max_abs_err": max(flash_worst[torch.bfloat16],
                           lm["bf16_err"]["flash_attention"],
                           moe["flash_attention"]["max_abs_err"]),
        **{k: lm["flash_attention"][k] for k in keys},
    }, {
        # B7 in float32: the float32 prefill steps' launches and times.
        "name": "flash_attention_f32", "route": "cuda",
        "source": FLASH_F32_SOURCE, "replaces": FLASH_REPLACES,
        "launches": (lm["launches"]["flash_attention"]
                     + widths["launches"]["flash_attention"]
                     + moe["f32_launches"]),
        "max_abs_err": max(flash_worst[torch.float32],
                           lm["err"]["flash_attention"],
                           widths["err"].get("flash_attention", 0.0),
                           moe["err"]["flash_attention_f32"]),
        **{k: lm["f32"]["flash_attention"][k] for k in keys},
    }, {
        "name": "ssd", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES,
        "launches": lm["launches"]["ssd"] + widths["launches"]["ssd"],
        "max_abs_err": max(ssd_worst, lm["err"]["ssd"],
                           widths["err"].get("ssd", 0.0)),
        **{k: lm["ssd"][k] for k in keys},
    }]
    log(f"[prior] quoted from PERF.md section 6, not measured in this run: "
        f"time before the redesign {PRIOR_MS} (ms)")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    # The result line's fixed format: count is torch.cuda.device_count(),
    # the cards visible; every phase runs on card 0.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def scheduling_paths() -> list:
    """Phases 3-13 and 17-22: the scheduling system's paths and kernels
    B1-B6; returns their entries of the kernels line."""
    from repro_torch.core import (AgentConfig, MRSchAgent, TrainConfig,
                                  slots_from_jobsets)
    from repro_torch.nn import count_params
    from repro_torch.workloads import ThetaConfig, build_train_mix
    worst_f32 = timed("fused_mlp parity", phase_parity)
    wp_err = timed("window_pack parity", phase_window_pack_parity)
    mha_worst = timed("mha parity", phase_mha_parity)
    agent = MRSchAgent(ThetaConfig().resources(), AgentConfig(seed=0))
    n_params = count_params(agent.net)
    assert agent.enc.state_dim == 11410, agent.enc.state_dim
    log(f"[agent] paper width: state_dim {agent.enc.state_dim}, "
        f"{n_params} parameters ({4 * n_params / 1e6:.1f} MB float32), "
        f"backend {agent.dfp.backend}")
    timing = timed("fused_mlp timing", phase_timing, agent)
    timed("window_pack timing", phase_window_pack_timing)
    service = timed("service path", phase_main_path, agent)
    timed("service breakdown", phase_breakdown, agent)
    timed("device-engine parity", phase_device_parity, agent)
    # One timed repeat, not three, keeps the run near ten minutes.
    device, sim = timed("device-engine path", phase_device_main, agent,
                        None, MLP_FORWARD, "device", 1)
    wp_main = timed("window_pack on the main path",
                    phase_window_pack_main_path, sim)
    del sim
    bwd_worst = timed("fused_mlp backward parity", phase_backward_parity,
                      agent)
    train_launches, trained, seq_dps = timed("training path", phase_training)
    timed("training parity", phase_training_parity, trained)
    timed("training timing", phase_training_timing, trained)
    bwd_main = timed("backward on the training path",
                     phase_backward_main_path, trained)
    del agent, trained

    # The attention state module: the reference's default attention agent.
    attn_cfg = AgentConfig(state_module="attention", seed=0)
    attn = MRSchAgent(ThetaConfig().resources(), attn_cfg)
    n_attn = count_params(attn.net)
    assert (attn.enc.state_dim, n_attn) == (517, 1383428), (
        attn.enc.state_dim, n_attn)
    log(f"[attn agent] queue_cap {attn.config.queue_cap}, attn_dim "
        f"{attn.config.attn_dim}, {attn.config.attn_heads} heads, "
        f"{attn.config.attn_layers} layers: state_dim {attn.enc.state_dim}, "
        f"{n_attn} parameters, backend {attn.dfp.backend}")
    attn_service = timed("attention service path", phase_main_path, attn,
                         attn_trace, ATTN_FORWARD, (1, 1), "attn service")
    timed("attention device-engine parity", agent_device_parity, attn,
          *attn_trace(1), "attention agent", "attn device parity")
    attn_device, attn_sim = timed(
        "attention device-engine path", phase_device_main, attn, attn_trace,
        ATTN_FORWARD, "attn device", 3, False)
    attn_launches, attn_trained, _ = timed(
        "attention training path", phase_training, attn_cfg, attn_trace,
        ATTN_STEP, ATTN_FORWARD, "attn train")
    timed("attention training parity", phase_training_parity, attn_trained,
          attn_trace, ATTN_STEP, "attn train parity")
    timed("attention training timing", phase_training_timing, attn_trained,
          "attn train timing")
    timed("backward on the attention training path",
          phase_backward_main_path, attn_trained, ATTN_STEP, "attn ")
    attn_main, wp_attn = timed("attention kernels on the main path",
                               phase_attention_main_path, attn_trained,
                               attn_sim)
    del attn_sim

    del attn_trained
    free_cuda()

    # The lockstep engine: a fresh paper-width MLP agent (phase 6's seed-0
    # weights) replays, then one trains on the heterogeneous mix; a fresh
    # attention agent trains with a step every round.
    agent = MRSchAgent(ThetaConfig().resources(), AgentConfig(seed=0))
    vec = timed("vector replay", phase_vector_replay, agent)
    vec_service = timed("vector service path", phase_vector_service, agent,
                        vec["results"])
    mix = build_train_mix(ThetaConfig(duration_days=2, jobs_per_day=160),
                          **VECTOR_MIX)
    agent = MRSchAgent(ThetaConfig().resources(), AgentConfig(seed=0))
    vec_launches, _ = timed("vector training path", phase_vector_training,
                            agent, mix, TrainConfig(n_envs=8), MLP_STEP,
                            MLP_FORWARD, "vector train", seq_dps)
    vec_replay_launches = vec["launches"]
    del agent, mix, vec
    lanes = [attn_trace(seed) for seed in ATTN_VECTOR_SEEDS]
    attn = MRSchAgent(lanes[0][0], attn_cfg)
    attn.epsilon = ATTN_VECTOR_EPSILON
    attn_vec_launches, attn_log = timed(
        "attention vector training path", phase_vector_training, attn,
        slots_from_jobsets(lanes[0][0], [j for _, j in lanes], len(lanes)),
        TrainConfig(n_envs=len(lanes), grad_steps_per_round=1), ATTN_STEP,
        ATTN_FORWARD, "attn vector train")
    assert attn_log.round_losses, "no per-round step ran"
    del attn, lanes
    free_cuda()
    ckpt = timed("checkpoint, hot reload and telemetry",
                 phase_checkpoint_reload)
    free_cuda()
    policies = timed("policies, baselines and the tournament",
                     phase_policies)
    pol = policies["launches"]
    free_cuda()
    # B1's times in the kernels line: the 13 DFP layers at M = 64, the
    # device engine's and training's rows (fused_mlp_fwd_m64_kernel).
    t_k, t_p, t_l, bnd, by = timing["sums"][64]
    return [{
        "name": "fused_mlp_forward", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": (service["launches"] + device["launches"]["forward"]
                     + train_launches["forward"] + attn_service["launches"]
                     + attn_device["launches"]["forward"]
                     + attn_launches["forward"] + vec_replay_launches
                     + vec_service["launches"] + vec_launches["forward"]
                     + attn_vec_launches["forward"] + ckpt["launches"]
                     + pol["forward"]),
        "max_abs_err": worst_f32,
        "ms": t_k, "plain_ms": t_p, "bound_ms": bnd, "bound_by": by,
        "library_ms": t_l,
    }, {
        "name": "window_pack", "route": "cuda",
        "source": WP_SOURCE, "replaces": WP_REPLACES,
        "launches": (device["launches"]["window_pack"]
                     + attn_device["launches"]["window_pack"]
                     + pol["window_pack"]),
        "max_abs_err": max(wp_err, wp_main["max_abs_err"],
                           wp_attn["max_abs_err"]),
        "ms": wp_main["ms"], "plain_ms": wp_main["plain_ms"],
        "bound_ms": wp_main["bound_ms"], "bound_by": wp_main["bound_by"],
        "library_ms": None,
    }] + [{
        "name": f"fused_mlp_{kind}", "route": "cuda", "source": BWD_SOURCE,
        "replaces": replaces,
        "launches": (train_launches[kind] + attn_launches[kind]
                     + vec_launches[kind] + attn_vec_launches[kind]
                     + pol[kind]),
        "max_abs_err": max(bwd_worst[kind], bwd_main[kind]["max_abs_err"]),
        "ms": bwd_main[kind]["ms"], "plain_ms": bwd_main[kind]["plain_ms"],
        "bound_ms": bwd_main[kind]["bound_ms"],
        "bound_by": bwd_main[kind]["bound_by"],
        "library_ms": bwd_main[kind]["library_ms"],
    } for kind, replaces in (("dgrad", DGRAD_REPLACES),
                             ("wgrad", WGRAD_REPLACES))] + [{
        "name": kind, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": (attn_service["counts"][key]
                     + attn_device["launches"][key] + attn_launches[key]
                     + attn_vec_launches[key]),
        "max_abs_err": max(mha_worst[kind], attn_main[kind]["max_abs_err"]),
        **{k: attn_main[kind][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
    } for kind, key, source, replaces in (
        ("mha_fwd", "mha", MHA_SOURCE, MHA_REPLACES),
        ("mha_bwd_dq", "mha_bwd_dq", MHA_BWD_SOURCE, MHA_BWD_REPLACES),
        ("mha_bwd_dkv", "mha_bwd_dkv", MHA_BWD_SOURCE, MHA_BWD_REPLACES))]


if __name__ == "__main__":
    sys.exit(main())
