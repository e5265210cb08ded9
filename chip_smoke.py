#!/usr/bin/env python3
"""Drive gymca_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Thirteen paths, ten of them carried by kernels written by hand in CUDA:

* slice 1: ``BulldozerCore(256, 256).step_batched`` over 4096 envs (256 MiB
  of int8 grid), carried by K1 (``gymca_torch/csrc/windy_sparse.cu``);
* slice 2: ``AdvancedForestFireBulldozerEnv(256, 256, num_envs=64)``,
  ``stateless_step`` then ``conditional_reset``, carried by the fused
  Alexandridis kernel (K2/K3, ``gymca_torch/csrc/alexandridis.cu``);
* slice 3: the probes' entry points (``gymca_torch/probes/``), carried by
  ``ca_variants.cu`` (four kernels), ``dma_floor.cu``, ``probe_floor.cu`` and
  the Alexandridis kernel's ablation instances;
* slice 5: the PPO trainer (``gymca_torch/agents/``) on the Advanced env at
  ``scripts/run``'s defaults, 8 envs at 256², carried by the Alexandridis
  kernel (one launch per env step) beside cuDNN's convs;
* slice 7: the Helicopter (``HelicopterCore``, plain torch ops, as the JAX
  package's Drossel–Schwabl CA is plain XLA) and ``gymca_torch.run``'s
  evaluation loop on the Advanced env, carried by the Alexandridis kernel;
* slice 8: pinecone spotting (plain torch ops: the JAX package spots them
  in plain XLA) and the legacy sequential spec (NumPy on the host), then
  ``python3 -m gymca_torch.train_curve`` and ``python3 -m
  gymca_torch.eval_policy`` (their ``main``), carried by the Alexandridis
  kernel in ``single`` mode.
* slice 9: ``gymca_torch.parallel`` on a world of one rank on NCCL:
  ``DataParallelPPO`` at ``[train]``'s cell, carried by the Alexandridis
  kernel, with one NCCL all-reduce a minibatch; the spatial steps (plain
  torch ops, as the JAX package's are plain XLA); ``bench_scaling`` at d = 1,
  carried by K1;
* slice 10: the step breakdowns, the fused CA's validation, the policy
  ceiling and the two small CLIs of ``scripts/`` as the port's entry points
  (``gymca_torch.profile_step`` and ``gymca_torch.probes.exp_split``,
  carried by K1; ``bench_advanced``, ``profile_advanced``,
  ``exp_advanced_split``, ``validate_fused_ca`` and ``exp_policy_ceiling``,
  carried by the Alexandridis kernel; ``update_gallery`` and
  ``versionate``);
* slice 11: ``bench.py`` as ``gymca_torch.bench``, whose two measurements
  (4096 windy envs and 64 Advanced envs at 256²) are carried by K1 and the
  Alexandridis kernel.

Phases, each fatal on failure:

1. device line: card, count, torch and CUDA versions, ``nvidia-smi`` name and
   power limit;
2. build every ``gymca_torch/csrc/*.cu`` from the checkout, one ``nvcc`` per
   source, all started together, with the ptxas report of each;
3. K1 against its plain version at (4096, 256, 256) int8 with every env
   class, deferred edits and shots on trees and non-trees (tolerance 0);
   then the CA pass's band seams (fire on both sides of every seam, every
   edit and shot on a band's first or last row, so halo rows carry edits),
   batches that are all CA, all idle and all modify-only envs;
4. the same at (64, 64, 128) int32, at (16, 40, 50) int8, whose rows take
   the kernel's one-cell-per-lane path, both also on band seams, at (16, 3,
   64) (bands of one row), at (8, 512, 512) int8, and at (2, 1024, 1024)
   int8 and int32, whose band masks (64.5 KiB a block) pass the 48 KiB a
   block gets without opting in;
5. the Alexandridis kernel against its plain version, grid and age with
   tolerance 0, on synthetic inputs at (64, 256, 256), (4, 512, 512),
   (2, 1024, 1024) and (16, 40, 50) (ragged tiles); then the layouts that
   can break its tiling at (16, 256, 256) and (4, 96, 200): fire only on
   tile edges, burning tiles beside fire-free ones, fire only in a tile's
   1-cell halo, all fire and none; radius 2 (halo 2), radius 7 at 512² and
   radius 32;
5b. ``[rng]``: the key chain's threefry kernel (``csrc/threefry.cu``)
   against the eager int64 chain on the same card keys, bit for bit, one
   launch a draw: ``derive_step_key`` over 4096 keys, the windy reset's
   six-way split, and the Advanced step's ``fold_in``, ``uniform``,
   ``randint`` and fresh-grid ``choice`` over 64 keys (64 x 256²); then its
   device time for a split of 4096 keys and a uniform over 64 x 256² cells
   beside its bound (int32 ALU or bytes);
6. slice 1's main path: reset 4096 envs, step them with random actions from
   a CUDA ``torch.Generator`` under ``torch.cuda.set_sync_debug_mode("error")``,
   the launch counters zeroed before and read after (and 4 threefry
   launches a step, one a draw of ``derive_step_key``; 10 a step on slice
   2's path); then ``step_batched``
   against the eager batched step ``step`` on 64 envs, bit for bit, and K1
   against its plain version on inputs recorded from the main path; then
   ``[bench]`` (7b, below); then its times (below);
7. slice 2's main path: reset 64 envs at 256² and run 100 steps of
   ``stateless_step`` + ``conditional_reset`` with random (move, shoot, 0)
   actions under the same sync-error mode, the counters zeroed before and
   read after (100 Alexandridis launches); the terrain that env drew on
   the card from a card key, and one drawn there at 17 x 23 x 3 (a scalar
   remainder in the JAX bundle's slope loops), against the CPU's draw from
   the same seed, nothing injected, every leaf bit for bit (the count of
   differing elements per leaf printed); the fused env on the card
   against the same env on the CPU with the kernel's plain version (4 envs
   at 64², bit for bit, env 0 made to terminate and reset half way); the
   kernel against its plain version on three launches recorded from the
   main path; 8 envs at 512² for 20 steps (the TPU's tiled sizes, 20
   launches); and the fused path against the XLA-path counterpart
   (``use_fused_ca=False``): mean fire and burned counts and mean fire age
   at checkpoints inside a 4-sigma band of the cross-env noise; then its
   times.  Times, for each path, beside the card's name and power limit:
   env-steps/s (``[bench]``'s); the kernel's device time per launch from the profiler's
   kernel events beside its bound for the bytes and operations of those
   inputs (and, for the Alexandridis kernel, its dense bound, every cell a
   candidate), on several input sets: K1 on the recorded main-path
   launches (and its light and CA passes alone), with every env a CA env,
   with every env idle; the Alexandridis kernel on the recorded main-path
   launches, the first launches after a reset and synthetic 10%-fire
   inputs at 64 x 256² (and its ablations on those), recorded and
   synthetic at 8 x 512²; the plain
   versions; the host time of parts of the step; and a profiler trace of
   the step (device kernels per step, idle share, time by kernel);
7b. slice 11, ``[bench]``: ``gymca_torch.bench``'s ``measure_windy`` at
   4096 x 256² and ``measure_advanced`` at 64 x 256² (the fused kernel), each
   at 200 steps a run (bench.py's 1000 cut), the best of 3 after 2 untimed,
   every run from the same reset states with its actions drawn before its
   clock and its steps under ``set_sync_debug_mode("error")``: env-steps/s,
   each rep, the done fraction and the draws' seconds; exactly 5 x 200
   launches of the path's kernel and none of the other (the counters zeroed
   before and read after), reward sums in [-envs, 0], and the kernel's
   inputs at 3 launches of the untimed runs held against its plain version
   (tolerance 0).  Every later line that quotes the windy or Advanced
   env-steps/s quotes these;
8. slice 3: the four windy-CA formulations against their plain versions step
   by step and against each other (tolerance 0) over 40 steps at (256, 256,
   256), 3 at (4096, 256, 256), 5 at (2, 512, 512) and 10 at (8, 64, 128),
   (4, 40, 52) and (4, 40, 50), where the swar wrapper must raise;
   ``dma_floor`` against its plain version at (64, 256, 256) and (8, 512,
   512); each Alexandridis ablation against its plain version at (64, 256,
   256) and (8, 512, 512), the shapes it is
   timed at, and the default instance again on recorded main-path launches
   (its ptxas line is checked at the build); then the entry points
   ``exp_ca_variants`` (at 256 and at 4096 envs), ``bench_fused_ca``
   (64 x 256² and 8 x 512², 100 launches per repetition),
   ``exp_counts_out``, ``exp_launch_floor``, ``exp_kernel_overhead`` and
   ``exp_floor`` (100 launches per repetition; each checks ``probe_floor``
   against its plain version at every launch configuration it times), the
   counters zeroed before and read after; their times, the new kernels'
   bounds and plain versions: S4 at 256 and 4096 envs of 256², each
   formulation against the busiest SM pipe for its inner loop's SASS
   (``cuobjdump -sass`` of this build) and, at 4096 envs, where the grid
   no longer fits in L2, the larger of that and its bytes, with its share
   of the bound; and their order; the floor family beside
   ``F.pad(table[:, 4:6], (0, counts_w - 2))`` where that computes its
   counts; S3 at 4096 envs a block beside the launch floor plus its bytes
   at the rate one SM reaches, the faster of two loaders: one block of the
   bulk-copy engine (``one_sm_copy``) and the probe's own kernel over
   65,536 envs, each timed against a launch that moves next to nothing;
9. slice 5, ``[train]``: (a) ``scripts/run``'s defaults through
   ``gymca_torch.run``'s ``parse_args`` and ``build_env`` (8 envs at 256²,
   ``single`` mode, uint8 obs, the fused kernel, the full-width network):
   ``train()`` for 1 iteration of 128 steps, 4 epochs of 4 minibatches,
   the launch counters zeroed before and read after (1 x 128 Alexandridis
   launches), the kernel's inputs recorded at the first and last launch of
   each iteration and each held against its plain version (tolerance 0),
   finite metrics, params moved; then one more iteration split
   into its rollout and its GAE + update, each under
   ``set_sync_debug_mode("error")`` and timed; env step against policy
   forward; a profiler trace of 4 rollout steps and of one update (the
   phase fails if either shows no device time); peak
   memory beside what was held before.  (b) round 5's pipeline flags (``scripts/sweep_r5_kickstart256.sh``:
   bf16, centroid features, the three shaping terms, 1 BC iteration, 1
   critic-warmup iteration, kickstart 1.0) at ``single`` mode, cut to 8 envs
   x 16 steps x 3 iterations: the critic-only iteration leaves torso and
   actor bit-identical.  (c) the trained weights on the card and on the CPU
   on the same observations, float32 with TF32 off (rtol 1e-4, atol 1e-5),
   and the difference TF32 makes.  (d) ``train_iteration`` twice from one
   carry at (a)'s cell (8 envs x 128 steps, 4 minibatches of 256): metrics
   and params must agree bit for bit (the trainer runs under cuDNN's
   deterministic algorithms); then at (b)'s size, float32 defaults and (b)'s
   flags, reported;
10. slice 7, ``[helicopter]``: ``HelicopterCore(42, 42)``, the registered
    size, at 4096 envs for 50 ``autoreset_step``s with random actions under
    ``set_sync_debug_mode("error")`` (best of 3 for env-steps/s), then 256
    envs at 256² for 50 steps: cells in {0, 1, 2}, finite rewards in [-1,
    1], never done; the card against the CPU, every leaf bit for bit, at 64
    envs for 70 steps (three CA applications and more); a profiler trace
    (device kernels per step, idle share).  Its CA is plain torch ops, as
    the JAX package's is plain XLA: no hand-written kernel on this path;
11. slice 7, ``[eval]``: ``gymca_torch.run``'s evaluation loop
    (``eval_loop``) at ``scripts/run``'s defaults (8 envs at 256², ``single``
    mode, the fused kernel), 50 steps each with the random, scripted and
    params actors (the params actor restores ``[train]``'s trained agent
    state, saved with the port's ``CheckpointManager``, through
    ``load_actor``), each under ``set_sync_debug_mode("error")`` with K2's
    counter zeroed before and read after (one launch a step); the kernel's
    inputs recorded at each actor's first and last launch and held against
    its plain version (tolerance 0); steps/s, and a profiler trace of the
    random actor's loop.  Nothing is rendered (the card's machine has no
    matplotlib);
12. slice 8, ``[pinecones]``: the Advanced env with ``enable_pinecones`` at
    64 envs x 256² (the XLA-path counterpart: no Alexandridis launch) for 10
    steps from a reset under ``set_sync_debug_mode("error")``: ms a step,
    and a profiler trace (device kernels a step, idle share); then the card
    against the CPU, every leaf bit for bit, at 4 envs x 64² for 30 steps
    from a burning block, which fails unless embers were lit and some cell
    was hit by a lit entry followed by an unlit one (the landing order
    decides it);
13. slice 8, ``[legacy]``: ``AlexandridisCA.sequential_prototype`` at 32² for
    3 passes from a Generator seed, on the host (the card's machine has no
    JAX): twice, equal, cells in {0, 1, 2}, some changed;
14. slice 8, ``[curve]``: ``gymca_torch.train_curve`` at 32 envs x 256², 1
    iteration, ``--pallas-ca --bf16``, artifacts in a temporary directory:
    1 x 128 Alexandridis launches, the kernel's inputs at the first and last
    launch of each iteration held against its plain version (tolerance 0),
    finite metrics, the JSON's ``hardware`` naming the card; then round 5's
    recipe flags, cut (modf: the XLA-path counterpart, no launch), and the
    same with ``--pallas-ca``, which must warn and fall back;
15. slice 8, ``[policy]``: ``gymca_torch.eval_policy`` on ``[curve]``'s blob,
    16 envs, 25 steps, ``--probes``, each episode loop under
    ``set_sync_debug_mode("error")``: exactly 4 x 25 Alexandridis launches, the
    kernel held against its plain version at each policy's first and last
    launch (tolerance 0), steps/s per policy; then the modf blob at 10 steps
    with no launch;
16. slice 9, ``[parallel]``, after every other phase, so that none of them
    sees a process group, its parts run in the order (a), (c), (d), (b):
    (a) ``initialize_distributed`` brings up a world
    of one rank on NCCL (a free local port, ``cuda:0``), which must report
    ``nccl``, destroyed at the phase's end; (b) ``DataParallelPPO`` at
    ``[train]``'s cell (``scripts/run``'s defaults), ``train(1)``: 128
    Alexandridis launches, the kernel's inputs at each iteration's first and
    last launch held against its plain version (tolerance 0), 16 gradient
    all-reduces an iteration and one of the metrics, finite metrics, params
    moved, samples/s beside ``[train]``'s; then, from the starting weights
    and the same key with TF32 off and cuDNN's deterministic algorithms,
    ``train_iteration`` of DP (its update traced: NCCL's kernels must show
    on the device), ``PPOTrainer``, DP and ``PPOTrainer``, each within rtol
    1e-4, atol 1e-5 of the first trainer's (bit for bit reported), the last
    three timed back to back; (c) under
    ``set_sync_debug_mode("error")``: ``bulldozer_step_spatial`` on one
    16384² int8 grid for 10 steps and ``bulldozer_step_batched_spatial`` on
    a (1, 1) mesh at 4096 x 256² for 10 steps, each leaf for leaf equal to
    ``BulldozerCore.step``; ``advanced_step_spatial`` on one 4096² grid for
    5 steps (cells in {0, 1, 2}, rewards in [-1, 0], fire burning; ms a
    step); ``advanced_step_batched_spatial`` at 64 x 256² on a (1, 1) mesh
    equal to 4 of its envs stepped alone, for 3 steps; the card against the
    CPU (a gloo mesh beside NCCL's) for ``advanced_step_spatial`` at 256² for
    5 steps; (d) ``bench_scaling`` at d = 1, 4096 x 256², 100 steps a run,
    the best of 3 after 2 untimed: 1,000 K1 launches, env-steps/s beside
    ``[time]``'s best;
17. slice 10, ``[tools]``, in a process of its own, the entry points of
    ``scripts/`` that the port had not taken, at their default cells with
    their steps cut (the cuts are ``TOOLS_*`` below), each with both launch
    counters zeroed before and read after: ``gymca_torch.profile_step`` and
    ``gymca_torch.probes.exp_split`` at 4096 x 256², carried by K1 (K1's
    first launch on each input set recorded: profile_step's 1/7-CA, all-CA,
    none-fire and pure no-op sets, exp_split's six fractions);
    ``gymca_torch.bench_advanced`` and ``gymca_torch.profile_advanced`` at 8
    x 256², ``gymca_torch.exp_advanced_split`` at 64 x 256²,
    ``gymca_torch.validate_fused_ca`` at 64 x 256² and
    ``gymca_torch.exp_policy_ceiling`` at 8 x 256², carried by the
    Alexandridis kernel (its first launch in each, in the env and alone,
    recorded); every recorded launch held against the kernel's plain
    version (tolerance 0); fails if a path launched its kernel no time, if
    a part it traced has no device reading (the profiler kept too few kernel
    events in each of its sessions), if
    exp_advanced_split's CA-stubbed variant launched it at all or left its
    stub in place, or if validate_fused_ca prints FAIL; then
    ``gymca_torch.update_gallery`` into a temporary directory where
    gymnasium and matplotlib are installed (said so where not) and
    ``gymca_torch.versionate --dry-run``;
18. a ``[phases]`` line, each phase's seconds and the total; one JSON line
    describing every kernel, one per path (the Alexandridis
    kernel's and K1's with their launches and their errors on each path),
    then ``{"step": ...}``, ``{"advanced_step": ...}``, ``{"bench": ...}``,
    ``{"rng": ...}``,
    ``{"train": ...}``, ``{"helicopter": ...}``, ``{"eval": ...}``,
    ``{"pinecones": ...}``, ``{"legacy": ...}``, ``{"curve": ...}``,
    ``{"policy": ...}``, ``{"parallel": ...}`` and ``{"tools": ...}``;
19. the ``nvidia-smi`` line, then the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  It exits non-zero, printing no result, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
N_ENVS, H, W = 4096, 256, 256
SEED = 0
MAIN_STEPS = 200
# The bench's runs (bench.py: 1000 steps, cut here to the main path's 200).
BENCH_STEPS = MAIN_STEPS
PARITY_ENVS, PARITY_STEPS = 64, 100
TIMING_REPS = 3
# Steps a trace of a step reads (the windy, Advanced, Helicopter and
# evaluation steps): reading a trace back costs seconds per 10,000 kernel
# events, and those steps launch 800-4,300 kernels each.
PROFILE_STEPS = 3
RECORDED_LAUNCHES = 10
KERNEL_REPEATS = 10  # passes over the recorded launches when timing a kernel
# Slice 2: the Advanced env (bench.py:143-195 runs 1000 steps, cut here to
# 100; [bench] runs this cell at 200).
ADV_ENVS, ADV_SIZE, ADV_STEPS = 64, 256, 100
ADV_PARITY_ENVS, ADV_PARITY_SIZE, ADV_PARITY_STEPS = 4, 64, 20
TERRAIN_ODD_SHAPE = (17, 23, 3)  # (H, W, envs): a width with a scalar remainder
K3_ENVS, K3_SIZE, K3_STEPS = 8, 512, 20
DIST_STEPS, DIST_CHECKPOINTS = 300, (100, 200, 300)
# Slice 3: the probes' entry points, their launches per repetition cut from
# 1000 (bench_fused_ca, exp_floor, exp_counts_out) and 120 (the others).
PROBE_S6_STEPS, PROBE_FLOOR_STEPS = 100, 100
CA_VARIANT_LINES = {"banded": 39, "bool": 49, "fma": 94, "swar": 141}  # exp_ca_variants.py
# S4 beside the script's 256 envs: K1's all-CA size, 4096 x 256² (256 MiB of
# grid, past the 50 MB L2), where its bytes bound is read, and a 512² grid.
# (The script's 40 steps a repetition there too: in sessions of 4 or 10
# launches of 0.2-0.7 ms the profiler kept too few kernel events.)
S4_BIG_ENVS = 4096
# S3's one-SM rate: one block walks this many envs (an 8-wide table, 4
# counts), timed against the same launch that reads and writes nothing; and
# one block copies this many bytes with the bulk-copy engine, timed against
# a copy of one 16 KiB chunk (and, beside S3, a copy moving S3's bytes).
S3_STREAM_ENVS = 65536
S3_COPY_BYTES, S3_COPY_SMALL = 1536 * 1024, 16 * 1024
# Slice 5: the trainer.  (a) scripts/run's defaults (scripts/run:42-127), 1
# iteration; (b) round 5's pipeline flags (scripts/sweep_r5_kickstart256.sh)
# at single mode, cut from 32 envs x 128 steps x 1500 iterations (300 BC,
# 150 warmup) to 8 envs x 16 steps x 3 iterations (1 BC, 1 warmup).
TRAIN_ARGV = ["-n", "8", "-z", "256"]
TRAIN_ITERS, TRAIN_PROFILE_STEPS, TRAIN_SPLIT_STEPS = 1, 2, 8
PIPELINE_ARGV = TRAIN_ARGV + ["--num-ppo-steps", "16", "--bf16", "--centroid-features",
                              "--shape-tree-coef", "20", "--shape-dist-coef", "2",
                              "--shape-douse-coef", "20", "--bc-iters", "1",
                              "--critic-warmup-iters", "1", "--kickstart-coef", "1.0"]
PIPELINE_ITERS = 3
# Slice 7.  The Helicopter at its registered size (gymca_tpu/registration.py:
# 15-24, 42²), 4096 envs, and 256 envs at 256²; card against CPU over more
# than three freeze cycles (the CA every 22 steps at 42²).  The evaluation
# at scripts/run's defaults (scripts/run:312-410: 8 envs at 256², single
# mode, the fused kernel), cut from 10,000 steps to 50 per actor.
HELI_SIZE, HELI_ENVS, HELI_STEPS = (42, 42), 4096, 50
HELI_BIG_SIZE, HELI_BIG_ENVS, HELI_BIG_STEPS = (256, 256), 256, 50
HELI_PARITY_ENVS, HELI_PARITY_STEPS = 64, 70
EVAL_ARGV = ["-n", "8", "-z", "256", "--no-train", "--steps", "50"]
# Slice 8.  Pinecones: the Advanced env at the bench's cell (bench.py:143-195,
# 64 x 256²) with enable_pinecones, 10 steps from a reset; card against CPU at
# 4 envs x 64² for 30 steps from a burning block.  The curve:
# scripts/train_curve.py's defaults at 256² (32 envs, 128 steps an iteration)
# with --pallas-ca --bf16, cut from 800 iterations to 1; round 5's recipe
# (scripts/sweep_r5_kickstart256.sh:12-16) cut from 32 envs x 1500
# iterations (300 BC, 150 warmup, decay 900) to 8 envs x 2 iterations in two
# stages (1 BC, 1 warmup, decay 2).  The policy evaluation (the same
# script's :25-27, 16 envs) cut from 20,000 steps to 25 (10 for the modf
# blob).
PINE_ENVS, PINE_SIZE, PINE_STEPS, PINE_PROFILE_STEPS = 64, 256, 10, 1
PINE_PARITY_ENVS, PINE_PARITY_SIZE, PINE_PARITY_STEPS = 4, 64, 30
LEGACY_SIZE, LEGACY_PASSES = 32, 3
CURVE_ITERS = 1
CURVE_ARGV = ["--size", "256", "--num-envs", "32", "--iters", str(CURVE_ITERS), "--pallas-ca",
              "--bf16"]
CURVE_STEPS = 128  # scripts/train_curve.py's steps an iteration
RECIPE_ARGV = ["--size", "256", "--num-envs", "8", "--iters", "2", "--bf16",
               "--ca-repeat-mode", "modf", "--gamma", "0.999", "--shape-tree-coef", "20",
               "--shape-dist-coef", "2", "--shape-douse-coef", "20", "--centroid-features",
               "--bc-iters", "1", "--critic-warmup-iters", "1", "--kickstart-coef", "1.0",
               "--kickstart-decay", "2", "--sm-schedule", "2:0.5,1:0.5"]
POLICY_ENVS, POLICY_STEPS, POLICY_MODF_STEPS = 16, 25, 10
POLICIES = ("trained-greedy", "idle", "random", "greedy-fire")
# Slice 9: parallel/ on a world of one rank (NCCL holds one rank per card).
# (b) the [train] cell through DataParallelPPO, 1 iteration; (c) the spatial
# steps: the windy cell's 268 M cells (4096 x 256²) as one 16384² grid and as
# 4096 envs on a (1, 1) mesh, 10 steps each; the Advanced physics on one
# 4096² grid for 5 steps, at the Advanced cell's 64 x 256² on a (1, 1) mesh
# against 4 envs stepped alone (3 steps), card against CPU at 256² (5 steps);
# (d) bench_scaling at its defaults (scripts/bench_scaling.py:107-109, 4096 x
# 256²), runs of 100 of its 1000 steps.
PAR_ITERS = 1
SPATIAL_BIG, SPATIAL_BIG_STEPS, SPATIAL_BATCH_STEPS = 16384, 10, 10
ADV_SPATIAL_SIZE, ADV_SPATIAL_STEPS = 4096, 5
ADV_BATCH_CHECK_ENVS, ADV_BATCH_CHECK_STEPS, ADV_CPU_STEPS = 4, 3, 5
SCALING_STEPS = 100
# Slice 10: the tools of scripts/ as the port's entry points, at their
# default cells with their steps cut (each part's trace reads at most 10
# steps of a step, all of a kernel alone, and most of the phase's time goes
# to reading traces back): profile_step and exp_split at 4096 x 256²
# (1000 steps each -> 3), bench_advanced and profile_advanced at 8 x 256²
# (1000 -> 3), exp_advanced_split at 64 x 256² (1000 -> 2),
# validate_fused_ca at 64 x 256² (500 -> 100: checkpoint t = 100),
# exp_policy_ceiling at 8 x 256² (6000 -> 20).
TOOLS_WINDY_STEPS, TOOLS_ADV_STEPS, TOOLS_SPLIT_STEPS = 3, 3, 2
TOOLS_VALIDATE_STEPS, TOOLS_POLICY_STEPS = 100, 20
# The default Alexandridis instance's ptxas line (the step, vector form):
# 64 registers, the cap its launch bounds set, and one barrier.
ALEXANDRIDIS_PTXAS = "Used 64 registers, used 1 barriers"

# gymca_torch.probes.kernel_inputs and gymca_torch.probes.timing.profile_steps,
# imported by main() once the checkout is on the path: the kernels' inputs,
# the main paths stepped with random actions and K1's work count; the trace
# of a path (device kernels per step, busy time, idle share).
ki = None
profile_steps = None


def log(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --- kernel inputs -------------------------------------------------------------


def kernel_vs_plain(inputs, empty=0, tree=3, fire=25):
    """Max |kernel - plain| over grids and counts on the same inputs."""
    from gymca_torch.ops.windy_kernel import windy_fused_step, windy_fused_step_plain

    grid, weights, params, edits, edit_counts = inputs
    g_k, c_k = windy_fused_step(grid.clone(), weights, params, edits, edit_counts,
                                empty=empty, tree=tree, fire=fire)
    g_p, c_p = windy_fused_step_plain(grid.clone(), weights, params, edits, edit_counts,
                                      empty=empty, tree=tree, fire=fire)
    torch.cuda.synchronize()
    err = max(
        (g_k.to(torch.int32) - g_p.to(torch.int32)).abs().max().item(),
        (c_k - c_p).abs().max().item(),
    )
    return err, c_p


def check_kernel(label, inputs):
    err, counts = kernel_vs_plain(inputs)
    params = inputs[2]
    n_ca = int((params[:, 0] > 0).sum())
    n_mod = int(((params[:, 0] == 0) & (params[:, 3] > 0)).sum())
    n_hits = int(counts[:, 2].sum())
    log(f"[kernel] windy_sparse {label} {tuple(inputs[0].shape)} {inputs[0].dtype}: "
        f"{n_ca} CA envs, {n_mod} modify-only, {n_hits} hits, "
        f"max_abs_err {err} (tolerance 0)")
    if err != 0:
        fail(f"windy_sparse disagrees with its plain version at {label}")
    return err


# --- the main path -----------------------------------------------------------------


def parity(core, keys, gen):
    """step_batched against the eager batched step, bit for bit."""
    a = core.initial_state(keys)
    b = a.clone()
    actions = ki.draw_actions(gen, PARITY_STEPS, keys.shape[0])
    mismatches = []
    for i, act in enumerate(actions):
        a, out_a = core.step_batched(a, act)
        b, out_b = core.step(b, act)
        pairs = {
            "reward": (out_a.reward, out_b.reward),
            "done": (out_a.terminated, out_b.terminated),
            "hit": (out_a.info["hit"], out_b.info["hit"]),
            "tree_count": (a.context["tree_count"], b.context["tree_count"]),
            "fire_count": (a.context["fire_count"], b.context["fire_count"]),
            "position": (a.context["position"], b.context["position"]),
            "time": (a.context["time"], b.context["time"]),
            "key": (a.key, b.key),
            "grid": (core.materialize_grid(a), b.grid),
        }
        for name, (x, y) in pairs.items():
            if not torch.equal(x, y):
                mismatches.append(f"step {i} {name}")
        if not torch.isfinite(out_a.reward).all():
            mismatches.append(f"step {i} non-finite reward")
    return mismatches, float(b.done.float().mean())


# --- slice 2: the Advanced env and the Alexandridis kernel ----------------------------


def alexandridis_vs_plain(x, kw):
    """Max |kernel - plain| over new grids and ages on the same inputs, and
    the number of trees the kernel ignited."""
    from gymca_torch.ops.alexandridis_kernel import (
        alexandridis_fused_step,
        alexandridis_fused_step_plain,
    )

    g_k, a_k = alexandridis_fused_step(**x, **kw)
    g_p, a_p = alexandridis_fused_step_plain(**x, **kw)
    torch.cuda.synchronize()
    err = max((g_k.to(torch.int32) - g_p.to(torch.int32)).abs().max().item(),
              (a_k - a_p).abs().max().item())
    if torch.isnan(a_k).any() or not torch.equal(torch.isnan(a_k), torch.isnan(a_p)):
        err = float("inf")
    ignited = int(((g_k == kw["fire"]) & (x["grid"] == kw["tree"])).sum())
    return err, ignited


def check_alexandridis(label, x, kw):
    err, ignited = alexandridis_vs_plain(x, kw)
    log(f"[kernel] alexandridis {label} (radius {len(kw['layer_coeffs'])}): {ignited} trees "
        f"ignited, max_abs_err {err} (tolerance 0, grid and age)")
    if err != 0:
        fail(f"alexandridis disagrees with its plain version at {label}")
    return err


def adv_parity(gen):
    """The fused env on the card against the same env on the CPU running
    the kernel's plain version: every leaf, bit for bit."""
    from gymca_torch import rng
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    n, size = ADV_PARITY_ENVS, ADV_PARITY_SIZE
    cpu = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(SEED, device="cpu"),
                                         num_envs=n, use_fused_ca=True, device="cpu")
    gpu = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(SEED, device="cpu"),
                                         num_envs=n, terrain=cpu._terrain_ctx)
    (c_obs, c_info), (g_obs, g_info) = cpu.reset(), gpu.reset()
    mismatches = []
    for i, a in enumerate(ki.adv_actions(gen, ADV_PARITY_STEPS, n)):
        if i == ADV_PARITY_STEPS // 2:  # env 0 loses its fire: reset on both
            for pe in (c_obs[1]["per_env_context"], g_obs[1]["per_env_context"]):
                tg = pe["true_grid"]
                tg[0] = torch.where(tg[0] == 2, 1, tg[0])
        cs = cpu.conditional_reset(cpu.stateless_step(a.cpu(), c_obs, c_info), a.cpu())
        gs = gpu.conditional_reset(gpu.stateless_step(a, g_obs, g_info), a)
        (c_obs, c_info), (g_obs, g_info) = (cs[0], cs[4]), (gs[0], gs[4])
        pairs = {"rgb": (g_obs[0], c_obs[0]), "reward": (gs[1], cs[1]),
                 "position": (g_obs[1]["position"], c_obs[1]["position"]),
                 "time": (g_obs[1]["time"], c_obs[1]["time"])}
        pairs.update({k: (g_obs[1]["per_env_context"][k], v)
                      for k, v in c_obs[1]["per_env_context"].items()})
        pairs.update({f"info.{k}": (g_info[k], v) for k, v in c_info.items()})
        mismatches += [f"step {i} {k}" for k, (x, y) in pairs.items()
                       if not torch.equal(x.cpu(), y)]
        if i == ADV_PARITY_STEPS // 2 and float(c_info["steps_elapsed"][0]) != 0.0:
            mismatches.append(f"step {i}: env 0 was not reset")
    fires = int((c_obs[1]["per_env_context"]["true_grid"] == 2).sum())
    return mismatches, fires


def check_terrain(card_env):
    """The terrain ``card_env`` drew on the card from a card key against the
    CPU's draw from the same seed: the elements of each leaf that differ in
    their bits, printed; any is fatal."""
    from gymca_torch import rng
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    def bits(t):
        if not t.is_floating_point():
            return t
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])

    if card_env.starting_key.device.type != "cuda":
        fail("the card env's terrain was not drawn from a key on the card")
    shape = (card_env.nrows, card_env.ncols, card_env.num_envs)
    t0 = time.perf_counter()
    cpu = AdvancedForestFireBulldozerEnv(*shape[:2], key=rng.key(SEED, device="cpu"),
                                         num_envs=shape[2], device="cpu")
    differing = {k: int((bits(v.cpu()) != bits(cpu._terrain_ctx[k])).sum())
                 for k, v in card_env._terrain_ctx.items()}
    log(f"[terrain] {shape[0]}x{shape[1]} x {shape[2]} envs drawn on the card from key "
        f"{SEED} against the CPU's draw ({time.perf_counter() - t0:.1f}s), elements "
        f"differing per leaf: {differing}")
    if any(differing.values()):
        fail(f"the terrain drawn on the card differs from the CPU's at {shape}: {differing}")


def fire_stats(env, obs, info, steps, checkpoints):
    """Per-env fire count, burned count (trees at the reset that are trees no
    more) and mean age of the burning cells at the checkpoints, the agents
    standing still (as ``scripts/validate_fused_ca_tpu.py`` does)."""
    n = env.num_envs
    stay = torch.tensor([[4, 0, 0]] * n, dtype=torch.int32, device="cuda")
    trees0 = (obs[1]["per_env_context"]["true_grid"] == 1).sum(dim=(1, 2))
    out = {}
    for t in range(1, steps + 1):
        obs, info, _ = ki.adv_run(env, obs, info, [stay])
        if t in checkpoints:
            pe = obs[1]["per_env_context"]
            fire = pe["true_grid"] == 2
            fires = fire.sum(dim=(1, 2))
            age = torch.where(fire, pe["fire_age"], 0.0).sum(dim=(1, 2)) / fires.clamp(min=1)
            burned = trees0 - (pe["true_grid"] == 1).sum(dim=(1, 2))
            out[t] = [v.double().cpu() for v in (fires, burned, age)]
    return out


# --- slice 3: the probes --------------------------------------------------------------


def int_err(a, b):
    """Max |a - b| over two integer tensors of one shape, or inf when only
    one of them is None."""
    if a is None or b is None:
        return 0 if a is None and b is None else float("inf")
    return (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0


def check_ca_variants(n, h, w, steps):
    """The four S4 kernels against their plain versions, step by step, and
    against each other after ``steps`` steps, from one seeded draw."""
    from gymca_torch.probes.ca_variants_kernel import PLAIN, VARIANTS, ca_variant_step
    from gymca_torch.probes.exp_ca_variants import make_inputs

    grid0, weights = make_inputs(n, h, w, SEED, "cuda")
    errs, finals = {}, {}
    for v in VARIANTS:
        if v == "swar" and w % 4:
            try:
                ca_variant_step(v, grid0.clone(), weights)
            except ValueError:
                errs[v] = None  # raises, as it must
                continue
            fail(f"the swar wrapper took W = {w}, which is not a multiple of 4")
        gk, gp, err = grid0.clone(), grid0.clone(), 0
        for _ in range(steps):
            gk, ck = ca_variant_step(v, gk, weights)
            gp, cp = PLAIN[v](gp, weights)
            err = max(err, int_err(gk, gp), int_err(ck, cp))
        errs[v], finals[v] = err, (gk, ck)
    first = next(iter(finals.values()))
    agree = all(torch.equal(g, first[0]) and torch.equal(c, first[1]) for g, c in finals.values())
    fires = int((first[0] == 25).sum())
    log(f"[probe] ca variants ({n}, {h}, {w}) x {steps} steps: max_abs_err against the plain "
        f"versions " + ", ".join(f"{v} {'raises' if e is None else e}" for v, e in errs.items())
        + f" (tolerance 0); the kernels agree with each other: {agree}; {fires} fires at the end")
    if any(e for e in errs.values()) or not agree:
        fail(f"the S4 kernels disagree at ({n}, {h}, {w})")
    return {v: e for v, e in errs.items() if e is not None}


def check_dma_floor(x):
    from gymca_torch.probes.dma_floor_kernel import dma_floor, dma_floor_plain

    args = [x[k] for k in ("grid", "fire_age", "dousing", "vdf", "exp_slope", "wind_rows",
                           "seeds")]
    got, want = dma_floor(*args), dma_floor_plain(*args)
    torch.cuda.synchronize()
    err = max(int_err(got[0], want[0]), int_err(got[2], want[2]),
              (got[1] - want[1]).abs().max().item())
    log(f"[probe] dma_floor {tuple(x['grid'].shape)}: out_grid, out_age and the fold word "
        f"against the plain version, max_abs_err {err} (tolerance 0)")
    if err != 0:
        fail(f"dma_floor disagrees with its plain version at {tuple(x['grid'].shape)}")
    return err


def library_us(fn, calls):
    """Device µs per call of ``fn``, one PyTorch call, from the profiler's
    kernel events (every device kernel it launches), as a kernel is timed."""
    from gymca_torch.probes.timing import time_launches

    return time_launches(lambda: [fn() for _ in range(calls)], calls, "")["device_us"]


def sm_clock_hz():
    """The SM clock's maximum, as ``nvidia-smi`` reports it."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.split()
    return float(out[torch.cuda.current_device()]) * 1e6


def s4_loops():
    """Each S4 formulation's bulk-form inner loop in the SASS of this build
    (cuobjdump -sass): the innermost loop around its 16-byte stores."""
    from gymca_torch import _build
    from gymca_torch.probes import sass
    from gymca_torch.probes.ca_variants_kernel import VARIANTS

    fns = sass.functions(sass.cuobjdump_sass(_build.build(["ca_variants"])["ca_variants"].path))
    out = {}
    for v in VARIANTS:
        inst = [f for name, f in fns.items() if f"ca_{v}_kernelILb1E" in name]
        out[v] = sass.inner_loop(inst[0], "STG.E.128") if len(inst) == 1 else None
        if out[v] is None:
            fail(f"no inner loop with a 16-byte store in the SASS of ca_{v}_kernel<true>")
    return out


def s4_bounds(n, h, w, loop, sms, clock_hz):
    """S4's bounds (ms) for one step of n envs: bytes (the grid read and
    written, weights and counts) at 3.35 TB/s, and each pipe's time for the
    loop's instructions on every 4-cell word (``sass.clocks_per_item``, 4
    words a 16-byte store) on every SM at ``clock_hz``.  Returns
    ``(bytes_ms, {pipe: ms}, bytes)``."""
    from gymca_torch.probes import sass

    words = n * h * w / 4
    moved = 2 * n * h * w + n * (32 + 8)
    per_word = sass.clocks_per_item(loop, 4 * loop.marked)
    sm_s = sms * clock_hz
    return (moved / ki.HBM_BYTES_PER_S * 1e3,
            {p: c * words / sm_s * 1e3 for p, c in per_word.items()}, moved)


def probe_phase(card, gen, adv_recorded):
    """Slice 3: every probe kernel against its plain version, the Alexandridis
    ablations, then the probes' entry points driven with the launch counters
    zeroed before and read after, and each new kernel's times.  Returns the
    new kernels' entries of the ``kernels`` line."""
    import torch.nn.functional as F

    from gymca_torch.ops.alexandridis_kernel import (
        ABLATIONS,
        alexandridis_fused_step,
        alexandridis_fused_step_plain,
    )
    from gymca_torch.probes import (
        bench_fused_ca,
        exp_ca_variants,
        exp_counts_out,
        exp_floor,
        exp_kernel_overhead,
        exp_launch_floor,
        floor_kernel,
    )
    from gymca_torch.probes.ca_variants_kernel import (
        PLAIN,
        VARIANTS,
        ca_variant_step,
    )
    from gymca_torch.probes.dma_floor_kernel import dma_floor, dma_floor_plain, moved_bytes
    from gymca_torch.probes.floor_kernel import (
        FloorVariant,
        one_sm_copy,
        probe_floor,
        probe_floor_plain,
    )
    from gymca_torch.probes.floor_kernel import moved_bytes as floor_bytes
    from gymca_torch.probes.timing import cuda_ms, time_launches

    t0 = time.perf_counter()

    # Kernels against their plain versions (launches not counted).
    ca_err = dict.fromkeys(VARIANTS, 0)
    for n, h, w, steps in ((exp_ca_variants.N, exp_ca_variants.H, exp_ca_variants.W,
                            exp_ca_variants.STEPS), (S4_BIG_ENVS, exp_ca_variants.H,
                                                     exp_ca_variants.W, 3),
                           (2, 512, 512, 5), (8, 64, 128, 10), (4, 40, 52, 10),
                           (4, 40, 50, 10)):
        for v, e in check_ca_variants(n, h, w, steps).items():
            ca_err[v] = max(ca_err[v], e)
    dma_x = {size: ki.alexandridis_inputs(n, size, size, gen)[0]
             for n, size in ((ADV_ENVS, ADV_SIZE), (K3_ENVS, K3_SIZE))}
    dma_err = max(check_dma_floor(x) for x in dma_x.values())
    # Each ablation at both shapes the probes' path times it at: 64 x 256²
    # (radius 6, one tile row) and 8 x 512² (radius 7, tiled).
    for n, size in ((ADV_ENVS, ADV_SIZE), (K3_ENVS, K3_SIZE)):
        x, kw = ki.alexandridis_inputs(n, size, size, gen)
        for ablate in ABLATIONS[1:]:
            g_k, a_k = alexandridis_fused_step(**x, **kw, ablate=ablate)
            g_p, a_p = alexandridis_fused_step_plain(**x, **kw, ablate=ablate)
            torch.cuda.synchronize()
            err = max(int_err(g_k, g_p), (a_k - a_p).abs().max().item())
            if torch.isnan(a_k).any() or not torch.equal(torch.isnan(a_k), torch.isnan(a_p)):
                err = float("inf")
            ignited = int(((g_k == kw["fire"]) & (x["grid"] == kw["tree"])).sum())
            log(f"[probe] alexandridis ablate={ablate!r} {tuple(x['grid'].shape)} radius "
                f"{len(kw['layer_coeffs'])}: {ignited} trees ignited, max_abs_err {err} "
                f"(tolerance 0, grid and age)")
            if err != 0:
                fail(f"the alexandridis {ablate} instance disagrees with its plain version at "
                     f"{tuple(x['grid'].shape)}")
    rec_err = max(alexandridis_vs_plain(rx, rkw)[0] for rx, rkw in adv_recorded[:3])
    log(f"[probe] alexandridis default instance on 3 recorded main-path launches: "
        f"max_abs_err {rec_err} (tolerance 0)")
    if rec_err != 0:
        fail("the default alexandridis instance disagrees with its plain version")

    # The probes' path, through their entry points, counters zeroed just before.
    torch.cuda.synchronize()
    for v in VARIANTS:
        ca_variant_step.launches[v] = 0
    dma_floor.launches = probe_floor.launches = alexandridis_fused_step.launches = 0
    ca_rows = {r["variant"]: r for r in exp_ca_variants.run("cuda")}
    ca_big = {r["variant"]: r for r in exp_ca_variants.run("cuda", n=S4_BIG_ENVS)}
    bench = bench_fused_ca.run("cuda", size=ADV_SIZE, envs=ADV_ENVS, steps=PROBE_S6_STEPS)
    bench_tiled = bench_fused_ca.run("cuda", size=K3_SIZE, envs=K3_ENVS, steps=PROBE_S6_STEPS)
    floor_rows = {}  # each entry point checks every launch configuration it times
    for mod in (exp_counts_out, exp_launch_floor, exp_kernel_overhead, exp_floor):
        floor_rows.update((r["label"], r) for r in mod.run("cuda", steps=PROBE_FLOOR_STEPS))
    torch.cuda.synchronize()
    launches = {**{f"ca_variant_{v}": ca_variant_step.launches[v] for v in VARIANTS},
                "dma_floor": dma_floor.launches, "probe_floor": probe_floor.launches,
                "alexandridis (4 instances)": alexandridis_fused_step.launches}
    log(f"[probe] entry points exp_ca_variants (and at {S4_BIG_ENVS} envs), "
        f"bench_fused_ca at {ADV_ENVS} x {ADV_SIZE}² and "
        f"{K3_ENVS} x {K3_SIZE}² ({PROBE_S6_STEPS} launches per repetition), exp_counts_out, "
        f"exp_launch_floor, exp_kernel_overhead, exp_floor ({PROBE_FLOOR_STEPS} launches per "
        f"repetition): launches {launches}")
    if not all(launches.values()):
        fail(f"a probe kernel was never launched on the probes' path: {launches}")

    # S4: each formulation's time beside its instruction bound (the busiest
    # pipe) at both sizes.  At 256 envs the 16 MiB grid stays in the 50 MB
    # L2 across the in-place steps, so the HBM bytes bound is no floor there
    # and no share is given; at 4096 envs (256 MiB) the bound is the larger
    # of the two, and the share is read there.  Then the formulations' order.
    loops = s4_loops()
    sms, clock_hz = torch.cuda.get_device_properties(0).multi_processor_count, sm_clock_hz()
    s4_bound = {}
    h, w = exp_ca_variants.H, exp_ca_variants.W
    for n, rows in ((exp_ca_variants.N, ca_rows), (S4_BIG_ENVS, ca_big)):
        for v in VARIANTS:
            r, loop = rows[v], loops[v]
            bytes_ms, pipes, moved = s4_bounds(n, h, w, loop, sms, clock_hz)
            pipe = max(pipes, key=pipes.get)
            in_l2 = n == exp_ca_variants.N
            s4_bound[n, v] = (pipes[pipe], "operations") if in_l2 else max(
                (bytes_ms, "bytes"), (pipes[pipe], "operations"))
            log(f"[time] [{card}] ca_{v} {n} x {h}x{w}: {r['device_us']} us/step of device "
                f"time ({r['device_us'] * 1e3 / n} ns/grid), host {r['host_us']} us/step, "
                f"{exp_ca_variants.STEPS} steps, 3 repetitions; inner loop "
                f"{loop.instructions} SASS instructions at {loop.start:#x}-{loop.end:#x} for "
                f"{4 * loop.marked} words ({loop.marked} 16-byte stores), "
                f"{loop.instructions / (4 * loop.marked)} a word, {dict(loop.opcodes)}; "
                f"{n * h * w // 4} words on {sms} SMs at {clock_hz / 1e6} MHz by pipe: "
                + ", ".join(f"{p} {t * 1e3} us" for p, t in pipes.items())
                + f" ({pipe} bounds); bytes {moved / 1e6} MB, at 3.35 TB/s {bytes_ms * 1e3} us"
                + ("; the grid stays in L2, so the bytes bound is no floor: bound "
                   f"{s4_bound[n, v][0] * 1e3} us by {pipe}, no share" if in_l2 else
                   f"; bound {s4_bound[n, v][0] * 1e3} us by {s4_bound[n, v][1]}, share "
                   f"{s4_bound[n, v][0] * 1e3 / r['device_us']}"))
        order = sorted(VARIANTS, key=lambda v: rows[v]["device_us"])
        log(f"[probe] S4 formulations at {n} x {exp_ca_variants.H}², fastest first: "
            + " < ".join(f"{v} {rows[v]['device_us']} us" for v in order))
    for label, b in ((f"{ADV_ENVS} x {ADV_SIZE}²", bench), (f"{K3_ENVS} x {K3_SIZE}²",
                                                             bench_tiled)):
        log(f"[time] [{card}] bench_fused_ca {label} (radius {b['radius']}): " + "; ".join(
            f"{m} {b[f'{m}_us']} us/launch device, {b[f'{m}_host_us']} host"
            for m in bench_fused_ca.MODES))
    floor_err = max(r["max_abs_err"] for r in floor_rows.values())
    combos = sorted({(r["table_w"], r["counts_w"], r["staged"]) for r in floor_rows.values()})
    log(f"[probe] probe_floor at the {len(floor_rows)} launch configurations of the entry "
        f"points (table_w, counts_w, staged: {combos}), each against its plain version by the "
        f"entry point: max_abs_err {floor_err} (tolerance 0)")
    if floor_err != 0:
        fail("probe_floor disagrees with its plain version")
    # The library yardstick: where the counts are [p[e, 4], p[e, 5], 0, 0]
    # cut to counts_w, one F.pad of the table computes them; timed on each
    # row's own table (the one its entry point drew), and held to the plain
    # version.
    for mod in (exp_counts_out, exp_launch_floor, exp_kernel_overhead, exp_floor):
        for v, table in zip(mod.VARIANTS, floor_kernel.variant_tables(mod.VARIANTS, "cuda")):
            floor_rows[v.label]["library_us"] = None
            if v.table_w < 6 or not v.counts_w:
                continue

            def pad(table=table, c=v.counts_w):
                return F.pad(table[:, 4:6], (0, c - 2))

            if not torch.equal(pad(), probe_floor_plain(v.n, table, counts_w=v.counts_w)):
                fail(f"F.pad of the table differs from probe_floor's plain version: {v.label}")
            floor_rows[v.label]["library_us"] = library_us(pad, PROBE_FLOOR_STEPS)
    for label, r in floor_rows.items():
        log(f"[time] [{card}] probe_floor {label}: {r['device_us']} us/launch device, "
            f"{r['host_us']} us/launch host (N={r['n']}, {r['envs_per_block']} envs/block, "
            f"table {r['table_w']}, counts {r['counts_w']}, staged {r['staged']}, grid "
            f"{r['grid']}); library F.pad {r['library_us']} us; bound max(bytes "
            f"{r['bytes'] / ki.HBM_BYTES_PER_S * 1e6} us, the launch floor)")
    # S3's bound at 4096 envs a block: one SM by the probe's definition, so the
    # launch floor (S5's A) plus its bytes at the rate one SM reaches.  That
    # rate is the faster of two loaders: one block of the bulk-copy engine
    # (one_sm_copy, which owes nothing to the probe) copying S3_COPY_BYTES
    # against a copy of one chunk, and the probe's own kernel over
    # S3_STREAM_ENVS envs against the same launch moving nothing.
    s3 = exp_kernel_overhead.VARIANTS[-1]
    s3_bytes = floor_bytes(s3.n, s3.table_w, s3.counts_w)
    src = torch.randint(-128, 128, (S3_COPY_BYTES,), generator=gen, device="cuda",
                        dtype=torch.int8)
    copies = {}
    for size in (S3_COPY_SMALL, s3_bytes // 2, S3_COPY_BYTES):
        dst = torch.zeros_like(src[:size])
        if not torch.equal(one_sm_copy(src[:size], dst), src[:size]):
            fail(f"one_sm_copy of {size} B differs from its source")
        copies[size] = time_launches(
            lambda size=size, dst=dst: [one_sm_copy(src[:size], dst)
                                        for _ in range(PROBE_FLOOR_STEPS)],
            PROBE_FLOOR_STEPS, "one_sm_copy_kernel")["device_us"]
    copy_rate = 2 * (S3_COPY_BYTES - S3_COPY_SMALL) / (
        (copies[S3_COPY_BYTES] - copies[S3_COPY_SMALL]) * 1e-6)
    stream = floor_kernel.run_variants(
        [FloorVariant("one block, nothing moved", S3_STREAM_ENVS, S3_STREAM_ENVS, 0, 0),
         FloorVariant("one block, 8-wide table, 4 counts", S3_STREAM_ENVS, S3_STREAM_ENVS, 8, 4)],
        PROBE_FLOOR_STEPS, "cuda", h=1, w=1)
    stream_bytes = floor_bytes(S3_STREAM_ENVS, 8, 4)
    probe_rate = stream_bytes / ((stream[1]["device_us"] - stream[0]["device_us"]) * 1e-6)
    sm_bytes_per_s = max(copy_rate, probe_rate)
    launch_floor_us = floor_rows[exp_floor.VARIANTS[0].label]["device_us"]
    s3_bound_us = launch_floor_us + s3_bytes / sm_bytes_per_s * 1e6
    log(f"[time] [{card}] S3 {s3.label}: {floor_rows[s3.label]['device_us']} us/launch; one "
        f"block of the bulk-copy engine copies {S3_COPY_BYTES} B in {copies[S3_COPY_BYTES]} "
        f"us against {copies[S3_COPY_SMALL]} us for {S3_COPY_SMALL} B: {copy_rate / 1e9} GB/s "
        f"read and written (a copy moving S3's {s3_bytes} B, launch included: "
        f"{copies[s3_bytes // 2]} us); the probe's one block over {S3_STREAM_ENVS} envs moving "
        f"{stream_bytes} B takes {stream[1]['device_us']} us against "
        f"{stream[0]['device_us']} us moving nothing: {probe_rate / 1e9} GB/s; bound = the "
        f"launch floor (S5 A) {launch_floor_us} us + {s3_bytes} B at the faster "
        f"{sm_bytes_per_s / 1e9} GB/s = {s3_bound_us} us, share "
        f"{s3_bound_us / floor_rows[s3.label]['device_us']}; library F.pad "
        f"{floor_rows[s3.label]['library_us']} us")

    # The kernels line: bounds from this run's inputs, plain versions timed.
    # S4 at 4096 envs, where its bytes bound is a floor (the grid past L2).
    entries = []
    grid0, weights = exp_ca_variants.make_inputs(S4_BIG_ENVS, exp_ca_variants.H,
                                                 exp_ca_variants.W, SEED, "cuda")
    for v in VARIANTS:
        scratch = grid0.clone()
        entries.append(dict(
            name=f"ca_variant_{v}", route="cuda", source="gymca_torch/csrc/ca_variants.cu",
            replaces=f"scripts/exp_ca_variants.py:{CA_VARIANT_LINES[v]}",
            launches=launches[f"ca_variant_{v}"], max_abs_err=ca_err[v],
            ms=ca_big[v]["device_us"] / 1e3,
            plain_ms=cuda_ms(lambda: PLAIN[v](scratch, weights), 3),
            bound_ms=s4_bound[S4_BIG_ENVS, v][0],
            bound_by=s4_bound[S4_BIG_ENVS, v][1], library_ms=None))
    del grid0, scratch
    xd = dma_x[ADV_SIZE]
    dma_args = [xd[k] for k in ("grid", "fire_age", "dousing", "vdf", "exp_slope", "wind_rows",
                                "seeds")]
    entries.append(dict(
        name="dma_floor", route="cuda", source="gymca_torch/csrc/dma_floor.cu",
        replaces="scripts/bench_fused_ca.py:118", launches=launches["dma_floor"],
        max_abs_err=dma_err, ms=bench["dma-floor_us"] / 1e3,
        plain_ms=cuda_ms(lambda: dma_floor_plain(*dma_args), 3),
        bound_ms=moved_bytes(ADV_ENVS, ADV_SIZE, ADV_SIZE) / ki.HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None))
    fv = exp_floor.VARIANTS[-2]  # F: 16-wide table, 4 counts, 32 blocks
    table = torch.randint(0, 100, (fv.n, fv.table_w), generator=gen, device="cuda",
                          dtype=torch.int32)
    entries.append(dict(
        name="probe_floor", route="cuda", source="gymca_torch/csrc/probe_floor.cu",
        replaces="scripts/exp_floor.py:42", launches=launches["probe_floor"],
        max_abs_err=floor_err, ms=floor_rows[fv.label]["device_us"] / 1e3,
        plain_ms=cuda_ms(lambda: probe_floor_plain(fv.n, table, counts_w=fv.counts_w), 3),
        bound_ms=floor_bytes(fv.n, fv.table_w, fv.counts_w) / ki.HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=floor_rows[fv.label]["library_us"] / 1e3))
    log(f"[time] [{card}] probe kernels' bounds: ca variants above; dma_floor "
        f"{moved_bytes(ADV_ENVS, ADV_SIZE, ADV_SIZE) / 1e6} MB/launch = "
        f"{entries[-2]['bound_ms'] * 1e3} us at {ADV_ENVS} x {ADV_SIZE}², "
        f"{moved_bytes(K3_ENVS, K3_SIZE, K3_SIZE) / 1e6} MB = "
        f"{moved_bytes(K3_ENVS, K3_SIZE, K3_SIZE) / ki.HBM_BYTES_PER_S * 1e6} us at {K3_ENVS} x "
        f"{K3_SIZE}²; probe_floor (F) {floor_bytes(fv.n, fv.table_w, fv.counts_w) / 1e6} MB = "
        f"{entries[-1]['bound_ms'] * 1e3} us by bytes, far under its launch floor; plain "
        f"versions (CUDA events): " + ", ".join(f"{e['name']} {e['plain_ms'] * 1e3} us"
                                                 for e in entries))
    log(f"[probe] phase took {time.perf_counter() - t0:.1f}s")
    return entries


# --- slice 5: the trainer --------------------------------------------------------------


def params_equal(a, b, groups):
    return all(torch.equal(a[g][k], b[g][k]) for g in groups for k in a[g])


def finite(metrics):
    return all(math.isfinite(v) for v in metrics.values())


def train_phase(card):
    """(a)-(d) of the ``[train]`` phase (module docstring, phase 9)."""
    from gymca_torch import rng
    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
    from gymca_torch.ops.windy_kernel import windy_fused_step
    from gymca_torch.run import args_to_structured_args, build_env, parse_args

    t_phase = time.perf_counter()
    counters = (alexandridis_fused_step, windy_fused_step)

    def trainer_for(argv):
        args = args_to_structured_args(parse_args(argv))
        env = build_env(args)
        if not env.use_fused_ca:
            fail("the trainer's env does not take the fused kernel on the card")
        return PPOTrainer(env, args, key=rng.key(args.exp.seed)), args

    def fresh_carry(tr, state=None):
        obs, info = tr.env.reset()
        n = tr.args.env.num_envs
        return (state or tr.agent_state, EpisodeStatistics.create(n), obs,
                torch.zeros(n, dtype=torch.bool, device="cuda"), info, tr.key)

    # (a) scripts/run's defaults: train() for TRAIN_ITERS iterations
    tr, args = trainer_for(TRAIN_ARGV)
    steps = args.exp.num_ppo_steps
    log(f"[train] (a) scripts/run defaults: {args.env.num_envs} envs at {args.env.size}², "
        f"{steps} steps, {args.ppo.update_epochs} epochs of {args.ppo.num_minibatches} "
        f"minibatches of {args.minibatch_size}; params {tr.param_counts}; convs at torch's "
        f"default precision on the card (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}), "
        f"dense layers float32 (cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32})")
    start_params = tr.agent_state.params
    torch.cuda.synchronize()
    held_mib = torch.cuda.memory_allocated() / 2**20  # earlier phases' tensors and the trainer
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    # the kernel's inputs at the first and last launch of each iteration
    keep = {i * steps + j for i in range(TRAIN_ITERS) for j in (0, steps - 1)}
    t0 = time.perf_counter()
    with ki.alexandridis_recorder(keep) as train_recorded:
        state, history = tr.train(num_iterations=TRAIN_ITERS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k2_launches, k1_launches = (c.launches for c in counters)
    log(f"[train] (a) train(): {TRAIN_ITERS} iterations in {train_s:.2f}s, {k2_launches} "
        f"alexandridis launches ({k1_launches} windy); SPS "
        + ", ".join(str(h["SPS"]) for h in history) + "; last metrics "
        + json.dumps(history[-1]))
    if k2_launches != TRAIN_ITERS * steps:
        fail(f"expected {TRAIN_ITERS * steps} alexandridis launches in train(), got "
             f"{k2_launches}")
    if not all(finite(h) for h in history):
        fail("the trainer's metrics are not finite")
    groups = tuple(state.params)
    if all(params_equal({g: start_params[g]}, {g: state.params[g]}, (g,)) for g in groups):
        fail("train() left the params where they started")
    k2_err = max(alexandridis_vs_plain(x, kw)[0] for x, kw in train_recorded)
    log(f"[kernel] alexandridis on the trainer's inputs ({len(train_recorded)} launches of "
        f"train() recorded, at steps {sorted(keep)}): max_abs_err {k2_err} (tolerance 0, "
        f"grid and age)")
    if len(train_recorded) != len(keep) or k2_err != 0:
        fail("alexandridis disagrees with its plain version on the trainer's inputs")

    # one more iteration, rollout and GAE + update apart, each with no host sync
    carry = fresh_carry(tr, state)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        after, storage = tr.rollout(*carry)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        new_state, losses, _, _ = tr.learn(after[0], after[2], after[3], storage, after[5])
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rollout_ms, update_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    if alexandridis_fused_step.launches != steps:
        fail(f"expected {steps} alexandridis launches in the rollout, got "
             f"{alexandridis_fused_step.launches}")
    if not all(torch.isfinite(v) for v in losses.values()):
        fail("the update's losses are not finite")
    log(f"[train] (a) [{card}] one iteration under sync_debug_mode=error in both parts: "
        f"rollout {rollout_ms} ms ({steps} steps, {alexandridis_fused_step.launches} "
        f"alexandridis launches), GAE + update {update_ms} ms")

    # env step against policy forward, each to a synchronize
    obs, info, key = carry[2], carry[4], carry[5]
    env_s = pol_s = 0.0
    for _ in range(TRAIN_SPLIT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        action, _, _, key = tr.get_action_and_value(new_state, obs, key)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = tr.env.conditional_reset(tr.env.stateless_step(action, obs, info), action)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        obs, info = out[0], out[4]
        pol_s, env_s = pol_s + t1 - t0, env_s + t2 - t1
    env_ms, pol_ms = env_s * 1e3 / TRAIN_SPLIT_STEPS, pol_s * 1e3 / TRAIN_SPLIT_STEPS
    log(f"[train] (a) [{card}] a rollout step, host clock to a synchronize, mean of "
        f"{TRAIN_SPLIT_STEPS}: env step (stateless_step + conditional_reset) {env_ms} ms, "
        f"policy forward and sampling {pol_ms} ms")

    # profiles: TRAIN_PROFILE_STEPS rollout steps and one GAE + update; an
    # iteration composed of them, the rollout's per-step numbers times its steps
    short = tr.args.exp.num_ppo_steps
    tr.args.exp.num_ppo_steps = TRAIN_PROFILE_STEPS
    try:
        roll_prof = profile_steps(lambda: tr.rollout(*carry), TRAIN_PROFILE_STEPS,
                                  f"trainer rollout {args.env.num_envs} x {args.env.size}²",
                                  card)
    finally:
        tr.args.exp.num_ppo_steps = short
    upd_prof = profile_steps(lambda: tr.learn(after[0], after[2], after[3], storage, after[5]),
                             1, f"trainer GAE + update over {args.batch_size} samples", card)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if roll_prof is None or upd_prof is None:
        fail("the profiler saw no device time in the trainer's rollout or update")
    kernels = roll_prof["kernels_per_step"] * steps + upd_prof["kernels_per_step"]
    busy = roll_prof["busy_us_per_step"] * steps + upd_prof["busy_us_per_step"]
    span = roll_prof["span_us_per_step"] * steps + upd_prof["span_us_per_step"]
    iteration = {"kernels_per_iteration": kernels, "idle_share": 1.0 - busy / span,
                 "device_busy_ms_per_iteration": busy / 1e3,
                 "rollout_kernels_per_step": roll_prof["kernels_per_step"],
                 "rollout_idle_share": roll_prof["idle_share"],
                 "update_kernels": upd_prof["kernels_per_step"],
                 "update_idle_share": upd_prof["idle_share"]}
    log(f"[train] (a) [{card}] an iteration composed from {TRAIN_PROFILE_STEPS} traced "
        f"rollout steps x {steps} and the traced update: {kernels} device kernels, device "
        f"busy {busy / 1e3} ms, idle share {iteration['idle_share']}")
    rec_mib = sum(t.numel() * t.element_size() for x, _ in train_recorded
                  for t in x.values()) / 2**20
    log(f"[train] (a) [{card}] peak memory allocated {peak_mib} MiB, {held_mib} MiB of it "
        f"held before train() (the earlier phases' tensors, the trainer's params) and "
        f"{rec_mib} MiB the recorded kernel inputs; (a) took "
        f"{time.perf_counter() - t_phase:.1f}s")

    # (b) round 5's pipeline flags, cut
    ptr, pargs = trainer_for(PIPELINE_ARGV)
    pargs.exp.checkpoint_every = 1

    class Recorder:
        """Stands in for a checkpoint manager: keeps each iteration's state."""

        def __init__(self):
            self.states = {}

        def save_state(self, step, agent_state, key):
            self.states[step] = agent_state

    rec = Recorder()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    bc = ptr.bc_pretrain(pargs.exp.bc_iters)
    cloned = ptr.agent_state.params
    _, p_hist = ptr.train(num_iterations=PIPELINE_ITERS, checkpoint_manager=rec)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    p_steps = pargs.exp.num_ppo_steps
    want = (pargs.exp.bc_iters + PIPELINE_ITERS) * p_steps
    log(f"[train] (b) round 5's pipeline at single mode, {pargs.env.num_envs} envs x {p_steps} "
        f"steps x {PIPELINE_ITERS} iterations (cut from 32 x 128 x 1500, BC 300 -> "
        f"{pargs.exp.bc_iters}, warmup 150 -> {pargs.exp.critic_warmup_iters}): {p_s:.2f}s, "
        f"{alexandridis_fused_step.launches} alexandridis launches; BC {json.dumps(bc)}; "
        f"losses " + ", ".join(f"{h['loss']}" for h in p_hist))
    if alexandridis_fused_step.launches != want:
        fail(f"expected {want} alexandridis launches in the pipeline, got "
             f"{alexandridis_fused_step.launches}")
    if not finite(bc) or not all(finite(h) for h in p_hist):
        fail("the pipeline's metrics are not finite")
    warm = rec.states[1].params
    frozen = params_equal(cloned, warm, ("network_params", "actor_params"))
    critic_moved = not params_equal(cloned, warm, ("critic_params",))
    actor_moved = not params_equal(warm, rec.states[PIPELINE_ITERS].params, ("actor_params",))
    log(f"[train] (b) after the critic-only iteration torso and actor bit-identical: {frozen}; "
        f"critic moved: {critic_moved}; the actor moved in the kickstart iterations: "
        f"{actor_moved}")
    if not (frozen and critic_moved and actor_moved):
        fail("the critic-warmup iteration did not freeze torso and actor alone")

    # (c) card against CPU on the trained weights and the same observations
    cpu_params = {g: {k: v.cpu() for k, v in d.items()} for g, d in state.params.items()}
    grid = carry[2][0]

    def heads(params, g):
        hidden = tr._torso(params, g, None)
        return [hidden] + tr._actor_logits(params, hidden) + [tr._value(params, hidden)]

    with torch.no_grad():
        want_cpu = heads(cpu_params, grid.cpu())
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            got_f32 = heads(state.params, grid)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        got_default = heads(state.params, grid)

    def err(got):
        return max((g.cpu() - w).abs().max().item() for g, w in zip(got, want_cpu))

    bad = [i for i, (g, w) in enumerate(zip(got_f32, want_cpu))
           if not torch.allclose(g.cpu(), w, rtol=1e-4, atol=1e-5)]
    f32_err, default_err = err(got_f32), err(got_default)
    log(f"[train] (c) network, heads and value on {grid.shape[0]} observations at "
        f"{args.env.size}², card against CPU: float32 with TF32 off max_abs_err {f32_err} "
        f"(rtol 1e-4, atol 1e-5); at the trainer's default precision {default_err}")
    if bad:
        fail(f"the networks on the card differ from the CPU beyond tolerance: outputs {bad}")

    log(f"[train] (b) and (c) done at {time.perf_counter() - t_phase:.1f}s")

    # (d) determinism: at (a)'s cell, scripts/run's defaults, the trainer
    # must repeat itself bit for bit (the JAX trainer's iteration is a pure
    # function, tests/test_ppo.py:71); at (b)'s size, reported
    def twice(t):
        c = fresh_carry(t)
        a, b = t.train_iteration(*c), t.train_iteration(*c)
        same_m = all(torch.equal(a[-1][k], b[-1][k]) for k in a[-1])
        return same_m, params_equal(a[0].params, b[0].params, tuple(a[0].params))

    default_cell = twice(tr)
    log(f"[train] (d) train_iteration twice from one carry at scripts/run's defaults "
        f"({args.env.num_envs} envs x {steps} steps, {args.ppo.num_minibatches} minibatches "
        f"of {args.minibatch_size}, cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}), "
        f"(metrics, params) bit for bit: {default_cell}")
    if default_cell != (True, True):
        fail("the trainer does not repeat itself bit for bit at scripts/run's defaults")
    dtr, _ = trainer_for(TRAIN_ARGV + ["--num-ppo-steps", "16"])
    det = {"float32_defaults": twice(dtr), "pipeline_flags": twice(ptr)}
    log(f"[train] (d) train_iteration twice from one carry at {pargs.env.num_envs} envs x "
        f"{p_steps} steps, (metrics, params) bit for bit: {det}")
    det["default_cell"] = default_cell
    log(f"[train] phase took {time.perf_counter() - t_phase:.1f}s")
    return state, {
        "card": card, "envs": args.env.num_envs, "size": args.env.size, "steps": steps,
        "iterations": TRAIN_ITERS, "samples_per_s": history[-1]["SPS"],
        "sps_per_iteration": [h["SPS"] for h in history],
        "alexandridis_launches": k2_launches, "alexandridis_recorded_launches":
        len(train_recorded), "alexandridis_max_abs_err": k2_err, "rollout_ms": rollout_ms,
        "update_ms": update_ms, "env_step_ms": env_ms, "policy_ms": pol_ms, **iteration,
        "peak_memory_mib": peak_mib, "memory_held_before_mib": held_mib,
        "memory_recorded_inputs_mib": rec_mib,
        "card_vs_cpu_float32_max_abs_err": f32_err,
        "card_vs_cpu_default_precision_max_abs_err": default_err,
        "conv_tf32": torch.backends.cudnn.allow_tf32,
        "deterministic": {k: {"metrics": v[0], "params": v[1]} for k, v in det.items()},
    }


# --- slice 7: the Helicopter and the evaluation mode ------------------------------------


def named_leaves(tree, prefix=""):
    """``{path: tensor}`` of a nest of dicts, tuples and dataclasses."""
    import dataclasses

    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(named_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def leaf_mismatches(a, b, where):
    """The paths of the tensor leaves of two like nests that differ (tensors
    compared on the host)."""
    la, lb = named_leaves(a), named_leaves(b)
    if sorted(la) != sorted(lb):
        return [f"{where} leaves {sorted(set(la) ^ set(lb))}"]
    return [f"{where} {k}" for k, x in la.items() if isinstance(x, torch.Tensor)
            and not torch.equal(x.cpu(), lb[k].cpu())]


def without_sync(fn):
    """``fn()`` under ``set_sync_debug_mode("error")``, timed to a
    synchronize: ``(its result, seconds)``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)


def helicopter_phase(card, gen):
    """``[helicopter]`` (module docstring, phase 10)."""
    from gymca_torch import rng
    from gymca_torch.core.env import autoreset_step
    from gymca_torch.envs.helicopter import HelicopterCore
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
    from gymca_torch.ops.windy_kernel import windy_fused_step

    t_phase = time.perf_counter()
    h, w = HELI_SIZE

    def run(core, n, steps):
        state = core.initial_state(rng.split(rng.key(SEED), n))
        actions = torch.randint(0, 9, (steps, n), generator=gen, device="cuda",
                                dtype=torch.int32)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            for a in actions:
                state, out = autoreset_step(core, state, a)
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return state, out, dt

    def check_out(state, out, core, label):
        values = torch.unique(state.grid).tolist()
        ok = (set(values) <= {core._empty, core._tree, core._fire}
              and bool(torch.isfinite(out.reward).all())
              and bool(((out.reward >= -1) & (out.reward <= 1)).all())
              and not bool(out.terminated.any()))
        if not ok:
            fail(f"the Helicopter at {label} gave cells {values} or rewards out of [-1, 1]")

    core = HelicopterCore(h, w)
    for c in (alexandridis_fused_step, windy_fused_step):
        c.launches = 0
    rates = []
    for _ in range(TIMING_REPS):
        state, out, dt = run(core, HELI_ENVS, HELI_STEPS)
        rates.append(HELI_ENVS * HELI_STEPS / dt)
    check_out(state, out, core, f"{HELI_ENVS} x {h}x{w}")
    launches = alexandridis_fused_step.launches + windy_fused_step.launches
    freeze = int(state.context["freeze"][0])
    log(f"[helicopter] [{card}] HelicopterCore({h}, {w}) (max_freeze {core._max_freeze}), "
        f"{HELI_ENVS} envs, {HELI_STEPS} autoreset_steps under sync_debug_mode=error, best of "
        f"{TIMING_REPS}: {max(rates)} env-steps/s ({HELI_ENVS * 1e3 / max(rates)} ms/step); "
        f"reps {rates}; freeze at the end {freeze}; mean reward {out.reward.mean().item()}; "
        f"hand-written kernel launches {launches} (the CA is plain torch ops, as the JAX "
        f"package's is plain XLA)")

    big = HelicopterCore(*HELI_BIG_SIZE)
    state, out, dt = run(big, HELI_BIG_ENVS, HELI_BIG_STEPS)
    check_out(state, out, big, f"{HELI_BIG_ENVS} x {HELI_BIG_SIZE}")
    big_rate = HELI_BIG_ENVS * HELI_BIG_STEPS / dt
    log(f"[helicopter] [{card}] HelicopterCore{HELI_BIG_SIZE}, {HELI_BIG_ENVS} envs, "
        f"{HELI_BIG_STEPS} autoreset_steps under sync_debug_mode=error: {big_rate} "
        f"env-steps/s ({dt * 1e3 / HELI_BIG_STEPS} ms/step)")

    # the card against the CPU, bit for bit, over more than three freeze cycles
    cpu = HelicopterCore(h, w, device="cpu")
    keys = rng.split(rng.key(SEED + 1), HELI_PARITY_ENVS)
    a, b = (core.initial_state(keys), None), (cpu.initial_state(keys.cpu()), None)
    actions = torch.randint(0, 9, (HELI_PARITY_STEPS, HELI_PARITY_ENVS), generator=gen,
                            device="cuda", dtype=torch.int32)
    mismatches, ca_steps = [], 0
    for t, act in enumerate(actions):
        ca_steps += int(a[0].context["freeze"][0] == 0)
        a = autoreset_step(core, a[0], act)
        b = autoreset_step(cpu, b[0], act.cpu())
        mismatches += leaf_mismatches(a, b, f"step {t}")
    log(f"[helicopter] card against CPU, {HELI_PARITY_ENVS} envs at {h}x{w}, "
        f"{HELI_PARITY_STEPS} autoreset_steps ({ca_steps} CA applications per env): "
        f"{len(mismatches)} leaf mismatches {mismatches[:5]}")
    if mismatches or ca_steps < 3:
        fail("the Helicopter on the card differs from the CPU")

    state0 = core.initial_state(rng.split(rng.key(SEED), HELI_ENVS))
    acts = torch.randint(0, 9, (PROFILE_STEPS, HELI_ENVS), generator=gen, device="cuda",
                         dtype=torch.int32)

    def steps():
        st = state0
        for act in acts:
            st, _ = autoreset_step(core, st, act)

    steps()  # warm
    prof = profile_steps(steps, PROFILE_STEPS,
                         f"Helicopter autoreset_step {HELI_ENVS} x {h}x{w}", card)
    if prof is None:
        fail("the profiler saw no device time in the Helicopter's step")
    log(f"[helicopter] phase took {time.perf_counter() - t_phase:.1f}s")
    return {"card": card, "envs": HELI_ENVS, "size": [h, w], "steps": HELI_STEPS,
            "env_steps_per_sec": max(rates), "env_steps_per_sec_reps": rates,
            "big": {"envs": HELI_BIG_ENVS, "size": list(HELI_BIG_SIZE),
                    "steps": HELI_BIG_STEPS, "env_steps_per_sec": big_rate},
            "card_vs_cpu_mismatches": len(mismatches), **prof}


def eval_phase(card, trained_state):
    """``[eval]`` (module docstring, phase 11)."""
    from gymca_torch.agents.checkpoint import CheckpointManager
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
    from gymca_torch.run import (
        args_to_structured_args,
        build_env,
        eval_loop,
        make_actor,
        parse_args,
    )

    t_phase = time.perf_counter()
    args = args_to_structured_args(parse_args(EVAL_ARGV))
    env = build_env(args)
    if not env.use_fused_ca:
        fail("the evaluation's env does not take the fused kernel on the card")
    env.reset()  # warm: copies its tables to the card once, before the sync check
    actors = {name: make_actor(args, env, name) for name in ("random", "scripted")}
    with tempfile.TemporaryDirectory() as ckpt:
        CheckpointManager(ckpt).save_state(1, trained_state,
                                           torch.zeros(2, dtype=torch.int64, device="cuda"))
        args.exp.params_path = ckpt
        actors["params"] = make_actor(args, env, "params")  # load_actor restores it here
    args.exp.params_path = None
    steps = args.viz.steps
    keep = {0, steps - 1}
    out, recorded, total = {}, [], 0
    for actor, get_action in actors.items():
        torch.cuda.synchronize()
        alexandridis_fused_step.launches = 0
        with ki.alexandridis_recorder(keep) as rec:
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                result = eval_loop(env, get_action, steps)
                torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
        launches = alexandridis_fused_step.launches
        total += launches
        recorded += rec
        r = result.rewards
        ok = (tuple(r.shape) == (steps, args.env.num_envs) and bool(torch.isfinite(r).all())
              and bool(((r <= 0) & (r >= -1)).all()))
        log(f"[eval] [{card}] actor {actor}: {steps} steps of {args.env.num_envs} envs at "
            f"{args.env.size}² under sync_debug_mode=error in {dt:.3f}s, {steps / dt} "
            f"steps/s ({args.env.num_envs * steps / dt} env-steps/s), {launches} "
            f"alexandridis launches; mean reward/env {result.total_reward.mean().item()}")
        if launches != steps:
            fail(f"expected one alexandridis launch a step in the {actor} evaluation, got "
                 f"{launches} in {steps} steps")
        if not ok:
            fail(f"the {actor} evaluation's rewards are not finite in [-1, 0]")
        out[actor] = {"steps_per_s": steps / dt, "alexandridis_launches": launches,
                      "mean_reward": result.total_reward.mean().item()}
    err = max(alexandridis_vs_plain(x, kw)[0] for x, kw in recorded)
    log(f"[kernel] alexandridis on the evaluation's inputs ({len(recorded)} launches recorded, "
        f"the first and last of each actor): max_abs_err {err} (tolerance 0, grid and age)")
    if len(recorded) != 3 * len(keep) or err != 0:
        fail("alexandridis disagrees with its plain version on the evaluation's inputs")

    loop_acts = make_actor(args, env, "random")
    eval_loop(env, loop_acts, 2)  # warm
    prof = profile_steps(lambda: eval_loop(env, loop_acts, PROFILE_STEPS), PROFILE_STEPS,
                         f"evaluation (random actor) {args.env.num_envs} x {args.env.size}²",
                         card)
    if prof is None:
        fail("the profiler saw no device time in the evaluation loop")
    log(f"[eval] phase took {time.perf_counter() - t_phase:.1f}s")
    return {"card": card, "envs": args.env.num_envs, "size": args.env.size, "steps": steps,
            "actors": out, "alexandridis_launches": total,
            "alexandridis_recorded_launches": len(recorded), "alexandridis_max_abs_err": err,
            **prof}


# --- slice 8: pinecones, the legacy spec, the curve and the policy evaluation -----------


def landing_stats(rows, cols, lit, h, w):
    """On the device, of one pinecone landing (every entry of every cell,
    lit or not): the lit entries, the cells hit by more than one entry and
    the cells where a lit entry is followed by an unlit one (there the order
    of the landings decides the cell)."""
    at = rows.long() * w + cols
    order = torch.arange(at.shape[1], device=at.device).expand_as(at)
    empty = torch.full((at.shape[0], h * w), -1, dtype=torch.int64, device=at.device)
    hits = torch.zeros_like(empty).scatter_add_(1, at, torch.ones_like(at))
    last = empty.scatter_reduce(1, at, order, reduce="amax")
    last_lit = empty.scatter_reduce(1, at, torch.where(lit, order, -1), reduce="amax")
    return torch.stack([lit.sum(), (hits > 1).sum(), ((last_lit >= 0) & (last_lit < last)).sum()])


def pinecone_parity(card_stats):
    """The pinecone env on the card against the CPU from a burning block:
    every leaf, bit for bit.  ``card_stats`` collects the card's landings."""
    from gymca_torch import rng
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    n, size = PINE_PARITY_ENVS, PINE_PARITY_SIZE
    cpu = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(SEED, device="cpu"),
                                         num_envs=n, enable_pinecones=True, device="cpu")
    gpu = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(SEED, device="cpu"),
                                         num_envs=n, enable_pinecones=True,
                                         terrain=cpu._terrain_ctx)
    (c_obs, c_info), (g_obs, g_info) = cpu.reset(), gpu.reset()
    for pe in (c_obs[1]["per_env_context"], g_obs[1]["per_env_context"]):
        block = pe["true_grid"][:, size // 3:2 * size // 3, size // 3:2 * size // 3]
        block[block == 1] = 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    mismatches = []
    for i, a in enumerate(ki.adv_actions(gen, PINE_PARITY_STEPS, n)):
        cs = cpu.conditional_reset(cpu.stateless_step(a.cpu(), c_obs, c_info), a.cpu())
        gs = gpu.conditional_reset(gpu.stateless_step(a, g_obs, g_info), a)
        (c_obs, c_info), (g_obs, g_info) = (cs[0], cs[4]), (gs[0], gs[4])
        pairs = {"rgb": (g_obs[0], c_obs[0]), "reward": (gs[1], cs[1]),
                 "position": (g_obs[1]["position"], c_obs[1]["position"]),
                 "time": (g_obs[1]["time"], c_obs[1]["time"])}
        pairs.update({k: (g_obs[1]["per_env_context"][k], v)
                      for k, v in c_obs[1]["per_env_context"].items()})
        pairs.update({f"info.{k}": (g_info[k], v) for k, v in c_info.items()})
        mismatches += [f"step {i} {k}" for k, (x, y) in pairs.items()
                       if not torch.equal(x.cpu(), y)]
    fires = int((c_obs[1]["per_env_context"]["true_grid"] == 2).sum())
    return mismatches, fires, len(card_stats)


def pinecone_phase(card, gen):
    """``[pinecones]`` (module docstring, phase 12)."""
    from gymca_torch import rng
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
    from gymca_torch.ops.alexandridis import AlexandridisCA
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step

    t_phase = time.perf_counter()
    env = AdvancedForestFireBulldozerEnv(PINE_SIZE, PINE_SIZE, key=rng.key(SEED),
                                         num_envs=PINE_ENVS, enable_pinecones=True)
    if env.use_fused_ca:
        fail("the pinecone env took the fused kernel, which has no pinecones")
    obs, info = env.reset()
    acts = ki.adv_actions(gen, PINE_STEPS, PINE_ENVS)
    ki.adv_run(env, obs, info, acts[:1])  # warm: the compass table, the allocator
    torch.cuda.synchronize()
    alexandridis_fused_step.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        end_obs, _, last = ki.adv_run(env, obs, info, acts)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    k2 = alexandridis_fused_step.launches
    fires = (end_obs[1]["per_env_context"]["true_grid"] == 2).sum(dim=(1, 2)).float()
    step_ms = dt * 1e3 / PINE_STEPS
    log(f"[pinecones] [{card}] {PINE_ENVS} envs at {PINE_SIZE}² with pinecones, "
        f"{PINE_STEPS} steps of stateless_step + conditional_reset under "
        f"sync_debug_mode=error in {dt:.3f}s: {step_ms} ms/step, "
        f"{PINE_ENVS * PINE_STEPS / dt} env-steps/s; {k2} alexandridis launches (the XLA-path "
        f"counterpart); mean reward {last[1].mean().item()}, fires per env "
        f"{fires.mean().item()}")
    if k2 != 0 or not torch.isfinite(last[1]).all():
        fail("the pinecone path launched the fused kernel or gave rewards that are not finite")
    prof = profile_steps(lambda: ki.adv_run(env, obs, info, acts[:PINE_PROFILE_STEPS]),
                         PINE_PROFILE_STEPS, f"pinecones {PINE_ENVS} x {PINE_SIZE}²", card)
    if prof is None:
        fail("the profiler saw no device time on the pinecone path")

    card_stats = []
    real_land = AlexandridisCA._land_pinecones

    def land(self, grid, fire_age, rows, cols, lit, ages):
        out = real_land(self, grid, fire_age, rows, cols, lit, ages)
        if grid.is_cuda:
            card_stats.append(torch.cat([landing_stats(rows, cols, lit, *grid.shape[-2:]),
                                         (out[0] != grid).sum()[None]]))
        return out

    AlexandridisCA._land_pinecones = land
    try:
        mismatches, parity_fires, steps = pinecone_parity(card_stats)
    finally:
        AlexandridisCA._land_pinecones = real_land
    lit, dup_cells, mixed, lights = (int(v) for v in torch.stack(card_stats).sum(0).tolist())
    log(f"[pinecones] {PINE_PARITY_ENVS} envs at {PINE_PARITY_SIZE}² x {PINE_PARITY_STEPS} "
        f"steps from a burning block: card against CPU {len(mismatches)} leaf mismatches; "
        f"{lit} embers lit; landings on a cell hit by several entries {dup_cells}, of them "
        f"{mixed} with a lit entry followed by an unlit one; {lights} cells lit by pinecones; "
        f"{parity_fires} fires at the end")
    if mismatches:
        fail(f"the pinecone env on the card differs from the CPU: {mismatches[:10]}")
    if steps != PINE_PARITY_STEPS or lit == 0 or mixed == 0:
        fail("the pinecone parity run lit no ember or had no duplicate landing that the "
             "order decides")
    log(f"[pinecones] phase took {time.perf_counter() - t_phase:.1f}s")
    return {"card": card, "envs": PINE_ENVS, "size": PINE_SIZE, "steps": PINE_STEPS,
            "ms_per_step": step_ms, "env_steps_per_sec": PINE_ENVS * PINE_STEPS / dt,
            "alexandridis_launches": k2, "card_vs_cpu_mismatches": len(mismatches),
            "parity_embers_lit": lit, "parity_duplicate_cells": dup_cells,
            "parity_order_decided_cells": mixed, "parity_cells_lit": lights, **prof}


def legacy_run(seed):
    """``LEGACY_PASSES`` passes of the legacy sequential spec at
    ``LEGACY_SIZE``² from one Generator seed: the final grid, ages and wind
    index as numpy."""
    import numpy as np

    from gymca_torch.ops.alexandridis import AlexandridisCA

    r = np.random.default_rng(seed)
    n = LEGACY_SIZE
    grid = r.choice(np.asarray([0, 1, 1, 2]), (n, n)).astype(np.int64)
    ctx = {"winds": [(r.uniform(0, 1.2, (3, 3)), r.uniform(0, 2.5, (3, 3))) for _ in range(8)],
           "wind_index": 0, "density": r.integers(1, 6, (n, n)),
           "vegetation": r.integers(1, 6, (n, n)), "slope": r.uniform(-20, 20, (n, n)),
           "fire_age": r.integers(1, 8, (n, n)), "p_tree": 0.05, "p_wind_change": 0.3}
    op = AlexandridisCA.sequential_prototype(0, 1, 2, rng=np.random.default_rng(seed))
    start = grid
    for _ in range(LEGACY_PASSES):
        grid, ctx = op.update(grid, ctx)
    return start, grid, ctx["fire_age"], ctx["wind_index"]


def legacy_phase():
    """``[legacy]`` (module docstring, phase 13)."""
    import hashlib

    t0 = time.perf_counter()
    start, grid, ages, wind = legacy_run(SEED)
    dt = time.perf_counter() - t0
    again = legacy_run(SEED)
    same = (bool((again[1] == grid).all()) and bool((again[2] == ages).all())
            and again[3] == wind)
    digest = hashlib.sha256(grid.tobytes() + ages.astype("int64").tobytes()).hexdigest()[:16]
    counts = {v: int((grid == v).sum()) for v in (0, 1, 2)}
    log(f"[legacy] SequentialAlexandridisCA at {LEGACY_SIZE}² for {LEGACY_PASSES} passes from "
        f"Generator seed {SEED}, on the host: {dt:.3f}s; cells empty/tree/fire {counts}, "
        f"{int((grid != start).sum())} cells changed, wind index {wind}; a second run from "
        f"the seed equal: {same}; digest {digest}")
    if not same or set(counts) != {0, 1, 2} or sum(counts.values()) != grid.size:
        fail("the legacy spec is not deterministic from its seed or left cells out of {0, 1, 2}")
    if not (grid != start).any():
        fail("the legacy spec changed no cell in its passes")
    return {"size": LEGACY_SIZE, "passes": LEGACY_PASSES, "seconds": dt, "counts": counts,
            "digest": digest}


def curve_phase(card, out):
    """``[curve]`` (module docstring, phase 14).  Returns the phase's
    summary, the recorded K2 error and the two blobs' paths."""
    import warnings

    from gymca_torch import train_curve
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    blob = out / "curve.pkl"
    keep = {i * CURVE_STEPS + j for i in range(CURVE_ITERS) for j in (0, CURVE_STEPS - 1)}
    torch.cuda.synchronize()
    alexandridis_fused_step.launches = 0
    with ki.alexandridis_recorder(keep) as recorded:
        t0 = time.perf_counter()
        result = train_curve.main(CURVE_ARGV + ["--tag", "smoke", "--out", str(out),
                                                "--save-params", str(blob)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = alexandridis_fused_step.launches
    history = result["history"]
    err = max(alexandridis_vs_plain(x, kw)[0] for x, kw in recorded)
    log(f"[curve] [{card}] train_curve {' '.join(CURVE_ARGV)}: {wall:.1f}s wall, samples/s "
        f"(SPS) {[h['SPS'] for h in history]}, {launches} alexandridis launches; hardware "
        f"{result['hardware']!r}; last metrics {json.dumps(history[-1])}")
    log(f"[kernel] alexandridis on the curve's inputs ({len(recorded)} launches recorded, the "
        f"first and last of each iteration): max_abs_err {err} (tolerance 0, grid and age)")
    if launches != CURVE_ITERS * CURVE_STEPS:
        fail(f"expected {CURVE_ITERS * CURVE_STEPS} alexandridis launches on the curve, got "
             f"{launches}")
    if len(recorded) != len(keep) or err != 0:
        fail("alexandridis disagrees with its plain version on the curve's inputs")
    if not result["hardware"].startswith(name):
        fail(f"the curve's JSON names {result['hardware']!r}, not the card {name!r}")
    if not all(math.isfinite(v) for h in history for v in h.values()):
        fail("the curve's metrics are not finite")
    if not blob.exists() or not (out / "ppo_curve_smoke.json").exists():
        fail("the curve wrote no params blob or no JSON")

    recipe, recipe_blob = {}, out / "recipe.pkl"
    for label, extra in (("modf", []), ("modf --pallas-ca", ["--pallas-ca"])):
        alexandridis_fused_step.launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            r = train_curve.main(RECIPE_ARGV + extra + ["--tag", "recipe", "--out", str(out),
                                                        "--save-params", str(recipe_blob)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        fell_back = any("falling back to the XLA CA path" in str(w.message) for w in caught)
        n_k2 = alexandridis_fused_step.launches
        log(f"[curve] [{card}] round 5's recipe ({label}), cut: {dt:.1f}s wall, samples/s "
            f"{[h['SPS'] for h in r['history']]}, {n_k2} alexandridis launches, fallback "
            f"warning {fell_back}; last metrics {json.dumps(r['history'][-1])}")
        if n_k2 != 0 or fell_back != bool(extra):
            fail(f"round 5's recipe ({label}) launched the fused kernel or warned wrongly")
        if not all(math.isfinite(v) for h in r["history"] for v in h.values()):
            fail(f"round 5's recipe ({label}) gave metrics that are not finite")
        recipe[label] = {"seconds": dt, "sps": [h["SPS"] for h in r["history"]],
                         "alexandridis_launches": n_k2, "fallback_warning": fell_back}
    log(f"[curve] phase took {time.perf_counter() - t_phase:.1f}s")
    return ({"card": card, "argv": CURVE_ARGV, "seconds": wall,
             "sps": [h["SPS"] for h in history], "hardware": result["hardware"],
             "alexandridis_launches": launches, "alexandridis_recorded_launches": len(recorded),
             "alexandridis_max_abs_err": err, "recipe": recipe}, blob, recipe_blob)


def policy_phase(card, blob, modf_blob):
    """``[policy]`` (module docstring, phase 15)."""
    import contextlib
    import io

    from gymca_torch import eval_policy
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step

    t_phase = time.perf_counter()
    real = eval_policy.episode_returns
    seconds = []

    def timed_loop(env, act_fn, keys, num_envs):
        """The episode loop under sync_debug_mode=error, timed to a
        synchronize; the summary's read-back comes after."""
        out, dt = without_sync(lambda: real(env, act_fn, keys, num_envs))
        seconds.append(dt)
        return out

    def evaluate(argv):
        alexandridis_fused_step.launches = 0
        seconds.clear()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            results = eval_policy.main(argv)
        for line in printed.getvalue().splitlines():
            log(f"[policy] {line}")
        return results, alexandridis_fused_step.launches, list(seconds)

    eval_policy.episode_returns = timed_loop
    try:
        keep = {p * POLICY_STEPS + i for p in range(len(POLICIES))
                for i in (0, POLICY_STEPS - 1)}
        with ki.alexandridis_recorder(keep) as recorded:
            results, launches, secs = evaluate(["--params", str(blob), "--envs",
                                                str(POLICY_ENVS), "--steps", str(POLICY_STEPS),
                                                "--probes"])
        modf, modf_launches, modf_secs = evaluate(["--params", str(modf_blob), "--envs",
                                                   str(POLICY_ENVS), "--steps",
                                                   str(POLICY_MODF_STEPS)])
    finally:
        eval_policy.episode_returns = real
    err = max(alexandridis_vs_plain(x, kw)[0] for x, kw in recorded)
    rates = {r["policy"]: POLICY_STEPS / s for r, s in zip(results, secs)}
    log(f"[policy] [{card}] eval_policy on the curve's blob, {POLICY_ENVS} envs, "
        f"{POLICY_STEPS} steps per policy under sync_debug_mode=error: steps/s {rates}; "
        f"{launches} alexandridis "
        f"launches; the modf blob {POLICY_MODF_STEPS} steps: {POLICY_MODF_STEPS / modf_secs[0]} "
        f"steps/s, {modf_launches} alexandridis launches")
    log(f"[kernel] alexandridis on the policy evaluation's inputs ({len(recorded)} launches "
        f"recorded, each policy's first and last): max_abs_err {err} (tolerance 0, grid and "
        f"age)")
    if [r["policy"] for r in results] != list(POLICIES) or len(modf) != 1:
        fail("eval_policy did not report every policy")
    if launches != len(POLICIES) * POLICY_STEPS or modf_launches != 0:
        fail(f"expected {len(POLICIES) * POLICY_STEPS} alexandridis launches from the policy "
             f"evaluation and none from the modf blob's, got {launches} and {modf_launches}")
    if len(recorded) != len(keep) or err != 0:
        fail("alexandridis disagrees with its plain version on the policy evaluation's inputs")
    if not all(math.isfinite(r[k]) for r in results + modf
               for k in ("mean_return", "min", "max")):
        fail("the policy evaluation's returns are not finite")
    log(f"[policy] phase took {time.perf_counter() - t_phase:.1f}s")
    return {"card": card, "envs": POLICY_ENVS, "steps": POLICY_STEPS, "steps_per_s": rates,
            "modf_steps_per_s": POLICY_MODF_STEPS / modf_secs[0],
            "alexandridis_launches": launches, "modf_alexandridis_launches": modf_launches,
            "alexandridis_recorded_launches": len(recorded), "alexandridis_max_abs_err": err,
            "results": results + modf}


# --- slice 9: parallel/ on torch.distributed ---------------------------------------------


def nccl_kernels(prof):
    """NCCL's device kernels in a trace (a sum over one rank is its
    ``oneRankReduce``), apart from its ``nccl:`` ranges."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("nccl:")
            and ("nccl" in e.name.lower() or "onerank" in e.name.lower())]


def parallel_ppo(card, train_sps):
    """(b) of ``[parallel]``: ``DataParallelPPO`` at ``[train]``'s cell."""
    from torch.profiler import ProfilerActivity, profile

    from gymca_torch import rng
    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
    from gymca_torch.ops.windy_kernel import windy_fused_step
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.sharded import DataParallelPPO
    from gymca_torch.run import args_to_structured_args, build_env, parse_args

    args = args_to_structured_args(parse_args(TRAIN_ARGV))
    env = build_env(args)
    if not env.use_fused_ca:
        fail("the data-parallel trainer's env does not take the fused kernel on the card")
    dp = DataParallelPPO(env, args, make_mesh(1), key=rng.key(args.exp.seed))
    steps = args.exp.num_ppo_steps
    n_mb = args.ppo.update_epochs * args.ppo.num_minibatches
    start = dp.trainer.agent_state
    counters = (alexandridis_fused_step, windy_fused_step)
    for c in counters:
        c.launches = 0
    keep = {i * steps + j for i in range(PAR_ITERS) for j in (0, steps - 1)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ki.alexandridis_recorder(keep) as recorded:
        state, history = dp.train(PAR_ITERS)
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t0
    k2, k1 = (c.launches for c in counters)
    grad_reduces, metric_reduces = dp.trainer.grad_all_reduces, dp.metric_all_reduces
    err = max(alexandridis_vs_plain(x, kw)[0] for x, kw in recorded)
    log(f"[parallel] (b) DataParallelPPO on a world of one rank, scripts/run's defaults: "
        f"{PAR_ITERS} iterations in {dp_s:.2f}s, {k2} alexandridis launches ({k1} windy), "
        f"{grad_reduces} gradient all-reduces and {metric_reduces} metric all-reduces; SPS " + ", ".join(str(h["SPS"]) for h in history)
        + f" ([train] (a): {train_sps}); last metrics " + json.dumps(history[-1]))
    log(f"[kernel] alexandridis on the data-parallel trainer's inputs ({len(recorded)} "
        f"launches recorded, at steps {sorted(keep)}): max_abs_err {err} (tolerance 0, grid "
        f"and age)")
    if k2 != PAR_ITERS * steps:
        fail(f"expected {PAR_ITERS * steps} alexandridis launches in DataParallelPPO.train, "
             f"got {k2}")
    if grad_reduces != PAR_ITERS * n_mb or metric_reduces != PAR_ITERS:
        fail(f"expected {n_mb} gradient all-reduces and one metric all-reduce an iteration, "
             f"got {grad_reduces} and {metric_reduces}")
    if len(recorded) != len(keep) or err != 0:
        fail("alexandridis disagrees with its plain version on the data-parallel inputs")
    if not all(finite(h) for h in history):
        fail("the data-parallel trainer's metrics are not finite")
    if params_equal(start.params, state.params, tuple(start.params)):
        fail("DataParallelPPO.train left the params where they started")

    # From the starting weights and the same key, TF32 off and cuDNN's
    # deterministic algorithms (on an H100 at this size its default ones do
    # not repeat: the trainer against itself differed by up to 7.8e-4),
    # iterations in the order DP (its update traced), trainer, DP, trainer,
    # the last three timed back to back.
    real_learn = dp.trainer.learn
    traces = []

    def traced_learn(*a, **kw):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = real_learn(*a, **kw)
        traces.append(prof)
        return out

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def dp_iteration(traced):
        dp.trainer.agent_state = start
        dp.trainer.learn = traced_learn if traced else real_learn
        try:
            return timed(dp.train_iteration, *dp.init_carry())
        finally:
            dp.trainer.learn = real_learn

    def trainer_iteration():
        tr = PPOTrainer(env, args, key=rng.key(args.exp.seed))
        obs, info = env.reset()
        n = args.env.num_envs
        return timed(tr.train_iteration, tr.agent_state, EpisodeStatistics.create(n), obs,
                     torch.zeros(n, dtype=torch.bool, device="cuda"), info,
                     rng.split(tr.key, 1)[0])

    tf32, det = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    try:
        runs = [dp_iteration(True), trainer_iteration(), dp_iteration(False),
                trainer_iteration()]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = tf32, det
    (d_out, _), (s_out, t_s1), (d2_out, d_s), (s2_out, t_s2) = runs

    def leaf_pairs(a, b):
        return ([(a[0].params[g][k], v) for g in b[0].params for k, v in b[0].params[g].items()],
                [(a[-1][k].to(torch.float32), v.to(torch.float32)) for k, v in b[-1].items()])

    pairs, m_pairs = leaf_pairs(d_out, s_out)
    others = [sum(leaf_pairs(o, s_out), []) for o in (d2_out, s2_out)]
    bad = [i for i, (a, b) in enumerate(pairs + m_pairs + others[0] + others[1])
           if not torch.allclose(a, b, rtol=1e-4, atol=1e-5)]
    bits = all(torch.equal(a, b) for a, b in pairs + m_pairs + others[0])
    gap = max((a - b).abs().max().item() for a, b in pairs)
    m_gap = max((a - b).abs().max().item() for a, b in m_pairs)
    dp_gap = max((a - b).abs().max().item() for a, b in others[0])
    self_gap = max((a - b).abs().max().item() for a, b in others[1])
    kernels = nccl_kernels(traces[0])
    nccl_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    log(f"[parallel] (b) [{card}] train_iteration from the starting weights and the same key, "
        f"TF32 off, cuDNN deterministic: DP against PPOTrainer params max_abs_err {gap}, "
        f"metrics {m_gap} (rtol 1e-4, atol 1e-5), the second DP iteration {dp_gap}; bit for "
        f"bit: {bits}; PPOTrainer against itself: {self_gap}")
    log(f"[parallel] (b) [{card}] back to back, TF32 off: PPOTrainer {t_s1:.3f}s, "
        f"DataParallelPPO {d_s:.3f}s, PPOTrainer {t_s2:.3f}s an iteration "
        f"({steps * args.env.num_envs} samples)")
    log(f"[parallel] (b) [{card}] its traced update ({n_mb} minibatches): {len(kernels)} "
        f"NCCL kernels {sorted({e.name[-60:] for e in kernels})}, "
        f"{nccl_us / max(len(kernels), 1)} us of device time each")
    if bad:
        fail(f"DataParallelPPO differs from PPOTrainer beyond tolerance at {len(bad)} leaves")
    if not kernels:
        fail("the traced data-parallel update shows no NCCL kernel on the device")
    return {"samples_per_s": history[-1]["SPS"],
            "sps_per_iteration": [h["SPS"] for h in history],
            "train_samples_per_s": train_sps, "train_seconds": dp_s,
            "alexandridis_launches": k2, "alexandridis_max_abs_err": err,
            "alexandridis_recorded_launches": len(recorded), "grad_all_reduces": grad_reduces,
            "metric_all_reduces": metric_reduces,
            "vs_trainer_params_max_abs_err": gap, "vs_trainer_metrics_max_abs_err": m_gap,
            "vs_trainer_bit_for_bit": bits, "trainer_self_max_abs_err": self_gap,
            "dp_self_max_abs_err": dp_gap,
            "iteration_seconds_tf32_off": {"trainer": [t_s1, t_s2], "dp": d_s},
            "nccl_kernels_in_update": len(kernels),
            "nccl_us_per_all_reduce": nccl_us / max(len(kernels), 1)}


def parallel_spatial(card, gen):
    """(c) of ``[parallel]``: the spatial steps on a world of 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from gymca_torch import rng
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
    from gymca_torch.envs.bulldozer import BulldozerCore
    from gymca_torch.parallel.mesh import make_2d_mesh, make_mesh
    from gymca_torch.parallel.spatial_env import (
        advanced_step_batched_spatial,
        advanced_step_spatial,
        bulldozer_step_batched_spatial,
        bulldozer_step_spatial,
        shard_state,
        shard_state_batched,
    )

    mesh, mesh2 = make_mesh(1), make_2d_mesh(1, 1)
    out = {}

    def bulldozer_run(label, core, n, steps, step_fn, shard):
        ref = core.initial_state(rng.split(rng.key(SEED), n))
        state = shard(ref.clone())
        actions = ki.draw_actions(gen, steps, n)
        bad, secs = [], []
        for i, a in enumerate(actions):
            (state, s_out), dt = without_sync(lambda: step_fn(core, state, a))
            secs.append(dt)
            ref, r_out = core.step(ref, a)
            bad += leaf_mismatches((state, s_out.reward, s_out.terminated, s_out.info["hit"]),
                                   (ref, r_out.reward, r_out.terminated, r_out.info["hit"]),
                                   f"{label} step {i}")
        fires = int((state.grid == core._fire).sum())
        ms = 1e3 * sum(secs) / steps
        log(f"[parallel] (c) [{card}] {label}: {steps} steps under sync_debug_mode=error, "
            f"{ms} ms a step; every leaf equal to BulldozerCore.step: {not bad} ({fires} fire "
            f"cells at the end)")
        if bad:
            fail(f"{label} differs from BulldozerCore.step: {bad[:10]}")
        return ms

    out["bulldozer_16384_ms"] = bulldozer_run(
        f"bulldozer_step_spatial, one {SPATIAL_BIG}² grid", BulldozerCore(SPATIAL_BIG,
                                                                          SPATIAL_BIG),
        1, SPATIAL_BIG_STEPS, lambda c, s, a: bulldozer_step_spatial(c, s, a, mesh),
        lambda s: shard_state(s, mesh))
    out["bulldozer_batched_ms"] = bulldozer_run(
        f"bulldozer_step_batched_spatial, (1, 1) mesh, {N_ENVS} x {H}²", BulldozerCore(H, W),
        N_ENVS, SPATIAL_BATCH_STEPS,
        lambda c, s, a: bulldozer_step_batched_spatial(c, s, a, mesh2),
        lambda s: shard_state_batched(s, mesh2))

    def single_env(env):
        (_, ctx), _ = env.reset()
        pe = dict(ctx["per_env_context"], position=ctx["position"])
        return pe, ctx["shared_context"]

    def one(pe, i):
        return {k: v[i] for k, v in pe.items()}

    def moves(n):
        return ki.adv_actions(gen, 1, n)[0, :, :2]

    # one 4096² grid, 10 steps
    env = AdvancedForestFireBulldozerEnv(ADV_SPATIAL_SIZE, ADV_SPATIAL_SIZE, key=rng.key(SEED),
                                         num_envs=1)
    pes, shared = single_env(env)
    pe = one(pes, 0)
    secs, fires, rewards, cells_ok = [], [], [], []
    for _ in range(ADV_SPATIAL_STEPS):
        a = moves(1)[0]
        (grid, pe, reward, done), dt = without_sync(
            lambda: advanced_step_spatial(env.ca, pe["true_grid"], pe, shared, a, pe["key"],
                                          mesh))
        secs.append(dt)
        fires.append((grid == 2).sum())
        rewards.append(reward)
        cells_ok.append(((grid >= 0) & (grid <= 2)).all())
    fires = [int(f) for f in fires]
    rewards = torch.stack(rewards)
    adv_ms = 1e3 * sum(secs) / ADV_SPATIAL_STEPS
    log(f"[parallel] (c) [{card}] advanced_step_spatial, one {ADV_SPATIAL_SIZE}² grid: "
        f"{ADV_SPATIAL_STEPS} steps under sync_debug_mode=error, {adv_ms} ms a step; fire "
        f"cells {fires}; rewards {rewards.tolist()}")
    if (not all(bool(c) for c in cells_ok) or not torch.isfinite(rewards).all()
            or not ((rewards >= -1) & (rewards <= 0)).all() or max(fires) == 0):
        fail("advanced_step_spatial: cells outside {0, 1, 2}, rewards outside [-1, 0] or "
             "nothing burned")
    out["advanced_4096_ms"] = adv_ms

    # 64 x 256² on a (1, 1) mesh against each of 4 envs stepped alone
    env = AdvancedForestFireBulldozerEnv(ADV_SIZE, ADV_SIZE, key=rng.key(SEED),
                                         num_envs=ADV_ENVS)
    pes, shared = single_env(env)
    block = shard_state_batched(pes, mesh2)
    alone = [one(pes, i) for i in range(ADV_BATCH_CHECK_ENVS)]
    bad, secs = [], []
    for step in range(ADV_BATCH_CHECK_STEPS):
        acts = moves(ADV_ENVS)
        (grids, block, rewards, dones), dt = without_sync(
            lambda: advanced_step_batched_spatial(env.ca, block["true_grid"], block, shared,
                                                  acts, block["key"], mesh2))
        secs.append(dt)
        for i, pe in enumerate(alone):
            (g, alone[i], r, d), _ = without_sync(
                lambda: advanced_step_spatial(env.ca, pe["true_grid"], pe, shared, acts[i],
                                              pe["key"], mesh))
            bad += leaf_mismatches((g, alone[i], r, d),
                                   (grids[i], one(block, i), rewards[i], dones[i]),
                                   f"step {step} env {i}")
    batch_ms = 1e3 * sum(secs) / ADV_BATCH_CHECK_STEPS
    log(f"[parallel] (c) [{card}] advanced_step_batched_spatial, (1, 1) mesh, {ADV_ENVS} x "
        f"{ADV_SIZE}², {ADV_BATCH_CHECK_STEPS} steps under sync_debug_mode=error, {batch_ms} "
        f"ms a step; envs 0-{ADV_BATCH_CHECK_ENVS - 1} equal to advanced_step_spatial "
        f"alone: {not bad}")
    if bad:
        fail(f"advanced_step_batched_spatial differs from the per-env step: {bad[:10]}")
    out["advanced_batched_64x256_ms"] = batch_ms

    # the card against the CPU at 256², 5 steps
    cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu",
                                     mesh_dim_names=("data",))
    env = AdvancedForestFireBulldozerEnv(ADV_SIZE, ADV_SIZE, key=rng.key(SEED), num_envs=1)
    pes, shared = single_env(env)
    card_pe = one(pes, 0)
    cpu_pe = {k: v.cpu() for k, v in card_pe.items()}
    cpu_shared = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in shared.items()}
    bad = []
    for step in range(ADV_CPU_STEPS):
        a = moves(1)[0]
        (card_res, _) = without_sync(
            lambda: advanced_step_spatial(env.ca, card_pe["true_grid"], card_pe, shared, a,
                                          card_pe["key"], mesh))
        cpu_res = advanced_step_spatial(env.ca, cpu_pe["true_grid"], cpu_pe, cpu_shared, a.cpu(),
                                        cpu_pe["key"], cpu_mesh)
        bad += leaf_mismatches(card_res, cpu_res, f"step {step}")
        card_pe, cpu_pe = card_res[1], cpu_res[1]
    log(f"[parallel] (c) [{card}] advanced_step_spatial at {ADV_SIZE}², {ADV_CPU_STEPS} steps: "
        f"the card equals the CPU (gloo mesh), every leaf: {not bad}")
    if bad:
        fail(f"advanced_step_spatial on the card differs from the CPU: {bad[:10]}")
    return out


def parallel_phase(card, gen, train_sps, bench_best):
    """``[parallel]`` (module docstring, phase 16)."""
    import socket

    import torch.distributed as dist

    from gymca_torch import bench_scaling
    from gymca_torch.ops.windy_kernel import windy_fused_step
    from gymca_torch.parallel.mesh import initialize_distributed

    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0)
    try:
        backend = dist.get_backend()
        log(f"[parallel] (a) a world of {dist.get_world_size()} rank on {backend}, "
            f"tcp://localhost:{port}, cuda:{torch.cuda.current_device()}")
        if backend != "nccl":
            fail(f"the card's process group runs {backend}, not NCCL")
        out = {"card": card, "backend": backend, "world_size": dist.get_world_size()}
        out.update(parallel_spatial(card, gen))
        log(f"[parallel] (c) done at {time.perf_counter() - t_phase:.1f}s")

        # (d) bench_scaling at d = 1
        windy_fused_step.launches = 0
        a = bench_scaling.parse_args(["--steps", str(SCALING_STEPS)])
        (rec,) = bench_scaling.run(a)
        k1 = windy_fused_step.launches
        runs = bench_scaling.WARMUP + bench_scaling.REPS
        log(f"[parallel] (d) [{card}] bench_scaling d=1, {a.envs_per_device} x {a.size}², "
            f"{a.steps} steps, best of {bench_scaling.REPS} after {bench_scaling.WARMUP} "
            f"untimed: {rec['steps_per_sec']} env-steps/s ([bench] best of 3: "
            f"{bench_best}), efficiency {rec['efficiency']}; {k1} windy launches")
        if k1 != runs * SCALING_STEPS or rec["devices"] != 1:
            fail(f"expected {runs * SCALING_STEPS} windy launches from bench_scaling, got {k1}")
        out.update(scaling_steps_per_s=rec["steps_per_sec"], scaling_windy_launches=k1,
                   bench_best_steps_per_s=bench_best)
        log(f"[parallel] (d) done at {time.perf_counter() - t_phase:.1f}s")
        out.update(parallel_ppo(card, train_sps))
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[parallel] phase took {out['seconds']:.1f}s")
    return out


# --- slice 10: the tools of scripts/ ---------------------------------------------------


def tools_phase(card):
    """``[tools]`` (module docstring, phase 17)."""
    import importlib.util

    import gymca_torch.envs.advanced as advanced
    from gymca_torch import (
        bench_advanced,
        exp_advanced_split,
        exp_policy_ceiling,
        profile_advanced,
        profile_step,
        update_gallery,
        validate_fused_ca,
        versionate,
    )
    from gymca_torch.ops import alexandridis_kernel, windy_kernel
    from gymca_torch.probes import exp_split

    t_phase = time.perf_counter()
    k1, k2 = windy_kernel.windy_fused_step, alexandridis_kernel.alexandridis_fused_step

    def new_params():
        """K1's first launch on each params tensor (or the tensor it views):
        one launch per case of profile_step and exp_split."""
        last = [None]

        def keep(i, args, kw):
            root = args[2] if args[2]._base is None else args[2]._base
            new, last[0] = root is not last[0], root
            return new

        return keep

    def path(name, fn):
        """Run one entry point with both counters zeroed before and read
        after; K1's first launch on each input set and K2's first launch
        (as the env calls it and as the module calls it alone) recorded."""
        k1.launches = k2.launches = 0
        with ki.launch_recorder(profile_step, "windy_fused_step", new_params()) as r1a, \
                ki.launch_recorder(exp_split, "windy_fused_step", new_params()) as r1b, \
                ki.alexandridis_recorder({0}) as r2_env, \
                ki.alexandridis_recorder({0}, profile_advanced) as r2_alone, \
                ki.alexandridis_recorder({0}, exp_advanced_split) as r2_iso:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        log(f"[tools] {name}: {seconds:.1f}s, {k1.launches} windy and {k2.launches} "
            f"alexandridis launches")
        return (result, {"windy": k1.launches, "alexandridis": k2.launches}, r1a + r1b,
                r2_env + r2_alone + r2_iso)

    launches, k1_recorded, k2_recorded, out = {}, [], [], {"card": card}
    windy_cell = ["--envs", str(N_ENVS), "--size", str(H), "--steps", str(TOOLS_WINDY_STEPS)]
    res, launches["profile_step"], r1, _ = path("profile_step",
                                                lambda: profile_step.main(windy_cell))
    out["profile_step"] = res
    k1_recorded += [(a, "profile_step") for a, _ in r1]
    if len(r1) != len(profile_step.KERNEL_CASES):
        fail(f"expected K1 on {len(profile_step.KERNEL_CASES)} input sets in profile_step, "
             f"recorded {len(r1)}")
    res, launches["exp_split"], r1, _ = path("exp_split", lambda: exp_split.main(windy_cell))
    out["exp_split"] = res
    k1_recorded += [(a, "exp_split") for a, _ in r1]
    if len(r1) != len(exp_split.FRACTIONS):
        fail(f"expected K1 on {len(exp_split.FRACTIONS)} input sets in exp_split, recorded "
             f"{len(r1)}")

    adv = ["--envs", "8", "--size", str(ADV_SIZE), "--steps", str(TOOLS_ADV_STEPS)]
    res, launches["bench_advanced"], _, r2 = path("bench_advanced",
                                                  lambda: bench_advanced.main(adv))
    out["bench_advanced"] = res
    k2_recorded += [(x, "bench_advanced") for x in r2]
    res, launches["profile_advanced"], _, r2 = path("profile_advanced",
                                                    lambda: profile_advanced.main(adv))
    out["profile_advanced"] = res
    k2_recorded += [(x, "profile_advanced") for x in r2]
    res, launches["exp_advanced_split"], _, r2 = path(
        "exp_advanced_split", lambda: exp_advanced_split.main(
            ["--envs", str(ADV_ENVS), "--size", str(ADV_SIZE), "--steps",
             str(TOOLS_SPLIT_STEPS)]))
    out["exp_advanced_split"] = res
    k2_recorded += [(x, "exp_advanced_split") for x in r2]
    split_k2 = res["k2_launches"]
    log(f"[tools] exp_advanced_split's alexandridis launches by variant: {split_k2}")
    if split_k2["step_no_ca"] != 0:
        fail(f"the CA-stubbed variant launched the alexandridis kernel "
             f"{split_k2['step_no_ca']} times")
    if min(v for k, v in split_k2.items() if k not in ("step_no_ca", "obs_iso")) == 0:
        fail("a variant of exp_advanced_split that steps the fused CA launched no kernel")
    if advanced.alexandridis_fused_step is not k2:
        fail("exp_advanced_split left its CA stub in the Advanced env")

    rc, launches["validate_fused_ca"], _, r2 = path(
        "validate_fused_ca", lambda: validate_fused_ca.main(
            [str(ADV_SIZE), str(ADV_ENVS), str(TOOLS_VALIDATE_STEPS)]))
    out["validate_fused_ca"] = rc
    k2_recorded += [(x, "validate_fused_ca") for x in r2]
    if rc != 0:
        fail("validate_fused_ca printed FAIL")
    res, launches["exp_policy_ceiling"], _, r2 = path(
        "exp_policy_ceiling", lambda: exp_policy_ceiling.main(
            ["--envs", "8", "--size", str(ADV_SIZE), "--steps", str(TOOLS_POLICY_STEPS)]))
    out["exp_policy_ceiling"] = res
    k2_recorded += [(x, "exp_policy_ceiling") for x in r2]
    if not all(math.isfinite(r["mean_return"]) for r in res):
        fail("exp_policy_ceiling's returns are not finite")

    zero = [name for name, c in launches.items()
            if c["windy" if name in ("profile_step", "exp_split") else "alexandridis"] == 0]
    if zero:
        fail(f"no kernel launch on the paths of {zero}")
    unread = [f"{name}: {part}" for name in launches for part, busy in device_readings(out[name])
              if busy is None]
    log(f"[tools] device readings: {sum(1 for n in launches for _ in device_readings(out[n]))} "
        f"parts traced, {len(unread)} without device time")
    if unread:
        fail(f"the profiler read no device time, in every session, for {unread}")
    k1_err = max(kernel_vs_plain(a)[0] for a, _ in k1_recorded)
    k2_err = max(alexandridis_vs_plain(x, kw)[0] for (x, kw), _ in k2_recorded)
    log(f"[kernel] windy_sparse on the tools' inputs ({len(k1_recorded)} launches recorded: "
        f"profile_step's 1/7-CA, all-CA, none-fire and pure no-op sets, exp_split's six "
        f"fractions): max_abs_err {k1_err} (tolerance 0)")
    log(f"[kernel] alexandridis on the tools' inputs ({len(k2_recorded)} launches recorded, "
        f"{sorted({p for _, p in k2_recorded})}): max_abs_err {k2_err} (tolerance 0)")
    if k1_err != 0 or k2_err != 0:
        fail("a kernel disagrees with its plain version on the tools' inputs")

    if all(importlib.util.find_spec(m) for m in ("gymnasium", "matplotlib")):
        with tempfile.TemporaryDirectory() as gallery:
            written = update_gallery.main(["--out-dir", gallery, "--steps", "8"])
            if len(written) != 2 or not all(p.stat().st_size > 0 for p in written):
                fail(f"update_gallery wrote {written}")
        out["update_gallery"] = [p.name for p in written]
    else:
        log("[tools] update_gallery not run: it needs gymnasium and matplotlib, and this "
            "machine lacks one of them")
        out["update_gallery"] = None
    new = versionate.main(["--dry-run"])
    if new.count(".") != 2:
        fail(f"versionate --dry-run gave {new!r}")
    out.update(launches=launches, windy_max_abs_err=k1_err, alexandridis_max_abs_err=k2_err,
               windy_recorded_launches=len(k1_recorded),
               alexandridis_recorded_launches=len(k2_recorded),
               seconds=time.perf_counter() - t_phase)
    log(f"[tools] phase took {out['seconds']:.1f}s")
    return out


def device_readings(result):
    """``(part, device busy µs a step)`` of every part a tool's result
    traced: its parts' ``busy_us_per_step`` (None where the profiler read no
    device time) and ``exp_advanced_split``'s ``<variant>_device_busy_us``."""
    if isinstance(result, dict) and "busy_us_per_step" in result:
        yield "", result["busy_us_per_step"]
    elif isinstance(result, dict):
        for k, v in result.items():
            if k.endswith("_device_busy_us"):
                yield k[:-len("_device_busy_us")], v
            else:
                yield from ((f"{k}/{p}".rstrip("/"), b) for p, b in device_readings(v))
    elif isinstance(result, list):
        for i, v in enumerate(result):
            yield from ((f"{i}/{p}".rstrip("/"), b) for p, b in device_readings(v))


def tools_process():
    """``[tools]`` in a process of its own (``python3 chip_smoke.py --tools
    OUT``), its result read back from ``OUT``: on the H100, after the other
    phases' profiler sessions, this process's traces lost every kernel event
    in ten sessions running (PR 11), while a fresh process traced the same
    parts whole."""
    with tempfile.TemporaryDirectory() as tmp:
        result = Path(tmp) / "tools.json"
        sys.stdout.flush()
        proc = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"), "--tools",
                               str(result)], cwd=HERE, timeout=900)
        if proc.returncode != 0:
            fail(f"[tools] failed in its process (exit {proc.returncode})")
        return json.loads(result.read_text())


def tools_main(result_path) -> int:
    """The process of :func:`tools_process`: the kernels are built already."""
    global ki, profile_steps
    sys.path.insert(0, str(HERE))
    from gymca_torch.probes import kernel_inputs as ki
    from gymca_torch.probes.timing import card, profile_steps

    out = tools_phase(card())
    Path(result_path).write_text(json.dumps(out, default=str))
    return 0


def bench_phase(card):
    """``[bench]`` (module docstring, phase 7b): ``gymca_torch.bench``'s two
    measurements at full width and the smoke's depth."""
    import gymca_torch.envs.bulldozer as bulldozer
    from gymca_torch import bench
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
    from gymca_torch.ops.windy_kernel import windy_fused_step

    t_phase = time.perf_counter()
    runs = bench.WARM + bench.REPS
    # Recorded in the untimed runs: the first run's first and last launch,
    # the second run's last.
    keep = {0, BENCH_STEPS - 1, 2 * BENCH_STEPS - 1}
    out = {"card": card}
    for kernel, measure, size, envs, recorder in (
            ("windy", bench.measure_windy, H, N_ENVS,
             lambda: ki.launch_recorder(bulldozer, "windy_fused_step", keep)),
            ("alexandridis", bench.measure_advanced, ADV_SIZE, ADV_ENVS,
             lambda: ki.alexandridis_recorder(keep))):
        windy_fused_step.launches = alexandridis_fused_step.launches = 0
        with recorder() as recorded:
            m = measure(size, envs, BENCH_STEPS, "cuda")
        launched = {"windy": windy_fused_step.launches,
                    "alexandridis": alexandridis_fused_step.launches}
        sums = torch.stack([r["reward_sums"] for r in m["runs"]])
        rates = [envs * BENCH_STEPS / r["seconds"] for r in m["runs"][bench.WARM:]]
        log(f"[bench] [{card}] {envs} x {size}x{size} ({m['path']}), {BENCH_STEPS} steps a "
            f"run, best of {bench.REPS} after {bench.WARM} untimed: {m['value']} env-steps/s; "
            f"reps {rates} env-steps/s; done fraction {m['done_fraction']}; draws outside the "
            f"clock {[r['draw_seconds'] for r in m['runs']]} s; launches {launched}")
        if launched[kernel] != runs * BENCH_STEPS or sum(launched.values()) != launched[kernel]:
            fail(f"[bench] expected {runs * BENCH_STEPS} {kernel} launches and no other, got "
                 f"{launched}")
        if not torch.isfinite(sums).all() or (sums > 0).any() or (sums < -envs).any():
            fail(f"[bench] {kernel} path: reward sums outside [-{envs}, 0]")
        if kernel == "windy":
            err = max(kernel_vs_plain(args)[0] for args, _ in recorded)
        else:
            err = max(alexandridis_vs_plain(x, kw)[0] for x, kw in recorded)
        log(f"[kernel] {kernel} on the bench's inputs ({len(recorded)} launches recorded, at "
            f"{sorted(keep)}): max_abs_err {err} (tolerance 0)")
        if len(recorded) != len(keep) or err != 0:
            fail(f"[bench] {kernel} disagrees with its plain version on the bench's inputs")
        out["windy" if kernel == "windy" else "advanced"] = {
            "envs": envs, "size": size, "steps": BENCH_STEPS, "path": m["path"],
            "value": m["value"], "reps_env_steps_per_s": rates,
            "done_fraction": m["done_fraction"],
            "draw_seconds": [r["draw_seconds"] for r in m["runs"]]}
        out[f"{kernel}_launches"], out[f"{kernel}_max_abs_err"] = launched[kernel], err
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[bench] phase took {out['seconds']:.1f}s")
    return out


# Integer operations an element of the threefry kernel: the hash (the key's
# third word 1, the first injection 2, 20 rounds of add, funnel shift and
# xor, 5 later injections of 2 adds), then a split's nothing more, or a
# uniform's xor, shift and or.
THREEFRY_HASH_OPS = 1 + 2 + 20 * 3 + 5 * 2
THREEFRY_REPEATS = 20


def rng_phase(card):
    """``[rng]``: the key chain's threefry kernel against the eager int64
    chain on the same card keys at the two cells' sizes, bit for bit, with
    one launch a draw; then its device time at 4096 keys (a split) and over
    a 64 x 256² fresh grid (a uniform) beside its bound."""
    from gymca_torch import rng
    from gymca_torch.envs.bulldozer import derive_step_key
    from gymca_torch.probes.timing import cuda_ms, time_launches

    t_phase = time.perf_counter()
    keys = rng.split(rng.key(SEED), N_ENVS)
    adv_keys = rng.split(rng.key(SEED + 1), ADV_ENVS)
    fresh = rng.split(adv_keys)[:, 0]  # a strided slice, as the env reads it
    cases = [  # (label, draw, launches)
        (f"derive_step_key over {N_ENVS} keys", lambda: derive_step_key(keys), 4),
        (f"split({N_ENVS} keys, 6)", lambda: rng.split(keys, 6), 1),
        (f"fold_in({ADV_ENVS} keys, 7)", lambda: rng.fold_in(adv_keys, 7), 1),
        (f"uniform({ADV_ENVS} keys)", lambda: rng.uniform(adv_keys), 1),
        (f"randint({ADV_ENVS} keys, 1, 8)", lambda: rng.randint(adv_keys, (), 1, 8), 1),
        (f"choice({ADV_ENVS} keys, {ADV_SIZE}x{ADV_SIZE}) (the fresh grids)",
         lambda: rng.choice(fresh, 3, (ADV_SIZE, ADV_SIZE), (0.1, 0.9, 0.0)), 1),
        (f"uniform({N_ENVS} keys, 3x3, [0, 5))", lambda: rng.uniform(keys, (3, 3), 0.0, 5.0), 1),
    ]
    checked = []
    for label, draw, launches in cases:
        before = rng.threefry_launch.launches
        got = draw()
        launched = rng.threefry_launch.launches - before
        launch = rng.threefry_launch
        rng.threefry_launch = rng.threefry_plain
        try:
            want = draw()
        finally:
            rng.threefry_launch = launch
        def words(t):  # bit patterns: -0 is not 0
            return t.view(torch.int32) if t.is_floating_point() else t

        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        differ = sum(int(words(g).ne(words(w)).sum()) for g, w in pairs)
        log(f"[rng] {label}: {launched} threefry launch(es), {differ} elements differ from "
            f"the eager chain")
        if launched != launches or differ:
            fail(f"[rng] {label}: expected {launches} launch(es) and no difference, got "
                 f"{launched} and {differ}")
        checked.append(label)

    n_grid = ADV_ENVS * ADV_SIZE * ADV_SIZE
    timings = {}
    for label, args, elements, ops, out_bytes in (
            (f"split of {N_ENVS} keys", (keys, 2, "keys"), 2 * N_ENVS, THREEFRY_HASH_OPS, 16),
            (f"uniform over {ADV_ENVS} x {ADV_SIZE}² cells",
             (adv_keys, ADV_SIZE * ADV_SIZE, "uniform"), n_grid, THREEFRY_HASH_OPS + 3, 4)):
        t = time_launches(lambda: [rng.threefry_launch(*args) for _ in range(THREEFRY_REPEATS)],
                          THREEFRY_REPEATS, "threefry_kernel")
        plain_us = cuda_ms(lambda: rng.threefry_plain(*args), 3) * 1e3
        ops_us = elements * ops / ki.INT32_OPS_PER_S * 1e6
        bytes_us = elements * out_bytes / ki.HBM_BYTES_PER_S * 1e6
        bound_us, by = max((ops_us, "int32 ALU"), (bytes_us, "bytes"))
        log(f"[time] [{card}] threefry {label}: {t['device_us']} us/launch device, "
            f"{t['host_us']} us/launch host (events kept {t['seen']}); bound {bound_us} us "
            f"by {by} ({elements} elements x {ops} int32 ops; {bytes_us} us of bytes), "
            f"{100 * bound_us / t['device_us']:.1f}% of it; the eager chain (plain version) "
            f"{plain_us} us a call (CUDA events)")
        timings[label] = {"device_us": t["device_us"], "host_us": t["host_us"],
                          "bound_us": bound_us, "bound_by": by, "plain_us": plain_us}
    out = {"checked": checked, "timings": timings, "seconds": time.perf_counter() - t_phase}
    log(f"[rng] phase took {out['seconds']:.1f}s")
    return out


# --- main ----------------------------------------------------------------------------


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the card and has no CPU path")
    sys.path.insert(0, str(HERE))
    import gymca_torch

    if Path(gymca_torch.__file__).resolve().parent.parent != HERE:
        fail(f"gymca_torch imported from {gymca_torch.__file__}, not this checkout")
    global ki, profile_steps
    from gymca_torch.probes import kernel_inputs as ki
    from gymca_torch.probes.timing import profile_steps
    from gymca_torch import _build, rng
    from gymca_torch.envs.bulldozer import BulldozerCore, derive_step_key
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
    from gymca_torch.ops.alexandridis_kernel import (
        ABLATIONS,
        alexandridis_fused_step,
        alexandridis_fused_step_plain,
    )
    from gymca_torch.ops.windy_kernel import (
        shared_memory_bytes,
        windy_fused_step,
        windy_fused_step_plain,
    )
    from gymca_torch.probes.timing import card as nvidia_smi_line
    from gymca_torch.probes.timing import cuda_ms, host_us, time_launches

    # Each phase's seconds, for the [phases] line: mark(name) closes the
    # phase that ran since the last mark.
    phases, last_mark = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phases[name] = now - last_mark[0]
        last_mark[0] = now

    # 1. device
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {name} x{count} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {smi}")
    card = smi

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} source(s) in {time.perf_counter() - t0:.1f}s: " + ", ".join(
        f"{b.name} {'reused' if b.seconds is None else f'{b.seconds:.1f}s'}"
        for b in built.values()))
    for b in built.values():
        for line in b.ptxas_report():
            log(f"[build] {b.name}: {line}")
    clusters = _build.load("windy_sparse").windy_sparse_clusters
    clusters.argtypes, clusters.restype = [ctypes.c_int] * 3, ctypes.c_int
    log(f"[build] windy_sparse: the CA pass launches {clusters(1, H, W)} clusters at {H}x{W} "
        f"int8, the clusters the card holds at once")
    default = [lines for name, lines in built["alexandridis"].ptxas_entries().items()
               if "alexandridis_kernelILi0ELb1E" in name]  # the step, vector form
    if (len(default) != 1 or not any(ALEXANDRIDIS_PTXAS in ln for ln in default[0])
            or not any("0 bytes spill stores, 0 bytes spill loads" in ln for ln in default[0])):
        fail(f"the default alexandridis instance's ptxas report changed: {default}")
    mark("build")

    # 3-4. kernel against plain: every env class, the band seams of the CA
    #      pass (fire on both sides, edits and shots on a band's first and
    #      last row), batches of one class, int32 rows, rows of a width that
    #      takes the cell-per-lane path, and masks past 48 KiB
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k_main = BulldozerCore(H, W)._edit_log_k
    k1_cases = [
        ("main shape", (N_ENVS, H, W, torch.int8, k_main), {}),
        ("band seams", (1024, H, W, torch.int8, k_main), dict(seams=True)),
        ("all CA", (1024, H, W, torch.int8, k_main), dict(classes="ca")),
        ("all CA, band seams", (512, H, W, torch.int8, k_main), dict(classes="ca", seams=True)),
        ("all idle", (1024, H, W, torch.int8, k_main), dict(classes="idle")),
        ("all modify-only", (1024, H, W, torch.int8, k_main), dict(classes="modify")),
        ("int32", (64, 64, 128, torch.int32, 5), {}),
        ("int32, band seams", (64, 64, 128, torch.int32, 5), dict(seams=True, classes="ca")),
        ("odd width", (16, 40, 50, torch.int8, 3), {}),
        ("odd width, band seams", (64, 40, 50, torch.int8, 5), dict(seams=True, classes="ca")),
        ("3 rows", (16, 3, 64, torch.int8, 4), {}),
        ("512 x 512", (8, 512, 512, torch.int8, 5), {}),
        ("masks past 48 KiB", (2, 1024, 1024, torch.int8, 5), dict(classes="ca")),
        ("masks past 48 KiB, int32, all CA", (2, 1024, 1024, torch.int32, 5),
         dict(classes="ca", seams=True)),
    ]
    if shared_memory_bytes(1024, 1024) <= 48 * 1024:
        fail(f"the 'masks past 48 KiB' cases stage {shared_memory_bytes(1024, 1024)} B a block")
    max_err = max(check_kernel(label, ki.windy_inputs(*args, gen, **kw))
                  for label, args, kw in k1_cases)
    mark("windy_checks")

    # 5. the Alexandridis kernel against plain: the earlier sizes, then fire
    #    on tile edges only, burning tiles beside fire-free ones, fire only in
    #    a tile's 1-cell halo, all fire and none, radius 2 (halo 2) and 7
    k2_cases = [((ADV_ENVS, ADV_SIZE, ADV_SIZE), "random", None), ((4, 512, 512), "random", None),
                ((2, 1024, 1024), "random", None), ((16, 40, 50), "random", None)]
    k2_cases += [((16, ADV_SIZE, ADV_SIZE), lay, None) for lay in ki.K2_LAYOUTS[1:]]
    k2_cases += [((4, 96, 200), lay, None) for lay in ("tile_edges", "halo_only")]
    k2_cases += [((16, ADV_SIZE, ADV_SIZE), "random", 2), ((4, 512, 512), "halo_only", None),
                 ((2, 100, 136), "random", 32)]
    adv_max_err = max(
        check_alexandridis(f"{shape} {lay}",
                           *ki.alexandridis_inputs(*shape, gen, layout=lay, radius=rad))
        for shape, lay, rad in k2_cases)
    mark("alexandridis_checks")

    # 5b. the key chain's threefry kernel against the eager chain
    rng_out = rng_phase(card)
    mark("rng")

    # 6. slice 1's main path
    core = BulldozerCore(H, W)
    keys = rng.split(rng.key(SEED, device="cuda"), N_ENVS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_states = core.initial_state(keys)
    torch.cuda.synchronize()
    log(f"[main] reset {N_ENVS} envs at {H}x{W} {reset_states.grid.dtype} "
        f"({reset_states.grid.numel() * reset_states.grid.element_size() / 2**20:.0f} "
        f"MiB of grid) in {time.perf_counter() - t0:.2f}s; edit log K={core._edit_log_k}")
    actions = ki.draw_actions(gen, MAIN_STEPS, N_ENVS)
    states = reset_states.clone()
    torch.cuda.synchronize()
    windy_fused_step.launches = alexandridis_fused_step.launches = 0
    rng.threefry_launch.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, out = ki.run_steps(core, states, actions)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = windy_fused_step.launches
    others = alexandridis_fused_step.launches
    key_launches = rng.threefry_launch.launches
    torch.cuda.synchronize()
    log(f"[main] {MAIN_STEPS} steps of step_batched under sync_debug_mode=error: "
        f"{launches} windy kernel launches ({others} alexandridis, {key_launches} threefry), "
        f"done fraction {states.done.float().mean().item()}")
    if launches != MAIN_STEPS:
        fail(f"expected {MAIN_STEPS} windy kernel launches on the main path, got {launches}")
    if key_launches != 4 * MAIN_STEPS:
        fail(f"expected {4 * MAIN_STEPS} threefry launches on the main path, got "
             f"{key_launches}")
    if out.reward.shape != (N_ENVS,) or not torch.isfinite(out.reward).all():
        fail("main path rewards are not finite (N,) values")

    mismatches, parity_done = parity(core, keys[:PARITY_ENVS], gen)
    if mismatches:
        fail(f"step_batched differs from the eager step: {mismatches[:10]}")
    log(f"[main] first {PARITY_ENVS} envs x {PARITY_STEPS} steps: rewards, dones, hits, "
        f"counts, positions, times, keys and materialized grids equal the eager "
        f"batched step bit for bit (done fraction {parity_done})")

    # Recorded from where the main path ended: by then the envs' CA periods
    # have drifted apart, as in a long run (from a reset they fire together).
    recorded = ki.record_windy_launches(core, states.clone(),
                                    ki.draw_actions(gen, RECORDED_LAUNCHES, N_ENVS))
    rec_err = max(kernel_vs_plain(inp)[0] for inp in recorded[:3])
    log(f"[kernel] windy_sparse on main-path inputs (3 recorded launches): "
        f"max_abs_err {rec_err} (tolerance 0)")
    if rec_err != 0:
        fail("windy_sparse disagrees with its plain version on main-path inputs")
    max_err = max(max_err, rec_err)

    mark("main")

    # 7b. bench.py on the port: both paths' env-steps/s through gymca_torch.bench
    bench_out = bench_phase(card)
    best, adv_best = bench_out["windy"]["value"], bench_out["advanced"]["value"]
    max_err = max(max_err, bench_out["windy_max_abs_err"])
    adv_max_err = max(adv_max_err, bench_out["alexandridis_max_abs_err"])
    mark("bench")

    # 6. slice 1's times: K1's device time on three input sets, each beside
    # its bound: the recorded main-path launches, every env a CA env, every
    # env idle.
    kin = [inp[1:] for inp in recorded]
    kernel_ms, bound_ms, bound_by = ki.time_k1(card, "on recorded main-path launches",
                                               recorded[0][0], kin, KERNEL_REPEATS)
    all_ca = ki.windy_inputs(N_ENVS, H, W, torch.int8, k_main, gen, classes="ca")
    ki.time_k1(card, f"with every env a CA env ({N_ENVS})", all_ca[0], [all_ca[1:]],
               KERNEL_REPEATS)
    noop = torch.zeros_like(kin[0][1])
    ki.time_k1(card, "with every env idle (recorded grid, params zero)", recorded[0][0],
               [(kin[0][0], noop, kin[0][2], kin[0][3])], KERNEL_REPEATS)
    plain_grid = recorded[0][0].clone()
    plain_ms = cuda_ms(lambda: windy_fused_step_plain(plain_grid, *kin[0], empty=0, tree=3,
                                                      fire=25), 3)
    log(f"[time] [{card}] windy_sparse plain version {plain_ms * 1e3} us/call (CUDA events)")

    s = reset_states.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        derive_step_key(s.key)
    torch.cuda.synchronize()
    key_us = (time.perf_counter() - t0) / 20 * 1e6
    t0 = time.perf_counter()
    s, _ = ki.run_steps(core, s, actions[:20])
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / 20 * 1e6
    log(f"[time] [{card}] parts of a step, host clock to a synchronize: step "
        f"{step_us} us, derive_step_key {key_us} us; windy kernel device time "
        f"{kernel_ms * 1e3} us")

    prof_states = reset_states.clone()
    ki.run_steps(core, prof_states, actions[:2])  # warm
    prof = profile_steps(lambda: ki.run_steps(core, prof_states, actions[:PROFILE_STEPS]),
                         PROFILE_STEPS, f"step_batched {N_ENVS} x {H}x{W}", card)
    mark("time_windy")

    # 7. slice 2's main path
    env = AdvancedForestFireBulldozerEnv(ADV_SIZE, ADV_SIZE, key=rng.key(SEED),
                                         num_envs=ADV_ENVS)
    if not env.use_fused_ca:
        fail("the Advanced env does not take the fused kernel on the card")
    check_terrain(env)
    h, w, n = TERRAIN_ODD_SHAPE
    check_terrain(AdvancedForestFireBulldozerEnv(h, w, key=rng.key(SEED), num_envs=n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_obs, reset_info = env.reset()
    torch.cuda.synchronize()
    log(f"[advanced] reset {ADV_ENVS} envs at {ADV_SIZE}x{ADV_SIZE} (uint8 obs, hidden "
        f"terrain, CA radius {env.ca.burn_kernel_radius}) in {time.perf_counter() - t0:.2f}s")
    adv_acts = ki.adv_actions(gen, ADV_STEPS, ADV_ENVS)
    torch.cuda.synchronize()
    windy_fused_step.launches = alexandridis_fused_step.launches = 0
    rng.threefry_launch.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        adv_obs, adv_info, adv_last = ki.adv_run(env, reset_obs, reset_info, adv_acts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    adv_launches = alexandridis_fused_step.launches
    others = windy_fused_step.launches
    adv_key_launches = rng.threefry_launch.launches
    if adv_key_launches != 10 * ADV_STEPS:
        fail(f"expected {10 * ADV_STEPS} threefry launches on the Advanced path, got "
             f"{adv_key_launches}")
    torch.cuda.synchronize()
    rgb, reward = adv_obs[0], adv_last[1]
    fires = (adv_obs[1]["per_env_context"]["true_grid"] == 2).sum(dim=(1, 2)).float()
    log(f"[advanced] {ADV_STEPS} steps of stateless_step + conditional_reset under "
        f"sync_debug_mode=error: {adv_launches} alexandridis kernel launches ({others} "
        f"windy), done fraction {adv_last[2].float().mean().item()}, mean reward "
        f"{reward.mean().item()}, fires per env {fires.mean().item()}")
    if adv_launches != ADV_STEPS:
        fail(f"expected {ADV_STEPS} alexandridis launches on the Advanced path, got "
             f"{adv_launches}")
    if reward.shape != (ADV_ENVS,) or not torch.isfinite(reward).all():
        fail("Advanced path rewards are not finite (N,) values")
    if rgb.shape != (ADV_ENVS, ADV_SIZE, ADV_SIZE, 3) or rgb.dtype != torch.uint8:
        fail(f"Advanced observations are {tuple(rgb.shape)} {rgb.dtype}")

    adv_mismatches, adv_fires = adv_parity(gen)
    if adv_mismatches:
        fail(f"the fused env on the card differs from the CPU: {adv_mismatches[:10]}")
    log(f"[advanced] {ADV_PARITY_ENVS} envs at {ADV_PARITY_SIZE}x{ADV_PARITY_SIZE} x "
        f"{ADV_PARITY_STEPS} steps: every observation, context, reward and info leaf on "
        f"the card equals the CPU env with the kernel's plain version, bit for bit "
        f"({adv_fires} fires at the end)")

    adv_recorded = ki.record_alexandridis_launches(env, adv_obs, adv_info,
                                            ki.adv_actions(gen, RECORDED_LAUNCHES, ADV_ENVS))
    adv_rec_err = max(alexandridis_vs_plain(x, kw)[0] for x, kw in adv_recorded[:3])
    log(f"[kernel] alexandridis on main-path inputs (3 recorded launches): max_abs_err "
        f"{adv_rec_err} (tolerance 0, grid and age)")
    if adv_rec_err != 0:
        fail("alexandridis disagrees with its plain version on main-path inputs")
    adv_max_err = max(adv_max_err, adv_rec_err)

    env_k3 = AdvancedForestFireBulldozerEnv(K3_SIZE, K3_SIZE, key=rng.key(SEED),
                                            num_envs=K3_ENVS)
    k3_obs, k3_info = env_k3.reset()
    k3_acts = ki.adv_actions(gen, K3_STEPS, K3_ENVS)
    torch.cuda.synchronize()
    alexandridis_fused_step.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        k3_obs, _, k3_last = ki.adv_run(env_k3, k3_obs, k3_info, k3_acts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    k3_launches = alexandridis_fused_step.launches
    torch.cuda.synchronize()
    log(f"[advanced] {K3_ENVS} envs at {K3_SIZE}x{K3_SIZE} (the TPU's tiled sizes, CA radius "
        f"{env_k3.ca.burn_kernel_radius}), {K3_STEPS} steps: {k3_launches} alexandridis "
        f"launches, mean reward {k3_last[1].mean().item()}")
    if k3_launches != K3_STEPS or not torch.isfinite(k3_last[1]).all():
        fail(f"expected {K3_STEPS} alexandridis launches and finite rewards at {K3_SIZE}²")
    k3_recorded = ki.record_alexandridis_launches(env_k3, k3_obs, k3_info,
                                           ki.adv_actions(gen, 3, K3_ENVS))
    mark("advanced")

    env_xla = AdvancedForestFireBulldozerEnv(ADV_SIZE, ADV_SIZE, key=rng.key(SEED),
                                             num_envs=ADV_ENVS, use_fused_ca=False,
                                             terrain=env._terrain_ctx)
    t0 = time.perf_counter()
    fused_stats = fire_stats(env, reset_obs, reset_info, DIST_STEPS, DIST_CHECKPOINTS)
    t1 = time.perf_counter()
    xla_stats = fire_stats(env_xla, *env_xla.reset(), DIST_STEPS, DIST_CHECKPOINTS)
    t2 = time.perf_counter()
    log(f"[distribution] [{card}] {ADV_ENVS} envs at {ADV_SIZE}x{ADV_SIZE} from one reset, "
        f"agents standing still, {DIST_STEPS} steps: fused path {t1 - t0:.2f}s, XLA-path "
        f"counterpart (AlexandridisCA, threefry uniforms) {t2 - t1:.2f}s")
    outside = []
    for t in DIST_CHECKPOINTS:
        for i, what in enumerate(("fire cells", "burned cells", "mean fire age")):
            f, x = fused_stats[t][i], xla_stats[t][i]
            band = 4.0 * math.hypot(f.std(unbiased=False).item() / math.sqrt(ADV_ENVS),
                                    x.std(unbiased=False).item() / math.sqrt(ADV_ENVS))
            diff = abs(f.mean().item() - x.mean().item())
            log(f"[distribution] t={t} {what} per env: fused mean {f.mean().item()}, "
                f"XLA-path mean {x.mean().item()}, |diff| {diff}, 4-sigma band {band}")
            if diff > band:
                outside.append(f"t={t} {what}")
    if outside:
        fail(f"fused and XLA-path statistics differ beyond 4 sigma: {outside}")

    mark("distribution")

    # 7. slice 2's times: the Alexandridis kernel's device time on five
    # input sets, each beside its bound for those inputs and its dense
    # bound: at 64 x 256², launches
    # recorded on the main path, the first launches after a reset (2 burning
    # cells per env) and synthetic 10%-fire inputs; at 8 x 512², recorded and
    # synthetic.
    adv_kernel_ms, adv_bound_ms, adv_bound_by, _ = ki.time_k2(
        card, "on recorded main-path launches", adv_recorded, KERNEL_REPEATS)
    after_reset = ki.record_alexandridis_launches(env, reset_obs, reset_info,
                                                  ki.adv_actions(gen, RECORDED_LAUNCHES,
                                                                 ADV_ENVS))
    ki.time_k2(card, "on the first launches after a reset", after_reset, KERNEL_REPEATS)
    synthetic = ki.alexandridis_inputs(ADV_ENVS, ADV_SIZE, ADV_SIZE, gen)
    ki.time_k2(card, "on synthetic 10%-fire inputs", [synthetic], KERNEL_REPEATS)
    for ablate in ABLATIONS[1:]:  # where the dense case's time goes
        t = time_launches(lambda: [alexandridis_fused_step(**synthetic[0], **synthetic[1],
                                                           ablate=ablate)
                                   for _ in range(KERNEL_REPEATS)],
                          KERNEL_REPEATS, "alexandridis_kernel")
        log(f"[time] [{card}] alexandridis ablate={ablate!r} on the same synthetic inputs: "
            f"{t['device_us']} us/launch of device time (events kept {t['seen']})")
    k3_ms = ki.time_k2(card, "on recorded launches", k3_recorded, KERNEL_REPEATS)[0]
    ki.time_k2(card, "on synthetic 10%-fire inputs",
               [ki.alexandridis_inputs(K3_ENVS, K3_SIZE, K3_SIZE, gen)], KERNEL_REPEATS)
    x0, kw0 = adv_recorded[0]
    adv_plain_ms = cuda_ms(lambda: alexandridis_fused_step_plain(**x0, **kw0), 3)
    k3_plain_ms = cuda_ms(lambda: alexandridis_fused_step_plain(**k3_recorded[0][0],
                                                                **k3_recorded[0][1]), 3)
    log(f"[time] [{card}] alexandridis plain version {adv_plain_ms * 1e3} us/call at "
        f"{ADV_ENVS} x {ADV_SIZE}², {k3_plain_ms * 1e3} at {K3_ENVS} x {K3_SIZE}² (CUDA events)")

    step_tuple = env.stateless_step(adv_acts[0], reset_obs, reset_info)
    fresh_keys = rng.fold_in(reset_obs[1]["per_env_context"]["key"], 7)
    step_us = host_us(lambda: env.stateless_step(adv_acts[0], reset_obs, reset_info))
    reset_us = host_us(lambda: env.conditional_reset(step_tuple, adv_acts[0]))
    fresh_us = host_us(lambda: env._initial_per_env_state(fresh_keys))
    log(f"[time] [{card}] parts of an Advanced step, host clock to a synchronize: "
        f"stateless_step {step_us} us, conditional_reset {reset_us} us (no env terminated; "
        f"of it the fresh states of every env {fresh_us} us); alexandridis kernel device "
        f"time {adv_kernel_ms * 1e3} us")

    ki.adv_run(env, reset_obs, reset_info, adv_acts[:2])  # warm
    adv_prof = profile_steps(
        lambda: ki.adv_run(env, reset_obs, reset_info, adv_acts[:PROFILE_STEPS]), PROFILE_STEPS,
        f"Advanced stateless_step + conditional_reset {ADV_ENVS} x {ADV_SIZE}x{ADV_SIZE}", card)
    mark("time_advanced")

    # 8. slice 3: the probes
    probe_kernels = probe_phase(card, gen, adv_recorded)
    mark("probe")

    # 9. slice 5: the trainer
    trained_state, train = train_phase(card)
    adv_max_err = max(adv_max_err, train["alexandridis_max_abs_err"])
    mark("train")

    # 10-11. slice 7: the Helicopter and the evaluation
    heli = helicopter_phase(card, gen)
    mark("helicopter")
    evaluation = eval_phase(card, trained_state)
    adv_max_err = max(adv_max_err, evaluation["alexandridis_max_abs_err"])
    mark("eval")

    # 12-15. slice 8: pinecones, the legacy spec, the curve and the policy evaluation
    pinecones = pinecone_phase(card, gen)
    mark("pinecones")
    legacy = legacy_phase()
    mark("legacy")
    with tempfile.TemporaryDirectory() as out:
        curve, blob, modf_blob = curve_phase(card, Path(out))
        mark("curve")
        policy = policy_phase(card, blob, modf_blob)
        mark("policy")
    adv_max_err = max(adv_max_err, curve["alexandridis_max_abs_err"],
                      policy["alexandridis_max_abs_err"])

    # 16. slice 9: parallel/ on NCCL, after every other phase: none of them
    #     sees a process group
    par = parallel_phase(card, gen, train["samples_per_s"], best)
    adv_max_err = max(adv_max_err, par["alexandridis_max_abs_err"])
    mark("parallel")

    # 17. slice 10: the tools of scripts/, in a process of their own
    tools = tools_process()
    max_err = max(max_err, tools["windy_max_abs_err"])
    adv_max_err = max(adv_max_err, tools["alexandridis_max_abs_err"])
    tool_launches = tools["launches"]
    mark("tools")

    # 18-19. result lines
    grid_draw = rng_out["timings"][f"uniform over {ADV_ENVS} x {ADV_SIZE}² cells"]
    kernels = [{
        "name": "windy_sparse",
        "route": "cuda",
        "source": "gymca_torch/csrc/windy_sparse.cu",
        "replaces": "gymca_tpu/ops/pallas_kernels.py:516",
        "launches": launches,
        "launches_by_path": {"bulldozer": launches,
                             "bench": bench_out["windy_launches"],
                             "scaling": par["scaling_windy_launches"],
                             **{k: v["windy"] for k, v in tool_launches.items()
                                if k in ("profile_step", "exp_split")}},
        "max_abs_err_by_path": {"bulldozer": rec_err, "bench": bench_out["windy_max_abs_err"],
                                "tools": tools["windy_max_abs_err"]},
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "alexandridis",
        "route": "cuda",
        "source": "gymca_torch/csrc/alexandridis.cu",
        "replaces": "gymca_tpu/ops/pallas_alexandridis.py:567",
        "launches": adv_launches,
        "launches_by_path": {"advanced": adv_launches,
                             "bench": bench_out["alexandridis_launches"],
                             "train": train["alexandridis_launches"],
                             "eval": evaluation["alexandridis_launches"],
                             "curve": curve["alexandridis_launches"],
                             "policy": policy["alexandridis_launches"],
                             "parallel": par["alexandridis_launches"],
                             **{k: v["alexandridis"] for k, v in tool_launches.items()
                                if k not in ("profile_step", "exp_split")}},
        "max_abs_err_by_path": {"advanced": adv_rec_err,
                                "bench": bench_out["alexandridis_max_abs_err"],
                                "train": train["alexandridis_max_abs_err"],
                                "eval": evaluation["alexandridis_max_abs_err"],
                                "curve": curve["alexandridis_max_abs_err"],
                                "policy": policy["alexandridis_max_abs_err"],
                                "parallel": par["alexandridis_max_abs_err"],
                                "tools": tools["alexandridis_max_abs_err"]},
        "max_abs_err": adv_max_err,
        "ms": adv_kernel_ms,
        "plain_ms": adv_plain_ms,
        "bound_ms": adv_bound_ms,
        "bound_by": adv_bound_by,
        "library_ms": None,
    }, {
        "name": "threefry",
        "route": "cuda",
        "source": "gymca_torch/csrc/threefry.cu",
        "replaces": None,  # the JAX package's key chain is plain XLA
        "launches": key_launches,
        "launches_by_path": {"bulldozer": key_launches, "advanced": adv_key_launches},
        "max_abs_err": 0,  # [rng] fails on any differing element
        "ms": grid_draw["device_us"] / 1e3,
        "plain_ms": grid_draw["plain_us"] / 1e3,
        "bound_ms": grid_draw["bound_us"] / 1e3,
        "bound_by": grid_draw["bound_by"],
        "library_ms": None,
    }] + probe_kernels
    phases["total"] = time.perf_counter() - t_start
    log("[phases] seconds: " + json.dumps(phases))
    log(json.dumps({"kernels": kernels}))
    old_keys = ("kernels_per_step", "idle_share")
    if prof is not None:
        log(json.dumps({"step": {"env_steps_per_sec": best,
                                 **{k: prof[k] for k in old_keys}}}))
    if adv_prof is not None:
        log(json.dumps({"advanced_step": {"env_steps_per_sec": adv_best,
                                          **{k: adv_prof[k] for k in old_keys}}}))
    log(json.dumps({"bench": bench_out}))
    log(json.dumps({"rng": rng_out}))
    log(json.dumps({"train": train}))
    log(json.dumps({"helicopter": heli}))
    log(json.dumps({"eval": evaluation}))
    log(json.dumps({"pinecones": pinecones}))
    log(json.dumps({"legacy": legacy}))
    log(json.dumps({"curve": curve}))
    log(json.dumps({"policy": policy}))
    log(json.dumps({"parallel": par}))
    log(json.dumps({"tools": tools}, default=str))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(tools_main(sys.argv[2]) if sys.argv[1:2] == ["--tools"] else main())
