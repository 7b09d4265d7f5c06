"""Smoke run of the PyTorch + CUDA port (back2future_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, one line each (any failure raises and exits non-zero):
  1. environment: the card (nvidia-smi name and power limit), TF32 flags
  2. build: nvcc of back2future_tpu_torch/csrc into back2future_tpu_torch/_build
     (one nvcc per source, in parallel); the bf16 tensor-core kernels of
     K1, K2 and K3 (win 9), K5 and K6: registers, spills, shared memory,
     resident blocks per SM, and the HMMA / LDGSTS / LDSM instructions of
     their SASS (cuobjdump); the same for the warp gradients' bf16
     kernels with the global reductions and shared-memory atomics (K4
     and its C = 3 pixel kernel) or the loads and shuffles (W-dflow) of
     their SASS, and for the warp
     gather's bf16 kernels (csrc/warp_fwd_tiled.cu: the rows kernel of
     C = 3, the lanes kernel at C = 32, 64, 96, 128) with the loads,
     stores and shuffles of their SASS; and g++ of the three host helpers
     (runtime/src/resample.cc, getocc.cc, pngfilter.cc by
     runtime/host_build.py) on this host: flags, seconds, the row loops'
     thread count (host_threads())
  3. kernels against their plain torch twins, in bf16 and f32, with the
     max abs error, the tolerance, CUDA-event medians of the kernel, the
     twin and (where one PyTorch call computes the same function) that
     call, and the kernel's bound (bytes over 3.35 TB/s or operations over
     the card's peak for the type, whichever is larger): the forward
     kernels at the shapes of the flagship serving forward at B=16 (KITTI
     1242x375 snapped to 1216x320); the backward kernels (cost volume
     d_ref / d_frame, warp image and flow gradients) at the shapes of the
     train step at B=8, 320x640, fwd and past, with flows past the border;
     the fused stem (K5 unit A, K6 unit B) at the serving (48 frames) and
     train (24 frames) stacked shapes. The bf16 checks are timed also by
     the profiler's device time per call (the summary's numbers), and the
     old CUDA-core kernels of K1, K2, K3 and K5 beside their tensor-core
     kernels at each shape, in turns in one profiler window. The warp
     gradients run on the random flows and on smooth ones (a 2x upsample
     of a coarse field, as a model's), each kernel beside the first
     design's in turns; K4's wrapper's zero-fill and cast apart. The warp
     gather runs at the serving shapes and at the train step's 18 (8
     feature warps, 10 image warps at C = 3), on random and smooth flows,
     and on the serving forward's own 8 warp inputs (captured from
     est.net(x, with_warped=False) of the seeded estimator), beside the
     first design's kernel (csrc/warp_fwd.cu) in turns; per serving
     forward and per train step: kernel, first design, twin,
     F.grid_sample and bound
  4. serving path, stem off: init(None, device="cuda") with the flagship
     config (frames 3, levels 7, win 9, skip 2, bf16, random weights from
     seed 0), compute_flow / compute_flow_batch (B=16, three times) /
     compute_flow_video on seeded requests; shapes, finite values, launch
     counts (10 cost volumes and 8 feature warps per serving forward, no
     backward kernel), a plain_ops() rerun of one batch for comparison,
     wall-clock triplets/s; then the host side on the C++ paths
     (runtime/src/resample.cc, getocc.cc): compute_flow_batch split into
     pre-processing (stack, colour normalisation, resize), copies,
     forward and post-processing, host clock, on the C++ path and inside
     numpy_twins(); each C++ function on the batch's own frames against
     its NumPy twin (1e-5; nearest, rotation and occlusion exact), ms of
     both, the row-threaded ones at 1 thread and at host_threads() with
     the same bits, get_occ on a crop against its Python oracle
  5. serving path, stem on (B2F_STEM_PALLAS=1 for this phase only): the
     same B=16 batch, exactly 1 K5 + 1 K6 + 10 + 8 launches, flow and
     occlusion against the stem-off results; device forward ms stem off /
     on / on / off, twice (the in-model A/B; the default stays off); then
     K1's A/B: the device forward with the CUDA-core cost volume (old) and
     the tensor-core one (new), old / new / new / old, twice; and the
     gather's A/B, the same with the first design's gather (old) and the
     new one (csrc/warp_fwd_tiled.cu)
  6. train path, hard recipe (stem off): the options of
     tools/train_bench.py (optimize pme, OBCC + L1, bf16, B=8, 320x640,
     weights from seed 0, numpy-seeded images on the device),
     create_train_state + make_train_step, 6 steps: finite loss and
     components, exact launch counts per step (10 / 18 / 10 / 10 / 18 / 8),
     step ms (CUDA events, median of steps 2-6), triplets/s trained, peak
     device memory; then one f32 step with the kernels and one under
     plain_ops() from the same initial state: loss and every parameter
     gradient compared; then the backward A/Bs: one bf16 step with the
     CUDA-core K2/K3 (old) and one with the tensor-core ones (new) from
     the same state, every parameter gradient compared, and the step in
     turns old / new / new / old, twice: step ms (CUDA events) and K1-K3
     device ms per step (profiler); the same with the warp gradients'
     first design (old) against K4 and W-dflow (new), warp device ms;
     then K4's routes on the same inputs (`--k4-routes` below)
  6b. criteria (stem off): per criterion and loss branch beyond the hard
     and soft recipes (pme_criterion BCC, SSIM, SSIML1, OSSIM, OSSIML1;
     smooth_occ_penalty KL; optimize epe --epe 1 with seeded flow_gt,
     occ_gt and mask on the device) 3 bf16 steps from the weights of seed
     0: finite loss and components, exact launch counts per step (10 / 18 /
     10 / 10 / 18 / 8; for epe, whose forward skips the 10 image warps,
     10 / 8 / 10 / 10 / 8 / 8), step ms; then the f32 step with the
     kernels against plain_ops()
  6c. remat (stem off): one bf16 hard step with -remat 1 and one without
     from the same state, the loss and every parameter gradient compared
     (within 2e-2 of max|g|); launches a step with remat: cost volume fwd
     20, gather 36, the backward's as without; then steps 2-5 of each:
     step ms and peak device memory, the remat step's the lower
  7. data path, the hard recipe from files on disk (stem off): a
     RoamingImages set of DATA_SCENES scenes at 320x640, 3 frames, written
     by `python -m back2future_tpu_torch.data.roaming`'s main (seconds,
     bytes); a FlowDataset on its train split and a process-mode
     PrefetchLoader (B=8, min(8, host cores) workers; spawn, since CUDA is
     live) in two configurations: (a) learn_demo's recipe data (augment
     0, rand_crop 0, the compact wire, scene_batches full) and (b)
     augment 1 on the f32 wire. For each: the loader alone (samples/s
     over 16 batches after the first and over the workers' second round,
     time to the first batch), with --data the pipe alone (as many
     producer processes as workers, of the same start method, streaming
     the configuration's batch through one queue: their start-up and ms
     a batch, its share of the loader's time a batch), a sample's time in
     sync mode, the first 3 batches bit-identical to sync mode
     (n_workers=0), then DATA_STEPS (13) hard bf16 steps fed through
     device_prefetch(depth=2): exact launch counts per step, finite loss,
     median step ms over the steps after the first (CUDA events),
     triplets/s trained (wall clock) and the mean host wait in next(),
     over those steps and the last 8, beside the random-tensor step of
     phase 6
  7b. loop path (stem off): train.loop.run() on a RoamingImages set of
     LOOP_SCENES scenes at 320x640 (20 train / 4 val), data configuration
     (a) without scene batches and with ground truth, the hard recipe in
     bf16 at B=8, epochSize 4, 2 epochs, a checkpoint each epoch, 8
     spawned loader workers: exact launch counts of every train step (10 /
     18 / 10 / 10 / 18 / 8) and every eval step (10 cost volumes, 18
     warps, no backward kernel), the checkpoint pairs, options.json, the
     two-row train.log / test.log with finite avg epe, their SVGs and
     `log`; each epoch's wall time and triplets/s through run() beside
     phase 7's loader-fed figure, the eval epoch's time, the checkpoint
     pair's save and load ms; then -cont with persistent Adam moments for
     a third epoch: the parameters and the Adam state right after the
     load equal the first run's final state bit for bit, the step counter
     goes on from 8 to 12; then init(<save dir>) (its ms) serves
     compute_flow_batch at B=16 on 1242x375 frames with 10 + 8 launches,
     its flow and occlusion bit-identical to the trained module's own
     forward on the same input; then the eval CLI
     (`python -m back2future_tpu_torch.eval`) over the val split prints
     finite metrics
  8. train path, soft fine-tune recipe (stem on): the hard net of phase 6
     turned into a soft one by convert_net_hard_to_soft (OBGCC,
     past_flow, const_vel 1, second-order smoothness), 6 bf16 steps with
     exact launch counts for all eight kernels (1 K5 + 1 K6 + 10 / 18 /
     10 / 10 / 18 / 8), then the f32 kernels-vs-plain_ops() step; then
     6c's remat comparison on the soft step (K5 and K6 twice with remat)
  10. netType spynet (stem off; frames 3, levels 7, widths 32-64-32-16,
     no stem and no cost volume; seed-0 weights): the bf16 serving
     forward at B=16 320x1216 (with_warped=False: 12 gathers and no other
     kernel; finest flow and occlusion against plain_ops(); device ms,
     CUDA events; peak memory); 6 bf16 pme steps of the hard recipe at
     B=8 320x640 (26 gathers, 12 K4, 26 W-dflow a step; finite loss;
     step ms, median of steps 2-6; triplets/s; peak memory); the gather,
     K4 and W-dflow on the first step's own 26 warp inputs against their
     twins, with profiler device ms per step beside the twins', the
     library calls' (F.grid_sample, aten.grid_sampler_2d_backward) and
     the bound; K4 on its 12 inputs by its C = 3 route and by the quad
     tiles the path took before it, each within 1e-5 of the largest value
     of the twin's and of the other's f32 sums, then in turns in one
     profiler window, per level and per step, the kernel, its zero-fill
     and its cast apart; the f32 pme step with the kernels against plain_ops();
     one bf16 epe step on seeded ground truth (12 / 0 / 12) and its f32
     step against plain_ops(); then train.loop.run() with netType spynet
     on a 12-scene 320x640 RoamingImages set (1 epoch of 2 steps, the
     synchronous loader, a checkpoint; every train step 26 / 12 / 26,
     every eval step 26 gathers), the eval CLI over its val split
     (finite metrics), and init(<save dir>) refusing it with the JAX
     package's error
  11. .t7 conversion: a seeded flagship PWCNet (bf16, levels 7, win 9,
     skip 2, frames 3), with past_flow 0 and 1, written as a reference
     nn.gModule module tree (frame-2 and frame-3 pyramid convs as
     value-equal copies) by the port's save_t7, converted by
     `python -m back2future_tpu_torch.convert_t7`, served by init(out):
     compute_flow_batch at B=16 on 1242x375 frames with 10 K1 + 8
     gathers, bit-identical to the seeded net's own forward
  12. serving export (stem off): torch.library.opcheck of every b2f op
     on CUDA tensors in bf16 and f32, at a small shape and at a
     main-path shape; then, only where `--parent DIR` names an unpacked
     tree of another commit (the parent, to A/B a change), that tree and
     this one each in a worker process that loads this tree's kernel
     library: SHA-256 digests of the eager serving forward's (flow, occ)
     at B=16 320x1216 on a seeded input (equal) and of a seeded hard
     bf16 step's loss (equal) and parameter gradients at B=8 320x640,
     twice each (K4's f32 atomics vary the gradients from run to run,
     so across the trees each must be within GRAD_SPREAD_FACTOR times
     the largest difference between a tree's own two runs; the
     bit-identical ones counted), then the serving forward's and the
     hard step's ms and an op call's host µs in turns (parent / this /
     this / parent, twice); then the flagship exported at B=16 320x1216 bf16
     (FlowEstimator.export: s, MiB), served by load_exported from a fresh
     `python` process on the card (load s, first-call s; K1 10 and the
     gather 8 a call; no module of back2future_tpu_torch.models imported;
     results equal to eager compute_flow_batch bit for bit); the device
     forward exported vs eager in turns, CUDA events; then
     `back2future_tpu_torch.serve_bench --export`, in this process (B=1 at the
     kitti and sintel resolutions, eager and exported)
  13. data parallelism (stem off): (a) an NCCL group of one rank joined
     from the B2F_COORDINATOR / B2F_NUM_PROCESSES / B2F_PROCESS_ID spec,
     6 hard bf16 steps at B=8 320x640 through DDP (exact launches per
     step), the first held against the same step without a group (loss,
     every gradient within 2e-2 of max|g|); (b) (with --ddp alone; in
     the default run it is phase 14 (d)) dryrun_multichip(8,
     backend="gloo"); (c) run() (f32, B=4, 3 steps and validation) on a
     generated 16-scene RoamingImages set by 2 gloo ranks sharing the
     card, which this script starts and joins to a group, against a
     1-rank run() with the same global batch: launches, train.log
     losses (rtol 2e-3), the .host1 side log, the checkpoint; then the
     2-rank f32 DDP step against the step on the whole B=8 batch (loss,
     every gradient within 1e-3 of max|g|); (d) the flagship served at
     B=16 on a mesh of two replicas of cuda:0 (K1 20, gather 16 a call)
     against the single-device estimator, and both timed in turns
     (one device, mesh, mesh, one device);
     (e) the hard step's host ms to return, device ms (CUDA events) and
     device busy ms (the profiler's kernel time) with DDP at world size 1
     and without, in turns
  14. the spatial mesh axis, run before phase 13 in the default run
     (after phase 13's NCCL group was torn down, the profiler once
     recorded no device time in any window), its part (a) right after
     phase 3 (later in the run the profiler once recorded only some of a
     window's kernels; a window is taken again until it holds them all)
     (stem off; image rows in bands, S = 2): (a)
     the row-window gather, K4 and W-dflow at the sharded feature warps'
     bf16 shapes (bands of levels 3-6 of the serving forward and of the
     hard step) against their twins, the gather and W-dflow bit for bit
     against the rows of the whole image's launch, K4's bands summed
     against it within its atomics' spread; per slot forward and rank
     step the kernels', twins' and library calls' device ms and the
     bound, and the bytes each feature-warp gather moves per rank; (a')
     the same at SPyNet's C = 3 bands (B=8 320x640, resolution levels
     1-6, SPyNet's levels 7-2: bands of 160 down to 5 rows), per rank
     step 4 gathers, 2 K4 and 4 W-dflow a level, and K4 on band 1 by its
     C = 3 route and by the quad tiles in turns, as in phase 10; (b)
     the flagship served at B=16 on data x spatial meshes of (1, 2) and
     (2, 2) slots of cuda:0 (threads) against the single-device
     estimator (phase 13 (d)'s tolerance; K1 10 and the gather 8 a slot;
     wall ms in turns); (c) the hard bf16 step at B=8 320x640 on 2
     spatial gloo ranks sharing the card against the unsharded step (in
     this process), the loss on the row bands: loss, every gradient
     within 2e-2 of max|g|, each rank's launches, the peak device memory
     a step takes, step ms; (c') in the same ranks, the SPyNet pme step
     (frames 3, levels 7, B=8 320x640) against the unsharded one: bf16
     at (c)'s tolerances with its launches (gather 26, K4 12, W-dflow 26
     a rank), peaks and step ms, and f32 (TF32 off) with every gradient
     within 1e-3 of max|g|; (d)
     dryrun_multichip(8, backend="gloo"): 8 ranks on a data x spatial
     mesh of (4, 2) sharing the card, one f32 step of each recipe, the
     JAX package's recorded losses at rtol 1e-4, each rank's launches;
     (e) run() (f32, B=4, 3 steps and validation) on a (1, 2) mesh of
     gloo ranks against 1 rank: train.log and test.log losses (rtol
     2e-3), launches
  15. one JSON line of the kernels (forward kernels: launches of the
     serving path and ms per serving forward; backward kernels: launches
     of the hard train path and ms per train step; K5/K6: launches of the
     soft train path and ms per train step; then the gather, K4 and
     W-dflow of the SPyNet path: launches over its 6 pme steps, ms per
     pme step on the step's own inputs; then the DDP step's kernels:
     launches over phase 13 (a)'s 6 steps, ms per train step, K1's per
     serving forward; then the row-window gather, K4 and W-dflow of
     phase 14: launches of a (1, 2) serving call and of a spatial rank's
     hard or SPyNet step, ms per slot forward or rank step), then the
     result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
It imports nothing of JAX and never runs on the CPU.

    python3 chip_smoke.py --host

runs, after phase 1 and the build, only phase 4 (with its host checks)
and prints the result line.

    python3 chip_smoke.py --spynet

runs, after phase 1 and the build, only phases 10 and 11 and prints the
SPyNet path's kernel entries and the result line.

    python3 chip_smoke.py --ddp

runs, after phase 1 and the build, only phase 13 and prints the result
line.

    python3 chip_smoke.py --spatial

runs, after phase 1 and the build, only phase 14 and prints its kernel
entries and the result line.

    python3 chip_smoke.py --serving-export [--parent DIR]

runs, after phase 1 and the build, only phase 12 and prints the result
line; DIR is an unpacked tree of the parent commit (`git archive`), which
the default run also takes as `python3 chip_smoke.py --parent DIR`.

    python3 chip_smoke.py --profile

runs, after phases 1-2, only a torch.profiler breakdown of the bf16 train
step at B=8, 320x640: the hard recipe, and the soft recipe with the stem
off and on; per step the unprofiled step ms (CUDA events), the device
busy ms (profiled kernel, copy and memset time), the idle share, and the
device time by kind of op.

    python3 chip_smoke.py --data

runs, after phase 1 and the build, only the hard train steps of phase 6
(for the random-tensor step) and the data path of phase 7.

    python3 chip_smoke.py --loop

runs, after phase 1 and the build, only the loop path of phase 7b.

    python3 chip_smoke.py --criteria

runs, after phase 1 and the build, only phases 6b and 6c and the soft
step's remat comparison of phase 8.

    python3 chip_smoke.py --learn [--scenes N] [--escape_scenes N] [learn_demo flags]

runs, after phase 1 and the build, only the learning demonstration on the
card (tens of minutes): a 300-scene RoamingImages set (seed 0, 320x640,
the generator's other defaults: 7 frames, val fraction 0.1) and a
10-scene escape set (seed 1) in a temporary directory, then
`python -m back2future_tpu_torch.learn_demo` with its defaults (escape 2
epochs, curriculum 30 x 2, hard 20, soft 3, epoch size 250, B=16, the
compact wire, the synchronous loader) or the flags given, which may name
its `--out` (default docs/evidence/learning_demo_torch).
It prints per stage the val EPE and occlusion accuracy per epoch, an
epoch's wall time and triplets/s, the zero-flow baseline, the escape
checkpoint's transfer probe, the evals and the past-flow sanity, then
K4's routes (as `--k4-routes`) on the trained hard net's own K4 inputs
(B=8, the first val scenes), and fails unless the hard stage's val EPE
is below the zero-flow baseline and the soft stage's is finite.

    python3 chip_smoke.py --pipe-variants

runs, after phase 1 and the build, only the transfer of one loader batch
of each wire (compact, f32; B=8, 320x640) from a spawned process to this
one, by the loader's multiprocessing queue and by alternatives: a
multiprocessing Connection (the queue's transport without its feeder
thread), the same with the pipe enlarged to 1 MiB, length-framed
os.readv into a buffer of the message's size through a 1 MiB pipe, and
shared memory (the arrays copied in and out, only their names sent):
median ms a batch.

    python3 chip_smoke.py --k6-phases

runs, after phases 1-2, only K6's bf16 kernel with its convs removed one
at a time (variants built from copies of its source), timed at the
serving and train shapes: where its time goes.

    python3 chip_smoke.py --k5-phases

does the same for K5's bf16 kernel: without conv 1, without conv 2, or
without its device-memory traffic, at the serving and train shapes.

    python3 chip_smoke.py --k1-phases

does the same for K1's bf16 kernel (win 9, dil 1): without its products,
its band scatter, its output store, or its device-memory traffic, at the
serving levels' shapes.

    python3 chip_smoke.py --gather-variants

runs, after phases 1-2, only the warp gather's bf16 kernels against
variants of their design on the same inputs (copies of
csrc/warp_fwd_tiled.cu with edits: the next pixel's flow loaded ahead,
C = 3 output staged for 16-byte stores, C = 3 bf16 spans as aligned
32-bit words or 16-byte chunks, no persistent grid): per serving forward and per train
step, on random and smooth flows and on each path's own inputs.

    python3 chip_smoke.py --k4-routes

runs, after phases 1-2, only K4's routes against each other on the same
bf16 inputs: the train step's feature-warp shapes on random and smooth
flows, and the hard step's own K4 inputs; per call and per step, the
blocks that take the window route and the kernel's device ms as the path
chooses, with every block direct, and with the window wherever a
block's box fits.

    python3 chip_smoke.py --k4-c3

runs, after phases 1-2, only K4's C = 3 routes against each other on the
SPyNet pme step's own 12 K4 inputs (bf16, B=8 320x640 down to 10x20):
the path's, the quad tiles', and the pixel kernel direct on every block
and with the window wherever a box fits; each against the twin and the
quad tiles, then in turns, per level and per step, the kernel, its
zero-fill and its cast, beside aten.grid_sampler_2d_backward.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

B = 16
H_IN, W_IN = 375, 1242                 # KITTI frames
H, W = 320, 1216                       # snapped to the /64 grid
# (H, W, C) of the pyramid levels 3..7 of the flagship forward at H x W
LEVEL_SHAPES = [(H >> (l - 1), W >> (l - 1), c)
                for l, c in zip(range(3, 8), (32, 64, 96, 128, 192))]
WIN = 9
# kernel vs twin: both sum in f32; f32 differs by summation order, bf16 by
# one rounding of the output
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}   # rtol = atol
# whole model, bf16, kernels vs plain_ops(): the per-op bf16 roundings
# differ and propagate through 5 decoder levels and 4 feature warps
FLOW_TOL_FRAC = 0.05                   # of max |flow|
OCC_TOL = 0.01                         # share of occlusion-mask pixels that flip

# the train step of tools/train_bench.py: B=8, 320x640; levels 3..7 of it
TRAIN_B, TRAIN_H, TRAIN_W = 8, 320, 640
TRAIN_LEVELS = [(TRAIN_H >> (l - 1), TRAIN_W >> (l - 1), c)
                for l, c in zip(range(3, 8), (32, 64, 96, 128, 192))]
# the image warps run at the output size of levels 3..7 (skip 2: full size first)
IMAGE_WARP_SHAPES = [(TRAIN_H >> j, TRAIN_W >> j, 3) for j in range(5)]
# the fused stem runs once per forward on the frame-stacked batch (3 frames)
STEM_SHAPES = {"serving": (3 * B, H, W), "train": (3 * TRAIN_B, TRAIN_H, TRAIN_W)}
TRAIN_STEPS = 6
# f32 train step, kernels vs plain_ops(): sums in another order, and the
# image gradient's f32 atomics in an order that varies from run to run
LOSS_RTOL = 1e-4
GRAD_TOL_FRAC = 1e-3                   # of max |gradient| per parameter
# bf16 train step, CUDA-core vs tensor-core K2/K3: each rounds its f32 sums
# to bf16 once (2^-8 relative), in another order, so an output may differ
# by one rounding; that propagates through the bf16 backward of the
# decoder and the features (5 levels, 4 warps) and the image gradient's
# atomics
BF16_GRAD_TOL_FRAC = 2e-2              # of max |gradient| per parameter
# phase 12 with --parent: the hard bf16 step's gradients of two trees may
# differ by this many times the most that one tree's two runs differ
GRAD_SPREAD_FACTOR = 3.0

# the card's published peaks (H100 SXM, dense): memory, and operations by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# launches of one serving forward and of one train step, per kernel (the
# CUDA-core cost volume kernels, K5's CUDA-core kernel, K4's route
# comparison and the warp's first design are for timing only)
SERVING_PER_FORWARD = {"b2f_cost_volume_fwd": 10, "b2f_cost_volume_fwd_cuda_cores": 0,
                       "b2f_warp_bilinear_fwd": 8, "b2f_warp_bilinear_fwd_thread": 0,
                       "b2f_cost_volume_dref": 0, "b2f_cost_volume_dframe": 0,
                       "b2f_cost_volume_dref_cuda_cores": 0,
                       "b2f_cost_volume_dframe_cuda_cores": 0,
                       "b2f_warp_bilinear_dflow": 0, "b2f_warp_bilinear_dimages": 0,
                       "b2f_warp_bilinear_dimages_routes": 0,
                       "b2f_warp_bilinear_dimages_thread": 0,
                       "b2f_warp_bilinear_dflow_thread": 0,
                       "b2f_stem_unit_a": 0, "b2f_stem_unit_a_cuda_cores": 0,
                       "b2f_stem_unit_b": 0}
SERVING_STEM_PER_FORWARD = dict(SERVING_PER_FORWARD, b2f_stem_unit_a=1, b2f_stem_unit_b=1)
TRAIN_PER_STEP = {"b2f_cost_volume_fwd": 10, "b2f_cost_volume_fwd_cuda_cores": 0,
                  "b2f_warp_bilinear_fwd": 18, "b2f_warp_bilinear_fwd_thread": 0,
                  "b2f_cost_volume_dref": 10, "b2f_cost_volume_dframe": 10,
                  "b2f_cost_volume_dref_cuda_cores": 0,
                  "b2f_cost_volume_dframe_cuda_cores": 0,
                  "b2f_warp_bilinear_dflow": 18, "b2f_warp_bilinear_dimages": 8,
                  "b2f_warp_bilinear_dimages_routes": 0, "b2f_warp_bilinear_dimages_thread": 0,
                  "b2f_warp_bilinear_dflow_thread": 0,
                  "b2f_stem_unit_a": 0, "b2f_stem_unit_a_cuda_cores": 0,
                  "b2f_stem_unit_b": 0}
SOFT_PER_STEP = dict(TRAIN_PER_STEP, b2f_stem_unit_a=1, b2f_stem_unit_b=1)
# the criteria phase: 3 bf16 steps of the hard step with each criterion and
# loss branch this port added, stem off, from the weights of seed 0
CRITERIA_CASES = (("BCC", dict(pme_criterion="BCC")), ("SSIM", dict(pme_criterion="SSIM")),
                  ("SSIML1", dict(pme_criterion="SSIML1")), ("OSSIM", dict(pme_criterion="OSSIM")),
                  ("OSSIML1", dict(pme_criterion="OSSIML1")),
                  ("KL", dict(smooth_occ_penalty="KL")), ("epe", dict(optimize="epe", epe=1.0)))
CRITERIA_STEPS = 3
# optimize="epe" reads no image warp, so the forward skips the 10 image
# warps and the backward their 10 flow gradients
EPE_PER_STEP = dict(TRAIN_PER_STEP, b2f_warp_bilinear_fwd=8, b2f_warp_bilinear_dflow=8)
# -remat 1: the forward runs again during the backward; the backward as before
REMAT_PER_STEP = dict(TRAIN_PER_STEP, b2f_cost_volume_fwd=20, b2f_warp_bilinear_fwd=36)
SOFT_REMAT_PER_STEP = dict(REMAT_PER_STEP, b2f_stem_unit_a=2, b2f_stem_unit_b=2)
REMAT_STEPS = 5                        # the first compared, steps 2-5 timed

# the data path (phase 7): a generated RoamingImages set, the loader's two
# configurations (SampleConfig fields, PrefetchLoader keywords)
# the set, the pipe probe and the loader-fed steps are cut to 24 scenes, 1
# batch a producer and 13 steps (from 48, 3 and 21), and the default run
# leaves the pipe probe out, to keep it well inside its time limit
DATA_SCENES = 24
DATA_BATCHES = 17                      # the first batch, then 16 timed
DATA_CHECKED = 3                       # batches held against sync mode
DATA_PIPE_PER_WORKER = 1               # batches each pipe-probe producer sends
DATA_STEPS = 13                        # the first step, then 12 timed
DATA_STEADY = 8                        # the last steps, past the workers' prefetch
PIPE_MESSAGES = 6                      # batches each pipe variant sends
DATA_LAUNCHES = ("b2f_cost_volume_fwd", "b2f_warp_bilinear_fwd", "b2f_cost_volume_dref",
                 "b2f_cost_volume_dframe", "b2f_warp_bilinear_dflow", "b2f_warp_bilinear_dimages")
# the loop path (phase 7b, --loop): run() on a generated RoamingImages set
# (val fraction 0.25 at seed 0: 20 train / 4 val scenes), data
# configuration (a) without scene batches, ground truth on
LOOP_SCENES = 24
LOOP_VAL_FRACTION = 0.25
LOOP_EPOCH_SIZE = 4
LOOP_OPTIONS = dict(optimize="pme", compute_dtype="bfloat16", augment=0, rand_crop=0,
                    wire="compact", ground_truth=True)
EVAL_PER_STEP = dict(dict.fromkeys(TRAIN_PER_STEP, 0), b2f_cost_volume_fwd=10,
                     b2f_warp_bilinear_fwd=18)
# netType spynet (phase 10, --spynet), frames 3, levels 7: 12 input warps
# (2 frames x levels 2-7) a forward; the pme step adds 14 output warps
# (levels 1-7), K4 on the 12 whose images are warped frames (level 1
# warps the pooled input), W-dflow on all 26; epe reads no image warp
SPY_SERVING_PER_FORWARD = dict(dict.fromkeys(TRAIN_PER_STEP, 0), b2f_warp_bilinear_fwd=12)
SPY_PME_PER_STEP = dict(SPY_SERVING_PER_FORWARD, b2f_warp_bilinear_fwd=26,
                        b2f_warp_bilinear_dimages=12, b2f_warp_bilinear_dflow=26)
SPY_EPE_PER_STEP = dict(SPY_SERVING_PER_FORWARD, b2f_warp_bilinear_dflow=12)
# the pme eval step's loss reads the output warps, so it runs them too
SPY_EVAL_PER_STEP = dict(SPY_SERVING_PER_FORWARD, b2f_warp_bilinear_fwd=26)
SPY_SCENES = 12                        # run()'s set (val fraction 0.25: 9 train / 3 val)
# the learning demo (--learn): the main set and the escape set of
# docs/evidence/learning_demo/attempt2/README.md:3-8
LEARN_SCENES = 300
LEARN_ESCAPE_SCENES = 10
DATA_CONFIGS = (
    ("a", "learn_demo's recipe data: augment 0, rand_crop 0, compact wire, "
          "scene_batches full", dict(augment=0, rand_crop=0, wire="compact"),
     dict(scene_batches=1_000_000_000)),
    ("b", "augment 1, gaussian_noise 0, f32 wire",
     dict(augment=1, gaussian_noise=0.0, wire="f32"), dict()),
)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def counts() -> dict:
    from back2future_tpu_torch.runtime import KERNELS

    return {k: v.launches for k, v in KERNELS.items()}


@contextlib.contextmanager
def stem(on: bool):
    """B2F_STEM_PALLAS set to `on` inside the block, restored after."""
    before = os.environ.get("B2F_STEM_PALLAS")
    os.environ["B2F_STEM_PALLAS"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            del os.environ["B2F_STEM_PALLAS"]
        else:
            os.environ["B2F_STEM_PALLAS"] = before


def cuda_ms(fn, reps: int) -> float:
    """Median over `reps` single launches of `fn`, CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, attempts: int = 8) -> dict:
    """Device time per call of `fn` by kernel name: the CUDA kernels it
    launches, summed by torch.profiler over `reps` calls after a warm-up,
    without the host time between them (which single-launch event windows
    include). A window in which the profiler recorded no device time (it
    happens now and then over many windows, and three in a row stopped a
    default run in phase 3) is logged and taken again after a second, up
    to `attempts` times in all, every other one tracing the host's
    activity too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        if attempt:
            log("profiler", f"window {attempt} recorded no device time; taking it again")
            time.sleep(1.0)
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if attempt % 2 else [])
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
        if by_name:
            return by_name
    raise AssertionError(f"the profiler recorded no device time in {attempts} windows")


def device_total_ms(fn, reps: int) -> float:
    """The device time per call of `fn`, all its kernels summed
    (`device_ms`); for a twin or a library call, which is timed beside a
    kernel but holds nothing of the port, a median of CUDA-event windows
    (`cuda_ms`, host gaps included, said so in the log) where the
    profiler records no device time in any of `device_ms`'s windows."""
    try:
        return sum(device_ms(fn, reps).values())
    except AssertionError as e:
        ms = cuda_ms(fn, reps)
        log("kernels", f"{e}; CUDA events instead: {ms:.4f} ms a call")
        return ms


def complete_device_ms(fn, reps: int, part: str, launches: int, attempts: int = 8) -> float:
    """The device time per call of `fn` of the kernel whose name contains
    `part` (`launches` a call), its own launches summed, from a profiler
    window that holds all `reps` x `launches` of them. A fill kernel
    before and after the calls pads the window, since the profiler has
    left out a window's first or last kernel; a window that still misses
    launches is logged and taken again, up to `attempts` windows; after
    that, a median of CUDA-event windows of `fn` (`cuda_ms`: all its
    device work and the host gaps), said so in the log."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.empty(1 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad.zero_()
            for _ in range(reps):
                fn()
            pad.zero_()
            torch.cuda.synchronize()
        mine = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation and part in e.name]
        if len(mine) == reps * launches:
            return sum(e.time_range.elapsed_us() for e in mine) / reps / 1e3
        log("profiler", f"window {attempt + 1} held {len(mine)} of the {reps * launches} "
                        f"launches of {part}; taking it again")
        time.sleep(1.0)
    ms = cuda_ms(fn, reps)
    log("profiler", f"no complete window of {part} in {attempts}; CUDA events instead: "
                    f"{ms:.4f} ms a call")
    return ms


def host_ms(fn, reps: int) -> float:
    """Median over `reps` calls of the host time `fn` takes to return
    (the enqueue; the device is idle at each call's start), after a
    warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card, flush=True)   # name, power limit as nvidia-smi gives them
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda}; "
               f"device_count {torch.cuda.device_count()}; "
               f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
               f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return card


def phase_build() -> None:
    from back2future_tpu_torch.runtime import cuda_build

    t0 = time.perf_counter()
    so = cuda_build.build()
    log("build", f"{so.name} in {time.perf_counter() - t0:.1f} s")
    report = so.with_suffix(".log").read_text() if so.with_suffix(".log").exists() else ""
    for line in report.splitlines():
        if "spill" in line or "Used" in line or "Compiling entry" in line:
            log("build", "ptxas " + line.strip()[:200])


HOST_LIBS = ("resample", "getocc", "pngfilter")
# C++ resampler (f32 weights) vs its NumPy twin (f64 weights), as
# tests/test_torch_data.py's IMAGE_TOL; nearest gathers, rotations and
# the occlusion are exact
HOST_TOL = 1e-5


def phase_host_build() -> None:
    """Phase 2's host helpers: g++ of runtime/src/{resample,getocc,
    pngfilter}.cc on this host (runtime/host_build.py), their flags and
    build seconds, and the thread count the row loops take."""
    from back2future_tpu_torch.runtime import host_build

    sig = host_build.cpu_signature().splitlines()
    cpu = "; ".join([sig[0]] + [line for line in sig if line.startswith(("model name",
                                                                         "CPU part"))])
    log("build", f"host helpers: {host_build.CXX} {' '.join(host_build.CXX_FLAGS)}; {cpu}; "
                 f"host_threads() {host_build.host_threads()} (OMP_NUM_THREADS="
                 f"{os.environ.get('OMP_NUM_THREADS')!r}, {len(os.sched_getaffinity(0))} CPUs "
                 f"in the affinity mask)")
    for name in HOST_LIBS:
        cached = host_build.library_path(name).exists()
        t0 = time.perf_counter()
        so = host_build.build(name)
        host_build.load_library(name)
        log("build", f"{so.name} {'cached' if cached else 'built'} in "
                     f"{time.perf_counter() - t0:.2f} s")


def mma_build_report(label: str, info: dict, function: str, ops=("HMMA", "LDGSTS", "LDSM"),
                     prefixes=(), required=("HMMA",)) -> None:
    """What the build made of a kernel: registers, local memory and shared
    memory from the runtime (`info`), spills from the build's `-Xptxas -v`
    report, resident blocks per SM, and the count of each of `ops` in its
    SASS (by default the bf16 tensor-core kernels' HMMA, cp.async LDGSTS
    and ldmatrix LDSM) and of every opcode that starts with one of
    `prefixes`, by `cuobjdump -sass`, for the function whose mangled name
    contains `function`. An instruction of `required` missing from the
    SASS (no count of an opcode that starts with it) fails."""
    from back2future_tpu_torch.runtime import cuda_build

    so = cuda_build.library_path()
    report = so.with_suffix(".log").read_text().splitlines()
    spills = next((report[i + 1].strip() for i, line in enumerate(report[:-1])
                   if "Function properties" in line and function in line), "not found")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or shutil.which("cuobjdump", path=os.path.join(home, "bin"))
    if tool is None:
        sass = "cuobjdump not found (PATH, $CUDA_HOME/bin): SASS not read"
    else:
        body = next((f for f in sass_dump(tool, str(so)).split("Function : ")[1:]
                     if function in f.split(None, 1)[0]), "")
        n = {op: len(re.findall(rf"\b{op}\b", body)) for op in ops}
        opcodes = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][\w.]*)", body)
        for op in sorted({o for o in opcodes if o.startswith(tuple(prefixes))} if prefixes else ()):
            n[op] = opcodes.count(op)
        sass = f"SASS ({tool}): " + ", ".join(f"{k} {v}" for k, v in n.items())
        missing = [op for op in required if not any(k.startswith(op) and v for k, v in n.items())]
        if missing:
            raise AssertionError(f"{label}: no {', '.join(missing)} instruction in the built "
                                 f"kernel's SASS")
    log("build", f"{label}: {info['registers']} registers, "
                 f"{info['local_bytes']} bytes local memory per thread ({spills}), "
                 f"{info['smem_bytes']} bytes shared memory per block, "
                 f"{info['blocks_per_sm']} resident blocks per SM; {sass}")


@functools.lru_cache(maxsize=None)
def sass_dump(tool: str, so: str) -> str:
    """`cuobjdump -sass` of the library, run once for all the reports."""
    return subprocess.run([tool, "-sass", so], check=True, capture_output=True, text=True,
                          timeout=300).stdout


# the warp gather's bf16 kernels that phase 2 reports: warp_fwd_tiled_info's
# name, C, and the mangled template of the kernel (T, VEC, G, PPL)
GATHER_BUILDS = (("rows", 3, "warp_bilinear_fwd_rows_kernelI13__nv_bfloat16E"),
                 ("c32", 32, "warp_bilinear_fwd_lanes_kernelI13__nv_bfloat16Li8ELi4ELi1EE"),
                 ("c64", 64, "warp_bilinear_fwd_lanes_kernelI13__nv_bfloat16Li8ELi8ELi1EE"),
                 ("c96", 96, "warp_bilinear_fwd_lanes_kernelI13__nv_bfloat16Li8ELi4ELi3EE"),
                 ("c128", 128, "warp_bilinear_fwd_lanes_kernelI13__nv_bfloat16Li8ELi8ELi2EE"))


def phase_mma_builds() -> None:
    """The build reports of K1's (win 9), K2/K3's (win 9), K5's and K6's
    bf16 tensor-core kernels, of the warp gradients' bf16 kernels (K4's
    global reductions and shared-memory atomics, W-dflow's loads and
    shuffles), and of the warp gather's bf16 kernels (loads, stores and
    shuffles)."""
    from back2future_tpu_torch.ops import (
        cost_volume_bwd_bf16_info, cost_volume_fwd_bf16_info, warp_bwd_tiled_info,
        warp_fwd_tiled_info,
    )
    from back2future_tpu_torch.ops.stem import stem_unit_a_bf16_info, stem_unit_b_bf16_info

    mma_build_report("K1 bf16 (cost_volume_fwd_mma_kernel<9, true>, win 9 dil 1)",
                     cost_volume_fwd_bf16_info(), "cost_volume_fwd_mma_kernelILi9ELb1E")
    for k, dframe in (("K2", False), ("K3", True)):
        mma_build_report(f"{k} bf16 (cost_volume_bwd_mma_kernel<9, {str(dframe).lower()}>, "
                         "win 9, any dil)", cost_volume_bwd_bf16_info(dframe),
                         f"cost_volume_bwd_mma_kernelILi9ELb{int(dframe)}E")
    mma_build_report("K5 bf16 (stem_unit_a_mma_kernel)", stem_unit_a_bf16_info(),
                     "stem_unit_a_mma")
    mma_build_report("K6 bf16 (stem_unit_b_mma_kernel)", stem_unit_b_bf16_info(),
                     "stem_unit_b_mma")
    mma_build_report("K4 bf16 (warp_bilinear_dimages_tiled_kernel<bf16, 4, true, false>)",
                     warp_bwd_tiled_info("dimages"),
                     "warp_bilinear_dimages_tiled_kernelI13__nv_bfloat16Li4ELb1ELb0E", ops=(),
                     prefixes=("RED", "ATOM"), required=("RED", "ATOMS"))
    mma_build_report("K4 bf16, direct on every block "
                     "(warp_bilinear_dimages_tiled_kernel<bf16, 4, false, false>)",
                     warp_bwd_tiled_info("dimages_direct"),
                     "warp_bilinear_dimages_tiled_kernelI13__nv_bfloat16Li4ELb0ELb0E", ops=(),
                     prefixes=("RED", "ATOM"), required=("RED",))
    mma_build_report("K4 bf16, C = 3 (warp_bilinear_dimages_pixels_kernel<bf16>)",
                     warp_bwd_tiled_info("dimages_c3"),
                     "warp_bilinear_dimages_pixels_kernelI13__nv_bfloat16E", ops=(),
                     prefixes=("RED", "ATOM", "LDG"), required=("RED", "ATOMS"))
    mma_build_report("W-dflow bf16, C = 3 (warp_bilinear_dflow_rows_kernel<bf16>)",
                     warp_bwd_tiled_info("dflow_rows"),
                     "warp_bilinear_dflow_rows_kernelI13__nv_bfloat16E", ops=(),
                     prefixes=("LDG", "LDS", "STS"), required=("LDG",))
    mma_build_report("W-dflow bf16, lane groups (warp_bilinear_dflow_lanes_kernel<bf16, 8, 4>)",
                     warp_bwd_tiled_info("dflow_lanes"),
                     "warp_bilinear_dflow_lanes_kernelI13__nv_bfloat16Li8ELi4E", ops=(),
                     prefixes=("LDG", "SHFL"), required=("LDG", "SHFL"))
    for name, c, function in GATHER_BUILDS:
        mma_build_report(f"warp gather bf16, C = {c} ({function.split('I', 1)[0]})",
                         warp_fwd_tiled_info(name), function, ops=("SHFL",),
                         prefixes=("LDG", "STG", "LDS", "STS"), required=("LDG", "STG"))


def compare_k1_cuda_cores(label, ref, frame, fwd, c, new, twin, summary) -> None:
    """K1's old CUDA-core kernel (b2f_cost_volume_fwd_cuda_cores) beside
    its tensor-core kernel on the same bf16 inputs: the old one against
    the twin, and both timed in one profiler window (one call of each, in
    turn, 20 times), told apart by kernel name."""
    from back2future_tpu_torch import ops

    def old():
        return ops.cost_volume_cuda_cores(ref, frame, WIN, 1, fwd, scale=1.0 / c)

    got, want = old(), twin()
    err = (got.float() - want.float()).abs().max().item()
    tol = KERNEL_TOL[torch.bfloat16]
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{label}, CUDA cores: outside tolerance ({err})")
    times = device_ms(lambda: (new(), old()), 20)
    new_ms = sum(v for n, v in times.items() if "mma" in n)
    old_ms = sum(v for n, v in times.items() if "mma" not in n)
    if not new_ms or not old_ms:
        raise AssertionError(f"{label}: the profiler did not see both kernels: {times}")
    log("kernels", f"{label}: K1 device time per call (profiler, in turns) tensor cores "
                   f"{new_ms:.4f} ms, CUDA cores {old_ms:.4f} ms ({old_ms / new_ms:.2f}x); "
                   f"CUDA cores max_abs_err {err:.3e}")
    summary["cost_volume"]["cuda_cores_ms"] += old_ms


def compare_cuda_cores(label, key, new, old, twin, summary, per_forward=1,
                       names=("mma", None), words=("tensor cores", "CUDA cores"),
                       field="cuda_cores_ms"):
    """K2's, K3's or K5's old CUDA-core kernel (`old`) beside its
    tensor-core kernel (`new`) on the same bf16 inputs (or another old
    design beside the new one, named by `words`): the old one against the
    twin within 1e-2 of the largest value, and both timed in one profiler
    window (one call of each, in turn, 20 times), told apart by kernel
    name: `names` = (a part of the new kernel's name, of the old one's, or
    None: every other device op, such as the wrappers' weight
    preparation). The old kernel's time goes `per_forward` times into the
    summary's `field`; returns (new ms, old ms) per call."""
    got, want = old(), twin()
    err = (got.float() - want.float()).abs().max().item()
    tol = KERNEL_TOL[torch.bfloat16]
    atol = tol * max(1.0, want.float().abs().max().item())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=atol):
        raise AssertionError(f"{label}, {words[1]}: outside tolerance ({err})")
    times = device_ms(lambda: (new(), old()), 20)
    new_ms = sum(v for n, v in times.items() if names[0] in n)
    old_ms = sum(v for n, v in times.items()
                 if (names[1] in n if names[1] else names[0] not in n))
    if not new_ms or not old_ms:
        raise AssertionError(f"{label}: the profiler did not see both kernels: {times}")
    log("kernels", f"{label}: device time per call (profiler, in turns) {words[0]} "
                   f"{new_ms:.4f} ms, {words[1]} {old_ms:.4f} ms ({old_ms / new_ms:.2f}x); "
                   f"{words[1]} max_abs_err {err:.3e}")
    summary[key][field] = summary[key].get(field, 0.0) + per_forward * old_ms
    return new_ms, old_ms


def smooth_flow(rng, shape, dtype, dev):
    """A model's kind of flow: a 2x bilinear upsample of a coarse random
    field (1 pixel std at half size), as a decoder level's flow is the 2x
    upsample of the coarser level's."""
    b, h, w = shape
    coarse = torch.from_numpy(rng.standard_normal((b, 2, h // 2, w // 2)).astype(
        np.float32)).to(dev)
    return F.interpolate(coarse, scale_factor=2, mode="bilinear", align_corners=False) \
        .permute(0, 2, 3, 1).contiguous().to(dtype)


def grid_of(flow):
    """The warp's pixel offsets as grid_sample's normalised grid
    (align_corners=True); with padding_mode="border" grid_sample clamps
    as the warp does."""
    b, h, w, _ = flow.shape
    fl = flow.float()
    gx = (fl[..., 0] + torch.arange(w, device=flow.device).view(1, 1, w)) * (2.0 / (w - 1)) - 1
    gy = (fl[..., 1] + torch.arange(h, device=flow.device).view(1, h, 1)) * (2.0 / (h - 1)) - 1
    return torch.stack([gx, gy], -1).to(flow.dtype)


def nchw(t):
    return t.permute(0, 3, 1, 2)


def phase_kernels(dev) -> dict:
    """Each kernel against its twin at every main-path shape; returns the
    per-kernel summary over the bf16 checks: max error, and the kernel,
    twin, library (profiler device times) and bound ms summed per serving
    forward (forward kernels), per hard train step (backward kernels) or
    per soft train step (K5, K6); for K1 also its CUDA-core kernel's
    device time (`cuda_cores_ms`)."""
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.models import ConvUnit

    rng = np.random.default_rng(0)

    def rand(shape, dtype, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(dev, dtype)

    summary = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                       bytes_ms=0.0, ops_ms=0.0)
               for k in ("cost_volume", "warp", "warp_train", "cost_volume_dref",
                         "cost_volume_dframe", "warp_dimages", "warp_dflow", "stem_unit_a",
                         "stem_unit_b")}
    for k in ("cost_volume", "cost_volume_dref", "cost_volume_dframe", "stem_unit_a"):
        summary[k]["cuda_cores_ms"] = 0.0

    def check(kernel, label, dtype, kern, twin, per_forward, work, library=None,
              of_largest=False, flows="random", kernel_part=None):
        """Compare, time, log; add bf16 results `per_forward` times to the
        summary. `work`: (operations, bytes) of one call, inputs read and
        outputs written once. `library`: one PyTorch call computing the
        same function, or None. `of_largest`: the absolute tolerance is
        taken relative to the largest value (gradients summed over many
        terms). bf16 checks are timed also by the profiler's device time
        per call (`device_ms`) of the kernel, twin and library, which the
        summary takes: single-launch event windows carry the wrapper's
        host time. `flows`: the warp's kind of input; other than "random"
        (smooth flows, or the serving forward's own inputs), its times go
        to the summary's `<flows>_*` entries (its error to `err`).
        `kernel_part`: a part of the kernel's name; the device time of
        the call's other ops (a wrapper's zero-fill and cast) is then
        summed apart as `wrapper_ms`."""
        tol = KERNEL_TOL[dtype]
        got, want = kern(), twin()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        atol = tol * max(1.0, want.float().abs().max().item()) if of_largest else tol
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=atol)
        ms, pms = cuda_ms(kern, 20), cuda_ms(twin, 5)
        lms = cuda_ms(library, 20) if library is not None else None
        ops_ms = work[0] / PEAK_OPS_PER_S[dtype] * 1e3
        bytes_ms = work[1] / HBM_BYTES_PER_S * 1e3
        lib = f" library {lms:.4f} ms" if lms is not None else ""
        log("kernels", f"{label}: max_abs_err {err:.3e} (tol rtol={tol:g} atol={atol:.3g}) "
                       f"kernel {ms:.4f} ms twin {pms:.4f} ms{lib} bound "
                       f"{max(ops_ms, bytes_ms):.4f} ms (bytes {bytes_ms:.4f}, "
                       f"operations {ops_ms:.4f})")
        if dtype == torch.bfloat16:
            mine = device_ms(kern, 20)
            ms, pms = sum(mine.values()), device_total_ms(twin, 5)
            lms = device_total_ms(library, 20) if library is not None else None
            lib = f" library {lms:.4f} ms" if lms is not None else ""
            log("kernels", f"{label}: device time per call (profiler) kernel {ms:.4f} ms "
                           f"(" + ", ".join(f"{n[:48]} {v:.4f}" for n, v in sorted(
                               mine.items(), key=lambda kv: -kv[1])) + f"), twin {pms:.4f} ms{lib}")
        if not ok:
            raise AssertionError(f"{label}: outside tolerance ({err})")
        if dtype == torch.bfloat16:
            s = summary[kernel]
            s["err"] = max(s["err"], err)
            prefix = "" if flows == "random" else flows + "_"
            if kernel_part is not None:
                alone = sum(v for n, v in mine.items() if kernel_part in n)
                for k, v in (("kernel_ms", alone), ("wrapper_ms", ms - alone)):
                    s[prefix + k] = s.get(prefix + k, 0.0) + per_forward * v
            if prefix:
                for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                             ("bound_ms", max(ops_ms, bytes_ms))):
                    if v is not None:
                        s[prefix + k] = s.get(prefix + k, 0.0) + per_forward * v
                return
            s["ms"] += per_forward * ms
            s["plain_ms"] += per_forward * pms
            s["bound_ms"] += per_forward * max(ops_ms, bytes_ms)
            s["bytes_ms"] += per_forward * bytes_ms
            s["ops_ms"] += per_forward * ops_ms
            if lms is not None:
                s["library_ms"] = (s["library_ms"] or 0.0) + per_forward * lms

    def compare_old(key, label, new, old, twin, new_name, old_name, flows, per_unit=2):
        """A warp kernel's new design beside the first design's, alone, in
        turns (`compare_cuda_cores`), into the summary's `old_ms` and
        `new_turn_ms` (with `<flows>_` before them for flows other than
        "random"); `per_unit` launches a step or a serving forward."""
        prefix = "" if flows == "random" else flows + "_"
        new_ms, _ = compare_cuda_cores(f"{label}, kernels alone", key, new, old, twin, summary,
                                       per_forward=per_unit, names=(new_name, old_name),
                                       words=("new", "the first design's"),
                                       field=prefix + "old_ms")
        summary[key][prefix + "new_turn_ms"] = \
            summary[key].get(prefix + "new_turn_ms", 0.0) + per_unit * new_ms

    def check_gather(key, where, dtype, img, flow, flows, per_unit=2):
        """The warp gather on one input against its twin (`check`, with
        F.grid_sample as the library call), and in bf16 beside the first
        design's kernel in turns; `per_unit` launches a serving forward or
        a train step."""
        grid = grid_of(flow)
        new = lambda: ops.warp_bilinear(img, flow)   # noqa: E731
        twin = lambda: ops.warp_bilinear_reference(img, flow)   # noqa: E731
        check(key, f"warp_bilinear {where}", dtype, new, twin, per_forward=per_unit,
              work=(8 * img.numel(), 2 * nbytes(img) + nbytes(flow)), flows=flows,
              library=lambda: F.grid_sample(nchw(img), grid, mode="bilinear",
                                            padding_mode="border", align_corners=True))
        if dtype == torch.bfloat16:
            compare_old(key, f"warp_bilinear {where}", new,
                        lambda: ops.warp_bilinear_fwd_thread(img, flow), twin,
                        "fwd_rows" if img.shape[-1] == 3 else "fwd_lanes",
                        "warp_bilinear_fwd_kernel", flows, per_unit)

    # the gather's inputs beyond the serving random flows: their own
    # generators, so that the other kernels' inputs stay as they were
    gather_rng = np.random.default_rng(3)

    def gather_rand(shape, dtype, scale=1.0):
        x = gather_rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(dev, dtype)

    smooth_rng = np.random.default_rng(1)

    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for (h, w, c) in LEVEL_SHAPES:
            ref, frame = rand((B, h, w, c), dtype), rand((B, h, w, c), dtype)
            work = (2 * B * h * w * c * WIN * WIN,
                    nbytes(ref, frame) + B * h * w * WIN * WIN * ref.element_size())
            for fwd in (True, False):
                label = f"cost_volume {tag} B={B} {h}x{w}x{c} {'fwd' if fwd else 'past'}"
                new = lambda: ops.cost_volume(ref, frame, WIN, 1, fwd, scale=1.0 / c)   # noqa: E731
                twin = lambda: ops.cost_volume_reference(   # noqa: E731
                    ref, frame, WIN, 1, fwd, scale=1.0 / c)
                check("cost_volume", label, dtype, new, twin, per_forward=1, work=work)
                if dtype == torch.bfloat16:
                    compare_k1_cuda_cores(label, ref, frame, fwd, c, new, twin, summary)
        # feature warps run at levels 6..3, once per non-reference frame
        for (h, w, c) in LEVEL_SHAPES[:4]:
            img = rand((B, h, w, c), dtype)
            flow = rand((B, h, w, 2), dtype, scale=w / 4)   # reaches past the border
            if dtype == torch.float32:
                lib = F.grid_sample(nchw(img), grid_of(flow), mode="bilinear",
                                    padding_mode="border", align_corners=True)
                lib_err = (lib.permute(0, 2, 3, 1)
                           - ops.warp_bilinear_reference(img, flow)).abs().max().item()
                log("kernels", f"grid_sample(border, align_corners) vs the warp twin, f32 "
                               f"{h}x{w}x{c}: max_abs_err {lib_err:.3e}")
            check_gather("warp", f"{tag} B={B} {h}x{w}x{c}", dtype, img, flow, "random")
            check_gather("warp", f"{tag} B={B} {h}x{w}x{c}, smooth flow", dtype, img,
                         smooth_flow(gather_rng, (B, h, w), dtype, dev), "smooth")
        # the gather at the train step's 18 warps: 8 feature warps (levels
        # 6..3) and 10 image warps (C = 3, the output sizes of levels 3..7)
        for (h, w, c) in TRAIN_LEVELS[:4] + IMAGE_WARP_SHAPES:
            img = gather_rand((TRAIN_B, h, w, c), dtype)
            flows = {"random": gather_rand((TRAIN_B, h, w, 2), dtype, scale=w / 4),
                     "smooth": smooth_flow(gather_rng, (TRAIN_B, h, w), dtype, dev)}
            for kind, flow in flows.items():
                check_gather("warp_train", f"{tag} B={TRAIN_B} {h}x{w}x{c}, {kind} flow", dtype,
                             img, flow, kind)

        # backward kernels at the train step's shapes: one future and one
        # past volume per level, 8 feature warps (levels 6..3) and 10 image
        # warps (levels 3..7) per step
        for (h, w, c) in TRAIN_LEVELS:
            ref, frame = rand((TRAIN_B, h, w, c), dtype), rand((TRAIN_B, h, w, c), dtype)
            g = rand((TRAIN_B, h, w, WIN * WIN), dtype)
            work = (2 * TRAIN_B * h * w * c * WIN * WIN, nbytes(g) + 2 * nbytes(ref))
            for fwd in (True, False):
                where = f"{tag} B={TRAIN_B} {h}x{w}x{c} {'fwd' if fwd else 'past'}"
                args = (WIN, 1, fwd, 1.0 / c)
                for i, name in enumerate(("d_ref", "d_frame")):
                    need = (i == 0, i == 1)
                    key = f"cost_volume_{name.replace('_', '')}"
                    op = getattr(torch.ops.b2f, key)
                    new = lambda: op(g, frame if i == 0 else ref, *args)   # noqa: E731
                    twin = lambda: ops.cost_volume_backward_reference(   # noqa: E731
                        g, ref, frame, *args)[i]
                    check(key, f"cost_volume {name} {where}", dtype, new, twin, per_forward=1,
                          work=work, of_largest=True)
                    if dtype == torch.bfloat16:
                        compare_cuda_cores(
                            f"cost_volume {name} {where}", key, new,
                            lambda: ops.cost_volume_backward_cuda_cores(
                                g, ref, frame, *args, need=need)[i], twin, summary)
        warps = [(shape, True) for shape in TRAIN_LEVELS[:4]] + \
            [(shape, False) for shape in IMAGE_WARP_SHAPES]
        for (h, w, c), feature in warps:
            img, g = rand((TRAIN_B, h, w, c), dtype), rand((TRAIN_B, h, w, c), dtype)
            flows = {"random": rand((TRAIN_B, h, w, 2), dtype, scale=w / 4),   # past the border
                     "smooth": smooth_flow(smooth_rng, (TRAIN_B, h, w), dtype, dev)}
            for kind, flow in flows.items():
                grid = grid_of(flow)

                def library(mask, flow=flow, grid=grid):
                    return lambda: torch.ops.aten.grid_sampler_2d_backward(
                        nchw(g), nchw(img), grid, 0, 1, True, mask)

                where = f"{tag} B={TRAIN_B} {h}x{w}x{c}, {kind} flow"
                new = lambda: torch.ops.b2f.warp_dflow(img, flow, g, True)   # noqa: E731
                twin = lambda: ops.warp_bilinear_backward_reference(img, flow, g)[1]   # noqa: E731
                check("warp_dflow", f"warp_bilinear d_flow {where}", dtype, new, twin,
                      per_forward=2, work=(8 * img.numel(), 2 * nbytes(img) + 2 * nbytes(flow)),
                      library=library([False, True]), of_largest=True, flows=kind)
                if dtype == torch.bfloat16:
                    compare_old("warp_dflow", f"warp_bilinear d_flow {where}", new,
                                lambda: ops.warp_bilinear_backward_thread(
                                    img, flow, g, need=(False, True))[1], twin,
                                "dflow_rows" if c == 3 else "dflow_lanes", "dflow_kernel",
                                kind)
                if not feature:   # the image warps' inputs need no gradient
                    continue
                new = lambda: torch.ops.b2f.warp_dimages(flow, g)   # noqa: E731
                twin = lambda: ops.warp_bilinear_backward_reference(img, flow, g)[0]   # noqa: E731
                check("warp_dimages", f"warp_bilinear d_images {where}", dtype, new, twin,
                      per_forward=2, work=(8 * img.numel(), 2 * nbytes(img) + nbytes(flow)),
                      library=library([True, False]), of_largest=True, flows=kind,
                      kernel_part="dimages_tiled")
                if dtype == torch.bfloat16:
                    compare_old("warp_dimages", f"warp_bilinear d_images {where}", new,
                                lambda: ops.warp_bilinear_backward_thread(
                                    img, flow, g, need=(True, False))[0], twin,
                                "dimages_tiled", "dimages_kernel", kind)

        # the fused stem: K5 then K6 on the frame-stacked batch; the twin is
        # the unfused cuDNN conv chain, which is also the library call
        gen = torch.Generator().manual_seed(1)
        units = {"a": ops.unit_params(ConvUnit(3, 16, generator=gen).to(dev)),
                 "b": ops.unit_params(ConvUnit(16, 32, generator=gen).to(dev))}
        for where, (n, h, w) in STEM_SHAPES.items():
            x = rand((n, h, w, 3), dtype)
            with torch.no_grad():
                f2 = ops.unit_reference(x, units["a"])
                for unit, inp in (("a", x), ("b", f2)):
                    p, c_in, c_out = units[unit], inp.shape[-1], units[unit][1].numel()
                    out_px = n * ((inp.shape[1] + 1) // 2) * ((inp.shape[2] + 1) // 2)
                    twin = lambda inp=inp, p=p: ops.unit_reference(inp, p)   # noqa: E731
                    label = f"stem unit {unit} {tag} {where} {'x'.join(map(str, inp.shape))}"
                    new = lambda inp=inp, p=p, unit=unit: ops.stem_unit_cuda(inp, p, unit)   # noqa: E731
                    check(f"stem_unit_{unit}", label, dtype, new, twin,
                          per_forward=int(where == "train"),
                          work=(2 * out_px * c_out * 9 * (c_in + c_out),
                                nbytes(inp, *p) + out_px * c_out * inp.element_size()),
                          library=twin, of_largest=True)
                    if unit == "a" and dtype == torch.bfloat16:
                        compare_cuda_cores(
                            label, "stem_unit_a", new,
                            lambda inp=inp, p=p: ops.stem_unit_a_cuda_cores(inp, p), twin,
                            summary, per_forward=int(where == "train"),
                            names=("stem_unit_a_mma", "stem_unit_kernel"))

    # the serving forward's own 8 warp inputs (bf16)
    for img, flow, _ in serving_warp_inputs(dev):
        b, h, w, c = img.shape
        check_gather("warp", f"bf16 B={b} {h}x{w}x{c}, the serving forward's own input",
                     torch.bfloat16, img, flow, "own", per_unit=1)
    for key, unit, kinds in (
            ("warp", f"serving forward (B={B}, 8 launches)", ("random", "smooth", "own")),
            ("warp_train", f"train step (B={TRAIN_B}, {TRAIN_H}x{TRAIN_W}, 18 launches)",
             ("random", "smooth"))):
        s = summary[key]
        log("kernels", f"warp gather per {unit}, bf16, profiler device time: " + "; ".join(
            f"{kind} {'inputs' if kind == 'own' else 'flows'}: kernel {s[p + 'ms']:.4f} ms "
            f"(in turns {s[p + 'new_turn_ms']:.4f} vs the first design's "
            f"{s[p + 'old_ms']:.4f}), twin {s[p + 'plain_ms']:.4f}, grid_sample "
            f"{s[p + 'library_ms']:.4f}, bound {s[p + 'bound_ms']:.4f}"
            for kind in kinds for p in ("" if kind == "random" else kind + "_",)))
    log("kernels", "per serving forward (bf16, B=16, profiler device time): cost volume kernel "
                   f"{summary['cost_volume']['ms']:.3f} ms (its CUDA-core kernel "
                   f"{summary['cost_volume']['cuda_cores_ms']:.3f} ms) vs twin "
                   f"{summary['cost_volume']['plain_ms']:.3f} ms; warp kernel "
                   f"{summary['warp']['ms']:.3f} ms vs twin {summary['warp']['plain_ms']:.3f} ms")
    log("kernels", f"per train step (bf16, B={TRAIN_B}, {TRAIN_H}x{TRAIN_W}, profiler device "
                   f"time): " + "; ".join(
        f"{k} kernel {summary[k]['ms']:.3f} ms vs twin {summary[k]['plain_ms']:.3f} ms"
        for k in ("cost_volume_dref", "cost_volume_dframe", "warp_dimages", "warp_dflow",
                  "stem_unit_a", "stem_unit_b")))
    log("kernels", "per hard train step (bf16, profiler device time, timed in turns with the "
                   "CUDA-core kernels): " + "; ".join(
        f"{k} tensor cores {summary[k]['ms']:.3f} ms (the CUDA-core kernel "
        f"{summary[k]['cuda_cores_ms']:.3f} ms in the turns), bound "
        f"{summary[k]['bound_ms']:.4f} ms" for k in ("cost_volume_dref", "cost_volume_dframe")))
    for k in ("warp_dimages", "warp_dflow"):
        s = summary[k]
        log("kernels", f"per hard train step (bf16, profiler device time), {k}: " + "; ".join(
            f"{kind} flows {s[p + 'ms']:.4f} ms" + "".join(
                f", {name} {s[p + key]:.4f}" for key, name in (
                    ("kernel_ms", "the kernel alone"), ("wrapper_ms", "zero-fill and cast"),
                    ("new_turn_ms", "the kernel in turns"),
                    ("old_ms", "the first design's kernel in turns")) if p + key in s)
            for kind, p in (("random", ""), ("smooth", "smooth_")))
            + f"; bound {s['bound_ms']:.4f} ms, library {s['library_ms']:.4f} ms (random flows)")
    s = summary["stem_unit_a"]
    log("kernels", f"per soft step (bf16, profiler device time): stem_unit_a tensor cores "
                   f"{s['ms']:.3f} ms with the wrapper's weight preparation (the CUDA-core "
                   f"kernel alone {s['cuda_cores_ms']:.3f} ms in the turns), bound "
                   f"{s['bound_ms']:.4f} ms")
    return summary



@contextlib.contextmanager
def recording_gather_inputs(into: list):
    """Inside the block, each warp gather first appends its (images, flow,
    whether the images need a gradient) to `into` (detached copies, the
    flow in the image dtype, as the kernels get them); restored after."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.warp")
    op = module._WARP

    def recording(images, flow, reference_grads, y0=0):
        into.append((images.detach().clone(), flow.detach().clone(), images.requires_grad))
        return op(images, flow, reference_grads, y0)

    module._WARP = recording
    try:
        yield
    finally:
        module._WARP = op


def serving_warp_inputs(dev) -> list:
    """The 8 (images, flow, needs grad) of the gather in one serving forward of the
    seeded estimator (as phase 4's, stem off) on a seeded B=16 input."""
    from back2future_tpu_torch.api import init

    est = init(None, device="cuda", seed=0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, H, W, 9), dtype=np.float32)).to(dev)
    recorded = []
    with stem(False), torch.no_grad(), recording_gather_inputs(recorded):
        est.net(x, with_warped=False)
    if len(recorded) != SERVING_PER_FORWARD["b2f_warp_bilinear_fwd"]:
        raise AssertionError(f"recorded {len(recorded)} gathers of one serving forward")
    return recorded


def phase_main_path(card: str) -> dict:
    """The serving path with the stem off; returns its launch counts, the
    estimator, the B=16 batch and the results on it."""
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.api import init
    from back2future_tpu_torch.runtime import reset_launches

    est = init(None, device="cuda", seed=0)
    cfg = est.config
    assert (cfg.frames, cfg.levels, cfg.win, cfg.skip, cfg.siamese, cfg.dtype) == \
        (3, 7, 9, 2, 1, torch.bfloat16), cfg
    rng = np.random.default_rng(0)

    def images(n):
        return rng.random((n, H_IN, W_IN, 3), dtype=np.float32)

    per_forward = SERVING_PER_FORWARD
    triplet = [im[0] for im in (images(1), images(1), images(1))]
    batch = [images(B) for _ in range(3)]
    video = images(5)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    flow, fo, bo = est(*triplet)
    check_results((flow[None], fo[None], bo[None]), 1)
    if counts() != per_forward:
        raise AssertionError(f"one serving forward launched {counts()}, expected {per_forward}")
    log("main", f"compute_flow 1x{H_IN}x{W_IN}: flow {flow.shape}, launches {counts()}")

    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = est.compute_flow_batch(*batch)
        walls.append(time.perf_counter() - t0)
        check_results(res, B)
        log("main", f"compute_flow_batch B={B} call {i + 1}: {walls[-1] * 1e3:.1f} ms "
                    f"wall, {B / walls[-1]:.2f} triplets/s")
    video_res = est.compute_flow_video(video)
    check_results(video_res, 3)
    launches = counts()
    expect = {k: 5 * v for k, v in per_forward.items()}   # 1 + 3 + 1 forwards
    if launches != expect:
        raise AssertionError(f"main path launched {launches}, expected {expect}")
    log("main", f"compute_flow_video 5 frames: flow {video_res[0].shape}; launches "
                f"over 5 serving forwards {launches}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rate = B / statistics.median(walls[1:])
    log("main", f"compute_flow_batch B={B} {H_IN}x{W_IN} -> {H}x{W}: {rate:.2f} "
                f"triplets/s wall clock (median of calls 2-3, host pre/post-processing "
                f"included) on {card}")

    # the same batch through the plain twins: flow and occlusion masks
    before = counts()
    with ops.plain_ops():
        want = est.compute_flow_batch(*batch)
    if counts() != before:
        raise AssertionError(f"plain_ops() launched kernels: {before} -> {counts()}")
    compare_results("main", "kernels vs plain_ops()", res, want)

    # the device side alone: one serving forward on a normalised-sized input
    x = torch.from_numpy(rng.standard_normal((B, H, W, 9), dtype=np.float32)).cuda()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: est.net(x, with_warped=False), 5)
    log("main", f"serving forward on the device, B={B} {H}x{W} bf16: {fwd_ms:.2f} ms "
                f"(CUDA events, median of 5) on {card}")
    phase_host_paths(card, est, batch)
    return dict(launches=launches, est=est, batch=batch, results=res, x=x)


def wall_ms(fn, reps: int) -> float:
    """Median host-clock ms of `reps` calls of `fn`, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serving_split(est, batch, calls: int = 3) -> dict:
    """compute_flow_batch's parts on `batch`, host clock, medians of calls
    2..`calls`: pre-processing (its stack and concatenation, colour
    normalisation and resize apart), the copy to the card, the forward
    (ending in a synchronize), the copy back, post-processing."""
    from back2future_tpu_torch.api import _numpy, _postprocess_results
    from back2future_tpu_torch.data.augment import color_normalize
    from back2future_tpu_torch.data.resample import resize

    keys = ("stack", "normalize", "resize", "pre", "h2d", "forward", "d2h", "post", "total")
    parts = {k: [] for k in keys}
    for _ in range(calls):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        imgs = np.concatenate([np.asarray(s, np.float32) for s in batch], axis=-1)
        t.append(time.perf_counter())
        imgs = color_normalize(imgs)
        t.append(time.perf_counter())
        imgs = np.stack([resize(im, H, W, "bilinear") for im in imgs])
        t.append(time.perf_counter())
        x = torch.from_numpy(imgs).to(est.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with torch.inference_mode():
            g = est.net(x, with_warped=False)[0]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        flow, occ = _numpy(g["flow"]), _numpy(g["occ"])
        t.append(time.perf_counter())
        _postprocess_results(flow, occ, B, H_IN, W_IN)
        t.append(time.perf_counter())
        ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        for k, v in zip(("stack", "normalize", "resize", "h2d", "forward", "d2h", "post"), ms):
            parts[k].append(v)
        parts["pre"].append(sum(ms[:3]))
        parts["total"].append(sum(ms))
    return {k: statistics.median(v[1:]) for k, v in parts.items()}, flow


@contextlib.contextmanager
def omp_threads(n: int):
    """OMP_NUM_THREADS, which host_threads() reads, set to `n` inside the
    block and restored after."""
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield
    finally:
        if before is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = before


def at_threads(n: int, fn):
    """fn() with the host helpers' row loops at `n` threads."""
    with omp_threads(n):
        return fn()


def phase_host_paths(card: str, est, batch: list) -> None:
    """Phase 4's host checks: the split of compute_flow_batch on the C++
    path and on the NumPy twins (`numpy_twins()`), then each C++ function
    of runtime/src/resample.cc and getocc.cc on the B=16 batch's own
    frames against its twin (HOST_TOL; nearest, rotation and occlusion
    exact), the row-threaded ones at 1 thread and at `host_threads()`
    with the same bits. Any mismatch raises."""
    from back2future_tpu_torch.data import augment, resample
    from back2future_tpu_torch.io import occ as occ_mod
    from back2future_tpu_torch.runtime.host_build import host_threads

    threads = host_threads()
    split, flow = serving_split(est, batch)
    with resample.numpy_twins():
        twin_split, _ = serving_split(est, batch)
    for label, s in (("C++", split), ("NumPy twins", twin_split)):
        log("host", f"compute_flow_batch B={B} split, {label}: total {s['total']:.2f} ms = pre "
                    f"{s['pre']:.2f} (stack and concatenate {s['stack']:.2f}, color_normalize "
                    f"{s['normalize']:.2f}, resize {s['resize']:.2f}) + copy in "
                    f"{s['h2d']:.2f} + forward {s['forward']:.2f} + copy out {s['d2h']:.2f} + "
                    f"post {s['post']:.2f}; {B / s['total'] * 1e3:.2f} triplets/s (host clock, "
                    f"median of calls 2-3) on {card}")

    frames = [np.asarray(s[0], np.float32) for s in batch]
    raw = np.concatenate(frames, axis=-1)                  # one triplet, 375x1242x9
    stack = augment.color_normalize(raw)
    occ_map = (stack[..., :1] > 0).astype(np.float32)
    sc_h, sc_w = int(round(H_IN * 1.5)), int(round(W_IN * 1.5))   # a scale-1.5 crop window
    oy, ox = sc_h // 4, sc_w // 4
    cases = {   # name -> (the call, exact against the twin)
        "resize_bilinear_f32": (lambda: resample.resize(stack, H, W, "bilinear"), False),
        "resize_nearest_f32": (lambda: resample.resize(flow[0], H_IN, W_IN, "simple"), True),
        "rotate_nearest_window_f32": (lambda: resample.rotate_nearest_window(
            frames[0], 0.15, -4, 7, H_IN, W_IN, True, False), True),
        "resize_bilinear_window_f32": (lambda: resample.resize_bilinear_window(
            stack, H_IN, W_IN, sc_h, sc_w, oy, ox, TRAIN_H, TRAIN_W), False),
        "resize_nearest_window_f32": (lambda: resample.resize_nearest_window(
            occ_map, sc_h, sc_w, oy, ox, TRAIN_H, TRAIN_W, True, True), True),
        "photo_pipeline_f32": (lambda: augment.preprocess(raw, np.random.default_rng(0)),
                               False),
    }
    threaded = ("resize_bilinear_f32", "resize_nearest_f32")
    for name, (call, exact) in cases.items():
        with omp_threads(1):
            got = call()
            one_ms = wall_ms(call, 5)
        with resample.numpy_twins():
            want = call()
            twin_ms = wall_ms(call, 3)
        err = float(np.abs(got.astype(np.float64) - want).max())
        tol = 0.0 if exact else HOST_TOL
        if name in threaded:
            same = all(at_threads(t, call).tobytes() == got.tobytes()
                       for t in (2, 3, 7, threads))
            many_ms = at_threads(threads, lambda: wall_ms(call, 5))
            times = (f"C++ {one_ms:.3f} ms at 1 thread, {many_ms:.3f} ms at {threads} (bits "
                     f"equal at 1, 2, 3, 7 and {threads} threads: {same})")
        else:
            same, times = True, f"C++ {one_ms:.3f} ms (serial)"
        log("host", f"{name} {tuple(got.shape)}: {times}; twin {twin_ms:.3f} ms; max_abs_err "
                    f"{err:.3e} (tol {tol}) on {card}")
        if err > tol or not same or got.dtype != want.dtype:
            raise AssertionError(f"host: {name} disagrees with its twin or across threads")
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    augment.preprocess(raw, r1)
    with resample.numpy_twins():
        augment.preprocess(raw, r2)
    if r1.bit_generator.state != r2.bit_generator.state:
        raise AssertionError("host: preprocess left the generator in another state than its twin")

    # get_occ: the median filter's threads, and the Python oracle on a crop
    depth = 1.0 + stack[..., 0].astype(np.float64)
    gflow = resample.resize(flow[0], H_IN, W_IN, "simple").astype(np.float64) * 4
    def occ_call():
        return occ_mod.get_occ(depth, gflow)

    one = at_threads(1, occ_call)
    same = all(np.array_equal(at_threads(t, occ_call), one) for t in (2, 3, 7, threads))
    one_ms = at_threads(1, lambda: wall_ms(occ_call, 5))
    many_ms = at_threads(threads, lambda: wall_ms(occ_call, 5))
    crop = np.s_[H_IN // 4:H_IN // 4 + 48, W_IN // 4:W_IN // 4 + 96]
    t0 = time.perf_counter()
    oracle = occ_mod.get_occ_reference(depth[crop], gflow[crop])
    oracle_ms = (time.perf_counter() - t0) * 1e3
    exact = np.array_equal(occ_mod.get_occ(depth[crop], gflow[crop]), oracle)
    log("host", f"get_occ_f64 ({H_IN}, {W_IN}): C++ {one_ms:.3f} ms at 1 thread, {many_ms:.3f} "
                f"ms at {threads}; bits equal at 1, 2, 3, 7 and {threads} threads: {same}; a "
                f"48x96 crop equal to the Python oracle ({oracle_ms:.1f} ms): {exact} on {card}")
    if not (same and exact):
        raise AssertionError("host: get_occ disagrees across threads or with its oracle")


def check_results(results, n):
    flow, fwd_occ, bwd_occ = results
    assert flow.shape == (n, H_IN, W_IN, 2) and flow.dtype == np.float32, flow.shape
    assert np.isfinite(flow).all()
    for occ in (fwd_occ, bwd_occ):
        assert occ.shape == (n, H_IN, W_IN) and occ.dtype == bool, occ.shape


def compare_results(phase, label, got, want):
    """Flow within FLOW_TOL_FRAC of max|flow|, occlusion masks flipping on
    at most OCC_TOL of the pixels."""
    scale = float(np.abs(want[0]).max())
    flow_err = float(np.abs(got[0] - want[0]).max())
    occ_diff = max(float(np.mean(got[k] != want[k])) for k in (1, 2))
    log(phase, f"{label} on the B={B} batch: flow max_abs_err {flow_err:.3e} (tol "
               f"{FLOW_TOL_FRAC} x max|flow| = {FLOW_TOL_FRAC * scale:.3e}); occlusion "
               f"masks differ on {occ_diff:.2e} of pixels (tol {OCC_TOL})")
    if not (flow_err <= FLOW_TOL_FRAC * scale and occ_diff <= OCC_TOL):
        raise AssertionError(f"{phase}: {label} disagree")


def phase_serving_stem(card: str, main: dict) -> dict:
    """The serving path with B2F_STEM_PALLAS=1: the same estimator and
    batch as the stem-off phase; launch counts, agreement with the
    stem-off results, and the device forward stem off / on / on / off,
    twice."""
    from back2future_tpu_torch.runtime import reset_launches

    est, x = main["est"], main["x"]
    with stem(True):
        reset_launches()
        res = est.compute_flow_batch(*main["batch"])
        launches = counts()
    check_results(res, B)
    if launches != SERVING_STEM_PER_FORWARD:
        raise AssertionError(f"serving forward with the stem launched {launches}, "
                             f"expected {SERVING_STEM_PER_FORWARD}")
    log("stem", f"compute_flow_batch B={B} with B2F_STEM_PALLAS=1: launches {launches}")
    compare_results("stem", "stem on vs stem off", res, main["results"])
    turns = (False, True, True, False) * 2
    times = []
    with torch.inference_mode():
        for on in turns:
            with stem(on):
                times.append(cuda_ms(lambda: est.net(x, with_warped=False), 5))
    off, on = (statistics.median(t for t, o in zip(times, turns) if o == side)
               for side in (False, True))
    log("stem", f"serving forward on the device, B={B} {H}x{W} bf16, stem "
                + " / ".join("on" if o else "off" for o in turns) + ": "
                + " / ".join(f"{t:.2f}" for t in times) + f" ms (CUDA events, medians of 5); "
                f"median off {off:.2f} ms, on {on:.2f} ms on {card}")
    return launches


@contextlib.contextmanager
def k1_cuda_cores():
    """Inside the block, ops.cost_volume's forward runs the CUDA-core
    kernel (b2f_cost_volume_fwd_cuda_cores), the bf16 design before the
    tensor cores; restored after. For the in-model A/B only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.cost_volume")
    kernel = module._FWD
    module._FWD = module._FWD_CUDA_CORES
    try:
        yield
    finally:
        module._FWD = kernel


def unwindowed(kernel, at: int):
    """A first design's warp `kernel` called as the path's is, with the
    row window's (H_src, y0) at argument `at`, which it does not take:
    the whole image's window only (y0 = 0)."""
    def call(*args):
        if args[at + 1] != 0:
            raise ValueError("the first design's warp kernels take the whole image only")
        kernel(*args[:at], *args[at + 2:])
    return call


@contextlib.contextmanager
def gather_thread():
    """Inside the block, the warp's forward runs the first design's gather
    (b2f_warp_bilinear_fwd_thread); restored after. For the A/B only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.warp")
    kernel = module._FWD
    module._FWD = unwindowed(module._FWD_THREAD, 8)
    try:
        yield
    finally:
        module._FWD = kernel


# the serving A/Bs: (log tag, the old kernel swapped in, what is compared,
# the old and the new kernel's words)
SERVING_AB = (("k1", k1_cuda_cores, "CUDA-core vs tensor-core cost volume",
               ("old (CUDA cores)", "new (tensor cores)")),
              ("gather", gather_thread, "the first design's vs the new warp gather",
               ("old (first design)", "new (csrc/warp_fwd_tiled.cu)")))


def phase_serving_ab(card: str, main: dict, tag: str, swap, what: str, words) -> None:
    """An in-model A/B (SERVING_AB): the device forward at B=16 (stem off)
    with the old kernel swapped in and with the new one, old / new / new /
    old, twice; the old forward's flow against the new one's."""
    est, x = main["est"], main["x"]
    with torch.inference_mode(), stem(False):
        new_flow = est.net(x, with_warped=False)[0]["flow"].float()
        with swap():
            old_flow = est.net(x, with_warped=False)[0]["flow"].float()
        scale = new_flow.abs().max().item()
        err = (new_flow - old_flow).abs().max().item()
        log(tag, f"device forward B={B}, finest flow, {what}: max_abs_err {err:.3e} (tol "
                 f"{FLOW_TOL_FRAC} x max|flow| = {FLOW_TOL_FRAC * scale:.3e})")
        if err > FLOW_TOL_FRAC * scale:
            raise AssertionError(f"{tag} A/B: the two kernels give different flows")
        turns = (True, False, False, True) * 2   # True: the old kernel
        times = []
        for old in turns:
            with swap() if old else contextlib.nullcontext():
                times.append(cuda_ms(lambda: est.net(x, with_warped=False), 5))
    old_ms, new_ms = (statistics.median(t for t, o in zip(times, turns) if o == side)
                      for side in (True, False))
    log(tag, f"serving forward on the device, B={B} {H}x{W} bf16, stem off, {what}, "
             + " / ".join("old" if o else "new" for o in turns) + ": "
             + " / ".join(f"{t:.2f}" for t in times) + f" ms (CUDA events, medians of 5); "
             f"median {words[0]} {old_ms:.2f} ms, {words[1]} {new_ms:.2f} ms on {card}")


@contextlib.contextmanager
def bwd_cuda_cores():
    """Inside the block, the cost volume's backward ops run the CUDA-core
    kernels (b2f_cost_volume_d*_cuda_cores), the bf16 design
    before the tensor cores; restored after. For the A/B only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.cost_volume")
    kernels = module._DREF, module._DFRAME
    module._DREF, module._DFRAME = module._DREF_CUDA_CORES, module._DFRAME_CUDA_CORES
    try:
        yield
    finally:
        module._DREF, module._DFRAME = kernels


@contextlib.contextmanager
def warp_bwd_thread():
    """Inside the block, the warp's backward ops run the first design's
    kernels (b2f_warp_bilinear_*_thread); restored after. For the A/B
    only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.warp")
    kernels = module._DIMAGES, module._DFLOW
    module._DIMAGES = unwindowed(module._DIMAGES_THREAD, 8)
    module._DFLOW = unwindowed(module._DFLOW_THREAD, 9)
    try:
        yield
    finally:
        module._DIMAGES, module._DFLOW = kernels


# the hard-step A/Bs: (label, the old kernels swapped in, what they
# replace, a part of the device op names timed per step)
BWD_AB = (("K2/K3", bwd_cuda_cores, "CUDA-core vs tensor-core K2/K3", "cost_volume", "K1-K3"),
          ("warp", warp_bwd_thread, "the first design's vs the new K4 and W-dflow",
           "warp_bilinear", "warp"))


def phase_train_bwd_ab(card: str, dev) -> None:
    """The backward A/Bs in the hard bf16 train step (BWD_AB: K2/K3 on the
    CUDA cores, the warp gradients' first design): for each, one step with
    the old kernels and one with the new from the same initial state,
    every parameter gradient compared; then the step in turns old / new /
    new / old, twice: per turn one warm-up step, the median of 3 steps by
    CUDA events, and the device ms per step of the kernels concerned over
    2 more (profiler)."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    opt = train_options("bfloat16", soft=False)
    crits = build_criterions(opt)
    batch = train_batch(dev)
    net = train_network(opt, dev)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    for tag, swap, what, part, kernels in BWD_AB:
        grads = {}
        for old in (True, False):
            net.load_state_dict(init)
            step = make_train_step(net, opt, crits)
            with swap() if old else contextlib.nullcontext():
                step(create_train_state(net, opt), batch)
            torch.cuda.synchronize()
            grads[old] = {n: p.grad.clone() for n, p in net.named_parameters()}
        ratios = {n: (grads[False][n] - g).float().abs().max().item()
                  / max(g.float().abs().max().item(), 1e-30) for n, g in grads[True].items()}
        worst = max(ratios, key=ratios.get)
        within = sum(v <= GRAD_TOL_FRAC for v in ratios.values())
        log("bwd", f"bf16 hard step, {what}: worst gradient max_abs_err / max|g| "
                   f"{ratios[worst]:.3e} ({worst}; tol {BF16_GRAD_TOL_FRAC}); {within} of "
                   f"{len(ratios)} parameters within {GRAD_TOL_FRAC}")
        if ratios[worst] > BF16_GRAD_TOL_FRAC:
            raise AssertionError(f"{tag} A/B: the two backward paths give different gradients")

        net.load_state_dict(init)
        step = make_train_step(net, opt, crits)
        state = create_train_state(net, opt)

        def one_step():
            nonlocal state
            state, _ = step(state, batch)

        turns = (True, False, False, True) * 2   # True: the old kernels
        step_ms, dev_ms = [], []
        for old in turns:
            with swap() if old else contextlib.nullcontext():
                one_step()
                times = []
                for _ in range(3):
                    start, end = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                    start.record()
                    one_step()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                by_name = device_ms(one_step, 2)
            step_ms.append(statistics.median(times))
            dev_ms.append(sum(v for n, v in by_name.items() if part in n))
        names = " / ".join("old" if o else "new" for o in turns)
        log("bwd", f"bf16 hard step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}, {tag} {names}: step "
                   + " / ".join(f"{t:.2f}" for t in step_ms) + " ms (CUDA events, medians of "
                   f"3); {kernels} device " + " / ".join(f"{t:.3f}" for t in dev_ms)
                   + f" ms per step (profiler) on {card}")
        for label, vals in (("step", step_ms), (f"{kernels} device", dev_ms)):
            old_v, new_v = (statistics.median(v for v, o in zip(vals, turns) if o == side)
                            for side in (True, False))
            log("bwd", f"{tag}: median {label} ms: old {old_v:.3f}, new {new_v:.3f}")


@contextlib.contextmanager
def recording_k4_inputs(into: list):
    """Inside the block, each call of the warp's image-gradient op
    (`b2f::warp_dimages`, K4) first appends a copy of its (flow, g) to
    `into`; restored after. For the route comparison only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.warp")
    op = module._DIMAGES_OP

    def recording(flow, g, h_src=-1, y0=0):
        into.append((flow.clone(), g.clone()))
        return op(flow, g, h_src, y0)

    module._DIMAGES_OP = recording
    try:
        yield
    finally:
        module._DIMAGES_OP = op


def k4_routes_ms(flow, g) -> dict:
    """K4 on one input with each of its route settings (K4_ROUTES[:3]: as the
    path allows them by the grid, direct on every block, the window
    wherever the box fits): per setting (window-route blocks, all blocks,
    ms). The three results agree within 1e-5 of the largest value (f32
    sums in another order); the times are profiler device times of the
    kernel alone per call, in turns (each setting once, then in reverse),
    medians."""
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.ops.warp import K4_ROUTES

    routes = K4_ROUTES[:3]
    res, got = {}, {}
    for route in routes:
        got[route], n_window, blocks = ops.warp_dimages_routes(flow, g, route)
        res[route] = (n_window, blocks, [])
    scale = max(got["direct"].abs().max().item(), 1e-30)
    for route in routes:
        if (got[route] - got["direct"]).abs().max().item() > 1e-5 * scale:
            raise AssertionError(f"K4's routes disagree: {route} against direct")
    for route in routes + routes[::-1]:
        t = device_ms(lambda: ops.warp_dimages_routes(flow, g, route), 20)
        res[route][2].append(sum(v for n, v in t.items() if "dimages_tiled" in n))
    return {r: (n, b, statistics.median(ms)) for r, (n, b, ms) in res.items()}


def phase_k4_routes(card: str, dev, trained=None) -> None:
    """K4's routes against each other on the same bf16 inputs: at the
    four feature-warp shapes of the train step (B=8, 320x640) on random
    flows (i.i.d., w/4) and smooth ones (a 2x upsample of a 1-pixel coarse
    field), and on the hard step's own K4 inputs (the 8 (flow, g) of its
    third step from the seeded net): per call and per step, the blocks
    that take the window route and the kernel's device ms as the path
    chooses (by the grid), with every block direct, and with the window
    wherever the box fits. With `trained` = (label, opt, net, batch),
    only the K4 inputs of that net's third step on that batch."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(2)

    def rand(shape, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(dev, torch.bfloat16)

    inputs = {"random": [], "smooth": []}   # (flow, g, launches a step)
    if trained is None:
        for (h, w, c) in TRAIN_LEVELS[:4]:
            g = rand((TRAIN_B, h, w, c))
            inputs["random"].append((rand((TRAIN_B, h, w, 2), w / 4), g, 2))
            inputs["smooth"].append((smooth_flow(rng, (TRAIN_B, h, w), torch.bfloat16, dev), g,
                                     2))
        label = "step"
        opt = train_options("bfloat16", soft=False)
        net, batch = train_network(opt, dev), train_batch(dev)
    else:
        inputs = {}
        label, opt, net, batch = trained
    step = make_train_step(net, opt, build_criterions(opt))
    state = create_train_state(net, opt)
    for _ in range(2):
        state, _ = step(state, batch)
    recorded = []
    with recording_k4_inputs(recorded):
        step(state, batch)
    if len(recorded) != TRAIN_PER_STEP["b2f_warp_bilinear_dimages"]:
        raise AssertionError(f"recorded {len(recorded)} K4 launches of one step")
    inputs[label] = [(flow, g, 1) for flow, g in recorded]

    def words(res):
        return "; ".join(f"{name}: {res[route][0]} of {res[route][1]} blocks windowed, "
                         f"{res[route][2]:.4f} ms" for route, name in (
                             ("grid", "the path's choice"), ("direct", "direct"),
                             ("window", "window wherever it fits")))

    for kind, cases in inputs.items():
        totals = {}
        for flow, g, launches in cases:
            res = k4_routes_ms(flow, g)
            mag = flow.float().abs()
            log("k4", f"{kind} flow {'x'.join(map(str, g.shape))} (|flow| mean "
                      f"{mag.mean().item():.3f}, max {mag.max().item():.3f}), K4 per call "
                      f"(profiler, in turns): {words(res)}")
            for route, vals in res.items():
                totals[route] = tuple(a + launches * b
                                      for a, b in zip(totals.get(route, (0, 0, 0.0)), vals))
        log("k4", f"{kind} flows, K4 per hard step ({sum(c[2] for c in cases)} launches): "
                  f"{words(totals)}; on {card}")


def train_options(dtype: str, soft: bool, **kw):
    """The options of the hard (or soft) train phases; `kw` overrides."""
    from back2future_tpu_torch.config import Options

    extra = (dict(pme_criterion="OBGCC", past_flow=True, const_vel=1.0,
                  smooth_second_order=True) if soft else {})
    extra.update(kw)
    return Options(**dict(dict(optimize="pme", compute_dtype=dtype, batchSize=TRAIN_B),
                          **extra)).derive()


def train_network(opt, dev):
    """The net of `opt` with weights from seed 0; a soft net gets them by
    surgery from the hard net of seed 0."""
    from back2future_tpu_torch.models import (
        PWCNet, convert_net_hard_to_soft, pwc_config_from_options,
    )

    if opt.netType == "spynet":
        return spynet_network(opt, dev)

    def seeded(o):
        return PWCNet(pwc_config_from_options(o), generator=torch.Generator().manual_seed(0))

    if not opt.past_flow:
        return seeded(opt).to(dev)
    hard = seeded(train_options(opt.compute_dtype, soft=False))
    return convert_net_hard_to_soft(hard, PWCNet(pwc_config_from_options(opt))).to(dev)


def train_batch(dev, ground_truth: bool = False) -> dict:
    """The seeded B=8 320x640 batch of the train phases, on the device;
    with `ground_truth`, also a seeded flow (in flownet units), a
    three-state occlusion (0 / 0.5 / 1, both channels) and a 0/1 mask."""
    rng = np.random.RandomState(0)
    images = rng.randn(TRAIN_B, TRAIN_H, TRAIN_W, 9).astype(np.float32)
    batch = {"images": images}
    if ground_truth:
        shape = (TRAIN_B, TRAIN_H, TRAIN_W)
        batch.update(flow_gt=(rng.randn(*shape, 2) * 0.2).astype(np.float32),
                     occ_gt=rng.choice(np.float32([0.0, 0.5, 1.0]), size=shape + (2,),
                                       p=[0.1, 0.8, 0.1]),
                     mask=(rng.rand(*shape) > 0.1).astype(np.float32))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


# device ops by kind, first match of the kernel name wins
OP_KINDS = (("stem (K5, K6)", ("stem_unit",)), ("cost volume (K1-K3)", ("cost_volume",)),
            ("warp", ("warp_bilinear",)), ("conv (cuDNN)", ("conv", "cudnn", "xmma", "gemm",
                                                            "sm90_", "implicit")),
            ("copy / memset", ("memcpy", "memset", "copy")))


def phase_profile(card: str, dev) -> None:
    """torch.profiler over 3 bf16 train steps, after 2 warm-up steps and
    5 unprofiled steps timed with CUDA events, for the hard recipe and
    the soft recipe with the stem off and on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    batch = train_batch(dev)
    for label, soft, on in (("hard", False, False), ("soft, stem off", True, False),
                            ("soft, stem on", True, True)):
        with stem(on):
            opt = train_options("bfloat16", soft)
            net = train_network(opt, dev)
            state = create_train_state(net, opt)
            step = make_train_step(net, opt, build_criterions(opt))
            for _ in range(2):
                state, _ = step(state, batch)
            times = []
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                state, _ = step(state, batch)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    state, _ = step(state, batch)
                torch.cuda.synchronize()
        # device events, without the user annotations (ranges such as
        # "Optimizer.step" mirrored onto the device timeline)
        ops = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        if not ops:   # device time attached to the CPU ops that launched it
            ops = [(k.name, k.duration) for e in prof.events() for k in e.kernels]
        if not ops:
            raise AssertionError("the profiler recorded no device time")
        busy = sum(us for _, us in ops) / 3e3
        by_kind = {}
        for name, us in ops:
            kind = next((k for k, keys in OP_KINDS if any(x in name.lower() for x in keys)),
                        "other (elementwise, reductions, optimiser)")
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 3e3
        step_ms = statistics.median(times)
        log("profile", f"{label}: bf16 step B={TRAIN_B} {TRAIN_H}x{TRAIN_W} {step_ms:.3f} ms "
                       f"(CUDA events, median of 5 unprofiled), device busy {busy:.3f} ms per "
                       f"step ({len(ops) // 3} device ops), idle share {1 - busy / step_ms:.3f}, "
                       f"on {card}")
        log("profile", f"{label}: device ms per step by kind: " + "; ".join(
            f"{k} {v:.3f}" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))
        top = {}
        for name, us in ops:
            top[name] = top.get(name, 0.0) + us / 3e3
        log("profile", f"{label}: top device ops (ms per step): " + "; ".join(
            f"{n[:60]} {v:.3f}" for n, v in sorted(top.items(), key=lambda kv: -kv[1])[:8]))
        del net, state, step, prof


# K6's phases, removed from a copy of its source: the sums of a removed
# conv 2 are 0 (the kernel still stages and stores); without device
# memory, the tiles' input copies and output stores go (the kernel still
# stages its weights and computes on whatever shared memory holds)
_ZERO_ACC = "    for (auto& a : acc) for (auto& b : a) for (float& v : b) v = 0.f;\n"
_STAGE = "stage_input(in_s, x + tile.n * in_image, 2 * tile.oy0 - 3, 2 * tile.ox0 - 3, H, W);\n"
K6_PHASES = {
    "whole kernel": [],
    "without conv 1": [("    conv1(smem, tile.oy0, tile.ox0, Ho, Wo);\n", "")],
    "without conv 2": [("    conv2(smem, acc);\n", _ZERO_ACC)],
    "without either conv": [("    conv1(smem, tile.oy0, tile.ox0, Ho, Wo);\n", ""),
                            ("    conv2(smem, acc);\n", _ZERO_ACC)],
    "without device memory": [
        ("      " + _STAGE, "      (void)tile;\n"), ("  " + _STAGE, ""),
        ("    store_output(smem + OFF_MID, out + here.n * out_image, here.oy0, here.ox0, Ho, Wo);\n",
         "")],
}


def build_variants(tag: str, source: str, variants: dict, entry: str, symbol: str,
                   argtypes: list) -> dict:
    """Each variant of csrc/`source` (a list of (text, replacement) edits)
    nvcc-built in parallel into its own library with the C entry point
    `entry` appended; returns the loaded libraries by variant name and
    logs each one's ptxas registers and spills."""
    import ctypes

    from back2future_tpu_torch.runtime import cuda_build

    src = (cuda_build.SRC_DIR / source).read_text()
    out_dir = cuda_build.BUILD_DIR / f"{tag}_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for a, b in edits:
            if a not in text:
                raise AssertionError(f"{tag} phases: {a.strip()!r} not in {source}")
            text = text.replace(a, b)
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text + entry)
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-I",
               str(cuda_build.SRC_DIR), str(cu), "-o", str(cu.with_suffix(".so"))]
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{tag} phases: nvcc failed for {name!r}:\n{report}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[name] = fn
        log(tag, f"{name}: ptxas " + "; ".join(
            line.strip() for line in report.splitlines() if "Used" in line or "spill" in line))
    return libs


def time_launches(fn, args, label: str, reps: int = 100) -> float:
    """ms per launch of the C entry point `fn`: CUDA events over `reps`
    back-to-back launches after 10 warm-up launches."""
    for _ in range(10):
        if fn(*args):
            raise RuntimeError(f"{label}: failed to launch")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_k6_phases(card: str, dev) -> None:
    """K6 bf16 with its convs removed (K6_PHASES), each variant built by
    nvcc from a copy of stem_unit_b_mma.cu with its own C entry point and
    timed by CUDA events over 100 back-to-back launches at the serving and
    train shapes, the variants in turn, two rounds."""
    import ctypes

    entry = ('\nextern "C" int k6_phase_launch(const void* x, const void* w1, const void* b1, '
             'const void* w2, const void* b2, void* out, int N, int H, int W, void* s) {\n'
             '  return b2f::stem_unit_b_mma(x, w1, b1, w2, b2, out, N, H, W, '
             'static_cast<cudaStream_t>(s));\n}\n')
    libs = build_variants("k6", "stem_unit_b_mma.cu", K6_PHASES, entry, "k6_phase_launch",
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rng = np.random.default_rng(0)

    def param(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1).to(
            dev).bfloat16().float()

    w1, b1, w2, b2 = param((3, 3, 16, 32)), param(32), param((3, 3, 32, 32)), param(32)
    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            for where, (n, h, w) in STEM_SHAPES.items():
                x = torch.from_numpy(rng.standard_normal((n, h // 2, w // 2, 16)).astype(
                    np.float32)).to(dev, torch.bfloat16)
                out = torch.empty((n, h // 4, w // 4, 32), dtype=torch.bfloat16, device=dev)
                args = [x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                        out.data_ptr(), n, h // 2, w // 2, torch.cuda.current_stream().cuda_stream]
                times.setdefault((name, where), []).append(
                    time_launches(lib, args, f"K6 phases: {name!r}"))
    for (name, where), t in times.items():
        log("k6", f"{name}, {where} {STEM_SHAPES[where][0]}x{STEM_SHAPES[where][1] // 2}x"
                  f"{STEM_SHAPES[where][2] // 2}x16: " + " / ".join(f"{v:.4f}" for v in t)
                  + f" ms per launch (two rounds; CUDA events over 100 launches) on {card}")
    # shared-memory bytes of one 8x32 output tile by the kernel's plan: 16-byte
    # ldmatrix.x4 rows of 512 bytes (conv 1: 22 m16 tiles x 9 taps of A, 8
    # warps x 9 taps x 2 of B; conv 2: 8 warps x 18 k16 steps x (2 A + 2 B)),
    # the input region's cp.async fill, the mid tile's and the output's writes
    # and the output's read
    ldsm = {"conv 1": (22 * 9 + 8 * 9 * 2) * 512, "conv 2": 8 * 18 * 4 * 512}
    other = 21 * 69 * 32 + 10 * 34 * 64 + 2 * 8 * 32 * 64
    for where, (n, h, w) in STEM_SHAPES.items():
        tiles = n * -(-(h // 4) // 8) * -(-(w // 4) // 32)
        log("k6", f"shared-memory traffic by the tile plan, {where}: {tiles} tiles x "
                  f"{sum(ldsm.values()) + other} bytes = "
                  f"{tiles * (sum(ldsm.values()) + other) / 1e9:.3f} GB per launch (ldmatrix "
                  + ", ".join(f"{k} {tiles * v / 1e9:.3f} GB" for k, v in ldsm.items())
                  + f"; staging and epilogues {tiles * other / 1e9:.3f} GB)")


# K5's phases, removed from a copy of its source, as K6's: without device
# memory, the octet loads and the output stores go (the kernel still
# repacks whatever its raw slots hold)
_K5_LOAD = ("load_octet(raw, x + tile.n * in_image, task, 2 * tile.oy0 - 3, 2 * tile.ox0 - 8, "
            "H, W, vec);\n")
K5_PHASES = {
    "whole kernel": [],
    "without conv 1": [("    conv1(smem, wt, here.oy0, here.ox0, Ho, Wo);\n", "")],
    "without conv 2": [("    conv2(smem, wt, acc);\n", _ZERO_ACC)],
    "without either conv": [("    conv1(smem, wt, here.oy0, here.ox0, Ho, Wo);\n", ""),
                            ("    conv2(smem, wt, acc);\n", _ZERO_ACC)],
    "without device memory": [
        ("      " + _K5_LOAD, ""), ("  " + _K5_LOAD, ""),
        ("    store_output(smem + OFF_OUT, out + here.n * out_image, here.oy0, here.ox0, Ho, Wo);\n",
         "")],
}


def phase_k5_phases(card: str, dev) -> None:
    """K5 bf16 with its convs or its device-memory traffic removed
    (K5_PHASES), each variant built by nvcc from a copy of
    stem_unit_a_mma.cu with its own C entry point and timed by CUDA events
    over 100 back-to-back launches at the serving and train shapes, the
    variants in turn, two rounds; beside each shape its byte bound and the
    shared-memory traffic of the tile plan."""
    import ctypes

    entry = ('\nextern "C" int k5_phase_launch(const void* x, const void* w1, const void* b1, '
             'const void* w2, const void* b2, void* out, int N, int H, int W, void* s) {\n'
             '  return b2f::stem_unit_a_mma(x, w1, b1, w2, b2, out, N, H, W, '
             'static_cast<cudaStream_t>(s));\n}\n')
    libs = build_variants("k5", "stem_unit_a_mma.cu", K5_PHASES, entry, "k5_phase_launch",
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rng = np.random.default_rng(0)

    def param(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1).to(
            dev).bfloat16().float()

    w1, b1, w2, b2 = param((3, 3, 3, 16)), param(16), param((3, 3, 16, 16)), param(16)
    inputs = {}
    for where, (n, h, w) in STEM_SHAPES.items():
        x = torch.from_numpy(rng.standard_normal((n, h, w, 3)).astype(np.float32)).to(
            dev, torch.bfloat16)
        out = torch.empty((n, h // 2, w // 2, 16), dtype=torch.bfloat16, device=dev)
        inputs[where] = (x, out)
    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            for where, (x, out) in inputs.items():
                n, h, w = STEM_SHAPES[where]
                args = [x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                        out.data_ptr(), n, h, w, torch.cuda.current_stream().cuda_stream]
                times.setdefault((name, where), []).append(
                    time_launches(lib, args, f"K5 phases: {name!r}"))
    # shared-memory bytes of one 8x32 output tile by the kernel's plan: 16-byte
    # ldmatrix.x4 rows of 512 bytes (conv 1: 22 m16 tiles x 3 ky; conv 2: 8
    # warps x 2 m16 tiles x 9 taps; no B operand is read from shared memory),
    # the input region's 8-byte pixel stores, the mid tile's and the output's
    # writes and the output's read
    ldsm = {"conv 1": 22 * 3 * 512, "conv 2": 8 * 2 * 9 * 512}
    other = 21 * 70 * 8 + 10 * 34 * 32 + 2 * 8 * 32 * 32
    for where, (x, out) in inputs.items():
        n, h, w = STEM_SHAPES[where]
        bound = nbytes(x, out) / HBM_BYTES_PER_S * 1e3
        log("k5", f"{where} {n}x{h}x{w}x3, byte bound {bound:.4f} ms: " + "; ".join(
            f"{name} " + " / ".join(f"{v:.4f}" for v in times[(name, where)]) for name in libs)
            + f" ms per launch (two rounds; CUDA events over 100 launches) on {card}")
        tiles = n * -(-(h // 2) // 8) * -(-(w // 2) // 32)
        log("k5", f"shared-memory traffic by the tile plan, {where}: {tiles} tiles x "
                  f"{sum(ldsm.values()) + other} bytes = "
                  f"{tiles * (sum(ldsm.values()) + other) / 1e9:.3f} GB per launch (ldmatrix "
                  + ", ".join(f"{k} {tiles * v / 1e9:.3f} GB" for k, v in ldsm.items())
                  + f"; staging and epilogues {tiles * other / 1e9:.3f} GB)")


# K1's phases, removed from a copy of cost_volume_fwd_mma.cu: without
# device memory the stages' copies and the tiles' stores go (the kernel
# still computes on whatever shared memory holds)
_K1_PRODUCTS = ("    products<WIN>(acc, cur, cur + REF_BYTES, ty, wg, step, "
                "min(CK / 16, (g.C - c0 + 15) / 16));\n")
_K1_SCATTER = ("    if (c0 + CK >= g.C) {\n", "    if (false) {\n")
_K1_STORE = "      store_tile<WIN>(smem, g, tile);\n"
_K1_STAGES = [("  stage<P::NT>(buf0, buf0 + REF_BYTES, g, tile, 0, chunks);\n", ""),
              ("    if (t_next < tiles) stage<P::NT>(nxt, nxt + REF_BYTES, g, next, s_next, "
               "chunks);\n", "")]
_K1_NO_MEMORY = _K1_STAGES + [(_K1_STORE, "")]
K1_PHASES = {
    "whole kernel": [],
    "without products": [(_K1_PRODUCTS, "")],
    "without the band scatter": [_K1_SCATTER],
    "without the output store": [(_K1_STORE, "")],
    "loads and stores only": [(_K1_PRODUCTS, ""), _K1_SCATTER],
    "without device memory": _K1_NO_MEMORY,
    "products only": _K1_NO_MEMORY + [_K1_SCATTER],
    "band scatter only": _K1_NO_MEMORY + [(_K1_PRODUCTS, "")],
    "loop and barriers only": _K1_NO_MEMORY + [(_K1_PRODUCTS, ""), _K1_SCATTER],
}


def phase_k1_phases(card: str, dev) -> None:
    """K1 bf16 (win 9, dil 1) with its phases removed (K1_PHASES), each
    variant built by nvcc from a copy of cost_volume_fwd_mma.cu with its
    own C entry point and timed by CUDA events over 100 back-to-back
    launches at the serving levels' shapes (fwd), the variants in turn,
    two rounds; beside each level its byte bound."""
    import ctypes

    entry = ('\nextern "C" int k1_phase_launch(const void* ref, const void* frame, void* out, '
             'int B, int H, int W, int C, int dil, int fwd, float scale, void* s) {\n'
             '  return b2f::cost_volume_fwd_mma(ref, frame, out, B, H, W, C, 9, dil, fwd, '
             'scale, static_cast<cudaStream_t>(s));\n}\n')
    libs = build_variants("k1", "cost_volume_fwd_mma.cu", K1_PHASES, entry, "k1_phase_launch",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                         ctypes.c_void_p])
    rng = np.random.default_rng(0)
    inputs = {}
    for (h, w, c) in LEVEL_SHAPES:
        ref, frame = (torch.from_numpy(rng.standard_normal((B, h, w, c)).astype(np.float32)).to(
            dev, torch.bfloat16) for _ in range(2))
        out = torch.empty((B, h, w, WIN * WIN), dtype=torch.bfloat16, device=dev)
        inputs[(h, w, c)] = (ref, frame, out)
    times = {}
    for _ in range(2):
        for name, fn in libs.items():
            for shape, (ref, frame, out) in inputs.items():
                args = [ref.data_ptr(), frame.data_ptr(), out.data_ptr(), B, *shape, 1, 1,
                        1.0 / shape[2], torch.cuda.current_stream().cuda_stream]
                times.setdefault((name, shape), []).append(
                    time_launches(fn, args, f"K1 phases: {name!r}"))
    for shape, (ref, frame, out) in inputs.items():
        bound = (nbytes(ref, frame, out)) / HBM_BYTES_PER_S * 1e3
        log("k1", f"B={B} {'x'.join(map(str, shape))} fwd, byte bound {bound:.4f} ms: " + "; ".join(
            f"{name} " + " / ".join(f"{v:.4f}" for v in times[(name, shape)])
            for name in libs) + f" ms per launch (two rounds; CUDA events over 100 launches) "
            f"on {card}")
    for name in libs:
        total = sum(statistics.median(times[(name, shape)]) for shape in inputs)
        log("k1", f"{name}: {2 * total:.4f} ms per serving forward (10 launches, fwd timings)")


# the warp gather's design against variants of it, each a copy of
# csrc/warp_fwd_tiled.cu with edits: the next pixel's flow loaded ahead of
# the current pixel's corners (both kernels); at C = 3, the output staged
# in shared memory and written as 16-byte chunks after a barrier, or the
# bf16 spans read as the aligned 32-bit words or 16-byte chunks that hold
# them (one instruction path, where load_span6's pair loads split a warp
# by the span's parity); one pass of a grid that covers every pixel
# instead of the persistent grid; and a second copy of the source as it
# is, last in the turns, for the spread between two copies of one kernel
_GATHER_LOOP = ("  for (Walk at(p0, H, W, npix <= UINT_MAX); at.p < npix; at.step(stride, H, W)) {\n"
                "    const float2 f = flow_at(flow, at.p, flow_pairs);\n")
_GATHER_ROWS_HEAD = ("  const size_t p0 = static_cast<size_t>(blockIdx.x) * NT_ROWS + threadIdx.x;\n"
                     + _GATHER_LOOP)
_GATHER_ROWS_TAIL = ("      out[3 * at.p + c] = from_f32<T>(blend(w, top[c], top[3 + c], bot[c], "
                     "bot[3 + c]));\n  }\n}\n")
_GATHER_ROWS_KERNEL = "// rows kernel, C = 3:"
_GATHER_PAIR_LOADER = """__device__ __forceinline__ void load_pair(const float* p, float (&v)[6]) {
  b2f::load_span6(p, v);
}

__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float (&v)[6]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
%s
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned pair = __funnelshift_r(u[k], u[k + 1], shift);
    __nv_bfloat162 h;
    memcpy(&h, &pair, 4);
    const float2 f = __bfloat1622float2(h);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

"""
_GATHER_WORDS = """  const unsigned* w = reinterpret_cast<const unsigned*>(a & ~static_cast<uintptr_t>(3));
  const unsigned shift = static_cast<unsigned>(a & 2) * 8;
  unsigned u[4] = {__ldg(w), __ldg(w + 1), __ldg(w + 2), 0u};
  if (shift) u[3] = __ldg(w + 3);"""
_GATHER_CHUNKS = """  const uint4* chunk = reinterpret_cast<const uint4*>(a & ~static_cast<uintptr_t>(15));
  const int s = static_cast<int>(a & 15);
  const uint4 lo = __ldg(chunk);
  uint4 hi = make_uint4(0u, 0u, 0u, 0u);
  if (s > 4) hi = __ldg(chunk + 1);
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int i = s >> 2;
  const unsigned shift = (s & 2) * 8;
  unsigned u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = i == 0 ? w[k] : i == 1 ? w[k + 1] : i == 2 ? w[k + 2] : w[k + 3];"""
GATHER_VARIANTS = {
    "as built": [],
    "flow prefetch": [(_GATHER_LOOP, """  float2 f_next = make_float2(0.f, 0.f);
  if (p0 < npix) f_next = flow_at(flow, p0, flow_pairs);
  for (Walk at(p0, H, W, npix <= UINT_MAX); at.p < npix; at.step(stride, H, W)) {
    const float2 f = f_next;
    if (at.p + stride.s < npix) f_next = flow_at(flow, at.p + stride.s, flow_pairs);
""")],
    "C = 3 staged stores": [(_GATHER_ROWS_HEAD, """  const size_t p0 = static_cast<size_t>(blockIdx.x) * NT_ROWS + threadIdx.x;
  constexpr int CHUNKS = NT_ROWS * 3 * sizeof(T) / 16;
  __shared__ uint4 staged_raw[CHUNKS];
  T* staged = reinterpret_cast<T*>(staged_raw);
  const size_t tiles = (npix + NT_ROWS - 1) / NT_ROWS;
  Walk at(p0, H, W, npix <= UINT_MAX);
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, at.step(stride, H, W)) {
   if (at.p < npix) {
    const float2 f = flow_at(flow, at.p, flow_pairs);
"""), (_GATHER_ROWS_TAIL, """      staged[3 * threadIdx.x + c] = from_f32<T>(blend(w, top[c], top[3 + c], bot[c], bot[3 + c]));
   }
    __syncthreads();
    const size_t q0 = tile * NT_ROWS;
    const int n = static_cast<int>(min(static_cast<size_t>(NT_ROWS), npix - q0));
    T* dst = out + 3 * q0;
    if (n == NT_ROWS && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      if (threadIdx.x < CHUNKS) reinterpret_cast<uint4*>(dst)[threadIdx.x] = staged_raw[threadIdx.x];
    } else {
      for (int i = threadIdx.x; i < 3 * n; i += NT_ROWS) dst[i] = staged[i];
    }
    __syncthreads();
  }
}
""")],
    "C = 3 32-bit word spans": [
        (_GATHER_ROWS_KERNEL, _GATHER_PAIR_LOADER % _GATHER_WORDS + _GATHER_ROWS_KERNEL),
        ("b2f::load_span6(row", "load_pair(row")],
    "C = 3 16-byte chunk spans": [
        (_GATHER_ROWS_KERNEL, _GATHER_PAIR_LOADER % _GATHER_CHUNKS + _GATHER_ROWS_KERNEL),
        ("b2f::load_span6(row", "load_pair(row")],
    "no persistent grid": [(
        "      std::min(needed, static_cast<size_t>(sms) * static_cast<size_t>(std::max(per_sm, 1))));",
        "      needed);")],
    "as built, a second copy": [],
}


def train_warp_inputs(dev) -> list:
    """The 18 (images, flow, needs grad) of the gather in the third bf16 hard train
    step of the seeded net (stem off)."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    opt = train_options("bfloat16", soft=False)
    net = train_network(opt, dev)
    step = make_train_step(net, opt, build_criterions(opt))
    state, batch = create_train_state(net, opt), train_batch(dev)
    with stem(False):
        for _ in range(2):
            state, _ = step(state, batch)
        recorded = []
        with recording_gather_inputs(recorded):
            step(state, batch)
    if len(recorded) != TRAIN_PER_STEP["b2f_warp_bilinear_fwd"]:
        raise AssertionError(f"recorded {len(recorded)} gathers of one train step")
    return recorded


def phase_gather_variants(card: str, dev) -> None:
    """The warp gather (bf16) as built against the variants of its design
    (GATHER_VARIANTS) on the same inputs: the serving forward's 8 shapes
    and the train step's 18 on random flows (i.i.d., w/4) and smooth ones
    (a 2x upsample of a 1-pixel coarse field), and the serving forward's
    and the hard train step's own inputs (seeded nets). Each variant's
    kernels carry its own name, so that one profiler window times them
    all, in turns (forward, reversed, forward; medians); each result is
    held against the twin. Per serving forward and per train step (the
    image warps, C = 3, apart)."""
    import ctypes

    from back2future_tpu_torch import ops
    from back2future_tpu_torch.ops.route import DTYPE_CODES, ptr, stream_ptr

    tags = {name: f"warp_bilinear_fwd_v{i}_" for i, name in enumerate(GATHER_VARIANTS)}
    libs = build_variants("gather", "warp_fwd_tiled.cu",
                          {name: edits + [("warp_bilinear_fwd_", tags[name])]
                           for name, edits in GATHER_VARIANTS.items()},
                          "", "b2f_warp_bilinear_fwd",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    names = list(libs)
    rng = np.random.default_rng(5)

    def rand(shape, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(dev, torch.bfloat16)

    def variant_ms(img, flow) -> dict:
        b, h, w, c = img.shape
        outs = {name: torch.empty_like(img) for name in names}

        def run(order):
            for name in order:
                if libs[name](ptr(img), ptr(flow), ptr(outs[name]), DTYPE_CODES[torch.bfloat16],
                              b, h, w, c, h, 0, stream_ptr(dev)):
                    raise RuntimeError(f"gather variant {name!r} failed to launch")

        run(names)
        want = ops.warp_bilinear_reference(img, flow).float()
        tol = KERNEL_TOL[torch.bfloat16]
        for name, got in outs.items():
            if not torch.allclose(got.float(), want, rtol=tol,
                                  atol=tol * max(1.0, want.abs().max().item())):
                raise AssertionError(f"gather variant {name!r} disagrees with the twin")
        times = {name: [] for name in names}
        for order in (names, names[::-1], names):
            t = device_ms(lambda: run(order), 10)
            for name in names:
                times[name].append(sum(v for n, v in t.items() if tags[name] in n))
        return {name: statistics.median(v) for name, v in times.items()}

    def words(ms: dict) -> str:
        return "; ".join(f"{name} {v:.4f}" for name, v in ms.items())

    units = (("serving forward", B, LEVEL_SHAPES[:4], serving_warp_inputs(dev)),
             ("train step", TRAIN_B, TRAIN_LEVELS[:4] + IMAGE_WARP_SHAPES, train_warp_inputs(dev)))
    for unit, b, shapes, own in units:
        cases = {"random flows": [], "smooth flows": [], "own inputs": [(img, flow, 1)
                                                                         for img, flow, _ in own]}
        for (h, w, c) in shapes:
            img = rand((b, h, w, c))
            cases["random flows"].append((img, rand((b, h, w, 2), w / 4), 2))
            cases["smooth flows"].append(
                (img, smooth_flow(rng, (b, h, w), torch.bfloat16, dev), 2))
        for kind, inputs in cases.items():
            totals = {False: dict.fromkeys(names, 0.0), True: dict.fromkeys(names, 0.0)}
            for img, flow, n in inputs:
                ms = variant_ms(img, flow)
                log("gather", f"{unit}, {kind}, {'x'.join(map(str, img.shape))} (|flow| mean "
                              f"{flow.float().abs().mean().item():.3f}), ms per call: "
                              f"{words(ms)}")
                for name in names:
                    totals[img.shape[-1] == 3][name] += n * ms[name]
            both = {name: totals[False][name] + totals[True][name] for name in names}
            split = (f" (image warps, C = 3: {words(totals[True])})"
                     if unit == "train step" else "")
            log("gather", f"per {unit}, {kind}, bf16, profiler device time in turns: "
                          f"{words(both)}{split}; on {card}")


def train_steps(phase: str, step, state, batch: dict, n: int, per_step: dict):
    """`n` steps, each launching exactly `per_step`; returns the state,
    every step's logs as floats (all finite) and the step ms (CUDA events)."""
    events, logs = [], []
    for i in range(n):
        before = counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, step_logs = step(state, batch)
        end.record()
        events.append((start, end))
        logs.append(step_logs)
        done = counts()
        got = {k: done[k] - before[k] for k in done}
        if got != per_step:
            raise AssertionError(f"{phase} step {i + 1} launched {got}, expected {per_step}")
    torch.cuda.synchronize()
    values = {k: [lg[k].item() for lg in logs] for k in logs[0]}
    if not all(np.isfinite(v).all() for v in values.values()):
        raise AssertionError(f"{phase}: non-finite loss or component: {values}")
    return state, values, [a.elapsed_time(b) for a, b in events]


def gradient_ratios(grads: dict, want: dict) -> dict:
    """max |grad - want| / max |want| per parameter."""
    return {name: (grads[name] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            for name, w in want.items()}


def f32_step_vs_plain(phase: str, opt32, batch: dict, dev) -> None:
    """One f32 step with the kernels and one under plain_ops() from the
    same initial state (the net of `opt32` from seed 0): the loss and
    every parameter gradient compared."""
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    crits32 = build_criterions(opt32)
    net32 = train_network(opt32, dev)
    init = {k: v.clone() for k, v in net32.state_dict().items()}
    results = []
    for plain in (False, True):
        net32.load_state_dict(init)
        step32 = make_train_step(net32, opt32, crits32)
        before = counts()
        with ops.plain_ops() if plain else contextlib.nullcontext():
            _, lg = step32(create_train_state(net32, opt32), batch)
        torch.cuda.synchronize()
        if plain and counts() != before:
            raise AssertionError(f"plain_ops() launched kernels: {before} -> {counts()}")
        results.append((lg["loss"].item(),
                        {n: p.grad.clone() for n, p in net32.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = results
    ratios = gradient_ratios(grads_k, grads_p)
    worst_name = max(ratios, key=ratios.get)
    stem = [v for k, v in ratios.items() if k.startswith(("feat_2.", "feat_3."))]
    log(phase, f"f32 step, kernels vs plain_ops(): loss {loss_k:.6f} vs {loss_p:.6f} "
               f"(rtol {LOSS_RTOL}); worst gradient max_abs_err / max|g| "
               f"{ratios[worst_name]:.3e} ({worst_name}; tol {GRAD_TOL_FRAC}) over "
               f"{len(grads_p)} parameters"
               + (f"; feat_2/feat_3 worst {max(stem):.3e}" if stem else ""))
    if not (abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p) and ratios[worst_name] <= GRAD_TOL_FRAC):
        raise AssertionError(f"{phase}: train step with kernels and under plain_ops() disagree")


def run_train(card: str, dev, phase: str, soft: bool, per_step: dict) -> dict:
    """6 bf16 steps with launch counts, then an f32 step with the kernels
    against one under plain_ops() from the same initial state. Returns
    the launch counts and the bf16 step ms."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import create_train_state, make_train_step

    opt = train_options("bfloat16", soft)
    batch = train_batch(dev)

    net = train_network(opt, dev)
    state = create_train_state(net, opt)
    step = make_train_step(net, opt, build_criterions(opt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, values, times = train_steps(phase, step, state, batch, TRAIN_STEPS, per_step)
    launches = counts()
    log(phase, f"6 bf16 steps B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: loss "
               f"{['%.4f' % v for v in values['loss']]}; step 6 components "
               + ", ".join(f"{k} {v[-1]:.5g}" for k, v in values.items() if k != "loss"))
    log(phase, f"launches over {TRAIN_STEPS} steps {launches} ({per_step} per step)")
    step_ms = statistics.median(times[1:])
    log(phase, f"bf16 train step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: {step_ms:.2f} ms "
               f"(CUDA events, median of steps 2-{TRAIN_STEPS}; all {['%.2f' % t for t in times]}), "
               f"{TRAIN_B / step_ms * 1e3:.2f} triplets/s trained, peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}")
    f32_step_vs_plain(phase, train_options("float32", soft), batch, dev)
    return {"launches": launches, "step_ms": step_ms}


def phase_criteria(card: str, dev) -> None:
    """The criteria and loss branches of the port beyond the hard and soft
    recipes (CRITERIA_CASES), stem off: per case 3 bf16 steps from the
    weights of seed 0 with exact launch counts (EPE_PER_STEP for epe,
    whose batch holds seeded ground truth), finite loss and components,
    step ms; then the f32 step with the kernels against plain_ops()."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import create_train_state, make_train_step

    phase_t0 = time.perf_counter()
    batch = train_batch(dev, ground_truth=True)
    net = train_network(train_options("bfloat16", soft=False), dev)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    for name, kw in CRITERIA_CASES:
        opt = train_options("bfloat16", soft=False, **kw)
        per_step = EPE_PER_STEP if opt.optimize == "epe" else TRAIN_PER_STEP
        net.load_state_dict(init)
        step = make_train_step(net, opt, build_criterions(opt))
        reset_launches()
        _, values, times = train_steps(f"criteria {name}", step, create_train_state(net, opt),
                                       batch, CRITERIA_STEPS, per_step)
        launches = counts()
        log("criteria", f"{name}: {CRITERIA_STEPS} bf16 steps B={TRAIN_B} {TRAIN_H}x{TRAIN_W}, "
                        f"loss {['%.4f' % v for v in values['loss']]}; step {CRITERIA_STEPS} "
                        + ", ".join(f"{k} {v[-1]:.5g}" for k, v in values.items() if k != "loss")
                        + f"; launches a step {' / '.join(str(per_step[k]) for k in DATA_LAUNCHES)}"
                        f" ({sum(launches.values())} in all); step ms "
                        f"{['%.2f' % t for t in times]} (CUDA events), on {card}")
        f32_step_vs_plain(f"criteria {name}", train_options("float32", soft=False, **kw), batch,
                          dev)
    log("criteria", f"phase took {time.perf_counter() - phase_t0:.1f} s")


def phase_remat(card: str, dev, soft: bool) -> None:
    """-remat 1 against the plain step: one bf16 step each from the same
    state (loss and every parameter gradient compared; K4's f32 atomics
    add in a varying order), exact launch counts (REMAT_PER_STEP: the
    forward kernels twice), then steps 2-5 of each: step ms (CUDA events)
    and peak device memory. The remat step must hold the lower peak."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import create_train_state, make_train_step

    tag = "remat soft" if soft else "remat"
    phase_t0 = time.perf_counter()
    batch = train_batch(dev)
    net = train_network(train_options("bfloat16", soft), dev)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    res = {}
    for remat in (0, 1):
        opt = train_options("bfloat16", soft, remat=remat)
        per_step = {(0, False): TRAIN_PER_STEP, (0, True): SOFT_PER_STEP,
                    (1, False): REMAT_PER_STEP, (1, True): SOFT_REMAT_PER_STEP}[remat, soft]
        net.load_state_dict(init)
        step = make_train_step(net, opt, build_criterions(opt))
        reset_launches()
        state, values, _ = train_steps(tag, step, create_train_state(net, opt), batch, 1,
                                       per_step)
        # on the host, so that the other run's peak does not hold them
        grads = {n: p.grad.float().cpu() for n, p in net.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, times = train_steps(tag, step, state, batch, REMAT_STEPS - 1, per_step)
        res[remat] = (values["loss"][0], grads, torch.cuda.max_memory_allocated(),
                      statistics.median(times))
        del state, step
    (loss0, grads0, peak0, ms0), (loss1, grads1, peak1, ms1) = res[0], res[1]
    ratios = gradient_ratios(grads1, grads0)
    worst = max(ratios, key=ratios.get)
    log(tag, f"bf16 step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}, remat 1 vs 0 from the same state: loss "
             f"{loss1:.6f} vs {loss0:.6f} (rtol {LOSS_RTOL}); worst gradient max_abs_err / max|g| "
             f"{ratios[worst]:.3e} ({worst}; tol {BF16_GRAD_TOL_FRAC}); launches a step with "
             f"remat: cost volume fwd {REMAT_PER_STEP['b2f_cost_volume_fwd']}, gather "
             f"{REMAT_PER_STEP['b2f_warp_bilinear_fwd']}"
             + (", K5 2, K6 2" if soft else "") + "; the backward's as without")
    log(tag, f"peak device memory over steps 2-{REMAT_STEPS}: remat 0 {peak0 / 2**30:.3f} GiB, "
             f"remat 1 {peak1 / 2**30:.3f} GiB ({peak1 / peak0:.3f}x); step ms (CUDA events, "
             f"median of steps 2-{REMAT_STEPS}) remat 0 {ms0:.2f}, remat 1 {ms1:.2f} "
             f"({ms1 / ms0:.3f}x), on {card}; the phase took "
             f"{time.perf_counter() - phase_t0:.1f} s")
    if abs(loss1 - loss0) > LOSS_RTOL * abs(loss0) or ratios[worst] > BF16_GRAD_TOL_FRAC:
        raise AssertionError(f"{tag}: the remat step and the plain step disagree")
    if peak1 >= peak0:
        raise AssertionError(f"{tag}: remat did not lower the peak memory ({peak1} >= {peak0})")


def _flag(argv: list, name: str, default: int) -> int:
    """The integer value of `name` in argv (removed from it), or `default`."""
    if name not in argv:
        return default
    i = argv.index(name)
    value = int(argv[i + 1])
    del argv[i:i + 2]
    return value


def phase_learn(card: str, dev, argv: list) -> None:
    """The learning demonstration on the card (module docstring, --learn):
    a LEARN_SCENES-scene RoamingImages set (seed 0, 320x640, the
    generator's other defaults) and a LEARN_ESCAPE_SCENES-scene escape set
    (seed 1) in a temporary directory, then back2future_tpu_torch.learn_demo
    with its defaults (or the flags in `argv`) on them: per stage the val
    EPE and occlusion accuracy per epoch, an epoch's wall time and
    triplets/s; the zero-flow baseline, the transfer probe, the evals and
    the past-flow sanity; then K4's routes on the trained hard net's own
    K4 inputs. Raises unless the hard stage's held-out EPE is below the
    zero-flow baseline."""
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch import learn_demo
    from back2future_tpu_torch.data import FlowDataset, SampleConfig, load_manifest, load_split
    from back2future_tpu_torch.data import roaming
    from back2future_tpu_torch.train.checkpoint import build_from_params, load_model_checkpoint
    from back2future_tpu_torch.utils import SymbolLogger

    argv = list(argv)
    scenes = _flag(argv, "--scenes", LEARN_SCENES)
    escape_scenes = _flag(argv, "--escape_scenes", LEARN_ESCAPE_SCENES)
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="b2f_learn_") as tmp:
        root = Path(tmp)
        main_set, escape_set, cache = root / "roaming", root / "roam_escape", root / "ckpt"
        t0 = time.perf_counter()
        workers = min(8, os.cpu_count() or 1)
        roaming.main(["--out", str(main_set), "--n", str(scenes), "--seed", "0"], workers)
        gen_s = time.perf_counter() - t0
        roaming.main(["--out", str(escape_set), "--n", str(escape_scenes), "--seed", "1"],
                     workers)
        n_val = len(load_split(main_set / "datasets" / "RoamingImages_split.dat")[1])
        log("learn", f"RoamingImages generated: {scenes} scenes (seed 0, {scenes - n_val} train / "
                     f"{n_val} val) in {gen_s:.1f} s by {workers} processes, and "
                     f"{escape_scenes} escape scenes (seed 1)")
        args = ["--data", str(main_set), "--escape_data", str(escape_set),
                "--cache", str(cache)] + argv
        t0 = time.perf_counter()
        learn_demo.main(args)
        learn_s = time.perf_counter() - t0
        i = args.index("--out") if "--out" in args else None
        out = learn_demo.REPO / (args[i + 1] if i is not None else "docs/evidence/learning_demo_torch")
        report = json.loads((out / "learning_demo.json").read_text())
        batch_size, epoch_size = report["batch"], report["epoch_size"]

        log("learn", f"learn_demo took {learn_s:.1f} s (B={batch_size}, epoch size "
                     f"{epoch_size}, wire {report['wire']}); report {out / 'learning_demo.json'}")
        stages = ["escape"] + sorted((p.name for p in cache.glob("cur*")),
                                     key=lambda n: int(n[3:])) + ["hard", "soft"]
        for exp in stages:
            d = cache / exp
            if not (d / "train.log").exists():
                continue
            train = SymbolLogger(d / "train.log").read()
            test = SymbolLogger(d / "test.log").read() if (d / "test.log").exists() else {}
            walls = [float(m) for m in re.findall(
                r"\[TRAINING SUMMARY\] Total Time\(s\): ([0-9.]+)", (d / "log").read_text())]
            rates = [batch_size * epoch_size / w for w in walls]
            log("learn", f"{exp}: {len(walls)} epochs; train EPE per epoch "
                         f"{['%.3f' % v for v in train.get('avg epe (train set)', [])]}; val EPE "
                         f"{['%.3f' % v for v in test.get('avg epe (test set)', [])]}; val occ acc "
                         f"{['%.3f' % v for v in test.get('avg occ acc (test set)', [])]}; epoch "
                         f"wall s {['%.1f' % w for w in walls]} (median "
                         f"{statistics.median(walls):.2f}); triplets/s (median) "
                         f"{statistics.median(rates):.2f}; on {card}")
        baseline = report["baseline"]
        log("learn", f"zero-flow baseline: EPE {baseline['zero_flow_epe']:.4f} px, all-visible "
                     f"occ acc {baseline['all_visible_occ_acc']:.4f}, {baseline['n_val']} val")
        for key in ("eval_escape_transfer", "eval_hard", "eval_soft"):
            ev = report.get(key, {})
            words = (f"EPE {ev['epe']:.4f} px, occ acc {ev['occ_acc']:.4f}, Fl-all "
                     f"{ev['fl_all']:.4f}, {ev['n_samples']} samples" if "epe" in ev else str(ev))
            log("learn", f"{key}: {words}")
        log("learn", f"past-flow sanity: {report.get('past_flow_sanity')}")

        # K4's routes on the trained hard net's own K4 inputs (B=8, the
        # first val scenes, the learn demo's hard recipe)
        params, cfg = load_model_checkpoint(cache / "hard" / f"model_{report['epochs'][0]}.pt")
        net = build_from_params(cfg, params).to(dev)
        opt = train_options("bfloat16", soft=False, pme=1.0, pme_criterion="OBCC",
                            smooth_flow=2.0, dataset="RoamingImages", ground_truth=True,
                            rand_crop=0)
        specs = load_manifest(main_set / "datasets" / "RoamingImages.dat", ground_truth=True,
                              root=str(main_set / "data"))
        _, val = load_split(main_set / "datasets" / "RoamingImages_split.dat")
        ds = FlowDataset(specs, SampleConfig.from_options(opt), val[:TRAIN_B], train=False)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.get(0, TRAIN_B).items()}
        phase_k4_routes(card, dev, trained=("trained hard net", opt, net, batch))
    log("learn", f"phase took {time.perf_counter() - phase_t0:.1f} s")
    hard = report["eval_hard"]
    if not ("epe" in hard and hard["epe"] < baseline["zero_flow_epe"]):
        raise AssertionError(f"learn: the hard stage's val EPE {hard} is not below the zero-flow "
                             f"baseline {baseline['zero_flow_epe']}")
    if not np.isfinite(report["eval_soft"].get("epe", np.nan)):
        raise AssertionError(f"learn: the soft stage's val EPE is not finite: {report['eval_soft']}")


def _probe_batch(shape: tuple, wire: str) -> dict:
    """A batch as the loader makes one (collate, then the wire's encoding)
    of B samples of (H, W, C) images; its values do not matter to a pipe."""
    from back2future_tpu_torch.data import collate, encode_batch

    b, h, w, c = shape
    sample = (np.zeros((h, w, c), np.float32), np.zeros((h, w, 4), np.float32),
              np.zeros((h, w), np.float32))
    return encode_batch(collate([sample] * b), wire)


def _pipe_probe(shape: tuple, wire: str, n: int, out_q, go) -> None:
    """A loader worker without its work: report the wall clock once this
    process has started (under spawn: imported this script, as the
    loader's workers do), wait for `go`, then put a batch n times on the
    queue."""
    out_q.put(time.time())
    batch = _probe_batch(shape, wire)
    go.wait()
    for _ in range(n):
        out_q.put(batch)


def pickle_ms(batch: dict) -> tuple:
    """ms of pickle's dumps and loads of `batch` in this process."""
    import pickle

    t0 = time.perf_counter()
    blob = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
    t1 = time.perf_counter()
    pickle.loads(blob)
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def pipe_probe(shape: tuple, wire: str, method: str, producers: int,
               per_producer: int) -> tuple:
    """The loader's pipe alone: `producers` processes of the loader's start
    method stream batches of `shape` on `wire` through one queue, as its
    workers do, to one consumer. Returns the seconds from the first start
    to the last producer's being ready (the workers' start-up), and the ms
    a batch over the arrivals after the first."""
    import multiprocessing as mp

    ctx = mp.get_context(method)
    out_q, go = ctx.Queue(maxsize=producers), ctx.Event()
    t0 = time.time()
    procs = [ctx.Process(target=_pipe_probe, args=(shape, wire, per_producer, out_q, go),
                         daemon=True) for _ in range(producers)]
    for p in procs:
        p.start()
    try:
        ready = [out_q.get(timeout=300) for _ in procs]
        go.set()
        arrivals = []
        for _ in range(producers * per_producer):
            out_q.get(timeout=300)
            arrivals.append(time.perf_counter())
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return max(ready) - t0, (arrivals[-1] - arrivals[0]) / (len(arrivals) - 1) * 1e3


def phase_data(card: str, dev, random_step_ms: float, probe: bool = True) -> dict:
    """The hard bf16 step fed from files on disk through the port's own
    generator, loader and device prefetch (module docstring, phase 7).
    `probe`: also time the loader's pipe alone (`pipe_probe`; `--data`
    does, the default run does not, for its time limit). Returns the
    loader-fed triplets/s (wall clock, steps 2-DATA_STEPS) by
    configuration."""
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch.data import (
        FlowDataset, PrefetchLoader, SampleConfig, device_prefetch, load_manifest, load_split,
    )
    from back2future_tpu_torch.data import roaming
    from back2future_tpu_torch.data.loader import _cuda_live
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.runtime.host_build import host_threads
    from back2future_tpu_torch.train import create_train_state, make_train_step

    phase_t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    method = os.environ.get("B2F_MP_START", "") or ("spawn" if _cuda_live() else "fork")
    opt = train_options("bfloat16", soft=False)
    rates = {}
    crits = build_criterions(opt)
    with tempfile.TemporaryDirectory(prefix="b2f_roaming_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        roaming.main(["--out", tmp, "--n", str(DATA_SCENES), "--height", str(TRAIN_H),
                      "--width", str(TRAIN_W), "--frames", "3", "--seed", "0"])
        gen_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
        specs = load_manifest(root / "datasets" / "RoamingImages.dat", ground_truth=True,
                              root=str(root / "data"))
        train_idx, val_idx = load_split(root / "datasets" / "RoamingImages_split.dat")
        log("data", f"RoamingImages generated: {DATA_SCENES} scenes at {TRAIN_H}x{TRAIN_W}, "
                    f"3 frames, in {gen_s:.2f} s ({gen_s / DATA_SCENES * 1e3:.1f} ms a scene), "
                    f"{size} bytes on disk; split {len(train_idx)} train / {len(val_idx)} val; "
                    f"host cores {os.cpu_count()}, {workers} loader workers, start method "
                    f"{method}, each worker's host C++ row loops at host_threads() = "
                    f"{host_threads()} threads (the full-plane resizes; the windowed and "
                    f"photometric functions of augment 1 are serial); on {card}")
        for tag, words, cfg_kw, loader_kw in DATA_CONFIGS:
            cfg = SampleConfig(frames=3, ground_truth=True, fine_height=TRAIN_H,
                               fine_width=TRAIN_W, load_height=TRAIN_H, load_width=TRAIN_W,
                               **cfg_kw)
            ds = FlowDataset(specs, cfg, train_idx, train=True)

            def loader(n_batches, n_workers):
                return PrefetchLoader(ds, TRAIN_B, n_batches, n_workers=n_workers,
                                      worker_mode="process", **loader_kw)

            # the loader alone, process mode
            t0 = time.perf_counter()
            got, arrived = [], []
            for batch in loader(DATA_BATCHES, workers):
                got.append(batch)
                arrived.append(time.perf_counter() - t0)
            rate = TRAIN_B * (DATA_BATCHES - 1) / (arrived[-1] - arrived[0])
            batch_ms = (arrived[-1] - arrived[0]) / (DATA_BATCHES - 1) * 1e3
            second = (arrived[-1] - arrived[-1 - workers]) / workers * 1e3
            nbytes_batch = sum(v.nbytes for v in got[0].values())
            dumps_ms, loads_ms = pickle_ms(got[0])
            pipe_words = "the pipe alone not timed (`--data` times it)"
            if probe:
                startup_s, pipe = pipe_probe(got[0]["images"].shape, cfg.wire, method, workers,
                                             DATA_PIPE_PER_WORKER)
                pipe_words = (f"{workers} workers' {method} start-up {startup_s:.2f} s; pipe "
                              f"alone {pipe:.1f} ms a batch ({workers} {method} producers, one "
                              f"queue; pickle dumps {dumps_ms:.1f} + loads {loads_ms:.1f} ms in "
                              f"one process), {pipe / batch_ms:.3f} of the loader's time a batch")

            # the same seed and epoch in sync mode: bit-identical batches
            t0 = time.perf_counter()
            for i, want in enumerate(loader(DATA_CHECKED, 0)):
                for k, v in want.items():
                    if got[i][k].dtype != v.dtype or not np.array_equal(got[i][k], v):
                        raise AssertionError(f"data ({tag}): batch {i} '{k}' differs between "
                                             f"process and sync mode")
            sample_ms = (time.perf_counter() - t0) / (DATA_CHECKED * TRAIN_B) * 1e3
            log("data", f"({tag}) {words}: loader alone {rate:.2f} samples/s over batches "
                        f"2-{DATA_BATCHES} ({batch_ms:.1f} ms a batch of {nbytes_batch} bytes; "
                        f"{TRAIN_B * 1e3 / second:.2f} samples/s over the last {workers}, the "
                        f"workers' second round), first batch after {arrived[0]:.2f} s; "
                        f"{pipe_words}; a sample in sync mode {sample_ms:.1f} ms (one process); the first "
                        f"{DATA_CHECKED} batches of process mode bit-identical to sync mode; "
                        f"on {card}")
            del got

            # the hard bf16 step fed by the loader through device_prefetch
            net = train_network(opt, dev)
            state = create_train_state(net, opt)
            step = make_train_step(net, opt, crits)
            ld = loader(DATA_STEPS, workers)
            ld.set_epoch(1)
            host = iter(ld)
            batches = device_prefetch(host, dev, depth=2)
            events, waits, logs, marks = [], [], [], []
            torch.cuda.synchronize()
            for i in range(DATA_STEPS):
                if i in (1, DATA_STEPS - DATA_STEADY):
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                t0 = time.perf_counter()
                batch = next(batches)
                waits.append(time.perf_counter() - t0)
                before = counts()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                state, step_logs = step(state, batch)
                end.record()
                events.append((start, end))
                logs.append(step_logs)
                done = counts()
                launched = {k: done[k] - before[k] for k in done}
                if launched != TRAIN_PER_STEP:
                    raise AssertionError(f"data ({tag}) step {i + 1} launched {launched}, "
                                         f"expected {TRAIN_PER_STEP}")
            torch.cuda.synchronize()
            wall, steady = (time.perf_counter() - m for m in marks)
            batches.close()
            host.close()
            values = {k: [lg[k].item() for lg in logs] for k in logs[0]}
            if not all(np.isfinite(v).all() for v in values.values()):
                raise AssertionError(f"data ({tag}): non-finite loss or component: {values}")
            times = [a.elapsed_time(b) for a, b in events]
            step_ms = statistics.median(times[1:])
            tail = DATA_STEPS - 1 - DATA_STEADY
            rates[tag] = TRAIN_B * (DATA_STEPS - 1) / wall
            log("data", f"({tag}) hard bf16 step B={TRAIN_B} {TRAIN_H}x{TRAIN_W} from the "
                        f"loader through device_prefetch, {DATA_STEPS} steps, launches "
                        f"{' / '.join(str(TRAIN_PER_STEP[k]) for k in DATA_LAUNCHES)} each: "
                        f"{step_ms:.2f} ms (CUDA events, median of steps 2-{DATA_STEPS}), "
                        f"{TRAIN_B * (DATA_STEPS - 1) / wall:.2f} triplets/s trained (wall "
                        f"clock, steps 2-{DATA_STEPS}; {TRAIN_B * DATA_STEADY / steady:.2f} "
                        f"over the last {DATA_STEADY}), mean host wait in next() "
                        f"{statistics.mean(waits[1:]) * 1e3:.1f} ms a step "
                        f"({statistics.mean(waits[1 + tail:]) * 1e3:.1f} over the last "
                        f"{DATA_STEADY}; the first {waits[0]:.2f} s); random-tensor step "
                        f"(phase 6) {random_step_ms:.2f} ms, "
                        f"{TRAIN_B / random_step_ms * 1e3:.2f} triplets/s; loss "
                        f"{['%.4f' % v for v in values['loss']]}; on {card}")
            del net, state, step, batch
    log("data", f"phase took {time.perf_counter() - phase_t0:.1f} s")
    return rates


@contextlib.contextmanager
def watching_run(loop, seen: dict, check_loaded):
    """Inside the block `loop.run` records into `seen`: each train and eval
    step's launches (host-side counters, read without a sync) and the host
    time after its dispatch, each train and eval epoch's wall interval,
    each checkpoint save's ms (synchronised), and each
    load_train_checkpoint's ms; `check_loaded(state)` runs right after a
    load, before any step changes the state."""
    names = ("make_train_step", "make_eval_step", "train_epoch", "eval_epoch",
             "save_checkpoint", "load_train_checkpoint")
    saved = {n: getattr(loop, n) for n in names}

    def counted(kind, make):
        def factory(*args, **kw):
            fn = make(*args, **kw)

            def step(*a):
                before = counts()
                out = fn(*a)
                done = counts()
                seen[kind].append({k: done[k] - before[k] for k in done})
                seen[kind + "_t"].append(time.perf_counter())
                return out
            return step
        return factory

    def timed(key, fn, sync=False, after=None):
        def wrapper(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            seen[key].append((t0, time.perf_counter()))
            if after is not None:
                after(out)
            return out
        return wrapper

    loop.make_train_step = counted("train", saved["make_train_step"])
    loop.make_eval_step = counted("eval", saved["make_eval_step"])
    loop.train_epoch = timed("epoch", saved["train_epoch"])
    loop.eval_epoch = timed("eval_epoch", saved["eval_epoch"])
    loop.save_checkpoint = timed("save", saved["save_checkpoint"], sync=True)
    loop.load_train_checkpoint = timed("load", saved["load_train_checkpoint"], sync=True,
                                       after=lambda out: check_loaded(out[0]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(loop, n, fn)


def phase_loop(card: str, dev, data_rates: dict) -> dict:
    """The epoch loop on the card (module docstring, phase 7b): run() from
    files, its checkpoints and logs, a -cont resume, init(path) serving
    what it saved, and the eval CLI. Returns the loop path's launches."""
    import collections
    import dataclasses
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch import api
    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.data import load_split, roaming
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import loop
    from back2future_tpu_torch.utils import SymbolLogger

    phase_t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    seen = collections.defaultdict(list)
    with tempfile.TemporaryDirectory(prefix="b2f_loop_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        roaming.main(["--out", str(root / "set"), "--n", str(LOOP_SCENES), "--height",
                      str(TRAIN_H), "--width", str(TRAIN_W), "--frames", "3", "--seed", "0",
                      "--val_fraction", str(LOOP_VAL_FRACTION)])
        gen_s = time.perf_counter() - t0
        datasets = root / "set" / "datasets"
        n_val = len(load_split(datasets / "RoamingImages_split.dat")[1])
        opt = Options(batchSize=TRAIN_B, dataset="RoamingImages", datasets_dir=str(datasets),
                      data_root=str(root / "set" / "data"), cache=str(root / "cache"),
                      expName="loop", epochSize=LOOP_EPOCH_SIZE, nEpochs=2, epochStore=1,
                      nDonkeys=workers, **LOOP_OPTIONS).derive(make_dirs=True)
        save = Path(opt.save)
        log("loop", f"RoamingImages generated: {LOOP_SCENES} scenes at {TRAIN_H}x{TRAIN_W} in "
                    f"{gen_s:.2f} s, {LOOP_SCENES - n_val} train / {n_val} val; run(): "
                    f"{opt.pme_criterion} {opt.compute_dtype} B={opt.batchSize} "
                    f"{opt.fineHeight}x{opt.fineWidth}, epochSize {opt.epochSize}, "
                    f"{workers} loader workers, wire {opt.wire}, ground_truth {opt.ground_truth}")

        def refuse_load(state):
            raise AssertionError("the first run loaded a checkpoint")

        reset_launches()
        with watching_run(loop, seen, refuse_load):
            first = loop.run(opt)
        launches = counts()
        n_train = 2 * LOOP_EPOCH_SIZE
        if first.step != n_train or len(seen["train"]) != n_train:
            raise AssertionError(f"loop: the first run took {first.step} steps "
                                 f"({len(seen['train'])} seen), expected {n_train}")
        if len(seen["eval"]) != 2 * -(-n_val // TRAIN_B):
            raise AssertionError(f"loop: {len(seen['eval'])} eval steps for {n_val} val scenes")
        for kind, want in (("train", TRAIN_PER_STEP), ("eval", EVAL_PER_STEP)):
            bad = [(i, got) for i, got in enumerate(seen[kind]) if got != want]
            if bad:
                raise AssertionError(f"loop: {kind} step {bad[0][0] + 1} launched {bad[0][1]}, "
                                     f"expected {want}")
        files = [f"model_{e}.pt" for e in (1, 2)] + [f"optimState_{e}.pt" for e in (1, 2)] + [
            "options.json", "train.log", "test.log", "train.svg", "test.svg", "log"]
        missing = [f for f in files if not (save / f).is_file()]
        if missing:
            raise AssertionError(f"loop: the first run did not write {missing}")
        logs = {name: SymbolLogger(save / f"{name}.log").read() for name in ("train", "test")}
        for name, cols in logs.items():
            epe = cols[f"avg epe ({name} set)"]
            if len(epe) != 2 or not np.isfinite(epe).all() or not np.isfinite(
                    cols[f"avg loss ({name} set)"]).all():
                raise AssertionError(f"loop: {name}.log {cols}")
        epochs = [b - a for a, b in seen["epoch"]]
        firsts = seen["train_t"][::LOOP_EPOCH_SIZE]
        after_first = [TRAIN_B * (LOOP_EPOCH_SIZE - 1) / (b - t)
                       for (a, b), t in zip(seen["epoch"], firsts)]
        evals = [b - a for a, b in seen["eval_epoch"]]
        save_ms = [(b - a) * 1e3 for a, b in seen["save"]]
        log("loop", f"run() 2 epochs x {LOOP_EPOCH_SIZE} steps: every train step launched "
                    f"{' / '.join(str(TRAIN_PER_STEP[k]) for k in DATA_LAUNCHES)}, every eval "
                    f"step K1 x10 and the gather x18 and no backward kernel; loss "
                    f"{logs['train']['avg loss (train set)']}, avg epe (train set) "
                    f"{logs['train']['avg epe (train set)']}, (test set) "
                    f"{logs['test']['avg epe (test set)']}; launches over the run {launches}")
        log("loop", f"epoch wall {['%.2f s' % e for e in epochs]} (spawn start-up of the "
                    f"loader included), {['%.2f' % (TRAIN_B * LOOP_EPOCH_SIZE / e) for e in epochs]}"
                    f" triplets/s trained through run(), "
                    f"{['%.2f' % r for r in after_first]} over steps 2-{LOOP_EPOCH_SIZE}; phase 7's "
                    f"loader-fed step (steps 2-{DATA_STEPS}) "
                    + (", ".join(f"({k}) {v:.2f}" for k, v in data_rates.items())
                       if data_rates else "not run") + f" triplets/s; eval epoch "
                    f"{['%.2f s' % e for e in evals]} ({n_val} samples); checkpoint pair save "
                    f"{['%.1f ms' % m for m in save_ms]}; on {card}")

        # -cont with persistent Adam moments: the state right after the load
        # equals the first run's final state, bit for bit
        def check_loaded(state):
            if state.step != first.step or state.epoch != 2:
                raise AssertionError(f"loop: -cont loaded step {state.step} epoch {state.epoch}")
            ref = dict(first.model.named_parameters())
            for name, q in state.model.named_parameters():
                p = ref[name]
                if not torch.equal(p, q):
                    raise AssertionError(f"loop: -cont parameter {name} differs from the saved one")
                want, got = first.optimizer.rule.state[p], state.optimizer.rule.state[q]
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    if not torch.equal(want[k], got[k]):
                        raise AssertionError(f"loop: -cont Adam {k} of {name} differs")
            seen["checked"].append(True)

        for k in ("train", "eval", "train_t", "epoch", "eval_epoch", "save"):
            seen[k].clear()
        with watching_run(loop, seen, check_loaded):
            resumed = loop.run(dataclasses.replace(opt, cont=True, nEpochs=3,
                                                   adam_reset_per_epoch=False))
        if seen["checked"] != [True] or resumed.step != n_train + LOOP_EPOCH_SIZE:
            raise AssertionError(f"loop: the resume checked {seen['checked']}, ended at step "
                                 f"{resumed.step}, expected {n_train + LOOP_EPOCH_SIZE}")
        if any(got != TRAIN_PER_STEP for got in seen["train"]) or any(
                got != EVAL_PER_STEP for got in seen["eval"]) or not (save / "model_3.pt").is_file():
            raise AssertionError("loop: the resumed epoch's launches or checkpoint")
        load_ms = [(b - a) * 1e3 for a, b in seen["load"]]
        log("loop", f"-cont adam_reset_per_epoch 0: parameters and Adam exp_avg / exp_avg_sq / "
                    f"step right after the load equal the first run's final state bit for "
                    f"bit; step {first.step} -> {resumed.step}; checkpoint pair load "
                    f"{load_ms[0]:.1f} ms, save {(seen['save'][0][1] - seen['save'][0][0]) * 1e3:.1f}"
                    f" ms; epoch 3 wall {seen['epoch'][0][1] - seen['epoch'][0][0]:.2f} s; on {card}")

        # init(path) serves what was saved: the trained module's own flow
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = api.init(str(save), device=dev)
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        if est.config != resumed.model.cfg:
            raise AssertionError(f"loop: init(path) config {est.config} != {resumed.model.cfg}")
        rng = np.random.default_rng(3)
        frames = [rng.random((B, H_IN, W_IN, 3), dtype=np.float32) for _ in range(3)]
        reset_launches()
        res = est.compute_flow_batch(*frames)
        if counts() != SERVING_PER_FORWARD:
            raise AssertionError(f"loop: init(path) serving launched {counts()}, "
                                 f"expected {SERVING_PER_FORWARD}")
        check_results(res, B)
        imgs, n, h, w = api._preprocess_triplets(frames, 3)
        x = torch.from_numpy(imgs).to(dev)
        with torch.inference_mode():
            got = est.net(x, with_warped=False)[0]
            want = resumed.model(x, with_warped=False)[0]
        ref = api._postprocess_results(want["flow"].float().cpu().numpy(),
                                       want["occ"].float().cpu().numpy(), n, h, w)
        if not (torch.equal(got["flow"], want["flow"]) and torch.equal(got["occ"], want["occ"])
                and all(np.array_equal(a, b) for a, b in zip(res, ref))):
            raise AssertionError("loop: init(path)'s flow differs from the trained module's")
        log("loop", f"init(path) {init_ms:.1f} ms (model_3.pt, {est.config.dtype}); "
                    f"compute_flow_batch B={B} {H_IN}x{W_IN}: launches {SERVING_PER_FORWARD['b2f_cost_volume_fwd']}"
                    f" K1 + {SERVING_PER_FORWARD['b2f_warp_bilinear_fwd']} gathers, flow and "
                    f"occlusion bit-identical to the trained module's forward on the same "
                    f"input; on {card}")

        # the eval CLI on the checkpoint over the val split
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "back2future_tpu_torch.eval", "--checkpoint", str(save),
               "--dataset", "RoamingImages", "--datasets_dir", str(datasets),
               "--data_root", str(root / "set" / "data"), "--batchSize", str(TRAIN_B),
               "--cropHeight", str(TRAIN_H), "--cropWidth", str(TRAIN_W)]
        here = os.path.dirname(os.path.abspath(__file__))
        res = subprocess.run(cmd + (["--cpu"] if dev.type == "cpu" else []), cwd=here,
                             env=dict(os.environ, PYTHONPATH=here), capture_output=True,
                             text=True, timeout=300)
        if res.returncode:
            raise AssertionError(f"loop: the eval CLI exited {res.returncode}: {res.stderr}")
        metrics = json.loads(res.stdout.strip().splitlines()[-1])
        if metrics["n_samples"] != n_val or not np.isfinite(list(metrics.values())).all():
            raise AssertionError(f"loop: eval CLI {metrics}")
        log("loop", f"eval CLI over the val split ({time.perf_counter() - t0:.1f} s, a process "
                    f"of its own): {metrics}")
    log("loop", f"phase took {time.perf_counter() - phase_t0:.1f} s")
    return launches


PIPE_VARIANTS = ("queue", "connection", "connection_1mb", "readv_1mb", "shared_memory")


def _pipe_variant_producer(variant: str, shape: tuple, wire: str, n: int, end, go) -> None:
    """Send the batch n times to the consumer by `variant`."""
    import pickle
    import struct

    batch = _probe_batch(shape, wire)
    if variant == "queue":
        go.wait()
        for _ in range(n):
            end.put(batch)
        end.close()
        end.join_thread()
        return
    if variant == "shared_memory":
        from multiprocessing import shared_memory

        go.wait()
        for _ in range(n):
            layout, blocks = {}, []
            for k, v in batch.items():
                shm = shared_memory.SharedMemory(create=True, size=max(v.nbytes, 1))
                np.ndarray(v.shape, v.dtype, buffer=shm.buf)[...] = v
                layout[k] = (shm.name, v.shape, v.dtype.str)
                blocks.append(shm)
            end.send(layout)
            end.recv()                 # the consumer has copied the batch out
            for shm in blocks:
                shm.close()
                shm.unlink()
        return
    if variant.endswith("_1mb"):
        import fcntl

        fcntl.fcntl(end.fileno(), fcntl.F_SETPIPE_SZ, 1 << 20)
    go.wait()
    for _ in range(n):
        blob = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
        if variant == "readv_1mb":
            os.write(end.fileno(), struct.pack("!Q", len(blob)))
            view = memoryview(blob)
            while view:
                view = view[os.write(end.fileno(), view):]
        else:
            end.send_bytes(blob)


def _readv_message(fd: int) -> bytearray:
    """One length-framed message read straight into a buffer of its size."""
    import struct

    head = bytearray(8)
    got = 0
    while got < 8:
        got += os.readv(fd, [memoryview(head)[got:]])
    (size,) = struct.unpack("!Q", head)
    buf = bytearray(size)
    view, got = memoryview(buf), 0
    while got < size:
        got += os.readv(fd, [view[got:]])
    return buf


def pipe_variant_ms(variant: str, shape: tuple, wire: str, n: int) -> float:
    """Median ms a batch from one spawned producer to this process, from
    the wait for a message to the batch as arrays, by `variant`."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    go = ctx.Event()
    if variant == "queue":
        here = there = ctx.Queue(maxsize=2)
    else:
        here, there = ctx.Pipe(duplex=variant == "shared_memory")
    p = ctx.Process(target=_pipe_variant_producer, args=(variant, shape, wire, n, there, go),
                    daemon=True)
    p.start()
    if variant.endswith("_1mb"):
        import fcntl

        fcntl.fcntl(here.fileno(), fcntl.F_SETPIPE_SZ, 1 << 20)
    go.set()
    times = []
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            if variant == "queue":
                batch = here.get(timeout=300)
            elif variant == "shared_memory":
                from multiprocessing import shared_memory

                batch = {}
                for k, (name, shp, dt) in here.recv().items():
                    shm = shared_memory.SharedMemory(name=name)
                    batch[k] = np.array(np.ndarray(shp, np.dtype(dt), buffer=shm.buf))
                    shm.close()
                here.send(True)
            elif variant == "readv_1mb":
                batch = pickle.loads(_readv_message(here.fileno()))
            else:
                batch = pickle.loads(here.recv_bytes())
            times.append((time.perf_counter() - t0) * 1e3)
            assert batch["images"].shape == shape
    finally:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
    return statistics.median(times[1:])


def phase_pipe_variants(card: str) -> None:
    """A batch of each wire through the loader's queue and through the
    alternatives, one producer process to this one (module docstring)."""
    torch.zeros(1, device="cuda")        # a live CUDA context, as in training
    shape = (TRAIN_B, TRAIN_H, TRAIN_W, 9)
    for wire in ("compact", "f32"):
        batch = _probe_batch(shape, wire)
        nbytes = sum(v.nbytes for v in batch.values())
        dumps_ms, loads_ms = pickle_ms(batch)
        ms = {v: pipe_variant_ms(v, shape, wire, PIPE_MESSAGES) for v in PIPE_VARIANTS}
        log("pipe", f"{wire} wire, a batch of {nbytes} bytes (B={TRAIN_B} {TRAIN_H}x{TRAIN_W}), "
                    f"ms a batch, median of {PIPE_MESSAGES - 1} after the first: "
                    + ", ".join(f"{v} {t:.1f}" for v, t in ms.items())
                    + f"; pickle dumps {dumps_ms:.1f} + loads {loads_ms:.1f} in one process; "
                      f"on {card}")


# ------------------------------------------------------------------ K4 at C = 3

# K4's routes at C = 3 timed against each other on the same inputs
# (ops.K4_ROUTES): the path's (the pixel kernel) and the quad tiles as the
# path took them before it, in the default run; with --k4-c3 also the
# pixel kernel direct on every block and with the window wherever the box
# fits
K4_C3_ROUTES = ("grid", "quads")
K4_C3_ALL = ("grid", "quads", "direct", "window")
# two routes' f32 image gradients: sums in another order (atomics)
K4_ROUTE_TOL = 1e-5                    # of the largest value
K4_TURNS_PAD = 32                      # kernels before a turns window's calls


def k4_route_turns(cases: list, routes: tuple, reps: int = 10, attempts: int = 3) -> list:
    """K4 by each of `routes` on each of `cases` ((flow, g, h_src, y0))
    through the path's wrapper (`ops.warp_dimages_route`: a zero-fill,
    the kernel, one cast), in turns: `reps` / 2 profiler windows, each
    case by every route in order and then each in reverse order in each
    window. Returns per case a dict of route -> (kernel, zero-fill, cast)
    device ms a call, means over `reps`. A window's device work is split
    into calls in time order: a call starts with its zero-fill, then its
    kernel (a name with "dimages") and its cast. A window that misses a
    launch is logged and taken again at once, every other one tracing the
    host's activity too (as `device_ms`; late in a long run the profiler
    has left out some of a window's kernels); after `attempts` such
    windows, each route is timed in a window of its own instead, in turns
    (routes in order, then reversed), its device work split by kernel
    name, and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from back2future_tpu_torch import ops

    order = [(i, r) for rep in range(2) for i in range(len(cases))
             for r in (routes if rep == 0 else routes[::-1])]
    family = {r: "dimages_tiled" if r == "quads" else "dimages_pixels" for r in routes}
    pad = torch.empty(1 << 20, device="cuda")

    def run(calls):
        for i, r in calls:
            flow, g, h_src, y0 = cases[i]
            ops.warp_dimages_route(flow, g, r, h_src, y0)

    def part(name: str) -> str:
        return "fill" if "Fill" in name or "emset" in name else \
            "kernel" if "dimages" in name else "cast"

    def window(attempt: int):
        """One window of `order`: its calls' (kernel, fill, cast) ms, or
        None where it does not hold every call in order."""
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if attempt % 2 else [])
        with profile(activities=activities) as prof:
            # pads the window: late in the default run the profiler has
            # left out a window's first 18 kernels, elsewhere its last one
            for _ in range(K4_TURNS_PAD):
                pad.neg_()
            run(order)
            pad.neg_()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and not e.is_user_annotation and "neg" not in e.name),
                        key=lambda e: e.time_range.start)
        calls = []
        for e in events:
            if part(e.name) == "fill":
                calls.append({"fill": 0.0, "kernel": 0.0, "cast": 0.0, "names": []})
            elif not calls:
                break
            calls[-1][part(e.name)] += e.time_range.elapsed_us() / 1e3
            calls[-1]["names"].append(e.name)
        if len(calls) == len(order) and all(
                sum(family[r] in n for n in c["names"]) == 1 for c, (_, r) in zip(calls, order)):
            return calls
        log("profiler", f"window {attempt + 1} of K4's routes held {len(calls)} of "
                        f"{len(order)} calls in order ({len(events)} device events, the first "
                        f"{[e.name[:40] for e in events[:3]]}); taking it again")
        return None

    run(order)
    torch.cuda.synchronize()
    out = [{r: [0.0, 0.0, 0.0] for r in routes} for _ in cases]
    for _ in range(reps // 2):
        calls = next((c for c in map(window, range(attempts)) if c is not None), None)
        if calls is None:
            break
        for c, (i, r) in zip(calls, order):
            for j, key in enumerate(("kernel", "fill", "cast")):
                out[i][r][j] += c[key] / (2 * (reps // 2))
    else:
        return out
    log("profiler", f"no window of K4's routes held every call in order in {attempts}; each "
                    f"route in a window of its own instead, in turns")
    out = [{r: [0.0, 0.0, 0.0] for r in routes} for _ in cases]
    for i, (flow, g, h_src, y0) in enumerate(cases):
        for r in routes + routes[::-1]:
            by_name = device_ms(lambda: ops.warp_dimages_route(flow, g, r, h_src, y0), reps)
            for name, ms in by_name.items():
                out[i][r][("kernel", "fill", "cast").index(part(name))] += ms / 2
    return out


def k4_c3_routes(card: str, where: str, cases: list, per: int, routes: tuple = K4_C3_ROUTES,
                 library_ms=None, twin_ms=None) -> dict:
    """K4 at C = 3 by `routes` on `cases` ((flow, g, h_src, y0), all
    bf16, C = 3; `per` launches of each a unit, a step): each route's f32
    image gradient within KERNEL_TOL[f32] of the largest value of the
    twin's (both sum in f32) and within K4_ROUTE_TOL of the quad tiles'
    (`ops.warp_dimages_routes`,
    which also counts the blocks that took the window route); then the
    routes in turns (`k4_route_turns`), per level and per unit: the
    kernel, its zero-fill and cast, and their sum, beside `library_ms`
    and `twin_ms` (the library call's and the twin's ms a unit, where
    given), and the seconds all this took. Returns per route (kernel,
    zero-fill, cast, sum) ms a unit."""
    from back2future_tpu_torch import ops

    began = time.time()
    tol = KERNEL_TOL[torch.float32]
    windowed = {r: [0, 0] for r in routes}
    worst = {r: 0.0 for r in routes}
    for flow, g, h_src, y0 in cases:
        twin = ops.warp_dimages_reference(flow, g.float(), h_src, y0)
        scale = max(1.0, twin.abs().max().item())
        got = {}
        for r in dict.fromkeys(routes + ("quads",)):
            got[r], n_window, blocks = ops.warp_dimages_routes(flow, g, r, h_src, y0)
            err = (got[r] - twin).abs().max().item()
            if r in windowed:
                windowed[r][0] += per * n_window
                windowed[r][1] += per * blocks
                worst[r] = max(worst[r], err)
            if err > tol * scale:
                raise AssertionError(f"K4 route {r} on {tuple(g.shape)} y0 {y0}: {err:.3e} off "
                                     f"the twin (tol {tol * scale:.3e})")
        ref = got["quads"]
        big = max(ref.abs().max().item(), 1e-30)
        for r in routes:
            if (got[r] - ref).abs().max().item() > K4_ROUTE_TOL * big:
                raise AssertionError(f"K4 route {r} on {tuple(g.shape)} y0 {y0}: off the quad "
                                     f"tiles' by more than {K4_ROUTE_TOL} of the largest value")
    times = k4_route_turns(cases, routes)
    levels = {}
    for (flow, g, _, _), t in zip(cases, times):
        key = "x".join(map(str, g.shape))
        for r in routes:
            acc = levels.setdefault(key, {}).setdefault(r, [0.0, 0.0, 0.0])
            for j in range(3):
                acc[j] += per * t[r][j]

    def words(ms: dict) -> str:
        return "; ".join(f"{r} {sum(v):.4f} (kernel {v[0]:.4f}, zero-fill {v[1]:.4f}, cast "
                         f"{v[2]:.4f})" for r, v in ms.items())

    for key, ms in levels.items():
        log("k4c3", f"{where}, level {key} (bf16, {per} launches a unit per input), ms a unit "
                    f"(profiler, in turns): {words(ms)}")
    total = {r: [sum(levels[k][r][j] for k in levels) for j in range(3)] for r in routes}
    lib = ""
    if library_ms is not None:
        below = "below" if sum(total[routes[0]]) < library_ms else "NOT below"
        lib = (f", aten.grid_sampler_2d_backward {library_ms:.4f} (the {routes[0]} route with "
               f"its zero-fill and cast {below} it)")
    if twin_ms is not None:
        lib += f", the twin {twin_ms:.4f}"
    log("k4c3", f"{where}, per unit ({len(cases)} inputs x {per}), ms (profiler, in turns): "
                f"{words(total)}{lib}; window-route blocks " + ", ".join(
                    f"{r} {n} of {b}" for r, (n, b) in windowed.items())
                + "; max_abs_err vs the twin " + ", ".join(
                    f"{r} {e:.3e}" for r, e in worst.items())
                + f"; {time.time() - began:.1f} s; on {card}")
    return {r: (*v, sum(v)) for r, v in total.items()}


# ------------------------------------------------------------------ SPyNet

def spynet_kernels(card: str, calls: list, dev) -> dict:
    """The gather, W-dflow and K4 on one SPyNet pme step's own warp inputs
    (`calls`: its 26 warps; K4 only where the images need a gradient),
    each call against its twin (KERNEL_TOL, the gradients relative to
    their largest value), then per step: the kernels', the twins' and the
    library calls' profiler device ms and the bound. The backward's
    upstream gradient is seeded noise of the warp's output shape."""
    from back2future_tpu_torch import ops

    rng = np.random.default_rng(6)
    grads = [torch.from_numpy(rng.standard_normal(img.shape).astype(np.float32)).to(dev, img.dtype)
             for img, _, _ in calls]

    grids = [grid_of(flow) for _, flow, _ in calls]
    which = {"warp_bilinear_fwd": list(range(len(calls))),
             "warp_bilinear_dflow": list(range(len(calls))),
             "warp_bilinear_dimages": [i for i, c in enumerate(calls) if c[2]]}

    def kernel(name, i, plain=False):
        img, flow, _ = calls[i]
        g = grads[i]
        if name == "warp_bilinear_fwd":
            return (ops.warp_bilinear_reference if plain else ops.warp_bilinear)(img, flow)
        if plain:
            return ops.warp_bilinear_backward_reference(img, flow, g)[
                int(name == "warp_bilinear_dflow")]
        if name == "warp_bilinear_dimages":
            return torch.ops.b2f.warp_dimages(flow, g)
        return torch.ops.b2f.warp_dflow(img, flow, g, True)

    def library(name, i):
        img, _, _ = calls[i]
        if name == "warp_bilinear_fwd":
            return F.grid_sample(nchw(img), grids[i], mode="bilinear", padding_mode="border",
                                 align_corners=True)
        mask = [name == "warp_bilinear_dimages", name == "warp_bilinear_dflow"]
        return torch.ops.aten.grid_sampler_2d_backward(nchw(grads[i]), nchw(img), grids[i],
                                                       0, 1, True, mask)

    def work(name, i):
        img, flow, _ = calls[i]
        extra = nbytes(flow) if name == "warp_bilinear_dflow" else 0
        return 8 * img.numel(), 2 * nbytes(img) + nbytes(flow) + extra

    summary = {}
    for name, idx in which.items():
        err, worst = 0.0, 0.0
        for i in idx:
            got, want = kernel(name, i).float(), kernel(name, i, plain=True).float()
            tol = KERNEL_TOL[calls[i][0].dtype]
            atol = tol if name == "warp_bilinear_fwd" else tol * max(1.0, want.abs().max().item())
            e = (got - want).abs().max().item()
            err = max(err, e)
            worst = max(worst, e / atol)
            if not torch.allclose(got, want, rtol=tol, atol=atol):
                img = calls[i][0]
                raise AssertionError(f"spynet {name} call {i} {tuple(img.shape)}: outside "
                                     f"tolerance ({e:.3e}, atol {atol:.3e})")
        ops_s = sum(work(name, i)[0] for i in idx) / PEAK_OPS_PER_S[calls[0][0].dtype]
        bytes_s = sum(work(name, i)[1] for i in idx) / HBM_BYTES_PER_S
        by_name = device_ms(lambda: [kernel(name, i) for i in idx], 10)
        ms = sum(by_name.values())
        plain_ms = device_total_ms(lambda: [kernel(name, i, plain=True) for i in idx], 3)
        lib_ms = device_total_ms(lambda: [library(name, i) for i in idx], 10)
        shapes = sorted({tuple(calls[i][0].shape) for i in idx}, key=lambda s: -s[1])
        summary[name] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=max(ops_s, bytes_s) * 1e3, bytes_ms=bytes_s * 1e3,
                             ops_ms=ops_s * 1e3, calls=len(idx))
        log("spynet", f"{name} on the pme step's own {len(idx)} inputs "
                      f"({', '.join('x'.join(map(str, s)) for s in shapes)}; "
                      f"{calls[0][0].dtype}): max_abs_err {err:.3e} (worst {worst:.3f} of its "
                      f"tolerance); per step (profiler device time) kernel {ms:.4f} ms, twin "
                      f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                      f"{summary[name]['bound_ms']:.4f} ms (the kernel's by name: " + ", ".join(
                          f"{n[:40]} {v:.4f}" for n, v in sorted(by_name.items(),
                                                                 key=lambda kv: -kv[1]))
                      + f"); on {card}")
    # K4 by its C = 3 route and by the quad tiles, in turns
    k4 = [(calls[i][1], grads[i], -1, 0) for i in which["warp_bilinear_dimages"]]
    s = summary["warp_bilinear_dimages"]
    summary["k4_routes"] = k4_c3_routes(card, "spynet pme step's own K4 inputs", k4, 1,
                                        library_ms=s["library_ms"], twin_ms=s["plain_ms"])
    return summary


def spynet_pme_inputs(dev) -> list:
    """The 26 warp inputs (images, flow, whether the images need a
    gradient) of the first bf16 SPyNet pme step (B=8 320x640, seed-0
    weights) on phase 10's batch, as `spynet_kernels` takes them."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    opt = train_options("bfloat16", soft=False, netType="spynet")
    net = spynet_network(opt, dev)
    step = make_train_step(net, opt, build_criterions(opt))
    calls = []
    with recording_gather_inputs(calls):
        train_steps("spynet pme", step, create_train_state(net, opt), train_batch(dev), 1,
                    SPY_PME_PER_STEP)
    return calls


def phase_k4_c3(card: str, dev) -> None:
    """K4's C = 3 routes against each other (K4_C3_ALL) on the SPyNet
    pme step's own 12 K4 inputs, per level and per step (`k4_c3_routes`),
    beside aten.grid_sampler_2d_backward's input gradient."""
    calls = spynet_pme_inputs(dev)
    rng = np.random.default_rng(6)
    grads = [torch.from_numpy(rng.standard_normal(img.shape).astype(np.float32)).to(dev, img.dtype)
             for img, _, _ in calls]
    k4 = [(img, flow, g) for (img, flow, need), g in zip(calls, grads) if need]
    grids = [grid_of(flow) for _, flow, _ in k4]
    lib = device_total_ms(lambda: [torch.ops.aten.grid_sampler_2d_backward(
        nchw(g), nchw(img), grid, 0, 1, True, [True, False]) for (img, _, g), grid in zip(k4, grids)],
        10)
    k4_c3_routes(card, "spynet pme step's own K4 inputs", [(flow, g, -1, 0) for _, flow, g in k4],
                 1, K4_C3_ALL, lib)


def spynet_network(opt, dev):
    """SPyNet of `opt` with weights from seed 0, on `dev`."""
    from back2future_tpu_torch.models import SPyNet, spynet_config_from_options

    return SPyNet(spynet_config_from_options(opt),
                  generator=torch.Generator().manual_seed(0)).to(dev)


def phase_spynet(card: str, dev) -> dict:
    """netType spynet on the card (module docstring, phase 10): the bf16
    serving forward, the pme and epe steps with exact launch counts, f32
    steps against plain_ops(), the warp kernels on the step's own inputs,
    and run() / the eval CLI / init's refusal. Returns the launches of its
    pme steps and the kernels' per-step summary."""
    import collections
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch import api, ops
    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.data import load_split, roaming
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.models import SPyNet
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import create_train_state, loop, make_train_step

    phase_t0 = time.perf_counter()
    # serving forward, bf16, B=16 at the snapped KITTI size
    opt = Options(netType="spynet", compute_dtype="bfloat16").derive()
    net = spynet_network(opt, dev).eval()
    cfg = net.cfg
    assert (cfg.frames, cfg.levels, cfg.dtype) == (3, 7, torch.bfloat16), cfg
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, H, W, 9), dtype=np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_launches()
        got = net(x, with_warped=False)
        if counts() != SPY_SERVING_PER_FORWARD:
            raise AssertionError(f"spynet serving forward launched {counts()}, expected "
                                 f"{SPY_SERVING_PER_FORWARD}")
        serving_launches = counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        with ops.plain_ops():
            want = net(x, with_warped=False)
        if counts() != serving_launches:
            raise AssertionError("spynet: plain_ops() launched kernels")
        fwd_ms = cuda_ms(lambda: net(x, with_warped=False), 5)
    flow, flow_p = got[0]["flow"].float(), want[0]["flow"].float()
    occ, occ_p = got[0]["occ"].float(), want[0]["occ"].float()
    if len(got) != cfg.levels or flow.shape != (B, H, W, 2) or not torch.isfinite(flow).all() \
            or not torch.isfinite(occ).all():
        raise AssertionError(f"spynet serving forward: {len(got)} levels, flow {flow.shape}")
    scale = flow_p.abs().max().item()
    flow_err = (flow - flow_p).abs().max().item()
    occ_diff = ((occ[..., 1] >= api.OCC_THRESHOLD) != (occ_p[..., 1] >= api.OCC_THRESHOLD)) \
        .float().mean().item()
    log("spynet", f"serving forward bf16 B={B} {H}x{W} (frames 3, levels 7, seed-0 weights): "
                  f"launches {SPY_SERVING_PER_FORWARD['b2f_warp_bilinear_fwd']} gathers and no "
                  f"other kernel; finest flow vs plain_ops() max_abs_err {flow_err:.3e} (tol "
                  f"{FLOW_TOL_FRAC} x max|flow| = {FLOW_TOL_FRAC * scale:.3e}), forward "
                  f"occlusion mask differs on {occ_diff:.2e} of pixels (tol {OCC_TOL}); "
                  f"{fwd_ms:.2f} ms (CUDA events, median of 5), peak device memory "
                  f"{peak / 2**30:.2f} GiB; on {card}")
    if flow_err > FLOW_TOL_FRAC * scale or occ_diff > OCC_TOL:
        raise AssertionError("spynet: the serving forward disagrees with plain_ops()")
    del net, got, want, x

    # the pme hard recipe, bf16, B=8 at 320x640, from the weights of seed 0
    opt = train_options("bfloat16", soft=False, netType="spynet")
    batch = train_batch(dev)
    net = spynet_network(opt, dev)
    step = make_train_step(net, opt, build_criterions(opt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, values, times = train_steps("spynet pme", step, create_train_state(net, opt), batch,
                                       TRAIN_STEPS, SPY_PME_PER_STEP)
    pme_launches = counts()
    step_ms = statistics.median(times[1:])
    log("spynet", f"pme {opt.pme_criterion} {TRAIN_STEPS} bf16 steps B={TRAIN_B} "
                  f"{TRAIN_H}x{TRAIN_W}: loss {['%.4f' % v for v in values['loss']]}; step "
                  f"{TRAIN_STEPS} components " + ", ".join(
                      f"{k} {v[-1]:.5g}" for k, v in values.items() if k != "loss")
                  + f"; launches a step gather {SPY_PME_PER_STEP['b2f_warp_bilinear_fwd']}, K4 "
                  f"{SPY_PME_PER_STEP['b2f_warp_bilinear_dimages']}, W-dflow "
                  f"{SPY_PME_PER_STEP['b2f_warp_bilinear_dflow']}, nothing else ({pme_launches} "
                  f"over the steps)")
    log("spynet", f"pme bf16 train step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: {step_ms:.2f} ms (CUDA "
                  f"events, median of steps 2-{TRAIN_STEPS}; all {['%.2f' % t for t in times]}), "
                  f"{TRAIN_B / step_ms * 1e3:.2f} triplets/s trained, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}")
    # the warp kernels on the first step's own inputs
    calls = spynet_pme_inputs(dev)
    if len(calls) != SPY_PME_PER_STEP["b2f_warp_bilinear_fwd"] or sum(
            c[2] for c in calls) != SPY_PME_PER_STEP["b2f_warp_bilinear_dimages"]:
        raise AssertionError(f"spynet: recorded {len(calls)} warps, "
                             f"{sum(c[2] for c in calls)} with image gradients")
    summary = spynet_kernels(card, calls, dev)
    del calls, state, step, net
    f32_step_vs_plain("spynet pme", train_options("float32", soft=False, netType="spynet"),
                      batch, dev)

    # one epe step on seeded ground truth
    opt = train_options("bfloat16", soft=False, netType="spynet", optimize="epe", epe=1.0)
    gt_batch = train_batch(dev, ground_truth=True)
    net = spynet_network(opt, dev)
    reset_launches()
    _, values, times = train_steps("spynet epe", make_train_step(net, opt, build_criterions(opt)),
                                   create_train_state(net, opt), gt_batch, 1, SPY_EPE_PER_STEP)
    log("spynet", f"epe bf16 step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: loss {values['loss'][0]:.4f}, "
                  f"sup_flow {values['sup_flow'][0]:.5g}, sup_occ {values['sup_occ'][0]:.5g}; "
                  f"launches gather {SPY_EPE_PER_STEP['b2f_warp_bilinear_fwd']}, K4 0, W-dflow "
                  f"{SPY_EPE_PER_STEP['b2f_warp_bilinear_dflow']}; {times[0]:.2f} ms (the first "
                  f"step, CUDA events)")
    del net
    f32_step_vs_plain("spynet epe", train_options("float32", soft=False, netType="spynet",
                                                  optimize="epe", epe=1.0), gt_batch, dev)

    # run() from files, the eval CLI, and init's refusal
    with tempfile.TemporaryDirectory(prefix="b2f_spynet_") as tmp:
        root = Path(tmp)
        roaming.main(["--out", str(root / "set"), "--n", str(SPY_SCENES), "--height",
                      str(TRAIN_H), "--width", str(TRAIN_W), "--frames", "3", "--seed", "0",
                      "--val_fraction", str(LOOP_VAL_FRACTION)])
        datasets = root / "set" / "datasets"
        n_val = len(load_split(datasets / "RoamingImages_split.dat")[1])
        opt = Options(netType="spynet", batchSize=TRAIN_B, dataset="RoamingImages",
                      datasets_dir=str(datasets), data_root=str(root / "set" / "data"),
                      cache=str(root / "cache"), expName="spynet", epochSize=2, nEpochs=1,
                      epochStore=1, nDonkeys=0, **LOOP_OPTIONS).derive(make_dirs=True)
        save = Path(opt.save)
        seen = collections.defaultdict(list)

        def refuse_load(state):
            raise AssertionError("spynet run() loaded a checkpoint")

        t0 = time.perf_counter()
        with watching_run(loop, seen, refuse_load):
            trained = loop.run(opt)
        run_s = time.perf_counter() - t0
        bad = [got for got in seen["train"] if got != SPY_PME_PER_STEP] + [
            got for got in seen["eval"] if got != SPY_EVAL_PER_STEP]
        if trained.step != 2 or len(seen["eval"]) != -(-n_val // TRAIN_B) or bad:
            raise AssertionError(f"spynet run(): step {trained.step}, {len(seen['eval'])} eval "
                                 f"steps, launches {bad[:1]}")
        missing = [f for f in ("model_1.pt", "optimState_1.pt", "options.json", "train.log",
                               "test.log") if not (save / f).is_file()]
        if missing or not isinstance(trained.model, SPyNet):
            raise AssertionError(f"spynet run(): missing {missing}")
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "back2future_tpu_torch.eval", "--checkpoint",
                              str(save), "--dataset", "RoamingImages", "--datasets_dir",
                              str(datasets), "--data_root", str(root / "set" / "data"),
                              "--batchSize", str(TRAIN_B), "--cropHeight", str(TRAIN_H),
                              "--cropWidth", str(TRAIN_W)], cwd=here,
                             env=dict(os.environ, PYTHONPATH=here), capture_output=True,
                             text=True, timeout=300)
        if res.returncode:
            raise AssertionError(f"spynet: the eval CLI exited {res.returncode}: {res.stderr}")
        metrics = json.loads(res.stdout.strip().splitlines()[-1])
        if metrics["n_samples"] != n_val or not np.isfinite(list(metrics.values())).all():
            raise AssertionError(f"spynet: eval CLI {metrics}")
        eval_s = time.perf_counter() - t0
        try:
            api.init(str(save), device=dev)
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError("spynet: init(<save dir>) served a SPyNet checkpoint")
        if "serves the PWC family only" not in refusal:
            raise AssertionError(f"spynet: init's error {refusal!r}")
        log("spynet", f"run() netType spynet, 1 epoch x 2 steps (B={TRAIN_B} {TRAIN_H}x{TRAIN_W} "
                      f"bf16, {SPY_SCENES - n_val} train / {n_val} val scenes, the synchronous "
                      f"loader): {run_s:.1f} s; every train step launched gather / K4 / W-dflow "
                      f"{SPY_PME_PER_STEP['b2f_warp_bilinear_fwd']} / "
                      f"{SPY_PME_PER_STEP['b2f_warp_bilinear_dimages']} / "
                      f"{SPY_PME_PER_STEP['b2f_warp_bilinear_dflow']}, every eval step "
                      f"{SPY_EVAL_PER_STEP['b2f_warp_bilinear_fwd']} gathers; model_1.pt written; "
                      f"the eval CLI ({eval_s:.1f} s): {metrics}; init(<save dir>) refuses it: "
                      f"{refusal}")
    log("spynet", f"phase took {time.perf_counter() - phase_t0:.1f} s")
    return {"launches": pme_launches, "summary": summary, "step_ms": step_ms}


def pwc_t7_tree(net) -> dict:
    """A PWCNet's weights as a Torch7 nn.gModule module tree in the
    reference's construction order (models/pwc.lua:87-508): the frame-1
    pyramid convs, value-equal copies of them for frames 2..F (the
    reference's clones), then per level coarsest -> finest the occlusion,
    flow and past-flow decoders; weights OIHW float32."""
    cfg = net.cfg
    params = {n: p.detach().float().cpu().numpy() for n, p in net.named_parameters()}

    def conv(prefix):
        w = params[prefix + ".weight"]
        return {"torch_type": "cudnn.SpatialConvolution", "weight": w,
                "bias": params[prefix + ".bias"], "nInputPlane": w.shape[1],
                "nOutputPlane": w.shape[0], "kW": w.shape[3], "kH": w.shape[2],
                "dW": 1, "dH": 1, "padW": w.shape[3] // 2, "padH": w.shape[2] // 2}

    pyramid = [conv(f"feat_{l}.{c}") for l in range(2, cfg.levels + 1) for c in ("c0", "c1")]
    mods = list(pyramid)
    for _ in range(cfg.frames - 1):
        mods += [dict(m, weight=m["weight"].copy(), bias=m["bias"].copy()) for m in pyramid]
    for l in range(cfg.levels, cfg.l_st - 1, -1):
        decoders = (["occ"] if cfg.frames > 2 else []) + ["flow"] + (
            ["past"] if cfg.past_flow else [])
        for d in decoders:
            mods += [conv(f"{d}_decoder_{l}.{c}") for c in ("c0", "c1", "c2", "c3", "c4", "out")]
    return {"torch_type": "nn.DataParallelTable",
            "modules": [{"torch_type": "nn.gModule", "modules": mods}]}


def phase_t7(card: str, dev) -> None:
    """.t7 conversion on the card (module docstring, phase 11): a seeded
    flagship PWCNet, with and without the past-flow decoders, written as
    a reference module tree by the port's save_t7, converted by
    `python -m back2future_tpu_torch.convert_t7` (the two conversions in
    two processes at once), served by init(out): compute_flow_batch at
    B=16 on 1242x375 frames equals the seeded net's own forward bit for
    bit, with 10 K1 and 8 gather launches."""
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch import api
    from back2future_tpu_torch.io import save_t7
    from back2future_tpu_torch.models import PWCConfig, PWCNet
    from back2future_tpu_torch.runtime import reset_launches

    phase_t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(8)
    frames = [rng.random((B, H_IN, W_IN, 3), dtype=np.float32) for _ in range(3)]
    imgs, n, h, w = api._preprocess_triplets(frames, 3)
    x = torch.from_numpy(imgs).to(dev)
    with tempfile.TemporaryDirectory(prefix="b2f_t7_") as tmp:
        runs = {}
        for past_flow in (False, True):
            seeded = PWCNet(PWCConfig(dtype=torch.bfloat16, past_flow=past_flow),
                            generator=torch.Generator().manual_seed(11)).to(dev).eval()
            t7 = Path(tmp) / f"model_past{int(past_flow)}.t7"
            out = Path(tmp) / f"out_past{int(past_flow)}"
            t0 = time.perf_counter()
            save_t7(t7, pwc_t7_tree(seeded))
            write_s = time.perf_counter() - t0
            proc = subprocess.Popen([sys.executable, "-m", "back2future_tpu_torch.convert_t7",
                                     str(t7), str(out), "--past_flow", str(int(past_flow))],
                                    cwd=here, env=dict(os.environ, PYTHONPATH=here),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            runs[past_flow] = (seeded, t7, out, write_s, proc, time.perf_counter())
        done = {}
        try:
            for k, r in runs.items():   # each conversion's wall time from its start
                done[k] = (*r[4].communicate(timeout=300), time.perf_counter() - r[5])
        finally:
            for r in runs.values():
                r[4].kill()
        for past_flow, (seeded, t7, out, write_s, proc, _) in runs.items():
            stdout, stderr, convert_s = done[past_flow]
            if proc.returncode:
                raise AssertionError(f"t7: convert_t7 exited {proc.returncode}: {stderr}")
            est = api.init(str(out), device=dev)
            if est.config != seeded.cfg:
                raise AssertionError(f"t7: init(out) config {est.config} != {seeded.cfg}")
            reset_launches()
            got = est.compute_flow_batch(*frames)
            if counts() != SERVING_PER_FORWARD:
                raise AssertionError(f"t7: init(out) serving launched {counts()}, expected "
                                     f"{SERVING_PER_FORWARD}")
            check_results(got, B)
            with torch.inference_mode():
                want = seeded(x, with_warped=False)[0]
                mine = est.net(x, with_warped=False)[0]
            ref = api._postprocess_results(want["flow"].float().cpu().numpy(),
                                           want["occ"].float().cpu().numpy(), n, h, w)
            if not (torch.equal(mine["flow"], want["flow"]) and torch.equal(mine["occ"], want["occ"])
                    and all(np.array_equal(a, b) for a, b in zip(got, ref))):
                raise AssertionError("t7: the converted net's flow differs from the seeded net's")
            log("t7", f"flagship PWCNet past_flow {int(past_flow)} (seed 11): .t7 of "
                      f"{t7.stat().st_size} bytes written by save_t7 in {write_s:.2f} s, "
                      f"convert_t7 CLI {convert_s:.1f} s ({stdout.strip()}); init(out) "
                      f"compute_flow_batch B={B} {H_IN}x{W_IN}: launches "
                      f"{SERVING_PER_FORWARD['b2f_cost_volume_fwd']} K1 + "
                      f"{SERVING_PER_FORWARD['b2f_warp_bilinear_fwd']} gathers, flow and "
                      f"occlusion bit-identical to the seeded net's own forward; on {card}")
    log("t7", f"phase took {time.perf_counter() - phase_t0:.1f} s")


SPY_KERNEL_ENTRIES = [   # (name, source, replaces) of the SPyNet path's kernels
    ("warp_bilinear_fwd", "warp_fwd_tiled.cu", "back2future_tpu/ops/warp.py:96"),
    ("warp_bilinear_dimages", "warp_bwd_tiled.cu", "back2future_tpu/ops/warp_pallas.py:81"),
    ("warp_bilinear_dflow", "warp_bwd_tiled.cu", "back2future_tpu/ops/warp.py:209"),
]
KERNEL_ENTRIES = [   # (name, summary key, source, replaces, path whose launches count)
    ("cost_volume_fwd", "cost_volume", "cost_volume_fwd_mma.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:91", "serving"),
    ("warp_bilinear_fwd", "warp", "warp_fwd_tiled.cu", "back2future_tpu/ops/warp.py:96",
     "serving"),
    ("cost_volume_dref", "cost_volume_dref", "cost_volume_bwd_mma.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:175", "train"),
    ("cost_volume_dframe", "cost_volume_dframe", "cost_volume_bwd_mma.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:203", "train"),
    ("warp_bilinear_dimages", "warp_dimages", "warp_bwd_tiled.cu",
     "back2future_tpu/ops/warp_pallas.py:81", "train"),
    ("warp_bilinear_dflow", "warp_dflow", "warp_bwd_tiled.cu",
     "back2future_tpu/ops/warp.py:209", "train"),
    ("stem_unit_a", "stem_unit_a", "stem_unit_a_mma.cu",
     "back2future_tpu/ops/stem_pallas.py:264",
     "soft"),
    ("stem_unit_b", "stem_unit_b", "stem_unit_b_mma.cu",
     "back2future_tpu/ops/stem_pallas.py:307", "soft"),
]


# ------------------------------------------------ phase 12: serving export

EXPORT_SEED = 7                        # the B=16 requests served eager and exported
EXPORT_REPS = 10                       # CUDA-event reps of a timed forward
EXPORT_STEPS = 20                      # hard steps timed a turn
OP_CALLS = 200                         # host-timed calls of an op a turn
SERVE_BENCH_ITERS = 5                  # serve_bench's --iters
# (tree, then the other): parent / this tree / this tree / parent, twice
TREE_TURNS = ("parent", "pr", "pr", "parent") * 2
EXPORT_TURNS = ("eager", "exported", "exported", "eager") * 2
SERVE_BENCH_KEYS = {"warmup_s", "total_ms", "pre_ms", "forward_ms", "fetch_ms", "post_ms"}


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def serving_input(dev) -> torch.Tensor:
    """The seeded (B, H, W, 9) input of the digests and the forward A/Bs."""
    return torch.from_numpy(np.random.default_rng(EXPORT_SEED).standard_normal(
        (B, H, W, 9), dtype=np.float32)).to(dev)


def export_requests() -> list:
    """The seeded B=16 KITTI-sized requests (one stack per frame) served
    eager and exported."""
    rng = np.random.default_rng(EXPORT_SEED)
    return [rng.random((B, H_IN, W_IN, 3), dtype=np.float32) for _ in range(3)]


def tree_worker(build_dir: str) -> None:
    """A worker process of phase 12, importing the package of one tree
    (its root first on sys.path; `TreeWorker` starts it) with its kernel
    library looked up in `build_dir`, this tree's build directory (a tree
    whose kernel sources are this tree's finds the library built; another
    builds its own there, and nothing is written into its tree): the flagship
    estimator (seed 0) and the hard bf16 step at B=8 320x640 (weights of
    seed 0), then commands from stdin, each answered by one `@@`-prefixed
    JSON line: `digests DIR` (SHA-256 of the serving forward's finest
    (flow, occ) on the seeded input; of the hard step's loss and every
    parameter gradient, twice from the same initial state, the gradients
    also saved to DIR), `time` (the serving forward's and the hard step's
    ms, CUDA events, medians of EXPORT_REPS forwards and EXPORT_STEPS
    steps after a warm-up; and the host µs a call of the cost volume and
    of the warp at a tiny bf16 shape, forward alone under inference mode
    and forward + backward, OP_CALLS calls ending in a synchronise),
    `quit`."""
    from pathlib import Path

    import back2future_tpu_torch
    from back2future_tpu_torch.runtime import cuda_build

    cuda_build.BUILD_DIR = Path(build_dir)
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.api import init
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    est = init(None, device="cuda", seed=0)
    x = serving_input(dev)
    opt = train_options("bfloat16", soft=False)
    batch = train_batch(dev)
    net = train_network(opt, dev)
    init_state = {k: v.clone() for k, v in net.state_dict().items()}
    crits = build_criterions(opt)

    def answer(obj):
        print("@@" + json.dumps(obj), flush=True)

    def forward():
        out = est.net(x, with_warped=False)[0]
        return out["flow"], out["occ"]

    def tiny(seed, c=32, grad=True):
        g = torch.Generator(device=dev).manual_seed(seed)
        t = torch.randn((1, 8, 16, c), generator=g, device=dev).to(torch.bfloat16)
        return t.requires_grad_(grad)

    ref, frame, images, flow = tiny(1), tiny(2), tiny(3), tiny(4, c=2)
    calls = {"cost_volume": lambda: ops.cost_volume(ref, frame, 9, 1, True, 0.1),
             "warp_bilinear": lambda: ops.warp_bilinear(images, flow)}

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / OP_CALLS * 1e6

    def op_us() -> dict:
        out = {}
        for name, fn in calls.items():
            with torch.inference_mode():
                out[f"{name} forward"] = host_us(fn)
            out[f"{name} forward+backward"] = host_us(lambda: fn().sum().backward())
        return out

    answer({"package": back2future_tpu_torch.__file__})
    state = step = None
    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "digests":
            with torch.inference_mode():
                serve = digest(forward())
            losses, grads = [], []
            for run in range(2):
                net.load_state_dict(init_state)
                _, logs = make_train_step(net, opt, crits)(create_train_state(net, opt), batch)
                named = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
                torch.save({n: g.cpu() for n, g in named.items()}, f"{cmd[1]}/grads{run}.pt")
                losses.append(digest([logs["loss"]]))
                grads.append(digest(named[n] for n in sorted(named)))
            answer({"serve": serve, "loss": losses, "grads": grads})
        elif cmd[0] == "time":
            if state is None:
                net.load_state_dict(init_state)
                state = create_train_state(net, opt)
                step = make_train_step(net, opt, crits)
            with torch.inference_mode():
                serve_ms = cuda_ms(forward, EXPORT_REPS)
            state, _ = step(state, batch)
            times = []
            for _ in range(EXPORT_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, _ = step(state, batch)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            answer({"serve_ms": serve_ms, "step_ms": statistics.median(times), **op_us()})
        elif cmd[0] == "quit":
            return


def tree_process(root, entry: str, *args, **popen) -> subprocess.Popen:
    """A `python` process that imports this script as a module and calls
    `entry(*args)` with `root` first on sys.path, so that it imports the
    package of the tree at `root` (PYTHONPATH cleared)."""
    code = ("import importlib.util, sys\n"
            f"sys.path.insert(0, {str(root)!r})\n"
            f"spec = importlib.util.spec_from_file_location('chip_smoke', "
            f"{os.path.abspath(__file__)!r})\n"
            "module = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(module)\n"
            f"module.{entry}(*{args!r})\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(root), env=env, **popen)


class TreeWorker:
    """`tree_worker` in its own process for the tree at `root`."""

    def __init__(self, label: str, root):
        self.label = label
        from back2future_tpu_torch.runtime.cuda_build import BUILD_DIR

        self.proc = tree_process(root, "tree_worker", str(BUILD_DIR), stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, text=True)

    def ask(self, command: str = "") -> dict:
        """Send `command` (none: read the greeting) and return the answer."""
        if command:
            self.proc.stdin.write(command + "\n")
            self.proc.stdin.flush()
        for line in self.proc.stdout:
            if line.startswith("@@"):
                return json.loads(line[2:])
            log("export", f"{self.label} worker: {line.rstrip()}")
        raise RuntimeError(f"the {self.label} worker ended with code {self.proc.wait()}")

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def parent_tree(argv: list):
    """The tree that `--parent DIR` names, or None."""
    from pathlib import Path

    if "--parent" not in argv:
        return None
    return Path(argv[argv.index("--parent") + 1]).resolve()


# opcheck's eager-vs-AOT comparison (rtol, atol): torch's defaults for bf16;
# in f32 a relative 1e-5 (torch's default 1.3e-6), since K4's atomics sum
# in an order that varies from run to run. cuDNN's weight gradients in the
# stem twin's backward (a sum of 1.2M-4.7M products a weight at the
# main-path shapes) vary too unless cuDNN is held to deterministic
# algorithms, as it is for the opchecks
OPCHECK_TOL = {torch.bfloat16: (None, None), torch.float32: (1e-5, 1e-5)}


def phase_opcheck(card: str, dev) -> None:
    """torch.library.opcheck of every b2f op on CUDA tensors, bf16 and
    f32, at a small shape and at a main-path shape, with cuDNN held to
    deterministic algorithms (OPCHECK_TOL)."""
    # (cost volume, warp, stem input without its channels)
    shapes = {"small": ((2, 9, 37, 32), (2, 9, 37, 32), (1, 16, 64)),
              "main path": ((B, *LEVEL_SHAPES[0]), (TRAIN_B, *TRAIN_LEVELS[0]),
                            STEM_SHAPES["serving"])}
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for size, (cv, wp, st) in shapes.items():
            for dtype in (torch.bfloat16, torch.float32):
                opcheck_cases(f"{size} shapes (cost volume {cv}, warp {wp}, stem {st})",
                              opcheck_args(cv, wp, st, dtype, gen, dev), dtype)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("export", f"opcheck: {time.perf_counter() - t0:.1f} s on {card}")


def opcheck_args(cv: tuple, wp: tuple, st: tuple, dtype, gen, dev) -> dict:
    """The arguments of each b2f op: cost volume inputs of shape `cv`,
    warp inputs `wp`, stem input `st` (N, H, W); seeded by `gen`."""
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.models import ConvUnit

    def rand(shape, scale=1.0, grad=False):
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale
        return t.to(dtype).requires_grad_(grad)

    unit2, unit3 = ConvUnit(3, 16, stride=2).to(dev), ConvUnit(16, 32, stride=2).to(dev)
    g_cv = rand(cv[:3] + (WIN * WIN,))
    images, flow, g_w = rand(wp), rand(wp[:3] + (2,), 3.0), rand(wp)
    return {
        "cost_volume": (rand(cv, grad=True), rand(cv, grad=True), WIN, 2, False, 1.0 / cv[-1]),
        "cost_volume_dref": (g_cv, rand(cv), WIN, 1, True, 0.5),
        "cost_volume_dframe": (g_cv, rand(cv), WIN, 1, False, 0.5),
        "warp_bilinear": (images.clone().requires_grad_(), flow.clone().requires_grad_(), True),
        "warp_dimages": (flow, g_w),
        "warp_dflow": (images, flow, g_w, False),
        "stem": (rand((*st, 3), grad=True), *ops.unit_params(unit2), *ops.unit_params(unit3)),
    }


def opcheck_cases(label: str, cases: dict, dtype) -> None:
    rtol, atol = OPCHECK_TOL[dtype]
    for name, args in cases.items():
        result = torch.library.opcheck(getattr(torch.ops.b2f, name).default, args, rtol=rtol,
                                       atol=atol)
        if set(result.values()) != {"SUCCESS"}:
            raise AssertionError(f"opcheck b2f::{name}: {result}")
    log("export", f"opcheck of {len(cases)} ops on CUDA tensors, {label}, {str(dtype)[6:]} "
                  f"(rtol, atol {OPCHECK_TOL[dtype]}; None: torch's): all "
                  f"{', '.join(sorted(result))} pass")


def compare_grad_files(tmp: str) -> None:
    """The hard step's gradients of the parent and this tree, two runs
    each from one state. K4's f32 atomics add in an order that varies
    from run to run, so a tree's two runs differ in some parameters and
    no gradient digest need repeat, not even the parent's own. The
    largest difference (max_abs_err / max|g| of a parameter) between the
    trees must stay within GRAD_SPREAD_FACTOR times the largest between a
    tree's own two runs; the counts of parameters bit-identical within
    each tree and across the trees are reported beside them."""
    runs = {(tree, run): torch.load(f"{tmp}/{tree}/grads{run}.pt")
            for tree in ("parent", "pr") for run in range(2)}
    names = sorted(runs["parent", 0])

    def ratio(a, b):
        return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)

    within = {t: [n for n in names if torch.equal(runs[t, 0][n], runs[t, 1][n])]
              for t in ("parent", "pr")}
    across = [n for n in names if all(torch.equal(runs["pr", r][n], runs["parent", r][n])
                                      for r in range(2))]
    within_max = max(ratio(runs[t, 0][n], runs[t, 1][n]) for t in ("parent", "pr") for n in names)
    ratios = {n: max(ratio(runs["pr", r][n], runs["parent", r][n]) for r in range(2))
              for n in names}
    worst = max(ratios, key=ratios.get)
    log("export", f"hard step gradients, {len(names)} parameters: bit-identical in both runs "
                  f"of the parent {len(within['parent'])}, of this tree {len(within['pr'])}, "
                  f"across the trees (both runs) {len(across)}; worst max_abs_err / max|g| "
                  f"{within_max:.3e} between a tree's two runs, {ratios[worst]:.3e} across the "
                  f"trees ({worst}; tol {GRAD_SPREAD_FACTOR} x {within_max:.3e})")
    if ratios[worst] > GRAD_SPREAD_FACTOR * within_max:
        raise AssertionError(f"the hard step's gradients differ from the parent's: {worst}")


def phase_parent(card: str, argv: list, tmp: str) -> None:
    """This tree against the parent commit's, each in its own worker
    process on this card: the digests of the eager serving forward and of
    the hard step, then the serving forward's and the hard step's ms in
    turns (parent / this / this / parent, twice)."""
    from pathlib import Path

    parent = parent_tree(argv)
    if parent is None:
        log("export", "parent tree: none (no --parent DIR); the parent comparison is not run")
        return
    workers = {}
    try:
        for label, root in (("parent", parent), ("pr", Path(__file__).resolve().parent)):
            workers[label] = TreeWorker(label, root)
        for label, root in (("parent", parent), ("pr", Path(__file__).resolve().parent)):
            package = workers[label].ask()["package"]
            if not Path(package).resolve().is_relative_to(root):
                raise AssertionError(f"the {label} worker imported {package}, not {root}'s")
        digests = {}
        for label, worker in workers.items():
            os.makedirs(f"{tmp}/{label}")
            digests[label] = worker.ask(f"digests {tmp}/{label}")
            d = digests[label]
            log("export", f"{label} tree SHA-256: serving forward B={B} {H}x{W} (flow, occ) "
                          f"{d['serve']}; hard step B={TRAIN_B} {TRAIN_H}x{TRAIN_W} loss "
                          f"{d['loss'][0]} / {d['loss'][1]}, gradients {d['grads'][0]} / "
                          f"{d['grads'][1]} (two runs)")
        if digests["parent"]["serve"] != digests["pr"]["serve"]:
            raise AssertionError("the serving forward's digest differs from the parent's")
        if len({*digests["parent"]["loss"], *digests["pr"]["loss"]}) != 1:
            raise AssertionError("the hard step's loss digest differs from the parent's")
        log("export", "serving forward and hard-step loss: bit-identical to the parent's")
        compare_grad_files(tmp)
        times = [(label, workers[label].ask("time")) for label in TREE_TURNS]
        whats = {"serve_ms": f"serving forward B={B} {H}x{W} bf16, ms (CUDA events, medians "
                             f"of {EXPORT_REPS})",
                 "step_ms": f"hard bf16 step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}, ms (CUDA events, "
                            f"medians of {EXPORT_STEPS})"}
        for key in times[0][1]:
            what = whats.get(key, f"{key} at 1x8x16 bf16, host µs a call (means of {OP_CALLS})")
            med = {side: statistics.median(t[key] for label, t in times if label == side)
                   for side in ("parent", "pr")}
            log("export", f"{what}, the parent tree vs this one, "
                          + " / ".join(label for label, _ in times) + ": "
                          + " / ".join(f"{t[key]:.3f}" for _, t in times)
                          + f"; median parent {med['parent']:.3f}, this tree {med['pr']:.3f} "
                          f"({med['pr'] - med['parent']:+.3f}) on {card}")
    finally:
        for worker in workers.values():
            worker.close()


def serve_exported(art: str, out: str) -> None:
    """The serving process of phase 12 (started by `tree_process`): loads
    the artifact on the card, serves the seeded B=16 requests twice with
    the launch counts of each call, saves the second call's results to
    `out` and prints one `@@` JSON line of times and counts."""
    t0 = time.perf_counter()
    from back2future_tpu_torch.api import _bucket, load_exported
    from back2future_tpu_torch.runtime import reset_launches

    served = load_exported(art, device="cuda")
    served.module(_bucket((B, H_IN, W_IN)))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    requests = export_requests()
    launches, walls = [], []
    for _ in range(2):
        reset_launches()
        t0 = time.perf_counter()
        res = served.compute_flow_batch(*requests)
        walls.append(time.perf_counter() - t0)
        launches.append({k: v for k, v in counts().items() if v})
    np.savez(out, flow=res[0], fwd=res[1], bwd=res[2])
    models = sorted(m for m in sys.modules if m.startswith("back2future_tpu_torch.models"))
    print("@@" + json.dumps({"load_s": load_s, "first_call_s": walls[0], "second_call_s": walls[1],
                             "launches": launches, "models": models}), flush=True)


def phase_serving_export(card: str, dev, argv: list) -> None:
    """Phase 12, serving export (module docstring); `argv` may name the
    parent commit's tree (`--parent DIR`)."""
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch.api import _bucket, init
    from back2future_tpu_torch.runtime import reset_launches

    t_phase = time.perf_counter()
    phase_opcheck(card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_parent(card, argv, tmp)

        est = init(None, device="cuda", seed=0)
        art = Path(tmp) / "artifact"
        bucket = _bucket((B, H_IN, W_IN))
        t0 = time.perf_counter()
        est.export(art, [(B, H_IN, W_IN)])
        export_s = time.perf_counter() - t0
        mib = sum(p.stat().st_size for p in art.iterdir()) / 2**20
        log("export", f"exported the flagship (bf16, seed 0) at bucket {bucket}: {export_s:.2f} s, "
                      f"artifact {mib:.2f} MiB ({', '.join(sorted(p.name for p in art.iterdir()))})")
        proc = tree_process(Path(__file__).resolve().parent, "serve_exported", str(art),
                            f"{tmp}/served.npz", stdout=subprocess.PIPE, text=True)
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the serving process failed with code {proc.returncode}")
        served = json.loads(next(line for line in out.splitlines() if line.startswith("@@"))[2:])
        want_calls = {k: v for k, v in SERVING_PER_FORWARD.items() if v}
        if served["launches"] != [want_calls] * 2:
            raise AssertionError(f"the exported forward launched {served['launches']}, "
                                 f"expected {want_calls} a call")
        if served["models"]:
            raise AssertionError(f"the serving process imported {served['models']}")
        got = np.load(f"{tmp}/served.npz")
        want = est.compute_flow_batch(*export_requests())
        same = [np.array_equal(got[k], w) for k, w in zip(("flow", "fwd", "bwd"), want)]
        log("export", f"a fresh process served the artifact on the card: load {served['load_s']:.2f} s, "
                      f"first call {served['first_call_s']:.2f} s, second "
                      f"{served['second_call_s']:.2f} s (B={B} {H_IN}x{W_IN}, host pre/post-"
                      f"processing included); launches a call {served['launches'][1]}; no module "
                      f"of back2future_tpu_torch.models imported; flow, fwd_occ, bwd_occ equal to "
                      f"eager compute_flow_batch bit for bit: {same}")
        if not all(same):
            raise AssertionError("the exported forward's results differ from eager's")

        module = torch.export.load(art / f"forward_{B}x{H}x{W}.pt2").module()
        x = serving_input(dev)
        with torch.inference_mode():
            g = est.net(x, with_warped=False)[0]
            eager_out = (g["flow"], g["occ"])
            reset_launches()
            exported_out = module(x)
            if {k: v for k, v in counts().items() if v} != want_calls:
                raise AssertionError(f"the exported forward launched {counts()}")
            if digest(exported_out) != digest(eager_out):
                raise AssertionError("the exported forward differs from eager's on the device")
            fns = {"eager": lambda: est.net(x, with_warped=False),
                   "exported": lambda: module(x)}
            times = [cuda_ms(fns[side], EXPORT_REPS) for side in EXPORT_TURNS]
            parts = {side: (host_ms(fn, EXPORT_REPS), device_ms(fn, EXPORT_REPS))
                     for side, fn in fns.items()}
        med = {side: statistics.median(t for s, t in zip(EXPORT_TURNS, times) if s == side)
               for side in fns}
        log("export", f"device forward B={B} {H}x{W} bf16, " + " / ".join(EXPORT_TURNS) + ": "
                      + " / ".join(f"{t:.3f}" for t in times) + f" ms (CUDA events, medians of "
                      f"{EXPORT_REPS}; the exported output bit-identical to eager's); median "
                      f"eager {med['eager']:.3f} ms, exported {med['exported']:.3f} ms on {card}")
        for side, (host, by_name) in parts.items():
            log("export", f"{side} forward: host {host:.3f} ms to enqueue (median of "
                          f"{EXPORT_REPS}), device busy {sum(by_name.values()):.3f} ms over "
                          f"{len(by_name)} kernel names (profiler, per forward)")
        same = set(parts["eager"][1]) == set(parts["exported"][1])
        log("export", f"the exported forward runs the same kernels as eager: {same}")
        del module, est

    from back2future_tpu_torch import serve_bench

    records = serve_bench.main(["--export", "--iters", str(SERVE_BENCH_ITERS)])
    if sorted((r["path"], r["resolution"]) for r in records) != sorted(
            (p, r) for p in ("eager", "exported") for r in ("kitti", "sintel")) or \
            not all(SERVE_BENCH_KEYS <= set(r) for r in records):
        raise AssertionError(f"serve_bench returned {records}")
    for r in records:
        log("export", f"serve_bench B=1 {r['resolution']} {r['raw_hw'][0]}x{r['raw_hw'][1]} "
                      f"{r['path']}: " + ", ".join(f"{k} {r[k]}" for k in sorted(SERVE_BENCH_KEYS))
                      + f" on {card}")
    log("export", f"phase 12: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------ phase 13: data parallelism

DDP_STEPS = 6                          # (a): NCCL at world size 1, hard bf16 steps
DDP_TURNS = 1                          # (e): (plain, DDP, DDP, plain) this many times
DDP_TIMED = 5                          # steps per turn
DRYRUN_ANCHORS = {False: 49.97828, True: 100.98643}   # MULTICHIP_r05.json
DRYRUN_RTOL = 1e-4
# (c): run() on 2 gloo ranks that share the card against 1 rank, f32, same
# global batch; a 16-scene set at val fraction 0.375 (11 train / 5 val at
# seed 0: the 2-rank validation drops the partial batch)
RUN_SCENES, RUN_VAL_FRACTION, RUN_B, RUN_EPOCH_SIZE = 16, 0.375, 4, 3
RUN_LOG_RTOL = 2e-3                    # the JAX package's multi-host loss tolerance
DDP_SERVING_TURNS = 1                  # (d): (one device, mesh, mesh, one device) turns


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def _ddp_run_rank(rank: int, world: int, opt, grad_seed: int) -> dict:
    """A rank of phase 13 (c), in a gloo group made by run_ranks: run()
    through its existing-group path, then one f32 DDP step of the seeded
    flagship on this rank's half of the seeded B=8 batch. Returns the
    run's launches and (rank 0) the step's loss and gradients."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import create_train_state, loop, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    loop.run(opt)
    torch.cuda.synchronize()
    launches = _nonzero(counts())
    opt32 = train_options("float32", soft=False)
    dev = torch.device("cuda", 0)
    net = train_network(opt32, dev)
    step = make_train_step(net, opt32, build_criterions(opt32))
    if not isinstance(step.forward, torch.nn.parallel.DistributedDataParallel):
        raise AssertionError("the train step in a group did not run through DDP")
    batch = train_batch(dev)
    half = TRAIN_B // world
    local = {k: v[rank * half:(rank + 1) * half] for k, v in batch.items()}
    _, logs = step(create_train_state(net, opt32), local)
    out = {"launches": launches, "loss": logs["loss"].item()}
    if rank == 0:
        out["grads"] = {n: p.grad.cpu().numpy() for n, p in net.named_parameters()}
    return out


def _time_turn(step, state, batch, n: int):
    """`n` steps: the state, the host ms each call took to return and the
    device ms (CUDA events around each step)."""
    host, events = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, _ = step(state, batch)
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
    torch.cuda.synchronize()
    return state, host, [a.elapsed_time(b) for a, b in events]


def phase_ddp_world1(card: str, dev) -> None:
    """(a) NCCL at world size 1 from the B2F_* spec, 6 hard bf16 steps
    through DDP against the same first step without a group, their
    launches checked and logged; (e) the step with DDP and without, in
    turns."""
    import torch.distributed as dist

    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.parallel import distributed
    from back2future_tpu_torch.parallel.launch import free_port
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import create_train_state, make_train_step

    opt = train_options("bfloat16", soft=False)
    batch = train_batch(dev)
    crits = build_criterions(opt)
    plain_net = train_network(opt, dev)
    plain_step = make_train_step(plain_net, opt, crits)
    if isinstance(plain_step.forward, torch.nn.parallel.DistributedDataParallel):
        raise AssertionError("a step built without a group runs through DDP")
    plain_state, logs = plain_step(create_train_state(plain_net, opt), batch)
    want_loss = logs["loss"].item()
    want_grads = {n: p.grad.clone() for n, p in plain_net.named_parameters()}

    spec = {"B2F_COORDINATOR": f"127.0.0.1:{free_port()}", "B2F_NUM_PROCESSES": "1",
            "B2F_PROCESS_ID": "0"}
    os.environ.update(spec)
    try:
        t0 = time.perf_counter()
        distributed.initialize_multihost()
        distributed.sync_hosts()
        log("ddp", f"(a) group from the B2F_* spec: backend {dist.get_backend()}, world "
                   f"{dist.get_world_size()}, in {time.perf_counter() - t0:.2f} s")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError("phase 13 (a) asks for NCCL at world size 1")
        net = train_network(opt, dev)
        step = make_train_step(net, opt, crits)
        if not isinstance(step.forward, torch.nn.parallel.DistributedDataParallel):
            raise AssertionError("the train step in a group did not run through DDP")
        state = create_train_state(net, opt)
        reset_launches()
        state, logs = step(state, batch)
        loss = logs["loss"].item()
        ratios = gradient_ratios({n: p.grad for n, p in net.named_parameters()}, want_grads)
        worst = max(ratios, key=ratios.get)
        state, values, times = train_steps("ddp", step, state, batch, DDP_STEPS - 1,
                                           TRAIN_PER_STEP)
        torch.cuda.synchronize()
        launches = counts()
        want = {k: DDP_STEPS * v for k, v in TRAIN_PER_STEP.items()}
        if launches != want:
            raise AssertionError(f"ddp: {DDP_STEPS} steps launched {launches}, expected {want}")
        log("ddp", f"(a) {DDP_STEPS} bf16 DDP steps B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: loss "
                   f"{['%.4f' % loss] + ['%.4f' % v for v in values['loss']]}; first step vs "
                   f"no group: loss {loss:.6f} vs {want_loss:.6f}, worst gradient "
                   f"max_abs_err / max|g| {ratios[worst]:.3e} ({worst}; tol "
                   f"{BF16_GRAD_TOL_FRAC}); launches {_nonzero(launches)} "
                   f"({_nonzero(TRAIN_PER_STEP)} a step)")
        if abs(loss - want_loss) > LOSS_RTOL * abs(want_loss) or ratios[worst] > BF16_GRAD_TOL_FRAC:
            raise AssertionError("ddp: the DDP step at world size 1 and the step without a "
                                 "group disagree")

        # (e) in turns: plain, DDP, DDP, plain
        rows = {"plain": ([], []), "ddp": ([], [])}
        states = {"plain": plain_state, "ddp": state}
        steps = {"plain": plain_step, "ddp": step}
        for _ in range(DDP_TURNS):
            for kind in ("plain", "ddp", "ddp", "plain"):
                states[kind], host, device = _time_turn(steps[kind], states[kind], batch,
                                                        DDP_TIMED)
                rows[kind][0].extend(host)
                rows[kind][1].extend(device)
        summary = {k: (statistics.median(h), statistics.median(d)) for k, (h, d) in rows.items()}
        # the device's own time a step, by the profiler (the CUDA-event
        # window above spans the host's gaps in a host-bound step)
        busy = {}
        for kind in ("plain", "ddp", "ddp", "plain"):
            busy.setdefault(kind, []).append(device_total_ms(
                lambda: steps[kind](states[kind], batch), 3))
        log("ddp", f"(e) hard bf16 step B={TRAIN_B} {TRAIN_H}x{TRAIN_W} in turns (plain, DDP, "
                   f"DDP, plain) x{DDP_TURNS}, {DDP_TIMED} steps a turn, medians: host ms to "
                   f"return {summary['plain'][0]:.2f} without DDP / {summary['ddp'][0]:.2f} "
                   f"with DDP at world size 1; device ms (CUDA events) "
                   f"{summary['plain'][1]:.2f} / {summary['ddp'][1]:.2f}; device busy ms "
                   f"(profiler, kernels summed, 2 turns of 3 steps) plain "
                   f"{['%.3f' % v for v in busy['plain']]} / DDP "
                   f"{['%.3f' % v for v in busy['ddp']]}; all plain host "
                   f"{['%.1f' % v for v in rows['plain'][0]]}, DDP host "
                   f"{['%.1f' % v for v in rows['ddp'][0]]}; on {card}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in spec:
            os.environ.pop(k, None)


def phase_ddp_run(card: str, dev) -> None:
    """(c) run() on 2 gloo ranks sharing the card against a 1-rank run()
    with the same global batch, then a gradient check of the 2-rank DDP
    step against the step on the whole batch."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.data import roaming
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.parallel.launch import run_ranks
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import create_train_state, loop, make_train_step
    from back2future_tpu_torch.utils import SymbolLogger

    with tempfile.TemporaryDirectory(prefix="b2f_ddp_") as tmp:
        root = Path(tmp)
        roaming.main(["--out", str(root / "set"), "--n", str(RUN_SCENES), "--height",
                      str(TRAIN_H), "--width", str(TRAIN_W), "--frames", "3", "--seed", "0",
                      "--val_fraction", str(RUN_VAL_FRACTION)])
        datasets = root / "set" / "datasets"
        opt = Options(batchSize=RUN_B, dataset="RoamingImages", datasets_dir=str(datasets),
                      data_root=str(root / "set" / "data"), cache=str(root / "cache"),
                      expName="one", epochSize=RUN_EPOCH_SIZE, nEpochs=1, epochStore=1,
                      nDonkeys=0, optimize="pme", compute_dtype="float32", augment=0,
                      rand_crop=0, ground_truth=True).derive(make_dirs=True)
        n_val = len(loop.build_loaders(opt)[1].dataset)   # the samples run() validates
        two = dataclasses.replace(opt, expName="two", save=str(root / "cache" / "two"))
        Path(two.save).mkdir(parents=True)
        t0 = time.perf_counter()
        reset_launches()
        loop.run(opt)
        torch.cuda.synchronize()
        one_s, one_launches = time.perf_counter() - t0, _nonzero(counts())
        t0 = time.perf_counter()
        ranks = run_ranks(_ddp_run_rank, 2, (two, 0), backend="gloo", rank0_here=False,
                          timeout=900)
        two_s = time.perf_counter() - t0
        logs = {name: SymbolLogger(Path(o.save) / "train.log").read()["avg loss (train set)"]
                for name, o in (("one", opt), ("two", two))}
        tests = {name: SymbolLogger(Path(o.save) / "test.log").read()["avg loss (test set)"]
                 for name, o in (("one", opt), ("two", two))}
        side = (Path(two.save) / "train.log.host1").exists()
        saved = (Path(two.save) / "model_1.pt").exists()
    n_full = n_val // RUN_B   # the 2-rank run's validation batches; 1 rank's add a partial one
    per_rank = {k: RUN_EPOCH_SIZE * TRAIN_PER_STEP[k] + n_full * EVAL_PER_STEP[k]
                for k in TRAIN_PER_STEP}
    one_want = {k: RUN_EPOCH_SIZE * TRAIN_PER_STEP[k] + -(-n_val // RUN_B) * EVAL_PER_STEP[k]
                for k in TRAIN_PER_STEP}
    log("ddp", f"(c) run() f32 B={RUN_B} {TRAIN_H}x{TRAIN_W}, {RUN_EPOCH_SIZE} steps + "
               f"validation: 1 rank {one_s:.1f} s, train loss {logs['one']}, test loss "
               f"{tests['one']} ({n_val} of {n_val} samples); 2 gloo ranks on the card "
               f"{two_s:.1f} s with their start-up, train loss {logs['two']}, test loss "
               f"{tests['two']} ({n_full * RUN_B} of {n_val}: full global batches); launches "
               f"1 rank {one_launches}, per rank "
               f"{[r['launches'] for r in ranks]}; .host1 side log {side}, checkpoint {saved}")
    if one_launches != _nonzero(one_want) or any(r["launches"] != _nonzero(per_rank)
                                                 for r in ranks):
        raise AssertionError(f"ddp: run() launches {one_launches} / "
                             f"{[r['launches'] for r in ranks]}, expected {_nonzero(one_want)} "
                             f"/ {_nonzero(per_rank)}")
    if not (side and saved and len(tests["two"]) == 1 and np.allclose(
            logs["two"], logs["one"], rtol=RUN_LOG_RTOL, atol=0)):
        raise AssertionError("ddp: the 2-rank run() and the 1-rank run() disagree")

    opt32 = train_options("float32", soft=False)
    net = train_network(opt32, dev)
    step = make_train_step(net, opt32, build_criterions(opt32))
    _, plain_logs = step(create_train_state(net, opt32), train_batch(dev))
    want = {n: p.grad for n, p in net.named_parameters()}
    got = {n: torch.from_numpy(g).to(dev) for n, g in ranks[0]["grads"].items()}
    ratios = gradient_ratios(got, want)
    worst = max(ratios, key=ratios.get)
    loss, want_loss = ranks[0]["loss"], plain_logs["loss"].item()
    log("ddp", f"(c) f32 DDP step on 2 gloo ranks (B={TRAIN_B // 2} each) vs one step on "
               f"B={TRAIN_B}: loss {loss:.6f} vs {want_loss:.6f} (rtol {LOSS_RTOL}), worst "
               f"gradient max_abs_err / max|g| {ratios[worst]:.3e} ({worst}; tol "
               f"{GRAD_TOL_FRAC}) over {len(want)} parameters")
    if abs(loss - want_loss) > LOSS_RTOL * abs(want_loss) or ratios[worst] > GRAD_TOL_FRAC \
            or ranks[1]["loss"] != loss:
        raise AssertionError("ddp: the 2-rank DDP step and the whole-batch step disagree")


def phase_ddp_serving(card: str) -> None:
    """(d) the flagship served on a mesh of two replicas of cuda:0 against
    the single-device estimator, B=16 KITTI frames."""
    from back2future_tpu_torch.api import init
    from back2future_tpu_torch.parallel import make_mesh
    from back2future_tpu_torch.runtime import reset_launches

    est = init(None, device="cuda", seed=0)
    mesh_est = init(None, seed=0, mesh=make_mesh(["cuda:0", "cuda:0"]))
    rng = np.random.default_rng(0)
    batch = [rng.random((B, H_IN, W_IN, 3), dtype=np.float32) for _ in range(3)]
    want = est.compute_flow_batch(*batch)
    reset_launches()
    got = mesh_est.compute_flow_batch(*batch)
    launches = _nonzero(counts())
    check_results(got, B)
    expect = _nonzero({k: 2 * v for k, v in SERVING_PER_FORWARD.items()})
    if launches != expect:
        raise AssertionError(f"ddp: a mesh call launched {launches}, expected {expect}")
    compare_results("ddp", "(d) mesh of 2 x cuda:0 vs one device", got, want)
    walls = {"one": [], "mesh": []}
    for _ in range(DDP_SERVING_TURNS):
        for kind, e in (("one", est), ("mesh", mesh_est), ("mesh", mesh_est), ("one", est)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.compute_flow_batch(*batch)
            walls[kind].append((time.perf_counter() - t0) * 1e3)
    log("ddp", f"(d) compute_flow_batch B={B} {H_IN}x{W_IN}: launches of a mesh call "
               f"{launches} (K1 10 and the gather 8 per slice forward); wall ms in turns, "
               f"medians: one device {statistics.median(walls['one']):.1f}, mesh of two "
               f"replicas on one card {statistics.median(walls['mesh']):.1f}; on {card}")


def phase_ddp(card: str, dev, dryrun: bool = True) -> None:
    """Phase 13: (a) + (e), (b), (c), (d). Each part checks its own
    launch counts and logs them; the kernels line keeps the paths of
    phase 3's entries. The dry run (b), on the data x spatial mesh that
    `dryrun_multichip(8)` makes, is phase 14 (d)'s in the default run
    (`dryrun=False` here)."""
    t0 = time.perf_counter()
    phase_ddp_world1(card, dev)
    if dryrun:
        phase_spatial_dryrun(card)
    phase_ddp_run(card, dev)
    phase_ddp_serving(card)
    log("ddp", f"phase 13: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------ phase 14: the spatial axis

SPATIAL_S = 2                          # ranks (slots) of a spatial group
# (a): the sharded feature warps' shapes: the bands of levels 3..6 (the
# targets of the warps of levels 4..7), whole sources, two frames a level
SPATIAL_WARP_LEVELS = (3, 4, 5, 6)
SPATIAL_WARP_CHANNELS = {3: 32, 4: 64, 5: 96, 6: 128}
# (a'): SPyNet's C = 3 bands at the train shapes: resolution levels 1-6
# (SPyNet's levels 7-2; level 1, 5 rows, stays whole)
SPY_SPATIAL_LEVELS = (1, 2, 3, 4, 5, 6)
# (a), (a'): per path its batch and image size, levels, channels a level
# and each timed kernel's launches a level per slot forward or rank step
# (the feature warps: two frames; SPyNet: two input warps, gather and
# W-dflow, and two output warps, gather, K4 and W-dflow)
SPATIAL_KERNEL_PATHS = {
    "serving": (B, H, W, SPATIAL_WARP_LEVELS, SPATIAL_WARP_CHANNELS,
                {"warp_bilinear_fwd": 2}),
    "train": (TRAIN_B, TRAIN_H, TRAIN_W, SPATIAL_WARP_LEVELS, SPATIAL_WARP_CHANNELS,
              {"warp_bilinear_fwd": 2, "warp_bilinear_dimages": 2, "warp_bilinear_dflow": 2}),
    "spynet": (TRAIN_B, TRAIN_H, TRAIN_W, SPY_SPATIAL_LEVELS, dict.fromkeys(SPY_SPATIAL_LEVELS, 3),
               {"warp_bilinear_fwd": 4, "warp_bilinear_dimages": 2, "warp_bilinear_dflow": 4}),
}
SPATIAL_STEPS = 4                      # (c): the first step compared, then 3 timed
# (a): a part of each row-window kernel's device name
KERNEL_PARTS = {"warp_bilinear_fwd": "warp_bilinear_fwd", "warp_bilinear_dimages": "dimages",
                "warp_bilinear_dflow": "dflow"}
# (c): bf16, the bands' convs may take other cuDNN algorithms than the
# whole image's (other sum orders), and the halo and gather gradients add
# in bf16: the loss within 1e-3, the gradients within BF16_GRAD_TOL_FRAC
SPATIAL_LOSS_RTOL = 1e-3


def window_grid(flow, y0: int, h_src: int):
    """`grid_of` for a row window: the band's flow of rows y0 .. of an
    image of `h_src` rows, normalised by the image's size."""
    b, h, w, _ = flow.shape
    fl = flow.float()
    gx = (fl[..., 0] + torch.arange(w, device=flow.device).view(1, 1, w)) * (2.0 / (w - 1)) - 1
    gy = (fl[..., 1] + torch.arange(y0, y0 + h, device=flow.device).view(1, h, 1)) * (
        2.0 / (h_src - 1)) - 1
    return torch.stack([gx, gy], -1).to(flow.dtype)


def rows_reached(flow, y0: int, h_src: int) -> int:
    """The image rows that a window's bilinear taps read on this flow."""
    ys = flow[..., 1].float() + torch.arange(y0, y0 + flow.shape[1],
                                             device=flow.device).view(1, -1, 1)
    ys = ys.clamp(0, h_src - 1)
    lo, hi = int(ys.min().floor().item()), min(int(ys.max().floor().item()) + 1, h_src - 1)
    return hi - lo + 1


def phase_spatial_kernels(card: str, dev) -> dict:
    """(a) The row-window gather, K4 and W-dflow at the sharded feature
    warps' bf16 shapes of the serving forward (B=16 320x1216) and the hard
    train step (B=8 320x640), and (a') at SPyNet's C = 3 bands of its pme
    step (B=8 320x640, resolution levels 1-6), at S = 2
    (SPATIAL_KERNEL_PATHS): every band of each level on smooth flows,
    against the twin with the same window, and the gather and W-dflow bit
    for bit against the rows of the whole image's launch, K4's bands
    summed against the whole launch within its atomics' spread
    (KERNEL_TOL of the largest value). Per slot forward (gather) and per
    rank step (K4, W-dflow), on band 1: the profiler's device ms of the
    kernels' own launches (`complete_device_ms`), of the twins and the
    library calls (F.grid_sample and
    aten.grid_sampler_2d_backward on the window's grid), and the bound
    (the gather's alone at the serving shapes, where the other two do not
    run); the summary of the kernels line's row-window entries."""
    from back2future_tpu_torch import ops

    rng = np.random.default_rng(14)
    dtype = torch.bfloat16
    tol = KERNEL_TOL[dtype]
    names = ("warp_bilinear_fwd", "warp_bilinear_dimages", "warp_bilinear_dflow")
    summary = {}
    for path, (b, h_img, w_img, levels, channels, per_level) in SPATIAL_KERNEL_PATHS.items():
        calls = []
        for level in levels:
            h_src, w = h_img >> (level - 1), w_img >> (level - 1)
            c = channels[level]
            img = torch.from_numpy(rng.standard_normal((b, h_src, w, c)).astype(
                np.float32)).to(dev, dtype)
            flow = smooth_flow(rng, (b, h_src, w), dtype, dev)
            g = torch.from_numpy(rng.standard_normal((b, h_src, w, c)).astype(
                np.float32)).to(dev, dtype)
            whole = ops.warp_bilinear(img, flow)
            whole_dflow = torch.ops.b2f.warp_dflow(img, flow, g, True)
            whole_dimg = torch.ops.b2f.warp_dimages(flow, g).float()
            total = torch.zeros_like(whole_dimg)
            band = h_src // SPATIAL_S
            for s in range(SPATIAL_S):
                y0, rows = s * band, slice(s * band, (s + 1) * band)
                fl, gb = flow[:, rows].contiguous(), g[:, rows].contiguous()
                out = ops.warp_bilinear(img, fl, y0=y0)
                d_flow = torch.ops.b2f.warp_dflow(img, fl, gb, True, y0)
                d_img = torch.ops.b2f.warp_dimages(fl, gb, h_src, y0)
                want = (ops.warp_bilinear_reference(img, fl, y0),
                        ops.warp_dimages_reference(fl, gb, h_src, y0),
                        ops.warp_dflow_reference(img, fl, gb, True, y0))
                for name, got, ref in zip(names, (out, d_img, d_flow), want):
                    err = (got.float() - ref.float()).abs().max().item()
                    atol = tol if name == "warp_bilinear_fwd" else \
                        tol * max(1.0, ref.float().abs().max().item())
                    entry = summary.setdefault((path, name), dict(err=0.0))
                    entry["err"] = max(entry["err"], err)
                    if not torch.allclose(got.float(), ref.float(), rtol=tol, atol=atol):
                        raise AssertionError(f"spatial: {name} band {s} of {tuple(img.shape)} "
                                             f"outside tolerance ({err:.3e})")
                if not (torch.equal(out, whole[:, rows]) and torch.equal(d_flow, whole_dflow[:, rows])):
                    raise AssertionError(f"spatial: the row window of {tuple(img.shape)} band {s} "
                                         f"differs from the whole launch's rows")
                total += d_img.float()
                calls.append(dict(img=img, flow=fl, g=gb, y0=y0, h_src=h_src, band=s))
            spread = (total - whole_dimg).abs().max().item()
            if spread > tol * max(1.0, whole_dimg.abs().max().item()):
                raise AssertionError(f"spatial: K4's bands of {tuple(img.shape)} sum to "
                                     f"{spread:.3e} off the whole launch")
            log("spatial", f"(a) {path} level {level} {'x'.join(map(str, img.shape))}: "
                           f"{SPATIAL_S} bands of {band} rows, gather and W-dflow bit for bit "
                           f"the whole launch's rows, K4's bands summed within {spread:.3e} of "
                           f"the whole launch's")
        timed = [c for c in calls if c["band"] == 1]   # an inner window, y0 > 0

        def kernel(name, c, plain=False):
            img, fl, g, y0, hs = c["img"], c["flow"], c["g"], c["y0"], c["h_src"]
            if name == "warp_bilinear_fwd":
                return (ops.warp_bilinear_reference(img, fl, y0) if plain
                        else ops.warp_bilinear(img, fl, y0=y0))
            if name == "warp_bilinear_dimages":
                return (ops.warp_dimages_reference(fl, g, hs, y0) if plain
                        else torch.ops.b2f.warp_dimages(fl, g, hs, y0))
            return (ops.warp_dflow_reference(img, fl, g, True, y0) if plain
                    else torch.ops.b2f.warp_dflow(img, fl, g, True, y0))

        def library(name, c):
            grid = window_grid(c["flow"], c["y0"], c["h_src"])
            if name == "warp_bilinear_fwd":
                return F.grid_sample(nchw(c["img"]), grid, mode="bilinear",
                                     padding_mode="border", align_corners=True)
            mask = [name == "warp_bilinear_dimages", name == "warp_bilinear_dflow"]
            return torch.ops.aten.grid_sampler_2d_backward(nchw(c["g"]), nchw(c["img"]), grid,
                                                           0, 1, True, mask)

        def work(name, c):
            """(operations, bytes): 8 a channel of an output pixel; the
            image rows the taps reach, the window's flow and g, and the
            output (K4's: the whole image gradient, f32 zero-fill apart)."""
            img, fl, g = c["img"], c["flow"], c["g"]
            b_, _, w, ch = img.shape
            reached = b_ * rows_reached(fl, c["y0"], c["h_src"]) * w * ch * img.element_size()
            if name == "warp_bilinear_fwd":
                return 8 * g.numel(), reached + nbytes(fl) + nbytes(g)
            if name == "warp_bilinear_dimages":
                return 8 * g.numel(), nbytes(fl, g) + nbytes(img)
            return 8 * g.numel(), reached + 2 * nbytes(fl) + nbytes(g)

        for name, per in per_level.items():
            ops_s = per * sum(work(name, c)[0] for c in timed) / PEAK_OPS_PER_S[dtype]
            bytes_s = per * sum(work(name, c)[1] for c in timed) / HBM_BYTES_PER_S
            ms = per * complete_device_ms(lambda: [kernel(name, c) for c in timed], 10,
                                          KERNEL_PARTS[name], len(timed))
            plain_ms = per * device_total_ms(lambda: [kernel(name, c, True) for c in timed], 3)
            lib_ms = per * device_total_ms(lambda: [library(name, c) for c in timed], 10)
            entry = summary[path, name]
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=max(ops_s, bytes_s) * 1e3, bytes_ms=bytes_s * 1e3,
                         ops_ms=ops_s * 1e3)
            log("spatial", f"(a) {name}, row window, per {path} {'slot forward' if path == 'serving' else 'rank step'} "
                           f"(band 1 of levels {levels[0]}-{levels[-1]}, {per} launches each; "
                           f"C {sorted(set(channels.values()))}; profiler device time, the "
                           f"kernel's own launches, K4's zero-fill and cast apart): kernel "
                           f"{ms:.4f} ms, twin {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                           f"{entry['bound_ms']:.4f} ms (bytes {bytes_s * 1e3:.4f}, operations "
                           f"{ops_s * 1e3:.4f}); max_abs_err {entry['err']:.3e}; on {card}")
        if path == "spynet":
            # K4 by its C = 3 route and by the quad tiles, in turns
            summary[path, "k4_routes"] = k4_c3_routes(
                card, "(a') spynet pme rank step, band 1", [
                    (c["flow"], c["g"], c["h_src"], c["y0"]) for c in timed],
                per_level["warp_bilinear_dimages"],
                library_ms=summary[path, "warp_bilinear_dimages"]["library_ms"],
                twin_ms=summary[path, "warp_bilinear_dimages"]["plain_ms"])
        # the bytes each gather of a warp's source moves per rank (the
        # feature warps'; SPyNet's output warps'): the other slots' bands
        # of the whole level, received (gloo: through host memory)
        moved = [2 * (SPATIAL_S - 1) * (b * (h_img >> (l - 1)) // SPATIAL_S * (w_img >> (l - 1))
                                        * channels[l] * 2)
                 for l in levels]
        log("spatial", f"(a) {path}: the gathers of warp sources receive per rank and "
                       f"{'forward' if path == 'serving' else 'step'} "
                       + ", ".join(f"level {l} {m / 2**20:.3f} MiB" for l, m in
                                   zip(levels, moved))
                       + f" (2 frames each, bf16): {sum(moved) / 2**20:.2f} MiB in all")
    return summary


def phase_spatial_serving(card: str) -> dict:
    """(b) The flagship bf16 estimator on data x spatial meshes of (1, 2)
    and (2, 2) slots that share cuda:0 (threads, in-process halo
    exchanges) against the single-device estimator, B=16 KITTI frames:
    results within phase 13 (d)'s tolerance, K1 10 and the gather 8 a
    slot (each mesh's first call); the (1, 2) mesh's wall ms in turns
    with the single device's. Returns the (1, 2) call's launches."""
    from back2future_tpu_torch.api import init
    from back2future_tpu_torch.parallel import make_mesh
    from back2future_tpu_torch.runtime import reset_launches

    est = init(None, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    batch = [rng.random((B, H_IN, W_IN, 3), dtype=np.float32) for _ in range(3)]
    want = est.compute_flow_batch(*batch)
    walls = {"one": []}
    launches = {}
    for shape in ((1, SPATIAL_S), (2, SPATIAL_S)):
        slots = shape[0] * shape[1]
        mesh_est = init(None, seed=0, spatial=True,
                        mesh=make_mesh(["cuda:0"] * slots, shape=shape, axes=("data", "spatial")))
        plan = mesh_est.replicas[0]._rows(H).plan
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        got = mesh_est.compute_flow_batch(*batch)
        launches[shape] = _nonzero(counts())
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_results(got, B)
        expect = _nonzero({k: slots * v for k, v in SERVING_PER_FORWARD.items()})
        if launches[shape] != expect:
            raise AssertionError(f"spatial: a {shape} mesh call launched {launches[shape]}, "
                                 f"expected {expect}")
        compare_results("spatial", f"(b) data x spatial mesh {shape} of cuda:0 vs one device",
                        got, want)
        key = f"{shape[0]}x{shape[1]}"
        walls[key] = []
        if shape[0] == 1:
            for kind, e in (("one", est), (key, mesh_est), (key, mesh_est), ("one", est)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.compute_flow_batch(*batch)
                walls[kind].append((time.perf_counter() - t0) * 1e3)
        turns = (f"; wall ms in turns: one device {['%.1f' % v for v in walls['one']]}, mesh "
                 f"{['%.1f' % v for v in walls[key]]}" if walls[key] else "")
        log("spatial", f"(b) mesh {shape}: plan {plan} (levels 1-7), launches of its first "
                       f"call {launches[shape]} (K1 10 and the gather 8 a slot), peak device "
                       f"memory {peak:.2f} GiB (all slots, one process){turns}; on {card}")
        del mesh_est
    return launches[(1, SPATIAL_S)]


# (c), (c'): the steps of one spawn of spatial ranks: (key, dtype, netType,
# launches a step, CUDA-event timed steps after the compared one, the
# case whose unsharded f32 gradients tell a bf16 leaf's own noise)
SPATIAL_STEP_CASES = (("hard", "bfloat16", "pwc", TRAIN_PER_STEP, SPATIAL_STEPS - 1, None),
                      ("spynet", "bfloat16", "spynet", SPY_PME_PER_STEP, SPATIAL_STEPS - 1,
                       "spynet_f32"),
                      ("spynet_f32", "float32", "spynet", SPY_PME_PER_STEP, 0, None))


@contextlib.contextmanager
def f32_without_tf32(on: bool):
    """f32 convs and matmuls in f32, not TF32, while `on` (the f32 steps
    of (c'), whose bands and whole image may take other cuDNN algorithms)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if on:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _step_record(step, state, batch, rank: int, net, timed: int) -> dict:
    """One step from `state` on `batch`: its loss, launches, the memory
    allocated before it and its peak, the gradients (rank 0) and the
    CUDA-event ms of `timed` steps after it."""
    from back2future_tpu_torch.runtime import reset_launches

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, logs = step(state, batch)
    out = {"loss": logs["loss"].item(), "launches": _nonzero(counts()),
           "peak": torch.cuda.max_memory_allocated(), "base": base,
           "plan": net._rows(TRAIN_H).plan}
    if rank == 0:
        out["grads"] = {n: p.grad.float().cpu().numpy() for n, p in net.named_parameters()}
    _, _, out["ms"] = _time_turn(step, state, batch, timed)
    return out


def _spatial_steps(rank: int, comm) -> dict:
    """Every case of SPATIAL_STEP_CASES from the seeded net on the whole
    B=8 320x640 batch, in this process: unsharded without `comm`, else its
    rows in bands over the spatial group (`_step_record` each)."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    dev = torch.device("cuda", 0)
    batch = train_batch(dev)
    out = {}
    for key, dtype, net_type, _, timed, _ in SPATIAL_STEP_CASES:
        opt = train_options(dtype, soft=False, netType=net_type)
        net = train_network(opt, dev)
        net.spatial_comm = comm
        with f32_without_tf32(dtype == "float32"):
            step = make_train_step(net, opt, build_criterions(opt))
            out[key] = _step_record(step, create_train_state(net, opt), batch, rank, net, timed)
        del net, step
        torch.cuda.empty_cache()
    return out


def _spatial_step_rank(rank: int, world: int) -> dict:
    """A rank of phase 14 (c) and (c'), in a gloo group made by run_ranks,
    on cuda:0, the `world` ranks one spatial group (`_spatial_steps`)."""
    from back2future_tpu_torch.parallel import distributed

    torch.cuda.set_device(0)
    distributed.init_mesh_groups(world)
    try:
        return _spatial_steps(rank, distributed.spatial_comm())
    finally:
        distributed.init_mesh_groups(1)


def phase_spatial_step(card: str) -> dict:
    """(c) The hard bf16 step and (c') the SPyNet pme step, bf16 and f32,
    on 2 spatial gloo ranks sharing the card against the unsharded steps
    (this process, no group): the loss, every gradient within
    BF16_GRAD_TOL_FRAC of max|g| (f32: GRAD_TOL_FRAC), each rank's
    launches, the peak memory a step takes over what was allocated before
    it, a rank's beside the unsharded step's; step ms. A bf16 SPyNet leaf
    past the tolerance is recorded, not failed, where the unsharded bf16
    step's own gradient is farther than the tolerance from the unsharded
    f32 step's (bf16 does not fix that leaf to the tolerance: SPyNet's
    sensitivity, ROADMAP.md queue 3), with the bands' distance from the f32
    gradient beside it. Returns rank 0's launches of the hard and the
    SPyNet step."""
    from back2future_tpu_torch.parallel.launch import run_ranks

    ones = _spatial_steps(0, None)
    t0 = time.perf_counter()
    twos = run_ranks(_spatial_step_rank, SPATIAL_S, (), backend="gloo", rank0_here=False,
                     timeout=600)
    secs = time.perf_counter() - t0
    gib = 2**30
    failed = []
    def grads(record):
        return {n: torch.from_numpy(g) for n, g in record["grads"].items()}

    for key, dtype, net_type, per_step, _, f32_key in SPATIAL_STEP_CASES:
        one, two = ones[key], [r[key] for r in twos]
        want, got = grads(one), grads(two[0])
        ratios = gradient_ratios(got, want)
        worst = max(ratios, key=ratios.get)
        tol = GRAD_TOL_FRAC if dtype == "float32" else BF16_GRAD_TOL_FRAC
        misses = {n: r for n, r in ratios.items() if r > tol}
        explained = {}
        if f32_key is not None:
            f32 = grads(ones[f32_key])
            own, bands = gradient_ratios(want, f32), gradient_ratios(got, f32)
            explained = {n: (r, own[n], bands[n]) for n, r in misses.items() if own[n] > tol}
            log("spatial", f"(c') {key}: leaves past {tol} of max|g| against the unsharded "
                           f"step {sorted(misses)}; of them recorded (the unsharded {dtype} "
                           f"step's own distance from the unsharded f32 step's past the "
                           f"tolerance): " + (", ".join(
                               f"{n} {r:.3e} (unsharded vs f32 {o:.3e}, bands vs f32 {b:.3e})"
                               for n, (r, o, b) in sorted(explained.items())) or "none")
                           + f"; over all leaves the unsharded {dtype} step vs f32 worst "
                           f"{max(own.values()):.3e}, the bands vs f32 worst "
                           f"{max(bands.values()):.3e}")
        per_step = _nonzero(per_step)
        tag = "(c)" if net_type == "pwc" else "(c')"
        log("spatial", f"{tag} {key} {dtype} {net_type} step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}, "
                       f"rows in bands over {SPATIAL_S} gloo ranks sharing the card (plan "
                       f"{two[0]['plan']}), the loss on the bands, vs the unsharded step: loss "
                       f"{two[0]['loss']:.6f} / {two[1]['loss']:.6f} vs {one['loss']:.6f} (rtol "
                       f"{SPATIAL_LOSS_RTOL}), worst gradient max_abs_err / max|g| "
                       f"{ratios[worst]:.3e} ({worst}; tol {tol}) over {len(want)} parameters; "
                       f"launches per rank {[r['launches'] for r in two]}; the step's peak over "
                       f"what was allocated before it a rank "
                       f"{['%.3f' % ((r['peak'] - r['base']) / gib) for r in two]} GiB (peak "
                       f"{['%.3f' % (r['peak'] / gib) for r in two]}, through DDP) vs the "
                       f"unsharded step's {(one['peak'] - one['base']) / gib:.3f} GiB (no group), "
                       f"ratio {(two[0]['peak'] - two[0]['base']) / (one['peak'] - one['base']):.3f}; "
                       f"step ms (CUDA events, steps 2-{1 + len(one['ms'])}) unsharded "
                       f"{['%.1f' % v for v in one['ms']]}, rank 0 {['%.1f' % v for v in two[0]['ms']]}"
                       f"; on {card}")
        if any(r["launches"] != per_step for r in two) or one["launches"] != per_step:
            failed.append(f"{key} launches {[r['launches'] for r in two]} / {one['launches']}, "
                          f"expected {per_step} each")
        if abs(two[0]["loss"] - one["loss"]) > SPATIAL_LOSS_RTOL * abs(one["loss"]) \
                or two[1]["loss"] != two[0]["loss"] or set(misses) - set(explained):
            failed.append(f"{key}: the row-sharded step and the unsharded step disagree")
    log("spatial", f"(c), (c') the ranks {secs:.1f} s with their start-up")
    if failed:
        raise AssertionError("spatial: " + "; ".join(failed))
    return {"train": twos[0]["hard"]["launches"], "spynet": twos[0]["spynet"]["launches"]}


def phase_spatial_dryrun(card: str) -> None:
    """(d) dryrun_multichip(8) over 8 gloo ranks that share the card, a
    data x spatial mesh of (4, 2) as the JAX package's, f32: both anchors
    at DRYRUN_RTOL, each rank's hard step TRAIN_PER_STEP."""
    from back2future_tpu_torch.graft_entry import dryrun_multichip

    t0 = time.perf_counter()
    results = dryrun_multichip(8, backend="gloo", timeout=600)
    secs = time.perf_counter() - t0
    per_step = _nonzero(TRAIN_PER_STEP)
    if len(results) != 8:
        raise AssertionError(f"spatial: the dry run ran {len(results)} ranks, expected 8")
    for rank, records in enumerate(results):
        for rec in records:
            kind = "soft" if rec["soft"] else "hard"
            log("spatial", f"(d) rank {rank} on {rec['device']} [{kind}]: loss "
                           f"{rec['loss']:.5f}, launches {rec['launches']}, peak "
                           f"{rec['peak_bytes'] / 2**30:.3f} GiB")
            if kind == "hard" and rec["launches"] != per_step:
                raise AssertionError(f"spatial: dry-run rank {rank} hard step launched "
                                     f"{rec['launches']}, expected {per_step}")
    for i, soft in enumerate((False, True)):
        loss = results[0][i]["loss"]
        if abs(loss - DRYRUN_ANCHORS[soft]) > DRYRUN_RTOL * DRYRUN_ANCHORS[soft]:
            raise AssertionError(f"spatial: dry run loss {loss} vs anchor "
                                 f"{DRYRUN_ANCHORS[soft]}")
    log("spatial", f"(d) dryrun_multichip(8): mesh {{'data': 4, 'spatial': 2}}, 8 gloo ranks "
                   f"on one card, losses {results[0][0]['loss']:.5f} (anchor "
                   f"{DRYRUN_ANCHORS[False]}) and {results[0][1]['loss']:.5f} (anchor "
                   f"{DRYRUN_ANCHORS[True]}), rtol {DRYRUN_RTOL}; {secs:.1f} s with the ranks' "
                   f"start-up, on {card}")


def _spatial_run_rank(rank: int, world: int, opt) -> dict:
    """A rank of phase 14 (e): run() through its existing-group path."""
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import loop

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    loop.run(opt)
    torch.cuda.synchronize()
    return {"launches": _nonzero(counts())}


def phase_spatial_run(card: str) -> None:
    """(e) run() (f32, B=4, 3 steps and validation) on a data x spatial
    mesh of (1, 2) gloo ranks sharing the card against one rank: the
    train.log and test.log losses at RUN_LOG_RTOL, each rank's launches."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.data import roaming
    from back2future_tpu_torch.parallel.launch import run_ranks
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import loop
    from back2future_tpu_torch.utils import SymbolLogger

    with tempfile.TemporaryDirectory(prefix="b2f_spatial_") as tmp:
        root = Path(tmp)
        roaming.main(["--out", str(root / "set"), "--n", str(RUN_SCENES), "--height",
                      str(TRAIN_H), "--width", str(TRAIN_W), "--frames", "3", "--seed", "0",
                      "--val_fraction", str(RUN_VAL_FRACTION)])
        opt = Options(batchSize=RUN_B, dataset="RoamingImages",
                      datasets_dir=str(root / "set" / "datasets"),
                      data_root=str(root / "set" / "data"), cache=str(root / "cache"),
                      expName="one", epochSize=RUN_EPOCH_SIZE, nEpochs=1, epochStore=1,
                      nDonkeys=0, optimize="pme", compute_dtype="float32", augment=0,
                      rand_crop=0, ground_truth=True).derive(make_dirs=True)
        n_val = len(loop.build_loaders(opt)[1].dataset)
        two = dataclasses.replace(opt, expName="spatial", save=str(root / "cache" / "spatial"),
                                  mesh_shape=(1, SPATIAL_S), mesh_axes=("data", "spatial"))
        Path(two.save).mkdir(parents=True)
        t0 = time.perf_counter()
        reset_launches()
        loop.run(opt)
        torch.cuda.synchronize()
        one_s, one_launches = time.perf_counter() - t0, _nonzero(counts())
        t0 = time.perf_counter()
        ranks = run_ranks(_spatial_run_rank, SPATIAL_S, (two,), backend="gloo",
                          rank0_here=False, timeout=900)
        two_s = time.perf_counter() - t0
        logs = {n: {k: SymbolLogger(Path(o.save) / f).read()[k] for f, k in
                    (("train.log", "avg loss (train set)"), ("test.log", "avg loss (test set)"))}
                for n, o in (("one", opt), ("two", two))}
        side = (Path(two.save) / "train.log.host1").exists()
    want = _nonzero({k: RUN_EPOCH_SIZE * TRAIN_PER_STEP[k] + -(-n_val // RUN_B) * EVAL_PER_STEP[k]
                     for k in TRAIN_PER_STEP})
    log("spatial", f"(e) run() f32 B={RUN_B} {TRAIN_H}x{TRAIN_W}, {RUN_EPOCH_SIZE} steps + "
                   f"validation ({n_val} samples): 1 rank {one_s:.1f} s, losses {logs['one']}; "
                   f"mesh (1, {SPATIAL_S}) of gloo ranks on the card {two_s:.1f} s with their "
                   f"start-up, losses {logs['two']}; launches 1 rank {one_launches}, per rank "
                   f"{[r['launches'] for r in ranks]}; .host1 side log {side}; on {card}")
    if one_launches != want or any(r["launches"] != want for r in ranks):
        raise AssertionError(f"spatial: run() launches {one_launches} / "
                             f"{[r['launches'] for r in ranks]}, expected {want}")
    if not side or any(not np.allclose(logs["two"][k], logs["one"][k], rtol=RUN_LOG_RTOL, atol=0)
                       for k in logs["one"]):
        raise AssertionError("spatial: the row-sharded run() and the 1-rank run() disagree")


def phase_spatial(card: str, dev, summary=None) -> dict:
    """Phase 14: (a)-(e); (a) only where `summary`, its result, is not
    given (the default run takes it right after phase 3, among the other
    kernel timings). Returns the launches of the spatial main paths and
    the row-window kernels' summary for the kernels line."""
    t0 = time.perf_counter()
    if summary is None:
        summary = phase_spatial_kernels(card, dev)
    serving = phase_spatial_serving(card)
    steps = phase_spatial_step(card)
    phase_spatial_dryrun(card)
    phase_spatial_run(card)
    log("spatial", f"phase 14: {time.perf_counter() - t0:.1f} s")
    return {"summary": summary, "serving": serving, **steps}


# the kernels line's row-window entries: (name, summary key, source, path)
SPATIAL_KERNEL_ENTRIES = (
    ("warp_bilinear_fwd", ("serving", "warp_bilinear_fwd"), "warp_fwd_tiled.cu",
     "back2future_tpu/ops/warp.py:96", "serving"),
    ("warp_bilinear_dimages", ("train", "warp_bilinear_dimages"), "warp_bwd_tiled.cu",
     "back2future_tpu/ops/warp_pallas.py:81", "train"),
    ("warp_bilinear_dflow", ("train", "warp_bilinear_dflow"), "warp_bwd_tiled.cu",
     "back2future_tpu/ops/warp.py:209", "train"),
    ("warp_bilinear_fwd", ("spynet", "warp_bilinear_fwd"), "warp_fwd_tiled.cu",
     "back2future_tpu/ops/warp.py:96", "spynet"),
    ("warp_bilinear_dimages", ("spynet", "warp_bilinear_dimages"), "warp_bwd_tiled.cu",
     "back2future_tpu/ops/warp_pallas.py:81", "spynet"),
    ("warp_bilinear_dflow", ("spynet", "warp_bilinear_dflow"), "warp_bwd_tiled.cu",
     "back2future_tpu/ops/warp.py:209", "spynet"),
)


def spatial_kernel_entries(spatial: dict) -> list:
    """The kernels line's entries of the row-window kernels: launches of a
    spatial serving call (two slots) or of a spatial rank's hard or SPyNet
    step, ms per slot forward or rank step on the sharded warps' shapes."""
    entries = []
    for name, key, source, replaces, path in SPATIAL_KERNEL_ENTRIES:
        s = spatial["summary"][key]
        where = {"serving": "spatial serving, 2 slots", "train": "spatial train rank",
                 "spynet": "spatial spynet pme rank, C = 3"}[path]
        entries.append({"name": f"{name} (row window, {where})", "route": "cuda",
                        "source": f"back2future_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": spatial[path][f"b2f_{name}"], "max_abs_err": s["err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                        "library_ms": s["library_ms"]})
    return entries


def elapsed_marks():
    """A function that logs the seconds since it was made and since its
    last call, after a phase of the default run."""
    t0 = last = time.perf_counter()

    def mark(label: str) -> None:
        nonlocal last
        now = time.perf_counter()
        log("time", f"{label}: {now - last:.1f} s ({now - t0:.1f} s since the build began)")
        last = now
    return mark


def main() -> None:
    card = phase_environment()
    mark = elapsed_marks()

    dev = torch.device("cuda")
    phase_build()
    phase_host_build()
    if "--pipe-variants" in sys.argv[1:]:
        phase_pipe_variants(card)
        return
    if "--data" in sys.argv[1:]:
        with stem(False):
            hard = run_train(card, dev, "train", soft=False, per_step=TRAIN_PER_STEP)
            phase_data(card, dev, hard["step_ms"])
        return
    if "--loop" in sys.argv[1:]:
        with stem(False):
            phase_loop(card, dev, {})
        return
    if "--criteria" in sys.argv[1:]:
        with stem(False):
            phase_criteria(card, dev)
            phase_remat(card, dev, soft=False)
        with stem(True):
            phase_remat(card, dev, soft=True)
        return
    if "--learn" in sys.argv[1:]:
        with stem(False):
            phase_learn(card, dev, [a for a in sys.argv[1:] if a != "--learn"])
        return
    if "--serving-export" in sys.argv[1:]:
        with stem(False):
            phase_serving_export(card, dev, sys.argv[1:])
        print_result()
        return
    if "--ddp" in sys.argv[1:]:
        with stem(False):
            phase_ddp(card, dev)
        print_result()
        return
    if "--spatial" in sys.argv[1:]:
        with stem(False):
            spatial = phase_spatial(card, dev)
        print(json.dumps({"kernels": spatial_kernel_entries(spatial)}), flush=True)
        print_result()
        return
    if "--host" in sys.argv[1:]:
        with stem(False):
            phase_main_path(card)
        print_result()
        return
    if "--spynet" in sys.argv[1:]:
        with stem(False):
            spynet = phase_spynet(card, dev)
            phase_t7(card, dev)
        print(json.dumps({"kernels": spynet_kernel_entries(spynet)}), flush=True)
        print_result()
        return
    phase_mma_builds()
    mark("build (2)")
    if "--profile" in sys.argv[1:]:
        phase_profile(card, dev)
        return
    if "--k6-phases" in sys.argv[1:]:
        phase_k6_phases(card, dev)
        return
    if "--k5-phases" in sys.argv[1:]:
        phase_k5_phases(card, dev)
        return
    if "--k1-phases" in sys.argv[1:]:
        phase_k1_phases(card, dev)
        return
    if "--gather-variants" in sys.argv[1:]:
        phase_gather_variants(card, dev)
        return
    if "--k4-routes" in sys.argv[1:]:
        with stem(False):
            phase_k4_routes(card, dev)
        return
    if "--k4-c3" in sys.argv[1:]:
        phase_k4_c3(card, dev)
        return
    summary = phase_kernels(dev)
    with stem(False):
        spatial_summary = phase_spatial_kernels(card, dev)
    mark("kernels (3, 14a)")
    with stem(False):
        main_path = phase_main_path(card)
    paths = {"serving": main_path["launches"]}
    phase_serving_stem(card, main_path)
    for ab in SERVING_AB:
        phase_serving_ab(card, main_path, *ab)
    del main_path
    mark("serving (4, 5)")
    with stem(False):
        hard = run_train(card, dev, "train", soft=False, per_step=TRAIN_PER_STEP)
        paths["train"] = hard["launches"]
        phase_criteria(card, dev)
        phase_remat(card, dev, soft=False)
        phase_train_bwd_ab(card, dev)
        phase_k4_routes(card, dev)
        mark("train (6, 6b, 6c)")
        data_rates = phase_data(card, dev, hard["step_ms"], probe=False)
        mark("data (7)")
        phase_loop(card, dev, data_rates)
        mark("loop (7b)")
    with stem(True):
        paths["soft"] = run_train(card, dev, "soft", soft=True, per_step=SOFT_PER_STEP)["launches"]
        phase_remat(card, dev, soft=True)
    mark("soft (8)")
    with stem(False):
        spynet = phase_spynet(card, dev)
        phase_t7(card, dev)
        mark("spynet, t7 (10, 11)")
        phase_serving_export(card, dev, sys.argv[1:])
        mark("serving export (12)")
        # phase 14 (b)-(e) runs before phase 13, whose NCCL group this
        # process forms and tears down (the profiler recorded no device
        # time in any window after it in one run)
        spatial = phase_spatial(card, dev, spatial_summary)
        mark("spatial axis (14b-e)")
        phase_ddp(card, dev, dryrun=False)
        mark("data parallelism (13)")
    kernels = []
    for name, key, source, replaces, path in KERNEL_ENTRIES:
        s = summary[key]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"back2future_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": paths[path][f"b2f_{name}"], "max_abs_err": s["err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                        "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels + spynet_kernel_entries(spynet)
                      + spatial_kernel_entries(spatial)}), flush=True)
    print_result()


def spynet_kernel_entries(spynet: dict) -> list:
    """The kernels line's entries of the SPyNet path: launches over its 6
    pme steps, ms per pme step on the step's own inputs."""
    entries = []
    for name, source, replaces in SPY_KERNEL_ENTRIES:
        s = spynet["summary"][name]
        entries.append({"name": f"{name} (spynet pme step)", "route": "cuda",
                        "source": f"back2future_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": spynet["launches"][f"b2f_{name}"], "max_abs_err": s["err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                        "library_ms": s["library_ms"]})
    return entries


def print_result() -> None:
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
