"""Smoke run of the PyTorch + CUDA port (back2future_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, one line each (any failure raises and exits non-zero):
  1. environment: the card (nvidia-smi name and power limit), TF32 flags
  2. build: nvcc of back2future_tpu_torch/csrc into back2future_tpu_torch/_build
     (one nvcc per source, in parallel); the bf16 tensor-core kernels of
     K1, K2 and K3 (win 9), K5 and K6: registers, spills, shared memory,
     resident blocks per SM, and the HMMA / LDGSTS / LDSM instructions of
     their SASS (cuobjdump); the same for the warp gradients' bf16
     kernels with the global reductions and shared-memory atomics (K4) or
     the loads and shuffles (W-dflow) of their SASS, and for the warp
     gather's bf16 kernels (csrc/warp_fwd_tiled.cu: the rows kernel of
     C = 3, the lanes kernel at C = 32, 64, 96, 128) with the loads,
     stores and shuffles of their SASS
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
     wall-clock triplets/s
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
  7. data path, the hard recipe from files on disk (stem off): a
     RoamingImages set of DATA_SCENES scenes at 320x640, 3 frames, written
     by `python -m back2future_tpu_torch.data.roaming`'s main (seconds,
     bytes); a FlowDataset on its train split and a process-mode
     PrefetchLoader (B=8, min(8, host cores) workers; spawn, since CUDA is
     live) in two configurations: (a) learn_demo's recipe data (augment
     0, rand_crop 0, the compact wire, scene_batches full) and (b)
     augment 1 on the f32 wire. For each: the loader alone (samples/s
     over 16 batches after the first and over the workers' second round,
     time to the first batch), the pipe alone (as many producer
     processes as workers, of the same start method, streaming the
     configuration's batch through one queue: their start-up and ms a
     batch, its share of the loader's time a batch), a sample's time in
     sync mode, the first 3 batches bit-identical to sync mode
     (n_workers=0), then 21 hard bf16 steps fed through
     device_prefetch(depth=2): exact launch counts per step, finite loss,
     median step ms over steps 2-21 (CUDA events), triplets/s trained
     (wall clock) and the mean host wait in next(), over steps 2-21 and
     the last 8, beside the random-tensor step of phase 6
  8. train path, soft fine-tune recipe (stem on): the hard net of phase 6
     turned into a soft one by convert_net_hard_to_soft (OBGCC,
     past_flow, const_vel 1, second-order smoothness), 6 bf16 steps with
     exact launch counts for all eight kernels (1 K5 + 1 K6 + 10 / 18 /
     10 / 10 / 18 / 8), then the f32 kernels-vs-plain_ops() step
  9. one JSON line of the kernels (forward kernels: launches of the
     serving path and ms per serving forward; backward kernels: launches
     of the hard train path and ms per train step; K5/K6: launches of the
     soft train path and ms per train step), then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
It imports nothing of JAX and never runs on the CPU.

    python3 chip_smoke.py --profile

runs, after phases 1-2, only a torch.profiler breakdown of the bf16 train
step at B=8, 320x640: the hard recipe, and the soft recipe with the stem
off and on; per step the unprofiled step ms (CUDA events), the device
busy ms (profiled kernel, copy and memset time), the idle share, and the
device time by kind of op.

    python3 chip_smoke.py --data

runs, after phase 1 and the build, only the hard train steps of phase 6
(for the random-tensor step) and the data path of phase 7.

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
"""

from __future__ import annotations

import contextlib
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

# the data path (phase 7): a generated RoamingImages set, the loader's two
# configurations (SampleConfig fields, PrefetchLoader keywords)
DATA_SCENES = 48
DATA_BATCHES = 17                      # the first batch, then 16 timed
DATA_CHECKED = 3                       # batches held against sync mode
DATA_PIPE_PER_WORKER = 3               # batches each pipe-probe producer sends
DATA_STEPS = 21                        # the first step, then 20 timed
DATA_STEADY = 8                        # the last steps, past the workers' prefetch
PIPE_MESSAGES = 6                      # batches each pipe variant sends
DATA_LAUNCHES = ("b2f_cost_volume_fwd", "b2f_warp_bilinear_fwd", "b2f_cost_volume_dref",
                 "b2f_cost_volume_dframe", "b2f_warp_bilinear_dflow", "b2f_warp_bilinear_dimages")
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


def device_ms(fn, reps: int, attempts: int = 3) -> dict:
    """Device time per call of `fn` by kernel name: the CUDA kernels it
    launches, summed by torch.profiler over `reps` calls after a warm-up,
    without the host time between them (which single-launch event windows
    include). A window in which the profiler recorded no device time (it
    happens now and then over many windows) is taken again, up to
    `attempts` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        dump = subprocess.run([tool, "-sass", str(so)], check=True, capture_output=True,
                              text=True, timeout=300).stdout
        body = next((f for f in dump.split("Function : ")[1:]
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
            ms, pms = sum(mine.values()), sum(device_ms(twin, 5).values())
            lms = sum(device_ms(library, 20).values()) if library is not None else None
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

    def grid_of(flow):
        """The warp's pixel offsets as grid_sample's normalised grid
        (align_corners=True); with padding_mode="border" grid_sample
        clamps as the warp does."""
        b, h, w, _ = flow.shape
        fl = flow.float()
        gx = (fl[..., 0] + torch.arange(w, device=dev).view(1, 1, w)) * (2.0 / (w - 1)) - 1
        gy = (fl[..., 1] + torch.arange(h, device=dev).view(1, h, 1)) * (2.0 / (h - 1)) - 1
        return torch.stack([gx, gy], -1).to(flow.dtype)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

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
                    new = lambda: ops.cost_volume_backward_cuda(   # noqa: E731
                        g, ref, frame, *args, need=need)[i]
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
                new = lambda: ops.warp_bilinear_backward_cuda(   # noqa: E731
                    img, flow, g, need=(False, True))[1]
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
                new = lambda: ops.warp_bilinear_backward_cuda(   # noqa: E731
                    img, flow, g, need=(True, False))[0]
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
    for img, flow in serving_warp_inputs(dev):
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
    """Inside the block, each warp gather first appends its (images, flow)
    to `into` (the flow in the image dtype, as the kernel gets it);
    restored after."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.warp")
    fn = module._WarpFn

    class Recording:
        @staticmethod
        def apply(images, flow, reference_grads):
            into.append((images.detach().clone(), flow.detach().clone()))
            return fn.apply(images, flow, reference_grads)

    module._WarpFn = Recording
    try:
        yield
    finally:
        module._WarpFn = fn


def serving_warp_inputs(dev) -> list:
    """The 8 (images, flow) of the gather in one serving forward of the
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
    return dict(launches=launches, est=est, batch=batch, results=res, x=x)


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


@contextlib.contextmanager
def gather_thread():
    """Inside the block, the warp's forward runs the first design's gather
    (b2f_warp_bilinear_fwd_thread); restored after. For the A/B only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.warp")
    kernel = module._FWD
    module._FWD = module._FWD_THREAD
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
    """Inside the block, the cost volume's backward runs the CUDA-core
    kernels (b2f_cost_volume_d*_cuda_cores), the bf16 design
    before the tensor cores; restored after. For the A/B only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.cost_volume")
    fn = module.cost_volume_backward_cuda
    module.cost_volume_backward_cuda = module.cost_volume_backward_cuda_cores
    try:
        yield
    finally:
        module.cost_volume_backward_cuda = fn


@contextlib.contextmanager
def warp_bwd_thread():
    """Inside the block, the warp's backward runs the first design's
    kernels (b2f_warp_bilinear_*_thread); restored after. For the A/B
    only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.warp")
    fn = module.warp_bilinear_backward_cuda
    module.warp_bilinear_backward_cuda = module.warp_bilinear_backward_thread
    try:
        yield
    finally:
        module.warp_bilinear_backward_cuda = fn


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
    """Inside the block, each image-gradient launch of the warp's backward
    first appends a copy of its (flow, g) to `into`; restored after. For
    the route comparison only."""
    import importlib

    module = importlib.import_module("back2future_tpu_torch.ops.warp")
    fn = module.warp_bilinear_backward_cuda

    def recording(images, flow, g, reference_grads=True, need=(True, True)):
        if need[0]:
            into.append((flow.clone(), g.clone()))
        return fn(images, flow, g, reference_grads, need)

    module.warp_bilinear_backward_cuda = recording
    try:
        yield
    finally:
        module.warp_bilinear_backward_cuda = fn


def k4_routes_ms(flow, g) -> dict:
    """K4 on one input with each of its route settings (K4_ROUTES: as the
    path allows them by the grid, direct on every block, the window
    wherever the box fits): per setting (window-route blocks, all blocks,
    ms). The three results agree within 1e-5 of the largest value (f32
    sums in another order); the times are profiler device times of the
    kernel alone per call, in turns (each setting once, then in reverse),
    medians."""
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.ops.warp import K4_ROUTES

    res, got = {}, {}
    for route in K4_ROUTES:
        got[route], n_window, blocks = ops.warp_dimages_routes(flow, g, route)
        res[route] = (n_window, blocks, [])
    scale = max(got["direct"].abs().max().item(), 1e-30)
    for route in K4_ROUTES:
        if (got[route] - got["direct"]).abs().max().item() > 1e-5 * scale:
            raise AssertionError(f"K4's routes disagree: {route} against direct")
    for route in K4_ROUTES + K4_ROUTES[::-1]:
        t = device_ms(lambda: ops.warp_dimages_routes(flow, g, route), 20)
        res[route][2].append(sum(v for n, v in t.items() if "dimages_tiled" in n))
    return {r: (n, b, statistics.median(ms)) for r, (n, b, ms) in res.items()}


def phase_k4_routes(card: str, dev) -> None:
    """K4's routes against each other on the same bf16 inputs: at the
    four feature-warp shapes of the train step (B=8, 320x640) on random
    flows (i.i.d., w/4) and smooth ones (a 2x upsample of a 1-pixel coarse
    field), and on the hard step's own K4 inputs (the 8 (flow, g) of its
    third step from the seeded net): per call and per step, the blocks
    that take the window route and the kernel's device ms as the path
    chooses (by the grid), with every block direct, and with the window
    wherever the box fits."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(2)

    def rand(shape, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(dev, torch.bfloat16)

    inputs = {"random": [], "smooth": [], "step": []}   # (flow, g, launches a step)
    for (h, w, c) in TRAIN_LEVELS[:4]:
        g = rand((TRAIN_B, h, w, c))
        inputs["random"].append((rand((TRAIN_B, h, w, 2), w / 4), g, 2))
        inputs["smooth"].append((smooth_flow(rng, (TRAIN_B, h, w), torch.bfloat16, dev), g, 2))
    opt = train_options("bfloat16", soft=False)
    net = train_network(opt, dev)
    step = make_train_step(net, opt, build_criterions(opt))
    state, batch = create_train_state(net, opt), train_batch(dev)
    for _ in range(2):
        state, _ = step(state, batch)
    recorded = []
    with recording_k4_inputs(recorded):
        step(state, batch)
    if len(recorded) != TRAIN_PER_STEP["b2f_warp_bilinear_dimages"]:
        raise AssertionError(f"recorded {len(recorded)} K4 launches of one step")
    inputs["step"] = [(flow, g, 1) for flow, g in recorded]

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
        log("k4", f"{kind} flows, K4 per hard step (8 launches): {words(totals)}; on {card}")


def train_options(dtype: str, soft: bool):
    from back2future_tpu_torch.config import Options

    extra = (dict(pme_criterion="OBGCC", past_flow=True, const_vel=1.0,
                  smooth_second_order=True) if soft else {})
    return Options(optimize="pme", compute_dtype=dtype, batchSize=TRAIN_B, **extra).derive()


def train_network(opt, dev):
    """The net of `opt` with weights from seed 0; a soft net gets them by
    surgery from the hard net of seed 0."""
    from back2future_tpu_torch.models import (
        PWCNet, convert_net_hard_to_soft, pwc_config_from_options,
    )

    def seeded(o):
        return PWCNet(pwc_config_from_options(o), generator=torch.Generator().manual_seed(0))

    if not opt.past_flow:
        return seeded(opt).to(dev)
    hard = seeded(train_options(opt.compute_dtype, soft=False))
    return convert_net_hard_to_soft(hard, PWCNet(pwc_config_from_options(opt))).to(dev)


def train_batch(dev) -> dict:
    """The seeded B=8 320x640 batch of the train phases, on the device."""
    rng = np.random.RandomState(0)
    images = rng.randn(TRAIN_B, TRAIN_H, TRAIN_W, 9).astype(np.float32)
    return {"images": torch.from_numpy(images).to(dev)}


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
    """The 18 (images, flow) of the gather in the third bf16 hard train
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
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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
                              b, h, w, c, stream_ptr(dev)):
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
                                                                         for img, flow in own]}
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


def run_train(card: str, dev, phase: str, soft: bool, per_step: dict) -> dict:
    """6 bf16 steps with launch counts, then an f32 step with the kernels
    against one under plain_ops() from the same initial state. Returns
    the launch counts and the bf16 step ms."""
    from back2future_tpu_torch import ops
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
    events, logs = [], []
    for i in range(TRAIN_STEPS):
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
    launches = counts()
    times = [a.elapsed_time(b) for a, b in events]
    values = {k: [lg[k].item() for lg in logs] for k in logs[0]}
    if not all(np.isfinite(v).all() for v in values.values()):
        raise AssertionError(f"{phase}: non-finite loss or component: {values}")
    log(phase, f"6 bf16 steps B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: loss "
               f"{['%.4f' % v for v in values['loss']]}; step 6 components "
               + ", ".join(f"{k} {v[-1]:.5g}" for k, v in values.items() if k != "loss"))
    log(phase, f"launches over {TRAIN_STEPS} steps {launches} ({per_step} per step)")
    step_ms = statistics.median(times[1:])
    log(phase, f"bf16 train step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: {step_ms:.2f} ms "
               f"(CUDA events, median of steps 2-{TRAIN_STEPS}; all {['%.2f' % t for t in times]}), "
               f"{TRAIN_B / step_ms * 1e3:.2f} triplets/s trained, peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}")

    # f32, one step each way from the same initial state: kernels, plain_ops()
    opt32 = train_options("float32", soft)
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
    ratios = {name: (grads_k[name] - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
              for name, gp in grads_p.items()}
    worst_name = max(ratios, key=ratios.get)
    stem_worst = max(v for k, v in ratios.items() if k.startswith(("feat_2.", "feat_3.")))
    log(phase, f"f32 step, kernels vs plain_ops(): loss {loss_k:.6f} vs {loss_p:.6f} "
               f"(rtol {LOSS_RTOL}); worst gradient max_abs_err / max|g| "
               f"{ratios[worst_name]:.3e} ({worst_name}; tol {GRAD_TOL_FRAC}) over "
               f"{len(grads_p)} parameters; feat_2/feat_3 worst {stem_worst:.3e}")
    if not (abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p) and ratios[worst_name] <= GRAD_TOL_FRAC):
        raise AssertionError(f"{phase}: train step with kernels and under plain_ops() disagree")
    return {"launches": launches, "step_ms": step_ms}


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


def phase_data(card: str, dev, random_step_ms: float) -> None:
    """The hard bf16 step fed from files on disk through the port's own
    generator, loader and device prefetch (module docstring, phase 7)."""
    import tempfile
    from pathlib import Path

    from back2future_tpu_torch.data import (
        FlowDataset, PrefetchLoader, SampleConfig, device_prefetch, load_manifest, load_split,
    )
    from back2future_tpu_torch.data import roaming
    from back2future_tpu_torch.data.loader import _cuda_live
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    phase_t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    method = os.environ.get("B2F_MP_START", "") or ("spawn" if _cuda_live() else "fork")
    opt = train_options("bfloat16", soft=False)
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
                    f"{method}; on {card}")
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
            startup_s, pipe = pipe_probe(got[0]["images"].shape, cfg.wire, method, workers,
                                         DATA_PIPE_PER_WORKER)
            dumps_ms, loads_ms = pickle_ms(got[0])

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
                        f"{workers} workers' {method} start-up {startup_s:.2f} s; pipe alone "
                        f"{pipe:.1f} ms a batch ({workers} {method} producers, one queue; "
                        f"pickle dumps {dumps_ms:.1f} + loads {loads_ms:.1f} ms in one "
                        f"process), {pipe / batch_ms:.3f} of the loader's time a batch; a "
                        f"sample in sync mode {sample_ms:.1f} ms (one process); the first "
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


def main() -> None:
    card = phase_environment()

    dev = torch.device("cuda")
    phase_build()
    if "--pipe-variants" in sys.argv[1:]:
        phase_pipe_variants(card)
        return
    if "--data" in sys.argv[1:]:
        with stem(False):
            hard = run_train(card, dev, "train", soft=False, per_step=TRAIN_PER_STEP)
            phase_data(card, dev, hard["step_ms"])
        return
    phase_mma_builds()
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
    summary = phase_kernels(dev)
    with stem(False):
        main_path = phase_main_path(card)
    paths = {"serving": main_path["launches"]}
    phase_serving_stem(card, main_path)
    for ab in SERVING_AB:
        phase_serving_ab(card, main_path, *ab)
    del main_path
    with stem(False):
        hard = run_train(card, dev, "train", soft=False, per_step=TRAIN_PER_STEP)
        paths["train"] = hard["launches"]
        phase_train_bwd_ab(card, dev)
        phase_k4_routes(card, dev)
        phase_data(card, dev, hard["step_ms"])
    with stem(True):
        paths["soft"] = run_train(card, dev, "soft", soft=True, per_step=SOFT_PER_STEP)["launches"]
    kernels = []
    for name, key, source, replaces, path in KERNEL_ENTRIES:
        s = summary[key]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"back2future_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": paths[path][f"b2f_{name}"], "max_abs_err": s["err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                        "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
