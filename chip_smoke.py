"""Smoke run of the PyTorch + CUDA port (back2future_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, one line each (any failure raises and exits non-zero):
  1. environment: the card (nvidia-smi name and power limit), TF32 flags
  2. build: nvcc of back2future_tpu_torch/csrc into back2future_tpu_torch/_build
     (one nvcc per source, in parallel); the bf16 tensor-core kernels of
     K1, K2 and K3 (win 9), K5 and K6: registers, spills, shared memory,
     resident blocks per SM, and the HMMA / LDGSTS / LDSM instructions of
     their SASS (cuobjdump)
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
     kernels at each shape, in turns in one profiler window
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
     the tensor-core one (new), old / new / new / old, twice
  6. train path, hard recipe (stem off): the options of
     tools/train_bench.py (optimize pme, OBCC + L1, bf16, B=8, 320x640,
     weights from seed 0, numpy-seeded images on the device),
     create_train_state + make_train_step, 6 steps: finite loss and
     components, exact launch counts per step (10 / 18 / 10 / 10 / 18 / 8),
     step ms (CUDA events, median of steps 2-6), triplets/s trained, peak
     device memory; then one f32 step with the kernels and one under
     plain_ops() from the same initial state: loss and every parameter
     gradient compared; then the backward A/B: one bf16 step with the
     CUDA-core K2/K3 (old) and one with the tensor-core ones (new) from
     the same state, every parameter gradient compared, and the step in
     turns old / new / new / old, twice: step ms (CUDA events) and K1-K3
     device ms per step (profiler)
  7. train path, soft fine-tune recipe (stem on): the hard net of phase 6
     turned into a soft one by convert_net_hard_to_soft (OBGCC,
     past_flow, const_vel 1, second-order smoothness), 6 bf16 steps with
     exact launch counts for all eight kernels (1 K5 + 1 K6 + 10 / 18 /
     10 / 10 / 18 / 8), then the f32 kernels-vs-plain_ops() step
  8. one JSON line of the kernels (forward kernels: launches of the
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
# CUDA-core cost volume kernels are for timing only)
SERVING_PER_FORWARD = {"b2f_cost_volume_fwd": 10, "b2f_cost_volume_fwd_cuda_cores": 0,
                       "b2f_warp_bilinear_fwd": 8,
                       "b2f_cost_volume_dref": 0, "b2f_cost_volume_dframe": 0,
                       "b2f_cost_volume_dref_cuda_cores": 0,
                       "b2f_cost_volume_dframe_cuda_cores": 0,
                       "b2f_warp_bilinear_dflow": 0, "b2f_warp_bilinear_dimages": 0,
                       "b2f_stem_unit_a": 0, "b2f_stem_unit_a_cuda_cores": 0,
                       "b2f_stem_unit_b": 0}
SERVING_STEM_PER_FORWARD = dict(SERVING_PER_FORWARD, b2f_stem_unit_a=1, b2f_stem_unit_b=1)
TRAIN_PER_STEP = {"b2f_cost_volume_fwd": 10, "b2f_cost_volume_fwd_cuda_cores": 0,
                  "b2f_warp_bilinear_fwd": 18,
                  "b2f_cost_volume_dref": 10, "b2f_cost_volume_dframe": 10,
                  "b2f_cost_volume_dref_cuda_cores": 0,
                  "b2f_cost_volume_dframe_cuda_cores": 0,
                  "b2f_warp_bilinear_dflow": 18, "b2f_warp_bilinear_dimages": 8,
                  "b2f_stem_unit_a": 0, "b2f_stem_unit_a_cuda_cores": 0,
                  "b2f_stem_unit_b": 0}
SOFT_PER_STEP = dict(TRAIN_PER_STEP, b2f_stem_unit_a=1, b2f_stem_unit_b=1)


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


def mma_build_report(label: str, info: dict, function: str) -> None:
    """What the build made of a bf16 tensor-core kernel: registers, local
    memory and shared memory from the runtime (`info`), spills from the
    build's `-Xptxas -v` report, resident blocks per SM, and its SASS's
    tensor-core (HMMA), cp.async (LDGSTS) and ldmatrix (LDSM) instructions
    by `cuobjdump -sass`, for the function whose mangled name contains
    `function`. No HMMA in the SASS fails."""
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
        n = {op: len(re.findall(rf"\b{op}\b", body)) for op in ("HMMA", "LDGSTS", "LDSM")}
        sass = f"SASS ({tool}): " + ", ".join(f"{k} {v}" for k, v in n.items())
        if not n["HMMA"]:
            raise AssertionError(f"{label}: no HMMA instruction in the built kernel's SASS")
    log("build", f"{label}: {info['registers']} registers, "
                 f"{info['local_bytes']} bytes local memory per thread ({spills}), "
                 f"{info['smem_bytes']} bytes shared memory per block, "
                 f"{info['blocks_per_sm']} resident blocks per SM; {sass}")


def phase_mma_builds() -> None:
    """The build reports of K1's (win 9), K2/K3's (win 9), K5's and K6's
    bf16 tensor-core kernels."""
    from back2future_tpu_torch.ops import cost_volume_bwd_bf16_info, cost_volume_fwd_bf16_info
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
                       names=("mma", None)) -> None:
    """K2's, K3's or K5's old CUDA-core kernel (`old`) beside its
    tensor-core kernel (`new`) on the same bf16 inputs: the old one
    against the twin within 1e-2 of the largest value, and both timed in
    one profiler window (one call of each, in turn, 20 times), told apart
    by kernel name: `names` = (a part of the new kernel's name, of the old
    one's, or None: every other device op, such as the wrappers' weight
    preparation). The old kernel's time goes `per_forward` times into the
    summary's `cuda_cores_ms`."""
    got, want = old(), twin()
    err = (got.float() - want.float()).abs().max().item()
    tol = KERNEL_TOL[torch.bfloat16]
    atol = tol * max(1.0, want.float().abs().max().item())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=atol):
        raise AssertionError(f"{label}, CUDA cores: outside tolerance ({err})")
    times = device_ms(lambda: (new(), old()), 20)
    new_ms = sum(v for n, v in times.items() if names[0] in n)
    old_ms = sum(v for n, v in times.items()
                 if (names[1] in n if names[1] else names[0] not in n))
    if not new_ms or not old_ms:
        raise AssertionError(f"{label}: the profiler did not see both kernels: {times}")
    log("kernels", f"{label}: device time per call (profiler, in turns) tensor cores "
                   f"{new_ms:.4f} ms, CUDA cores {old_ms:.4f} ms ({old_ms / new_ms:.2f}x); "
                   f"CUDA cores max_abs_err {err:.3e}")
    summary[key]["cuda_cores_ms"] += per_forward * old_ms


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
               for k in ("cost_volume", "warp", "cost_volume_dref", "cost_volume_dframe",
                         "warp_dimages", "warp_dflow", "stem_unit_a", "stem_unit_b")}
    for k in ("cost_volume", "cost_volume_dref", "cost_volume_dframe", "stem_unit_a"):
        summary[k]["cuda_cores_ms"] = 0.0

    def check(kernel, label, dtype, kern, twin, per_forward, work, library=None,
              of_largest=False):
        """Compare, time, log; add bf16 results `per_forward` times to the
        summary. `work`: (operations, bytes) of one call, inputs read and
        outputs written once. `library`: one PyTorch call computing the
        same function, or None. `of_largest`: the absolute tolerance is
        taken relative to the largest value (gradients summed over many
        terms). bf16 checks are timed also by the profiler's device time
        per call (`device_ms`) of the kernel, twin and library, which the
        summary takes: single-launch event windows carry the wrapper's
        host time."""
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
            grid = grid_of(flow)
            library = lambda: F.grid_sample(nchw(img), grid, mode="bilinear",   # noqa: E731
                                            padding_mode="border", align_corners=True)
            if dtype == torch.float32:
                lib_err = (library().permute(0, 2, 3, 1)
                           - ops.warp_bilinear_reference(img, flow)).abs().max().item()
                log("kernels", f"grid_sample(border, align_corners) vs the warp twin, f32 "
                               f"{h}x{w}x{c}: max_abs_err {lib_err:.3e}")
            check("warp", f"warp_bilinear {tag} B={B} {h}x{w}x{c}", dtype,
                  lambda: ops.warp_bilinear(img, flow),
                  lambda: ops.warp_bilinear_reference(img, flow), per_forward=2,
                  work=(8 * img.numel(), 2 * nbytes(img) + nbytes(flow)), library=library)

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
            flow = rand((TRAIN_B, h, w, 2), dtype, scale=w / 4)   # reaches past the border
            grid = grid_of(flow)

            def library(mask):
                return lambda: torch.ops.aten.grid_sampler_2d_backward(
                    nchw(g), nchw(img), grid, 0, 1, True, mask)

            where = f"{tag} B={TRAIN_B} {h}x{w}x{c}"
            check("warp_dflow", f"warp_bilinear d_flow {where}", dtype,
                  lambda: ops.warp_bilinear_backward_cuda(img, flow, g, need=(False, True))[1],
                  lambda: ops.warp_bilinear_backward_reference(img, flow, g)[1],
                  per_forward=2, work=(8 * img.numel(), 2 * nbytes(img) + 2 * nbytes(flow)),
                  library=library([False, True]), of_largest=True)
            if feature:   # the image warps' inputs need no gradient
                check("warp_dimages", f"warp_bilinear d_images {where}", dtype,
                      lambda: ops.warp_bilinear_backward_cuda(img, flow, g, need=(True, False))[0],
                      lambda: ops.warp_bilinear_backward_reference(img, flow, g)[0],
                      per_forward=2, work=(8 * img.numel(), 2 * nbytes(img) + nbytes(flow)),
                      library=library([True, False]), of_largest=True)

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
    s = summary["stem_unit_a"]
    log("kernels", f"per soft step (bf16, profiler device time): stem_unit_a tensor cores "
                   f"{s['ms']:.3f} ms with the wrapper's weight preparation (the CUDA-core "
                   f"kernel alone {s['cuda_cores_ms']:.3f} ms in the turns), bound "
                   f"{s['bound_ms']:.4f} ms")
    return summary



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


def phase_serving_k1(card: str, main: dict) -> None:
    """K1's in-model A/B: the device forward at B=16 (stem off) with the
    CUDA-core cost volume (old) and the tensor-core one (new), old / new
    / new / old, twice; the old forward's flow against the new one's."""
    est, x = main["est"], main["x"]
    with torch.inference_mode(), stem(False):
        new_flow = est.net(x, with_warped=False)[0]["flow"].float()
        with k1_cuda_cores():
            old_flow = est.net(x, with_warped=False)[0]["flow"].float()
        scale = new_flow.abs().max().item()
        err = (new_flow - old_flow).abs().max().item()
        log("k1", f"device forward B={B}, finest flow, CUDA-core vs tensor-core cost volume: "
                  f"max_abs_err {err:.3e} (tol {FLOW_TOL_FRAC} x max|flow| = "
                  f"{FLOW_TOL_FRAC * scale:.3e})")
        if err > FLOW_TOL_FRAC * scale:
            raise AssertionError("K1 A/B: the two cost volumes give different flows")
        turns = (True, False, False, True) * 2   # True: the old kernel
        times = []
        for old in turns:
            with k1_cuda_cores() if old else contextlib.nullcontext():
                times.append(cuda_ms(lambda: est.net(x, with_warped=False), 5))
    old_ms, new_ms = (statistics.median(t for t, o in zip(times, turns) if o == side)
                      for side in (True, False))
    log("k1", f"serving forward on the device, B={B} {H}x{W} bf16, stem off, cost volume "
              + " / ".join("old" if o else "new" for o in turns) + ": "
              + " / ".join(f"{t:.2f}" for t in times) + f" ms (CUDA events, medians of 5); "
              f"median old (CUDA cores) {old_ms:.2f} ms, new (tensor cores) {new_ms:.2f} ms "
              f"on {card}")


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


def phase_train_bwd_ab(card: str, dev) -> None:
    """K2/K3's A/B in the hard bf16 train step: one step with the CUDA-core
    backward (old) and one with the tensor-core one (new) from the same
    initial state, every parameter gradient compared; then the step in
    turns old / new / new / old, twice: per turn one warm-up step, the
    median of 3 steps by CUDA events, and the K1-K3 device ms per step of
    2 more (profiler)."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    opt = train_options("bfloat16", soft=False)
    crits = build_criterions(opt)
    batch = train_batch(dev)
    net = train_network(opt, dev)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    grads = {}
    for old in (True, False):
        net.load_state_dict(init)
        step = make_train_step(net, opt, crits)
        with bwd_cuda_cores() if old else contextlib.nullcontext():
            step(create_train_state(net, opt), batch)
        torch.cuda.synchronize()
        grads[old] = {n: p.grad.clone() for n, p in net.named_parameters()}
    ratios = {n: (grads[False][n] - g).float().abs().max().item()
              / max(g.float().abs().max().item(), 1e-30) for n, g in grads[True].items()}
    worst = max(ratios, key=ratios.get)
    within = sum(v <= GRAD_TOL_FRAC for v in ratios.values())
    log("bwd", f"bf16 hard step, CUDA-core vs tensor-core K2/K3: worst gradient max_abs_err / "
               f"max|g| {ratios[worst]:.3e} ({worst}; tol {BF16_GRAD_TOL_FRAC}); {within} of "
               f"{len(ratios)} parameters within {GRAD_TOL_FRAC}")
    if ratios[worst] > BF16_GRAD_TOL_FRAC:
        raise AssertionError("K2/K3 A/B: the two backward paths give different gradients")

    net.load_state_dict(init)
    step = make_train_step(net, opt, crits)
    state = create_train_state(net, opt)

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    turns = (True, False, False, True) * 2   # True: the old kernels
    step_ms, cv_ms = [], []
    for old in turns:
        with bwd_cuda_cores() if old else contextlib.nullcontext():
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
        cv_ms.append(sum(v for n, v in by_name.items() if "cost_volume" in n))
    names = " / ".join("old" if o else "new" for o in turns)
    log("bwd", f"bf16 hard step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}, backward {names}: step "
               + " / ".join(f"{t:.2f}" for t in step_ms) + " ms (CUDA events, medians of 3); "
               "K1-K3 device " + " / ".join(f"{t:.3f}" for t in cv_ms)
               + f" ms per step (profiler) on {card}")
    for label, vals in (("step", step_ms), ("K1-K3 device", cv_ms)):
        old_v, new_v = (statistics.median(v for v, o in zip(vals, turns) if o == side)
                        for side in (True, False))
        log("bwd", f"median {label} ms: old (CUDA cores) {old_v:.3f}, new (tensor cores) "
                   f"{new_v:.3f}")


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


def run_train(card: str, dev, phase: str, soft: bool, per_step: dict) -> dict:
    """6 bf16 steps with launch counts, then an f32 step with the kernels
    against one under plain_ops() from the same initial state."""
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
    return launches


KERNEL_ENTRIES = [   # (name, summary key, source, replaces, path whose launches count)
    ("cost_volume_fwd", "cost_volume", "cost_volume_fwd_mma.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:91", "serving"),
    ("warp_bilinear_fwd", "warp", "warp_fwd.cu", "back2future_tpu/ops/warp.py:96", "serving"),
    ("cost_volume_dref", "cost_volume_dref", "cost_volume_bwd_mma.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:175", "train"),
    ("cost_volume_dframe", "cost_volume_dframe", "cost_volume_bwd_mma.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:203", "train"),
    ("warp_bilinear_dimages", "warp_dimages", "warp_bwd.cu",
     "back2future_tpu/ops/warp_pallas.py:81", "train"),
    ("warp_bilinear_dflow", "warp_dflow", "warp_bwd.cu", "back2future_tpu/ops/warp.py:209",
     "train"),
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
    summary = phase_kernels(dev)
    with stem(False):
        main_path = phase_main_path(card)
    paths = {"serving": main_path["launches"]}
    phase_serving_stem(card, main_path)
    phase_serving_k1(card, main_path)
    del main_path
    with stem(False):
        paths["train"] = run_train(card, dev, "train", soft=False, per_step=TRAIN_PER_STEP)
        phase_train_bwd_ab(card, dev)
    with stem(True):
        paths["soft"] = run_train(card, dev, "soft", soft=True, per_step=SOFT_PER_STEP)
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
