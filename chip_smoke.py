"""Smoke run of the PyTorch + CUDA port (back2future_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, one line each (any failure raises and exits non-zero):
  1. environment: the card (nvidia-smi name and power limit), TF32 flags
  2. build: nvcc of back2future_tpu_torch/csrc into back2future_tpu_torch/_build
  3. kernels against their plain torch twins, in bf16 and f32, at the
     shapes of the flagship serving forward at B=16 (KITTI 1242x375
     snapped to 1216x320): max abs error, tolerance, CUDA-event medians
  4. main path: init(None, device="cuda") with the flagship config
     (frames 3, levels 7, win 9, skip 2, bf16, random weights from seed 0),
     compute_flow / compute_flow_batch (B=16, three times) /
     compute_flow_video on seeded requests; shapes, finite values, launch
     counts (10 cost volumes and 8 feature warps per serving forward), a
     plain_ops() rerun of one batch for comparison, wall-clock triplets/s
  5. one JSON line of the kernels, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
It imports nothing of JAX and never runs on the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

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


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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


def phase_kernels(dev) -> dict:
    """Each kernel against its twin at every main-path shape; returns the
    per-kernel summary (bf16 max error, summed ms per serving forward)."""
    from back2future_tpu_torch import ops

    rng = np.random.default_rng(0)

    def rand(shape, dtype, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(dev, dtype)

    summary = {"cost_volume": dict(err=0.0, ms=0.0, plain_ms=0.0),
               "warp": dict(err=0.0, ms=0.0, plain_ms=0.0)}

    def check(kernel, label, dtype, kern, twin, per_forward):
        """Compare, time, log; add bf16 results `per_forward` times to the summary."""
        tol = KERNEL_TOL[dtype]
        got, want = kern(), twin()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        ms, pms = cuda_ms(kern, 20), cuda_ms(twin, 5)
        log("kernels", f"{label}: max_abs_err {err:.3e} (tol rtol=atol={tol:g}) "
                       f"kernel {ms:.4f} ms twin {pms:.4f} ms")
        if not ok:
            raise AssertionError(f"{label}: outside tolerance ({err})")
        if dtype == torch.bfloat16:
            s = summary[kernel]
            s["err"] = max(s["err"], err)
            s["ms"] += per_forward * ms
            s["plain_ms"] += per_forward * pms

    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for (h, w, c) in LEVEL_SHAPES:
            ref, frame = rand((B, h, w, c), dtype), rand((B, h, w, c), dtype)
            for fwd in (True, False):
                check("cost_volume",
                      f"cost_volume {tag} B={B} {h}x{w}x{c} {'fwd' if fwd else 'past'}",
                      dtype,
                      lambda: ops.cost_volume(ref, frame, WIN, 1, fwd, scale=1.0 / c),
                      lambda: ops.cost_volume_reference(ref, frame, WIN, 1, fwd, scale=1.0 / c),
                      per_forward=1)
        # feature warps run at levels 6..3, once per non-reference frame
        for (h, w, c) in LEVEL_SHAPES[:4]:
            img = rand((B, h, w, c), dtype)
            flow = rand((B, h, w, 2), dtype, scale=w / 4)   # reaches past the border
            check("warp", f"warp_bilinear {tag} B={B} {h}x{w}x{c}", dtype,
                  lambda: ops.warp_bilinear(img, flow),
                  lambda: ops.warp_bilinear_reference(img, flow), per_forward=2)
    log("kernels", "per serving forward (bf16, B=16): cost volume kernel "
                   f"{summary['cost_volume']['ms']:.3f} ms vs twin "
                   f"{summary['cost_volume']['plain_ms']:.3f} ms; warp kernel "
                   f"{summary['warp']['ms']:.3f} ms vs twin {summary['warp']['plain_ms']:.3f} ms")
    return summary


def phase_main_path(card: str) -> dict:
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.api import init
    from back2future_tpu_torch.runtime import KERNELS, reset_launches

    est = init(None, device="cuda", seed=0)
    cfg = est.config
    assert (cfg.frames, cfg.levels, cfg.win, cfg.skip, cfg.siamese, cfg.dtype) == \
        (3, 7, 9, 2, 1, torch.bfloat16), cfg
    rng = np.random.default_rng(0)

    def images(n):
        return rng.random((n, H_IN, W_IN, 3), dtype=np.float32)

    def check(results, n):
        flow, fwd_occ, bwd_occ = results
        assert flow.shape == (n, H_IN, W_IN, 2) and flow.dtype == np.float32, flow.shape
        assert np.isfinite(flow).all()
        for occ in (fwd_occ, bwd_occ):
            assert occ.shape == (n, H_IN, W_IN) and occ.dtype == bool, occ.shape

    def counts():
        return {k: v.launches for k, v in KERNELS.items()}

    per_forward = {"b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 8}
    triplet = [im[0] for im in (images(1), images(1), images(1))]
    batch = [images(B) for _ in range(3)]
    video = images(5)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    flow, fo, bo = est(*triplet)
    check((flow[None], fo[None], bo[None]), 1)
    if counts() != per_forward:
        raise AssertionError(f"one serving forward launched {counts()}, expected {per_forward}")
    log("main", f"compute_flow 1x{H_IN}x{W_IN}: flow {flow.shape}, launches {counts()}")

    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = est.compute_flow_batch(*batch)
        walls.append(time.perf_counter() - t0)
        check(res, B)
        log("main", f"compute_flow_batch B={B} call {i + 1}: {walls[-1] * 1e3:.1f} ms "
                    f"wall, {B / walls[-1]:.2f} triplets/s")
    video_res = est.compute_flow_video(video)
    check(video_res, 3)
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
    scale = float(np.abs(want[0]).max())
    flow_err = float(np.abs(res[0] - want[0]).max())
    occ_diff = max(float(np.mean(res[k] != want[k])) for k in (1, 2))
    log("main", f"kernels vs plain_ops() on the B={B} batch: flow max_abs_err "
                f"{flow_err:.3e} (tol {FLOW_TOL_FRAC} x max|flow| = "
                f"{FLOW_TOL_FRAC * scale:.3e}); occlusion masks differ on "
                f"{occ_diff:.2e} of pixels (tol {OCC_TOL})")
    if not (flow_err <= FLOW_TOL_FRAC * scale and occ_diff <= OCC_TOL):
        raise AssertionError("kernel path and plain_ops() path disagree")

    # the device side alone: one serving forward on a normalised-sized input
    x = torch.from_numpy(rng.standard_normal((B, H, W, 9), dtype=np.float32)).cuda()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: est.net(x, with_warped=False), 5)
    log("main", f"serving forward on the device, B={B} {H}x{W} bf16: {fwd_ms:.2f} ms "
                f"(CUDA events, median of 5) on {card}")
    return launches


def main() -> None:
    card = phase_environment()

    dev = torch.device("cuda")
    phase_build()
    summary = phase_kernels(dev)
    launches = phase_main_path(card)
    kernels = [
        {"name": "cost_volume_fwd", "route": "cuda",
         "source": "back2future_tpu_torch/csrc/cost_volume_fwd.cu",
         "replaces": "back2future_tpu/ops/cost_volume_pallas.py:91",
         "launches": launches["b2f_cost_volume_fwd"],
         "max_abs_err": summary["cost_volume"]["err"],
         "ms": summary["cost_volume"]["ms"], "plain_ms": summary["cost_volume"]["plain_ms"]},
        {"name": "warp_bilinear_fwd", "route": "cuda",
         "source": "back2future_tpu_torch/csrc/warp_fwd.cu",
         "replaces": "back2future_tpu/ops/warp.py:96",
         "launches": launches["b2f_warp_bilinear_fwd"],
         "max_abs_err": summary["warp"]["err"],
         "ms": summary["warp"]["ms"], "plain_ms": summary["warp"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
