"""Smoke run of the PyTorch + CUDA port (back2future_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, one line each (any failure raises and exits non-zero):
  1. environment: the card (nvidia-smi name and power limit), TF32 flags
  2. build: nvcc of back2future_tpu_torch/csrc into back2future_tpu_torch/_build
     (one nvcc per source, in parallel)
  3. kernels against their plain torch twins, in bf16 and f32, with the
     max abs error, the tolerance and CUDA-event medians: the forward
     kernels at the shapes of the flagship serving forward at B=16 (KITTI
     1242x375 snapped to 1216x320); the backward kernels (cost volume
     d_ref / d_frame, warp image and flow gradients) at the shapes of the
     train step at B=8, 320x640, fwd and past, with flows past the border
  4. serving path: init(None, device="cuda") with the flagship config
     (frames 3, levels 7, win 9, skip 2, bf16, random weights from seed 0),
     compute_flow / compute_flow_batch (B=16, three times) /
     compute_flow_video on seeded requests; shapes, finite values, launch
     counts (10 cost volumes and 8 feature warps per serving forward, no
     backward kernel), a plain_ops() rerun of one batch for comparison,
     wall-clock triplets/s
  5. train path: the hard unsupervised recipe of tools/train_bench.py
     (optimize pme, OBCC + L1, bf16, B=8, 320x640, weights from seed 0,
     numpy-seeded images on the device), create_train_state +
     make_train_step, 6 steps: finite loss and components, exact launch
     counts per step (10 / 18 / 10 / 10 / 18 / 8), step ms (CUDA events,
     median of steps 2-6), triplets/s trained, peak device memory; then one
     f32 step with the kernels and one under plain_ops() from the same
     initial state: loss and every parameter gradient compared
  6. one JSON line of the kernels (forward kernels: launches of the
     serving path and ms per serving forward; backward kernels: launches
     of the train path and ms per train step), then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
It imports nothing of JAX and never runs on the CPU.
"""

from __future__ import annotations

import contextlib
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

# the train step of tools/train_bench.py: B=8, 320x640; levels 3..7 of it
TRAIN_B, TRAIN_H, TRAIN_W = 8, 320, 640
TRAIN_LEVELS = [(TRAIN_H >> (l - 1), TRAIN_W >> (l - 1), c)
                for l, c in zip(range(3, 8), (32, 64, 96, 128, 192))]
# the image warps run at the output size of levels 3..7 (skip 2: full size first)
IMAGE_WARP_SHAPES = [(TRAIN_H >> j, TRAIN_W >> j, 3) for j in range(5)]
TRAIN_STEPS = 6
# f32 train step, kernels vs plain_ops(): sums in another order, and the
# image gradient's f32 atomics in an order that varies from run to run
LOSS_RTOL = 1e-4
GRAD_TOL_FRAC = 1e-3                   # of max |gradient| per parameter

# launches of one serving forward and of one train step, per kernel
SERVING_PER_FORWARD = {"b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 8,
                       "b2f_cost_volume_dref": 0, "b2f_cost_volume_dframe": 0,
                       "b2f_warp_bilinear_dflow": 0, "b2f_warp_bilinear_dimages": 0}
TRAIN_PER_STEP = {"b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 18,
                  "b2f_cost_volume_dref": 10, "b2f_cost_volume_dframe": 10,
                  "b2f_warp_bilinear_dflow": 18, "b2f_warp_bilinear_dimages": 8}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def counts() -> dict:
    from back2future_tpu_torch.runtime import KERNELS

    return {k: v.launches for k, v in KERNELS.items()}


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
    per-kernel summary (bf16 max error, summed ms per serving forward for
    the forward kernels and per train step for the backward kernels)."""
    from back2future_tpu_torch import ops

    rng = np.random.default_rng(0)

    def rand(shape, dtype, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(dev, dtype)

    summary = {k: dict(err=0.0, ms=0.0, plain_ms=0.0)
               for k in ("cost_volume", "warp", "cost_volume_dref", "cost_volume_dframe",
                         "warp_dimages", "warp_dflow")}

    def check(kernel, label, dtype, kern, twin, per_forward, of_largest=False):
        """Compare, time, log; add bf16 results `per_forward` times to the
        summary. `of_largest`: the absolute tolerance is taken relative to
        the largest value (gradients summed over many terms)."""
        tol = KERNEL_TOL[dtype]
        got, want = kern(), twin()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        atol = tol * max(1.0, want.float().abs().max().item()) if of_largest else tol
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=atol)
        ms, pms = cuda_ms(kern, 20), cuda_ms(twin, 5)
        log("kernels", f"{label}: max_abs_err {err:.3e} (tol rtol={tol:g} atol={atol:.3g}) "
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

        # backward kernels at the train step's shapes: one future and one
        # past volume per level, 8 feature warps (levels 6..3) and 10 image
        # warps (levels 3..7) per step
        for (h, w, c) in TRAIN_LEVELS:
            ref, frame = rand((TRAIN_B, h, w, c), dtype), rand((TRAIN_B, h, w, c), dtype)
            g = rand((TRAIN_B, h, w, WIN * WIN), dtype)
            for fwd in (True, False):
                where = f"{tag} B={TRAIN_B} {h}x{w}x{c} {'fwd' if fwd else 'past'}"
                args = (WIN, 1, fwd, 1.0 / c)
                for i, name in enumerate(("d_ref", "d_frame")):
                    need = (i == 0, i == 1)
                    check(f"cost_volume_{name.replace('_', '')}", f"cost_volume {name} {where}",
                          dtype,
                          lambda: ops.cost_volume_backward_cuda(g, ref, frame, *args, need=need)[i],
                          lambda: ops.cost_volume_backward_reference(g, ref, frame, *args)[i],
                          per_forward=1, of_largest=True)
        warps = [(shape, True) for shape in TRAIN_LEVELS[:4]] + \
            [(shape, False) for shape in IMAGE_WARP_SHAPES]
        for (h, w, c), feature in warps:
            img, g = rand((TRAIN_B, h, w, c), dtype), rand((TRAIN_B, h, w, c), dtype)
            flow = rand((TRAIN_B, h, w, 2), dtype, scale=w / 4)   # reaches past the border
            where = f"{tag} B={TRAIN_B} {h}x{w}x{c}"
            check("warp_dflow", f"warp_bilinear d_flow {where}", dtype,
                  lambda: ops.warp_bilinear_backward_cuda(img, flow, g, need=(False, True))[1],
                  lambda: ops.warp_bilinear_backward_reference(img, flow, g)[1],
                  per_forward=2, of_largest=True)
            if feature:   # the image warps' inputs need no gradient
                check("warp_dimages", f"warp_bilinear d_images {where}", dtype,
                      lambda: ops.warp_bilinear_backward_cuda(img, flow, g, need=(True, False))[0],
                      lambda: ops.warp_bilinear_backward_reference(img, flow, g)[0],
                      per_forward=2, of_largest=True)

    log("kernels", "per serving forward (bf16, B=16): cost volume kernel "
                   f"{summary['cost_volume']['ms']:.3f} ms vs twin "
                   f"{summary['cost_volume']['plain_ms']:.3f} ms; warp kernel "
                   f"{summary['warp']['ms']:.3f} ms vs twin {summary['warp']['plain_ms']:.3f} ms")
    log("kernels", f"per train step (bf16, B={TRAIN_B}, {TRAIN_H}x{TRAIN_W}): " + "; ".join(
        f"{k} kernel {summary[k]['ms']:.3f} ms vs twin {summary[k]['plain_ms']:.3f} ms"
        for k in ("cost_volume_dref", "cost_volume_dframe", "warp_dimages", "warp_dflow")))
    return summary


def phase_main_path(card: str) -> dict:
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

    def check(results, n):
        flow, fwd_occ, bwd_occ = results
        assert flow.shape == (n, H_IN, W_IN, 2) and flow.dtype == np.float32, flow.shape
        assert np.isfinite(flow).all()
        for occ in (fwd_occ, bwd_occ):
            assert occ.shape == (n, H_IN, W_IN) and occ.dtype == bool, occ.shape

    per_forward = SERVING_PER_FORWARD
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


def phase_train(card: str, dev) -> dict:
    """The train path: 6 bf16 steps of the hard recipe with launch counts,
    then an f32 step with the kernels against one under plain_ops()."""
    from back2future_tpu_torch import ops
    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.models import PWCNet, pwc_config_from_options
    from back2future_tpu_torch.runtime import reset_launches
    from back2future_tpu_torch.train import create_train_state, make_train_step

    def options(dtype):
        return Options(optimize="pme", compute_dtype=dtype, batchSize=TRAIN_B).derive()

    def network(opt):
        return PWCNet(pwc_config_from_options(opt),
                      generator=torch.Generator().manual_seed(0)).to(dev)

    opt = options("bfloat16")
    assert (opt.pme_criterion, opt.pme_penalty, opt.smooth_occ_penalty, opt.past_flow,
            opt.reference_grads, opt.optimizer) == ("OBCC", "L1", "Quadratic", False, True,
                                                    "adam"), opt
    rng = np.random.RandomState(0)
    images = rng.randn(TRAIN_B, TRAIN_H, TRAIN_W, 3 * opt.frames).astype(np.float32)
    batch = {"images": torch.from_numpy(images).to(dev)}

    net = network(opt)
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
        per_step = {k: done[k] - before[k] for k in done}
        if per_step != TRAIN_PER_STEP:
            raise AssertionError(f"train step {i + 1} launched {per_step}, "
                                 f"expected {TRAIN_PER_STEP}")
    torch.cuda.synchronize()
    launches = counts()
    times = [a.elapsed_time(b) for a, b in events]
    values = {k: [lg[k].item() for lg in logs] for k in logs[0]}
    if not all(np.isfinite(v).all() for v in values.values()):
        raise AssertionError(f"non-finite loss or component: {values}")
    log("train", f"6 bf16 steps B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: loss "
                 f"{['%.4f' % v for v in values['loss']]}; step 6 components "
                 + ", ".join(f"{k} {v[-1]:.5g}" for k, v in values.items() if k != "loss"))
    log("train", f"launches over {TRAIN_STEPS} steps {launches} ({TRAIN_PER_STEP} per step)")
    step_ms = statistics.median(times[1:])
    log("train", f"bf16 train step B={TRAIN_B} {TRAIN_H}x{TRAIN_W}: {step_ms:.2f} ms "
                 f"(CUDA events, median of steps 2-{TRAIN_STEPS}; all {['%.2f' % t for t in times]}), "
                 f"{TRAIN_B / step_ms * 1e3:.2f} triplets/s trained, peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}")

    # f32, one step each way from the same initial state: kernels, plain_ops()
    opt32 = options("float32")
    crits32 = build_criterions(opt32)
    net32 = network(opt32)
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
    worst, worst_name = 0.0, ""
    for name, gp in grads_p.items():
        ratio = (grads_k[name] - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
    log("train", f"f32 step, kernels vs plain_ops(): loss {loss_k:.6f} vs {loss_p:.6f} "
                 f"(rtol {LOSS_RTOL}); worst gradient max_abs_err / max|g| {worst:.3e} "
                 f"({worst_name}; tol {GRAD_TOL_FRAC}) over {len(grads_p)} parameters")
    if not (abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p) and worst <= GRAD_TOL_FRAC):
        raise AssertionError("train step with kernels and under plain_ops() disagree")
    return launches


KERNEL_ENTRIES = [   # (name, summary key, source, replaces)
    ("cost_volume_fwd", "cost_volume", "cost_volume_fwd.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:91"),
    ("warp_bilinear_fwd", "warp", "warp_fwd.cu", "back2future_tpu/ops/warp.py:96"),
    ("cost_volume_dref", "cost_volume_dref", "cost_volume_bwd.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:175"),
    ("cost_volume_dframe", "cost_volume_dframe", "cost_volume_bwd.cu",
     "back2future_tpu/ops/cost_volume_pallas.py:203"),
    ("warp_bilinear_dimages", "warp_dimages", "warp_bwd.cu",
     "back2future_tpu/ops/warp_pallas.py:81"),
    ("warp_bilinear_dflow", "warp_dflow", "warp_bwd.cu", "back2future_tpu/ops/warp.py:209"),
]


def main() -> None:
    card = phase_environment()

    dev = torch.device("cuda")
    phase_build()
    summary = phase_kernels(dev)
    serving = phase_main_path(card)
    train = phase_train(card, dev)
    kernels = []
    for name, key, source, replaces in KERNEL_ENTRIES:
        symbol = f"b2f_{name}"
        launches = serving[symbol] if SERVING_PER_FORWARD[symbol] else train[symbol]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"back2future_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": launches, "max_abs_err": summary[key]["err"],
                        "ms": summary[key]["ms"], "plain_ms": summary[key]["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
