"""Single-triplet serving latency of the port (counterpart of
tools/serve_bench.py): ms per B=1 `compute_flow` call.

The reference's serving shape is one triplet per `computeFlow` call
(back2future.lua:47-95). This measures what a serving user waits for,
the whole `FlowEstimator.__call__` (host pre-processing, the forward,
the device-to-host fetch, host post-processing), and each of those
parts on its own, for the eager estimator and, with --export, for the
`torch.export` artifact served by `load_exported` (one B=1 bucket per
resolution, exported into a temporary directory).

Each call is timed alone (a barrier per call). On the card the forward
and the fetch end in `torch.cuda.synchronize()`, so their host clocks
hold the device's time; `warmup_s` is the eager `warmup()` (kernel
library load, first launches, cuDNN plans) or the artifact's load plus
its first call.

    python -m back2future_tpu_torch.serve_bench [--iters 20] [--export] \
        [--checkpoint CKPT] [--cpu]

Prints one JSON line per (resolution, path) with median component ms.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

# (name, raw H, raw W): the two reference eval resolutions
# (opts.lua:125-130 Kitti/Sintel defaults); /64-snapped inside the API
RESOLUTIONS = [("kitti", 375, 1242), ("sintel", 436, 1024)]


def _median_ms(fn, iters: int) -> float:
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def measure(path: str, name: str, h: int, w: int, serve, forward, warmup_s: float,
            ims, frames: int, device, iters: int) -> dict:
    """One JSON record: `serve(*ims)` whole, then its parts; `forward(x)`
    is the device forward of the preprocessed input, returning (flow,
    occ) tensors."""
    import torch

    from back2future_tpu_torch.api import _numpy, _postprocess_results, _preprocess_triplets

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    serve(*ims)   # one whole warm call (host caches, allocator)
    total = _median_ms(lambda: serve(*ims), iters)
    pre = _median_ms(lambda: _preprocess_triplets([im[None] for im in ims], frames), iters)
    imgs, n, _, _ = _preprocess_triplets([im[None] for im in ims], frames)
    x = torch.from_numpy(imgs).to(device)

    def fwd():
        with torch.inference_mode():
            out = forward(x)
        sync()
        return out

    fwd()
    fwd_ms = _median_ms(fwd, iters)
    f_d, o_d = fwd()
    fetch = _median_ms(lambda: (_numpy(f_d), _numpy(o_d)), iters)
    f_h, o_h = _numpy(f_d), _numpy(o_d)
    post = _median_ms(lambda: _postprocess_results(f_h, o_h, n, h, w), iters)
    return {"path": path, "resolution": name, "raw_hw": [h, w],
            "warmup_s": round(warmup_s, 3), "total_ms": round(total, 3),
            "pre_ms": round(pre, 3), "forward_ms": round(fwd_ms, 3),
            "fetch_ms": round(fetch, 3), "post_ms": round(post, 3), "iters": iters,
            "device": device.type}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--export", action="store_true",
                    help="also time the exported artifact (load_exported)")
    ap.add_argument("--checkpoint", default="",
                    help="serve this checkpoint (default: random weights, seed 0, bf16)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from back2future_tpu_torch.api import _bucket, init, load_exported

    device = "cpu" if args.cpu else "cuda"
    est = init(args.checkpoint or None, device=device)
    frames = est.config.frames

    def eager_forward(x):
        g = est.net(x, with_warped=False)[0]
        return g["flow"], g["occ"]

    rng = np.random.RandomState(0)
    results = []
    for name, h, w in RESOLUTIONS:
        ims = [rng.rand(h, w, 3).astype(np.float32) for _ in range(frames)]
        t0 = time.perf_counter()
        est.warmup([(h, w)])
        warmup_s = time.perf_counter() - t0
        rec = measure("eager", name, h, w, est, eager_forward, warmup_s, ims, frames,
                      est.device, args.iters)
        print(json.dumps(rec), flush=True)
        results.append(rec)

        if args.export:
            with tempfile.TemporaryDirectory() as td:
                art = Path(td) / f"flow_{name}"
                est.export(art, [(h, w)])
                t0 = time.perf_counter()
                served = load_exported(art, device=device)
                served(*ims)   # the first call loads the bucket's program
                warm_s = time.perf_counter() - t0
                rec = measure("exported", name, h, w, served, served.module(_bucket((h, w))),
                              warm_s, ims, frames, est.device, args.iters)
            print(json.dumps(rec), flush=True)
            results.append(rec)
    return results


if __name__ == "__main__":
    main()
