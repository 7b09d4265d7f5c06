"""Pretrained-weight parity harness of the port (counterpart of
tools/parity.py): the BASELINE.md correctness gate.

Given a reference `.t7` checkpoint (or an already-converted checkpoint),
run the 3-frame inference path on a frame triplet, write the resulting
`flow.flo`, and — when a reference `.flo` is provided — compare against
it and exit nonzero if the AEPE exceeds the tolerance (0.05 px by
default, the BASELINE.md north-star bound).

    python -m back2future_tpu_torch.parity --t7 Ours-Soft-ft-KITTI.t7 \
        --frames frame_0009.png frame_0010.png frame_0011.png \
        --ref_flo reference_flow.flo --out parity_out [--cpu]

It runs on the card unless `--cpu` asks for the CPU. Reference semantics
being gated: back2future.lua:47-130 (computeFlow returns flow in raw
network units — multiply by flownet_factor (20, opts.lua:92) for pixels;
the AEPE gate is applied in pixels).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def compare_flows(flow, ref_flow, factor: float = 20.0) -> dict:
    """AEPE between two flow fields in raw units -> stats dict in both
    raw units and pixels (EPE definition: L2Criterion.lua:18-75)."""
    flow = np.asarray(flow, np.float64)
    ref_flow = np.asarray(ref_flow, np.float64)
    if flow.shape != ref_flow.shape:
        raise ValueError(f"shape mismatch: {flow.shape} vs {ref_flow.shape}")
    epe = np.sqrt(((flow - ref_flow) ** 2).sum(-1))
    return {
        "aepe_raw": float(epe.mean()),
        "aepe_px": float(epe.mean() * factor),
        "max_epe_px": float(epe.max() * factor),
        "p99_epe_px": float(np.percentile(epe, 99) * factor),
    }


def occlusion_agreement(occ, ref_occ) -> float:
    """Fraction of pixels where two boolean occlusion masks agree."""
    return float((np.asarray(occ, bool) == np.asarray(ref_occ, bool)).mean())


def run_triplet(model, frame_paths, out_dir=None, device="cuda"):
    """Run compute_flow on a frame triplet; optionally write artifacts.

    `model` is anything `api.init` accepts (a converted checkpoint path, a
    (params, PWCConfig) tuple, a pretrained name...).
    -> (flow raw-units (H,W,2), fwd_occ bool, bwd_occ bool)
    """
    from back2future_tpu_torch.api import init
    from back2future_tpu_torch.data.sample import default_image_loader
    from back2future_tpu_torch.demo import write_results

    ims = [default_image_loader(p) for p in frame_paths]
    compute_flow = init(model, device=device)
    flow, fwd_occ, bwd_occ = compute_flow(*ims)

    if out_dir is not None:
        write_results(out_dir, flow, fwd_occ, bwd_occ)
    return flow, fwd_occ, bwd_occ


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--t7", help="reference .t7 checkpoint to convert+run")
    src.add_argument("--checkpoint", help="already-converted checkpoint")
    ap.add_argument("--frames", nargs=3, required=True,
                    help="triplet image paths (im1 im2 im3)")
    ap.add_argument("--ref_flo", help="reference flow (raw network units, "
                    "as written by the reference README workflow)")
    ap.add_argument("--ref_fwd_occ", help="reference fwd occlusion PNG")
    ap.add_argument("--out", default="parity_out")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="max AEPE in pixels (BASELINE.md north star)")
    ap.add_argument("--factor", type=float, default=20.0,
                    help="flownet_factor raw->px (opts.lua:92)")
    ap.add_argument("--frames_n", type=int, default=3)
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--skip", type=int, default=2)
    ap.add_argument("--past_flow", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --cpu for the CPU)")
    device = "cpu" if args.cpu else "cuda"

    if args.t7:
        from back2future_tpu_torch.config import Options
        from back2future_tpu_torch.models import pwc_config_from_options
        from back2future_tpu_torch.models.convert import convert_t7_checkpoint

        params = convert_t7_checkpoint(
            args.t7, frames=args.frames_n, levels=args.levels,
            skip=args.skip, past_flow=bool(args.past_flow))
        opt = Options(frames=args.frames_n, levels=args.levels,
                      pwc_skip=args.skip,
                      past_flow=bool(args.past_flow)).derive()
        model = (params, pwc_config_from_options(opt))
    else:
        model = args.checkpoint

    flow, fwd_occ, bwd_occ = run_triplet(model, args.frames, args.out, device)

    result = {"out": str(args.out),
              "fwd_occ_rate": float(fwd_occ.mean()),
              "bwd_occ_rate": float(bwd_occ.mean())}
    ok = True
    if args.ref_flo:
        from back2future_tpu_torch.io.flow_io import load_flo

        stats = compare_flows(flow, load_flo(args.ref_flo), args.factor)
        result.update(stats)
        ok = stats["aepe_px"] <= args.tolerance
        result["pass"] = ok
        result["tolerance_px"] = args.tolerance
    if args.ref_fwd_occ:
        from back2future_tpu_torch.data.sample import default_image_loader

        ref_occ = default_image_loader(args.ref_fwd_occ)[..., 0] > 0.5
        result["fwd_occ_agreement"] = occlusion_agreement(fwd_occ, ref_occ)

    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
