"""Inference demo of the port (counterpart of tools/demo.py): the
reference README workflow (README.md:54-71). Loads a frame window (one
image per model frame; 3 for the flagship models), computes flow and
occlusions, and writes flow.flo, the flow visualisation and the
occlusion masks.

    python -m back2future_tpu_torch.demo frame_0009.png frame_0010.png \
        frame_0011.png --model Ours-Soft-ft-KITTI --out out/ [--cpu]

With --model none it runs random weights (a pipeline smoke test). It
runs on the card unless `--cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def write_results(out_dir, flow, fwd_occ, bwd_occ) -> float:
    """Write flow.flo, flow.png and the two occlusion PNGs into `out_dir`;
    return the flow visualisation's max norm."""
    from back2future_tpu_torch import io as fio
    from back2future_tpu_torch.io.png16 import write_png

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fio.write_flo(out / "flow.flo", flow)
    rgb, mx = fio.xy2rgb(flow)
    write_png(out / "flow.png", (rgb * 255).astype(np.uint8))
    write_png(out / "fwd_occ.png", (fwd_occ * 255).astype(np.uint8))
    write_png(out / "bwd_occ.png", (bwd_occ * 255).astype(np.uint8))
    return mx


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("frames", nargs="+",
                    help="one image per model frame (3 for the flagship "
                         "models; 2 or 5 for those variants)")
    ap.add_argument("--model", default="Ours-Soft-ft-KITTI")
    ap.add_argument("--out", default="out")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from back2future_tpu_torch.api import init
    from back2future_tpu_torch.data.sample import default_image_loader

    ims = [default_image_loader(p) for p in args.frames]
    compute_flow = init(None if args.model == "none" else args.model,
                        device="cpu" if args.cpu else "cuda")
    flow, fwd_occ, bwd_occ = compute_flow(*ims)
    mx = write_results(args.out, flow, fwd_occ, bwd_occ)
    print(f"wrote {args.out}/flow.flo  flow.png (max|f|={mx:.3f})  "
          f"fwd_occ.png ({fwd_occ.mean():.3%} occluded)  bwd_occ.png")


if __name__ == "__main__":
    main()
