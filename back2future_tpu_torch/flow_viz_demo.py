"""Render qualitative evidence images for a trained checkpoint (counterpart
of tools/flow_viz_demo.py): per val scene a 2x2 panel — reference frame,
predicted flow (xy2rgb, the reference's flowToColor convention,
flowExtensions.lua:129-150), ground truth flow on the same color scale,
and the predicted forward-occlusion mask — written as PNGs.

    python -m back2future_tpu_torch.flow_viz_demo --checkpoint <ckpt> --data <set> \
        --out docs/evidence/learning_demo_torch/viz --n 3 [--cpu]

`--data` is a generated set's root (<data>/datasets + <data>/data). It
runs on the card unless `--cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--dataset", default="RoamingImages")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.data import FlowDataset, SampleConfig, load_manifest, load_split
    from back2future_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
    from back2future_tpu_torch.io.png16 import write_png
    from back2future_tpu_torch.io.viz import xy2rgb
    from back2future_tpu_torch.ops.pyramid import resize_bilinear
    from back2future_tpu_torch.train.checkpoint import build_from_params, load_model_checkpoint
    from back2future_tpu_torch.train.metrics import decode_occ

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --cpu for the CPU)")
    device = torch.device("cpu" if args.cpu else "cuda")
    params, cfg = load_model_checkpoint(args.checkpoint)
    model = build_from_params(cfg, params).to(device).eval()

    data = Path(args.data)
    opt = Options(dataset=args.dataset, ground_truth=True, frames=cfg.frames,
                  levels=cfg.levels, rand_crop=0).derive()
    specs = load_manifest(data / "datasets" / f"{args.dataset}.dat",
                          ground_truth=True, root=str(data / "data"))
    _, val = load_split(data / "datasets" / f"{args.dataset}_split.dat")
    ds = FlowDataset(specs, SampleConfig.from_options(opt), val[:args.n], train=False)
    batch = ds.get(0, min(args.n, len(ds)))

    with torch.no_grad():
        g = model(torch.from_numpy(batch["images"]).to(device), with_warped=False)[0]
        flow = g["flow"].float() * cfg.flownet_factor
        occ = None if g["occ"] is None else g["occ"].float()
        H, W = batch["images"].shape[1:3]
        if flow.shape[1:3] != (H, W):  # finest level below full res: upsample
            sc = H / flow.shape[1]
            flow = resize_bilinear(flow, H, W) * sc
            if occ is not None:
                occ = resize_bilinear(occ, H, W)
        occ_sharp = None if occ is None else decode_occ(occ).cpu().numpy()
        flow = flow.cpu().numpy()

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ref = cfg.frames // 2 if cfg.frames == 2 else (cfg.frames - 1) // 2
    for i in range(flow.shape[0]):
        # un-normalize the reference frame for display (ImageNet mean/std)
        img = (batch["images"][i, ..., 3 * ref:3 * ref + 3] * IMAGENET_STD
               + IMAGENET_MEAN)
        gt = batch["flow_gt"][i] * cfg.flownet_factor
        max_norm = float(np.hypot(gt[..., 0], gt[..., 1]).max()) or None
        pred_rgb, _ = xy2rgb(flow[i], max_norm)  # float RGB in [0,1]
        gt_rgb, _ = xy2rgb(gt, max_norm)
        occ_img = (np.zeros((H, W, 3), np.float32) if occ_sharp is None else
                   np.repeat(occ_sharp[i][..., None], 3, -1).astype(np.float32))
        top = np.concatenate([np.clip(img, 0, 1), pred_rgb], 1)
        bot = np.concatenate([gt_rgb, occ_img], 1)
        panel = (np.concatenate([top, bot], 0) * 255).astype(np.uint8)
        write_png(out / f"val{i:02d}_panel.png", panel)
        epe = float(np.mean(np.hypot(*(flow[i] - gt).transpose(2, 0, 1))))
        print(f"val{i:02d}: EPE {epe:.3f} px -> {out}/val{i:02d}_panel.png", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
