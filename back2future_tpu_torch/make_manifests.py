"""Generate dataset manifests (.dat + _split.dat) for standard layouts
(counterpart of tools/make_manifests.py, through the port's
`data/manifest.py`).

The reference ships pre-built manifests (datasets/<name>.dat, one
`img_printf_pattern [flow_pattern] ref [skip]` line per sample, plus an
ASCII 1/2-per-line train/val split — donkey.lua:70-94). This tool builds
equivalent manifests from on-disk dataset layouts:

  kitti2015-multiview: <root>/training/image_2/%06d_%02d.png sequences,
      one 3-frame sample centered on frame 10 per scene (no ground truth;
      the reference's Kitti2015.dat layout)
  kitti2015-flow: adds flow_occ/%06d_10.png ground truth
  sintel: <root>/<pass>/<scene>/frame_%04d.png with
      <root>/flow/<scene>/frame_%04d.flo ground truth
  frames: any directory of numbered frames matching a printf pattern

    python -m back2future_tpu_torch.make_manifests kitti2015-multiview /data/kitti \
        datasets/Kitti2015.dat --val_fraction 0.1
"""

from __future__ import annotations

import argparse
import random
import re
import sys
from pathlib import Path

from back2future_tpu_torch.data.manifest import SampleSpec, write_manifest


def kitti_multiview(root: str, ref: int = 10, use_gt: bool = False):
    img_dir = Path(root) / "training" / "image_2"
    scenes = sorted({p.name.split("_")[0] for p in img_dir.glob("*_*.png")})
    specs = []
    for s in scenes:
        img = f"{root}/training/image_2/{s}_%02d.png"
        flow = f"{root}/training/flow_occ/{s}_%02d.png" if use_gt else None
        specs.append(SampleSpec(img, flow, ref=ref, skip=1))
    return specs


def sintel(root: str, render_pass: str = "clean"):
    base = Path(root) / render_pass
    specs = []
    for scene in sorted(p.name for p in base.iterdir() if p.is_dir()):
        frames = sorted((base / scene).glob("frame_*.png"))
        n = len(frames)
        img = f"{root}/{render_pass}/{scene}/frame_%04d.png"
        flow = f"{root}/flow/{scene}/frame_%04d.flo"
        has_flow = (Path(root) / "flow" / scene).is_dir()
        for ref in range(2, n):  # need ref-1 and ref+1
            specs.append(SampleSpec(img, flow if has_flow else None,
                                    ref=ref, skip=1))
    return specs


def frames_dir(root: str, pattern: str, frames_window: int = 3,
               skip: int = 1):
    nums = []
    for p in sorted(Path(root).iterdir()):
        m = re.fullmatch(pattern.replace("%02d", r"(\d{2})")
                         .replace("%04d", r"(\d{4})")
                         .replace("%d", r"(\d+)"), p.name)
        if m:
            nums.append(int(m.group(1)))
    nums = sorted(nums)
    half = (frames_window - 1) // 2 * skip
    img = f"{root}/{pattern}"
    return [SampleSpec(img, None, ref=n, skip=skip)
            for n in nums if n - half in nums and n + half in nums]


def write_split(path: Path, n: int, val_fraction: float, seed: int) -> None:
    rng = random.Random(seed)
    labels = [2 if rng.random() < val_fraction else 1 for _ in range(n)]
    path.write_text("\n".join(map(str, labels)) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("layout", choices=["kitti2015-multiview", "kitti2015-flow",
                                       "sintel", "frames"])
    ap.add_argument("root")
    ap.add_argument("out", help="output .dat path")
    ap.add_argument("--pattern", default="img_%04d.png",
                    help="frame filename pattern (frames layout)")
    ap.add_argument("--sintel_pass", default="clean")
    ap.add_argument("--ref", type=int, default=10)
    ap.add_argument("--val_fraction", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)

    if args.layout == "kitti2015-multiview":
        specs = kitti_multiview(args.root, args.ref, use_gt=False)
    elif args.layout == "kitti2015-flow":
        specs = kitti_multiview(args.root, args.ref, use_gt=True)
    elif args.layout == "sintel":
        specs = sintel(args.root, args.sintel_pass)
    else:
        specs = frames_dir(args.root, args.pattern)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_manifest(out, specs)
    write_split(out.with_name(out.stem + "_split.dat"), len(specs),
                args.val_fraction, args.seed)
    print(f"wrote {out} ({len(specs)} samples) + split")


if __name__ == "__main__":
    main(sys.argv[1:])
