"""Export a serving artifact of the port (counterpart of
tools/export_serving.py).

Wraps `FlowEstimator.export()`: loads a checkpoint (or a reference
pretrained name already converted with `python -m
back2future_tpu_torch.convert_t7`), exports the serving forward for the
requested (batch, height, width) buckets as `torch.export` programs with
their weights, ready for `api.load_exported()` in a serving process with
no model code or checkpoint access. The artifact serves on the device
type it was exported on: the card unless `--cpu` asks for the CPU.

    python -m back2future_tpu_torch.export_serving --model <ckpt-or-name> \
        --out art/ --sizes 375x1242 16x375x1242 [--dtype bfloat16] [--cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_size(s: str):
    parts = [int(p) for p in s.lower().split("x")]
    if len(parts) in (2, 3):
        return tuple(parts)
    raise argparse.ArgumentTypeError(
        f"{s!r}: expected HxW or BxHxW (e.g. 375x1242 or 16x375x1242)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None,
                    help="checkpoint path or pretrained name; default: "
                         "random weights (smoke)")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--sizes", nargs="+", type=parse_size,
                    default=[(375, 1242)],
                    help="buckets as HxW or BxHxW (input resolutions; "
                         "snapped down to the /64 grid)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from back2future_tpu_torch import api

    est = api.init(args.model, device="cpu" if args.cpu else "cuda", dtype=args.dtype)
    est.export(args.out, args.sizes)
    arts = sorted(p.name for p in Path(args.out).iterdir())
    print(f"exported {len(args.sizes)} bucket(s) to {args.out}:")
    for a in arts:
        print(" ", a)


if __name__ == "__main__":
    main()
