"""Convert a reference Torch7 .t7 checkpoint into one of the port's
(counterpart of tools/convert_t7.py).

    python -m back2future_tpu_torch.convert_t7 RoamingImages_H.t7 models/RoamingImages_H \
        [--frames 3 --levels 7 --skip 2 --past_flow 0]
    python -m back2future_tpu_torch.convert_t7 model.t7 --inspect   # print module listing

Writes `model_0.pt`, `optimState_0.pt` and `options.json` through the
port's `save_checkpoint`, so that `api.init(out_dir)` serves it. The
conversion is host work: it runs on the CPU and touches no card.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("t7_path")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--skip", type=int, default=2)
    ap.add_argument("--past_flow", type=int, default=0)
    ap.add_argument("--inspect", action="store_true")
    args = ap.parse_args(argv)

    from back2future_tpu_torch.models.convert import convert_t7_checkpoint, inspect_t7

    if args.inspect:
        for line in inspect_t7(args.t7_path):
            print(line)
        return

    if not args.out_dir:
        ap.error("out_dir required unless --inspect")

    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.models import PWCNet, load_flax_params, pwc_config_from_options
    from back2future_tpu_torch.train.checkpoint import save_checkpoint
    from back2future_tpu_torch.train.state import create_train_state

    params = convert_t7_checkpoint(
        args.t7_path, frames=args.frames, levels=args.levels,
        skip=args.skip, past_flow=bool(args.past_flow))
    opt = Options(frames=args.frames, levels=args.levels,
                  pwc_skip=args.skip, past_flow=bool(args.past_flow)).derive()
    net = PWCNet(pwc_config_from_options(opt))
    load_flax_params(net, params)
    model_path, _ = save_checkpoint(args.out_dir, create_train_state(net, opt), opt, epoch=0)
    print(f"wrote {model_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
