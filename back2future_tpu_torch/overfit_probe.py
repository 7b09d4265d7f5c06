"""One-batch overfit probe of the port (counterpart of
tools/overfit_probe.py): the fastest end-to-end health check of the
optimizer + losses + model on real data.

Builds ONE fixed B=`--batch` batch through the real loader (with the
exact flags the learning demo trains under: compact wire, grad-clip,
demo LR) and Adam-steps it `--steps` times, printing loss/EPE every 25.
A flat curve here means a real defect; a flat *full-dataset* run at the
same step count usually just means the shared-function gradient is
slower than the per-scene overfit direction.

    python -m back2future_tpu_torch.overfit_probe --data <set> [--steps 400] [--cpu]

`--data` is a generated set's root (<data>/datasets + <data>/data). It
runs on the card unless `--cpu` asks for the CPU. Reference for the
recipe: README.md:83-87 of the reference (hard OBCC pretrain),
train.lua:66-92 (LR regime the demo overrides via public flags).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="dataset root (<data>/datasets + <data>/data)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--wire", default="compact")
    ap.add_argument("--optimize", default="pme", choices=["pme", "epe"],
                    help="pme = the unsupervised hard OBCC recipe; epe = "
                         "supervised multiscale EPE on the generator's gt "
                         "(the reference's -optimize epe / -ground_truth "
                         "mode, opts.lua) — isolates the optimizer/loss "
                         "path from the photometric objective")
    ap.add_argument("--lr", default="0.0003")
    ap.add_argument("--grad_clip", default="500")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from back2future_tpu_torch.config import parse_args
    from back2future_tpu_torch.data import (FlowDataset, PrefetchLoader, SampleConfig,
                                            load_manifest, load_split)
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train.checkpoint import load_or_convert
    from back2future_tpu_torch.train.state import create_train_state
    from back2future_tpu_torch.train.step import make_train_step

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --cpu for the CPU)")
    device = torch.device("cpu" if args.cpu else "cuda")
    data = Path(args.data)
    opt = parse_args([
        "--dataset", "RoamingImages", "--datasets_dir",
        str(data / "datasets"), "--data_root", str(data / "data"),
        "--ground_truth", "1", "--cache", str(Path(tempfile.gettempdir()) / "overfit_probe"),
        "--expName", "ob", "--batchSize", str(args.batch),
        "--epochSize", "1", "--nDonkeys", "0", "--wire", args.wire,
        "--optimize", args.optimize] + (
        ["--pme", "1", "--pme_criterion", "OBCC", "--smooth_flow", "2"]
        if args.optimize == "pme" else
        # the reference defaults -epe to 0.0 (opts.lua:60), so supervised
        # mode without an explicit weight multiplies the flow loss by
        # zero (train.lua:312-314) and only the occ head learns
        ["--epe", "1"]) + [
        "--LR", args.lr, "--grad_clip",
        args.grad_clip, "--adam_reset_per_epoch", "0", "--nEpochs", "1"])

    np.random.seed(opt.manualSeed)
    model, _cfg, epoch0 = load_or_convert(opt)
    model = model.to(device)
    state = create_train_state(model, opt, epoch=epoch0)
    step = make_train_step(model, opt, build_criterions(opt))

    specs = load_manifest(data / "datasets" / "RoamingImages.dat",
                          ground_truth=True, root=str(data / "data"))
    train, _val = load_split(data / "datasets" / "RoamingImages_split.dat")
    ds = FlowDataset(specs, SampleConfig.from_options(opt), train, train=True)
    loader = PrefetchLoader(ds, batch_size=args.batch, n_batches=1,
                            n_workers=0, manual_seed=opt.manualSeed)
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(iter(loader)).items()}

    t0 = time.time()
    for i in range(1, args.steps + 1):
        state, logs = step(state, batch)
        if i == 1:
            print(f"first step {time.time() - t0:.1f}s", flush=True)
        if i % 25 == 0 or i == 1:
            print(f"step {i:4d} loss {logs['loss'].item():10.3f} "
                  f"epe {logs['epe'].item():7.4f}", flush=True)
    print(f"done in {time.time() - t0:.1f}s  wire={args.wire} "
          f"clip={args.grad_clip} lr={args.lr}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
