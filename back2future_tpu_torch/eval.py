"""Evaluation CLI of the port (counterpart of tools/eval.py): AEPE / Fl-all /
occlusion metrics of a checkpoint over a dataset split (the reference's
`test()` pass, test.lua:33-312).

    python -m back2future_tpu_torch.eval --checkpoint models/RoamingImages_H_KITTI_S \
        --dataset Kitti2015 --datasets_dir datasets --data_root /data/kitti \
        [--split val|all] [--batchSize 4] [--limit N] [--cpu] [--dump_dir DIR]

It runs on the card unless `--cpu` asks for the CPU, and prints one JSON
line with the aggregate metrics (the keys of tools/eval.py).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dataset", default="Kitti2015")
    ap.add_argument("--datasets_dir", default="datasets")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--split", default="val", choices=["val", "train", "all"])
    ap.add_argument("--batchSize", type=int, default=4)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--cropHeight", type=int, default=0,
                    help="center-crop height (default: dataset eval size)")
    ap.add_argument("--cropWidth", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dump_dir", default="",
                    help="also write per-sample predictions: KITTI-format "
                         "16-bit flow PNGs + raw-pixel .flo files, named "
                         "%%06d_10 by MANIFEST ROW (stable across --split/"
                         "--limit). Predictions are at the eval crop "
                         "resolution")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.data import (FlowDataset, PrefetchLoader, SampleConfig,
                                            decode_batch, device_prefetch, load_manifest,
                                            load_split)
    from back2future_tpu_torch.train.checkpoint import build_from_params, load_model_checkpoint
    from back2future_tpu_torch.train.metrics import full_res_metrics

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --cpu for the CPU)")
    device = torch.device("cpu" if args.cpu else "cuda")
    params, cfg = load_model_checkpoint(args.checkpoint)
    model = build_from_params(cfg, params).to(device).eval()

    opt = Options(dataset=args.dataset, ground_truth=True,
                  frames=cfg.frames, levels=cfg.levels,
                  cropHeight=args.cropHeight, cropWidth=args.cropWidth,
                  rand_crop=0).derive()
    scfg = SampleConfig.from_options(opt)
    specs = load_manifest(Path(args.datasets_dir) / f"{args.dataset}.dat",
                          ground_truth=True, root=args.data_root or None)
    split_path = Path(args.datasets_dir) / f"{args.dataset}_split.dat"
    if split_path.exists() and args.split != "all":
        tr, va = load_split(split_path)
        idx = va if args.split == "val" else tr
    else:
        idx = np.arange(len(specs))
    if args.limit:
        idx = idx[:args.limit]

    ds = FlowDataset(specs, scfg, idx, train=False)
    # ceil: the final partial batch is evaluated too (and weighted by its
    # true size below) so the aggregate covers the whole split; eval
    # decoding is light, so threads keep up
    n_batches = -(-len(ds) // args.batchSize)
    loader = PrefetchLoader(ds, args.batchSize, n_batches, n_workers=4,
                            sequential=True, worker_mode="thread")

    @torch.no_grad()
    def metrics_step(batch):
        batch = decode_batch(batch)  # no-op for the default f32 wire
        g0 = model(batch["images"], with_warped=False)[0]
        metrics = full_res_metrics(
            g0["flow"].float(), None if g0["occ"] is None else g0["occ"].float(),
            batch, cfg.flownet_factor, size_average=False)
        return metrics, g0["flow"].float()

    dump = Path(args.dump_dir) if args.dump_dir else None
    if dump:
        from back2future_tpu_torch.io.flow_io import write_flo, write_kitti_png

        dump.mkdir(parents=True, exist_ok=True)

    rows, weights, seen = [], [], 0
    for batch in device_prefetch(iter(loader), device):
        logs, flows = metrics_step(batch)
        rows.append({k: float(v) for k, v in logs.items()})
        n = int(batch["images"].shape[0])
        weights.append(n)
        if dump:
            px = flows.cpu().numpy() * cfg.flownet_factor
            for i in range(n):
                row = int(idx[seen + i])  # manifest row (sequential loader)
                write_kitti_png(dump / f"{row:06d}_10.png", px[i])
                write_flo(dump / f"{row:06d}_10.flo", px[i])
        seen += n
    w = np.asarray(weights, np.float64)
    agg = {k: float(np.average([r[k] for r in rows], weights=w))
           for k in rows[0]}
    agg["n_samples"] = int(w.sum())
    print(json.dumps(agg))


if __name__ == "__main__":
    main(sys.argv[1:])
