"""High-level epoch loop: the top level of main.lua / train.lua / test.lua
(counterpart of back2future_tpu/train/loop.py:36-413).

`run(opt)` wires everything: model build-or-load (model.lua:38-142),
criteria, datasets and prefetch loaders (data.lua), the per-epoch
train/validate cycle (main.lua:35-39), per-batch console lines and TSV
epoch logs (train.lua:510-518, :162-173), and checkpoints every
`epochStore` epochs (train.lua:179-185).

One process, one device: `opt.platform` "cpu" asks for the CPU, "",
"gpu" or "cuda" for the card `cuda:{GPU-1}` (RuntimeError when there is
none; nothing falls back to the CPU). Multi-card and multi-host training
(`nGPU > 1`, meshes, the cross-host resume fingerprint) are ROADMAP.md
queue 1 item 11.

The steps' logs are 0-d device tensors. After each step they are
stacked and copied into pinned host memory with `non_blocking=True`, and
an event marks the copy; the host reads a step's copy only once 16 more
steps are in flight (the eval epoch: `max(2, prefetch_depth)`), so no
step waits for the device.
"""

from __future__ import annotations

import collections
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Options
from ..data import (FlowDataset, PrefetchLoader, SampleConfig, device_prefetch,
                    load_manifest_cached, load_split)
from ..losses import build_criterions
from ..models.factory import model_and_config
from ..utils import StepTimer, SymbolLogger
from .checkpoint import load_or_convert, load_train_checkpoint, save_checkpoint
from .optim import lr_for_epoch
from .state import TrainState, create_train_state
from .step import make_eval_step, make_train_step

# steps whose logs may be in flight before the oldest is read, at least
# (back2future_tpu/train/loop.py:206: max(2, prefetch_depth, 16))
DRAIN_DEPTH = 16


def build_model(opt: Options):
    """The module of `opt`, freshly initialised from opt.manualSeed."""
    return model_and_config(opt, generator=torch.Generator().manual_seed(opt.manualSeed))[0]


def build_loaders(opt: Options) -> Tuple[PrefetchLoader, Optional[PrefetchLoader]]:
    """Manifest + split -> train/val loaders (donkey.lua). Validation
    covers the whole split, the final partial batch included (improving
    on test.lua:52-64, which drops the remainder)."""
    manifest = Path(opt.datasets_dir) / f"{opt.dataset}.dat"
    split = Path(opt.datasets_dir) / f"{opt.dataset}_split.dat"
    specs = load_manifest_cached(manifest, opt.ground_truth, root=opt.data_root or None,
                                 cache_dir=opt.cache)
    if split.exists():
        train_idx, val_idx = load_split(split)
    else:
        train_idx, val_idx = np.arange(len(specs)), np.arange(0)

    cfg = SampleConfig.from_options(opt)
    train_ds = FlowDataset(specs, cfg, train_idx, train=True)
    train_loader = PrefetchLoader(
        train_ds, opt.batchSize, n_batches=opt.epochSize, n_workers=opt.nDonkeys,
        manual_seed=opt.manualSeed, scene_batches=opt.scene_batches)
    if not len(val_idx):
        return train_loader, None
    val_ds = FlowDataset(specs, cfg, val_idx, train=False)
    n_val_batches = -(-len(val_ds) // opt.batchSize)  # ceil
    val_loader = PrefetchLoader(val_ds, opt.batchSize, n_val_batches, n_workers=opt.nDonkeys,
                                manual_seed=opt.manualSeed, sequential=True)
    return train_loader, val_loader


def _fmt_console(epoch, i, n, batch_time: float, data_time: float,
                 logs: Dict, lr: float) -> str:
    """Per-batch console line (train.lua:505-518). `batch_time` is the
    total wall time attributed to this batch (the reference's Time field
    also includes data wait, train.lua:498-517); `data_time` is the host
    wait for THIS batch's data, snapshotted at dispatch."""
    parts = [f"Epoch: [{epoch}][{i}/{n}]",
             f"Time {batch_time:.3f}",
             f"ERR {float(logs.get('loss', 0)):.3f}"]
    for key, label in (("pme", "PME"), ("sflow", "SmoothFlow"),
                       ("socc", "SmoothOcc"), ("gocc", "PriorOcc"),
                       ("epe", "EPE"), ("epe_nocc", "EPE non Occ"),
                       ("epe_occ", "EPE Occ")):
        if key in logs:
            parts.append(f"{label} {float(logs[key]):.3f}")
    if "occ_acc" in logs:
        parts.append(
            f"Occ Acc {float(logs['occ_acc']):.3f} "
            f"({float(logs['occ_acc_bwd']):.3f},"
            f"{float(logs['occ_acc_vis']):.3f},"
            f"{float(logs['occ_acc_fwd']):.3f})")
    parts.append(f"LR {lr:.0e}")
    parts.append(f"DataLoadingTime {data_time:.3f}")
    return "\t".join(parts)


@torch.no_grad()
def _debug_dump(save: str, epoch: int, i: int, model, batch, frames: int) -> None:
    """-debug 1: dump the reference frame and the finest-level warped
    frames as PNGs (train.lua:254-277 writes them to tmp/)."""
    from ..data.augment import IMAGENET_MEAN, IMAGENET_STD
    from ..data.wire import decode_batch
    from ..io.png16 import write_png

    out_dir = Path(save) / "tmp"
    out_dir.mkdir(parents=True, exist_ok=True)
    g0 = model(decode_batch(batch)["images"], with_warped=True)[0]
    rc = (0 if frames == 2 else (frames - 1) // 2) * 3

    def unnorm(img):
        x = img.float().cpu().numpy() * IMAGENET_STD + IMAGENET_MEAN
        return (np.clip(x, 0, 1) * 255).astype(np.uint8)

    ref_img = batch["images"][0][..., rc:rc + 3]
    write_png(out_dir / f"e{epoch}_b{i}_ref.png",
              ref_img.cpu().numpy() if ref_img.dtype == torch.uint8  # compact wire: raw u8
              else unnorm(ref_img))
    for k, wimg in enumerate(g0["warped"]):
        write_png(out_dir / f"e{epoch}_b{i}_warp{k}.png", unnorm(wimg[0]))


def _epoch_means(rows) -> Dict[str, float]:
    keys = rows[0].keys()
    return {k: float(np.mean([float(r[k]) for r in rows if k in r]))
            for k in keys}


def _to_host(logs: Dict[str, torch.Tensor]):
    """Start the copy of a step's 0-d logs to the host without waiting:
    one stacked tensor, copied into pinned memory with non_blocking=True
    on a card, and the event that marks the copy's end."""
    names = list(logs)
    values = torch.stack([v.float() for v in logs.values()])
    if values.device.type != "cuda":
        return names, values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return names, host, done


def _read(pending) -> Dict[str, float]:
    """The logs of a `_to_host` copy, once the copy has landed."""
    names, host, done = pending
    if done is not None:
        done.synchronize()
    return dict(zip(names, host.tolist()))


def train_epoch(epoch: int, state: TrainState, step, loader, opt, logger: SymbolLogger,
                device) -> Tuple[TrainState, Dict[str, float]]:
    """One training epoch (train.lua:108-186)."""
    state = state.with_epoch(epoch, opt)
    # pin the sample stream to the global epoch (1-based loop -> 0-based
    # stream) so resumed runs draw epoch N's data, not epoch 1's again
    loader.set_epoch(epoch - 1)
    lr = lr_for_epoch(epoch, opt.LR)
    rows: List[Dict[str, float]] = []
    timer = StepTimer()
    t0 = time.time()
    last_drain = [t0]

    def drain(pending):
        """Read a queued step's logs (waiting for their copy only) and
        print its console line. Each batch's data-loading time is
        snapshotted at dispatch so the deferred line reports the right
        batch's wait."""
        i, copy, data_time = pending
        logs = _read(copy)
        now = time.time()
        batch_time, last_drain[0] = now - last_drain[0], now
        # the read above waited on the device; reset the timer mark so
        # the NEXT batch's data_loaded() measures only its own host wait
        timer.step_done()
        rows.append(logs)
        print(_fmt_console(epoch, i + 1, len(loader), batch_time, data_time, logs, lr))

    drain_depth = max(opt.prefetch_depth, DRAIN_DEPTH)
    pending_q = collections.deque()
    for i, batch in enumerate(device_prefetch(iter(loader), device, depth=opt.prefetch_depth)):
        timer.data_loaded()
        state, logs = step(state, batch)
        pending_q.append((i, _to_host(logs), timer.data_time))
        if len(pending_q) > drain_depth:
            drain(pending_q.popleft())
        if opt.debug == 1:
            _debug_dump(opt.save, epoch, i, state.model, batch, opt.frames)
    while pending_q:
        drain(pending_q.popleft())

    means = _epoch_means(rows)
    summary = {"avg loss (train set)": means["loss"]}
    if "epe" in means:
        summary.update({
            "avg epe (train set)": means["epe"],
            "avg epe non occ (train set)": means["epe_nocc"],
            "avg epe occ (train set)": means["epe_occ"]})
    if "occ_acc" in means:
        summary.update({
            "avg occ acc (train set)": means["occ_acc"],
            "avg bwd acc (train set)": means["occ_acc_bwd"],
            "avg vis acc (train set)": means["occ_acc_vis"],
            "avg fwd acc (train set)": means["occ_acc_fwd"]})
    logger.add(summary)
    print(f"Epoch: [{epoch}][TRAINING SUMMARY] Total Time(s): "
          f"{time.time() - t0:.2f}\taverage loss (per batch): "
          f"{means['loss']:.4f}")
    return state, means


def eval_epoch(epoch: int, eval_step, loader, opt, logger: SymbolLogger,
               device) -> Dict[str, float]:
    """Validation epoch (test.lua:33-95): sample-weighted means over the
    whole split, with at most max(2, prefetch_depth) steps in flight."""
    handles = collections.deque()
    loader.set_epoch(epoch - 1)
    rows, weights = [], []
    t0 = time.time()

    def fetch(item):
        copy, n = item
        rows.append(_read(copy))
        weights.append(n)

    max_in_flight = max(2, opt.prefetch_depth)
    for batch in device_prefetch(iter(loader), device, depth=opt.prefetch_depth):
        # the final batch may be partial; per-batch sample counts weight
        # the aggregation so the epoch metrics are exact over the split
        handles.append((_to_host(eval_step(batch)), int(batch["images"].shape[0])))
        if len(handles) > max_in_flight:
            fetch(handles.popleft())
    while handles:
        fetch(handles.popleft())
    w = np.asarray(weights, np.float64)
    means = {k: float(np.average([float(r[k]) for r in rows], weights=w))
             for k in rows[0]}
    n_eval, n_total = int(w.sum()), len(loader.dataset)
    summary = {"avg loss (test set)": means["loss"]}
    if "epe" in means:
        summary["avg epe (test set)"] = means["epe"]
    if "occ_acc" in means:
        summary["avg occ acc (test set)"] = means["occ_acc"]
    logger.add(summary)
    skipped = f" ({n_total - n_eval} skipped)" if n_eval < n_total else ""
    print(f"Epoch: [{epoch}][TESTING SUMMARY] Total Time(s): "
          f"{time.time() - t0:.2f}\taverage loss (per batch): "
          f"{means['loss']:.4f}\tsamples {n_eval}/{n_total}{skipped}")
    return means


def run_device(opt: Options) -> torch.device:
    """The device `run` trains on (module docstring)."""
    if opt.nGPU > 1:
        raise NotImplementedError(f"-nGPU {opt.nGPU}: multi-card training is not ported yet "
                                  f"(ROADMAP.md queue 1 item 11)")
    platform = opt.platform.lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "gpu", "cuda"):
        raise ValueError(f"--platform {opt.platform!r}: use '', 'gpu' or 'cuda' for the card, "
                         f"'cpu' for the CPU")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--platform {opt.platform!r} asks for the card and no CUDA device "
                           f"is available (pass --platform cpu for the CPU)")
    index = max(opt.GPU - 1, 0)
    if index >= torch.cuda.device_count():
        raise ValueError(f"-GPU {opt.GPU} asks for device {index + 1} but this host has only "
                         f"{torch.cuda.device_count()}")
    return torch.device("cuda", index)


def run(opt: Options, max_epochs: Optional[int] = None) -> TrainState:
    """Full training run (main.lua:17-39). Returns the final state."""
    device = run_device(opt)
    np.random.seed(opt.manualSeed)
    crits = build_criterions(opt)
    state = None
    if opt.cont and not opt.adam_reset_per_epoch:
        # With persistent Adam moments, a resume must restore them from
        # optimState_<e> (model.lua:51-130); with the reference's
        # per-epoch reset they would be discarded at with_epoch anyway.
        try:
            state, epoch0 = load_train_checkpoint(opt.save, opt, device=device)
        except FileNotFoundError:
            state = None
    if state is None:
        net, _cfg, epoch0 = load_or_convert(opt)
        state = create_train_state(net.to(device), opt, epoch=epoch0)

    train_loader, val_loader = build_loaders(opt)
    step = make_train_step(state.model, opt, crits)
    eval_step = make_eval_step(state.model, opt, crits)
    train_log = SymbolLogger(Path(opt.save) / "train.log")
    test_log = SymbolLogger(Path(opt.save) / "test.log")

    last = opt.nEpochs if max_epochs is None else min(opt.nEpochs, epoch0 + max_epochs - 1)
    for epoch in range(epoch0, last + 1):
        state, _ = train_epoch(epoch, state, step, train_loader, opt, train_log, device)
        if val_loader is not None:
            eval_epoch(epoch, eval_step, val_loader, opt, test_log, device)
        if epoch % opt.epochStore == 0:
            save_checkpoint(opt.save, state, opt, epoch)
        for log in (train_log, test_log):  # myLogger.lua:137-192
            try:
                log.plot()
            except (ValueError, FileNotFoundError):
                pass  # empty log (e.g. no val split yet)
    return state
