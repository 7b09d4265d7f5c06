"""High-level epoch loop: the top level of main.lua / train.lua / test.lua
(counterpart of back2future_tpu/train/loop.py:36-413).

`run(opt)` wires everything: model build-or-load (model.lua:38-142),
criteria, datasets and prefetch loaders (data.lua), the per-epoch
train/validate cycle (main.lua:35-39), per-batch console lines and TSV
epoch logs (train.lua:510-518, :162-173), and checkpoints every
`epochStore` epochs (train.lua:179-185).

One process per device: `opt.platform` "cpu" asks for the CPU, "",
"gpu" or "cuda" for the card `cuda:{GPU-1}` (RuntimeError when there is
none; nothing falls back to the CPU).

Data parallelism runs one rank per device in a `torch.distributed`
group (parallel/distributed.py), with DDP in the train step:

* `-nGPU n > 1` with no group: `run` starts ranks 1..n-1 with the
  spawn method and is rank 0 itself; rank r trains on `cuda:{GPU-1+r}`
  over NCCL, or on the CPU over gloo with `--platform cpu`. `-nGPU`
  beyond the host's cards raises ValueError. A rank's failure fails
  `run` with that rank's error; rank 0 returns its state, and the group
  is torn down at the end. The kernels are built once, before the ranks
  start.
* In a cluster (the B2F_COORDINATOR / B2F_NUM_PROCESSES / B2F_PROCESS_ID
  spec, torchrun's env, or a group the caller made) every process runs
  `run` as one rank on `cuda:{GPU-1+LOCAL_RANK}` (LOCAL_RANK 0 when
  unset) and `-nGPU` is ignored, as the JAX package ignores it across
  hosts. The JAX package runs one process per host instead.

`opt.batchSize` is the global batch; each rank loads its slice of every
batch. A resume is checked across ranks (`_state_fingerprint`) before
DDP broadcasts rank 0's parameters. Rank 0 owns the console,
`train.log`/`test.log` and the checkpoints (of the bare net); the other
ranks keep `train.log.host{r}`/`test.log.host{r}` side logs.
Multi-rank validation keeps full global batches only and logs how many
samples that skips. `opt.mesh_shape`/`opt.mesh_axes` describe the
ranks as the JAX package's mesh, whose shape must hold every rank: a
`data` axis, and optionally a `spatial` one of S (`--mesh_axes
data,spatial --mesh_shape D,S`), which shards image rows over the S
ranks of each data slot (rank = d*S + s; parallel/spatial.py): those
ranks load the same slice of every batch, and the net's row bands and
halo exchanges run over their spatial group, for either net (PWC or
SPyNet), as do the losses of the levels the net computes in bands.

The steps' logs are 0-d device tensors. After each step they are
stacked and copied into pinned host memory with `non_blocking=True`, and
an event marks the copy; the host reads a step's copy only once 16 more
steps are in flight (the eval epoch: `max(2, prefetch_depth)`), so no
step waits for the device.
"""

from __future__ import annotations

import collections
import contextlib
import os
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
from ..parallel import distributed
from ..utils import StepTimer, SymbolLogger, maybe_profile
from .checkpoint import load_or_convert, load_train_checkpoint, save_checkpoint
from .optim import lr_for_epoch
from .state import TrainState, create_train_state
from .step import make_eval_step, make_train_step

# steps whose logs may be in flight before the oldest is read, at least
# (back2future_tpu/train/loop.py:206: max(2, prefetch_depth, 16))
DRAIN_DEPTH = 16
# the steps of a run's first epoch that `trace_dir` traces: three, after
# one of warm-up
TRACED_STEPS = range(1, 4)


def build_model(opt: Options):
    """The module of `opt`, freshly initialised from opt.manualSeed."""
    return model_and_config(opt, generator=torch.Generator().manual_seed(opt.manualSeed))[0]


def build_loaders(opt: Options, shard=(0, 1)
                  ) -> Tuple[PrefetchLoader, Optional[PrefetchLoader]]:
    """Manifest + split -> train/val loaders (donkey.lua).

    `shard=(rank, world)`: each rank loads only its slice of every
    global batch; `opt.batchSize` stays the GLOBAL batch size. One
    rank's validation covers the whole split, the final partial batch
    included (improving on test.lua:52-64, which drops the remainder);
    multi-rank validation keeps full global batches only, and
    eval_epoch logs how many samples that skips."""
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
        manual_seed=opt.manualSeed, shard=shard, scene_batches=opt.scene_batches)
    if not len(val_idx):
        return train_loader, None
    val_ds = FlowDataset(specs, cfg, val_idx, train=False)
    if shard[1] == 1:
        n_val_batches = -(-len(val_ds) // opt.batchSize)  # ceil
    else:
        n_val_batches = len(val_ds) // opt.batchSize
    if not n_val_batches:
        return train_loader, None
    val_loader = PrefetchLoader(val_ds, opt.batchSize, n_val_batches, n_workers=opt.nDonkeys,
                                manual_seed=opt.manualSeed, sequential=True, shard=shard)
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
                device, verbose: bool = True, trace_dir: Optional[str] = None
                ) -> Tuple[TrainState, Dict[str, float]]:
    """One training epoch (train.lua:108-186). `verbose`: print the
    console lines (rank 0 does). With `trace_dir`, the steps of
    `TRACED_STEPS` run under `utils.maybe_profile`, which writes their
    trace, the step's spans included, to `<trace_dir>/trace.json`."""
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
        if verbose:
            print(_fmt_console(epoch, i + 1, len(loader), batch_time, data_time, logs, lr))

    drain_depth = max(opt.prefetch_depth, DRAIN_DEPTH)
    pending_q = collections.deque()
    with contextlib.ExitStack() as tracing:
        batches = device_prefetch(iter(loader), device, depth=opt.prefetch_depth)
        for i, batch in enumerate(batches):
            if trace_dir and i == TRACED_STEPS.start:
                tracing.enter_context(maybe_profile(trace_dir))
            timer.data_loaded()
            state, logs = step(state, batch)
            pending_q.append((i, _to_host(logs), timer.data_time))
            if len(pending_q) > drain_depth:
                drain(pending_q.popleft())
            if opt.debug == 1:
                _debug_dump(opt.save, epoch, i, state.model, batch, opt.frames)
            if i == TRACED_STEPS.stop - 1:
                tracing.close()
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
    if verbose:
        print(f"Epoch: [{epoch}][TRAINING SUMMARY] Total Time(s): "
              f"{time.time() - t0:.2f}\taverage loss (per batch): "
              f"{means['loss']:.4f}")
    return state, means


def eval_epoch(epoch: int, eval_step, loader, opt, logger: SymbolLogger,
               device, verbose: bool = True) -> Dict[str, float]:
    """Validation epoch (test.lua:33-95): sample-weighted means over the
    batches evaluated (the whole split on one rank), with at most
    max(2, prefetch_depth) steps in flight. A batch's weight is its
    global size: the rank's slice times the world."""
    handles = collections.deque()
    loader.set_epoch(epoch - 1)
    rows, weights = [], []
    t0 = time.time()

    def fetch(item):
        copy, n = item
        rows.append(_read(copy))
        weights.append(n)

    max_in_flight = max(2, opt.prefetch_depth)
    world = distributed.data_count()
    for batch in device_prefetch(iter(loader), device, depth=opt.prefetch_depth):
        # the final batch may be partial; per-batch sample counts weight
        # the aggregation so the epoch metrics are exact over the split
        handles.append((_to_host(eval_step(batch)), int(batch["images"].shape[0]) * world))
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
    if verbose:
        skipped = f" ({n_total - n_eval} skipped)" if n_eval < n_total else ""
        print(f"Epoch: [{epoch}][TESTING SUMMARY] Total Time(s): "
              f"{time.time() - t0:.2f}\taverage loss (per batch): "
              f"{means['loss']:.4f}\tsamples {n_eval}/{n_total}{skipped}")
    return means


def _state_fingerprint(model: torch.nn.Module, epoch0: int) -> str:
    """Order-stable digest of (start epoch, parameters by name, shape and
    float32 value) for the cross-rank resume check."""
    import hashlib

    h = hashlib.md5(str(epoch0).encode())
    for name, p in sorted(model.named_parameters()):
        arr = p.detach().float().cpu().numpy()
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _platform(opt: Options) -> str:
    platform = opt.platform.lower()
    if platform not in ("", "gpu", "cuda", "cpu"):
        raise ValueError(f"--platform {opt.platform!r}: use '', 'gpu' or 'cuda' for the card, "
                         f"'cpu' for the CPU")
    return "cpu" if platform == "cpu" else "cuda"


def run_device(opt: Options, local_rank: int = 0) -> torch.device:
    """The device a rank of `run` trains on (module docstring)."""
    if _platform(opt) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--platform {opt.platform!r} asks for the card and no CUDA device "
                           f"is available (pass --platform cpu for the CPU)")
    index = max(opt.GPU - 1, 0) + local_rank
    if index >= torch.cuda.device_count():
        raise ValueError(f"-GPU {opt.GPU} asks for device {index + 1} but this host has only "
                         f"{torch.cuda.device_count()}")
    return torch.device("cuda", index)


def _check_devices(opt: Options) -> None:
    """`-GPU g -nGPU n` must name cards this host has (the JAX package's
    ValueError); the CPU platform has no such bound."""
    base = max(opt.GPU - 1, 0)
    if _platform(opt) == "cuda" and opt.nGPU > 0 and base + opt.nGPU > torch.cuda.device_count():
        raise ValueError(
            f"-GPU {opt.GPU} -nGPU {opt.nGPU} asks for devices "
            f"{base + 1}..{base + opt.nGPU} but this host has only "
            f"{torch.cuda.device_count()} (cutorch.setDevice would error too)")


def _check_mesh(opt: Options, world: int) -> int:
    """`mesh_shape`/`mesh_axes` as the JAX package's mesh over the ranks:
    a `data` axis and optionally a `spatial` one, of every rank. Returns
    the `spatial` axis's size (1 without one)."""
    unknown = set(opt.mesh_axes) - {"data", "spatial"}
    if unknown or len(set(opt.mesh_axes)) != len(opt.mesh_axes):
        raise ValueError(f"--mesh_axes {tuple(opt.mesh_axes)}: the axes are 'data' and "
                         f"optionally 'spatial'")
    if opt.mesh_shape and int(np.prod(opt.mesh_shape)) != world:
        raise ValueError(f"--mesh_shape {tuple(opt.mesh_shape)} does not hold the {world} "
                         f"data-parallel ranks")
    if "spatial" not in opt.mesh_axes:
        return 1
    if len(opt.mesh_shape) != len(opt.mesh_axes):
        raise ValueError(f"--mesh_axes {tuple(opt.mesh_axes)} needs a --mesh_shape of "
                         f"{len(opt.mesh_axes)} sizes, got {tuple(opt.mesh_shape)}")
    return int(opt.mesh_shape[opt.mesh_axes.index("spatial")])


def join_cluster(opt: Options) -> None:
    """Join the cluster that the env asks for, if any (B2F_* spec or
    torchrun): NCCL on the card, gloo with `--platform cpu`."""
    distributed.initialize_multihost(backend="gloo" if _platform(opt) == "cpu" else None)


def run(opt: Options, max_epochs: Optional[int] = None) -> TrainState:
    """Full training run (main.lua:17-39). Returns the final state: in a
    cluster each process's own, and rank 0's when `run` starts the ranks
    itself (`-nGPU > 1`). Module docstring: ranks."""
    join_cluster(opt)
    if distributed.in_group() or opt.nGPU <= 1:
        local = int(os.environ.get("LOCAL_RANK", 0)) if distributed.in_group() else 0
        return _run_rank(opt, max_epochs, local)
    _check_devices(opt)
    backend = "gloo" if _platform(opt) == "cpu" else "nccl"
    if backend == "nccl":
        from ..runtime import cuda_build

        cuda_build.build()  # once, before the ranks start: they load it
    from ..parallel.launch import run_ranks

    return run_ranks(_spawned_rank, opt.nGPU, (opt, max_epochs), backend=backend)[0]


def _spawned_rank(rank: int, world: int, opt: Options, max_epochs: Optional[int]):
    """A rank that `run` started: rank r on the r-th device from -GPU."""
    state = _run_rank(opt, max_epochs, rank)
    return state if rank == 0 else None


def _run_rank(opt: Options, max_epochs: Optional[int], local_rank: int) -> TrainState:
    """One rank of a run (all of it without a group)."""
    rank, world = distributed.process_index(), distributed.process_count()
    distributed.init_mesh_groups(_check_mesh(opt, world))
    try:
        return _train(opt, max_epochs, local_rank, rank)
    finally:
        distributed.init_mesh_groups(1)


def _train(opt: Options, max_epochs: Optional[int], local_rank: int, rank: int) -> TrainState:
    """`_run_rank` once the mesh's groups are made."""
    distributed.host_local_batch_size(opt.batchSize)  # validates divisibility
    device = run_device(opt, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
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
    # DDP would broadcast rank 0's parameters over any divergence (e.g. a
    # -cont resume where only rank 0 sees the checkpoint): refuse it first
    distributed.assert_same_across_hosts("resume_state",
                                         _state_fingerprint(state.model, epoch0))

    if distributed.spatial_count() > 1:
        state.model.spatial_comm = distributed.spatial_comm()
    train_loader, val_loader = build_loaders(
        opt, shard=(distributed.data_index(), distributed.data_count()))
    step = make_train_step(state.model, opt, crits)
    eval_step = make_eval_step(state.model, opt, crits)
    is_main = rank == 0
    suffix = "" if is_main else f".host{rank}"
    train_log = SymbolLogger(Path(opt.save) / f"train.log{suffix}")
    test_log = SymbolLogger(Path(opt.save) / f"test.log{suffix}")

    last = opt.nEpochs if max_epochs is None else min(opt.nEpochs, epoch0 + max_epochs - 1)
    distributed.sync_hosts()
    for epoch in range(epoch0, last + 1):
        trace_dir = opt.trace_dir if epoch == epoch0 and is_main else None
        state, _ = train_epoch(epoch, state, step, train_loader, opt, train_log, device,
                               verbose=is_main, trace_dir=trace_dir)
        if val_loader is not None:
            eval_epoch(epoch, eval_step, val_loader, opt, test_log, device, verbose=is_main)
        if epoch % opt.epochStore == 0 and is_main:
            save_checkpoint(opt.save, state, opt, epoch)
        for log in (train_log, test_log):  # myLogger.lua:137-192
            try:
                log.plot()
            except (ValueError, FileNotFoundError):
                pass  # empty log (e.g. no val split yet)
    return state
