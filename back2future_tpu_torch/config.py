"""Run options of the port: the reference CLI's option surface
(opts.lua:14-160) with its derived-option logic (opts.lua:102-159), as a
typed dataclass.

The port's own copy of the JAX package's `Options`
(back2future_tpu/config.py), with the same field names and defaults, so
that an option set written by one package reads in the other and
`pwc_config_from_options` / `build_criterions` take either. `platform`
picks the device of `train.loop.run`: "", "gpu" or "cuda" mean the card
(`cuda:{GPU-1}`), "cpu" asks for the CPU; `nGPU` the ranks `run`
starts, and `mesh_shape`/`mesh_axes` the JAX mesh's layout of them: a
`data` axis, and optionally a `spatial` one that shards image rows
(train/loop.py). `trace_dir`, where given, has `run` trace steps 2-4 of
its first epoch (one step of warm-up, then three: `train.loop.TRACED_STEPS`)
on rank 0 with `utils.maybe_profile` and write them, the step's and the
net's spans included (`utils.span`), to `<trace_dir>/trace.json` (a
Chrome trace: chrome://tracing, Perfetto). `use_pallas` means nothing to
the port and is kept only so option sets round-trip.
`parse_args` is the training CLI's front end (back2future_tpu/config.py:234).
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple


@dataclass
class Options:
    # ------------ General options (opts.lua:21-30) ------------
    expName: str = "exp"
    debug: int = 0
    cache: str = "checkpoints"
    dataset: str = "RoamingImages"
    ground_truth: bool = False
    manualSeed: int = 2
    GPU: int = 1                # 1-based first device index
    nGPU: int = 1               # number of devices for data parallelism
    backend: str = "xla"        # informational

    # ------------- Data options (opts.lua:32-41) -------------
    nDonkeys: int = 8           # host data-loader worker threads
    scale: float = 1.0
    fineWidth: int = 128
    fineHeight: int = 64
    rand_crop: int = 1
    cropWidth: int = 0
    cropHeight: int = 0
    gaussian_noise: float = 0.0
    normalize_images: int = 1

    # ------------- Training options (opts.lua:43-53) -------------
    augment: int = 0
    nEpochs: int = 1000
    epochSize: int = 1000
    epochStore: int = 1
    batchSize: int = 8
    # no reference analog: >0 draws each training batch from this many
    # distinct scenes instead of batchSize i.i.d. ones
    scene_batches: int = 0
    epochNumber: int = 1
    retrain: str = "none"
    optimState: str = "none"
    cont: bool = False
    convert_to_soft: bool = False

    # ------------- Criterion options (opts.lua:55-73) -------------
    optimize: str = "pme"       # 'epe' (supervised) or 'pme' (unsupervised)
    sizeAverage: bool = False
    past_flow: bool = False
    epe: float = 0.0
    pme: float = 1.0
    pme_criterion: str = "OBCC"   # BCC, OBCC, OBGCC, SSIM, SSIML1, OSSIM, OSSIML1
    pme_penalty: str = "L1"       # Quadratic | L1 | Lorentzian
    pme_alpha: float = 1.0
    pme_beta: float = 1.0
    pme_gamma: float = 1.0
    smooth_flow: float = 1.0
    smooth_second_order: bool = False
    smooth_flow_penalty: str = "L1"
    smooth_occ_penalty: str = "Quadratic"  # Quadratic|L1|Lorentzian|Dirac|KL
    smooth_occ: float = 0.1
    prior_occ: float = 0.1
    const_vel: float = 1.0

    # ---------- Optimization options (opts.lua:75-79) ----------
    LR: float = 0.0             # 0 -> default regime LR of 1e-4
    momentum: float = 0.9
    weightDecay: float = 0.0
    optimizer: str = "adam"     # adam | sgd

    # ---------- Model options (opts.lua:81-98) ----------
    netType: str = "pwc"        # pwc | spynet
    frames: int = 3
    two_frame: int = 0
    no_occ: bool = False
    levels: int = 7
    residual: int = 0
    flow_input: int = 1
    occ_input: int = 0
    rescale_flow: int = 0
    flownet_factor: float = 20.0
    original_pwc: int = 0
    pwc_ws: int = 9
    pwc_skip: int = 2
    pwc_siamese: int = 1
    pwc_sum_cvs: bool = False

    # ---------- additions without a reference analog ----------
    platform: str = ""               # "", "gpu", "cuda": the card; "cpu"
    datasets_dir: str = "datasets"   # manifest directory (donkey.lua:78)
    data_root: str = ""              # replaces [PATH] in manifests (README.md:76-80)
    trace_dir: str = ""              # trace of the first epoch's steps 2-4 (train/loop.py)
    compute_dtype: str = "bfloat16"  # conv/matmul compute dtype
    param_dtype: str = "float32"
    mesh_shape: Tuple[int, ...] = ()   # () -> every rank on one 'data' axis
    mesh_axes: Tuple[str, ...] = ("data",)   # or ("data", "spatial"): rows sharded
    use_pallas: bool = True            # inert in the port
    reference_grads: bool = True       # replicate hand-written reference VJPs
    prefetch_depth: int = 2            # device prefetch depth for the data loader
    # batch wire format: 'f32' or 'compact' (u8 images, normalised on the
    # device by data.wire.decode_batch)
    wire: str = "f32"
    # recompute the forward in the backward (train/step.py: one
    # activation-checkpoint region over the net)
    remat: int = 0
    # the reference rebuilds optimState each epoch, resetting Adam
    # moments (train.lua:112-121); False keeps them across epochs
    adam_reset_per_epoch: bool = True
    # global-norm gradient clipping before the optimizer update (no
    # reference analog); 0 disables
    grad_clip: float = 0.0

    # Filled in by `derive()`:
    save: str = ""
    channels: int = 9
    loadSize: Tuple[int, int, int] = (9, 320, 640)

    def derive(self, make_dirs: bool = False) -> "Options":
        """Apply the reference's derived-option logic (opts.lua:102-159)."""
        opt = dataclasses.replace(self)
        if opt.expName == "":
            opt.expName = time.strftime("%Y%m%d_%H%M%S")
        opt.save = str(Path(opt.cache) / opt.expName)

        # no_occ implies summed cost volumes (opts.lua:111-113)
        if opt.no_occ:
            opt.pwc_sum_cvs = True

        # frames must be 2 or odd (opts.lua:115-117)
        assert opt.frames == 2 or opt.frames % 2 == 1, "frames must be 2 or odd"
        opt.channels = 3 * opt.frames

        # per-dataset resolutions (opts.lua:119-135)
        if "Kitti" in opt.dataset:
            opt.loadSize = (opt.channels, 375, 1242)
            opt.fineWidth, opt.fineHeight = 1242, 375
            opt.cropWidth, opt.cropHeight = 640, 320
        elif "Sintel" in opt.dataset:
            opt.loadSize = (opt.channels, 436, 1024)
            opt.fineWidth, opt.fineHeight = 1024, 436
            opt.cropWidth, opt.cropHeight = 640, 384
        else:
            opt.loadSize = (opt.channels, 320, 640)
            opt.fineWidth, opt.fineHeight = 640, 320

        # crop overrides fine size (opts.lua:137-144)
        if opt.cropWidth > 0 and opt.cropHeight > 0:
            opt.loadSize = (opt.channels, opt.cropHeight, opt.cropWidth)
            opt.fineWidth = opt.cropWidth
            opt.fineHeight = opt.cropHeight
        else:
            opt.fineWidth = int(opt.fineWidth * opt.scale)
            opt.fineHeight = int(opt.fineHeight * opt.scale)

        # supervised optimization requires ground truth (opts.lua:146-148)
        if opt.optimize == "epe":
            opt.ground_truth = True
            # -epe defaults to 0.0 (opts.lua:60): supervised mode without an
            # explicit weight trains only the occlusion head (train.lua:312-314)
            if opt.epe == 0.0:
                warnings.warn(
                    "--optimize epe with --epe 0 (the reference default): "
                    "the supervised flow loss is weighted by zero and the "
                    "flow decoders get no gradient; pass e.g. --epe 1")

        # the compact wire defers normalisation to the device and cannot
        # represent -normalize_images 0
        if opt.wire not in ("f32", "compact"):
            raise ValueError(f"--wire {opt.wire!r}: use 'f32' or 'compact'")
        if opt.wire == "compact" and opt.normalize_images != 1:
            raise ValueError("--wire compact requires --normalize_images 1")

        # only pwc supports past_flow / conversion (opts.lua:150-154)
        if opt.netType != "pwc":
            opt.past_flow = False
            opt.convert_to_soft = False

        if make_dirs:
            Path(opt.save).mkdir(parents=True, exist_ok=True)
            # log all params (opts.lua:156-157)
            with open(Path(opt.save) / "log", "a") as f:
                f.write(json.dumps(dataclasses.asdict(opt), default=str) + "\n")
        return opt

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, indent=2)

    @staticmethod
    def from_json(s: str) -> "Options":
        d = json.loads(s)
        fields = {f.name for f in dataclasses.fields(Options)}
        d = {k: v for k, v in d.items() if k in fields}
        for k in ("loadSize", "mesh_shape", "mesh_axes"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return Options(**d)


def parse_args(argv=None) -> Options:
    """CLI front end exposing every reference flag (opts.lua:14-100), as
    back2future_tpu/config.py:234 parses them: bools from "1"/"true"/
    "yes", `mesh_shape`/`mesh_axes` as comma lists; then
    `derive(make_dirs=True)`."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Back2Future port: unsupervised multi-frame optical flow with occlusions")
    for f in dataclasses.fields(Options):
        if f.name in ("save", "channels", "loadSize"):
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        elif f.name == "mesh_shape":
            parser.add_argument("--mesh_shape", default=default, metavar="N[,M...]",
                                type=lambda s: tuple(int(v) for v in s.split(",") if v))
        elif f.name == "mesh_axes":
            parser.add_argument("--mesh_axes", default=default, metavar="AX[,AX...]",
                                type=lambda s: tuple(v for v in s.split(",") if v))
        else:
            ftype = {"int": int, "float": float, "str": str}.get(str(f.type), str)
            parser.add_argument(f"--{f.name}", type=ftype, default=default)
    ns = parser.parse_args(argv)
    return Options(**vars(ns)).derive(make_dirs=True)


__all__ = ["Options", "parse_args"]
