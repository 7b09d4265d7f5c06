"""Library inference API: `init(...) -> FlowEstimator` and the serving
export, the port of back2future_tpu/api.py (the reference's library
mode, back2future.lua:47-130).

The numpy pre- and post-processing is a copy of the JAX package's
(back2future_tpu/api.py:35-102): frames are channel-stacked,
ImageNet-normalised and snapped DOWN to the /64 grid; the finest-level
flow is nearest-resized back with u scaled by W/W64 and v by H/H64, and
the occlusion softmax is thresholded at OCC_THRESHOLD. The returned flow
is in raw network units (multiply by `flownet_factor`, 20, for pixels).

The forward runs under `torch.inference_mode()` with
`with_warped=False`: the image warps feed only the training losses.

On a mesh (`init(..., mesh=make_mesh([...]))`, parallel/mesh.py) the
estimator holds one replica of the net per slot of the mesh's `data`
axis; `compute_flow_batch` pads the batch to a multiple of the axis by
repeating the last sample (as the JAX package does), enqueues each
slice's forward on its replica's device before reading any result, and
trims the padding. Slots may share a device. With `spatial=True` and a
mesh with a `spatial` axis of S, image rows are sharded too: one replica
per (data, spatial) slot, each in a thread of its own (which enters
inference mode itself), the S slots of a data slot taking its whole
slice and computing their row bands of it, with in-process halo
exchanges (parallel/spatial.py `ThreadGroup`); slot s = 0 of each data
slot returns the whole outputs. The video path and the export are
single-device, as in the JAX package.

`FlowEstimator.export(path, sizes)` writes one `torch.export` program per
(batch, H64, W64) bucket and `load_exported(path)` serves them
(`ExportedFlowEstimator`) with the same pre- and post-processing and no
model code: this module imports `models` only inside the functions that
build nets. It does import `ops`, which registers the `b2f` custom ops
that an exported program calls.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the b2f ops an exported program calls)
from .data.augment import color_normalize
from .data.resample import resize

if TYPE_CHECKING:
    from .models import PWCConfig, PWCNet

Results = Tuple[np.ndarray, np.ndarray, np.ndarray]

OCC_THRESHOLD = 0.6666  # back2future.lua:40

# Reference pretrained-name -> converted checkpoint path (back2future.lua:100-110),
# as in back2future_tpu/api.py
PRETRAINED_PATHS = {
    "Ours-Hard": "models/RoamingImages_H",
    "Ours-Soft-ft-KITTI": "models/RoamingImages_H_KITTI_S",
    "Ours-Soft-ft-Sintel": "models/RoamingImages_H_Sintel_S",
}

EXPORT_FORMAT = "back2future_tpu_torch.export.v1"
Size = Sequence[int]   # (height, width) or (batch, height, width)


def _round_down_64(x: int) -> int:
    return max(x - (x % 64), 64)


def _bucket(size: Size) -> Tuple[int, int, int]:
    """(batch, H64, W64) of a `(height, width)` (batch 1) or
    `(batch, height, width)` size, snapped down to the /64 grid as
    compute_flow snaps its input."""
    b, (h, w) = (1, tuple(size)) if len(size) == 2 else (size[0], tuple(size[1:]))
    return int(b), _round_down_64(h), _round_down_64(w)


def _preprocess_triplets(frame_stacks, frames: int):
    """compute_flow preprocessing (back2future.lua:48-71): stack,
    channel-concat, ImageNet-normalise, snap to the /64 grid.

    Returns (imgs (B, H64, W64, 3F) float32, n, height, width)."""
    if len(frame_stacks) != frames:
        raise ValueError(f"model expects {frames} frames, got {len(frame_stacks)} "
                         f"image stacks")
    stacks = [np.stack([np.asarray(im, np.float32) for im in ims])
              if not isinstance(ims, np.ndarray) else
              np.asarray(ims, np.float32) for ims in frame_stacks]
    imgs = np.concatenate(stacks, axis=-1)          # (B, H, W, 3F)
    if imgs.shape[-1] != 3 * frames:
        raise ValueError(f"model expects {frames} frames ({3 * frames} channels), "
                         f"got {imgs.shape[-1]}")
    imgs = color_normalize(imgs)
    n, height, width = imgs.shape[:3]
    fine_h, fine_w = _round_down_64(height), _round_down_64(width)
    if (fine_h, fine_w) != (height, width):
        imgs = np.stack([resize(im, fine_h, fine_w, "bilinear") for im in imgs])
    return imgs, n, height, width


def _postprocess_results(flow_b, occ_b, n: int, height: int, width: int) -> Results:
    """compute_flow postprocessing (back2future.lua:77-91): resize the
    flow back with its components rescaled, threshold and resize the
    occlusions. Models without an occlusion head (two-frame / no_occ)
    return all-False masks."""
    flow_b = np.asarray(flow_b, np.float32)[:n]
    sc_h = height / flow_b.shape[1]
    sc_w = width / flow_b.shape[2]
    flows = np.empty((n, height, width, 2), np.float32)
    fwd_occs = np.zeros((n, height, width), bool)
    bwd_occs = np.zeros((n, height, width), bool)
    occ_b = None if occ_b is None else np.asarray(occ_b, np.float32)[:n]
    for i in range(n):
        f = resize(flow_b[i], height, width, "simple")
        f[..., 0] *= sc_w
        f[..., 1] *= sc_h
        flows[i] = f
        if occ_b is None:
            continue
        # channel 1 (index 0) past/backward, channel 2 (index 1) future/forward
        fwd_occs[i] = resize((occ_b[i, ..., 1] >= OCC_THRESHOLD).astype(np.float32),
                             height, width, "simple") > 0.5
        bwd_occs[i] = resize((occ_b[i, ..., 0] >= OCC_THRESHOLD).astype(np.float32),
                             height, width, "simple") > 0.5
    return flows, fwd_occs, bwd_occs


def _numpy(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.float().cpu().numpy()


class FlowEstimator:
    """compute_flow over one PWCNet on one device, or over its replicas
    on a mesh (module docstring).

    Eager PyTorch compiles nothing per input shape, so unlike the JAX
    estimator there are no shape buckets to warn about: `warmup` only
    takes the one-time costs out of the first request."""

    def __init__(self, net: PWCNet, device: torch.device, mesh=None, spatial: bool = False):
        """`net` on `device`, which is the mesh's first data slot's device
        when there is a mesh. Without a mesh the estimator is one slot
        that holds `net` itself. `spatial` shards rows over the mesh's
        `spatial` axis (module docstring); a mesh without one ignores it,
        as the JAX package does."""
        from .parallel.mesh import make_mesh, replicate
        from .parallel.spatial import ThreadGroup

        self.config: PWCConfig = net.cfg
        self.mesh = mesh
        self.device = device
        self._slots = make_mesh([device]) if mesh is None else mesh
        self.spatial = 1 if mesh is None or not spatial else mesh.shape.get("spatial", 1)
        self.replicas = [r.eval() for r in ([net] if mesh is None
                                            else replicate(net, mesh, self.spatial > 1))]
        self.net = self.replicas[0]
        self._groups = []
        if self.spatial > 1:
            self._groups = [ThreadGroup(self.spatial) for _ in self._slots.data_devices()]
            for i, r in enumerate(self.replicas):
                r.spatial_comm = self._groups[i // self.spatial].comm(i % self.spatial)

    def _padded_batch(self, n: int) -> int:
        """Batch size after mesh padding: a multiple of the `data` axis."""
        return n + (-n) % len(self._slots.data_devices())

    def _forward(self, x: torch.Tensor) -> List[Dict]:
        """The finest level of each data slot's forward on its slice of
        `x` (all enqueued before any is read; with a spatial axis, the
        slots run in threads of their own)."""
        from .parallel.mesh import shard_batch
        from .parallel.spatial import run_slots

        parts = shard_batch(x, self._slots)
        if not self._groups:
            return [net(part, with_warped=False)[0] for net, part in zip(self.replicas, parts)]
        devices = self._slots.slot_devices()

        def slot(i):
            with torch.inference_mode():
                part = parts[i // self.spatial].to(devices[i])
                return self.replicas[i](part, with_warped=False)[0]

        outputs = run_slots([functools.partial(slot, i) for i in range(len(self.replicas))],
                            self._groups)
        return outputs[::self.spatial]

    def _finest(self, outputs) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        g = outputs[0]
        return _numpy(g["flow"]), _numpy(g["occ"])

    def _zeros(self, size: Size) -> torch.Tensor:
        return torch.zeros((*_bucket(size), 3 * self.config.frames), dtype=torch.float32,
                           device=self.device)

    def warmup(self, sizes: Sequence[Size]) -> None:
        """One forward per size in `sizes`, each ``(height, width)`` or
        ``(batch, height, width)`` (raw input resolutions, snapped down to
        the /64 grid like compute_flow; batch defaults to 1), on the
        estimator's device. On the card that builds the kernel library,
        makes each kernel's first launch (which sets its shared-memory
        attribute) and lets cuDNN choose its plans for these shapes."""
        with torch.inference_mode():
            for size in sizes:
                b, h64, w64 = _bucket(size)
                self._forward(torch.zeros((self._padded_batch(b), h64, w64,
                                           3 * self.config.frames)))
        for net in self.replicas:
            device = next(net.parameters()).device
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def export(self, path: Union[str, Path], sizes: Sequence[Size]) -> None:
        """Serving export: for each bucket of `sizes` (as `warmup` takes
        them), `torch.export.export` of the forward that returns the
        finest level's (flow, occ) (occ None for a model without an
        occlusion head), traced on this estimator's device under
        `torch.no_grad()` and saved with its parameters as
        `forward_{b}x{h64}x{w64}.pt2`, beside a `meta.json`; served by
        `load_exported(path)`. The program holds the eager ops and the
        `b2f` kernel ops, so it rounds as this estimator does; whether the
        fused stem runs (`B2F_STEM_PALLAS`) is read while tracing and
        kept. Each bucket is warmed up first, so that the pyramid's
        resize taps enter its program as constants, not as ops run on
        every call. Each bucket's file holds its own copy of the
        weights."""
        from .ops.stem import stem_enabled

        if self.mesh is not None:
            raise ValueError("export() supports single-device estimators; "
                             "serve a mesh by loading the artifact once "
                             "per chip")
        out = Path(path)
        out.mkdir(parents=True, exist_ok=True)
        module = _FinestForward(self.net)
        buckets = []
        for size in sizes:
            b, h64, w64 = _bucket(size)
            self.warmup([size])
            with torch.no_grad():
                program = torch.export.export(module, (self._zeros(size),))
            program.example_inputs = None   # a zero batch: not worth its bytes in the file
            torch.export.save(program, out / f"forward_{b}x{h64}x{w64}.pt2")
            buckets.append([b, h64, w64])
        (out / "meta.json").write_text(json.dumps({
            "format": EXPORT_FORMAT,
            "frames": self.config.frames,
            "buckets": buckets,
            "dtype": str(self.config.dtype).replace("torch.", ""),
            "device": self.device.type,
            "stem": stem_enabled(),
            "torch_version": torch.__version__,
        }, indent=1))

    def __call__(self, *ims: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """compute_flow (back2future.lua:47-95): one (H, W, 3) image in
        [0,1] per model frame. Returns (flow (H,W,2) float32 raw network
        units, fwd_occ (H,W) bool, bwd_occ (H,W) bool)."""
        flows, fwd_occs, bwd_occs = self.compute_flow_batch(
            *(np.asarray(im, np.float32)[None] for im in ims))
        return flows[0], fwd_occs[0], bwd_occs[0]

    def compute_flow_batch(self, *frame_stacks) -> Results:
        """One argument per model frame, each (B, H, W, 3) (or a list of
        (H, W, 3) images) in [0,1]; one forward serves the whole batch.
        Returns (flows (B,H,W,2), fwd_occs (B,H,W), bwd_occs (B,H,W))."""
        imgs, n, height, width = _preprocess_triplets(frame_stacks, self.config.frames)
        pad = self._padded_batch(n) - n
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
        with torch.inference_mode():
            finest = self._forward(torch.from_numpy(imgs))
            flow = np.concatenate([_numpy(g["flow"]) for g in finest])
            occ = (None if finest[0]["occ"] is None
                   else np.concatenate([_numpy(g["occ"]) for g in finest]))
        return _postprocess_results(flow, occ, n, height, width)

    def compute_flow_video(self, frames) -> Results:
        """`frames` is a whole (N, H, W, 3) sequence in [0,1] (or a list of
        (H, W, 3) images), N >= frames. Results for all N-F+1 sliding
        F-frame windows, each equal to compute_flow on that window, with
        every frame's feature pyramid computed once. Window t covers
        frames[t:t+F], flow at its reference (centre) frame."""
        F = self.config.frames
        if self.mesh is not None:
            raise ValueError(
                "compute_flow_video is single-device (the window batch is "
                "coupled across frames); shard a workload by scene/chunk "
                "across chips instead, one estimator each")
        arr = (np.asarray(frames, np.float32) if isinstance(frames, np.ndarray)
               else np.stack([np.asarray(f, np.float32) for f in frames]))
        if arr.ndim != 4 or arr.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) video frames, got {arr.shape}")
        if arr.shape[0] < F:
            raise ValueError(f"need at least frames={F} video frames, got "
                             f"{arr.shape[0]}")
        arr = color_normalize(arr)
        n, height, width = arr.shape[:3]
        fine_h, fine_w = _round_down_64(height), _round_down_64(width)
        if (fine_h, fine_w) != (height, width):
            arr = np.stack([resize(im, fine_h, fine_w, "bilinear") for im in arr])
        w = n - F + 1
        with torch.inference_mode():
            frames_t = torch.from_numpy(arr).to(self.device)
            cs_all = self.net.pyramid(frames_t)
            cs = {f: {l: feat[f - 1:f - 1 + w] for l, feat in cs_all.items()}
                  for f in range(1, F + 1)}
            x = torch.cat([frames_t[f - 1:f - 1 + w] for f in range(1, F + 1)], dim=-1)
            flow, occ = self._finest(self.net.from_pyramids(x, cs, with_warped=False))
        return _postprocess_results(flow, occ, w, height, width)


class _FinestForward(torch.nn.Module):
    """The exported function: the finest level's (flow, occ) of the net's
    serving forward."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor):
        g = self.net(x, with_warped=False)[0]
        return g["flow"], g["occ"]


class ExportedFlowEstimator:
    """compute_flow over a `FlowEstimator.export()` artifact: the same
    pre- and post-processing, the forward from the deserialised programs,
    served under `torch.inference_mode()`; no model code, checkpoint or
    tracing in the serving process. Only exported (batch, H64, W64)
    buckets are callable; anything else raises. Each bucket's program is
    loaded at its first call."""

    def __init__(self, path: Union[str, Path], device="cuda"):
        self.path = Path(path)
        meta = json.loads((self.path / "meta.json").read_text())
        if meta.get("format") != EXPORT_FORMAT:
            raise ValueError(f"{path}: not a back2future_tpu_torch export artifact "
                             f"(format={meta.get('format')!r})")
        self.device = torch.device(device)
        if meta["device"] != self.device.type:
            raise ValueError(f"{path}: exported for device {meta['device']!r}, asked to "
                             f"serve on {self.device.type!r}; re-export on the serving device")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("load_exported(device='cuda'): no CUDA device is available")
        self.frames = int(meta["frames"])
        self.buckets = {tuple(b) for b in meta["buckets"]}
        self._modules: Dict[Tuple[int, int, int], torch.nn.Module] = {}

    def module(self, bucket: Tuple[int, int, int]) -> torch.nn.Module:
        """The loaded program of `bucket` (batch, H64, W64): x (B, H64,
        W64, 3F) float32 on the device -> (flow, occ)."""
        if bucket not in self.buckets:
            raise ValueError(f"no exported executable for (batch, H, W)={bucket}; "
                             f"artifact has {sorted(self.buckets)}; re-export with "
                             f"this bucket in `sizes`")
        mod = self._modules.get(bucket)
        if mod is None:
            b, h, w = bucket
            program = torch.export.load(self.path / f"forward_{b}x{h}x{w}.pt2")
            mod = self._modules[bucket] = program.module()
        return mod

    def __call__(self, *ims: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        flows, fwd_occs, bwd_occs = self.compute_flow_batch(
            *(np.asarray(im, np.float32)[None] for im in ims))
        return flows[0], fwd_occs[0], bwd_occs[0]

    def compute_flow_batch(self, *frame_stacks) -> Results:
        imgs, n, height, width = _preprocess_triplets(frame_stacks, self.frames)
        mod = self.module(imgs.shape[:3])
        with torch.inference_mode():
            flow, occ = mod(torch.from_numpy(imgs).to(self.device))
            flow, occ = _numpy(flow), _numpy(occ)
        return _postprocess_results(flow, occ, n, height, width)


def load_exported(path: Union[str, Path], device="cuda") -> ExportedFlowEstimator:
    """Open a serving artifact written by `FlowEstimator.export()` on
    `device`, which must be of the type it was exported on."""
    return ExportedFlowEstimator(path, device)


def _checkpoint(model) -> str:
    """The checkpoint path of a pretrained name or a path, as the JAX
    package resolves it; FileNotFoundError with its message when nothing
    is there."""
    path = PRETRAINED_PATHS.get(str(model), str(model))
    if not Path(path).exists():
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (for reference pretrained names, "
            f"convert the .t7 with tools/convert_t7.py first)")
    return path


def _load(path: str) -> Tuple[dict, PWCConfig]:
    """(params, PWCConfig) of the checkpoint at `path` (a model_<e> file
    or a directory, newest wins; back2future_tpu/api.py:473-487). The API
    serves the PWC family only: another netType raises the JAX package's
    ValueError from the options alone, before any module is built."""
    from .train.checkpoint import checkpoint_options, load_model_checkpoint, resolve_checkpoint

    file = resolve_checkpoint(path)
    opt = checkpoint_options(file)
    if opt is not None and opt.netType == "spynet":
        raise ValueError(
            f"checkpoint at {path!r} was trained with netType="
            f"SPyNetConfig; load() serves the PWC family only")
    return load_model_checkpoint(file, opt)


def init(model: Union[None, str, Path, Tuple[dict, PWCConfig]] = "Ours-Soft-ft-KITTI",
         device="cuda", dtype: str = "", seed: int = 0, mesh=None,
         spatial: bool = False) -> FlowEstimator:
    """Build a FlowEstimator on `device`.

    `model` is either
      * a reference pretrained name ("Ours-Hard", "Ours-Soft-ft-KITTI",
        the default, "Ours-Soft-ft-Sintel") or a checkpoint path (a
        directory, newest model_<e> wins, or a model_<e>.pt /
        model_<e>.msgpack file, the latter written by the JAX package),
        as in the JAX package: FileNotFoundError when no checkpoint is
        there;
      * a (params, PWCConfig) pair: `params` a flax-named tree of numpy
        arrays (models.bridge) or a `state_dict`, `PWCConfig` the
        port's; or
      * None: random weights from `torch.Generator().manual_seed(seed)`,
        the flagship 3-frame config (frames 3, levels 7, win 9, skip 2).

    `dtype` ("bfloat16" / "float32") overrides the compute dtype; the
    default is the config's own (a checkpoint's options.json), and
    bfloat16 for random weights. `device` "cuda" with no card raises.
    `mesh` (parallel.make_mesh) serves on one replica per `data` slot
    instead of on `device`; `spatial=True` shards image rows over the
    mesh's `spatial` axis too (FlowEstimator).
    """
    from .models import PWCConfig, PWCNet
    from .models.pwc import DTYPES

    if model is not None and not isinstance(model, tuple):
        model = _load(_checkpoint(model))
    device = torch.device(device) if mesh is None else mesh.data_devices()[0]
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init(device='cuda'): no CUDA device is available")
    if dtype and dtype not in DTYPES:
        raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {dtype!r}")
    generator = torch.Generator().manual_seed(seed)
    if model is None:
        config = PWCConfig(dtype=DTYPES[dtype or "bfloat16"])
        net = PWCNet(config, generator=generator)
    elif len(model) == 2:
        from .train.checkpoint import load_params

        params, config = model
        if not isinstance(config, PWCConfig):
            raise TypeError(f"expected the port's PWCConfig, got {type(config)}")
        if dtype:
            config = dataclasses.replace(config, dtype=DTYPES[dtype])
        net = PWCNet(config, generator=generator)
        load_params(net, params)
    else:
        raise TypeError(f"model as a tuple must be (params, PWCConfig), got {len(model)} items")
    return FlowEstimator(net.to(device), device, mesh, spatial)
