"""A small device mesh and batch placement (counterpart of
back2future_tpu/parallel/mesh.py).

The JAX package shards a batch over the mesh's `data` axis and lets XLA
run one program over every device. The port's mesh is a named array of
`torch.device`s: `shard_batch` splits a batch along its first dim, one
slice a data slot, and `replicate` copies a module once a slot; the
caller runs one forward a slot (api.FlowEstimator on a mesh). Slots may
share a device (two replicas on `cuda:0`, or on the CPU), which is how
the tests and a one-card machine exercise the path. Training spans
devices through ranks and DDP instead (parallel/distributed.py).
JAX's `batch_sharding` and `replicated_sharding` (the NamedShardings
that place a batch and the params) have no counterpart: the list of
data-slot devices (`Mesh.data_devices`) is all that placement needs.

A `spatial` axis shards image rows: slot (d, s) of a data x spatial mesh
holds batch slice d and row band s (`shard_batch(..., spatial=True)`,
rows split only where H divides the axis, as in JAX), and
`replicate(..., spatial=True)` copies the module once a (data, spatial)
slot. The row-sharded forward itself, its halo exchanges and its
spatial groups are parallel/spatial.py's and models/pwc.py's.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """`devices`, an array of torch.devices of shape `shape`, with one
    name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs {devices.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    def data_devices(self) -> List[torch.device]:
        """One device per slot of the `data` axis, in order (a mesh with
        no `data` axis is one slot)."""
        if "data" not in self.shape:
            return [self.devices.flat[0]]
        axis = self.axis_names.index("data")
        return list(np.moveaxis(self.devices, axis, 0).reshape(self.shape["data"], -1)[:, 0])

    def slot_devices(self) -> List[torch.device]:
        """One device per (data, spatial) slot, data-major: slot (d, s) is
        entry d * S + s (S the `spatial` axis, 1 without one)."""
        order = [self.axis_names.index(a) for a in ("data", "spatial") if a in self.shape]
        rest = [i for i in range(self.devices.ndim) if i not in order]
        devices = np.transpose(self.devices, order + rest)
        return list(devices.reshape(self.shape.get("data", 1) * self.shape.get("spatial", 1),
                                    -1)[:, 0])


def make_mesh(devices: Optional[Sequence] = None, shape: Sequence[int] = (),
              axes: Sequence[str] = ("data",)) -> Mesh:
    """A Mesh; by default every card (or the CPU when there is none) on
    one `data` axis. `devices` are torch.devices or their names, and may
    repeat a device."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")])
    flat = np.empty(len(devices), dtype=object)
    flat[:] = [torch.device(d) for d in devices]
    if not shape:
        shape = (len(flat),)
        axes = tuple(axes[:1]) or ("data",)
    return Mesh(flat.reshape(tuple(shape)), axes)


def shard_batch(batch, mesh: Mesh, spatial: bool = False,
                allow_partial: bool = False) -> List:
    """Split a dict of tensors (or one tensor) along the batch dim into
    one slice per `data` slot, each on its slot's device; returns the
    list of slices. With `spatial` and a `spatial` axis of S, one slice
    per (data, spatial) slot (`Mesh.slot_devices` order): batch slice d
    with row band s of each tensor whose second dim divides by S, the
    whole tensor otherwise (as JAX's batch sharding places it).

    A batch whose leading dim does not divide the `data` axis is only
    legitimate for a final partial validation batch: with
    ``allow_partial=True`` every slot gets the whole batch (correct, not
    parallel); otherwise it raises, as a training batch of that size
    would compute the whole batch on every device."""
    slots = mesh.data_devices()
    data_n = len(slots)
    spatial_n = mesh.shape.get("spatial", 1) if spatial else 1
    single = isinstance(batch, torch.Tensor)
    items = {"x": batch} if single else batch

    def split(x, k, dev):
        if x is None:
            return None
        if x.dim() == 0:
            return x.to(dev)
        if x.shape[0] % data_n:
            if not allow_partial:
                raise ValueError(
                    f"batch dim {x.shape[0]} does not divide the mesh's "
                    f"'data' axis ({data_n}); pick a batch size that is a "
                    f"multiple of {data_n} (replication fallback is only "
                    f"allowed for partial eval batches, allow_partial=True)")
            return x.to(dev)
        n = x.shape[0] // data_n
        return x[k * n:(k + 1) * n].to(dev)

    def band(x, d, s, dev):
        part = split(x, d, dev)
        if part is None or x.dim() < 2 or x.shape[0] % data_n or x.shape[1] % spatial_n:
            return part
        h = x.shape[1] // spatial_n
        return part[:, s * h:(s + 1) * h]

    if spatial_n == 1:
        shards = [{key: split(x, k, dev) for key, x in items.items()}
                  for k, dev in enumerate(slots)]
    else:
        shards = [{key: band(x, i // spatial_n, i % spatial_n, dev)
                   for key, x in items.items()}
                  for i, dev in enumerate(mesh.slot_devices())]
    return [s["x"] for s in shards] if single else shards


def replicate(module: torch.nn.Module, mesh: Mesh,
              spatial: bool = False) -> List[torch.nn.Module]:
    """One copy of `module` per `data` slot (with `spatial`, per (data,
    spatial) slot), on the slot's device (slots that share a device get
    copies of their own)."""
    return [copy.deepcopy(module).to(dev)
            for dev in (mesh.slot_devices() if spatial else mesh.data_devices())]
