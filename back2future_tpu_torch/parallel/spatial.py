"""Image rows sharded over the `spatial` axis of a mesh (counterpart of the
JAX package's `batch_sharding(mesh, spatial=True)`, where XLA's
partitioner inserts the halo exchanges; the port writes them itself).

Slot s of a spatial group of S slots holds row band s of each sharded
pyramid level: rows s*h .. (s+1)*h - 1 of a level of S*h rows. The model
code sees one small communicator interface (`Comm`: its size, its index
and an all-gather), with two backends: `GroupComm` over a
`torch.distributed` subgroup (training ranks, parallel/distributed.py)
and `ThreadGroup` for slots that are threads of one process (serving,
api.FlowEstimator). Every collective is made by every slot of the group,
in the same order, so a slot at the image's edge takes part in a halo
exchange too.

The row ops, with their backward rules:

  halo_rows(x, k)   the band with k rows of each neighbour above and
                    below (zeros at the image's edge); backward: the
                    halo rows' gradients go back to their owners and are
                    summed there.
  gather_rows(x)    the whole level from the bands; backward: each slot
                    sums every slot's gradient of its own rows (a
                    reduce-scatter).
  shard_rows(x)     this slot's band of a whole (replicated) level; a
                    plain slice, whose backward puts the band's gradient
                    in its rows and zeros elsewhere.

The gradient invariant: a sharded tensor's gradient on its slot is the
whole gradient of its rows; a replicated tensor's gradients on the S
slots are parts that sum to its whole gradient. The backward of every
op is linear in its output gradient, so a replicated region (a level
below the plan's cut, the fused stem, the loss) keeps the invariant, its
parameters' gradients summed over the slots (DDP's summing hook) are
the whole gradients, and `shard_rows` needs no collective. The loss
keeps it too: at a sharded level each slot computes its band's part of
every term (a `Band` travels with the level's outputs; losses/common.py
reads the rows around it), the parts summing over the group to the whole
term; a replicated level's terms, computed alike on every slot, carry a
share of 1/S (parallel/distributed.py `loss_share`).

`level_plan` says which pyramid levels are sharded: those whose height
divides S into bands at least as tall as the largest halo the net reads
there; the others are replicated, each slot holding the whole level.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Comm:
    """A spatial group's communicator, as the model code sees it."""

    size: int
    index: int

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every slot's `t` (equal shapes and dtypes), in slot order, on
        `t`'s device; this slot's entry is `t` itself."""
        raise NotImplementedError


class GroupComm(Comm):
    """A `torch.distributed` subgroup of ranks. Tensors travel as their
    bytes (gloo has no bf16 all-gather). On gloo, CUDA tensors are staged
    through host memory (gloo's all-gather is taken on CPU tensors
    only); NCCL takes them as they are."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size
        self.host = dist.get_backend(group) == "gloo"

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        src = t.contiguous().view(torch.uint8)
        if self.host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return [t if i == self.index else p.to(t.device).view(t.dtype)
                for i, p in enumerate(parts)]


class ThreadGroup:
    """S slots that are threads of one process: `comm(s)` is slot s's
    communicator. A collective waits for every slot at a barrier (at most
    `timeout` seconds); `abort()` breaks it, so the other slots raise
    instead of waiting out a slot that failed. Inference only: an
    autograd backward on a card runs on one engine thread per device,
    where the slots' collectives could not meet."""

    def __init__(self, size: int, timeout: float = 600.0):
        self.size = size
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._slots: List[Optional[torch.Tensor]] = [None] * size

    def comm(self, index: int) -> "ThreadComm":
        return ThreadComm(self, index)

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        self._barrier.reset()


class ThreadComm(Comm):
    def __init__(self, group: ThreadGroup, index: int):
        self.group, self.index, self.size = group, index, group.size

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        g = self.group
        g._slots[self.index] = t
        g._barrier.wait()
        parts = [t if i == self.index else x.to(t.device, copy=True)
                 for i, x in enumerate(g._slots)]
        g._barrier.wait()   # no slot overwrites its entry before every slot read it
        return parts


def run_slots(fns: Sequence[Callable[[], object]], groups: Sequence[ThreadGroup] = ()
              ) -> List[object]:
    """Call each of `fns` in a thread of its own and return their results
    in order. An error breaks the barriers of `groups`, so that no slot
    waits for the failed one, and is raised once every thread ended (the
    first slot's own error before the broken barriers it caused)."""
    def call(fn):
        try:
            return fn()
        except BaseException:
            for g in groups:
                g.abort()
            raise

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(call, fn) for fn in fns]
        concurrent.futures.wait(futures)
    for g in groups:
        g.reset()
    errors = [f.exception() for f in futures if f.exception() is not None]
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return [f.result() for f in futures]


# ------------------------------------------------------------- row ops

def _band(t: torch.Tensor, comm: Comm) -> Tuple[int, int]:
    """(first row, rows) of this slot's band of a whole level `t`."""
    h = t.shape[1] // comm.size
    return comm.index * h, h


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, comm):
        ctx.k, ctx.comm = k, comm
        parts = comm.all_gather(torch.cat([x[:, :k], x[:, -k:]], dim=1))
        s, n = comm.index, comm.size
        zeros = x.new_zeros((x.shape[0], k, *x.shape[2:]))
        above = parts[s - 1][:, k:] if s > 0 else zeros
        below = parts[s + 1][:, :k] if s < n - 1 else zeros
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        k, comm = ctx.k, ctx.comm
        s, n = comm.index, comm.size
        parts = comm.all_gather(torch.cat([g[:, :k], g[:, -k:]], dim=1))
        dx = g[:, k:g.shape[1] - k].clone()
        if s > 0:       # the slot above holds this band's first rows as its halo below
            dx[:, :k] += parts[s - 1][:, k:]
        if s < n - 1:   # the slot below holds this band's last rows as its halo above
            dx[:, -k:] += parts[s + 1][:, :k]
        return dx, None, None


def halo_rows(x: torch.Tensor, k: int, comm: Comm) -> torch.Tensor:
    """(B, h, ...) band -> (B, k + h + k, ...): k rows of the slot above,
    the band, k rows of the slot below; zeros past the image's edge.
    Needs k <= h (the neighbours' bands hold the rows)."""
    if not 0 < k <= x.shape[1]:
        raise ValueError(f"halo of {k} rows on a band of {x.shape[1]}")
    return _Halo.apply(x, k, comm)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return torch.cat(comm.all_gather(x), dim=1)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        y0, h = _band(g, comm)
        parts = comm.all_gather(g)
        acc = parts[0][:, y0:y0 + h].float()
        for p in parts[1:]:
            acc = acc + p[:, y0:y0 + h].float()
        return acc.to(g.dtype), None


def gather_rows(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The whole level (B, S*h, ...) from each slot's band (B, h, ...)."""
    return _Gather.apply(x, comm)


def shard_rows(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """This slot's band of a whole level (module docstring)."""
    y0, h = _band(x, comm)
    return x.narrow(1, y0, h)


@dataclasses.dataclass(frozen=True)
class Band:
    """Where a slot's tensors of a sharded level lie: its spatial group's
    communicator, the band's first image row and the level's rows in all."""

    comm: Comm
    y0: int
    height: int

    @property
    def first(self) -> bool:
        """Whether the band holds the image's first row."""
        return self.comm.index == 0

    @property
    def last(self) -> bool:
        """Whether the band holds the image's last row."""
        return self.comm.index == self.comm.size - 1

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """The band's rows of a whole level `t`."""
        return t.narrow(1, self.y0, self.height // self.comm.size)


# ------------------------------------------------------------ the plan

def level_plan(height: int, size: int, levels: int, halo: int) -> Tuple[bool, ...]:
    """Whether each pyramid level 1..levels (height / 2**(l-1) rows) is
    sharded over `size` slots: its height divides into `size` bands of at
    least `halo` rows. Computed from global shapes only, so every slot
    takes the same branches and makes the same collectives."""
    plan = []
    for l in range(1, levels + 1):
        h = height >> (l - 1)
        plan.append(h << (l - 1) == height and h % size == 0 and h // size >= halo)
    return tuple(plan)
