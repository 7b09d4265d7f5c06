"""Process groups, cross-rank checks and the reductions of data-parallel
training (counterpart of back2future_tpu/parallel/distributed.py).

The JAX package scales out as multi-host SPMD: one process per host, a
mesh over every chip, XLA inserting the gradient all-reduce. The port
runs one process per device (a "rank") in a `torch.distributed` process
group, NCCL between cards and gloo on the CPU or between ranks that
share a card, and wraps the net in DistributedDataParallel
(train/step.py). Each rank loads only its slice of every global batch
(PrefetchLoader `shard`). `make_global_batch` has no tensor counterpart,
so the port has no such function: under DDP a rank's batch stays its
local slice, and the step's collectives (the gradient all-reduce here,
the loss normalisers and metric sums below) make the step equal to one
step on the global batch.

`initialize_multihost` joins a group from arguments, the env spec
B2F_COORDINATOR=host:port B2F_NUM_PROCESSES=n B2F_PROCESS_ID=i (how the
training CLI joins a cluster without new flags), or torchrun's
RANK/WORLD_SIZE/MASTER_ADDR; with none of them it stays single-process.

The reductions: the JAX package's losses are sums over the global batch
when `sizeAverage` is off, and means over fixed per-sample sizes or
ratios of batch sums when it is on. A rank computes its share of each
term (`loss_share`), so the global value is the sum of the shares over
ranks (`all_reduce_sum`), and so is the gradient: DDP's gradient hook
here sums (`sum_gradients_hook`) instead of averaging. Ratio metrics
all-reduce numerator and denominator. Without a group of more than one
rank every helper returns its input and the code paths are the
single-process ones.

With a `spatial` mesh axis (`init_mesh_groups(S)`), the ranks form a
data x spatial mesh of shape (D, S), rank = d*S + s: a subgroup for each
spatial group (the S ranks of data slot d, which share its batch slice
and hold row bands of it, parallel/spatial.py) and for each data group
(the D ranks of band s). At a level the net computes in row bands, each
rank computes its band's part of every loss term, so its share is the
data share alone, and the L2's mask count and the metrics' sums are
summed over the world; a level every rank of a spatial group holds
whole has its terms computed S times over, so a rank's share carries
1/S more (`loss_share`) and those counts and sums go over the data group
(`all_reduce_data`). Either way the loss shares sum over the world.

The SSIM criteria normalise by the min and max over the global batch:
`all_reduce_max` takes them over the world, which holds every rank's
part of it (a band, or the whole level S times over).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

def timeout() -> datetime.timedelta:
    """The group's collective timeout: B2F_DIST_TIMEOUT seconds, 1800 by
    default, long enough for a rank that builds the kernels or reaches
    its first step minutes after the others (sync_hosts); a collective
    past it raises."""
    return datetime.timedelta(seconds=int(os.environ.get("B2F_DIST_TIMEOUT", "1800")))


def _env_spec():
    """(init_method, world, rank) from the B2F_* spec or torchrun's env,
    else None."""
    if os.environ.get("B2F_COORDINATOR"):
        coordinator = os.environ["B2F_COORDINATOR"]
        try:
            num_processes = int(os.environ["B2F_NUM_PROCESSES"])
            process_id = int(os.environ["B2F_PROCESS_ID"])
        except KeyError as e:
            raise ValueError(
                "B2F_COORDINATOR is set but the cluster spec is "
                f"incomplete (missing {e.args[0]}): a manual launch needs "
                "all three of B2F_COORDINATOR=host:port "
                "B2F_NUM_PROCESSES=n B2F_PROCESS_ID=i") from None
        return _tcp(coordinator), num_processes, process_id
    if all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    return None


def _tcp(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join the process group (a no-op when one exists, so a caller or
    torchrun may set it up first, and a no-op with no cluster spec).

    The spec comes from the arguments, else from B2F_COORDINATOR /
    B2F_NUM_PROCESSES / B2F_PROCESS_ID (all three or ValueError), else
    from torchrun's RANK / WORLD_SIZE / MASTER_ADDR. `backend` defaults
    to NCCL when a card is present and gloo otherwise. A requested group
    that fails to form raises."""
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        spec = (_tcp(coordinator_address), int(num_processes), int(process_id))
    else:
        spec = _env_spec()
    if spec is None:
        return  # no cluster was asked for: stay single-process
    init_method, world, rank = spec
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout())


def process_count() -> int:
    """The group's world size; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def _collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current
    card for NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_hosts(tag: str = "startup") -> None:
    """Align all ranks, then form the communicator with one trivial
    all-reduce, so that the first train step starts on every rank from
    one clock and none waits out a rendezvous behind a rank that is
    still building or loading (the JAX package's rationale). No-op
    without a group of more than one rank. `tag` names the point in
    error messages."""
    if process_count() == 1:
        return
    dist.barrier()
    ones = torch.ones(1, device=_collective_device())
    dist.all_reduce(ones)
    if int(ones.item()) != process_count():
        raise RuntimeError(f"sync_hosts({tag!r}): all-reduce of ones gave {ones.item()}, "
                           f"expected {process_count()}")


def assert_same_across_hosts(tag: str, value: str) -> None:
    """Raise on every rank, rank 0 included, if any rank's `value` for
    `tag` differs from rank 0's (e.g. a `-cont` resume where only rank 0
    sees the checkpoint because opt.save is not on storage all ranks
    share). No-op without a group of more than one rank. All ranks must
    call with the same sequence of tags."""
    if process_count() == 1:
        return
    values: List[Optional[str]] = [None] * process_count()
    dist.all_gather_object(values, value)
    pid, ref = process_index(), values[0]
    hint = ("For checkpoint resume this usually means opt.save is not on "
            "storage shared by all hosts — every host must see the same "
            "checkpoints.")
    if pid != 0 and value != ref:
        raise RuntimeError(f"cross-host divergence at {tag!r}: host {pid} has "
                           f"{value!r} but host 0 has {ref!r}. {hint}")
    for other, theirs in enumerate(values):
        if theirs != ref:
            raise RuntimeError(f"cross-host divergence at {tag!r}: host {other} has "
                               f"{theirs!r} but host 0 has {ref!r}. {hint}")


def host_local_batch_size(global_batch: int) -> int:
    """The batch slice of this rank's data slot."""
    n = data_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} hosts")
    return global_batch // n


# ---------------------------------------------------- the data x spatial mesh

@dataclasses.dataclass(frozen=True)
class _MeshGroups:
    spatial: int
    spatial_group: object
    data_group: object


_MESH: Optional[_MeshGroups] = None


def init_mesh_groups(spatial: int) -> None:
    """Arrange the world as a data x spatial mesh with `spatial` ranks a
    spatial group (module docstring); every rank calls it, with the same
    value. 1 (or no group) clears it."""
    global _MESH
    _MESH = None
    if spatial == 1 or not dist.is_initialized():
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % spatial:
        raise ValueError(f"a spatial axis of {spatial} does not divide the {world} ranks")
    mine = {}
    for kind, groups in (("spatial", [[d * spatial + s for s in range(spatial)]
                                      for d in range(world // spatial)]),
                         ("data", [list(range(s, world, spatial)) for s in range(spatial)])):
        for ranks in groups:
            group = dist.new_group(ranks, timeout=timeout())
            if rank in ranks:
                mine[kind] = group
    _MESH = _MeshGroups(spatial, mine["spatial"], mine["data"])


def spatial_count() -> int:
    """Ranks of a spatial group: 1 without a spatial axis."""
    return _MESH.spatial if _MESH else 1


def data_count() -> int:
    """Data slots of the world: its ranks over `spatial_count()`."""
    return process_count() // spatial_count()


def data_index() -> int:
    """This rank's data slot."""
    return process_index() // spatial_count()


def spatial_comm():
    """This rank's spatial group as a parallel.spatial communicator."""
    from .spatial import GroupComm

    return GroupComm(_MESH.spatial_group, process_index() % _MESH.spatial, _MESH.spatial)


def all_reduce_data(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data group (the world without a spatial
    axis; outside autograd); `t` itself with one data slot."""
    if data_count() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=_MESH.data_group if _MESH else None)
    return out


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The element-wise max of `t` over the world (outside autograd, in
    one collective); `t` itself without a group of more than one rank."""
    if not data_parallel():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


# ------------------------------------------------------------- reductions

def in_group() -> bool:
    """True inside a process group, of any size: the train step runs
    through DDP there (one rank too, as under `torchrun --nproc 1`)."""
    return dist.is_initialized()


def data_parallel() -> bool:
    """True inside a group of more than one rank: the reductions below
    act only there."""
    return process_count() > 1


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over ranks (outside autograd); `t` itself without
    a group of more than one rank."""
    if not data_parallel():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def loss_share(size_average: bool, banded: bool = False) -> float:
    """The factor that turns a loss term normalised by this rank's own
    batch into its share of the global term: 1/D for a mean over a fixed
    per-sample size (`sizeAverage`), 1 for a batch sum; at a level whole
    on every rank of a spatial group (not `banded`), which compute it
    alike, over its S ranks (module docstring)."""
    return (1.0 / data_count() if size_average else 1.0) / (1 if banded else spatial_count())


def sum_gradients_hook(state, bucket):
    """DDP communication hook: all-reduce each gradient bucket (a
    `dist.GradBucket`; DDP checks a hook's annotations, so it has none)
    as a sum, the gradient of the global loss of which every rank holds
    a share."""
    work = dist.all_reduce(bucket.buffer(), async_op=True, group=state)
    return work.get_future().then(lambda fut: fut.value()[0])
