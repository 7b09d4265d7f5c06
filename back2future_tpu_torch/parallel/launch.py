"""Start the ranks of a process group on one machine.

`run_ranks(target, world)` runs `target(rank, world, *args)` in `world`
ranks that form one `torch.distributed` group over `tcp://127.0.0.1`:
ranks 1.. are processes started with the spawn method (a live CUDA
context cannot be forked), rank 0 runs in the calling process unless
`rank0_here=False`. A spawned rank uses as many CPU threads as the
caller. Every rank returns its result to the caller through
a pipe; a rank that raises sends its traceback, and the caller raises
the first failing rank's error. Each spawned rank has a deadline: past
`timeout` seconds the caller kills it and raises. The group a rank
joined here is destroyed when its target returns.

Spawned ranks start with the directories that hold a `profile.py`
other than the standard library's off `sys.path` (a repo's `tools/`
may be first there, and its `profile.py` would shadow the stdlib module
that `torch._dynamo` imports through cProfile).
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import socket
import sys
import sysconfig
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .distributed import timeout as group_timeout


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _stdlib_first_path():
    stdlib = os.path.realpath(sysconfig.get_paths()["stdlib"])
    saved = sys.path[:]
    sys.path[:] = [p for p in saved
                   if os.path.realpath(p or ".") == stdlib
                   or not os.path.isfile(os.path.join(p or ".", "profile.py"))]
    try:
        yield
    finally:
        sys.path[:] = saved


def _rank_main(target, rank: int, world: int, init_method: str, backend: str,
               args: Sequence, conn, threads: int) -> None:
    """A rank's process: join the group, run the target, send
    ("ok", result) or ("error", traceback) to the caller. It uses as
    many CPU threads as the caller did."""
    torch.set_num_threads(threads)
    try:
        result = _in_group(target, rank, world, init_method, backend, args)
        conn.send(("ok", result))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        sys.exit(1)
    conn.close()


def _in_group(target, rank, world, init_method, backend, args):
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=group_timeout())
    try:
        return target(rank, world, *args)
    finally:
        dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank of `run_ranks` failed; the message holds its traceback."""


def run_ranks(target: Callable[..., Any], world: int, args: Sequence = (), *,
              backend: str = "gloo", rank0_here: bool = True,
              timeout: Optional[float] = None) -> List[Any]:
    """Run `target(rank, world, *args)` in `world` ranks of one group
    (module docstring) and return the ranks' results in rank order.
    `target` must be importable by a spawned process (a module-level
    function). A spawned rank inherits the caller's environment."""
    ctx = mp.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    first = 1 if rank0_here else 0
    procs, conns = [], []
    with _stdlib_first_path():
        for rank in range(first, world):
            parent, child = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, name=f"b2f-rank{rank}", daemon=True,
                            args=(target, rank, world, init_method, backend, tuple(args),
                                  child, torch.get_num_threads()))
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
    deadline = None if timeout is None else time.monotonic() + timeout
    results: List[Any] = [None] * world
    here_error = None
    try:
        if rank0_here:
            try:
                results[0] = _in_group(target, 0, world, init_method, backend, args)
            except BaseException as e:  # reported below, after the ranks' own errors
                here_error = e
        errors = _collect(procs, conns, first, results, deadline)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    if errors:
        rank, msg = errors[0]
        raise RankError(f"rank {rank} of {world} failed:\n{msg}") from here_error
    if here_error is not None:
        raise here_error
    return results


def _collect(procs, conns, first, results, deadline):
    """Wait for each spawned rank's message; [(rank, error text)] of the
    ranks that failed, died or ran past the deadline."""
    errors = []
    for i, (p, conn) in enumerate(zip(procs, conns)):
        rank = first + i
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        if not conn.poll(left):
            p.kill()
            errors.append((rank, "no result before the deadline (killed)"
                           if p.is_alive() or p.exitcode is None
                           else f"exited with code {p.exitcode} and no result"))
            continue
        try:
            status, payload = conn.recv()
        except EOFError:
            p.join()
            errors.append((rank, f"exited with code {p.exitcode} and no result"))
            continue
        if status == "ok":
            results[rank] = payload
        else:
            errors.append((rank, payload))
    return errors
