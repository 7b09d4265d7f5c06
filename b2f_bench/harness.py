"""The parts of a run that every traffic kind shares: the seeded pool of
input batches, the timed loop, the traced window, and the comparisons
that decide `correct`.
"""

from __future__ import annotations

import random
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from . import inputs, manifest, trace, weights


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    """One cell's run on one device: `setup`, then `window` (timed or
    traced), then `free_program`, then `readings` against the reference.
    A kind defines `setup`, `iterate` (one batch or step of the window),
    `free_program` and `readings`, and the window's numbers in
    `end_to_end`."""

    spans: tuple = ()

    def __init__(self, cell: manifest.Cell, seed: int, device):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        self.traffic = cell.traffic
        self.batch = self.traffic["batch"]
        self.reference = manifest.reference(cell)
        self.ref_options = cell.options
        self.shapes = self.reference.param_shapes(self.ref_options)
        self.iterations = 0
        self.enqueue_s: List[float] = []
        self.record_enqueue = False

    def make_params(self) -> Dict[str, torch.Tensor]:
        return weights.make_params(self.shapes, self.seed, self.device)

    def make_pool(self) -> List[torch.Tensor]:
        t = self.traffic
        pool = inputs.render(self.seed, t["pool"], t["height"], t["width"],
                             self.ref_options["frames"], t["scene"]["layers"],
                             t["scene"]["max_speed"], self.device)
        return list(pool.split(self.batch))

    def rng(self, tag: str) -> random.Random:
        return random.Random(weights.sub_seed(self.seed, tag))

    def timed(self, call: Callable):
        """`call()` with its host time kept when enqueue times are kept."""
        if not self.record_enqueue:
            return call()
        t0 = time.perf_counter()
        out = call()
        self.enqueue_s.append(time.perf_counter() - t0)
        return out

    def loop(self, seconds: float = 0.0, iterations: Optional[int] = None) -> dict:
        """`iterations` iterations, or without them as many as begin
        before `seconds` have passed; then synchronise. The iterations
        and the seconds from the start to the synchronise."""
        synchronize(self.device)
        first = self.iterations
        t0 = time.perf_counter()
        while (self.iterations - first < iterations if iterations is not None
               else time.perf_counter() - t0 < seconds):
            self.iterate()
        synchronize(self.device)
        return {"iterations": self.iterations - first, "seconds": time.perf_counter() - t0}

    def window(self, seconds: float, traced: bool) -> dict:
        """The measured window. Untraced: the kind's end-to-end numbers.
        Traced: two slices, then the rest of `seconds` untraced, to state
        what tracing costs. The device slice (`trace_seconds`) records
        the device alone, whose recording costs the host little: its busy
        and idle time, its top operations, and the host's enqueue times.
        The host slice (`trace_iterations` iterations) records the host's
        operations too, which slows a host-bound loop: from it come the
        `b2f::*` ops' device time and what the host was doing in each
        idle gap of the device."""
        if not traced:
            return {"loop": self.loop(seconds)}
        from torch.autograd.profiler import record_function

        t = self.traffic
        self.record_enqueue = True
        with trace.profiler(host=False) as prof:
            device_loop = self.loop(min(seconds, t["trace_seconds"]))
        self.record_enqueue = False
        device = trace.device_summary(prof, device_loop["seconds"])
        del prof
        with trace.profiler(host=True) as prof:
            with record_function(trace.WINDOW):
                host_loop = self.loop(iterations=t["trace_iterations"])
        host = trace.host_summary(prof, self.spans)
        del prof
        spent = device_loop["seconds"] + host_loop["seconds"]
        rest = self.loop(max(seconds - spent, 0.0))
        return {"loop": device_loop, "host_loop": host_loop, "untraced": rest,
                "trace": {**device, **host}}


def p95(values: List[float]) -> float:
    """The 95th percentile (statistics' 'inclusive' quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per leading index: ||got - want|| / ||want|| over the rest."""
    d = (got.float() - want.float()).flatten(1)
    return d.norm(dim=1) / want.float().flatten(1).norm(dim=1).clamp_min(1e-30)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              names: Optional[List[str]] = None) -> List[float]:
    """Each leaf's |got - want| over the larger of want's value and the
    median of want's values, over `names` (all by default)."""
    names = list(want) if names is None else names
    median = statistics.median(want.values())
    return [abs(got.get(n, 0.0) - want[n]) / max(want[n], median) for n in names]
