"""The program's spans in a traced window: its span table (host seconds
and calls, `back2future_tpu_torch.utils.span_totals`) and the host
slice's device work and idle gaps put down to its spans.

In the host slice (trace.py), inside the range `trace.WINDOW`:

- each device operation (kernel, copy, memset) is put down to the
  program spans open on the host operation that launched it (its
  `kernels`; a CUPTI record's are not its own): the spans
  in that operation's `cpu_parent` chain; where the chain holds none, as
  on autograd's device thread, the spans on any thread whose interval
  holds the launch (in a train step, `step.backward` on the main thread);
- each idle gap of the device is put down to the spans whose interval
  holds its start;
- each top-level `b2f::*` operation (one inside no other) is an entry of
  its own, named `b2f::<op>`, which takes the device operations of its
  chain and the gaps that start inside it.

A device operation or a gap counts for every span that holds it
(inclusive time); what no program span holds goes to `outside`. The
entries are per iteration of the slice, host ms per call aside. With
no program spans (a program that opens none) only the `b2f::*` ops and
`outside` are there.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from . import trace

OUTSIDE = "outside"


def reset_program_spans() -> None:
    """Clear the program's span table; nothing where it has none."""
    try:
        from back2future_tpu_torch.utils import reset_span_totals
    except ImportError:
        return
    reset_span_totals()


def program_spans() -> Dict[str, Tuple[int, float]]:
    """The program's span table, name -> (calls, host seconds); empty
    where the program keeps none."""
    try:
        from back2future_tpu_torch.utils import span_totals
    except ImportError:
        return {}
    return span_totals()


def host_table(totals: Dict[str, Tuple[int, float]], iterations: int) -> Dict[str, dict]:
    """The span table of `iterations` iterations, per iteration: calls
    and host ms."""
    if iterations <= 0:
        return {}
    return {name: {"calls": calls / iterations, "host_ms": 1e3 * seconds / iterations}
            for name, (calls, seconds) in sorted(totals.items())}


def _is_host(e) -> bool:
    """An operation or range on a host thread; not the copy of a range
    that the profiler lays on the device's timeline (a user annotation
    of the device), which holds the device's, not the host's, time."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CPU


# CUPTI's records of its own overhead, as the profiler names them
CUPTI_OVERHEAD = frozenset({
    "Unknown", "Driver Compiler", "Buffer Flush", "Instrumentation", "Resource",
    "Runtime Triggered Module Loading", "Lazy Function Loading", "Command Buffer Full",
    "Activity Buffer Request", "UVM Activity Init"})


def _is_cupti(e) -> bool:
    """A CUPTI record on the host, not a PyTorch operation: a CUDA runtime
    or driver call (`cudaLaunchKernel`, `cuLaunchKernel`, ...) or CUPTI's
    overhead (`Command Buffer Full` where the launch queue fills). The
    profiler of PyTorch 2.11 hands such a record the device operations of
    the operation whose correlation id, in another numbering, equals its
    own, and that operation holds them already."""
    return (e.name.startswith("cu") and "::" not in e.name) or e.name in CUPTI_OVERHEAD


def _holding(intervals: List[Tuple[float, float, str]], t: float) -> List[str]:
    return [name for s, e, name in intervals if s <= t <= e]


def summary(events: Iterable, names: Iterable[str], iterations: int) -> Dict[str, dict]:
    """The spans of a host slice of `iterations` iterations, from its
    profiler events; `names` are the program's span names. Each entry:
    calls, device ms, kernels and idle ms per iteration, host ms a call;
    `outside` also the slice's device ms per iteration (`of_device_ms`)."""
    events = list(events)
    names = set(names)
    window = [e for e in events if e.name == trace.WINDOW and _is_host(e)]
    if not window or iterations <= 0:
        return {}
    w0, w1 = window[0].time_range.start, window[0].time_range.end

    def within(e) -> bool:
        return w0 <= e.time_range.start <= w1

    host = [e for e in events if _is_host(e) and not e.is_async and within(e)]
    device = [e for e in events if trace._is_device(e) and within(e)]

    def top_op(e) -> Optional[object]:
        """The outermost `b2f::*` operation of e's chain, e included."""
        top = None
        while e is not None:
            if e.name.startswith("b2f::"):
                top = e
            e = e.cpu_parent
        return top

    entries: Dict[str, dict] = {}

    def entry(name: str) -> dict:
        return entries.setdefault(name, {"calls": 0, "host_us": 0.0, "device_us": 0.0,
                                         "kernels": 0, "idle_us": 0.0})

    spans = [e for e in host if e.name in names]
    tops = [e for e in host if e.name.startswith("b2f::") and top_op(e.cpu_parent) is None]
    for e in spans + tops:
        x = entry(e.name)
        x["calls"] += 1
        x["host_us"] += e.time_range.elapsed_us()
    span_intervals = [(e.time_range.start, e.time_range.end, e.name) for e in spans]
    top_intervals = [(e.time_range.start, e.time_range.end, e.name) for e in tops]

    out = {"device_us": 0.0, "kernels": 0, "idle_us": 0.0}
    linked_us = 0.0
    for e in host:
        kernels = e.kernels
        if not kernels or _is_cupti(e):
            continue
        us = sum(k.duration for k in kernels)
        linked_us += us
        chain, p = [], e
        while p is not None:
            if p.name in names:
                chain.append(p.name)
            p = p.cpu_parent
        holders = chain or _holding(span_intervals, e.time_range.start)
        op = top_op(e)
        for name in set(holders) | ({op.name} if op is not None else set()):
            x = entry(name)
            x["device_us"] += us
            x["kernels"] += len(kernels)
        if not holders:
            out["device_us"] += us
            out["kernels"] += len(kernels)
    total_us = sum(e.time_range.elapsed_us() for e in device)
    # device operations linked to no host operation
    out["device_us"] += max(total_us - linked_us, 0.0)

    busy = trace._union([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                         for e in device])
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        holders = set(_holding(span_intervals, s))
        for name in holders | set(_holding(top_intervals, s)):
            entry(name)["idle_us"] += e - s
        if not holders:
            out["idle_us"] += e - s

    n = iterations
    result = {name: {"calls": x["calls"] / n, "device_ms": x["device_us"] / 1e3 / n,
                     "host_ms_per_call": x["host_us"] / 1e3 / x["calls"] if x["calls"] else 0.0,
                     "kernels": x["kernels"] / n, "idle_ms": x["idle_us"] / 1e3 / n}
              for name, x in sorted(entries.items())}
    result[OUTSIDE] = {"device_ms": out["device_us"] / 1e3 / n, "kernels": out["kernels"] / n,
                       "idle_ms": out["idle_us"] / 1e3 / n, "of_device_ms": total_us / 1e3 / n}
    return result
