"""The traced slices: `torch.profiler` over the device alone, then over
the device and the host, and their reduction to what the per-layer
metrics and the breakdown read (harness.Runner.window).

Device time is the union of the intervals in which a kernel, a copy or
a memset ran on the device. In the host slice, inside the range
`WINDOW` that the harness opens around its iterations (their last
synchronise included), each idle gap of the device is put down to what
the host was doing at its start: the innermost operation then running
on the host (runtime API calls aside), under the harness's span of that
iteration; and each top-level `b2f::*` operation (one not inside
another) brings its device time, the kernels of the operations inside
it included.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

WINDOW = "b2f_bench.window"
TOP = 10
NAME = 160          # characters of an operation's name kept in the breakdown
SEARCH = 20000      # host events searched back from a gap for the one running then


def profiler(host: bool):
    """The profiler of a slice: the device's activity, and with `host`
    the host's operations too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def device_summary(prof, window_s: float) -> dict:
    """Of a device slice that lasted `window_s` by the host's clock, from
    a synchronise to a synchronise: the seconds in which the device ran
    an operation (the union of their intervals) and its top operations."""
    device = [e for e in prof.events() if _is_device(e)]
    busy = _union([(e.time_range.start, e.time_range.end) for e in device])
    by_op: Dict[str, float] = {}
    for e in device:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(e - s for s, e in busy) / 1e6, "window_s": window_s,
            "device_ops": [[name[:NAME], us / 1e6] for name, us in top]}


def host_summary(prof, spans: Tuple[str, ...]) -> dict:
    """Of a host slice inside the range `WINDOW`: the `b2f::*` ops' calls
    and device seconds by name, and the idle gaps of the device by what
    the host was doing; `spans` are the harness's iteration spans."""
    events = list(prof.events())
    window = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
                   if _is_device(e) and e.time_range.end > w0 and e.time_range.start < w1])
    host = sorted((e for e in events if not _is_device(e) and e.name != WINDOW
                   and not e.name.startswith("cuda")),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps: Dict[str, float] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            what = _host_activity(host, starts, s, spans)
            gaps[what] = gaps.get(what, 0.0) + (e - s) / 1e6
    idle_gaps = [[name[:NAME], s] for name, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]

    ops: Dict[str, Tuple[int, float]] = {}
    for e in events:
        if _is_device(e) or not e.name.startswith("b2f::"):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("b2f::"):
            parent = parent.cpu_parent
        if parent is None:
            name = e.name[len("b2f::"):]
            calls, secs = ops.get(name, (0, 0.0))
            ops[name] = (calls + 1, secs + e.device_time_total / 1e6)
    return {"ops": ops, "idle_gaps": idle_gaps}


def _host_activity(host, starts, t: float, spans) -> str:
    """"<span>/<innermost op>" running on the host at time t."""
    i = bisect.bisect_right(starts, t) - 1
    inner = None
    stop = max(i - SEARCH, -1)
    while i > stop and inner is None:
        e = host[i]
        if e.time_range.end >= t:
            inner = e
        i -= 1
    if inner is None:
        return "outside any operation"
    span, e = None, inner
    while e is not None:
        if e.name in spans:
            span = e.name
        e = e.cpu_parent
    return f"{span or 'no span'}/{inner.name}" if inner.name != span else inner.name
