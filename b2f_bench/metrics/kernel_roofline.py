"""`kernel_roofline.<kind>`: the `b2f::*` kernel ops of the traced
host slice against their least time, in %: the sum over their calls of each
call's bound (counts/ops.py, from the arguments one iteration dispatches,
times the iterations) over the sum of their device time in the trace.
Nothing to read where the trace holds no device time of these ops, or
where it holds another number of calls than the iterations dispatch."""

import sys

from b2f_bench.counts import ops as op_counts


def read(ctx: dict, part: str):
    if ctx["kind"] != part:
        return None
    calls = ctx["ops_per_iteration"]
    traced = ctx["ops"]
    device_s = sum(secs for _, secs in traced.values())
    n_traced = sum(n for n, _ in traced.values())
    if device_s <= 0 or n_traced != len(calls) * ctx["op_iterations"]:
        print(f"kernel_roofline: {n_traced} b2f calls traced for {len(calls)} an iteration "
              f"x {ctx['op_iterations']}, {device_s} device s: not read", file=sys.stderr)
        return None
    bound_s = ctx["op_iterations"] * sum(op_counts.bound_seconds(op, args) for op, args in calls)
    return 100.0 * bound_s / device_s
