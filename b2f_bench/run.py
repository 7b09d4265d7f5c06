"""Run one cell of the benchmark once, on the device it is started on:

    python3 b2f_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and
the program (`back2future_tpu_torch`, whose kernel library is built on
a checkout's first run into its `_build/`). Set-up makes the weights and the
input pool from the seed on the device and warms up the cell's shapes
(`setup_s` counts from the start of this script); the window runs for
`--seconds`; then the program's state is freed and what the window
produced is compared with the plain reference. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`), `device`, with `--trace 1` `breakdown` and
`trace` (the rates of the device slice, the host slice and the untraced
rest of the window), and last
`checks`, each compared number beside its limit; those also end
standard error. Without as many CUDA devices as the cell asks for, or
with JAX or the JAX package loaded, it prints no result and exits with
another code than 0.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "back2future_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (`back2future_tpu_torch` is not `back2future_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def main(argv=None, root: Path = ROOT, device=None, started: float = STARTED) -> int:
    """One run; `device` None asks for the card the cell needs."""
    args = parse(argv)
    import torch

    from b2f_bench import harness, manifest

    cell = manifest.load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    runner = manifest.kind(cell).Runner(cell, args.seed, device)
    runner.setup()
    harness.synchronize(device)
    setup_s = time.perf_counter() - started
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    window = runner.window(args.seconds, bool(args.trace))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted = runner.attempted()
    runner.free_program()
    readings = runner.readings()

    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in sorted(cell.limits.items())}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    if args.trace:
        ctx = runner.per_layer_context(window)
        for m in cell.per_layer:
            read, part = manifest.metric_reader(cell, m["name"])
            value = read(ctx, part)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
    else:
        numbers = {**runner.end_to_end(window), "setup_s": setup_s}
        for m in cell.end_to_end:
            if numbers.get(m["name"]) is None:
                raise RuntimeError(f"{cell.name} measures no {m['name']}")
            metrics[m["name"]] = _metric(numbers[m["name"]], m["unit"])
    cuda = device.type == "cuda"
    result = {
        "correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": 1, "memory_peak_bytes": peak},
    }
    if args.trace:
        summary = window["trace"]
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["trace"] = {"setup_s": setup_s, **{
            f"{k}_triplets_per_s": window[k]["iterations"] * runner.batch / window[k]["seconds"]
            for k in ("loop", "host_loop", "untraced") if window[k]["seconds"] > 0}}
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"modules that the run may not load are loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
