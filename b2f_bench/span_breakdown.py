"""The program's spans in one cell, read as a traced run reads its window:

    python3 b2f_bench/span_breakdown.py --workload <cell> --seed <n>

from the root of a checkout, as run.py. It sets the cell up as run.py
does, then runs the two slices of the traced window
(harness.Runner.window): the device slice (`trace_seconds`, the device
alone), with the program's span table cleared before it and read after
it, and the host slice (`trace_iterations`), whose events spans.py puts
down to the program's spans. The last line of standard output is one
JSON object: `cell`, `device`, `metrics` (the per-layer metrics of
`span_metrics.json` that list the cell, and `enqueue_ms.<kind>` of the
same device slice beside them), `span_host` (the table, per iteration)
and `spans`. It checks no output against the reference: `correct` is
run.py's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

METRICS = "span_metrics.json"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    return ap.parse_args(argv)


def span_metrics(root: Path, cell: str) -> list:
    """The entries of span_metrics.json whose `workloads` list `cell`."""
    entries = json.loads((root / "b2f_bench" / METRICS).read_text())["per_layer"]
    return [m for m in entries if cell in m["workloads"]]


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """One cell's spans; `device` None asks for the card the cell needs."""
    args = parse(argv)
    import torch
    from torch.autograd.profiler import record_function

    from b2f_bench import harness, manifest, spans, trace

    cell = manifest.load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    runner = manifest.kind(cell).Runner(cell, args.seed, device)
    runner.setup()
    harness.synchronize(device)

    t = cell.traffic
    spans.reset_program_spans()
    runner.record_enqueue = True
    with trace.profiler(host=False):
        device_loop = runner.loop(t["trace_seconds"])
    runner.record_enqueue = False
    host_table = spans.host_table(spans.program_spans(), device_loop["iterations"])
    with trace.profiler(host=True) as prof:
        with record_function(trace.WINDOW):
            host_loop = runner.loop(iterations=t["trace_iterations"])
    summary = spans.summary(prof.events(), host_table, host_loop["iterations"])
    del prof

    ctx = runner.per_layer_context({"loop": device_loop, "host_loop": host_loop,
                                    "trace": {"spans": summary, "span_host": host_table}})
    metrics = {}
    for m in span_metrics(root, cell.name) + [{"name": f"enqueue_ms.{ctx['kind']}",
                                               "unit": "ms"}]:
        read, part = manifest.metric_reader(cell, m["name"])
        value = read(ctx, part)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    print(json.dumps({
        "cell": cell.name, "device": torch.cuda.get_device_name(device) if cuda else device.type,
        "metrics": metrics, "span_host": host_table, "spans": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
