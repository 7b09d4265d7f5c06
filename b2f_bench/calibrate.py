"""Readings for the limits of a cell's check, on the chip, in one
process over many seeds:

    python3 b2f_bench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 3 [--control] [--fault altered|unchanged|half_batch]

For each seed: set-up, a window of `--seconds` at the cell's own load,
then the compared numbers of the program against the plain reference,
with `--control` also those of the control (the reference in float8 in
the program's place), with `--fault` those of the program with that
fault planted (faults.py). One JSON line a seed on standard output.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def calibrate(cell_name: str, seeds, seconds: float, control: bool, fault, root: Path = ROOT,
              device="cuda:0"):
    """Yield one record a seed."""
    import torch

    from b2f_bench import faults, harness, manifest

    cell = manifest.load_cell(root, cell_name)
    kind = manifest.kind(cell)
    planted = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    with planted:
        for seed in seeds:
            t0 = time.perf_counter()
            runner = kind.Runner(cell, seed, torch.device(device))
            runner.setup()
            harness.synchronize(runner.device)
            setup_s = time.perf_counter() - t0
            window = runner.window(seconds, False)
            e2e = runner.end_to_end(window)
            runner.free_program()
            t1 = time.perf_counter()
            record = {"cell": cell_name, "seed": seed, "fault": fault, "setup_s": setup_s,
                      **e2e, "program": runner.readings()}
            record["check_s"] = time.perf_counter() - t1
            if control:
                record["control"] = runner.readings(control=True)
            del runner
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            yield record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("altered", "unchanged", "half_batch"))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for record in calibrate(args.workload, seeds, args.seconds, args.control, args.fault):
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
