"""The harness driven on the CPU at a tiny size (it skips its look for a
card): cells added to a copy of the benchmark by data files alone run
and report; the faults a cell can have make `correct` false; the
control, the reference in float8, fails the cells' limits. Without a
card, and without the program beside it, the harness prints no result.

Run with: python -m pytest b2f_bench/tests -q
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from b2f_bench import calibrate, faults, run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345
TINY = dict(batch=2, height=64, width=128, check_block=2, trace_seconds=1, trace_iterations=2)
# a tiny cell of each kind, added beside the cell whose limits it takes
TINY_CELLS = {"pwc3f.tiny_serve": ("pwc3f", "serve_kitti_b64", "pwc3f.serve.kitti_b64", 4),
              "pwc3f.tiny_train": ("pwc3f", "train_hard_b128", "pwc3f.train.hard_b128", 6),
              "spynet3f.tiny_train": ("spynet3f", "train_hard_b64", "spynet3f.train.pme_b64", 6)}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with the tiny cells added: a traffic file,
    a limits file and entries in BENCHMARK.json each, no code."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "b2f_bench", root / "b2f_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (config, traffic, like, pool) in TINY_CELLS.items():
        t = json.loads((ROOT / "b2f_bench" / "traffic" / f"{traffic}.json").read_text())
        tiny_traffic = f"tiny_{name.replace('.', '_')}"
        (root / "b2f_bench" / "traffic" / f"{tiny_traffic}.json").write_text(
            json.dumps({**t, **TINY, "pool": pool}))
        shutil.copy(root / "b2f_bench" / "workloads" / f"{like}.json",
                    root / "b2f_bench" / "workloads" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config, "traffic": tiny_traffic,
                                   "chips": 1, "why": "a tiny cell for the CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, cell, capsys, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "1",
                   "--trace", str(trace)], root=root, device="cpu", started=time.perf_counter())
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", ["pwc3f.tiny_serve", "spynet3f.tiny_train"])
def test_a_cell_added_by_files_runs_and_reports(tiny_root, cell, capsys):
    result, err = _run(tiny_root, cell, capsys)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    want = ({"serve_throughput", "serve_batch_p95_ms", "setup_s"} if "serve" in cell
            else {"train_throughput", "setup_s"})
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    lines = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in lines] == sorted(result["checks"])


def test_a_traced_run_reports_the_per_layer_metrics(tiny_root, capsys):
    result, _ = _run(tiny_root, "pwc3f.tiny_serve", capsys, trace=1)
    # on the CPU nothing runs on a device: the roofline finds nothing to read
    assert set(result["metrics"]) == {"mfu.serve", "device_idle.serve", "enqueue_ms.serve"}
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault", [("pwc3f.tiny_serve", "altered"),
                                        ("pwc3f.tiny_train", "unchanged"),
                                        ("pwc3f.tiny_train", "half_batch")])
def test_each_fault_makes_the_check_fail(tiny_root, cell, fault, capsys):
    with faults.FAULTS[fault]():
        result, _ = _run(tiny_root, cell, capsys)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ["pwc3f.tiny_serve", "pwc3f.tiny_train", "spynet3f.tiny_train"])
def test_the_control_fails_the_cells_limits(tiny_root, cell):
    from b2f_bench import manifest

    limits = manifest.load_cell(tiny_root, cell).limits
    (record,) = calibrate.calibrate(cell, [SEED], 0.5, True, None, root=tiny_root, device="cpu")
    assert any(record["control"][k] > v for k, v in limits.items()), record["control"]


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "b2f_bench/run.py", "--workload",
                           "pwc3f.serve.kitti_b64", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "b2f_bench", tmp_path / "b2f_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "b2f_bench/run.py", "--workload",
                           "pwc3f.serve.kitti_b64", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
def test_a_cell_on_the_card(capsys):
    """A short run of the first cell on the card, `correct` true."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc = run.main(["--workload", "pwc3f.serve.kitti_b64", "--seed", str(SEED), "--seconds", "2"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
