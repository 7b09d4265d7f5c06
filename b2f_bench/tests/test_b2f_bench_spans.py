"""The program's spans as the benchmark reads them (spans.py, the
readers `span_device_ms` and `span_host_ms`, span_breakdown.py):

* the attribution on fabricated profiler events: a kernel put down to
  the span of its host operation's chain, an operation on autograd's
  thread with no span of its own put down to `step.backward` open on the
  main thread, a top-level `b2f::*` op as an entry of its own, idle gaps
  by the spans open at their start, and what no span holds in `outside`;
* the two readers on a fabricated context, and nothing to read where the
  program opens no spans (a parent without them) or in a cell of the
  other kind;
* span_breakdown.py on the CPU at a tiny size: the spans of a serving
  and a training cell, their host metrics, no device metric.

Run with: python -m pytest b2f_bench/tests -q
"""

import json
import shutil
import types
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from b2f_bench import span_breakdown, spans, trace
from b2f_bench.metrics import span_device_ms, span_host_ms

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 54321
CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def host(name, start, end, thread=1, parent=None, kernels=()):
    return types.SimpleNamespace(
        name=name, time_range=Range(start, end), thread=thread, cpu_parent=parent,
        device_type=CPU, is_async=False, is_user_annotation=False,
        kernels=[types.SimpleNamespace(name="k", device=0, duration=d) for d in kernels])


def kernel(start, end, name="k", annotation=False):
    return types.SimpleNamespace(name=name, time_range=Range(start, end), cpu_parent=None,
                                 device_type=CUDA, is_async=False, is_user_annotation=annotation,
                                 kernels=[])


def fabricated_step():
    """One train step in a window of 100 us: the forward's conv on the
    main thread, a multiply and a top-level b2f op on autograd's thread
    (thread 2) while the main thread is in `step.backward`, Adam's step,
    one device operation linked to no host operation, two CUPTI records
    that an older profiler hands another operation's kernel, and the profiler's
    copy of `step.forward` on the device's timeline, which lasts into
    the backward and holds no host operation."""
    window = host(trace.WINDOW, 0, 100)
    forward = host("step.forward", 10, 30, parent=window)
    conv = host("aten::conv", 12, 20, parent=forward, kernels=[5])
    # CUPTI records whose correlation ids, in their own numbering, equal the
    # multiply's: an older profiler hands them the multiply's kernel too
    launch = host("cudaLaunchKernel", 13, 14, parent=conv, kernels=[7])
    full = host("Command Buffer Full", 14, 15, parent=conv, kernels=[7])
    backward = host("step.backward", 40, 80, parent=window)
    engine = host("autograd::engine::evaluate_function: MulBackward0", 44, 52, thread=2)
    mul = host("aten::mul", 45, 50, thread=2, parent=engine, kernels=[7])
    dflow = host("b2f::warp_dflow", 55, 60, thread=2)
    zero = host("aten::zero_", 56, 57, thread=2, parent=dflow, kernels=[1, 1])
    optimizer = host("step.optimizer", 85, 95, parent=window)
    adam = host("Optimizer.step#Adam.step", 86, 94, parent=optimizer, kernels=[3])
    device = [kernel(14, 19), kernel(46, 53), kernel(57, 58), kernel(58, 59), kernel(88, 91),
              kernel(96, 97), kernel(14, 48, "step.forward", annotation=True)]
    return [window, forward, conv, launch, full, backward, engine, mul, dflow, zero, optimizer,
            adam, *device]


def test_kernels_and_gaps_go_to_the_spans_that_hold_them():
    names = ["step.forward", "step.backward", "step.optimizer"]
    got = spans.summary(fabricated_step(), names, iterations=1)
    assert set(got) == {*names, "b2f::warp_dflow", spans.OUTSIDE}
    us = 1e-3
    assert got["step.forward"] == pytest.approx(
        {"calls": 1, "device_ms": 5 * us, "host_ms_per_call": 20 * us, "kernels": 1,
         "idle_ms": 27 * us})
    # the multiply and the b2f op ran on autograd's thread, inside no span of
    # their own thread: the main thread's step.backward holds them
    assert got["step.backward"] == pytest.approx(
        {"calls": 1, "device_ms": 9 * us, "host_ms_per_call": 40 * us, "kernels": 3,
         "idle_ms": (4 + 29) * us})
    assert got["b2f::warp_dflow"] == pytest.approx(
        {"calls": 1, "device_ms": 2 * us, "host_ms_per_call": 5 * us, "kernels": 2,
         "idle_ms": 29 * us})
    assert got["step.optimizer"]["device_ms"] == pytest.approx(3 * us)
    assert got["step.optimizer"]["idle_ms"] == pytest.approx(5 * us)
    assert got[spans.OUTSIDE] == pytest.approx(
        {"device_ms": 1 * us, "kernels": 0, "idle_ms": (14 + 3) * us, "of_device_ms": 18 * us})
    # every device operation counts once among the unnested phases and outside
    phases = sum(got[n]["device_ms"] for n in names) + got[spans.OUTSIDE]["device_ms"]
    assert phases == pytest.approx(got[spans.OUTSIDE]["of_device_ms"])


def test_without_program_spans_only_the_ops_and_outside():
    got = spans.summary(fabricated_step(), [], iterations=2)
    assert set(got) == {"b2f::warp_dflow", spans.OUTSIDE}
    assert got[spans.OUTSIDE]["device_ms"] == pytest.approx(got[spans.OUTSIDE]["of_device_ms"])
    assert got["b2f::warp_dflow"]["calls"] == 0.5


def test_the_host_table_is_per_iteration():
    assert spans.host_table({"model.decode": (8, 0.4)}, 4) == {
        "model.decode": {"calls": 2.0, "host_ms": 100.0}}
    assert spans.host_table({"model.decode": (8, 0.4)}, 0) == {}


def test_the_readers():
    ctx = {"kind": "train",
           "spans": {"step.backward": {"device_ms": 120.0},
                     spans.OUTSIDE: {"device_ms": 0.1, "of_device_ms": 180.0}},
           "span_host": {"model.decode": {"calls": 1.0, "host_ms": 15.0}}}
    assert span_device_ms.read(ctx, "train.step.backward") == 120.0
    assert span_host_ms.read(ctx, "train.model.decode") == 15.0
    assert span_device_ms.read(ctx, "serve.step.backward") is None
    assert span_device_ms.read(ctx, "train.step.forward") is None
    assert span_host_ms.read({**ctx, "kind": "serve"}, "train.model.decode") is None
    # a program that opens no spans, and a slice with no device time (the CPU)
    assert span_device_ms.read({"kind": "train"}, "train.step.backward") is None
    assert span_host_ms.read({"kind": "train", "span_host": {}}, "train.model.decode") is None
    cpu = {**ctx, "spans": {**ctx["spans"], spans.OUTSIDE: {"of_device_ms": 0.0}}}
    assert span_device_ms.read(cpu, "train.step.backward") is None


def test_the_metric_entries_fit_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    kinds = {"serve": "serve_throughput", "train": "train_throughput"}
    entries = json.loads((ROOT / "b2f_bench" / span_breakdown.METRICS).read_text())["per_layer"]
    assert len(entries) == 8
    for m in entries:
        family, kind, _ = m["name"].split(".", 2)
        assert family in ("span_device_ms", "span_host_ms") and m["moves"] == kinds[kind]
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert all(f".{kind}." in cells[w]["name"] for w in m["workloads"])


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with a tiny serving and a tiny training
    cell, listed in the span metrics' cells beside the cells they copy."""
    root = tmp_path_factory.mktemp("spans")
    shutil.copytree(ROOT / "b2f_bench", root / "b2f_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = json.loads((ROOT / "b2f_bench" / span_breakdown.METRICS).read_text())
    tiny = dict(batch=2, height=64, width=128, check_block=2, trace_seconds=1,
                trace_iterations=2, checked_steps=1)
    for name, config, traffic, like in [
            ("pwc3f.tiny_serve", "pwc3f", "serve_kitti_b64", "pwc3f.serve.kitti_b64"),
            ("spynet3f.tiny_train", "spynet3f", "train_hard_b64", "spynet3f.train.pme_b64")]:
        t = json.loads((ROOT / "b2f_bench" / "traffic" / f"{traffic}.json").read_text())
        (root / "b2f_bench" / "traffic" / f"tiny_{traffic}.json").write_text(
            json.dumps({**t, **tiny, "pool": 4}))
        shutil.copy(root / "b2f_bench" / "workloads" / f"{like}.json",
                    root / "b2f_bench" / "workloads" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config, "traffic": f"tiny_{traffic}",
                                   "chips": 1, "why": "a tiny cell for the CPU tests"})
        for m in metrics["per_layer"]:
            if like in m["workloads"]:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "b2f_bench" / span_breakdown.METRICS).write_text(json.dumps(metrics))
    return root


@pytest.mark.parametrize("cell,want_spans,want_metrics", [
    ("pwc3f.tiny_serve", {"model.pyramid", "model.decode", "model.level3", "model.level7"},
     {"span_host_ms.serve.model.pyramid", "span_host_ms.serve.model.decode",
      "enqueue_ms.serve"}),
    ("spynet3f.tiny_train", {"step.decode", "step.forward", "step.loss", "step.backward",
                             "step.optimizer", "model.level1"},
     {"enqueue_ms.train"}),
])
def test_span_breakdown_on_the_cpu(tiny_root, cell, want_spans, want_metrics, capsys):
    rc = span_breakdown.main(["--workload", cell, "--seed", str(SEED)], root=tiny_root,
                             device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["cell"] == cell and out["device"] == "cpu"
    # the CPU runs no device operation: no device metric is read
    assert set(out["metrics"]) == want_metrics
    assert want_spans <= set(out["spans"]) and want_spans <= set(out["span_host"])
    assert all(out["span_host"][n]["calls"] == 1 for n in want_spans)
    assert out["spans"][spans.OUTSIDE]["of_device_ms"] == 0
    host_ms = sum(out["span_host"][n]["host_ms"] for n in ("model.pyramid", "model.decode"))
    enqueue = out["metrics"][f"enqueue_ms.{'serve' if 'serve' in cell else 'train'}"]["value"]
    assert 0 < host_ms <= enqueue
