"""CPU tests of the port's spans (`utils.span`) and of `-trace_dir`.

* With no profiler running, `span` hands out one shared no-op context,
  enters no RecordFunction and leaves the span table empty.
* Under a CPU `torch.profiler`, a tiny hard-recipe train step runs as
  the five spans `step.decode`, `step.forward`, `step.loss`,
  `step.backward`, `step.optimizer`, in order and unnested; the PWC and
  SPyNet forwards (and PWC's `from_pyramids`) as `model.pyramid`, then
  `model.decode` holding one `model.level{r}` a level, r the resolution
  level (1 = full resolution); `span_totals()` counts each span the
  trace holds, with its host seconds.
* `train_epoch` with `trace_dir` writes a Chrome trace of the steps of
  `TRACED_STEPS`, each with its `step.*` spans.
* Spans closed on eight threads at once are all counted.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from back2future_tpu_torch.config import Options
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models.factory import model_and_config
from back2future_tpu_torch.train import create_train_state, make_train_step
from back2future_tpu_torch.train import loop
from back2future_tpu_torch.utils import SymbolLogger, reset_span_totals, span, span_totals
from back2future_tpu_torch.utils import timing

torch.set_num_threads(1)

STEP_SPANS = ["step.decode", "step.forward", "step.loss", "step.backward", "step.optimizer"]
B, H, W = 2, 32, 64


def tiny_options(**kw):
    base = dict(optimize="pme", frames=3, levels=4, pwc_ws=3, compute_dtype="float32",
                batchSize=B, cropHeight=H, cropWidth=W, pme_criterion="OBCC", past_flow=False)
    base.update(kw)
    return Options(**base).derive()


def tiny_images(opt, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, H, W, 3 * opt.frames), np.float32) * 0.1)


def profiled(fn):
    """fn() under a CPU profiler, with the span table reset before it;
    the events of the program's spans in order of their start."""
    reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = [e for e in prof.events()
             if e.name.startswith(("step.", "model.")) and e.device_type.name == "CPU"]
    return sorted(spans, key=lambda e: e.time_range.start)


def inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.fixture(autouse=True)
def empty_table():
    reset_span_totals()
    yield
    reset_span_totals()


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a RecordFunction was made for {name!r}")

    monkeypatch.setattr(timing._profiler, "record_function", no_range)
    assert span("step.forward") is span("model.level3")
    with span("step.forward"):
        with span("model.level3"):
            pass
    assert span_totals() == {}


def test_a_train_step_runs_as_five_spans_in_order():
    opt = tiny_options()
    net, _ = model_and_config(opt)
    state = create_train_state(net, opt)
    step = make_train_step(net, opt, build_criterions(opt))
    x = tiny_images(opt)
    events = profiled(lambda: step(state, {"images": x}))
    phases = [e for e in events if e.name.startswith("step.")]
    assert [e.name for e in phases] == STEP_SPANS
    for a, b in zip(phases, phases[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)
    forward = phases[1]
    assert all(inside(e, forward) for e in events if e.name.startswith("model."))
    totals = span_totals()
    assert {name: calls for name, (calls, _) in totals.items()} == {
        name: sum(e.name == name for e in events) for name in {e.name for e in events}}
    assert all(seconds > 0 for _, seconds in totals.values())
    assert all(p.grad is not None for p in net.parameters())   # kept after the step


def _pwc_from_pyramids(net, x):
    frames = [x[..., 3 * f:3 * f + 3] for f in range(net.cfg.frames)]
    cs = {f + 1: net.pyramid(frame) for f, frame in enumerate(frames)}
    reset_span_totals()
    return lambda: net.from_pyramids(x, cs, with_warped=False)


@pytest.mark.parametrize("net_type,path,levels", [
    ("pwc", "forward", [4, 3]),
    ("pwc", "from_pyramids", [4, 3]),
    ("spynet", "forward", [3, 2, 1]),
])
def test_a_forward_runs_as_pyramid_decode_and_levels(net_type, path, levels):
    opt = tiny_options(netType=net_type, levels=4 if net_type == "pwc" else 3)
    net, _ = model_and_config(opt)
    x = tiny_images(opt)
    with torch.inference_mode():
        call = (_pwc_from_pyramids(net, x) if path == "from_pyramids"
                else lambda: net(x, with_warped=False))
        events = profiled(call)
    names = [e.name for e in events]
    assert names == ["model.pyramid", "model.decode", *[f"model.level{r}" for r in levels]]
    pyramid, decode, *level_events = events
    assert pyramid.time_range.end <= decode.time_range.start
    assert all(inside(e, decode) for e in level_events)
    assert {n: c for n, (c, _) in span_totals().items()} == {n: 1 for n in names}


def test_trace_dir_writes_the_traced_steps_with_their_spans(tmp_path):
    opt = tiny_options(trace_dir=str(tmp_path / "trace"))
    net, _ = model_and_config(opt)
    state = create_train_state(net, opt)
    step = make_train_step(net, opt, build_criterions(opt))
    n_steps = loop.TRACED_STEPS.stop + 1

    class Loader:
        def set_epoch(self, epoch):
            pass

        def __len__(self):
            return n_steps

        def __iter__(self):
            return iter([{"images": tiny_images(opt, seed).numpy()} for seed in range(n_steps)])

    state, means = loop.train_epoch(1, state, step, Loader(), opt, SymbolLogger(tmp_path / "log"),
                                    "cpu", verbose=False, trace_dir=opt.trace_dir)
    assert state.step == n_steps and np.isfinite(means["loss"])
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"]
    for name in STEP_SPANS:
        assert names.count(name) == len(loop.TRACED_STEPS), name
    assert "model.decode" in names and "model.level3" in names
    assert span_totals()["step.forward"][0] == len(loop.TRACED_STEPS)


def test_spans_on_many_threads_count_every_call():
    """The table's updates hold under threads that close spans together
    (autograd's thread opens the net's spans when a remat backward
    recomputes the forward)."""
    n_threads, n_spans = 8, 200

    def work():
        for _ in range(n_spans):
            with span("model.level1"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert span_totals()["model.level1"][0] == n_threads * n_spans
