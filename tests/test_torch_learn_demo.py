"""CPU tests of the port's learning-demo script
(back2future_tpu_torch/learn_demo.py), counterparts of
tests/test_learn_demo.py at its tiny sizes, and its parity with
tools/learn_demo.py:

* the full stage sequence (escape -> curriculum -> hard -> soft -> eval ->
  report) as subprocesses of the port's CLIs on the CPU, and its three
  clear exits;
* the stage argv of both scripts, captured by monkeypatching each one's
  `run_cli`, equal once the entry module and the checkpoint suffix
  (`.pt` / `.msgpack`) are set aside, and their reports equal;
* `zero_flow_baseline` equal to JAX's on one generated set;
* `past_flow_sanity` on a soft checkpoint written by the JAX package
  within rtol 1e-4, atol 1e-5 of JAX's (both forwards in f32 on the CPU;
  conv sums in another order).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_import import TOOLS, import_dynamo_from_stdlib_path

# before tools/learn_demo.py puts tools/ first on sys.path
import_dynamo_from_stdlib_path()

from back2future_tpu_torch import learn_demo  # noqa: E402
from back2future_tpu_torch.data.roaming import main as make_roaming  # noqa: E402

torch.set_num_threads(1)

TINY_TRAIN = ("--platform cpu --levels 4 --frames 3 --compute_dtype float32 "
              "--cropWidth 64 --cropHeight 32 --rand_crop 0")
TINY_EVAL = "--cpu --cropWidth 64 --cropHeight 32 --batchSize 2"


def _jax_learn_demo():
    """tools/learn_demo.py, imported as the JAX test imports it."""
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    import learn_demo as jax_learn_demo

    return jax_learn_demo


@pytest.fixture(scope="module")
def tiny_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("learn_demo_torch")
    # disjoint seeds: scenes are keyed rng((seed, i))
    make_roaming(["--out", str(root / "main"), "--n", "6", "--seed", "0",
                  "--height", "64", "--width", "96", "--frames", "3",
                  "--val_fraction", "0.34"])
    make_roaming(["--out", str(root / "esc"), "--n", "2", "--seed", "1",
                  "--height", "64", "--width", "96", "--frames", "3"])
    return root


def _args(root, out, cache, stage="all"):
    return ["--data", str(root / "main"),
            "--escape_data", str(root / "esc"),
            "--out", str(out), "--cache", str(cache),
            "--stage", stage, "--escape_epochs", "1",
            "--epochs1", "1", "--epochs2", "1",
            "--epoch_size", "2", "--batch", "2", "--wire", "f32",
            "--train_args", TINY_TRAIN, "--eval_args", TINY_EVAL]


def test_full_stage_sequencing_writes_report(tiny_sets, tmp_path):
    out = tmp_path / "evidence"
    learn_demo.main(_args(tiny_sets, out, tmp_path / "ckpt"))

    report = json.loads((out / "learning_demo.json").read_text())
    assert report["baseline"]["zero_flow_epe"] > 0
    assert report["baseline"]["n_val"] >= 1
    for k in ("eval_escape_transfer", "eval_hard", "eval_soft"):
        assert "error" not in report[k], report[k]
        assert report[k]["epe"] > 0 and report[k]["n_samples"] >= 1
        assert 0.0 <= report[k]["occ_acc"] <= 1.0
    sanity = report["past_flow_sanity"]
    assert "error" not in sanity, sanity
    assert sanity["mean_|past-future|_over_mean_|future|"] >= 0
    # the port's checkpoints, and the stage logs copied next to the report
    # (the tiny escape set has no val scenes, so no escape_test.tsv)
    for exp in ("escape", "cur30", "hard", "soft"):
        assert (tmp_path / "ckpt" / exp / "model_1.pt").exists()
    for exp in ("escape", "hard", "soft"):
        assert (out / f"{exp}_train.tsv").exists()
        assert (out / f"{exp}_console.txt").exists()
    for exp in ("hard", "soft"):
        assert (out / f"{exp}_test.tsv").exists()


def test_stage_hard_without_escape_ckpt_exits_clearly(tiny_sets, tmp_path):
    with pytest.raises(SystemExit) as e:
        learn_demo.main(_args(tiny_sets, tmp_path / "o", tmp_path / "fresh", stage="hard"))
    assert "--stage escape" in str(e.value) and "model_1.pt" in str(e.value)


def test_stage_escape_standalone_completes_without_report(tiny_sets, tmp_path):
    out = tmp_path / "o"
    learn_demo.main(_args(tiny_sets, out, tmp_path / "esc_only", stage="escape"))
    assert not (out / "learning_demo.json").exists()
    assert (tmp_path / "esc_only" / "escape" / "model_1.pt").exists()


def test_missing_main_dataset_exits_clearly(tmp_path):
    with pytest.raises(SystemExit) as e:
        learn_demo.main(["--data", str(tmp_path / "nope"), "--out", str(tmp_path / "o")])
    assert "back2future_tpu_torch.data.roaming" in str(e.value)


def _capture(module, monkeypatch, suffix):
    """Record every stage's argv instead of running it, writing the
    checkpoint that the next stage looks for."""
    stages = []

    def run_cli(args, label):
        stages.append((label, list(args)))
        value = {k: args[i + 1] for i, k in enumerate(args[:-1])}
        ckpt = Path(value["--cache"]) / value["--expName"] / f"model_{value['--nEpochs']}.{suffix}"
        ckpt.parent.mkdir(parents=True, exist_ok=True)
        ckpt.touch()

    monkeypatch.setattr(module, "run_cli", run_cli)
    monkeypatch.setattr(module, "run_eval", lambda ckpt, data, label, batch, extra: {
        "ckpt": Path(ckpt).name.replace(f".{suffix}", ""), "label": label, "batch": batch,
        "extra": list(extra)})
    monkeypatch.setattr(module, "past_flow_sanity", lambda *args, **kwargs: {"sanity": 1})
    return stages


@pytest.mark.parametrize("extra", [[], ["--curriculum", "", "--escape_data", "none",
                                        "--scene_batches", "3", "--lr1", "0.001"]],
                         ids=["defaults", "no_escape_no_curriculum"])
def test_stage_argv_match_jax(tiny_sets, tmp_path, monkeypatch, extra):
    """Both scripts, the same flags (the defaults but the paths): the same
    stages with the same argv but for the checkpoint suffix, and the same
    report."""
    jax_learn_demo = _jax_learn_demo()
    reports = {}
    for name, module, suffix in (("torch", learn_demo, "pt"),
                                 ("jax", jax_learn_demo, "msgpack")):
        stages = _capture(module, monkeypatch, suffix)
        out, cache = tmp_path / name / "out", tmp_path / "cache"
        argv = ["--data", str(tiny_sets / "main"), "--escape_data", str(tiny_sets / "esc"),
                "--out", str(out), "--cache", str(cache)] + extra
        module.main(argv)
        reports[name] = (stages, json.loads((out / "learning_demo.json").read_text()))
        for p in cache.rglob("model_*"):
            p.unlink()
    (port_stages, port_report), (jax_stages, jax_report) = reports["torch"], reports["jax"]
    assert [label for label, _ in port_stages] == [label for label, _ in jax_stages]
    assert len(port_stages) == (4 if not extra else 2)
    for (_, got), (_, want) in zip(port_stages, jax_stages):
        assert [a.replace(".pt", ".msgpack") for a in got] == want
    assert port_report == jax_report


def test_zero_flow_baseline_matches_jax(tiny_sets):
    got = learn_demo.zero_flow_baseline(tiny_sets / "main")
    want = _jax_learn_demo().zero_flow_baseline(tiny_sets / "main")
    assert got == want and got["n_val"] == 2


def test_past_flow_sanity_matches_jax_on_jax_checkpoint(tiny_sets, tmp_path):
    """A soft (past-flow) checkpoint written by the JAX package's
    save_checkpoint, read by both scripts' past_flow_sanity."""
    import jax
    import jax.numpy as jnp

    from back2future_tpu.config import Options
    from back2future_tpu.models.pwc import PWCNet, pwc_config_from_options
    from back2future_tpu.train.checkpoint import save_checkpoint
    from back2future_tpu.train.state import create_train_state

    opt = Options(levels=4, frames=3, past_flow=True, compute_dtype="float32",
                  dataset="RoamingImages", batchSize=2).derive()
    params = PWCNet(pwc_config_from_options(opt)).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 64, 9), jnp.float32))["params"]
    save_checkpoint(tmp_path, create_train_state(params, opt), opt, 1)
    ckpt = tmp_path / "model_1.msgpack"

    want = _jax_learn_demo().past_flow_sanity(ckpt, tiny_sets / "main", (64, 32))
    got = learn_demo.past_flow_sanity(ckpt, tiny_sets / "main", (64, 32), cpu=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
