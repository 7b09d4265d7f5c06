"""CPU tests of the port's epoch loop (`train.loop.run`), its resume paths
and its two CLIs, against the JAX package's on a toy tree (40x72 frames
with ground-truth flow and occlusion maps, cropped to 32x64; the tiny f32
config: levels 4, win 3, B=2).

* The port mirrors of tests/test_loop.py:31-105: two epochs write the
  checkpoint pairs and the logs; the `-cont` step counters (a fresh
  counter with the per-epoch Adam reset, the saved one without); a run
  resumed with `-cont` equals a straight run bit for bit.
* The three-stage hard -> soft recipe through `convert_to_soft`.
* Across packages, from one JAX-written `model_0.msgpack` through
  `-retrain`: JAX `run()` and the port's `run()` write the same
  train.log / test.log rows within 1e-4 relative, and end on the same
  params (rtol 1e-3, atol a tenth of LR, as
  tests/test_torch_train.py::test_train_steps_match_jax, for all but
  1e-5 of the elements: `assert_params_close`); the port resumes JAX's
  own msgpack pair with `-cont` and persistent Adam moments and lands on
  JAX's params of the next epoch at the same tolerance.
* `python -m back2future_tpu_torch.main --platform cpu` writes the
  checkpoint pair, the logs, their SVGs and `log`;
  `python -m back2future_tpu_torch.eval --cpu` prints the keys of
  tools/eval.py on the same checkpoint, with values within 1e-4.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp

from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.data import SampleSpec, resample as jax_resample, write_manifest
from back2future_tpu.io.flow_io import write_disp, write_flo
from back2future_tpu.io.png16 import write_png
from back2future_tpu.train import checkpoint as jax_checkpoint
from back2future_tpu.train.loop import run as jax_run
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.data.resample import TWINS_ENV
from back2future_tpu_torch.io import flax_msgpack
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.train.checkpoint import load_or_convert
from back2future_tpu_torch.train.loop import build_model, run
from back2future_tpu_torch.utils import SymbolLogger

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3


@pytest.fixture(scope="module")
def toy_tree(tmp_path_factory):
    """7 frames, 4 samples with .flo ground truth and {0, 0.5, 1}
    occlusion maps; split 2 train / 2 val."""
    root = tmp_path_factory.mktemp("toyloop")
    (root / "datasets").mkdir()
    rng = np.random.default_rng(0)
    h, w = 40, 72
    for i in range(1, 8):
        write_png(root / f"img_{i:02d}.png", (rng.random((h, w, 3)) * 255).astype(np.uint8))
    labels = np.array([0.0, 0.5, 1.0], np.float32)
    for r in (2, 3, 4, 5):
        write_flo(root / f"flow_{r:02d}.flo", rng.standard_normal((h, w, 2)).astype(np.float32))
        write_disp(root / f"flow_{r:02d}_occ_3.disp", rng.choice(labels, (h, w)))
    write_manifest(root / "datasets" / "toy.dat",
                   [SampleSpec("[PATH]/img_%02d.png", "[PATH]/flow_%02d.flo", r, 1)
                    for r in (2, 3, 4, 5)])
    (root / "datasets" / "toy_split.dat").write_text("1\n1\n2\n2\n")
    return root


def toy_options(root, cls=Options, **kw):
    base = dict(dataset="toy", datasets_dir=str(root / "datasets"), data_root=str(root),
                cache=str(root / "ckpt"), optimize="pme", frames=3, levels=4, pwc_ws=3,
                compute_dtype="float32", cropHeight=32, cropWidth=64, batchSize=2,
                epochSize=2, nEpochs=2, nDonkeys=0, epochStore=1, nGPU=1, platform="cpu",
                ground_truth=True)
    base.update(kw)
    return cls(**base).derive(make_dirs=True)


def params_of(path) -> dict:
    """torch name -> array of a .pt state_dict or a flax msgpack file."""
    from back2future_tpu_torch.models.bridge import flax_to_torch_names

    if Path(path).suffix == ".pt":
        return {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    return flax_to_torch_names(flax_msgpack.load(path))


def test_run_two_epochs_checkpoints_and_logs(toy_tree):
    opt = toy_options(toy_tree, expName="itest")
    state = run(opt)
    assert state.step == 4  # 2 epochs x 2 batches
    save = Path(opt.save)
    for e in (1, 2):
        assert (save / f"model_{e}.pt").exists() and (save / f"optimState_{e}.pt").exists()
    for name in ("train.svg", "test.svg", "options.json", "log"):
        assert (save / name).exists(), name
    train_cols = SymbolLogger(save / "train.log").read()
    assert len(train_cols["avg loss (train set)"]) == 2
    assert all(np.isfinite(v) for v in train_cols["avg epe (train set)"])
    test_cols = SymbolLogger(save / "test.log").read()
    assert len(test_cols["avg loss (test set)"]) == 2 and "avg occ acc (test set)" in test_cols

    # -cont resume picks up after the last checkpoint, with a fresh step
    # counter under the per-epoch Adam reset ...
    state2 = run(dataclasses.replace(opt, cont=True, nEpochs=3))
    assert state2.step == 2 and (save / "model_3.pt").exists()
    # ... and restores the optimiser state and step from optimState_<e>
    # with persistent Adam moments (model.lua:51-130)
    state3 = run(dataclasses.replace(opt, cont=True, nEpochs=4, adam_reset_per_epoch=False))
    assert state3.step == 4 and (save / "model_4.pt").exists()
    assert len(SymbolLogger(save / "train.log").read()["avg loss (train set)"]) == 4


def test_run_device_choice(toy_tree, monkeypatch):
    """`--platform cpu` is the only way to the CPU: the card asked for and
    absent raises, as do more cards than the host has (the JAX package's
    ValueError), a data x spatial mesh shape that does not hold the ranks
    and an unknown platform."""
    from back2future_tpu_torch.train.loop import run_device

    assert run_device(toy_options(toy_tree, expName="dev")).type == "cpu"
    if not torch.cuda.is_available():
        for platform in ("", "gpu", "cuda"):
            with pytest.raises(RuntimeError, match="--platform cpu"):
                run(toy_options(toy_tree, expName="dev", platform=platform))
    with pytest.raises(ValueError, match=r"does not hold the 1 "):
        run(toy_options(toy_tree, expName="dev", mesh_shape=(1, 2),
                        mesh_axes=("data", "spatial")))
    with pytest.raises(ValueError, match="platform"):
        run(toy_options(toy_tree, expName="dev", platform="tpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="this host has only 1"):
        run(toy_options(toy_tree, expName="dev", platform="", nGPU=2))


def test_resume_trajectory_matches_straight_run(toy_tree):
    """1 epoch + `-cont` for a 2nd lands on exactly the params of an
    uninterrupted 2-epoch run (the slot-seeded loader, persistent Adam
    moments in optimState_<e>, the LR a pure function of the epoch)."""
    base = dict(adam_reset_per_epoch=False, LR=LR)
    straight = run(toy_options(toy_tree, expName="straight", **base))
    opt_a = toy_options(toy_tree, expName="resumed", nEpochs=1, **base)
    run(opt_a)
    resumed = run(dataclasses.replace(opt_a, cont=True, nEpochs=2))
    assert straight.step == resumed.step == 4
    want = straight.model.state_dict()
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, want[name]), f"resume diverged at {name}"
    for p, q in zip(straight.model.parameters(), resumed.model.parameters()):
        for k, v in straight.optimizer.rule.state[p].items():
            assert torch.equal(v, resumed.optimizer.rule.state[q][k])


def test_three_stage_hard_to_soft_recipe(toy_tree):
    """Hard pretrain (OBCC, one future-flow decoder) -> `-retrain <ckpt>
    -convert_to_soft 1` surgery -> soft fine-tune (OBGCC + past_flow +
    const_vel + second-order smoothness), README.md:83-103."""
    common = dict(cache=str(toy_tree / "ckpt3"), epochSize=3, LR=LR)
    hard_opt = toy_options(toy_tree, expName="hard", pme_criterion="OBCC", nEpochs=1, **common)
    assert not hard_opt.past_flow
    run(hard_opt)
    hard_ckpt = Path(hard_opt.save) / "model_1.pt"
    assert hard_ckpt.exists()

    soft_opt = toy_options(toy_tree, expName="soft", pme_criterion="OBGCC", past_flow=True,
                           const_vel=1.0, smooth_second_order=True, retrain=str(hard_ckpt),
                           convert_to_soft=True, **common)
    net, _, _ = load_or_convert(soft_opt)
    params = to_flax_params(net)
    past = [k for k in params if k.startswith("past_decoder_")]
    assert past
    for k in past:   # seeded from the matching hard future-flow decoder
        jax.tree_util.tree_map(np.testing.assert_array_equal, params[k],
                               params[k.replace("past_decoder_", "flow_decoder_")])

    state = run(soft_opt)
    assert state.step == 6
    losses = SymbolLogger(Path(soft_opt.save) / "train.log").read()["avg loss (train set)"]
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    outs = state.model(torch.zeros(1, 32, 64, 9))
    assert all(g["flow_past"] is not None for g in outs)
    p = to_flax_params(state.model)
    assert any(not np.array_equal(a, b) for k in past
               for a, b in zip(jax.tree_util.tree_leaves(p[k]), jax.tree_util.tree_leaves(
                   p[k.replace("past_decoder_", "flow_decoder_")])))
    assert isinstance(build_model(soft_opt), PWCNet)


@pytest.fixture(scope="module")
def jax_runs(toy_tree):
    """From one JAX-written model_0.msgpack (`-retrain`), JAX `run()`
    trains epoch 1 with persistent Adam moments, then resumes its own
    pair with `-cont` for epoch 2. The JAX loader on its NumPy path."""
    cache = toy_tree / "cross"
    opt0 = toy_options(toy_tree, JaxOptions, cache=str(cache), expName="start", LR=LR)
    net = PWCNet(pwc_config_from_options(opt0), generator=torch.Generator().manual_seed(7))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    jax_checkpoint.save_checkpoint(opt0.save, jax_create_train_state(tree, opt0), opt0, 0)
    kw = dict(cache=str(cache), retrain=str(Path(opt0.save) / "model_0.msgpack"), LR=LR,
              adam_reset_per_epoch=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resample, "_native", (None,))
        opt_a = toy_options(toy_tree, JaxOptions, expName="jax", nEpochs=1, **kw)
        jax_run(opt_a)
        jax_run(dataclasses.replace(opt_a, cont=True, nEpochs=2))
    return kw, Path(opt_a.save)


def test_run_matches_jax_run(toy_tree, jax_runs, monkeypatch):
    kw, jax_save = jax_runs
    monkeypatch.setenv(TWINS_ENV, "1")   # the port's loader on the NumPy paths too
    opt = toy_options(toy_tree, expName="port", nEpochs=1, **kw)
    run(opt)
    for log in ("train.log", "test.log"):
        got = SymbolLogger(Path(opt.save) / log).read()
        want = SymbolLogger(jax_save / log).read()
        assert list(got) == list(want)
        rows = len(got[next(iter(got))])
        for k in want:
            # the JAX log gained epoch 2 from its resume
            np.testing.assert_allclose(got[k], want[k][:rows], rtol=1e-4, atol=1e-6, err_msg=k)
    got, want = params_of(Path(opt.save) / "model_1.pt"), params_of(jax_save / "model_1.msgpack")
    assert_params_close(got, want, steps=2)


def test_cont_resumes_jax_optimizer_state(toy_tree, jax_runs, monkeypatch):
    kw, jax_save = jax_runs
    monkeypatch.setenv(TWINS_ENV, "1")
    opt = toy_options(toy_tree, expName="port_cont", nEpochs=1, **kw)
    for name in ("model_1.msgpack", "optimState_1.msgpack", "options.json"):
        shutil.copy(jax_save / name, Path(opt.save) / name)
    state = run(dataclasses.replace(opt, cont=True, nEpochs=2))
    assert state.step == 4   # JAX's 2, restored, + 2
    got, want = params_of(Path(opt.save) / "model_2.pt"), params_of(jax_save / "model_2.msgpack")
    assert_params_close(got, want, steps=2)


def assert_params_close(got, want, steps):
    """Within test_train_steps_match_jax's tolerance (rtol 1e-3, atol a
    tenth of LR), but for at most 1e-5 of the elements: where a gradient
    sits within float noise of zero, Adam's normalised step may take
    either sign in the two packages, so such an element may differ by up
    to the 2 LR a step that its update spans (seen: 1 element of 1.6M,
    by 0.15 LR)."""
    total, loose = 0, []
    for name in want:
        d = np.abs(got[name] - want[name])
        assert d.max() <= 2 * LR * steps, name
        loose += [name] * int((d > 1e-3 * np.abs(want[name]) + 0.1 * LR).sum())
        total += d.size
    assert len(loose) <= 1e-5 * total, loose


def _port_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_training_cli_writes_a_run(toy_tree):
    cache = toy_tree / "cli"
    out = _port_cli("back2future_tpu_torch.main", "--platform", "cpu", "--epochSize", "2",
                    "--nEpochs", "1", "--cropHeight", "32", "--cropWidth", "64",
                    "--batchSize", "2", "--dataset", "toy",
                    "--datasets_dir", str(toy_tree / "datasets"), "--data_root", str(toy_tree),
                    "--ground_truth", "1", "--cache", str(cache), "--expName", "v",
                    "--nDonkeys", "0", "--levels", "4", "--pwc_ws", "3",
                    "--compute_dtype", "float32")
    save = cache / "v"
    for name in ("model_1.pt", "optimState_1.pt", "options.json", "train.log", "test.log",
                 "train.svg", "test.svg", "log"):
        assert (save / name).exists(), name
    assert "Epoch: [1][TRAINING SUMMARY]" in out and '"expName": "v"' in out
    assert "Epoch: [1][TESTING SUMMARY]" in (save / "log").read_text()


def test_eval_cli_matches_tools_eval(toy_tree, jax_runs, monkeypatch, capsys):
    _, jax_save = jax_runs
    monkeypatch.setenv(TWINS_ENV, "1")   # the CLI subprocess inherits it
    args = ["--checkpoint", str(jax_save), "--dataset", "toy",
            "--datasets_dir", str(toy_tree / "datasets"), "--data_root", str(toy_tree),
            "--batchSize", "2", "--cropHeight", "32", "--cropWidth", "64", "--split", "all",
            "--limit", "3", "--cpu"]
    dumps = {pkg: toy_tree / f"dump_{pkg}" for pkg in ("jax", "port")}
    got = json.loads(_port_cli("back2future_tpu_torch.eval", *args, "--dump_dir",
                               str(dumps["port"])).strip().splitlines()[-1])
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    monkeypatch.setattr(jax_resample, "_native", (None,))
    spec = importlib.util.spec_from_file_location("_tools_eval", ROOT / "tools" / "eval.py")
    tools_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools_eval)
    capsys.readouterr()
    tools_eval.main(args + ["--dump_dir", str(dumps["jax"])])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) and got["n_samples"] == want["n_samples"] == 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    from back2future_tpu.io.flow_io import load_flo, load_kitti_png

    names = sorted(f.name for f in dumps["jax"].iterdir())
    assert names == sorted(f.name for f in dumps["port"].iterdir())
    assert names == [f"{r:06d}_10.{ext}" for r in range(3) for ext in ("flo", "png")]
    for name in names:
        # the 16-bit PNG holds flow in steps of 1/64 px: a value within
        # float noise of a rounding boundary may land one step apart
        flo = name.endswith(".flo")
        load = load_flo if flo else (lambda p: load_kitti_png(p)[0])
        np.testing.assert_allclose(load(dumps["port"] / name), load(dumps["jax"] / name),
                                   rtol=1e-4, atol=1e-3 if flo else 1 / 64 + 1e-6, err_msg=name)
