"""CPU tests of the port's multi-rank `run()` (train/loop.py) against the
JAX package's, on the toy tree of tests/test_multiprocess.py (8 frames
of 40x72, 5 samples: 2 train / 3 val, so that a 2-rank validation drops
the odd sample).

* `run()` with `--platform cpu -nGPU 2` (rank 0 in this process, rank 1
  spawned) from one JAX-written `model_0.msgpack` (`-retrain`) against
  JAX's single-host `run()` from the same file: the train.log rows
  within rtol 1e-4 (the global batch is the same, the loader's slots
  are seeded; only sum order differs); test.log logs each epoch, the
  2-rank run from its one full global batch ("samples 2/3 (1
  skipped)", as JAX's multi-host run); rank 1 keeps `.host1` side logs;
  the checkpoints hold the bare net's keys and `init(path)` serves them;
  `-cont` resumes on both ranks.
* The training CLI as two processes that join a cluster from the
  B2F_COORDINATOR / B2F_NUM_PROCESSES / B2F_PROCESS_ID spec with no new
  flag; then a `-cont` resume where only rank 0 sees the checkpoints
  raises the cross-host divergence on both ranks.

Spawned ranks and CLI processes are killed past their deadline, and the
group's collectives time out after B2F_DIST_TIMEOUT = 120 s.
"""

import dataclasses
import os
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
from back2future_tpu.data import resample as jax_resample
from back2future_tpu.train import checkpoint as jax_checkpoint
from back2future_tpu.train.loop import run as jax_run
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu_torch import api
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.data.resample import TWINS_ENV
from back2future_tpu_torch.parallel.launch import free_port
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.train.loop import run
from back2future_tpu_torch.utils import SymbolLogger
from test_multiprocess import _toy_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3
CLI_TIMEOUT = 300


def toy_options(root, cls=Options, **kw):
    base = dict(dataset="toy", datasets_dir=str(root / "datasets"), data_root=str(root),
                cache=str(root / "ckpt"), optimize="pme", frames=3, levels=4, pwc_ws=3,
                compute_dtype="float32", cropHeight=32, cropWidth=64, batchSize=2,
                epochSize=2, nEpochs=2, nDonkeys=0, epochStore=1, nGPU=1, platform="cpu",
                LR=LR)
    base.update(kw)
    return cls(**base).derive(make_dirs=True)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy tree, a JAX-written model_0.msgpack of a seeded net, and
    JAX's single-host run() of 2 epochs from it."""
    root = tmp_path_factory.mktemp("toymp")
    _toy_tree(root)
    opt0 = toy_options(root, JaxOptions, expName="start")
    net = PWCNet(pwc_config_from_options(opt0), generator=torch.Generator().manual_seed(7))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    jax_checkpoint.save_checkpoint(opt0.save, jax_create_train_state(tree, opt0), opt0, 0)
    retrain = str(Path(opt0.save) / "model_0.msgpack")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resample, "_native", (None,))
        jopt = toy_options(root, JaxOptions, expName="jax", retrain=retrain)
        jax_run(jopt)
    return root, retrain, Path(jopt.save)


def test_two_rank_run_matches_jax_single_host(toy, capfd, monkeypatch):
    root, retrain, jax_save = toy
    monkeypatch.setenv("B2F_DIST_TIMEOUT", "120")
    monkeypatch.setenv(TWINS_ENV, "1")   # both ranks' loaders on the NumPy paths, as JAX's
    opt = toy_options(root, expName="ranks", retrain=retrain, nGPU=2)
    state = run(opt)
    assert not torch.distributed.is_initialized()   # run() tore its group down
    assert state.step == 4
    out = capfd.readouterr().out
    assert out.count("samples 2/3 (1 skipped)") == 2
    save = Path(opt.save)
    got, want = (SymbolLogger(save / "train.log").read(),
                 SymbolLogger(jax_save / "train.log").read())
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert SymbolLogger(save / "train.log.host1").read() == got
    assert len(SymbolLogger(save / "test.log").read()["avg loss (test set)"]) == 2
    assert len(SymbolLogger(save / "test.log.host1").read()["avg loss (test set)"]) == 2
    keys = torch.load(save / "model_2.pt", weights_only=True)
    assert set(keys) == set(dict(state.model.named_parameters()))
    est = api.init(str(save), device="cpu")
    flow, _, _ = est(*(np.full((64, 128, 3), v, np.float32) for v in (0.2, 0.4, 0.6)))
    assert flow.shape == (64, 128, 2) and np.isfinite(flow).all()

    # -cont: both ranks load model_2 (one fingerprint) and train epoch 3
    state = run(dataclasses.replace(opt, cont=True, nEpochs=3))
    assert state.step == 2 and (save / "model_3.pt").exists()
    for name in ("train.log", "train.log.host1"):
        assert len(SymbolLogger(save / name).read()["avg loss (train set)"]) == 3


def cli_cluster(args_of_rank, timeout=CLI_TIMEOUT):
    """Two training CLI processes joined by the B2F_* spec; their exit
    codes and outputs."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "B2F_COORDINATOR": f"127.0.0.1:{port}",
           "B2F_NUM_PROCESSES": "2", "B2F_DIST_TIMEOUT": "120"}
    procs = [subprocess.Popen([sys.executable, "-m", "back2future_tpu_torch.main",
                               *args_of_rank(i)],
                              env={**env, "B2F_PROCESS_ID": str(i)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"CLI ranks hung; partial output: {outs}")
    return [p.returncode for p in procs], outs


def test_cli_joins_cluster_from_env_spec_and_refuses_divergent_resume(toy):
    root, retrain, _ = toy

    def args(cache, **kw):
        opts = dict(dataset="toy", datasets_dir=root / "datasets", data_root=root, cache=cache,
                    expName="cli", optimize="pme", frames=3, levels=4, pwc_ws=3,
                    compute_dtype="float32", cropHeight=32, cropWidth=64, batchSize=2,
                    epochSize=2, nEpochs=1, nDonkeys=0, epochStore=1, platform="cpu",
                    retrain=retrain)
        opts.update(kw)
        return [a for k, v in opts.items() for a in (f"--{k}", str(v))]

    shared = root / "cli_shared"
    codes, outs = cli_cluster(lambda i: args(shared))
    assert codes == [0, 0], outs
    save = shared / "cli"
    for name in ("model_1.pt", "train.log", "train.log.host1", "log", "log.host1"):
        assert (save / name).exists(), name
    assert "Epoch: [1][TRAINING SUMMARY]" in outs[0]
    assert "TRAINING SUMMARY" not in outs[1]

    # rank 1 on storage that does not hold rank 0's checkpoints
    alone = root / "cli_alone"
    codes, outs = cli_cluster(lambda i: args(shared if i == 0 else alone, cont=1, nEpochs=2))
    assert codes[0] != 0 and codes[1] != 0
    for out in outs:
        assert "cross-host divergence at 'resume_state'" in out, out[-3000:]
