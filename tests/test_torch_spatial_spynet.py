"""CPU tests of the port's SPyNet on a data x spatial mesh of ranks
(models/spynet.py, parallel/spatial.py) against the JAX package.

* One `pme` train step of SPyNet (frames 3, levels 4, 32x64, B = 4, with
  ground truth) on 2 x 2 gloo ranks (rank = d*2 + s: the two ranks of
  data slot d share its half of the global batch and compute their row
  bands of it; every conv is 7x7, so the plan keeps resolution levels
  1-3 in bands of 16, 8 and 4 rows and level 4 (SPyNet's coarsest) whole)
  against one jitted JAX `value_and_grad` on the global batch. Two
  cases: OBCC with sizeAverage 0, and `occ_input 1`, `residual 1` with
  sizeAverage 1. Held at tests/test_torch_spynet.py's one-step
  tolerances: the loss, every component and metric at rtol 1e-4 (atol
  1e-7), every parameter gradient at rtol 1e-3 with atol 1e-5 * max|g|
  per leaf; the four ranks hold the same logs and gradients bit for bit.
  The gradients are held so against the port's own unsharded step on
  the global batch (one process) everywhere, and against JAX's wherever
  that unsharded step is within half the tolerance of JAX's: at this
  size SPyNet's gradient of its finest trunk moves past the tolerance
  under input changes of a few ulps (the two packages' convolutions
  round differently; 2 and 8 elements of `trunk_4.c0.weight` miss JAX's
  in the unsharded port at these seeds, ROADMAP.md queue 3), so where
  the unsharded port uses up half the tolerance the bands, whose forward
  is the unsharded port's bit for bit and whose gradients differ from it
  in summation order, are held to the unsharded port alone; such
  elements are under 1% of a leaf.
  The loss runs on the bands: the net gathers whole only the warped
  frames its output warps read (2 a banded level past the coarsest), and
  every warp at a banded level takes a row window of the whole level.
* `run()` with `netType spynet` on a (1, 2) mesh of gloo ranks against
  one rank's `run()` on the toy tree of tests/test_multiprocess.py (2
  epochs of 2 steps, SGD with momentum as tests/test_torch_spynet.py's
  steps: Adam's sign at near-zero gradients would amplify the summation
  order of the bands' gradients): train.log and test.log at rtol 2e-3
  (atol 1e-5);
  then a `-cont` resume on the mesh, whose ranks hold one fingerprint,
  trains epoch 3 from the saved bare net.

One worker: ~60 s.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp

import torch_ranks
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.models.factory import model_and_config as jax_model_and_config
from back2future_tpu.train.metrics import full_res_metrics as jax_full_res_metrics
from back2future_tpu.train.multiscale import multiscale_loss as jax_multiscale_loss
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models import to_flax_params
from back2future_tpu_torch.models.factory import model_and_config
from back2future_tpu_torch.parallel import launch
from back2future_tpu_torch.train.loop import run
from back2future_tpu_torch.train.multiscale import multiscale_loss
from back2future_tpu_torch.utils import SymbolLogger
from test_multiprocess import _toy_tree

torch.set_num_threads(1)

B, H, W = 4, 32, 64
SEED = 6
CASES = {
    "obcc_sum": dict(),
    "occ_residual_mean": dict(occ_input=1, residual=1, sizeAverage=True),
}


def case_options(cls, name):
    base = dict(netType="spynet", levels=4, frames=3, batchSize=B, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32", LR=1e-3, ground_truth=True)
    base.update(CASES[name])
    return cls(**base).derive()


def case_batch(name):
    rng = np.random.default_rng(30 + len(name))
    shape = (B, H, W)
    valid = np.where(np.arange(B)[:, None, None] < B // 2, 0.1, 0.8)
    return {"images": rng.standard_normal(shape + (9,)).astype(np.float32),
            "flow_gt": (rng.standard_normal(shape + (2,)) * 0.2).astype(np.float32),
            "occ_gt": rng.choice(np.float32([0.0, 0.5, 1.0]), size=shape + (2,),
                                 p=[0.1, 0.8, 0.1]),
            "mask": (rng.random(shape) > valid).astype(np.float32)}


@pytest.fixture(scope="module")
def rank_results():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("B2F_DIST_TIMEOUT", "120")
        cases = {n: case_options(Options, n).__dict__ for n in CASES}
        batches = {n: case_batch(n) for n in CASES}
        return launch.run_ranks(torch_ranks.spatial_step, 4, (cases, batches, SEED, 2),
                                rank0_here=False, timeout=300)


def jax_global_step(name):
    opt, jopt = case_options(Options, name), case_options(JaxOptions, name)
    net = model_and_config(opt, generator=torch.Generator().manual_seed(SEED))[0]
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    batch = {k: jnp.asarray(v) for k, v in case_batch(name).items()}
    model, crits = jax_model_and_config(jopt)[0], jax_build_criterions(jopt)

    def loss_fn(params):
        outputs = model.apply({"params": params}, batch["images"])
        loss, comps = jax_multiscale_loss(outputs, batch, jopt, crits)
        g0 = outputs[0]
        metrics = jax_full_res_metrics(g0["flow"], g0.get("occ"), batch, jopt.flownet_factor,
                                       jopt.sizeAverage)
        return loss, {"loss": loss, **comps, **metrics}

    (_, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    return {k: float(v) for k, v in logs.items()}, jax.tree_util.tree_map(np.asarray, grads)


def port_global_grads(name):
    """The port's unsharded step's parameter gradients on the global batch."""
    opt = case_options(Options, name)
    net = model_and_config(opt, generator=torch.Generator().manual_seed(SEED))[0]
    batch = {k: torch.from_numpy(v) for k, v in case_batch(name).items()}
    loss, _ = multiscale_loss(net(batch["images"]), batch, opt, build_criterions(opt))
    loss.backward()
    return {n: p.grad.numpy() for n, p in net.named_parameters()}


def leaf(tree, name):
    *mods, last = name.split(".")
    node = functools.reduce(lambda d, m: d[m], mods + ["conv"], tree)
    return node["kernel"].transpose(3, 2, 0, 1) if last == "weight" else node["bias"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_spatial_spynet_step_matches_jax_global_batch(rank_results, name):
    want_logs, want_grads = jax_global_step(name)
    got = rank_results[0][name]
    assert got["plan"] == (True, True, True, False)
    assert set(got["logs"]) == set(want_logs)
    for k, v in want_logs.items():
        np.testing.assert_allclose(got["logs"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert len(got["grads"]) == len(jax.tree_util.tree_leaves(want_grads))
    port = port_global_grads(name)
    for pname, g in got["grads"].items():
        want = leaf(want_grads, pname)
        tol = dict(rtol=1e-3, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(g, port[pname], **tol, err_msg=pname)
        meets = np.isclose(port[pname], want, rtol=tol["rtol"] / 2, atol=tol["atol"] / 2)
        assert meets.mean() > 0.99, pname
        np.testing.assert_allclose(g[meets], want[meets], **tol, err_msg=pname)
    for rank, r in enumerate(rank_results):
        assert r[name]["logs"] == got["logs"]
        for pname, g in got["grads"].items():
            np.testing.assert_array_equal(g, r[name]["grads"][pname], err_msg=pname)
        # the output warps' sources at resolution levels 3, 2, 1, two frames each
        assert r[name]["gathered"] == [3] * 6
        banded = [w for w in r[name]["warps"] if w[0] != w[1]]
        assert len(banded) == 4 * 3 and len(r[name]["warps"]) == 4 * 3 + 2
        for rows, flow_rows, _, y0 in banded:
            assert (flow_rows * 2, y0) == (rows, rank % 2 * flow_rows)


def run_options(root, **kw):
    base = dict(dataset="toy", datasets_dir=str(root / "datasets"), data_root=str(root),
                cache=str(root / "ckpt"), optimize="pme", netType="spynet", frames=3, levels=4,
                compute_dtype="float32", cropHeight=32, cropWidth=64, batchSize=2,
                epochSize=2, nEpochs=2, nDonkeys=0, epochStore=2, platform="cpu", LR=1e-3,
                optimizer="sgd", momentum=0.9)
    base.update(kw)
    return Options(**base).derive(make_dirs=True)


def test_spatial_spynet_run_matches_one_rank_run(tmp_path, monkeypatch):
    monkeypatch.setenv("B2F_DIST_TIMEOUT", "120")
    _toy_tree(tmp_path)
    one = run_options(tmp_path, expName="one")
    spatial = run_options(tmp_path, expName="spatial", nGPU=2, mesh_shape=(1, 2),
                          mesh_axes=("data", "spatial"))
    run(one)
    state = run(spatial)
    assert not torch.distributed.is_initialized() and state.step == 4
    assert state.model.spatial_comm is not None
    save = tmp_path / "ckpt" / "spatial"
    for log in ("train.log", "test.log"):
        want = SymbolLogger(tmp_path / "ckpt" / "one" / log).read()
        got = SymbolLogger(save / log).read()
        assert list(got) == list(want) and len(got[next(iter(got))]) == 2
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-5, err_msg=k)
        assert (save / f"{log}.host1").exists()
    assert (save / "model_2.pt").exists()
    state = run(dataclasses.replace(spatial, cont=True, nEpochs=3, epochStore=1))
    assert state.step == 2 and (save / "model_3.pt").exists()
    for name in ("train.log", "train.log.host1"):
        assert len(SymbolLogger(save / name).read()["avg loss (train set)"]) == 3
