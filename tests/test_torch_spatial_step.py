"""CPU tests of the port's train step on a data x spatial mesh of ranks
(parallel/spatial.py, parallel/distributed.py `init_mesh_groups`)
against the JAX package.

One hard (OBCC, sizeAverage 0) and one soft (OBGCC, past flow, const_vel,
second-order smoothness, sizeAverage 1) step, and one each of the
supervised L2 (`optimize="epe"`, sizeAverage 1: the mask count summed
over the world), of OSSIML1 (sizeAverage 1: the min and max over the
world) and of the hard step under `-remat 1` (whose backward makes the
forward's collectives again), on 2 x 2 gloo ranks
(rank = d*2 + s; the two ranks of data slot d share its half of the
global batch and compute their row bands of it), at 32x64, levels 4 and
win 9 (cost
volume halo 4: levels 1-3 in row bands, level 4 whole), with ground
truth whose mask counts differ 90% / 20% between the two data slots:
against one jitted JAX `value_and_grad` on the global batch, the loss,
every component and metric at rtol 1e-4 (atol 1e-7), and every parameter
gradient within 1e-3 of its leaf's max|g|, as
tests/test_torch_parallel.py holds the data-parallel step; the four
ranks hold the same logs and gradients bit for bit (DDP's sum). The loss
runs on the row bands: the net gathers whole only features (no tensor
of 3 channels or fewer: no flow, occlusion or image), and its image
warps warp the whole image pyramid by a band's flow through the row
window.
"""

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
from back2future_tpu_torch.models import to_flax_params
from back2future_tpu_torch.models.factory import model_and_config
from back2future_tpu_torch.parallel import launch

torch.set_num_threads(1)

B, H, W = 4, 32, 64
SEED = 5
CASES = {
    "hard": dict(),
    "soft": dict(pme_criterion="OBGCC", past_flow=True, const_vel=1.0,
                 smooth_second_order=True, sizeAverage=True),
    "epe_mean": dict(optimize="epe", epe=1.0, sizeAverage=True),
    "remat": dict(remat=1),
    "ossiml1": dict(pme_criterion="OSSIML1", sizeAverage=True),
}


def case_options(cls, name):
    base = dict(levels=4, pwc_ws=9, frames=3, batchSize=B, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32", LR=1e-3, ground_truth=True)
    base.update(CASES[name])
    return cls(**base).derive()


def case_batch(name):
    rng = np.random.default_rng(10 + len(name))
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


def leaf(tree, name):
    *mods, last = name.split(".")
    node = functools.reduce(lambda d, m: d[m], mods + ["conv"], tree)
    return node["kernel"].transpose(3, 2, 0, 1) if last == "weight" else node["bias"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_spatial_step_matches_jax_global_batch(rank_results, name):
    want_logs, want_grads = jax_global_step(name)
    got = rank_results[0][name]
    assert got["plan"] == (True, True, True, False)
    for rank, r in enumerate(rank_results):
        assert r[name]["gathered"] and min(r[name]["gathered"]) > 3
        image_warps = [w for w in r[name]["warps"] if w[2] == 3]
        runs = 2 if CASES[name].get("remat") else 1   # the recompute warps again
        assert len(image_warps) == (0 if CASES[name].get("optimize") == "epe" else 4 * runs)
        for rows, flow_rows, _, y0 in image_warps:   # levels 1 and 2: bands of 2
            assert (flow_rows * 2, y0) == (rows, rank % 2 * flow_rows)
    assert set(got["logs"]) == set(want_logs)
    for k, v in want_logs.items():
        np.testing.assert_allclose(got["logs"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    n_leaves = len(jax.tree_util.tree_leaves(want_grads))
    assert len(got["grads"]) == n_leaves
    for pname, g in got["grads"].items():
        want = leaf(want_grads, pname)
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-3 * np.abs(want).max(),
                                   err_msg=pname)
    for other in rank_results[1:]:
        assert other[name]["logs"] == got["logs"]
        for pname, g in got["grads"].items():
            np.testing.assert_array_equal(g, other[name]["grads"][pname], err_msg=pname)
