"""CPU tests of the port's data parallelism (back2future_tpu_torch.parallel
and the DDP train step) against the JAX package.

* `shard_batch`, `host_local_batch_size`, `initialize_multihost`'s
  cluster-spec errors and `assert_same_across_hosts` against the JAX
  package's behaviour and messages, on one process; what a spatial mesh
  axis takes (either net) and refuses (a shape that does not hold the
  ranks).
* The resume fingerprint: stable, sensitive to the epoch and to a value.
* A 2-rank gloo group (ranks spawned by `parallel.launch.run_ranks`):
  the all-reduce, sync, agreeing values passing and diverging ones
  raising on every rank, rank 0 included.
* One train step under 2 gloo ranks, each on its half of the global
  batch, against one jitted JAX `value_and_grad` on the whole batch:
  the loss, every component and metric, and every parameter gradient,
  for the hard recipe at sizeAverage 0 and 1, the soft recipe, frames 5,
  SPyNet, `optimize="epe"` with sizeAverage 1, the same with `past_flow`
  (whose past decoders no loss reaches: their gradients are None, JAX's
  zero, and a second step, which DDP refuses when unused parameters are
  not handled, matches JAX's second step), gradient clipping with
  SGD at LR 1 (the update against optax's chain too, within rtol 1e-3
  and 4 ulps of the largest parameter) and
  `-remat 1`. Every case has ground truth, and the two ranks' halves
  hold masks of very different valid counts (90% against 20%), so the
  L2 normaliser and every ratio metric must be reduced over the global
  batch. Tolerances as tests/test_torch_multiscale_options.py: logs rtol
  1e-4 (atol 1e-7), gradients rtol 1e-3 with atol 1e-5 * max|g| per leaf
  (conv and sum order differ); both ranks hold the same logs and
  gradients bit for bit.
* Mesh serving: `init(..., mesh=make_mesh(["cpu", "cpu"]))` at n = 3
  (padded to 4, trimmed) against the JAX package's FlowEstimator on a
  2-device CPU mesh, the mesh estimator's refusals, and a (1, 2) data x
  spatial mesh with `spatial=True` against JAX's.
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
import optax

import torch_ranks
from back2future_tpu import api as jax_api
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.models.factory import model_and_config as jax_model_and_config
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.parallel import distributed as jax_distributed
from back2future_tpu.parallel import mesh as jax_mesh
from back2future_tpu.train.metrics import full_res_metrics as jax_full_res_metrics
from back2future_tpu.train.multiscale import multiscale_loss as jax_multiscale_loss
from back2future_tpu.train.optim import make_optimizer as jax_make_optimizer
from back2future_tpu_torch import api
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.models.factory import model_and_config
from back2future_tpu_torch.parallel import distributed, launch, mesh
from back2future_tpu_torch.train.loop import _state_fingerprint

torch.set_num_threads(1)

B, H, W = 4, 32, 64
SEED = 3
TIMEOUT = 300   # seconds a spawned rank may take before it is killed


# ------------------------------------------------------- one process, vs JAX

def test_shard_batch_matches_jax():
    x = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    jmesh = jax_mesh.make_mesh(jax.devices()[:2])
    want = jax_mesh.shard_batch({"x": x}, jmesh)["x"]
    pmesh = mesh.make_mesh(["cpu", "cpu"])
    assert pmesh.shape == dict(jmesh.shape) == {"data": 2}
    got = mesh.shard_batch({"x": torch.from_numpy(x)}, pmesh)
    for shard, part in zip(sorted(want.addressable_shards, key=lambda s: s.index[0].start), got):
        np.testing.assert_array_equal(part["x"].numpy(), np.asarray(shard.data))
    odd = x[:3]
    with pytest.raises(ValueError) as jerr:
        jax_mesh.shard_batch({"x": odd}, jmesh)
    with pytest.raises(ValueError) as perr:
        mesh.shard_batch({"x": torch.from_numpy(odd)}, pmesh)
    assert str(perr.value) == str(jerr.value)
    # allow_partial replicates: every slot holds the whole batch, as JAX's
    # replicated sharding holds it on every device
    whole = mesh.shard_batch(torch.from_numpy(odd), pmesh, allow_partial=True)
    jwhole = jax_mesh.shard_batch({"x": odd}, jmesh, allow_partial=True)["x"]
    for part, shard in zip(whole, jwhole.addressable_shards):
        np.testing.assert_array_equal(part.numpy(), np.asarray(shard.data))


def test_spatial_axis_is_not_ported():
    """What a spatial axis takes and refuses: either net, SPyNet too; a
    mesh shape that does not hold the ranks raises."""
    from back2future_tpu_torch.train.loop import _check_mesh

    spatial = dict(mesh_shape=(1, 2), mesh_axes=("data", "spatial"), dataset="synthetic")
    assert _check_mesh(Options(netType="spynet", **spatial).derive(), 2) == 2
    pwc = Options(**spatial).derive()
    with pytest.raises(ValueError, match="does not hold the 4 "):
        _check_mesh(pwc, 4)
    assert _check_mesh(pwc, 2) == 2
    assert mesh.make_mesh(["cpu", "cpu"], shape=(1, 2),
                          axes=("data", "spatial")).shape == {"data": 1, "spatial": 2}


def test_single_process_helpers_match_jax():
    assert not torch.distributed.is_initialized()
    assert distributed.host_local_batch_size(6) == jax_distributed.host_local_batch_size(6) == 6
    distributed.assert_same_across_hosts("x", "anything")   # no-op on one process
    jax_distributed.assert_same_across_hosts("x", "anything")
    distributed.sync_hosts()
    t = torch.ones(3)
    assert distributed.all_reduce_sum(t) is t and distributed.loss_share(True) == 1.0


@pytest.mark.parametrize("missing", ["B2F_NUM_PROCESSES", "B2F_PROCESS_ID"])
def test_incomplete_cluster_spec_raises_as_jax(monkeypatch, missing):
    spec = {"B2F_COORDINATOR": "127.0.0.1:1", "B2F_NUM_PROCESSES": "2", "B2F_PROCESS_ID": "0"}
    for k, v in spec.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv(missing)
    with pytest.raises(ValueError) as jerr:
        jax_distributed.initialize_multihost()
    with pytest.raises(ValueError) as perr:
        distributed.initialize_multihost()
    assert str(perr.value) == str(jerr.value) and missing in str(perr.value)
    assert not torch.distributed.is_initialized()


def test_no_cluster_spec_stays_single_process(monkeypatch):
    for k in ("B2F_COORDINATOR", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize_multihost()
    assert not torch.distributed.is_initialized()
    assert distributed.process_count() == 1 and distributed.process_index() == 0


def test_fingerprint_is_stable_and_sensitive():
    opt = Options(levels=4, pwc_ws=3, dataset="synthetic").derive()

    def net():
        return PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(1))

    a, b = net(), net()
    assert _state_fingerprint(a, 1) == _state_fingerprint(b, 1)
    assert _state_fingerprint(a, 1) != _state_fingerprint(a, 2)
    with torch.no_grad():
        next(b.parameters()).view(-1)[0] += 1e-7
    assert _state_fingerprint(a, 1) != _state_fingerprint(b, 1)


# ------------------------------------------------------------ a 2-rank group

def test_two_rank_group_checks(monkeypatch):
    monkeypatch.setenv("B2F_DIST_TIMEOUT", "120")
    results = launch.run_ranks(torch_ranks.cluster_checks, 2, rank0_here=False,
                               timeout=TIMEOUT)
    hint = ("For checkpoint resume this usually means opt.save is not on storage shared by "
            "all hosts — every host must see the same checkpoints.")
    want = (f"cross-host divergence at 'diverge': host 1 has 'host-1-value' but host 0 has "
            f"'host-0-value'. {hint}")
    for rank, r in enumerate(results):
        assert (r["rank"], r["world"], r["sum"], r["batch4"]) == (rank, 2, 3.0, 2)
        assert r["diverge"] == want          # rank 0 raises too, naming host 1
        assert r["batch3"] == "global batch 3 not divisible by 2 hosts"


def test_a_failing_rank_fails_the_caller(monkeypatch):
    monkeypatch.setenv("B2F_DIST_TIMEOUT", "120")
    with pytest.raises(launch.RankError, match=r"rank 1 of 2 failed:(.|\n)*not divisible"):
        launch.run_ranks(_raise_on_rank_1, 2, timeout=TIMEOUT)
    assert not torch.distributed.is_initialized()


def _raise_on_rank_1(rank, world):
    if rank == 1:
        distributed.host_local_batch_size(3)
    return rank


# ------------------------------------------- one step, 2 ranks vs JAX global

GT = dict(ground_truth=True)
CASES = {
    "hard_sum": dict(),
    "hard_mean": dict(sizeAverage=True),
    "soft": dict(pme_criterion="OBGCC", past_flow=True, const_vel=1.0),
    "frames5": dict(frames=5),
    "spynet": dict(netType="spynet"),
    "epe_mean": dict(optimize="epe", epe=1.0, sizeAverage=True),
    # SGD: after Adam's first step the nets would differ by 2 LR wherever
    # a gradient is within float noise of zero, and the second step's
    # gradients with them
    "epe_past_flow": dict(optimize="epe", epe=1.0, sizeAverage=True, past_flow=True,
                          optimizer="sgd"),
    "grad_clip_sgd": dict(grad_clip=0.5, optimizer="sgd", momentum=0.9, LR=1.0),
    "remat": dict(remat=1),
}
TWO_STEPS = ("epe_past_flow",)


def case_options(cls, name):
    base = dict(levels=4, pwc_ws=3, frames=3, batchSize=B, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32", LR=1e-3, **GT)
    base.update(CASES[name])
    return cls(**base).derive()


def case_batch(name, frames):
    """The global batch: rank 0's half with 90% valid mask pixels, rank
    1's with 20%."""
    rng = np.random.default_rng(len(name))
    shape = (B, H, W)
    valid = np.where(np.arange(B)[:, None, None] < B // 2, 0.1, 0.8)
    return {"images": rng.standard_normal(shape + (3 * frames,)).astype(np.float32),
            "flow_gt": (rng.standard_normal(shape + (2,)) * 0.2).astype(np.float32),
            "occ_gt": rng.choice(np.float32([0.0, 0.5, 1.0]), size=shape + (2,),
                                 p=[0.1, 0.8, 0.1]),
            "mask": (rng.random(shape) > valid).astype(np.float32)}


@pytest.fixture(scope="module")
def rank_results():
    """Every case's step on 2 gloo ranks, in one group."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("B2F_DIST_TIMEOUT", "120")
        cases = {n: dataclasses.asdict(case_options(Options, n)) for n in CASES}
        batches = {n: case_batch(n, case_options(Options, n).frames) for n in CASES}
        return launch.run_ranks(torch_ranks.one_step, 2, (cases, batches, SEED, TWO_STEPS),
                                rank0_here=False, timeout=TIMEOUT)


def jax_global_step(name):
    """JAX's loss, components and metrics, parameter gradients and (with
    its optax chain) parameters after one step, on the global batch, the
    parameters before it, and the jitted value_and_grad."""
    opt = case_options(Options, name)
    jopt = case_options(JaxOptions, name)
    net = model_and_config(opt, generator=torch.Generator().manual_seed(SEED))[0]
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    batch = {k: jnp.asarray(v) for k, v in case_batch(name, opt.frames).items()}
    model, crits = jax_model_and_config(jopt)[0], jax_build_criterions(jopt)

    def loss_fn(params):
        outputs = model.apply({"params": params}, batch["images"])
        loss, comps = jax_multiscale_loss(outputs, batch, jopt, crits)
        g0 = outputs[0]
        occ = g0.get("occ") if (jopt.frames > 2 and not jopt.no_occ) else None
        metrics = jax_full_res_metrics(g0["flow"], occ, batch, jopt.flownet_factor,
                                       jopt.sizeAverage)
        return loss, {"loss": loss, **comps, **metrics}

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, logs), grads = value_and_grad(tree)
    tx = jax_make_optimizer(jopt, epoch=1)
    updates, _ = tx.update(grads, tx.init(tree), tree)
    after = optax.apply_updates(tree, updates)
    return {k: float(v) for k, v in logs.items()}, numpy_tree(grads), after, tree, value_and_grad


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_step_matches(got, want_logs, want_grads, other):
    """One step's logs and gradients on rank 0 (`got`) against JAX's,
    and bit for bit against rank 1's (`other`). Gradients that the port
    leaves None are JAX's zeros; the names of those are returned."""
    assert set(got["logs"]) == set(want_logs)
    for k, v in want_logs.items():
        np.testing.assert_allclose(got["logs"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert got["logs"] == other["logs"]
    assert set(got["grads"]) == set(other["grads"])
    for pname, g in got["grads"].items():
        want = leaf(want_grads, pname)
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-5 * np.abs(want).max(),
                                   err_msg=pname)
        np.testing.assert_array_equal(g, other["grads"][pname], err_msg=pname)
    return {pname for pname, _ in named_leaves(want_grads) if pname not in got["grads"]}


def named_leaves(tree):
    """(port parameter name, leaf) of a flax params tree."""
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        *mods, conv, kind = [p.key for p in path]
        assert conv == "conv"
        yield ".".join(mods + ["weight" if kind == "kernel" else "bias"]), x


def leaf(tree, name):
    *mods, last = name.split(".")
    node = functools.reduce(lambda d, m: d[m], mods + ["conv"], tree)
    return node["kernel"].transpose(3, 2, 0, 1) if last == "weight" else node["bias"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_rank_step_matches_jax_global_batch(rank_results, name):
    want_logs, want_grads, want_after, tree, value_and_grad = jax_global_step(name)
    r0, r1 = rank_results[0][name], rank_results[1][name]
    assert set(r0["params"]) == {pname for pname, _ in named_leaves(want_grads)}
    unused = assert_step_matches(r0, want_logs, want_grads, r1)
    for pname in unused:
        assert not np.any(leaf(want_grads, pname)), pname
    if name == "epe_past_flow":
        assert unused and all(p.startswith("past_decoder_") for p in unused)
        (_, logs), grads = value_and_grad(want_after)
        second = assert_step_matches(r0["second"], {k: float(v) for k, v in logs.items()},
                                     numpy_tree(grads), r1["second"])
        assert second == unused
    else:
        assert not unused
    want_after = numpy_tree(want_after)
    if name == "grad_clip_sgd":
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in jax.tree_util.tree_leaves(want_grads)))
        assert norm > CASES[name]["grad_clip"]   # the clip acts on the global gradient
        for pname, p in r0["params"].items():
            want, before = leaf(want_after, pname), leaf(tree, pname)
            # the update, within rtol 1e-3 and 4 ulps of the largest
            # parameter (the rounding of the differences themselves)
            before = np.asarray(before)
            np.testing.assert_allclose(p - before, want - before, rtol=1e-3,
                                       atol=4 * np.spacing(np.abs(before).max()), err_msg=pname)
    if name == "epe_mean":
        assert want_logs["sup_flow"] > 0


# -------------------------------------------------------------- mesh serving

def serving_case():
    opt = Options(levels=4, pwc_ws=3, dataset="synthetic", compute_dtype="float32").derive()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(4))
    jcfg = jax_pwc_config(JaxOptions(levels=4, pwc_ws=3, dataset="synthetic",
                                     compute_dtype="float32").derive())
    rng = np.random.default_rng(12)
    frames = [rng.random((3, 70, 140, 3)).astype(np.float32) for _ in range(3)]
    return net, jcfg, frames


def test_mesh_serving_matches_jax_mesh():
    net, jcfg, frames = serving_case()
    tree = to_flax_params(net)
    jest = jax_api.init((jax.tree_util.tree_map(jnp.asarray, tree), jcfg),
                        mesh=jax_mesh.make_mesh(jax.devices()[:2]))
    est = api.init((tree, net.cfg), device="cpu", mesh=mesh.make_mesh(["cpu", "cpu"]))
    assert len(est.replicas) == 2 and est._padded_batch(3) == jest._padded_batch(3) == 4
    got, want = est.compute_flow_batch(*frames), jest.compute_flow_batch(*frames)
    single = api.init((tree, net.cfg), device="cpu").compute_flow_batch(*frames)
    for g, w, s in zip(got, want, single):
        assert g.shape == w.shape and g.shape[0] == 3
        if g.dtype == bool:
            assert (g != w).mean() <= 1e-3 and (g != s).mean() <= 1e-3
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
            np.testing.assert_allclose(g, s, rtol=1e-5, atol=1e-5 * np.abs(s).max())


def test_mesh_estimator_refusals_match_jax(tmp_path):
    net, jcfg, frames = serving_case()
    tree = to_flax_params(net)
    jest = jax_api.init((jax.tree_util.tree_map(jnp.asarray, tree), jcfg),
                        mesh=jax_mesh.make_mesh(jax.devices()[:2]))
    est = api.init((tree, net.cfg), device="cpu", mesh=mesh.make_mesh(["cpu", "cpu"]))
    video = np.zeros((4, 64, 128, 3), np.float32)
    for call in (lambda e: e.compute_flow_video(video),
                 lambda e: e.export(tmp_path / "art", [(64, 128)])):
        with pytest.raises(ValueError) as jerr:
            call(jest)
        with pytest.raises(ValueError) as perr:
            call(est)
        assert str(perr.value) == str(jerr.value)
    # a spatial axis is served, as JAX's estimator serves it: rows in
    # bands over the axis's two slots
    jest = jax_api.init((jax.tree_util.tree_map(jnp.asarray, tree), jcfg),
                        mesh=jax_mesh.make_mesh(jax.devices()[:2], shape=(1, 2),
                                                axes=("data", "spatial")), spatial=True)
    est = api.init((tree, net.cfg), device="cpu", spatial=True,
                   mesh=mesh.make_mesh(["cpu", "cpu"], shape=(1, 2), axes=("data", "spatial")))
    assert len(est.replicas) == 2 and est._padded_batch(3) == jest._padded_batch(3) == 3
    for g, w in zip(est.compute_flow_batch(*frames), jest.compute_flow_batch(*frames)):
        if g.dtype == bool:
            assert (g != w).mean() <= 1e-3
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
