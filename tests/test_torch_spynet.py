"""CPU parity of the port's SPyNet (models/spynet.py) and its paths through
the factory, the train step, checkpoints, the eval CLI and `init`, against
the JAX package's (back2future_tpu/models/spynet.py and friends).

Weights are drawn by the port's seeded init and crossed to a flax tree by
the params bridge; inputs are seeded numpy arrays; f32 throughout (the
port keeps f32 warp coordinates where JAX's bf16 net casts them to bf16,
ROADMAP queue 3, so parity holds in f32 only). Levels 4 at 32x64.

* The forward at frames 2 and 3, residual 0 and 1, occ_input,
  rescale_flow and flow_input 0: every level's flow, occlusion and output
  warps at rtol/atol 1e-4 (conv sums in another order);
  `with_warped=False` drops only the output warps; every warp gets a
  contiguous image, as the kernel takes it.
* The double-residual quirk: the next level upsamples the doubled
  output flow (tests/test_models.py:207-227 in JAX).
* `multiscale_loss` (pme and epe) and every parameter gradient against
  one JAX `value_and_grad`: loss rtol 1e-4, gradients rtol 1e-3 with atol
  1e-5 * max|g| per leaf.
* 3 `pme` steps against JAX `make_train_step`, with SGD and momentum
  (see `jax_steps`): loss rtol 1e-3, params rtol 1e-3 with atol a tenth
  of LR (tests/test_torch_train.py).
* A SPyNet `model_<e>.pt` pair saved and resumed bit for bit, `-cont`
  through `load_or_convert`, and JAX's `.msgpack` pair read with its Adam
  moments; the eval CLI on a JAX-written SPyNet checkpoint against
  tools/eval.py (values within 1e-4); `init` refusing it with JAX's
  message.
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from back2future_tpu import api as jax_api
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.data import SampleSpec, resample as jax_resample, write_manifest
from back2future_tpu.io.flow_io import write_disp, write_flo
from back2future_tpu.io.png16 import write_png
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.models.spynet import SPyNet as JaxSPyNet
from back2future_tpu.models.spynet import SPyNetConfig as JaxSPyNetConfig
from back2future_tpu.train import checkpoint as jax_checkpoint
from back2future_tpu.train.multiscale import multiscale_loss as jax_multiscale_loss
from back2future_tpu.train.optim import make_optimizer as jax_make_optimizer
from back2future_tpu.train.state import TrainState as JaxTrainState
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu.train.step import make_train_step as jax_make_train_step
from back2future_tpu_torch import api
from back2future_tpu_torch import eval as port_eval
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.data.resample import TWINS_ENV
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models import SPyNet, SPyNetConfig, spynet_config_from_options
from back2future_tpu_torch.models import pwc as rows_module   # the row layout's ops
from back2future_tpu_torch.models import to_flax_params
from back2future_tpu_torch.models.bridge import flax_to_torch_names
from back2future_tpu_torch.train import checkpoint, create_train_state, make_train_step
from back2future_tpu_torch.train import multiscale_loss

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
H, W = 32, 64
LR = 1e-3


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_config(cfg: SPyNetConfig) -> JaxSPyNetConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = jnp.float32
    return JaxSPyNetConfig(**fields)


def seeded(cfg: SPyNetConfig, seed: int = 0) -> SPyNet:
    return SPyNet(cfg, generator=torch.Generator().manual_seed(seed))


def jax_tree(net) -> dict:
    return jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))


VARIANTS = {
    "frames3": dict(),
    "frames2": dict(frames=2),
    "residual": dict(residual=1),
    "frames2_residual": dict(frames=2, residual=1),
    "occ_input_residual": dict(occ_input=1, residual=1),
    "rescale_flow": dict(rescale_flow=1),
    "flow_input0": dict(flow_input=0),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_jax(name):
    cfg = SPyNetConfig(levels=4, **VARIANTS[name])
    net = seeded(cfg, seed=len(name))
    x = rand((2, H, W, 3 * cfg.frames), 1)
    want = JaxSPyNet(jax_config(cfg)).apply({"params": jax_tree(net)}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
        lean = net(torch.from_numpy(x), with_warped=False)
    assert len(got) == len(want) == cfg.levels
    for g, w, gl in zip(got, want, lean):
        assert g["flow_scale"] == w["flow_scale"] and g["flow_past"] is None
        for key in ("flow", "occ"):
            assert (g[key] is None) == (w[key] is None), key
            if g[key] is not None:
                np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]), err_msg=key, **TOL)
                assert torch.equal(gl[key], g[key])
        assert len(g["warped"]) == len(w["warped"]) == cfg.frames - 1 and gl["warped"] == []
        for a, b in zip(g["warped"], w["warped"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg="warped", **TOL)


def test_param_names_and_shapes_match_jax():
    for kw in VARIANTS.values():
        cfg = SPyNetConfig(levels=3, **kw)
        want = JaxSPyNet(jax_config(cfg)).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 16, 16, 3 * cfg.frames)))["params"]
        got = to_flax_params(seeded(cfg))
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, want))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(want)):
            assert a.shape == b.shape, path


def test_every_warp_gets_a_contiguous_image(monkeypatch):
    """The warp kernel refuses a strided image on the card; on the CPU the
    twin would take one, so the model's own inputs are checked here: 4
    input warps and 6 output warps at levels 3, frames 3."""
    seen = []
    real = rows_module.warp_bilinear

    def checking(images, flow, **kw):
        seen.append((images.is_contiguous(), flow.is_contiguous()))
        return real(images, flow, **kw)

    monkeypatch.setattr(rows_module, "warp_bilinear", checking)
    net = seeded(SPyNetConfig(levels=3))
    net(torch.from_numpy(rand((1, 16, 16, 9), 2)))
    assert seen == [(True, True)] * 10
    seen.clear()
    net(torch.from_numpy(rand((1, 16, 16, 9), 2)), with_warped=False)
    assert len(seen) == 4


def test_residual_next_level_gets_doubled_flow(monkeypatch):
    """With residual=1 the next level upsamples the OUTPUT flow after the
    second residual add, not the singly-added flow the level warps with."""
    real_up = rows_module.upsample_bilinear2x
    seen = []

    def recording_up(t):
        seen.append(t.detach().clone())
        return real_up(t)

    net = seeded(SPyNetConfig(levels=3, residual=1))
    monkeypatch.setattr(rows_module, "upsample_bilinear2x", recording_up)
    with torch.no_grad():
        levels = net(torch.from_numpy(rand((1, 16, 16, 9), 3)))
    assert len(seen) == 2
    assert torch.equal(seen[0], levels[-1]["flow"]) and torch.equal(seen[1], levels[-2]["flow"])


def tiny_options(cls=Options, **kw):
    base = dict(netType="spynet", levels=4, frames=3, batchSize=2, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32", LR=LR)
    base.update(kw)
    return cls(**base).derive()


def gt_batch(seed):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((2, H, W, 9)).astype(np.float32),
            "flow_gt": (rng.standard_normal((2, H, W, 2)) * 0.2).astype(np.float32),
            "occ_gt": rng.choice(np.float32([0.0, 0.5, 1.0]), size=(2, H, W, 2)),
            "mask": (rng.random((2, H, W)) > 0.1).astype(np.float32)}


@pytest.fixture(scope="module", params=["pme", "epe"])
def loss_case(request):
    """Seeded port net, a batch, and JAX's loss, components and gradients
    (one value_and_grad jit)."""
    kw = dict(optimize="epe", epe=1.0) if request.param == "epe" else {}
    opt = tiny_options(**kw)
    net = seeded(spynet_config_from_options(opt), seed=5)
    batch = gt_batch(80)
    model, crits = JaxSPyNet(jax_config(net.cfg)), jax_build_criterions(tiny_options(JaxOptions,
                                                                                     **kw))

    @jax.jit
    def loss_fn(params, batch):
        return jax_multiscale_loss(model.apply({"params": params}, batch["images"]), batch, opt,
                                   crits)

    (loss, comps), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax_tree(net), {k: jnp.asarray(v) for k, v in batch.items()})
    return (opt, net, batch, float(loss), {k: float(v) for k, v in comps.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def test_multiscale_loss_and_param_grads_match_jax(loss_case):
    opt, net, batch, want_loss, want_comps, want_grads = loss_case
    net.zero_grad()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, comps = multiscale_loss(net(tb["images"], opt.optimize == "pme"), tb, opt,
                                  build_criterions(opt))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4)
    assert set(comps) == set(want_comps)
    for k, v in comps.items():
        np.testing.assert_allclose(v.item(), want_comps[k], rtol=1e-4, atol=1e-7, err_msg=k)
    loss.backward()
    n = 0
    for name, p in net.named_parameters():
        *mods, leaf = name.split(".")
        want = functools.reduce(lambda d, m: d[m], mods + ["conv"], want_grads)
        want = want["kernel"].transpose(3, 2, 0, 1) if leaf == "weight" else want["bias"]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want_grads))


STEPS = 3
STEP_OPTIMIZER = dict(optimizer="sgd", momentum=0.9)


@pytest.fixture(scope="module")
def jax_steps():
    """The steps run SGD with momentum (STEP_OPTIMIZER): Adam's first step
    moves every element by LR times the sign of its gradient, and through
    SPyNet's full-resolution warps the gradients that sit within float
    noise of zero, whose sign the two packages may round either way, grow
    to 0.7% of the elements by the third step. An SGD update follows the
    gradient, so the comparison holds every element at the tolerances.
    Adam's chain is held against optax in tests/test_torch_train.py."""
    opt = tiny_options(**STEP_OPTIMIZER)
    net = seeded(spynet_config_from_options(opt), seed=7)
    images = rand((2, H, W, 9), 9)
    step = jax_make_train_step(JaxSPyNet(jax_config(net.cfg)), opt,
                               jax_build_criterions(tiny_options(JaxOptions, **STEP_OPTIMIZER)),
                               donate=False)
    state = jax_create_train_state(jax_tree(net), opt)
    losses = []
    for _ in range(STEPS):
        state, logs = step(state, {"images": jnp.asarray(images)})
        losses.append(float(logs["loss"]))
    return opt, net, images, losses, jax.tree_util.tree_map(np.asarray, state.params)


def test_train_steps_match_jax(jax_steps):
    opt, net, images, want_losses, want_params = jax_steps
    state = create_train_state(net, opt)
    step = make_train_step(net, opt, build_criterions(opt))
    losses = []
    for _ in range(STEPS):
        state, logs = step(state, {"images": torch.from_numpy(images)})
        losses.append(logs["loss"].item())
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert losses[-1] < losses[0]
    got = flax_to_torch_names(to_flax_params(net))
    for name, want in flax_to_torch_names(want_params).items():
        np.testing.assert_allclose(got[name], want, rtol=1e-3, atol=0.1 * LR, err_msg=name)


def test_checkpoint_round_trip_and_cont(tmp_path):
    """model_<e>.pt pair saved and loaded bit for bit; load_or_convert
    builds a fresh SPyNet, then -cont loads the newest pair."""
    opt = tiny_options(cache=str(tmp_path), expName="spy")
    net, cfg, epoch0 = checkpoint.load_or_convert(opt)
    assert isinstance(net, SPyNet) and cfg == spynet_config_from_options(opt) and epoch0 == 1
    again, _, _ = checkpoint.load_or_convert(opt)
    assert all(torch.equal(p, q) for p, q in zip(net.parameters(), again.parameters()))
    state = create_train_state(net, opt, epoch=2)
    sum((p ** 2).sum() for p in net.parameters()).backward()
    state.optimizer.step()
    state = dataclasses.replace(state, step=5)
    checkpoint.save_checkpoint(opt.save, state, opt, 2)
    loaded, next_epoch = checkpoint.load_train_checkpoint(opt.save, opt, device="cpu")
    assert next_epoch == 3 and loaded.step == 5 and isinstance(loaded.model, SPyNet)
    for (name, p), q in zip(net.named_parameters(), loaded.model.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.rule.state[p][k],
                               loaded.optimizer.rule.state[q][k]), (name, k)
    resumed, _, epoch = checkpoint.load_or_convert(dataclasses.replace(opt, cont=True))
    assert epoch == 3 and all(torch.equal(p, q) for p, q in
                              zip(net.parameters(), resumed.parameters()))


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """A JAX TrainState of a seeded SPyNet after 2 Adam updates of random
    gradients, saved by the JAX package's save_checkpoint (msgpack)."""
    opt = tiny_options(JaxOptions)
    net = seeded(SPyNetConfig(levels=4), seed=2)
    params = jax_tree(net)
    tx = jax_make_optimizer(opt, 1)
    opt_state = tx.init(params)
    rng = np.random.default_rng(3)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    d = tmp_path_factory.mktemp("jax_spynet")
    jax_checkpoint.save_checkpoint(d, JaxTrainState(params=params, opt_state=opt_state,
                                                    step=jnp.asarray(4, jnp.int32), epoch=2),
                                   opt, 2)
    return d, jax.tree_util.tree_map(np.asarray, params), serialization.to_state_dict(opt_state)


def test_jax_msgpack_pair_reads(jax_written):
    d, params, opt_state = jax_written
    state, next_epoch = checkpoint.load_train_checkpoint(d, tiny_options(), device="cpu")
    assert next_epoch == 3 and state.step == 4 and isinstance(state.model, SPyNet)
    want = flax_to_torch_names(params)
    node = checkpoint._rule_state(opt_state)
    mu, nu = flax_to_torch_names(node["mu"]), flax_to_torch_names(node["nu"])
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])
        rule = state.optimizer.rule.state[p]
        np.testing.assert_array_equal(rule["exp_avg"].numpy(), mu[name])
        np.testing.assert_array_equal(rule["exp_avg_sq"].numpy(), nu[name])


def test_init_refuses_spynet_as_jax_does(jax_written, monkeypatch):
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    d = jax_written[0]
    with pytest.raises(ValueError) as jax_err:
        jax_api.init(str(d))
    with pytest.raises(ValueError) as port_err:
        api.init(str(d), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert "SPyNetConfig" in str(port_err.value)


@pytest.fixture(scope="module")
def toy_tree(tmp_path_factory):
    """7 frames, 4 samples with .flo ground truth and {0, 0.5, 1}
    occlusion maps (as tests/test_torch_loop.py's)."""
    root = tmp_path_factory.mktemp("toyspy")
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


def test_eval_cli_matches_tools_eval(jax_written, toy_tree, monkeypatch, capsys):
    d = jax_written[0]
    args = ["--checkpoint", str(d), "--dataset", "toy", "--datasets_dir",
            str(toy_tree / "datasets"), "--data_root", str(toy_tree), "--batchSize", "2",
            "--cropHeight", "32", "--cropWidth", "64", "--split", "all", "--limit", "3", "--cpu"]
    monkeypatch.setenv(TWINS_ENV, "1")
    port_eval.main(args)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    monkeypatch.setattr(jax_resample, "_native", (None,))
    spec = importlib.util.spec_from_file_location("_tools_eval", ROOT / "tools" / "eval.py")
    tools_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools_eval)
    tools_eval.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) and got["n_samples"] == want["n_samples"] == 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
