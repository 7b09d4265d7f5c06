"""CPU parity of the port's soft fine-tune recipe against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port, in f32:

* OBGCC, forward and reference gradients, against `jax.vjp` of
  `make_obgcc` over the penalties, `past_flow` and occlusion present or
  absent (and the autodiff variant); `const_vel` over `size_average` and
  `reference_grads`; second-order smoothness, forward and autodiff
  gradients: value rtol 1e-5, gradients rtol 1e-5 / atol 1e-6.
* Hard -> soft surgery: leaf-exact against JAX's `convert_hard_to_soft`,
  and the same errors where JAX's raises.
* The soft-loss anchor: the flagship f32 soft config (OBGCC, past_flow,
  const_vel 1, second-order smoothness) with params from
  `PWCNet.init(PRNGKey(0))` bridged into the port, on the inputs of
  `__graft_entry__.dryrun_multichip(soft=True)` (B=4, 64x128,
  `randn * 0.1` from `RandomState(0)`), gives the loss that run recorded,
  100.98643 (MULTICHIP_r05.json), at rtol 1e-4 (sum order and the mesh
  differ), with the fused stem off as recorded and on.
* Three soft `make_train_step` steps against JAX `make_train_step` (one
  jit) from a hard net by surgery, at the tiny config (levels 4, win 3,
  (2, 32, 64, 9)), with B2F_STEM_PALLAS=1 in both packages (JAX runs the
  Pallas stem in interpret mode inside its jit): the tolerances of
  tests/test_torch_train.py::test_train_steps_match_jax.
"""


import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp

from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.losses import make_const_vel as jax_make_const_vel
from back2future_tpu.losses import second_order_smoothness as jax_second_order
from back2future_tpu.losses.photometric import PhotoConfig as JaxPhotoConfig
from back2future_tpu.losses.photometric import make_obgcc as jax_make_obgcc
from back2future_tpu.losses.smoothness import SmoothConfig as JaxSmoothConfig
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.models.surgery import convert_hard_to_soft as jax_convert_hard_to_soft
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu.train.step import make_train_step as jax_make_train_step
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.losses import (
    PhotoConfig, SmoothConfig, build_criterions, make_const_vel, make_obgcc,
    second_order_smoothness,
)
from back2future_tpu_torch.models import (
    PWCNet, convert_hard_to_soft, convert_net_hard_to_soft, load_flax_params,
    pwc_config_from_options, to_flax_params,
)
from back2future_tpu_torch.train import create_train_state, make_train_step, multiscale_loss

torch.set_num_threads(1)

SOFT = dict(pme_criterion="OBGCC", past_flow=True, const_vel=1.0, smooth_second_order=True)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def group(seed, with_occ=True):
    """flow, flow_past, occ, (warped frames), target at B=2, 9x13."""
    b, h, w = 2, 9, 13
    occ = 1.0 / (1.0 + np.exp(-rand((b, h, w, 2), seed + 2))) if with_occ else None
    return (rand((b, h, w, 2), seed, 0.5), rand((b, h, w, 2), seed + 1, 0.5), occ,
            (rand((b, h, w, 3), seed + 3), rand((b, h, w, 3), seed + 4)), rand((b, h, w, 3), seed + 5))


def compare_criterion(port_fn, jax_fn, arrays):
    """Value and gradient w.r.t. every array (None: not an input); the
    JAX gradient is `jax.vjp` of the value."""
    names = [k for k, v in arrays.items() if v is not None]
    nones = {k: None for k, v in arrays.items() if v is None}
    want_val, vjp = jax.vjp(lambda d: jax_fn(**d, **nones),
                            {k: jnp.asarray(arrays[k]) for k in names})
    (want_grads,) = vjp(jnp.ones_like(want_val))
    tens = {k: (torch.tensor(v, requires_grad=True) if v is not None else None)
            for k, v in arrays.items()}
    got = port_fn(**tens)
    grads = torch.autograd.grad(got, [tens[k] for k in names], allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want_val), rtol=1e-5)
    for k, gr in zip(names, grads):
        gr = np.zeros_like(arrays[k]) if gr is None else gr.numpy()
        np.testing.assert_allclose(gr, np.asarray(want_grads[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------------- criteria

@pytest.mark.parametrize("with_occ", [True, False], ids=["occ", "no_occ"])
@pytest.mark.parametrize("past_flow", [True, False], ids=["past_flow", "future_only"])
@pytest.mark.parametrize("penalty", ["Quadratic", "L1", "Lorentzian"])
def test_obgcc_reference_grads_match_jax(penalty, past_flow, with_occ):
    """alpha != 1 and beta != 1 expose the forward's missing alpha and the
    backward's weights; the flow scale pushes border pixels out of the
    image, so the out-of-image penalty and masks are exercised."""
    kw = dict(frames=3, penalty=penalty, size_average=False, past_flow=past_flow,
              alpha=0.7, beta=1.3, reference_grads=True)
    scale = 4.0
    flow, flow_past, occ, warped, target = group(40, with_occ)
    port_fn, jax_fn = make_obgcc(PhotoConfig(**kw), scale), jax_make_obgcc(JaxPhotoConfig(**kw), scale)
    arrays = dict(flow=flow, flow_past=flow_past, occ=occ, w1=warped[0], w2=warped[1],
                  target=target)

    def call(fn):
        return lambda flow, flow_past, occ, w1, w2, target: fn(flow, flow_past, occ, (w1, w2),
                                                               target)

    compare_criterion(call(port_fn), call(jax_fn), arrays)


@pytest.mark.parametrize("size_average", [False, True], ids=["sum", "mean"])
def test_obgcc_autodiff_matches_jax(size_average):
    kw = dict(frames=3, penalty="L1", size_average=size_average, past_flow=True,
              reference_grads=False)
    flow, flow_past, occ, warped, target = group(50)
    port_fn, jax_fn = make_obgcc(PhotoConfig(**kw), 3.0), jax_make_obgcc(JaxPhotoConfig(**kw), 3.0)
    arrays = dict(flow=flow, flow_past=flow_past, occ=occ, w1=warped[0], w2=warped[1],
                  target=target)

    def call(fn):
        return lambda flow, flow_past, occ, w1, w2, target: fn(flow, flow_past, occ, (w1, w2),
                                                               target)

    compare_criterion(call(port_fn), call(jax_fn), arrays)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("size_average", [False, True], ids=["sum", "mean"])
def test_const_vel_matches_jax(size_average, reference_grads):
    flow, flow_past = rand((2, 6, 7, 2), 60), rand((2, 6, 7, 2), 61)
    compare_criterion(make_const_vel(size_average, reference_grads),
                      jax_make_const_vel(size_average, reference_grads),
                      dict(flow_a=flow, flow_b=flow_past))


@pytest.mark.parametrize("penalty,size_average", [("L1", False), ("Quadratic", True),
                                                  ("Lorentzian", False)])
def test_second_order_smoothness_matches_jax(penalty, size_average):
    kw = dict(penalty=penalty, size_average=size_average, second_order=True)
    flow, _, _, _, target = group(70)
    compare_criterion(lambda flow, target: second_order_smoothness(flow, target, SmoothConfig(**kw)),
                      lambda flow, target: jax_second_order(flow, target, JaxSmoothConfig(**kw)),
                      dict(flow=flow, target=target))


def test_build_criterions_selects_the_soft_criteria():
    """The soft options select OBGCC, second-order smoothness and
    const_vel in both packages: the same values on one level's group."""
    base = dict(levels=4, pwc_ws=3, batchSize=2, dataset="synthetic", pme_alpha=0.8, **SOFT)
    port, ref = build_criterions(Options(**base).derive()), \
        jax_build_criterions(JaxOptions(**base).derive())
    flow, flow_past, occ, warped, target = group(80)
    t = torch.from_numpy
    pairs = [
        (port.pme(2.5)(t(flow), t(flow_past), t(occ), tuple(map(t, warped)), t(target)),
         ref.pme(2.5)(flow, flow_past, occ, warped, target)),
        (port.flow_smooth(t(flow), t(target)), ref.flow_smooth(flow, target)),
        (port.const_vel(t(flow), t(flow_past)), ref.const_vel(flow, flow_past)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# -------------------------------------------------------------------- surgery

def tiny_options(**kw) -> Options:
    base = dict(levels=4, pwc_ws=3, frames=3, batchSize=2, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32", LR=1e-3)
    base.update(kw)
    return Options(**base).derive()


def tiny_nets():
    hard = PWCNet(pwc_config_from_options(tiny_options()),
                  generator=torch.Generator().manual_seed(0))
    soft = PWCNet(pwc_config_from_options(tiny_options(**SOFT)),
                  generator=torch.Generator().manual_seed(1))
    return hard, soft


def test_surgery_matches_jax_leaf_by_leaf():
    hard, soft = tiny_nets()
    hard_tree, soft_tree = to_flax_params(hard), to_flax_params(soft)
    got = convert_hard_to_soft(hard_tree, soft_tree)
    want = jax_convert_hard_to_soft(hard_tree, soft_tree)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))
    np.testing.assert_array_equal(got["past_decoder_3"]["c2"]["conv"]["kernel"],
                                  hard_tree["flow_decoder_3"]["c2"]["conv"]["kernel"])


def _no_flow_decoder(hard, soft):
    del hard["flow_decoder_4"]


def _unknown_module(hard, soft):
    soft["extra_9"] = soft["feat_2"]


def _shape_mismatch(hard, soft):
    hard["flow_decoder_3"]["out"]["conv"]["bias"] = np.zeros(3, np.float32)


@pytest.mark.parametrize("break_trees,error", [(_no_flow_decoder, KeyError),
                                               (_unknown_module, KeyError),
                                               (_shape_mismatch, ValueError)],
                         ids=["no_flow_decoder", "unknown_module", "shape_mismatch"])
def test_surgery_raises_where_jax_raises(break_trees, error):
    hard, soft = tiny_nets()
    hard_tree, soft_tree = to_flax_params(hard), to_flax_params(soft)
    break_trees(hard_tree, soft_tree)
    with pytest.raises(error):
        jax_convert_hard_to_soft(hard_tree, soft_tree)
    with pytest.raises(error):
        convert_hard_to_soft(hard_tree, soft_tree)


def test_surgery_on_nets_keeps_the_future_flow():
    """After surgery the soft net's future flow is the hard net's, and its
    past decoders, seeded from the future ones, give the same flow."""
    hard, soft = tiny_nets()
    convert_net_hard_to_soft(hard, soft)
    x = torch.from_numpy(rand((1, 32, 64, 9), 90))
    with torch.no_grad():
        want, got = hard(x, with_warped=False), soft(x, with_warped=False)
    for g, w in zip(got, want):
        torch.testing.assert_close(g["flow"], w["flow"], rtol=0, atol=0)
        torch.testing.assert_close(g["flow_past"], g["flow"], rtol=0, atol=0)


# ----------------------------------------------------------------- the anchor

SOFT_LOSS = 100.98643   # MULTICHIP_r05.json, dryrun_multichip(8) [soft]


@pytest.fixture(scope="module")
def soft_anchor_case():
    opt = Options(optimize="pme", frames=3, levels=7, batchSize=4, compute_dtype="float32",
                  **SOFT).derive()
    b, h, w = 4, 64, 128
    images = np.random.RandomState(0).randn(b, h, w, 3 * opt.frames).astype(np.float32) * 0.1
    model = JaxPWCNet(jax_pwc_config(JaxOptions(**{k: getattr(opt, k) for k in (
        "optimize", "frames", "levels", "batchSize", "compute_dtype", *SOFT)}).derive()))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, h, w, 3 * opt.frames), jnp.float32))["params"]
    return opt, images, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("stem", ["0", "1"], ids=["stem_off", "stem_on"])
def test_soft_loss_anchor(soft_anchor_case, stem, monkeypatch):
    monkeypatch.setenv("B2F_STEM_PALLAS", stem)
    opt, images, params = soft_anchor_case
    net = PWCNet(pwc_config_from_options(opt))
    load_flax_params(net, params)
    x = torch.from_numpy(images)
    loss, comps = multiscale_loss(net(x, with_warped=True), {"images": x}, opt,
                                  build_criterions(opt))
    np.testing.assert_allclose(loss.item(), SOFT_LOSS, rtol=1e-4)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in net.parameters())


# ---------------------------------------------------------------- train steps

STEPS = 3


@pytest.fixture(scope="module")
def jax_soft_steps():
    """The soft net made by surgery from a seeded hard net, the batch, and
    JAX's losses and params after STEPS steps of its jitted train step,
    with the fused stem on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("B2F_STEM_PALLAS", "1")
        hard, soft = tiny_nets()
        net = convert_net_hard_to_soft(hard, soft)
        opt = tiny_options(**SOFT)
        jax_opt = JaxOptions(**{f: getattr(opt, f) for f in (
            "levels", "pwc_ws", "frames", "batchSize", "cropWidth", "cropHeight", "dataset",
            "sizeAverage", "optimize", "compute_dtype", "LR", *SOFT)}).derive()
        tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
        images = rand((2, 32, 64, 9), 5)
        step = jax_make_train_step(JaxPWCNet(jax_pwc_config(jax_opt)), jax_opt,
                                   jax_build_criterions(jax_opt), donate=False)
        state = jax_create_train_state(tree, jax_opt)
        losses = []
        for _ in range(STEPS):
            state, logs = step(state, {"images": jnp.asarray(images)})
            losses.append(float(logs["loss"]))
    return opt, net, images, losses, jax.tree_util.tree_map(np.asarray, state.params)


def test_soft_train_steps_match_jax(jax_soft_steps, monkeypatch):
    monkeypatch.setenv("B2F_STEM_PALLAS", "1")
    opt, net, images, want_losses, want_params = jax_soft_steps
    state = create_train_state(net, opt)
    step = make_train_step(net, opt, build_criterions(opt))
    batch = {"images": torch.from_numpy(images)}
    losses = []
    for _ in range(STEPS):
        state, logs = step(state, batch)
        losses.append(logs["loss"].item())
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    got = to_flax_params(net)
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        keys = [k.key for k in path]
        node = got
        for k in keys:
            node = node[k]
        np.testing.assert_allclose(node, want, rtol=1e-3, atol=0.1 * opt.LR,
                                   err_msg="/".join(keys))
