"""CPU parity of the port's train step against the JAX package.

* The hard-loss anchor: the flagship f32 config with params from
  `PWCNet.init(PRNGKey(0))` bridged into the port, on the inputs of
  `__graft_entry__.dryrun_multichip` (B=4, 64x128, `randn * 0.1` from
  `RandomState(0)`), gives the loss that run recorded, 49.97828
  (MULTICHIP_r05.json), at rtol 1e-4 (sum order and the mesh differ).
* Three `make_train_step` steps against JAX `make_train_step` (one jit)
  from the same params at the tiny config (levels 4, win 3) with
  LR 1e-3: loss per step and params after 3 steps at rtol 1e-3 (conv
  and sum order differ), with atol 1e-4, a tenth of LR, for the params:
  Adam rescales every gradient to a step of about LR, so a gradient
  component near 0 moves its param by up to LR either way.
* The optimiser chain order (decay, then clip, then the rule) on a toy
  module against optax's chain, and the per-epoch Adam reset.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


def _import_dynamo_from_stdlib_path():
    """torch.optim imports torch._dynamo at its first call, which imports
    the standard library's `profile` through cProfile. Test files that
    are collected earlier in the same worker (test_learn_demo.py,
    test_parity_demo.py) put tools/ first on sys.path, where
    tools/profile.py would shadow it: import torch._dynamo with tools/
    off the path."""
    tools = Path(__file__).resolve().parent.parent / "tools"
    saved = sys.path[:]
    sys.path[:] = [p for p in saved if Path(p or ".").resolve() != tools]
    shadow = sys.modules.get("profile")
    if shadow is not None and Path(getattr(shadow, "__file__", "") or ".").parent == tools:
        del sys.modules["profile"]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.path[:] = saved


_import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp
import optax

from back2future_tpu.config import Options
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.train.optim import make_optimizer as jax_make_optimizer
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu.train.step import make_train_step as jax_make_train_step
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models import (
    PWCNet, load_flax_params, pwc_config_from_options, to_flax_params,
)
from back2future_tpu_torch.train import (
    create_train_state, lr_for_epoch, make_optimizer, make_train_step, multiscale_loss,
)

torch.set_num_threads(1)

HARD_LOSS = 49.97828   # MULTICHIP_r05.json, dryrun_multichip(8) [hard]


def test_hard_loss_anchor():
    opt = Options(optimize="pme", frames=3, levels=7, batchSize=4, compute_dtype="float32",
                  pme_criterion="OBCC", past_flow=False).derive()
    b, h, w = 4, 64, 128
    images = np.random.RandomState(0).randn(b, h, w, 3 * opt.frames).astype(np.float32) * 0.1
    model = JaxPWCNet(jax_pwc_config(opt))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, h, w, 3 * opt.frames), jnp.float32))["params"]
    net = PWCNet(pwc_config_from_options(opt))
    load_flax_params(net, jax.tree_util.tree_map(np.asarray, params))
    x = torch.from_numpy(images)
    loss, comps = multiscale_loss(net(x, with_warped=True), {"images": x}, opt,
                                  build_criterions(opt))
    np.testing.assert_allclose(loss.item(), HARD_LOSS, rtol=1e-4)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in net.parameters())


def tiny_options(**kw) -> Options:
    base = dict(levels=4, pwc_ws=3, frames=3, batchSize=2, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32", LR=1e-3)
    base.update(kw)
    return Options(**base).derive()


STEPS = 3


@pytest.fixture(scope="module")
def jax_steps():
    """Seeded port weights, the batch, and JAX's losses and params after
    STEPS steps of its jitted train step."""
    opt = tiny_options()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    images = np.random.default_rng(5).standard_normal((2, 32, 64, 9)).astype(np.float32)
    step = jax_make_train_step(JaxPWCNet(jax_pwc_config(opt)), opt, jax_build_criterions(opt),
                               donate=False)
    state = jax_create_train_state(tree, opt)
    losses = []
    for _ in range(STEPS):
        state, logs = step(state, {"images": jnp.asarray(images)})
        losses.append(float(logs["loss"]))
    return opt, net, images, losses, jax.tree_util.tree_map(np.asarray, state.params)


def test_train_steps_match_jax(jax_steps):
    opt, net, images, want_losses, want_params = jax_steps
    state = create_train_state(net, opt)
    step = make_train_step(net, opt, build_criterions(opt))
    batch = {"images": torch.from_numpy(images)}
    losses = []
    for _ in range(STEPS):
        state, logs = step(state, batch)
        losses.append(logs["loss"].item())
        assert set(logs) == {"loss", "pme", "sflow", "socc", "gocc", "sup_flow", "sup_occ"}
    assert state.step == STEPS and state.optimizer.lr == pytest.approx(1e-3)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert losses[-1] < losses[0]
    got = to_flax_params(net)
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        keys = [k.key for k in path]
        node = got
        for k in keys:
            node = node[k]
        np.testing.assert_allclose(node, want, rtol=1e-3, atol=0.1 * opt.LR,
                                   err_msg="/".join(keys))


def test_train_step_rejects_unported():
    net = PWCNet(pwc_config_from_options(tiny_options()))
    for kw in (dict(remat=1), dict(ground_truth=True)):
        opt = tiny_options(**kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(net, opt, build_criterions(opt))


# ------------------------------------------------------------------ optimiser

OPTIM_CASES = {
    "adam_wd_clip": dict(optimizer="adam", weightDecay=0.1, grad_clip=0.5),
    "adam_plain": dict(optimizer="adam"),
    "sgd_wd_clip": dict(optimizer="sgd", momentum=0.9, weightDecay=0.05, grad_clip=1.0),
    "sgd_no_momentum_clip_inactive": dict(optimizer="sgd", momentum=0.0, grad_clip=1e6),
}


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_optimizer_chain_matches_optax(case):
    """Decay, then global-norm clip, then the rule: three updates of a toy
    module against optax's chain from the same gradients."""
    opt = tiny_options(LR=0.01, **OPTIM_CASES[case])
    rng = np.random.default_rng(9)
    w0, b0 = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    grads = [(rng.standard_normal((4, 3)).astype(np.float32) * 3,
              rng.standard_normal(3).astype(np.float32) * 3) for _ in range(3)]

    tx = jax_make_optimizer(opt, epoch=1)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    opt_state = tx.init(params)
    for gw, gb in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)

    w, b = torch.nn.Parameter(torch.tensor(w0)), torch.nn.Parameter(torch.tensor(b0))
    optimizer = make_optimizer(opt, [w, b], epoch=1)
    for gw, gb in grads:
        optimizer.zero_grad()
        w.grad, b.grad = torch.tensor(gw), torch.tensor(gb)
        optimizer.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(params["b"]), rtol=1e-5, atol=1e-6)


def test_epoch_regime_and_adam_reset():
    assert lr_for_epoch(1) == pytest.approx(1e-4)
    assert lr_for_epoch(201) == pytest.approx(5e-5)
    assert lr_for_epoch(1001, base_lr=1e-3) == pytest.approx(1e-3 / 16)
    net = torch.nn.Linear(2, 2)
    for reset in (True, False):
        opt = tiny_options(LR=0.0, adam_reset_per_epoch=reset)
        state = create_train_state(net, opt)
        net(torch.ones(1, 2)).sum().backward()
        state.optimizer.step()
        assert state.optimizer.rule.state
        new = state.with_epoch(201, opt)
        assert new.epoch == 201 and new.model is net
        assert (new.optimizer is not state.optimizer) == reset
        assert bool(new.optimizer.rule.state) == (not reset)
        if reset:
            assert new.optimizer.lr == pytest.approx(5e-5)
    assert dataclasses.replace(state, step=3).step == 3
