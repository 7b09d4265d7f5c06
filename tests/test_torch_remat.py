"""`-remat 1` in the port: the train step's forward under non-reentrant
activation checkpointing (counterpart of tests/test_remat.py).

* The remat step gives the parameters of the plain step (rtol 1e-5, atol
  1e-7, as the JAX test): the recompute runs the same ops on the same
  inputs.
* It gives the parameters of JAX's remat step from the same weights at
  test_remat.py's `_setup` sizes (rtol 1e-3, atol a tenth of the epoch's
  LR, as test_torch_train.py).
* The forward runs twice a step (once more in the backward), every
  forward op of the kernels' twins (cost volume, warp) twice, their
  backward ops once; without remat, once each. On a CUDA tensor the twins
  are the kernels, so this is what chip_smoke.py's launch counts see.
* The forward draws no random numbers, so the recompute needs no saved
  RNG state.
* `--remat 1` on the command line reaches the step.
"""

import sys

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp

from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu.train.step import make_train_step as jax_make_train_step
from back2future_tpu_torch.config import Options, parse_args
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.train import create_train_state, lr_for_epoch, make_train_step

torch.set_num_threads(1)

# the modules, not the functions that back2future_tpu_torch.ops exports
# under the same names
cv_module = sys.modules["back2future_tpu_torch.ops.cost_volume"]
warp_module = sys.modules["back2future_tpu_torch.ops.warp"]

B, H, W = 2, 32, 64      # tests/test_remat.py's _setup
LR = lr_for_epoch(1)     # the default regime's LR at epoch 1


def _options(remat: int, cls=Options):
    return cls(optimize="pme", frames=3, levels=4, batchSize=B, compute_dtype="float32",
               remat=remat).derive()


def _images():
    return np.random.RandomState(0).randn(B, H, W, 9).astype(np.float32) * 0.1


def _port_step(remat: int):
    """One port step from the weights of seed 0 -> (loss, params by name)."""
    opt = _options(remat)
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0))
    step = make_train_step(net, opt, build_criterions(opt))
    _, logs = step(create_train_state(net, opt), {"images": torch.from_numpy(_images())})
    return logs["loss"].item(), net


def test_remat_matches_plain_step():
    loss0, net0 = _port_step(0)
    loss1, net1 = _port_step(1)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    for (name, a), (_, b) in zip(net0.named_parameters(), net1.named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_remat_matches_jax_remat_step():
    opt = _options(1, JaxOptions)
    net = PWCNet(pwc_config_from_options(_options(1)), generator=torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    step = jax_make_train_step(JaxPWCNet(jax_pwc_config(opt)), opt, jax_build_criterions(opt),
                               donate=False)
    new, logs = step(jax_create_train_state(tree, opt), {"images": jnp.asarray(_images())})
    want_params = jax.tree_util.tree_map(np.asarray, new.params)

    loss, got_net = _port_step(1)
    np.testing.assert_allclose(loss, float(logs["loss"]), rtol=1e-3)
    got = to_flax_params(got_net)
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        keys = [k.key for k in path]
        node = got
        for k in keys:
            node = node[k]
        np.testing.assert_allclose(node, want, rtol=1e-3, atol=0.1 * LR, err_msg="/".join(keys))


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("remat", [0, 1])
def test_remat_recomputes_the_forward(monkeypatch, remat):
    """Under remat the module's forward and every forward twin of the
    kernels run twice a step, their backward twins once: autograd saved
    only the forward's input, and the recompute rebuilt the tensors that
    the ops' autograd formulas saved."""
    calls = {}
    for module, name in ((cv_module, "cost_volume_reference"),
                         (cv_module, "dref_form"), (cv_module, "dframe_reference"),
                         (warp_module, "warp_bilinear_reference"),
                         (warp_module, "warp_dimages_reference"),
                         (warp_module, "warp_dflow_reference")):
        _counting(monkeypatch, module, name, calls)
    opt = _options(remat)
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0))
    forwards = []
    # a pre-hook: the recompute stops once it has rebuilt the last saved
    # tensor (checkpoint's early stop), so a forward hook would not fire
    net.register_forward_pre_hook(lambda *_: forwards.append(1))
    make_train_step(net, opt, build_criterions(opt))(create_train_state(net, opt),
                                                     {"images": torch.from_numpy(_images())})
    # levels 4, skip 2: 2 decoded levels (2 cost volumes each, for the past
    # and the future frame), 1 feature warp per non-reference frame between
    # them, and the image warps of both non-reference frames at 2 levels;
    # the image gradient only for the feature warps (the frames need none)
    once = {"cost_volume_reference": 4, "dref_form": 4, "dframe_reference": 4,
            "warp_bilinear_reference": 6, "warp_dimages_reference": 2,
            "warp_dflow_reference": 6}
    forward = ("cost_volume_reference", "warp_bilinear_reference")
    want = {k: v * (1 + remat if k in forward else 1) for k, v in once.items()}
    assert calls == want
    assert len(forwards) == 1 + remat


@pytest.mark.parametrize("past_flow", [False, True], ids=["hard", "soft"])
def test_forward_draws_no_random_numbers(past_flow):
    """The step's recompute keeps no RNG state (`preserve_rng_state=False`):
    the net's forward must leave the generator as it found it."""
    opt = Options(optimize="pme", frames=3, levels=4, batchSize=B, compute_dtype="float32",
                  past_flow=past_flow).derive()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0))
    state = torch.get_rng_state()
    net(torch.from_numpy(_images()), True)
    assert torch.equal(torch.get_rng_state(), state)


def test_cli_flag_threads_through(tmp_path, monkeypatch):
    """`--remat 1` reaches the step: the forward runs under checkpointing."""
    opt = parse_args(["--remat", "1", "--dataset", "Kitti2015", "--cache", str(tmp_path),
                      "--levels", "4", "--batchSize", str(B)])
    assert opt.remat == 1
    seen = []
    checkpoint = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kwargs):
        seen.append(kwargs)
        return checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0))
    make_train_step(net, opt, build_criterions(opt))(create_train_state(net, opt),
                                                     {"images": torch.from_numpy(_images())})
    assert seen == [{"use_reentrant": False, "preserve_rng_state": False}]
