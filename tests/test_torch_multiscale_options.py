"""CPU parity of the port's `multiscale_loss` and its parameter gradients
against the JAX package's, over the option sets that
tests/test_torch_train_ops.py::test_multiscale_loss_and_param_grads_match_jax
(frames 3, the hard recipe) does not cover: frames 2 and 5, past flow
with OBGCC and with OSSIML1 at frames 5, no_occ, rescale_flow, residual,
original_pwc, occ_input, flow_input 0, pwc_skip 1, pwc_siamese 0 with
pwc_sum_cvs, pwc_sum_cvs alone, two_frame, Lorentzian penalties and
sizeAverage.

The tiny f32 PWC config (levels 4, win 3, B=2 at 32x64), the port's
seeded weights crossed to flax by the params bridge, the same numpy
batch. JAX's reference is one `value_and_grad` per case, computed once
and without jit (jit's reassociation moved rescale_flow's gradients by
5e-4 of max|g|). Tolerances as the frames-3 test: loss and components
rtol 1e-4, gradients rtol 1e-3 with atol 1e-5 * max|g| per leaf (conv
and sum order differ through four decoder levels).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.train.multiscale import multiscale_loss as jax_multiscale_loss
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.train import multiscale_loss

torch.set_num_threads(1)

H, W = 32, 64
LORENTZIAN = dict(pme_penalty="Lorentzian", smooth_flow_penalty="Lorentzian",
                  smooth_occ_penalty="Lorentzian")
CASES = {
    "frames2": dict(frames=2),
    "frames5": dict(frames=5),
    "past_flow_obgcc": dict(past_flow=True, pme_criterion="OBGCC", const_vel=1.0),
    "past_flow_ossiml1_frames5": dict(past_flow=True, pme_criterion="OSSIML1", frames=5),
    "no_occ": dict(no_occ=True),
    "rescale_flow": dict(rescale_flow=1),
    "residual": dict(residual=1),
    "original_pwc": dict(original_pwc=1),
    "occ_input": dict(occ_input=1),
    "flow_input0": dict(flow_input=0),
    "pwc_skip1": dict(pwc_skip=1),
    "siamese0_sum_cvs": dict(pwc_siamese=0, pwc_sum_cvs=True),
    "sum_cvs": dict(pwc_sum_cvs=True),
    "two_frame": dict(two_frame=1),
    "lorentzian": LORENTZIAN,
    "size_average": dict(sizeAverage=True),
}


def options(cls, **kw):
    base = dict(levels=4, pwc_ws=3, frames=3, batchSize=2, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32")
    base.update(kw)
    return cls(**base).derive()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The port's seeded net and options for one case, the batch, and
    JAX's loss, components and parameter gradients (no jit)."""
    kw = CASES[request.param]
    opt, jax_opt = options(Options, **kw), options(JaxOptions, **kw)
    net = PWCNet(pwc_config_from_options(opt),
                 generator=torch.Generator().manual_seed(len(request.param)))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    images = np.random.default_rng(90).standard_normal(
        (2, H, W, 3 * opt.frames)).astype(np.float32)
    model, crits = JaxPWCNet(jax_pwc_config(jax_opt)), jax_build_criterions(jax_opt)

    def loss_fn(params, images):
        outputs = model.apply({"params": params}, images)
        return jax_multiscale_loss(outputs, {"images": images}, jax_opt, crits)

    (loss, comps), grads = jax.value_and_grad(loss_fn, has_aux=True)(tree, jnp.asarray(images))
    return (opt, net, images, float(loss), {k: float(v) for k, v in comps.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def test_multiscale_loss_and_param_grads_match_jax(case):
    opt, net, images, want_loss, want_comps, want_grads = case
    net.zero_grad()
    x = torch.from_numpy(images)
    loss, comps = multiscale_loss(net(x, with_warped=True), {"images": x}, opt,
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
