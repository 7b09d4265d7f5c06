"""CPU parity of the port's training ops against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port (on CPU tensors the port runs the plain twin of each CUDA
kernel), in f32:

* cost-volume backward (the op `b2f::cost_volume`'s autograd formula, on
  the CPU the twins of kernels K2/K3)
  against `jax.vjp` of `cost_volume_pallas` in interpret mode (the
  Pallas `_dref_kernel`/`_dframe_kernel`): rtol/atol 1e-5, the sums run
  in another order;
* warp backward (the op `b2f::warp_bilinear`'s autograd formula, on the
  CPU the twins of K4 and the flow-gradient kernel)
  against `jax.vjp` of `warp_bilinear` (XLA scatter, and the Pallas
  `d_images_pallas` in interpret mode) and `_warp_autodiff`: atol 1e-5;
* each ported criterion, value and gradient, against JAX's value and
  `jax.grad`, with reference gradients on and off: rtol 1e-5, atol 1e-6;
* `multiscale_loss` on the bridged model's outputs and its gradient for
  every parameter, against one JAX `value_and_grad` at the tiny config:
  rtol 1e-3 with atol 1e-5 * max|g| per leaf (conv and sum order differ
  through four decoder levels).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu.config import Options
from back2future_tpu.data.wire import decode_batch as jax_decode_batch
from back2future_tpu.data.wire import encode_batch
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.losses import make_occ_prior as jax_make_occ_prior
from back2future_tpu.losses import smoothness as jax_smoothness
from back2future_tpu.losses.photometric import PhotoConfig as JaxPhotoConfig
from back2future_tpu.losses.photometric import make_obcc as jax_make_obcc
from back2future_tpu.losses.smoothness import SmoothConfig as JaxSmoothConfig
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.ops.cost_volume_pallas import cost_volume_pallas
from back2future_tpu.ops.warp import _warp_autodiff
from back2future_tpu.ops.warp import warp_bilinear as jax_warp_bilinear
from back2future_tpu.train.multiscale import multiscale_loss as jax_multiscale_loss
from back2future_tpu_torch import ops
from back2future_tpu_torch.data import decode_batch
from back2future_tpu_torch.losses import (
    PhotoConfig, SmoothConfig, build_criterions, make_obcc, make_occ_prior, smoothness,
)
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.train import multiscale_loss

torch.set_num_threads(1)

CV_MODULE = importlib.import_module("back2future_tpu_torch.ops.cost_volume")
WARP_MODULE = importlib.import_module("back2future_tpu_torch.ops.warp")


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(x, grad=True):
    return torch.tensor(x, requires_grad=grad)


# ------------------------------------------------------ cost-volume backward

# every window, dilation and direction, each twice (an interpret-mode
# Pallas backward costs seconds per case)
CV_CASES = [(3, 1, True), (3, 2, False), (5, 1, False), (5, 2, True), (9, 1, True),
            (9, 2, False)]
CV_SHAPE = (1, 10, 12, 8)
CV_SCALE = 0.25


@pytest.fixture(scope="module")
def cv_grads():
    """(g, d_ref, d_frame) of the Pallas kernels (interpret mode) per case."""
    ref, frame = map(jnp.asarray, (rand(CV_SHAPE, 1), rand(CV_SHAPE, 2)))
    out = {}
    for k, (win, dil, fwd) in enumerate(CV_CASES):
        g = rand(CV_SHAPE[:3] + (win * win,), 30 + k)
        _, vjp = jax.vjp(lambda r, f: cost_volume_pallas(r, f, win, dil, fwd), ref, frame)
        out[(win, dil, fwd)] = (g, *(np.asarray(d) * CV_SCALE for d in vjp(jnp.asarray(g))))
    return out


@pytest.mark.parametrize("win,dilation,fwd", CV_CASES)
def test_cost_volume_backward_matches_pallas(cv_grads, win, dilation, fwd):
    g, want_ref, want_frame = cv_grads[(win, dilation, fwd)]
    ref, frame = t(rand(CV_SHAPE, 1)), t(rand(CV_SHAPE, 2))
    ops.cost_volume(ref, frame, win, dilation, fwd, scale=CV_SCALE).backward(torch.from_numpy(g))
    np.testing.assert_allclose(ref.grad.numpy(), want_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(frame.grad.numpy(), want_frame, rtol=1e-5, atol=1e-5)
    # the op's CPU backward is the twin
    d_ref, d_frame = ops.cost_volume_backward_reference(
        torch.from_numpy(g), ref.detach(), frame.detach(), win, dilation, fwd, CV_SCALE)
    np.testing.assert_array_equal(d_ref.numpy(), ref.grad.numpy())
    np.testing.assert_array_equal(d_frame.numpy(), frame.grad.numpy())


def test_cost_volume_grad_only_where_needed():
    ref, frame = t(rand((1, 6, 7, 4), 3)), t(rand((1, 6, 7, 4), 4), grad=False)
    ops.cost_volume(ref, frame, 3).sum().backward()
    assert ref.grad is not None and frame.grad is None


# -------------------------------------------------------------- warp backward

WARP_SHAPE = (2, 9, 13, 5)
WARP_SCALES = {"subpixel": 0.7, "pixels": 3.0, "far_out_of_range": 40.0}


def warp_inputs(scale_name):
    img = rand(WARP_SHAPE, 20)
    flow = rand(WARP_SHAPE[:3] + (2,), 21, scale=WARP_SCALES[scale_name])
    g = rand(WARP_SHAPE, 22)
    return img, flow, g


def port_warp_grads(img, flow, g, reference_grads=True):
    ti, tf = t(img), t(flow)
    ops.warp_bilinear(ti, tf, reference_grads=reference_grads).backward(torch.from_numpy(g))
    return ti.grad.numpy(), tf.grad.numpy()


def jax_vjp(fn, img, flow, g):
    _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(flow))
    return tuple(map(np.asarray, vjp(jnp.asarray(g))))


@pytest.mark.parametrize("scale", sorted(WARP_SCALES))
def test_warp_backward_matches_jax(scale):
    img, flow, g = warp_inputs(scale)
    got = port_warp_grads(img, flow, g)
    want = jax_vjp(jax_warp_bilinear, img, flow, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # the op's CPU backward is the twin
    twin = ops.warp_bilinear_backward_reference(*map(torch.from_numpy, (img, flow, g)))
    for a, b in zip(twin, got):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("shape", [(2, 8, 16, 4), (1, 12, 8, 3)])
def test_warp_image_grad_matches_pallas_dimages(shape, monkeypatch):
    """K4's twin against the Pallas two-hot transpose (interpret mode)."""
    monkeypatch.setenv("B2F_DIMG_PALLAS", "1")
    img, g = rand(shape, 23), rand(shape, 24)
    flow = rand(shape[:3] + (2,), 25, scale=6.0)
    want, _ = jax_vjp(jax_warp_bilinear, img, flow, g)
    got, _ = port_warp_grads(img, flow, g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_warp_border_flow_gradient_is_not_zeroed():
    """Far out of range, the reference flow gradient is taken at the
    clamped coordinate and stays non-zero; autodiff zeroes it."""
    img, flow, g = warp_inputs("far_out_of_range")
    _, d_flow = port_warp_grads(img, flow, g)
    _, want = jax_vjp(jax_warp_bilinear, img, flow, g)
    b, h, w, _ = WARP_SHAPE
    xs = flow[..., 0] + np.arange(w)
    clamped = (xs < 0) | (xs > w - 1)
    assert clamped.mean() > 0.5
    assert np.abs(d_flow[..., 0][clamped]).max() > 0.1
    np.testing.assert_allclose(d_flow, want, rtol=1e-5, atol=1e-5)
    _, d_flow_ad = port_warp_grads(img, flow, g, reference_grads=False)
    assert np.all(d_flow_ad[..., 0][clamped] == 0)


@pytest.mark.parametrize("scale", sorted(WARP_SCALES))
def test_warp_autodiff_grads_match_jax(scale):
    img, flow, g = warp_inputs(scale)
    b, h, w, _ = WARP_SHAPE
    xs, ys = flow[..., 0] + np.arange(w), flow[..., 1] + np.arange(h)[:, None]
    assert not np.isin(xs, [0.0, w - 1.0]).any() and not np.isin(ys, [0.0, h - 1.0]).any()
    got = port_warp_grads(img, flow, g, reference_grads=False)
    want = jax_vjp(_warp_autodiff, img, flow, g)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a, b_, rtol=1e-5, atol=1e-5)


def test_warp_image_grad_only_where_needed():
    img = t(rand((1, 6, 7, 3), 26), grad=False)
    flow = t(rand((1, 6, 7, 2), 27))
    ops.warp_bilinear(img, flow).sum().backward()
    assert flow.grad is not None and img.grad is None


# ------------------------------------------------------------------- criteria

CRIT_SHAPE = (2, 8, 12)     # B, H, W


def group(seed, occ_channels=2, with_occ=True):
    b, h, w = CRIT_SHAPE
    flow = rand((b, h, w, 2), seed, scale=0.3)
    occ = 1.0 / (1.0 + np.exp(-rand((b, h, w, occ_channels), seed + 1))) if with_occ else None
    warped = (rand((b, h, w, 3), seed + 2), rand((b, h, w, 3), seed + 3))
    target = rand((b, h, w, 3), seed + 4)
    return flow, occ, warped, target


def compare_criterion(port_fn, jax_fn, arrays):
    """Value and gradient w.r.t. every array (None: not an input)."""
    names = [k for k, v in arrays.items() if v is not None]
    nones = {k: None for k, v in arrays.items() if v is None}
    want_val, want_grads = jax.value_and_grad(
        lambda d: jax_fn(**d, **nones))({k: jnp.asarray(arrays[k]) for k in names})
    tens = {k: (t(v) if v is not None else None) for k, v in arrays.items()}
    got = port_fn(**tens)
    grads = torch.autograd.grad(got, [tens[k] for k in names], allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want_val), rtol=1e-5)
    for k, gr in zip(names, grads):
        gr = np.zeros_like(arrays[k]) if gr is None else gr.numpy()
        np.testing.assert_allclose(gr, np.asarray(want_grads[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("with_occ", [True, False], ids=["occ", "no_occ"])
@pytest.mark.parametrize("penalty", ["L1", "Quadratic", "Lorentzian"])
def test_obcc_matches_jax(penalty, with_occ, reference_grads):
    kw = dict(frames=3, penalty=penalty, size_average=False, reference_grads=reference_grads)
    scale = 2.5
    flow, occ, warped, target = group(40, with_occ=with_occ)
    jax_fn, port_fn = jax_make_obcc(JaxPhotoConfig(**kw), scale), make_obcc(PhotoConfig(**kw), scale)
    arrays = dict(flow=flow, occ=occ, w1=warped[0], w2=warped[1], target=target)

    def call(fn):
        return lambda flow, occ, w1, w2, target: fn(flow, None, occ, (w1, w2), target)

    compare_criterion(call(port_fn), call(jax_fn), arrays)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("penalty,size_average", [("L1", False), ("Quadratic", True)])
def test_smoothness_matches_jax(penalty, size_average, reference_grads):
    kw = dict(penalty=penalty, size_average=size_average, reference_grads=reference_grads)
    flow, occ, _, target = group(50)
    for field in (flow, occ):
        compare_criterion(lambda field, target: smoothness(field, target, SmoothConfig(**kw)),
                          lambda field, target: jax_smoothness(field, target, JaxSmoothConfig(**kw)),
                          dict(field=field, target=target))


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("channels", [2, 3])
def test_occ_prior_matches_jax(channels, reference_grads):
    _, occ, _, target = group(60, occ_channels=channels)
    for size_average in (False, True):
        compare_criterion(make_occ_prior(size_average, 1.0, reference_grads),
                          jax_make_occ_prior(size_average, 1.0, reference_grads),
                          dict(occ=occ, target=target))


def test_build_criterions_rejects_unported():
    """What raised NotImplementedError before the remaining criteria were
    ported (BCC, the SSIM family, KL occlusion smoothness, the L2) now
    builds and computes; only a name the JAX factory lacks is refused."""
    base = dict(levels=4, pwc_ws=3, batchSize=2, dataset="synthetic")
    flow, occ, warped, target = group(65)
    flow, occ, target = (torch.tensor(x) for x in (flow, occ, target))
    warped = tuple(torch.tensor(x) for x in warped)
    for kw in (dict(pme_criterion="SSIML1"), dict(pme_criterion="BCC"),
               dict(smooth_occ_penalty="KL")):
        crits = build_criterions(Options(**base, **kw).derive())
        assert torch.isfinite(crits.pme(1.0)(flow, None, occ, warped, target))
        assert torch.isfinite(crits.occ_smooth(occ, target))
    loss, epe = crits.l2(torch.zeros(1, 2, 2, 2), torch.ones(1, 2, 2, 2), torch.ones(1, 2, 2))
    assert loss.item() == pytest.approx(4 * 2 ** 0.5) and epe.shape == (1, 2, 2)   # summed
    with pytest.raises(ValueError, match="pme_criterion"):
        build_criterions(Options(**base, pme_criterion="NCC").derive())


def test_decode_batch_matches_jax():
    rng = np.random.default_rng(70)
    host = {"images": rng.random((2, 4, 6, 9), dtype=np.float32),
            "mask": np.ones((2, 4, 6), np.float32)}
    wire = encode_batch(host, "compact")
    want = jax_decode_batch({k: jnp.asarray(v) for k, v in wire.items()})
    got = decode_batch({k: torch.from_numpy(v) for k, v in wire.items()})
    for k in wire:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    f32 = {"images": torch.from_numpy(host["images"])}
    assert decode_batch(f32) is f32


# ------------------------------------------------------------ multiscale loss

def tiny_options(**kw) -> Options:
    base = dict(levels=4, pwc_ws=3, frames=3, batchSize=2, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32")
    base.update(kw)
    return Options(**base).derive()


@pytest.fixture(scope="module")
def multiscale_case():
    """Port model with seeded weights, its flax tree, a batch, and JAX's
    loss, components and parameter gradients (one value_and_grad jit)."""
    opt = tiny_options()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    images = rand((2, 32, 64, 9), 80)
    model, crits = JaxPWCNet(jax_pwc_config(opt)), jax_build_criterions(opt)

    @jax.jit
    def loss_fn(params, images):
        outputs = model.apply({"params": params}, images)
        return jax_multiscale_loss(outputs, {"images": images}, opt, crits)

    (loss, comps), grads = jax.value_and_grad(loss_fn, has_aux=True)(tree, jnp.asarray(images))
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return opt, net, images, float(loss), {k: float(v) for k, v in comps.items()}, grads


def test_multiscale_loss_and_param_grads_match_jax(multiscale_case):
    opt, net, images, want_loss, want_comps, want_grads = multiscale_case
    net.zero_grad()
    outputs = net(torch.from_numpy(images), with_warped=True)
    loss, comps = multiscale_loss(outputs, {"images": torch.from_numpy(images)}, opt,
                                  build_criterions(opt))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4)
    assert set(comps) == set(want_comps)
    for k, v in comps.items():
        np.testing.assert_allclose(v.item(), want_comps[k], rtol=1e-4, atol=1e-7, err_msg=k)
    loss.backward()
    got_grads = {}
    for name, p in net.named_parameters():
        *mods, leaf = name.split(".")
        want = functools.reduce(lambda d, m: d[m], mods + ["conv"], want_grads)
        want = want["kernel"].transpose(3, 2, 0, 1) if leaf == "weight" else want["bias"]
        got = p.grad.numpy()
        got_grads[name] = got
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    assert len(got_grads) == len(jax.tree_util.tree_leaves(want_grads))


def test_backward_kernel_entry_points_reject_cpu_tensors():
    """The backward ops' CUDA implementations launch kernels only: a CPU
    tensor raises, they never fall back to the twin."""
    x = torch.zeros(1, 4, 4, 2)
    g = torch.zeros(1, 4, 4, 9)
    for kernel in (CV_MODULE._dref_kernel, CV_MODULE._dframe_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(g, x, 3, 1, True, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        WARP_MODULE._dimages_kernel(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        WARP_MODULE._dflow_kernel(x, x, x, True)
