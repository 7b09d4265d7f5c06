"""CPU parity of back2future_tpu_torch.ops against back2future_tpu.ops.

The same numpy inputs, made from a seed, go through the JAX op and its
port; on CPU tensors the port runs the plain twin of each CUDA kernel.
Tolerances: 1e-6 for the resampling ops (same taps and f32 sums),
1e-5 for the cost volume (channel sums in another order) and the warp
(the four corner products summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from back2future_tpu.ops import cost_volume as jax_cost_volume
from back2future_tpu.ops import cost_volume_multi as jax_cost_volume_multi
from back2future_tpu.ops import pyramid as jax_pyramid
from back2future_tpu.ops import warp_bilinear as jax_warp_bilinear
from back2future_tpu.ops.cost_volume_pallas import cost_volume_pallas
from back2future_tpu.ops.warp import _corners as jax_corners
from back2future_tpu_torch import ops

torch.set_num_threads(1)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ pyramid

PYRAMID_CASES = {
    "avg_pool2_odd": ("avg_pool2", (2, 9, 11, 3), ()),
    "avg_pool2_even": ("avg_pool2", (1, 8, 12, 4), ()),
    "subsample2": ("subsample2", (1, 7, 6, 2), ()),
    "upsample_nearest2x": ("upsample_nearest2x", (2, 3, 5, 2), ()),
    "upsample_bilinear2x": ("upsample_bilinear2x", (2, 5, 7, 3), ()),
    "resize_bilinear_down_up": ("resize_bilinear", (1, 9, 13, 2), (5, 20)),
    "resize_bilinear_from_1": ("resize_bilinear", (1, 1, 4, 2), (3, 4)),
    "resize_nearest": ("resize_nearest", (1, 7, 9, 2), (3, 20)),
    "spatial_softmax": ("spatial_softmax", (2, 4, 5, 6), ()),
}


@pytest.mark.parametrize("case", sorted(PYRAMID_CASES))
def test_pyramid_matches_jax(case):
    name, shape, args = PYRAMID_CASES[case]
    x = rand(shape, seed=len(case))
    want = np.asarray(getattr(jax_pyramid, name)(jnp.asarray(x), *args))
    got = getattr(ops, name)(torch.from_numpy(x), *args).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------- cost volume

CV_CASES = [(win, dil, fwd) for win in (3, 5, 9) for dil in (1, 2)
            for fwd in (True, False)]


@pytest.fixture(scope="module")
def cv_inputs():
    return rand((2, 10, 12, 8), seed=1), rand((2, 10, 12, 8), seed=2)


@pytest.fixture(scope="module")
def jax_cv(cv_inputs):
    """XLA and Pallas (interpret mode) outputs for every case, once."""
    r, f = map(jnp.asarray, cv_inputs)
    return {case: (np.asarray(jax_cost_volume(r, f, win=case[0], dilation=case[1],
                                              fwd=case[2])),
                   np.asarray(cost_volume_pallas(r, f, *case)))
            for case in CV_CASES}


@pytest.mark.parametrize("win,dilation,fwd", CV_CASES)
def test_cost_volume_reference_matches_jax_and_pallas(cv_inputs, jax_cv, win,
                                                      dilation, fwd):
    r, f = map(torch.from_numpy, cv_inputs)
    got = ops.cost_volume_reference(r, f, win, dilation, fwd).numpy()
    want_xla, want_pallas = jax_cv[(win, dilation, fwd)]
    assert got.shape == (2, 10, 12, win * win)
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)
    # on a CPU tensor the public op is the twin
    np.testing.assert_array_equal(ops.cost_volume(r, f, win, dilation, fwd).numpy(), got)


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("n_frames", [1, 2])
def test_cost_volume_multi_normalisation(n_frames, fwd):
    ref = rand((1, 8, 9, 6), seed=10)
    frames = [rand((1, 8, 9, 6), seed=11 + k) for k in range(n_frames)]
    want = np.asarray(jax_cost_volume_multi(jnp.asarray(ref), [jnp.asarray(f) for f in frames],
                                            5, fwd=fwd))
    got = ops.cost_volume_multi(torch.from_numpy(ref),
                                [torch.from_numpy(f) for f in frames], 5, fwd=fwd).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the normalisation is C * frames over the summed terms
    raw = sum(ops.cost_volume_reference(torch.from_numpy(ref), torch.from_numpy(f), 5,
                                        dilation=k + 1, fwd=fwd).numpy()
              for k, f in enumerate(frames))
    np.testing.assert_allclose(got, raw / (6 * n_frames), rtol=1e-5, atol=1e-6)


def test_cost_volume_rejects_bad_shapes():
    a = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        ops.cost_volume(a, torch.zeros(1, 4, 5, 2), 3)
    with pytest.raises(ValueError):
        ops.cost_volume(a, a, 4)


# -------------------------------------------------------------------- warp

WARP_SCALES = {"subpixel": 0.7, "pixels": 3.0, "far_out_of_range": 40.0}


@pytest.mark.parametrize("scale", sorted(WARP_SCALES))
def test_warp_reference_matches_jax(scale):
    img = rand((2, 9, 13, 5), seed=20)
    flow = rand((2, 9, 13, 2), seed=21, scale=WARP_SCALES[scale])
    want = np.asarray(jax_warp_bilinear(jnp.asarray(img), jnp.asarray(flow)))
    got = ops.warp_bilinear_reference(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_array_equal(
            ops.warp_bilinear(torch.from_numpy(img), torch.from_numpy(flow)).numpy(), got)


def test_warp_bf16_keeps_subpixel_weights():
    """In bf16 the JAX warp builds the pixel grid in bf16 (spacing 2.0 from
    256 to 512), so at width 304 a flow of 0.3 loses its fraction; the
    port computes coordinates in f32."""
    h, w = 2, 304
    img = np.zeros((1, h, w, 1), np.float32)
    img[..., 0] = np.arange(w) % 2            # 0/1 columns: exact in bf16
    flow = np.zeros((1, h, w, 2), np.float32)
    flow[..., 0] = 0.3
    xs = np.arange(255, 262)

    # the JAX fault: x0 collapses onto bf16-representable values, wx == 1
    x0, _, wx, _, _, _ = jax_corners(jnp.asarray(flow, jnp.bfloat16), h, w)
    assert list(np.asarray(x0)[0, 0, xs]) == [255, 256, 256, 258, 260, 260, 260]
    assert np.all(np.asarray(wx, np.float32)[0, 0, xs] == 1.0)

    want = 0.7 * img[0, 0, xs, 0] + 0.3 * img[0, 0, xs + 1, 0]   # 0.7 / 0.3
    timg = torch.from_numpy(img).bfloat16()
    tflow = torch.from_numpy(flow).bfloat16()
    got = ops.warp_bilinear(timg, tflow)[0, 0, xs, 0].float().numpy()
    np.testing.assert_allclose(got, want, atol=4e-3)   # bf16 rounding of 0.7
    jax_got = np.asarray(jax_warp_bilinear(jnp.asarray(img, jnp.bfloat16),
                                           jnp.asarray(flow, jnp.bfloat16)),
                         np.float32)[0, 0, xs, 0]
    assert np.abs(jax_got - want).max() > 0.2


def test_warp_grad_needs_training_slice():
    img = torch.zeros(1, 4, 4, 2, requires_grad=True)
    flow = torch.zeros(1, 4, 4, 2)
    with pytest.raises(NotImplementedError):
        ops.warp_bilinear(img, flow)
    # plain autodiff through the twin is what reference_grads=False asks for
    ops.warp_bilinear(img, flow, reference_grads=False).sum().backward()
    assert img.grad is not None


def test_plain_ops_routing_on_cpu():
    from back2future_tpu_torch.ops.route import use_kernel
    t = torch.zeros(1)
    assert not use_kernel(t)
    with ops.plain_ops():
        assert not use_kernel(t)
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1, device="meta"))
