"""CPU tests of the port's ops on row bands (parallel/spatial.py), each
assembled from its bands and held against the unsharded op, which the
other tests hold against the JAX package.

The bands are slots of one process (`ThreadGroup`, S = 2 or 3); each
slot's loss is its band's output against a seeded gradient, and the
gradients are the bands' (assembled) or, for parameters and replicated
inputs, the slots' parts summed. f32; the forward is the unsharded op's
bit for bit where the band computes the same sums (the warp's row window,
the upsample's taps, the cost volume), within 1e-5 of the largest value
where a conv's sums may take another order on a band's shape; gradients
within 1e-5 of the largest.

* `Conv` at stride 1 and 2 (layers.py): a halo of 1 row and no row
  padding.
* `RowLayout.up_bilinear` (models/pwc.py) from a band and from a whole
  level to a band, against `upsample_bilinear2x` (global taps).
* `cost_volume_multi(..., comm=)` at dilation 1 and 2 (1 and 2 frames),
  with the gradients of `ref` and the frames.
* The warp's row window (`y0`) in its three twins, with
  `reference_grads` true and false: the forward and W-dflow equal the
  whole warp's rows, K4's twin sums to the whole image gradient; and the
  op `b2f::warp_bilinear` with `y0` under autograd, as a feature warp
  runs it (`RowLayout.warp`: the source gathered, the band warped).
"""

import numpy as np
import pytest
import torch

from back2future_tpu_torch import ops
from back2future_tpu_torch.models.layers import Conv
from back2future_tpu_torch.models.pwc import RowLayout
from back2future_tpu_torch.parallel.spatial import ThreadGroup, run_slots

torch.set_num_threads(1)


def rand(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32) * scale)


def band_of(x, s, size):
    h = x.shape[1] // size
    return x[:, s * h:(s + 1) * h]


def on_slots(size, fn):
    group = ThreadGroup(size, timeout=60)
    return run_slots([lambda s=s: fn(group.comm(s)) for s in range(size)], [group])


def close(got, want, tol=1e-5):
    assert got.shape == want.shape
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol * scale, (got - want).abs().max().item()


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_on_bands(stride, size):
    conv = Conv(5, 4, stride=stride, generator=torch.Generator().manual_seed(1))
    x = rand((2, 12 * size, 10, 5), 2).requires_grad_()
    want = conv(x)
    g = rand(want.shape, 3)
    want.backward(g)
    want_params = [p.grad.clone() for p in conv.parameters()]

    def slot(comm):
        mine = Conv(5, 4, stride=stride)
        mine.load_state_dict(conv.state_dict())
        band = band_of(x.detach(), comm.index, size).clone().requires_grad_()
        out = mine(band, comm)
        out.backward(band_of(g, comm.index, size))
        return out.detach(), band.grad, [p.grad for p in mine.parameters()]

    results = on_slots(size, slot)
    close(torch.cat([r[0] for r in results], 1), want.detach())
    close(torch.cat([r[1] for r in results], 1), x.grad)
    for i, w in enumerate(want_params):
        close(sum(r[2][i] for r in results), w)


def layout(comm, height, levels=3, halo=1):
    return RowLayout(comm, height, levels, halo)


@pytest.mark.parametrize("from_band", [True, False], ids=["band", "whole"])
def test_upsample_bilinear_on_bands(from_band):
    # 24 rows at level 1: level 2 (12 rows) sharded at halo 1, level 3 (6
    # rows) sharded too, or whole at halo 4 (bands of 3 rows)
    x = rand((2, 6, 7, 2), 4).requires_grad_()
    want = ops.upsample_bilinear2x(x)
    g = rand(want.shape, 5)
    want.backward(g)

    def slot(comm):
        rows = layout(comm, 24, halo=1 if from_band else 4)
        assert rows.plan == ((True, True, True) if from_band else (True, True, False))
        src = x.detach().clone().requires_grad_()
        inp = rows.band(src, 3)
        out = rows.up_bilinear(inp, 3)
        out.backward(band_of(g, comm.index, 2))
        return out.detach(), src.grad

    results = on_slots(2, slot)
    assert torch.equal(torch.cat([r[0] for r in results], 1), want.detach())
    close(sum(r[1] for r in results), x.grad)


@pytest.mark.parametrize("frames", [1, 2], ids=["dilation1", "dilation2"])
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "past"])
def test_cost_volume_on_bands(frames, fwd):
    win, size = 5, 2
    ref = rand((2, 16, 9, 4), 6).requires_grad_()
    others = [rand((2, 16, 9, 4), 7 + k).requires_grad_() for k in range(frames)]
    want = ops.cost_volume_multi(ref, others, win, fwd=fwd)
    g = rand(want.shape, 9)
    want.backward(g)

    def slot(comm):
        r = band_of(ref.detach(), comm.index, size).clone().requires_grad_()
        fs = [band_of(o.detach(), comm.index, size).clone().requires_grad_() for o in others]
        out = ops.cost_volume_multi(r, fs, win, fwd=fwd, comm=comm)
        out.backward(band_of(g, comm.index, size))
        return out.detach(), r.grad, [f.grad for f in fs]

    results = on_slots(size, slot)
    assert torch.equal(torch.cat([r[0] for r in results], 1), want.detach())
    close(torch.cat([r[1] for r in results], 1), ref.grad)
    for k, o in enumerate(others):
        close(torch.cat([r[2][k] for r in results], 1), o.grad)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("c", [3, 8])
def test_warp_row_window_twins(c, reference_grads):
    h, size = 12, 3
    img = rand((2, h, 11, c), 10)
    flow = rand((2, h, 11, 2), 11, scale=5.0)   # reaches past the border and other bands
    g = rand((2, h, 11, c), 12)
    want = ops.warp_bilinear_reference(img, flow)
    want_img, want_flow = ops.warp_bilinear_backward_reference(img, flow, g, reference_grads)
    d_img = torch.zeros_like(img)
    for s in range(size):
        y0, rows = s * h // size, slice(s * h // size, (s + 1) * h // size)
        assert torch.equal(ops.warp_bilinear_reference(img, flow[:, rows], y0), want[:, rows])
        assert torch.equal(ops.warp_dflow_reference(img, flow[:, rows], g[:, rows],
                                                    reference_grads, y0), want_flow[:, rows])
        d_img += ops.warp_dimages_reference(flow[:, rows], g[:, rows], h, y0)
        both = ops.warp_bilinear_backward_reference(img, flow[:, rows], g[:, rows],
                                                    reference_grads, y0)
        assert torch.equal(both[1], want_flow[:, rows])
    close(d_img, want_img)
    # the whole image's window is the plain call
    assert torch.equal(ops.warp_bilinear_reference(img, flow, 0), want)
    assert torch.equal(ops.warp_dimages_reference(flow, g), want_img)
    with pytest.raises(ValueError, match="row window"):
        ops.warp_bilinear(img, flow[:, :4], y0=10)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
def test_feature_warp_on_bands(reference_grads):
    size = 2
    img = rand((2, 16, 9, 6), 13).requires_grad_()
    flow = rand((2, 16, 9, 2), 14, scale=6.0).requires_grad_()
    want = ops.warp_bilinear(img, flow, reference_grads=reference_grads)
    g = rand(want.shape, 15)
    want.backward(g)

    def slot(comm):
        rows = layout(comm, 16, levels=1)
        im = band_of(img.detach(), comm.index, size).clone().requires_grad_()
        fl = band_of(flow.detach(), comm.index, size).clone().requires_grad_()
        out = rows.warp(im, fl, 1, reference_grads)
        out.backward(band_of(g, comm.index, size))
        return out.detach(), im.grad, fl.grad

    results = on_slots(size, slot)
    assert torch.equal(torch.cat([r[0] for r in results], 1), want.detach())
    close(torch.cat([r[1] for r in results], 1), img.grad)
    assert torch.equal(torch.cat([r[2] for r in results], 1), flow.grad)
