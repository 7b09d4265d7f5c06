"""The hand-written CUDA kernels against their plain torch twins, on the card.

Every test here needs a CUDA device (marker `gpu`) and skips without
one; run them on a machine with an H100 with
`python -m pytest tests/test_torch_kernels.py -q`.

Tolerances: f32 1e-5 relative (both sum in f32, in another order); bf16
one bf16 rounding of the output (rtol 1e-2), since both sum in f32 and
round once. The warp's image gradient adds with f32 atomics in an order
that varies from run to run: f32 1e-5 of the largest value.
"""

import numpy as np
import pytest
import torch

from back2future_tpu.config import Options
from back2future_tpu_torch import ops
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models import PWCConfig, PWCNet, pwc_config_from_options
from back2future_tpu_torch.runtime import KERNELS, reset_launches
from back2future_tpu_torch.train import create_train_state, make_train_step

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rand(shape, seed, device, dtype=torch.float32, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(device, dtype)


CV_CASES = [(win, dil, fwd) for win in (3, 5, 9) for dil in (1, 2) for fwd in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("win,dil,fwd", CV_CASES)
def test_cost_volume_kernel_matches_twin(cuda, dtype, win, dil, fwd):
    # ragged tile edges (13x37) and a channel count that is not a multiple of 8
    ref = rand((2, 13, 37, 20), 1, cuda, dtype)
    frame = rand((2, 13, 37, 20), 2, cuda, dtype)
    before = KERNELS["b2f_cost_volume_fwd"].launches
    got = ops.cost_volume(ref, frame, win, dil, fwd, scale=0.05)
    assert KERNELS["b2f_cost_volume_fwd"].launches == before + 1
    want = ops.cost_volume_reference(ref, frame, win, dil, fwd, scale=0.05)
    assert got.dtype == dtype and got.shape == (2, 13, 37, win * win)
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 16, 20])
def test_warp_kernel_matches_twin(cuda, dtype, c):
    img = rand((2, 11, 300, c), 3, cuda, dtype)
    flow = rand((2, 11, 300, 2), 4, cuda, dtype, scale=8.0)   # reaches past the border
    before = KERNELS["b2f_warp_bilinear_fwd"].launches
    got = ops.warp_bilinear(img, flow)
    assert KERNELS["b2f_warp_bilinear_fwd"].launches == before + 1
    want = ops.warp_bilinear_reference(img, flow)
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


def test_plain_ops_does_not_launch(cuda):
    ref = rand((1, 8, 8, 8), 5, cuda)
    reset_launches()
    with ops.plain_ops():
        ops.cost_volume(ref, ref, 3)
        ops.warp_bilinear(ref, torch.zeros(1, 8, 8, 2, device=cuda))
    assert all(k.launches == 0 for k in KERNELS.values())


def test_kernel_inputs_are_checked(cuda):
    ref = rand((1, 8, 8, 8), 6, cuda)
    with pytest.raises(TypeError):
        ops.cost_volume(ref.half(), ref.half(), 3)
    with pytest.raises(ValueError):
        ops.cost_volume(ref.transpose(1, 2), ref.transpose(1, 2), 3)
    with pytest.raises(ValueError):
        ops.cost_volume(ref, ref, 11)


def test_model_kernels_match_plain_ops(cuda):
    """One flagship f32 forward: 10 cost-volume and 8 feature-warp launches
    (with_warped=False), and the same outputs as under plain_ops()."""
    net = PWCNet(PWCConfig(), generator=torch.Generator().manual_seed(0)).to(cuda)
    x = rand((2, 64, 128, 9), 7, cuda)
    with torch.inference_mode():
        reset_launches()
        got = net(x, with_warped=False)
        launches = {k: v.launches for k, v in KERNELS.items()}
        with ops.plain_ops():
            want = net(x, with_warped=False)
    assert {k: n for k, n in launches.items() if n} == {"b2f_cost_volume_fwd": 10,
                                                        "b2f_warp_bilinear_fwd": 8}
    for g, w in zip(got, want):
        torch.testing.assert_close(g["flow"], w["flow"], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(g["occ"], w["occ"], rtol=1e-4, atol=1e-4)


def close_to_scale(got, want, dtype):
    """Within the dtype's tolerance, relative to the largest value."""
    tol = TOLS[dtype]["rtol"] * max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype]["rtol"], atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("win,dil,fwd", CV_CASES)
def test_cost_volume_backward_kernels_match_twin(cuda, dtype, win, dil, fwd):
    ref = rand((2, 13, 37, 20), 11, cuda, dtype).requires_grad_()
    frame = rand((2, 13, 37, 20), 12, cuda, dtype).requires_grad_()
    g = rand((2, 13, 37, win * win), 13, cuda, dtype)
    before = {k: KERNELS[k].launches for k in ("b2f_cost_volume_dref", "b2f_cost_volume_dframe")}
    ops.cost_volume(ref, frame, win, dil, fwd, scale=0.05).backward(g)
    for k, n in before.items():
        assert KERNELS[k].launches == n + 1, k
    want_ref, want_frame = ops.cost_volume_backward_reference(
        g, ref.detach(), frame.detach(), win, dil, fwd, scale=0.05)
    assert ref.grad.dtype == dtype
    close_to_scale(ref.grad, want_ref, dtype)
    close_to_scale(frame.grad, want_frame, dtype)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 16, 20])
def test_warp_backward_kernels_match_twin(cuda, dtype, c, reference_grads):
    img = rand((2, 11, 300, c), 14, cuda, dtype).requires_grad_()
    flow = rand((2, 11, 300, 2), 15, cuda, dtype, scale=8.0).requires_grad_()
    g = rand((2, 11, 300, c), 16, cuda, dtype)
    names = ("b2f_warp_bilinear_dimages", "b2f_warp_bilinear_dflow")
    before = {k: KERNELS[k].launches for k in names}
    ops.warp_bilinear(img, flow, reference_grads=reference_grads).backward(g)
    for k in names:
        assert KERNELS[k].launches == before[k] + 1, k
    want_img, want_flow = ops.warp_bilinear_backward_reference(
        img.detach(), flow.detach(), g, reference_grads)
    close_to_scale(img.grad, want_img, dtype)
    close_to_scale(flow.grad, want_flow, dtype)


def test_warp_image_grad_kernel_only_where_needed(cuda):
    img = rand((1, 8, 8, 4), 17, cuda)
    flow = rand((1, 8, 8, 2), 18, cuda).requires_grad_()
    reset_launches()
    ops.warp_bilinear(img, flow).sum().backward()
    assert KERNELS["b2f_warp_bilinear_dimages"].launches == 0
    assert KERNELS["b2f_warp_bilinear_dflow"].launches == 1


def test_train_step_kernels_match_plain_ops(cuda):
    """One f32 train step of the flagship model at 64x128: 10 / 18 / 10 /
    10 / 18 / 8 launches, and the loss and every gradient as under
    plain_ops()."""
    opt = Options(optimize="pme", batchSize=2, compute_dtype="float32").derive()
    crits = build_criterions(opt)
    x = rand((2, 64, 128, 9), 19, cuda)
    grads, losses = [], []
    for plain in (False, True):
        net = PWCNet(pwc_config_from_options(opt),
                     generator=torch.Generator().manual_seed(0)).to(cuda)
        state = create_train_state(net, opt)
        step = make_train_step(net, opt, crits)
        reset_launches()
        if plain:
            with ops.plain_ops():
                _, logs = step(state, {"images": x})
            assert all(k.launches == 0 for k in KERNELS.values())
        else:
            _, logs = step(state, {"images": x})
            assert {k: v.launches for k, v in KERNELS.items()} == {
                "b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 18,
                "b2f_cost_volume_dref": 10, "b2f_cost_volume_dframe": 10,
                "b2f_warp_bilinear_dflow": 18, "b2f_warp_bilinear_dimages": 8}
        losses.append(logs["loss"].item())
        grads.append([p.grad.clone() for p in net.parameters()])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * b.abs().max().item())
