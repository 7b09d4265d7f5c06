"""The hand-written CUDA kernels against their plain torch twins, on the card.

Every test here needs a CUDA device (marker `gpu`) and skips without
one; run them on a machine with an H100 with
`python -m pytest tests/test_torch_kernels.py -q`.

Tolerances: f32 1e-5 relative (both sum in f32, in another order); bf16
one bf16 rounding of the output (rtol 1e-2), since both sum in f32 and
round once.
"""

import numpy as np
import pytest
import torch

from back2future_tpu_torch import ops
from back2future_tpu_torch.models import PWCConfig, PWCNet
from back2future_tpu_torch.runtime import KERNELS, reset_launches

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
    with pytest.raises(NotImplementedError):
        ops.warp_bilinear(ref.requires_grad_(), torch.zeros(1, 8, 8, 2, device=cuda),
                          reference_grads=False)


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
    assert launches == {"b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 8}
    for g, w in zip(got, want):
        torch.testing.assert_close(g["flow"], w["flow"], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(g["occ"], w["occ"], rtol=1e-4, atol=1e-4)
