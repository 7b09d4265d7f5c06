"""The hand-written CUDA kernels against their plain torch twins, on the card.

Every test here needs a CUDA device (marker `gpu`) and skips without
one; run them on a machine with an H100 with
`python -m pytest tests/test_torch_kernels.py -q`.

Tolerances: f32 1e-5 relative (both sum in f32, in another order); bf16
one bf16 rounding of the output (rtol 1e-2), since both sum in f32 and
round once. The warp's image gradient adds with f32 atomics in an order
that varies from run to run: f32 1e-5 of the largest value. The fused
stem (K5, K6) against its twin: bf16 1e-2 of the largest value (the mid
map and the output each round once to bf16, the twin rounds again after
the bias and after leaky). Each `b2f::*` op also passes
`torch.library.opcheck` on CUDA tensors, and the exported flagship
launches the kernels.
"""

import importlib

import numpy as np
import pytest
import torch

from back2future_tpu_torch import ops
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models import (
    ConvUnit, PWCConfig, PWCNet, convert_net_hard_to_soft, pwc_config_from_options,
)
from back2future_tpu_torch.ops.route import DTYPE_CODES, ptr, stream_ptr
from back2future_tpu_torch.runtime import KERNELS, reset_launches
from back2future_tpu_torch.train import create_train_state, make_train_step

pytestmark = pytest.mark.gpu

CV_MODULE = importlib.import_module("back2future_tpu_torch.ops.cost_volume")
WARP_MODULE = importlib.import_module("back2future_tpu_torch.ops.warp")

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


CV_CASES = [(win, dil, fwd) for win in (3, 5, 7, 9) for dil in (1, 2) for fwd in (True, False)]


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


@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "past"])
@pytest.mark.parametrize("scale", [1.0, 30.0], ids=["unit", "x30"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [32, 64, 192])
def test_cost_volume_kernel_main_path_channels(cuda, dtype, c, scale, fwd):
    """K1 at the main path's channel counts (several chunks of 32 for the
    tensor-core kernel), win 9, dil 1, a width that is not a multiple of
    16, inputs up to 30x: bf16 on the tensor cores, f32 on the CUDA cores,
    each within its tolerance of the largest value (at 30x an f32 sum of
    terms near 900 cancels to values far below its terms)."""
    ref = rand((2, 11, 38, c), 31, cuda, dtype, scale=scale)
    frame = rand((2, 11, 38, c), 32, cuda, dtype, scale=scale)
    before = KERNELS["b2f_cost_volume_fwd"].launches
    got = ops.cost_volume(ref, frame, 9, 1, fwd, scale=1.0 / c)
    assert KERNELS["b2f_cost_volume_fwd"].launches == before + 1
    want = ops.cost_volume_reference(ref, frame, 9, 1, fwd, scale=1.0 / c)
    close_to_scale(got, want, dtype)


@pytest.mark.parametrize("offset", [1, 4], ids=["2B", "8B"])
def test_cost_volume_bf16_kernel_unaligned(cuda, offset):
    """Inputs and output that do not start on a 16-byte boundary: the
    tensor-core kernel gathers its chunks by scalar loads and stores the
    ends of each output run element by element."""
    shape = (2, 9, 37, 32)

    def unaligned(seed):
        x = rand(shape, seed, cuda, torch.bfloat16)
        buf = torch.empty(x.numel() + offset, dtype=torch.bfloat16, device=cuda)
        view = buf[offset:].view(shape)
        view.copy_(x)
        return view

    ref, frame = unaligned(33), unaligned(34)
    for win, dil, fwd in ((9, 1, True), (5, 2, False)):
        want = ops.cost_volume_reference(ref, frame, win, dil, fwd, scale=0.1)
        out = torch.empty(want.numel() + offset, dtype=torch.bfloat16, device=cuda)
        got = out[offset:].view(want.shape)
        b, h, w, c = shape
        CV_MODULE._FWD(ptr(ref), ptr(frame), ptr(got), DTYPE_CODES[torch.bfloat16], b, h, w, c,
                       win, dil, int(fwd), 0.1, stream_ptr(ref.device))
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOLS[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("win,dil,fwd", [(9, 1, True), (9, 1, False), (7, 2, True), (3, 1, False)])
def test_cost_volume_cuda_cores_kernel_matches_twin(cuda, dtype, win, dil, fwd):
    """The CUDA-core forward, kept for the A/B, in both dtypes."""
    ref = rand((2, 13, 37, 20), 35, cuda, dtype)
    frame = rand((2, 13, 37, 20), 36, cuda, dtype)
    before = KERNELS["b2f_cost_volume_fwd_cuda_cores"].launches
    got = ops.cost_volume_cuda_cores(ref, frame, win, dil, fwd, scale=0.05)
    assert KERNELS["b2f_cost_volume_fwd_cuda_cores"].launches == before + 1
    want = ops.cost_volume_reference(ref, frame, win, dil, fwd, scale=0.05)
    assert got.dtype == dtype and got.shape == (2, 13, 37, win * win)
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


def test_cost_volume_bf16_kernel_info(cuda):
    info = ops.cost_volume_fwd_bf16_info()
    assert 0 < info["registers"] <= 255 and info["blocks_per_sm"] >= 1, info
    assert info["smem_bytes"] > 0


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


# the gather (csrc/warp_fwd_tiled.cu): its rows kernel at C = 3, lane
# groups with 16-byte packs at the model's widths (32..128) and at 8, and
# single elements where C takes no 16-byte packs (20 in bf16); flows
# i.i.d. at scale 8, smooth, far past the border, and at exact clamp ties
GATHER_CHANNELS = [3, 8, 20, 32, 64, 96, 128]
GATHER_FLOWS = ("random8", "smooth", "far", "ties")
GATHER_NAMES = ("b2f_warp_bilinear_fwd", "b2f_warp_bilinear_fwd_thread")


def gather_flow(kind, shape, seed, device, dtype):
    """`warp_flow`'s kinds, and ties: every source coordinate exactly on
    the border or inside it, by integer offsets (to column 0 or W-1 and
    row 0 or H-1 in turns, or 0-2 pixels away)."""
    if kind != "ties":
        return warp_flow(kind, shape, seed, device, dtype)
    b, h, w = shape
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    to = rng.integers(0, 4, (b, h, w))   # 0: column 0, 1: column W-1, 2: both borders, 3: near
    u = np.where(to == 0, -xs, np.where(to >= 1, w - 1 - xs, 0)).astype(np.float32)
    v = np.where(to == 2, h - 1 - ys, np.where(to == 0, -ys, 0)).astype(np.float32)
    near = to == 3
    u[near] = rng.integers(-2, 3, near.sum())
    v[near] = rng.integers(-2, 3, near.sum())
    return torch.from_numpy(np.stack([u, v], -1)).to(device, dtype)


def gather_launches():
    return tuple(KERNELS[k].launches for k in GATHER_NAMES)


@pytest.mark.parametrize("kind", GATHER_FLOWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", GATHER_CHANNELS)
def test_warp_gather_matches_twin(cuda, dtype, c, kind):
    """The gather against its twin within the dtype's tolerance of the
    largest value; one launch of the path's kernel, none of the first
    design's."""
    img = rand((2, 11, 300, c), 50, cuda, dtype)
    flow = gather_flow(kind, (2, 11, 300), 51, cuda, dtype)
    before = gather_launches()
    got = ops.warp_bilinear(img, flow)
    assert gather_launches() == (before[0] + 1, before[1])
    want = ops.warp_bilinear_reference(img, flow)
    assert got.dtype == dtype and got.shape == img.shape
    close_to_scale(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 32, 128])
def test_warp_gather_grid_stride(cuda, dtype, c):
    """More pixels than the persistent grid takes at once (2.5 times a
    block's 256 threads on every resident block of every SM), B = 1 and a
    width whose stride carries into the next row and image: every thread
    walks several pixels."""
    kernel = {3: "rows", 32: "c32", 128: "c128"}[c]
    info = ops.warp_fwd_tiled_info(kernel, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    npix = int(2.5 * sms * info["blocks_per_sm"] * 256)
    for b in (1, 3):
        w = 301
        h = -(-npix // (b * w))
        img = rand((b, h, w, c), 52, cuda, dtype)
        flow = gather_flow("random8", (b, h, w), 53, cuda, dtype)
        close_to_scale(ops.warp_bilinear(img, flow), ops.warp_bilinear_reference(img, flow),
                       dtype)


@pytest.mark.parametrize("offset", [1, 3], ids=["1el", "3el"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 20, 32, 64])
def test_warp_gather_unaligned(cuda, dtype, c, offset):
    """Image, flow and output offset by `offset` elements from 16-byte
    storage: single-element loads and stores, and single flow loads where
    the flow takes no pair loads."""
    shape = (2, 13, 70, c)
    img = storage_at(rand(shape, 54, cuda, dtype), offset)
    flow = storage_at(gather_flow("smooth", shape[:3], 55, cuda, dtype), offset)
    out = storage_at(torch.zeros(shape, dtype=dtype, device=cuda), offset)
    b, h, w, _ = shape
    WARP_MODULE._FWD(ptr(img), ptr(flow), ptr(out), DTYPE_CODES[dtype], b, h, w, c, h, 0,
                     stream_ptr(img.device))   # the whole image's row window
    torch.cuda.synchronize()
    close_to_scale(out, ops.warp_bilinear_reference(img, flow), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 20, 32])
def test_warp_gather_thread_kernel_matches_twin(cuda, dtype, c):
    """The first design's gather, kept for comparison: against the twin,
    one launch of it and none of the path's kernel."""
    img = rand((2, 11, 300, c), 56, cuda, dtype)
    flow = gather_flow("random8", (2, 11, 300), 57, cuda, dtype)
    before = gather_launches()
    got = ops.warp_bilinear_fwd_thread(img, flow)
    assert gather_launches() == (before[0], before[1] + 1)
    close_to_scale(got, ops.warp_bilinear_reference(img, flow), dtype)


@pytest.mark.parametrize("kernel", list(WARP_MODULE.FWD_TILED_KERNELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_fwd_tiled_kernel_info(cuda, dtype, kernel):
    info = ops.warp_fwd_tiled_info(kernel, dtype)
    assert 0 < info["registers"] <= 255 and info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1 and info["smem_bytes"] == 0, info


def test_warp_gather_thread_kernel_on_no_path(cuda):
    """A serving forward (8 feature warps) and a bf16 train step (8 feature
    and 10 image warps) launch the path's gather and never the first
    design's."""
    net = PWCNet(PWCConfig(), generator=torch.Generator().manual_seed(0)).to(cuda)
    reset_launches()
    with torch.inference_mode():
        net(rand((2, 64, 128, 9), 58, cuda), with_warped=False)
    assert gather_launches() == (8, 0)
    opt = Options(optimize="pme", batchSize=2, compute_dtype="bfloat16").derive()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0)).to(cuda)
    step = make_train_step(net, opt, build_criterions(opt))
    reset_launches()
    step(create_train_state(net, opt), {"images": rand((2, 64, 128, 9), 59, cuda)})
    assert gather_launches() == (18, 0)


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
    _, launches = backward_launches(
        lambda: ops.cost_volume(ref, frame, win, dil, fwd, scale=0.05).backward(g))
    assert launches == {"b2f_cost_volume_dref": 1, "b2f_cost_volume_dframe": 1}
    want_ref, want_frame = ops.cost_volume_backward_reference(
        g, ref.detach(), frame.detach(), win, dil, fwd, scale=0.05)
    assert ref.grad.dtype == dtype
    close_to_scale(ref.grad, want_ref, dtype)
    close_to_scale(frame.grad, want_frame, dtype)


def cv_backward_ops(g, ref, frame, win, dil, fwd, scale, need=(True, True)):
    """(d_ref, d_frame) by the ops `b2f::cost_volume_dref` and
    `b2f::cost_volume_dframe`, each None where `need` says so."""
    args = (win, dil, fwd, scale)
    return (torch.ops.b2f.cost_volume_dref(g, frame, *args) if need[0] else None,
            torch.ops.b2f.cost_volume_dframe(g, ref, *args) if need[1] else None)


def backward_launches(fn):
    """fn's launches of the backward kernels (main and CUDA-core entry
    points), by name, after a synchronise."""
    names = [k for k in KERNELS if k.startswith("b2f_cost_volume_d")]
    before = {k: KERNELS[k].launches for k in names}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: KERNELS[k].launches - n for k, n in before.items() if KERNELS[k].launches > n}


# the train step's levels 3..7 (B=8, 320x640 cut to B=2)
TRAIN_LEVELS = [(80, 160, 32), (40, 80, 64), (20, 40, 96), (10, 20, 128), (5, 10, 192)]


@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "past"])
@pytest.mark.parametrize("scale", [1.0, 30.0], ids=["unit", "x30"])
@pytest.mark.parametrize("level", TRAIN_LEVELS, ids=lambda s: "x".join(map(str, s)))
def test_cost_volume_bf16_backward_train_levels(cuda, level, scale, fwd):
    """K2 and K3 in bf16 at the main path's shapes (win 9, dil 1), inputs
    up to 30x: exactly one d_ref and one d_frame launch, each within 1e-2
    of the largest value of the twin."""
    h, w, c = level
    ref, frame = (rand((2, h, w, c), 40 + k, cuda, torch.bfloat16, scale) for k in range(2))
    g = rand((2, h, w, 81), 42, cuda, torch.bfloat16, scale)
    (d_ref, d_frame), launches = backward_launches(
        lambda: cv_backward_ops(g, ref, frame, 9, 1, fwd, 1.0 / c))
    assert launches == {"b2f_cost_volume_dref": 1, "b2f_cost_volume_dframe": 1}
    want_ref, want_frame = ops.cost_volume_backward_reference(g, ref, frame, 9, 1, fwd, 1.0 / c)
    assert d_ref.dtype == d_frame.dtype == torch.bfloat16
    close_to_scale(d_ref, want_ref, torch.bfloat16)
    close_to_scale(d_frame, want_frame, torch.bfloat16)


@pytest.mark.parametrize("c", [20, 32, 64, 192])
@pytest.mark.parametrize("win,dil,fwd", [(win, dil, fwd) for win in (3, 5, 7, 9)
                                         for dil in (1, 2, 3) for fwd in (True, False)])
def test_cost_volume_bf16_backward_windows(cuda, win, dil, fwd, c):
    """Every window, dilation and direction, ragged 13x37 tiles, C = 20
    (scalar frame staging, a zero tail), 32, 64, 192; one launch alone
    where only one gradient is needed."""
    ref, frame = (rand((2, 13, 37, c), 50 + k, cuda, torch.bfloat16) for k in range(2))
    g = rand((2, 13, 37, win * win), 52, cuda, torch.bfloat16)
    want = ops.cost_volume_backward_reference(g, ref, frame, win, dil, fwd, 0.05)
    for i, need, names in ((0, (True, False), {"b2f_cost_volume_dref": 1}),
                           (1, (False, True), {"b2f_cost_volume_dframe": 1})):
        got, launches = backward_launches(
            lambda: cv_backward_ops(g, ref, frame, win, dil, fwd, 0.05, need=need))
        assert launches == names and got[1 - i] is None
        close_to_scale(got[i], want[i], torch.bfloat16)


def storage_at(x, offset):
    """A copy of x whose storage starts `offset` elements into a buffer."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("offset", [1, 3, 4], ids=["2B", "6B", "8B"])
def test_cost_volume_bf16_backward_unaligned(cuda, offset):
    """g, the features and the gradients starting off a 16-byte boundary:
    the g rows are staged from their shift, the features by scalar loads,
    the gradients stored element by element; and features that are not
    contiguous are refused by the op."""
    shape = (2, 9, 37, 32)
    ref, frame = (storage_at(rand(shape, 60 + k, cuda, torch.bfloat16), offset) for k in range(2))
    b, h, w, c = shape
    for win, dil, fwd in ((9, 1, True), (5, 2, False)):
        g = storage_at(rand((b, h, w, win * win), 62, cuda, torch.bfloat16), offset)
        want_ref, want_frame = ops.cost_volume_backward_reference(g, ref, frame, win, dil, fwd,
                                                                  0.1)
        for kernel, other, want in ((CV_MODULE._DREF, frame, want_ref),
                                    (CV_MODULE._DFRAME, ref, want_frame)):
            got = storage_at(torch.zeros_like(want), offset)
            kernel(ptr(g), ptr(other), ptr(got), DTYPE_CODES[torch.bfloat16], b, h, w, c,
                   win, dil, int(fwd), 0.1, stream_ptr(cuda))
            torch.cuda.synchronize()
            close_to_scale(got, want, torch.bfloat16)
    with pytest.raises(ValueError):
        ops.cost_volume(ref.transpose(1, 2), frame.transpose(1, 2), 9)


@pytest.mark.parametrize("win,dil,fwd", [(9, 1, True), (9, 1, False), (3, 1, True), (7, 2, False),
                                         (5, 3, True), (3, 9, False), (9, 12, True)])
@pytest.mark.parametrize("shape", [(1, 80, 160, 32), (2, 5, 10, 192), (1, 19, 70, 8),
                                   (1, 9, 112, 16), (1, 1, 1, 8), (1, 3, 40, 8)],
                         ids=["l3", "l7", "ragged", "wide", "1x1", "3_rows"])
def test_cost_volume_bf16_backward_halos(cuda, shape, win, dil, fwd):
    """d_frame's haloed g tile (and d_ref's rows) where the halo leaves the
    image on every side, reaches past it altogether, or the image is one
    pixel: every staged value outside the image must be 0."""
    ref, frame = (rand(shape, 70 + k, cuda, torch.bfloat16) for k in range(2))
    g = rand(shape[:3] + (win * win,), 72, cuda, torch.bfloat16)
    got, launches = backward_launches(
        lambda: cv_backward_ops(g, ref, frame, win, dil, fwd, 0.5))
    assert launches == {"b2f_cost_volume_dref": 1, "b2f_cost_volume_dframe": 1}
    want = ops.cost_volume_backward_reference(g, ref, frame, win, dil, fwd, 0.5)
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all()
        close_to_scale(a, b, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("win,dil,fwd", [(9, 1, True), (9, 1, False), (7, 2, True), (3, 3, False)])
def test_cost_volume_backward_cuda_cores_kernels(cuda, dtype, win, dil, fwd):
    """The CUDA-core backward, kept for the A/B, in both dtypes against the
    twin; f32 on the main path runs the same kernels (the same bits)."""
    ref, frame = (rand((2, 13, 37, 20), 80 + k, cuda, dtype) for k in range(2))
    g = rand((2, 13, 37, win * win), 82, cuda, dtype)
    got, launches = backward_launches(
        lambda: ops.cost_volume_backward_cuda_cores(g, ref, frame, win, dil, fwd, 0.05))
    assert launches == {"b2f_cost_volume_dref_cuda_cores": 1,
                        "b2f_cost_volume_dframe_cuda_cores": 1}
    want = ops.cost_volume_backward_reference(g, ref, frame, win, dil, fwd, 0.05)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        close_to_scale(a, b, dtype)
    if dtype == torch.float32:
        main, launches = backward_launches(
            lambda: cv_backward_ops(g, ref, frame, win, dil, fwd, 0.05))
        assert launches == {"b2f_cost_volume_dref": 1, "b2f_cost_volume_dframe": 1}
        for a, b in zip(main, got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dframe", [False, True], ids=["d_ref", "d_frame"])
def test_cost_volume_bwd_bf16_kernel_info(cuda, dframe):
    info = ops.cost_volume_bwd_bf16_info(dframe)
    assert 0 < info["registers"] <= 255 and info["blocks_per_sm"] >= 2, info
    assert info["smem_bytes"] > 0 and info["local_bytes"] == 0


def test_bf16_train_step_launches(cuda):
    """One bf16 train step of the flagship model at 64x128: 10 cost volume,
    18 warp, 10 d_ref, 10 d_frame, 18 flow-gradient and 8
    image-gradient launches; a finite loss."""
    opt = Options(optimize="pme", batchSize=2, compute_dtype="bfloat16").derive()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0)).to(cuda)
    step = make_train_step(net, opt, build_criterions(opt))
    reset_launches()
    _, logs = step(create_train_state(net, opt), {"images": rand((2, 64, 128, 9), 29, cuda)})
    assert {k: v.launches for k, v in KERNELS.items() if v.launches} == {
        "b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 18,
        "b2f_cost_volume_dref": 10, "b2f_cost_volume_dframe": 10,
        "b2f_warp_bilinear_dflow": 18, "b2f_warp_bilinear_dimages": 8}
    assert np.isfinite(logs["loss"].item())


# the warp's backward: channel counts of the image warps (3), the feature
# warps (32..128, slices of K4) and between, and the flows K4's routes
# see: zero, smooth (window route), random (direct), smooth with a few
# outliers (both in one launch), far past the border, and the i.i.d.
# flow of scale 8 that this test held the kernels to first
WARP_CHANNELS = [3, 5, 16, 20, 32, 64, 96, 128]
WARP_FLOWS = ("zero", "smooth", "random", "outliers", "far", "random8")


def warp_flow(kind, shape, seed, device, dtype):
    """A (B, H, W, 2) flow: zero; smooth, a 2x bilinear upsample of a
    coarse random field (1 pixel std at half size); random, i.i.d. at
    scale W/2; outliers, the smooth flow with 8 pixels per image sent 1-2
    widths away; far, the smooth flow moved 2 widths right and 2 heights
    up; random8, i.i.d. at scale 8 (`rand`'s draw of `seed`)."""
    b, h, w = shape
    if kind == "random8":
        return rand((b, h, w, 2), seed, device, dtype, scale=8.0)
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.standard_normal((b, 2, -(-h // 2), -(-w // 2))).astype(
        np.float32))
    smooth = torch.nn.functional.interpolate(coarse, scale_factor=2, mode="bilinear",
                                             align_corners=False)
    flow = smooth[:, :, :h, :w].permute(0, 2, 3, 1).contiguous()
    if kind == "zero":
        flow = torch.zeros_like(flow)
    elif kind == "random":
        flow = torch.from_numpy(rng.standard_normal((b, h, w, 2)).astype(np.float32)) * (w / 2)
    elif kind == "outliers":
        for bi in range(b):
            ys, xs = rng.integers(0, h, 8), rng.integers(0, w, 8)
            flow[bi, ys, xs] = torch.from_numpy(
                (rng.uniform(w, 2 * w, (8, 2)) * rng.choice([-1, 1], (8, 2))).astype(np.float32))
    elif kind == "far":
        flow = flow + torch.tensor([2.0 * w, -2.0 * h])
    return flow.to(device, dtype)


def warp_backward_ops(img, flow, g, need=(True, True)):
    """(d_images, d_flow) by the ops `b2f::warp_dimages` and
    `b2f::warp_dflow` (the reference flow gradient), each None where
    `need` says so."""
    return (torch.ops.b2f.warp_dimages(flow, g) if need[0] else None,
            torch.ops.b2f.warp_dflow(img, flow, g, True) if need[1] else None)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", WARP_FLOWS)
@pytest.mark.parametrize("c", WARP_CHANNELS)
def test_warp_backward_kernels_match_twin(cuda, dtype, c, kind, reference_grads):
    # 11 x 300 leaves partial K4 tiles (16 x 16) in both directions
    img = rand((2, 11, 300, c), 14, cuda, dtype).requires_grad_()
    flow = warp_flow(kind, (2, 11, 300), 15, cuda, dtype).requires_grad_()
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


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)],
                         ids=["both", "d_images", "d_flow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_backward_kernels_where_needed(cuda, dtype, need):
    img = rand((2, 20, 40, 32), 30, cuda, dtype)
    flow = warp_flow("smooth", (2, 20, 40), 31, cuda, dtype)
    g = rand((2, 20, 40, 32), 32, cuda, dtype)
    reset_launches()
    got = warp_backward_ops(img, flow, g, need=need)
    assert KERNELS["b2f_warp_bilinear_dimages"].launches == int(need[0])
    assert KERNELS["b2f_warp_bilinear_dflow"].launches == int(need[1])
    want = ops.warp_bilinear_backward_reference(img, flow, g)
    for n, a, b in zip(need, got, want):
        if n:
            close_to_scale(a, b, dtype)
        else:
            assert a is None


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 20, 32, 64])
def test_warp_backward_kernels_b1_and_offset(cuda, dtype, c, offset):
    """B = 1, with g and the image offset by `offset` elements from an
    aligned buffer: one element reaches the kernels' scalar loads."""
    shape = (1, 13, 70, c)
    n = int(np.prod(shape))

    def shifted(seed):
        buf = rand((n + offset,), seed, cuda, dtype)
        return buf[offset:].view(shape)

    img, g = shifted(33), shifted(34)
    flow = warp_flow("outliers", shape[:3], 35, cuda, dtype)
    got = warp_backward_ops(img, flow, g)
    want = ops.warp_bilinear_backward_reference(img, flow, g)
    for a, b in zip(got, want):
        close_to_scale(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", WARP_FLOWS)
@pytest.mark.parametrize("c", [5, 20, 32, 96])
def test_warp_dimages_routes_agree(cuda, dtype, c, kind):
    """K4 with the window route wherever a block's box fits, against the
    direct route on every block and the twin, on one input (f32 sums in
    another order: 1e-5 of the largest value between the routes). At this
    small grid the path's own choice is the direct route; smooth flows
    take the window route in every block where it is allowed, random ones
    at 32 channels a slice in almost none."""
    shape = (2, 40, 80)
    g = rand(shape + (c,), 36, cuda, dtype)
    flow = warp_flow(kind, shape, 37, cuda, dtype)
    window, n_window, blocks = ops.warp_dimages_routes(flow, g, "window")
    direct, n_direct, _ = ops.warp_dimages_routes(flow, g, "direct")
    _, n_path, _ = ops.warp_dimages_routes(flow, g)
    assert n_direct == n_path == 0
    if kind == "smooth":
        assert n_window == blocks
    if kind == "random" and c >= 32:
        assert n_window < blocks // 10
    torch.testing.assert_close(window, direct, rtol=1e-5,
                               atol=1e-5 * direct.abs().max().item())
    want, _ = ops.warp_bilinear_backward_reference(g, flow, g)
    close_to_scale(window, want.float(), dtype)


@pytest.mark.parametrize("level", [3, 4, 5, 6])
def test_warp_dimages_route_by_grid(cuda, level):
    """The path lets K4's blocks take the window route where the grid holds
    1.5 blocks an SM or more: on the train step's feature warps (B=8,
    320x640) of an H100, levels 3-4 and not 5-6. Smooth flows: there the
    blocks the window route allows (all of them, as a rule) take it, and
    none elsewhere; the result is the twin's."""
    h, w, c = 320 >> (level - 1), 640 >> (level - 1), {3: 32, 4: 64, 5: 96, 6: 128}[level]
    g = rand((8, h, w, c), 42, cuda, torch.bfloat16)
    flow = warp_flow("smooth", (8, h, w), 43, cuda, torch.bfloat16)
    got, n_window, blocks = ops.warp_dimages_routes(flow, g)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks == 8 * -(-h // 16) * -(-w // 16) * -(-c // 32)
    _, fits, _ = ops.warp_dimages_routes(flow, g, "window")
    assert fits > 0 and n_window == (fits if 2 * blocks >= 3 * sms else 0)
    want, _ = ops.warp_bilinear_backward_reference(g, flow, g)
    close_to_scale(got, want.float(), torch.bfloat16)


# K4 at C = 3, the pixel kernel: SPyNet's pme step's image warps (levels
# 7-2 of 320x640; B=2 at the full size, 8 elsewhere)
SPY_LEVELS = [(2 if j == 0 else 8, 320 >> j, 640 >> j) for j in range(6)]


def shifted_rand(shape, seed, device, dtype, offset):
    """`rand` of `shape`, `offset` elements into a buffer of its own (1:
    the pixels' first elements at the other parity, g's pairs unaligned
    where they were aligned)."""
    buf = rand((int(np.prod(shape)) + offset,), seed, device, dtype)
    return buf[offset:].view(shape)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("kind", ["random", "smooth", "outliers"])
@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_dimages_c3_matches_twin(cuda, dtype, level, kind, offset):
    """The op at C = 3 (the pixel kernel, one launch) against the twin at
    SPyNet's six level shapes, with g aligned and at an odd element
    offset."""
    b, h, w = SPY_LEVELS[level]
    g = shifted_rand((b, h, w, 3), 80 + level, cuda, dtype, offset)
    flow = warp_flow(kind, (b, h, w), 81 + level, cuda, dtype)
    reset_launches()
    got = torch.ops.b2f.warp_dimages(flow, g)
    assert KERNELS["b2f_warp_bilinear_dimages"].launches == 1
    assert got.shape == g.shape and got.dtype == dtype and got.is_contiguous()
    close_to_scale(got, ops.warp_dimages_reference(flow, g), dtype)


@pytest.mark.parametrize("kind", ["smooth", "random8", "outliers"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_dimages_c3_row_windows(cuda, dtype, kind):
    """The pixel kernel's row window: bands of 60 rows (y0 = 0, 60, 120)
    of a 180-row image, each against the twin with the same window, and
    summed against the whole image's gradient; by every C = 3 route."""
    h, w = 180, 200
    flow = warp_flow(kind, (2, h, w), 82, cuda, dtype)
    g = rand((2, h, w, 3), 83, cuda, dtype)
    whole = ops.warp_dimages_reference(flow, g.float())
    for route in ("grid", "direct", "window", "quads"):
        total = torch.zeros_like(whole)
        for y0 in (0, 60, 120):
            fl, gb = flow[:, y0:y0 + 60].contiguous(), g[:, y0:y0 + 60].contiguous()
            got, _, _ = ops.warp_dimages_routes(fl, gb, route, h, y0)
            assert got.shape == (2, h, w, 3)
            close_to_scale(got, ops.warp_dimages_reference(fl, gb.float(), h, y0),
                           torch.float32)
            if route == "grid":
                close_to_scale(torch.ops.b2f.warp_dimages(fl, gb, h, y0),
                               ops.warp_dimages_reference(fl, gb, h, y0), dtype)
            total += got
        close_to_scale(total, whole, torch.float32)


@pytest.mark.parametrize("kind", WARP_FLOWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_dimages_c3_routes_agree(cuda, dtype, kind):
    """Every C = 3 route against the quad tiles on the same input, f32
    sums in another order: 1e-5 of the largest value; and through the
    path's wrapper in g's dtype."""
    shape = (8, 80, 160)
    g = rand(shape + (3,), 84, cuda, dtype)
    flow = warp_flow(kind, shape, 85, cuda, dtype)
    old, _, _ = ops.warp_dimages_routes(flow, g, "quads")
    for route in ("grid", "direct", "window"):
        got, _, _ = ops.warp_dimages_routes(flow, g, route)
        torch.testing.assert_close(got, old, rtol=1e-5, atol=1e-5 * old.abs().max().item())
        out = ops.warp_dimages_route(flow, g, route)
        assert out.dtype == dtype and out.shape == g.shape and out.is_contiguous()
        close_to_scale(out, old, dtype)


@pytest.mark.parametrize("kind", ["zero", "smooth", "far"])
@pytest.mark.parametrize("shape", [(1, 7, 13), (2, 9, 35), (1, 3, 2)])
def test_warp_dimages_c3_odd_sizes(cuda, shape, kind):
    """Pixel counts and rows that are not multiples of 4, by every route
    of the pixel kernel, in f32: far flows pile every add on the last
    pixel, whose group of 4 in the window's flush reaches past the
    accumulator's end."""
    flow = warp_flow("random8" if kind == "far" else kind, shape, 90, cuda, torch.float32)
    if kind == "far":
        flow = flow + torch.tensor([3.0 * shape[2], 3.0 * shape[1]], device=cuda)
    g = rand(shape + (3,), 91, cuda)
    want = ops.warp_dimages_reference(flow, g)
    for route in ("grid", "direct", "window"):
        got, n_window, blocks = ops.warp_dimages_routes(flow, g, route)
        assert n_window == (blocks if route == "window" else 0)
        close_to_scale(got, want, torch.float32)


@pytest.mark.parametrize("level", range(6))
def test_warp_dimages_c3_route_counts(cuda, level):
    """The routes' block counts at C = 3 on smooth flows: the pixel kernel
    has a block a 8x32 tile of each image; the path lets them take the
    window route where its grid holds half a block an SM or more, and
    then every block does (their boxes fit); direct on every block none,
    the window wherever it fits all; the quad tiles, 16x16, as before."""
    b, h, w = SPY_LEVELS[level]
    g = rand((b, h, w, 3), 86, cuda, torch.bfloat16)
    flow = warp_flow("smooth", (b, h, w), 87, cuda, torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    blocks = b * -(-h // 8) * -(-w // 32)
    _, n_path, n = ops.warp_dimages_routes(flow, g)
    assert n == blocks and n_path == (blocks if 2 * blocks >= sms else 0)
    assert ops.warp_dimages_routes(flow, g, "direct")[1:] == (0, blocks)
    assert ops.warp_dimages_routes(flow, g, "window")[1:] == (blocks, blocks)
    _, _, n_quads = ops.warp_dimages_routes(flow, g, "quads")
    assert n_quads == b * -(-h // 16) * -(-w // 16)


@pytest.mark.parametrize("c", [4, 32])
def test_warp_dimages_quads_route_is_the_path_off_c3(cuda, c):
    """Off C = 3 the "quads" route is the path's: the quad tiles by their
    grid, the same blocks and the same sums up to their order."""
    g = rand((2, 48, 64, c), 88, cuda)
    flow = warp_flow("smooth", (2, 48, 64), 89, cuda, torch.float32)
    got, n_window, blocks = ops.warp_dimages_routes(flow, g, "quads")
    want, n_path, n = ops.warp_dimages_routes(flow, g)
    assert (n_window, blocks) == (n_path, n) == (n_path, 2 * 3 * 4 * -(-c // 32))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 32])
def test_warp_backward_thread_kernels_match_twin(cuda, dtype, c):
    """The first design's kernels, kept for comparison: against the twin."""
    img, g = rand((2, 11, 300, c), 39, cuda, dtype), rand((2, 11, 300, c), 40, cuda, dtype)
    flow = warp_flow("random", (2, 11, 300), 41, cuda, dtype)
    reset_launches()
    got = ops.warp_bilinear_backward_thread(img, flow, g)
    for name in ("dimages", "dflow"):
        assert KERNELS[f"b2f_warp_bilinear_{name}_thread"].launches == 1
        assert KERNELS[f"b2f_warp_bilinear_{name}"].launches == 0
    want = ops.warp_bilinear_backward_reference(img, flow, g)
    for a, b in zip(got, want):
        close_to_scale(a, b, dtype)


@pytest.mark.parametrize("kernel", ["dimages", "dflow_rows", "dflow_lanes", "dimages_direct",
                                    "dimages_c3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_bwd_tiled_kernel_info(cuda, dtype, kernel):
    info = ops.warp_bwd_tiled_info(kernel, dtype)
    assert 0 < info["registers"] <= 255 and info["local_bytes"] == 0, info
    # K4 in bf16, the model's dtype, keeps 4 blocks on an SM (f32's packs
    # take twice the registers); W-dflow's lane groups hold 5 packs a lane;
    # K4's C = 3 kernel, a pixel a thread, keeps 6 blocks of 256 threads on
    # an SM (40 registers), its window 6 KB of shared memory
    k4 = 4 if dtype == torch.bfloat16 else 2
    want = {"dimages": k4, "dimages_direct": k4, "dflow_rows": 4, "dflow_lanes": 3,
            "dimages_c3": 6}
    assert info["blocks_per_sm"] >= want[kernel], info
    assert (info["smem_bytes"] > 0) == (kernel != "dflow_lanes"), info
    if kernel == "dimages_c3":
        assert info["smem_bytes"] <= 7 << 10, info


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
            assert {k: v.launches for k, v in KERNELS.items() if v.launches} == {
                "b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 18,
                "b2f_cost_volume_dref": 10, "b2f_cost_volume_dframe": 10,
                "b2f_warp_bilinear_dflow": 18, "b2f_warp_bilinear_dimages": 8}
        losses.append(logs["loss"].item())
        grads.append([p.grad.clone() for p in net.parameters()])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * b.abs().max().item())


# ------------------------------------------------------------ fused stem (K5, K6)

# (N, H, W): the serving and train frames at a reduced batch, and a ragged
# size that leaves partial tiles
STEM_SHAPES = [(2, 320, 1216), (2, 320, 640), (1, 37, 70)]


def stem_units(device):
    gen = torch.Generator().manual_seed(21)
    return ConvUnit(3, 16, generator=gen).to(device), ConvUnit(16, 32, generator=gen).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", STEM_SHAPES, ids=["serving", "train", "ragged"])
def test_stem_kernels_match_twin(cuda, dtype, shape):
    unit2, unit3 = stem_units(cuda)
    x = rand(shape + (3,), 22, cuda, dtype)
    reset_launches()
    with torch.no_grad():
        f2, f3 = ops.fused_stem(x, unit2, unit3)
        want2, want3 = ops.stem_reference(x, ops.unit_params(unit2), ops.unit_params(unit3))
    assert KERNELS["b2f_stem_unit_a"].launches == 1 and KERNELS["b2f_stem_unit_b"].launches == 1
    n, h, w = shape
    assert f2.shape == (n, (h + 1) // 2, (w + 1) // 2, 16) and f2.dtype == dtype
    assert f3.shape == (n, (h + 3) // 4, (w + 3) // 4, 32) and f3.dtype == dtype
    close_to_scale(f2, want2, dtype)
    close_to_scale(f3, want3, dtype)


# (N, H, W) of K6's input, for its 8 x 32 output tiles: Wo % 32 of 1 and
# 31, Ho % 8 not 0, odd H and W, N = 1, a single pixel, and the full
# serving frame batch (3 x B=16 frames at 160 x 608)
UNIT_B_SHAPES = [(1, 25, 65), (3, 10, 62), (2, 17, 125), (1, 1, 1), (48, 160, 608)]


@pytest.mark.parametrize("scale", [1.0, 30.0], ids=["unit", "x30"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", UNIT_B_SHAPES, ids=["ho13_wo33", "ho5_wo31", "ho9_wo63",
                                                      "1x1", "serving48"])
def test_stem_unit_b_kernel_matches_twin(cuda, dtype, shape, scale):
    """K6 alone (bf16 on the tensor cores, f32 on the CUDA cores, whose
    1e-5 a TF32 product would miss) against the twin, inputs up to 30x so
    that the mid map's rounding is tested at scale."""
    _, unit3 = stem_units(cuda)
    x = rand(shape + (16,), 29, cuda, dtype, scale=scale)
    p = ops.unit_params(unit3)
    before = KERNELS["b2f_stem_unit_b"].launches
    with torch.no_grad():
        got = ops.stem_unit_cuda(x, p, "b")
        want = ops.unit_reference(x, p)
    assert KERNELS["b2f_stem_unit_b"].launches == before + 1
    n, h, w = shape
    assert got.shape == (n, (h + 1) // 2, (w + 1) // 2, 32) and got.dtype == dtype
    close_to_scale(got, want, dtype)


# (N, H, W) of K5's input, for its 8 x 32 output tiles: Wo % 32 of 1 and
# 31, Ho % 8 not 0, odd H and W, W % 8 of 1 to 7 (a global row then starts
# at every 16-byte misalignment of the 6-byte pixels, and the kernel reads
# element by element), a single pixel, and the full serving frame batch
# (3 x B=16 frames at 320 x 1216)
UNIT_A_SHAPES = [(1, 17, 65), (2, 10, 62), (1, 33, 130), (1, 21, 123), (3, 12, 124),
                 (1, 9, 69), (1, 14, 63), (1, 1, 1), (48, 320, 1216)]


@pytest.mark.parametrize("scale", [1.0, 30.0], ids=["unit", "x30"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", UNIT_A_SHAPES, ids=["ho9_wo33_w8r1", "ho5_wo31_w8r6",
                                                      "wo65_w8r2", "w8r3", "w8r4", "w8r5",
                                                      "w8r7", "1x1", "serving48"])
def test_stem_unit_a_kernel_matches_twin(cuda, dtype, shape, scale):
    """K5 alone (bf16 on the tensor cores, f32 on the CUDA cores, whose
    1e-5 a TF32 product would miss) against the twin, inputs up to 30x so
    that the mid map's rounding is tested at scale."""
    unit2, _ = stem_units(cuda)
    x = rand(shape + (3,), 30, cuda, dtype, scale=scale)
    p = ops.unit_params(unit2)
    before = KERNELS["b2f_stem_unit_a"].launches
    with torch.no_grad():
        got = ops.stem_unit_cuda(x, p, "a")
        want = ops.unit_reference(x, p)
    assert KERNELS["b2f_stem_unit_a"].launches == before + 1
    n, h, w = shape
    assert got.shape == (n, (h + 1) // 2, (w + 1) // 2, 16) and got.dtype == dtype
    close_to_scale(got, want, dtype)


@pytest.mark.parametrize("offset", [1, 3, 5], ids=["2B", "6B", "10B"])
def test_stem_unit_a_bf16_kernel_unaligned(cuda, offset):
    """An input that does not start on a 16-byte boundary (W % 8 == 0):
    the tensor-core kernel reads it element by element."""
    unit2, _ = stem_units(cuda)
    shape = (2, 19, 128, 3)
    x = rand(shape, 31, cuda, torch.bfloat16)
    buf = torch.empty(x.numel() + offset, dtype=torch.bfloat16, device=cuda)
    view = buf[offset:].view(shape)
    view.copy_(x)
    p = ops.unit_params(unit2)
    with torch.no_grad():
        got = ops.stem_unit_cuda(view, p, "a")
        want = ops.unit_reference(x, p)
    close_to_scale(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stem_unit_a_cuda_cores_kernel(cuda, dtype):
    """K5's CUDA-core kernel, kept for the comparison: within tolerance of
    the twin in both dtypes, and in f32 bit for bit the main path's K5
    (the same kernel)."""
    unit2, _ = stem_units(cuda)
    x = rand((2, 37, 70, 3), 32, cuda, dtype)
    p = ops.unit_params(unit2)
    before = KERNELS["b2f_stem_unit_a_cuda_cores"].launches
    with torch.no_grad():
        got = ops.stem_unit_a_cuda_cores(x, p)
        want = ops.unit_reference(x, p)
        main = ops.stem_unit_cuda(x, p, "a")
    assert KERNELS["b2f_stem_unit_a_cuda_cores"].launches == before + 1
    assert got.shape == main.shape and got.dtype == dtype
    close_to_scale(got, want, dtype)
    if dtype == torch.float32:
        assert torch.equal(got, main)


def test_stem_unit_a_bf16_kernel_info(cuda):
    from back2future_tpu_torch.ops.stem import stem_unit_a_bf16_info

    info = stem_unit_a_bf16_info()
    assert 0 < info["registers"] <= 128 and info["local_bytes"] == 0, info   # no spills
    assert info["blocks_per_sm"] >= 2 and info["smem_bytes"] > 0, info


def test_stem_backward_is_the_twin_chain(cuda):
    """Gradients of x and the 8 parameters through the kernels' ops
    equal autograd through the twin chain (the backward recomputes it)."""
    unit2, unit3 = stem_units(cuda)
    x = rand((1, 32, 64, 3), 23, cuda).requires_grad_()
    g2, g3 = rand((1, 16, 32, 16), 24, cuda), rand((1, 8, 16, 32), 25, cuda)
    params = [*ops.unit_params(unit2), *ops.unit_params(unit3)]
    f2, f3 = ops.fused_stem(x, unit2, unit3)
    got = torch.autograd.grad((f2, f3), [x, *params], (g2, g3))
    w2, w3 = ops.stem_reference(x, params[:4], params[4:])
    want = torch.autograd.grad((w2, w3), [x, *params], (g2, g3))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())


def test_stem_kernel_inputs_are_checked(cuda):
    unit2, unit3 = stem_units(cuda)
    x = rand((1, 16, 64, 3), 26, cuda)
    with pytest.raises(TypeError):
        ops.stem_unit_cuda(x.half(), ops.unit_params(unit2), "a")
    with pytest.raises(ValueError):
        ops.stem_unit_cuda(x, ops.unit_params(unit3), "a")
    with pytest.raises(ValueError):
        ops.stem_unit_cuda(x.cpu(), ops.unit_params(unit2), "a")


def test_model_with_stem_matches_stem_off(cuda, monkeypatch):
    """The f32 flagship forward with B2F_STEM_PALLAS=1: one K5 and one K6
    launch beside the 10 + 8, and the outputs of the stem-off forward."""
    net = PWCNet(PWCConfig(), generator=torch.Generator().manual_seed(0)).to(cuda)
    x = rand((2, 64, 128, 9), 27, cuda)
    with torch.inference_mode():
        monkeypatch.setenv("B2F_STEM_PALLAS", "0")
        want = net(x, with_warped=False)
        monkeypatch.setenv("B2F_STEM_PALLAS", "1")
        reset_launches()
        got = net(x, with_warped=False)
    assert {k: v.launches for k, v in KERNELS.items() if v.launches} == {
        "b2f_stem_unit_a": 1, "b2f_stem_unit_b": 1,
        "b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 8}
    for g, w in zip(got, want):
        torch.testing.assert_close(g["flow"], w["flow"], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(g["occ"], w["occ"], rtol=1e-4, atol=1e-4)


def test_soft_train_step_kernels_match_plain_ops(cuda, monkeypatch):
    """One f32 step of the soft recipe (OBGCC, past_flow, const_vel,
    second-order smoothness) from a hard net by surgery, with the fused
    stem on: the loss and every gradient as under plain_ops()."""
    monkeypatch.setenv("B2F_STEM_PALLAS", "1")
    hard_opt = Options(optimize="pme", batchSize=2, compute_dtype="float32").derive()
    opt = Options(optimize="pme", batchSize=2, compute_dtype="float32", pme_criterion="OBGCC",
                  past_flow=True, const_vel=1.0, smooth_second_order=True).derive()
    crits = build_criterions(opt)
    x = rand((2, 64, 128, 9), 28, cuda)
    hard = PWCNet(pwc_config_from_options(hard_opt), generator=torch.Generator().manual_seed(0))
    grads, losses = [], []
    for plain in (False, True):
        net = convert_net_hard_to_soft(hard, PWCNet(pwc_config_from_options(opt))).to(cuda)
        step = make_train_step(net, opt, crits)
        reset_launches()
        if plain:
            with ops.plain_ops():
                _, logs = step(create_train_state(net, opt), {"images": x})
            assert all(k.launches == 0 for k in KERNELS.values())
        else:
            _, logs = step(create_train_state(net, opt), {"images": x})
            assert KERNELS["b2f_stem_unit_a"].launches == 1
            assert KERNELS["b2f_stem_unit_b"].launches == 1
        losses.append(logs["loss"].item())
        grads.append([p.grad.clone() for p in net.parameters()])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * b.abs().max().item())


# ------------------------------------------------ the loader's device prefetch

def test_device_prefetch_pinned_side_stream(cuda):
    """`data.loader.device_prefetch` on the card: each batch is staged in
    pinned host memory and copied on a side stream, the consumer's stream
    waits for the copy, and the tensors equal a synchronous copy."""
    from back2future_tpu_torch.data import loader

    rng = np.random.default_rng(0)
    host = [{"images": rng.integers(0, 256, (2, 32, 64, 9), dtype=np.uint8),
             "flow_gt": rng.standard_normal((2, 32, 64, 2)).astype(np.float16),
             "mask": rng.random((2, 32, 64), dtype=np.float32)} for _ in range(5)]
    side = torch.cuda.Stream(cuda)
    loader._stage(host[0], cuda, side)      # warms the pinned host allocator
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(5e8))        # keeps the side stream busy a while
    pinned, dev, done = loader._stage(host[0], cuda, side)
    assert all(t.is_pinned() for t in pinned.values())
    assert not done.query()                # the copies queue behind the side stream's work
    assert torch.cuda.current_stream(cuda).query()   # ... and not on the consumer's stream
    got = loader._release((pinned, dev, done), cuda)
    after = torch.cuda.Event()
    after.record()
    assert not after.query()               # the consumer's stream waits for the copies
    torch.cuda.synchronize()
    for k, v in host[0].items():
        assert torch.equal(got[k], torch.from_numpy(v).to(cuda)), k

    staged = list(loader.device_prefetch(iter(host), cuda, depth=2))
    torch.cuda.synchronize()
    assert len(staged) == len(host)
    for got, want in zip(staged, host):
        for k, v in want.items():
            assert got[k].device.type == "cuda" and got[k].dtype == torch.from_numpy(v).dtype
            assert torch.equal(got[k], torch.from_numpy(v).to(cuda)), k


# ------------------------------------------- the eval step, init(path), the drain

EVAL_LAUNCHES = {"b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 18}


def gt_batch(device, seed=31, b=2, h=64, w=128):
    rng = np.random.default_rng(seed)
    return {"images": rand((b, h, w, 9), seed, device),
            "flow_gt": rand((b, h, w, 2), seed + 1, device, scale=0.2),
            "occ_gt": torch.from_numpy(rng.choice(np.array([0.0, 0.5, 1.0], np.float32),
                                                  (b, h, w, 2))).to(device),
            "mask": torch.from_numpy((rng.random((b, h, w)) > 0.1).astype(np.float32)).to(device)}


def test_eval_step_launches_and_matches_plain_ops(cuda):
    """The eval step of the flagship model (f32, 64x128, ground truth):
    10 cost volume and 18 warp launches (8 feature warps, 10 image warps)
    and no backward kernel; its logs as under plain_ops() (rtol 1e-4; the
    occlusion accuracies atol 1e-3, a few of 16384 pixels whose decode
    sits at a tie)."""
    from back2future_tpu_torch.train import make_eval_step

    opt = Options(optimize="pme", batchSize=2, compute_dtype="float32", ground_truth=True).derive()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0)).to(cuda)
    eval_step = make_eval_step(net, opt, build_criterions(opt))
    batch = gt_batch(cuda)
    reset_launches()
    logs = eval_step(batch)
    assert {k: v.launches for k, v in KERNELS.items() if v.launches} == EVAL_LAUNCHES
    reset_launches()
    with ops.plain_ops():
        want = eval_step(batch)
    assert all(k.launches == 0 for k in KERNELS.values())
    assert set(logs) == set(want) and "occ_f1" in logs
    for k in want:
        np.testing.assert_allclose(logs[k].item(), want[k].item(), rtol=1e-4, atol=1e-3, err_msg=k)


def test_init_path_serves_pt_written_on_card(cuda, tmp_path):
    """A bf16 checkpoint saved on the card serves through init(path): the
    config's dtype, 10 cost volume and 8 warp launches a forward, and the
    flow of the module's own forward on the same input, bit for bit."""
    from back2future_tpu_torch import api
    from back2future_tpu_torch.train.checkpoint import save_checkpoint

    opt = Options(optimize="pme", batchSize=2, compute_dtype="bfloat16").derive()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(3)).to(cuda)
    save_checkpoint(tmp_path, create_train_state(net, opt), opt, 1)
    est = api.init(str(tmp_path), device="cuda")
    assert est.config.dtype == torch.bfloat16 and est.device.type == "cuda"
    rng = np.random.default_rng(4)
    frames = [rng.random((2, 70, 140, 3), dtype=np.float32) for _ in range(3)]
    imgs, n, h, w = api._preprocess_triplets(frames, 3)
    x = torch.from_numpy(imgs).to(cuda)
    reset_launches()
    with torch.inference_mode():
        got = est.net(x, with_warped=False)[0]
        assert {k: v.launches for k, v in KERNELS.items() if v.launches} == {
            "b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 8}
        want = net(x, with_warped=False)[0]
    assert torch.equal(got["flow"], want["flow"]) and torch.equal(got["occ"], want["occ"])
    flows, fwd_occ, bwd_occ = est.compute_flow_batch(*frames)
    ref = api._postprocess_results(want["flow"].float().cpu().numpy(),
                                   want["occ"].float().cpu().numpy(), n, h, w)
    assert np.array_equal(flows, ref[0]) and np.array_equal(fwd_occ, ref[1])


# ------------------------------------------------------------------ SPyNet

# levels 4, frames 3: 2 frames x levels 2-4 input warps a forward; the pme
# step adds 2 x 4 output warps, K4 on the 6 whose images are warped frames
SPY_SERVING = {"b2f_warp_bilinear_fwd": 6}
SPY_PME = {"b2f_warp_bilinear_fwd": 14, "b2f_warp_bilinear_dimages": 6,
           "b2f_warp_bilinear_dflow": 14}


def test_spynet_forward_launches_and_matches_plain_ops(cuda):
    """The bf16 SPyNet forward (levels 4, B=2 at 64x128) without the output
    warps: 6 gathers and no other kernel; the finest flow within 5% of
    max|flow| of its plain_ops() rerun (bf16 roundings through 4 levels)."""
    from back2future_tpu_torch.models import SPyNet, SPyNetConfig

    net = SPyNet(SPyNetConfig(levels=4, dtype=torch.bfloat16),
                 generator=torch.Generator().manual_seed(1)).to(cuda)
    x = rand((2, 64, 128, 9), 41, cuda)
    reset_launches()
    with torch.inference_mode():
        got = net(x, with_warped=False)
        assert {k: v.launches for k, v in KERNELS.items() if v.launches} == SPY_SERVING
        with ops.plain_ops():
            want = net(x, with_warped=False)
    assert len(got) == 4 and got[0]["warped"] == []
    flow, flow_p = got[0]["flow"].float(), want[0]["flow"].float()
    assert (flow - flow_p).abs().max().item() <= 0.05 * flow_p.abs().max().item()


def test_spynet_pme_step_launches_and_matches_plain_ops(cuda):
    """One f32 pme step of SPyNet (levels 4, B=2 at 64x128): 14 gathers, 6
    K4 and 14 W-dflow; the loss (rtol 1e-4) and every parameter gradient
    (1e-3 of its max|g|) as under plain_ops() from the same state."""
    from back2future_tpu_torch.models import SPyNet, spynet_config_from_options

    opt = Options(netType="spynet", levels=4, optimize="pme", batchSize=2,
                  compute_dtype="float32").derive()
    net = SPyNet(spynet_config_from_options(opt), generator=torch.Generator().manual_seed(2)).to(cuda)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    batch = {"images": rand((2, 64, 128, 9), 43, cuda)}
    results = []
    for plain in (False, True):
        net.load_state_dict(init)
        step = make_train_step(net, opt, build_criterions(opt))
        reset_launches()
        if plain:
            with ops.plain_ops():
                _, logs = step(create_train_state(net, opt), batch)
            assert all(k.launches == 0 for k in KERNELS.values())
        else:
            _, logs = step(create_train_state(net, opt), batch)
            assert {k: v.launches for k, v in KERNELS.items() if v.launches} == SPY_PME
        results.append((logs["loss"].item(), {n: p.grad.clone() for n, p in net.named_parameters()}))
    (loss, grads), (loss_p, grads_p) = results
    assert loss == pytest.approx(loss_p, rel=1e-4)
    for name, want in grads_p.items():
        assert (grads[name] - want).abs().max().item() <= 1e-3 * want.abs().max().item(), name


def test_metric_drain_does_not_synchronise(cuda):
    """The loop's drain: a step's logs go to pinned host memory by a
    non-blocking copy; no train step nor the copies call
    cudaStreamSynchronize or cudaDeviceSynchronize, and reading the
    oldest copy waits on its event only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from back2future_tpu_torch.train.loop import _read, _to_host

    opt = Options(optimize="pme", batchSize=2, compute_dtype="bfloat16", ground_truth=True).derive()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0)).to(cuda)
    state = create_train_state(net, opt)
    step = make_train_step(net, opt, build_criterions(opt))
    batch = gt_batch(cuda)
    state, logs = step(state, batch)          # warm-up: allocator, cuDNN plans
    _read(_to_host(logs))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pending = []
        with record_function("window"):
            for _ in range(3):
                state, logs = step(state, batch)
                pending.append(_to_host(logs))
        names, host, done = pending[0]
        assert host.is_pinned() and host.device.type == "cpu"
    # the profiler's own exit synchronises the device: only the window counts
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    window = next(e.time_range for e in events if e.name == "window")
    inside = [e for e in events if window.start <= e.time_range.start <= window.end]
    assert any("LaunchKernel" in e.name for e in inside)
    syncs = [e.name for e in inside if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]
    assert not syncs, syncs
    read = [_read(p) for p in pending]
    assert all(set(r) == set(names) and np.isfinite(list(r.values())).all() for r in read)
    assert read[-1]["loss"] == logs["loss"].item()


# ------------------------------------------------------------ the custom ops

def op_cases(device, dtype):
    """(op name, args) of every b2f op at small shapes, on the card."""
    unit2, unit3 = stem_units(device)
    cv, wp = (2, 9, 37, 32), (2, 9, 37, 20)
    g_cv = rand(cv[:3] + (81,), 40, device, dtype)
    images, flow, g = rand(wp, 41, device, dtype), rand(wp[:3] + (2,), 42, device, dtype, 3.0), \
        rand(wp, 43, device, dtype)
    return {
        "cost_volume": (rand(cv, 44, device, dtype).requires_grad_(),
                        rand(cv, 45, device, dtype).requires_grad_(), 9, 2, False, 0.05),
        "cost_volume_dref": (g_cv, rand(cv, 46, device, dtype), 9, 1, True, 0.5),
        "cost_volume_dframe": (g_cv, rand(cv, 47, device, dtype), 9, 1, False, 0.5),
        "warp_bilinear": (images.clone().requires_grad_(), flow.clone().requires_grad_(), True),
        "warp_dimages": (flow, g),
        "warp_dflow": (images, flow, g, False),
        "stem": (rand((1, 16, 64, 3), 48, device, dtype).requires_grad_(),
                 *ops.unit_params(unit2), *ops.unit_params(unit3)),
    }


OP_NAMES = ("cost_volume", "cost_volume_dref", "cost_volume_dframe", "warp_bilinear",
            "warp_dimages", "warp_dflow", "stem")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", OP_NAMES)
def test_op_opcheck_on_cuda(cuda, dtype, name):
    """opcheck of each op on CUDA tensors: the schema, the autograd
    registration, the fake against the kernel's output, and eager against
    AOT dispatch (f32 at rtol 1e-5: K4's atomics sum in a varying order)."""
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else {}
    result = torch.library.opcheck(getattr(torch.ops.b2f, name).default,
                                   op_cases(cuda, dtype)[name], **tol)
    assert set(result.values()) == {"SUCCESS"}, result


def test_op_launch_failure_raises(cuda, monkeypatch):
    """A kernel that fails to launch raises through the op; it never falls
    back to the twin."""
    def failing(*args):
        raise RuntimeError("b2f_cost_volume_fwd: CUDA error 1 (invalid argument)")

    monkeypatch.setattr(CV_MODULE, "_FWD", failing)
    x = rand((1, 8, 16, 32), 50, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.cost_volume(x, x, 9)


def test_exported_forward_launches_the_kernels(cuda, tmp_path):
    """The flagship (bf16, seed 0) exported on the card and served by
    load_exported: 10 K1 and 8 gathers a call, results equal to the live
    estimator's bit for bit."""
    from back2future_tpu_torch import api

    est = api.init(None, device="cuda", seed=0)
    est.export(tmp_path / "art", [(2, 64, 128)])
    served = api.load_exported(tmp_path / "art", device="cuda")
    rng = np.random.default_rng(51)
    stacks = [rng.random((2, 64, 128, 3), dtype=np.float32) for _ in range(3)]
    want = est.compute_flow_batch(*stacks)
    reset_launches()
    got = served.compute_flow_batch(*stacks)
    launched = {k: v.launches for k, v in KERNELS.items() if v.launches}
    assert launched == {"b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 8}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exported for device 'cuda'"):
        api.load_exported(tmp_path / "art", device="cpu")


# ------------------------------------------------------- data parallelism

TRAIN_LAUNCHES = {"b2f_cost_volume_fwd": 10, "b2f_warp_bilinear_fwd": 18,
                  "b2f_cost_volume_dref": 10, "b2f_cost_volume_dframe": 10,
                  "b2f_warp_bilinear_dflow": 18, "b2f_warp_bilinear_dimages": 8}


def test_ddp_nccl_world1_step_matches_plain_step(cuda, monkeypatch):
    """One f32 step of the flagship at 64x128 through DDP in an NCCL
    group of one rank (joined from the B2F_* spec) against the same step
    without a group: the kernels' launches, the loss and every gradient
    (1e-3 of max|g|: K4's f32 atomics add in a varying order)."""
    import torch.distributed as dist

    from back2future_tpu_torch.parallel import distributed
    from back2future_tpu_torch.parallel.launch import free_port

    opt = Options(optimize="pme", batchSize=2, compute_dtype="float32").derive()
    crits = build_criterions(opt)
    x = rand((2, 64, 128, 9), 23, cuda)
    results = []
    for group in (False, True):
        if group:
            monkeypatch.setenv("B2F_COORDINATOR", f"127.0.0.1:{free_port()}")
            monkeypatch.setenv("B2F_NUM_PROCESSES", "1")
            monkeypatch.setenv("B2F_PROCESS_ID", "0")
            distributed.initialize_multihost()
        try:
            net = PWCNet(pwc_config_from_options(opt),
                         generator=torch.Generator().manual_seed(0)).to(cuda)
            step = make_train_step(net, opt, crits)
            assert isinstance(step.forward, torch.nn.parallel.DistributedDataParallel) == group
            reset_launches()
            _, logs = step(create_train_state(net, opt), {"images": x})
            assert {k: v.launches for k, v in KERNELS.items() if v.launches} == TRAIN_LAUNCHES
            assert not group or dist.get_backend() == "nccl"
            results.append((logs["loss"].item(), [p.grad.clone() for p in net.parameters()]))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    (loss_a, grads_a), (loss_b, grads_b) = results
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-6)
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-3 * a.abs().max().item())


def test_mesh_serving_two_replicas_of_cuda0(cuda):
    """The flagship served on a mesh of two replicas of cuda:0: a batch
    of 3 padded to 4 and trimmed, each slice's forward 10 K1 and 8
    gathers, the results as the single-device estimator's (f32)."""
    from back2future_tpu_torch import api
    from back2future_tpu_torch.parallel import make_mesh

    one = api.init(None, device="cuda", dtype="float32", seed=2)
    mesh_est = api.init(None, dtype="float32", seed=2, mesh=make_mesh(["cuda:0", "cuda:0"]))
    frames = [np.random.default_rng(i).random((3, 96, 200, 3), dtype=np.float32)
              for i in range(3)]
    want = one.compute_flow_batch(*frames)
    reset_launches()
    got = mesh_est.compute_flow_batch(*frames)
    assert {k: v.launches for k, v in KERNELS.items() if v.launches} == {
        "b2f_cost_volume_fwd": 20, "b2f_warp_bilinear_fwd": 16}
    assert got[0].shape == want[0].shape == (3, 96, 200, 2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 * np.abs(want[0]).max())
    for g, w in zip(got[1:], want[1:]):
        assert (g != w).mean() <= 1e-3


def test_dryrun_multichip_gloo_ranks_share_the_card(cuda):
    """dryrun_multichip(2, backend="gloo"): 2 ranks on cuda:0, one f32
    hard step each with the train step's launches, one global loss."""
    from back2future_tpu_torch.graft_entry import dryrun_multichip

    results = dryrun_multichip(2, soft=False, backend="gloo", timeout=600)
    assert len(results) == 2
    losses = [r[0]["loss"] for r in results]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    for r in results:
        assert r[0]["device"] == "cuda:0" and r[0]["launches"] == TRAIN_LAUNCHES


# the row window (y0, H_src) of the gather, K4 and W-dflow: a flow of
# rows y0 .. y0 + h - 1 of an image of H_src rows, as a row-sharded
# feature warp launches them (parallel/spatial.py); 3 bands of 8 rows of
# a 24-row image, partial K4 tiles across W
@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("kind", ["smooth", "random8", "outliers"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 32, 64])
def test_warp_row_window_kernels(cuda, dtype, c, kind, reference_grads):
    """Each band's gather and W-dflow against their twins, and bit for bit
    against the rows of the whole image's launch; the bands' K4 image
    gradients against the twin's and, summed, against the whole launch's
    within the dtype's tolerance (f32 atomics in another order)."""
    h, w, bands = 24, 70, 3
    img = rand((2, h, w, c), 70, cuda, dtype)
    flow = warp_flow(kind, (2, h, w), 71, cuda, dtype)
    g = rand((2, h, w, c), 72, cuda, dtype)
    whole = ops.warp_bilinear(img, flow)
    whole_dflow = torch.ops.b2f.warp_dflow(img, flow, g, reference_grads)
    whole_dimg = torch.ops.b2f.warp_dimages(flow, g).float()
    total = torch.zeros_like(whole_dimg)
    for s in range(bands):
        y0, rows = s * h // bands, slice(s * h // bands, (s + 1) * h // bands)
        fl, gb = flow[:, rows].contiguous(), g[:, rows].contiguous()
        reset_launches()
        out = ops.warp_bilinear(img, fl, y0=y0)
        d_flow = torch.ops.b2f.warp_dflow(img, fl, gb, reference_grads, y0)
        d_img = torch.ops.b2f.warp_dimages(fl, gb, h, y0)
        for k in ("b2f_warp_bilinear_fwd", "b2f_warp_bilinear_dflow",
                  "b2f_warp_bilinear_dimages"):
            assert KERNELS[k].launches == 1, k
        assert torch.equal(out, whole[:, rows])
        assert torch.equal(d_flow, whole_dflow[:, rows])
        close_to_scale(out, ops.warp_bilinear_reference(img, fl, y0), dtype)
        close_to_scale(d_flow, ops.warp_dflow_reference(img, fl, gb, reference_grads, y0), dtype)
        assert d_img.shape == img.shape
        close_to_scale(d_img, ops.warp_dimages_reference(fl, gb, h, y0), dtype)
        total += d_img.float()
    close_to_scale(total, whole_dimg, dtype)
