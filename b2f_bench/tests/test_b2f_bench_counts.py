"""The counts against hand counts at small shapes: the model FLOPs of
both configurations (the convolutions as torch's FLOP counter counts the
reference's, the cost volumes by hand), and each kernel op's work.

Run with: python -m pytest b2f_bench/tests -q
"""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from b2f_bench import weights
from b2f_bench.counts import model, ops
from b2f_bench.reference import pwc, spynet

ROOT = Path(__file__).resolve().parents[2]


def _options(config: str) -> dict:
    return json.loads((ROOT / "b2f_bench" / "configs" / f"{config}.json").read_text())["options"]


@pytest.mark.parametrize("config,ref,h,w", [("pwc3f", pwc, 64, 128), ("pwc3f", pwc, 128, 192),
                                            ("spynet3f", spynet, 64, 128)])
def test_model_flops_match_the_references_convs_and_cost_volumes(config, ref, h, w):
    opts = _options(config)
    params = weights.make_params(ref.param_shapes(opts), 1, "cpu")
    x = torch.zeros(1, h, w, 3 * opts["frames"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(params, x, opts, False)
    convs = counter.get_total_flops()
    cost_volumes = 0
    if config == "pwc3f":   # 2 terms a level (future, past), 2 * C * 81 a pixel each
        for l in range(3, 8):
            c = (16, 32, 64, 96, 128, 192)[l - 2]
            cost_volumes += 2 * 2 * c * 81 * (h >> (l - 1)) * (w >> (l - 1))
    assert model.forward_flops(opts, h, w) == convs + cost_volumes
    assert model.step_flops(opts, h, w) == 3 * model.forward_flops(opts, h, w)


def test_the_flagship_forward_at_kitti_size():
    """82.1 GFLOP a 320x1216 triplet: 8.0 in the pyramid, the rest in the
    decoders and the cost volumes."""
    assert model.forward_flops(_options("pwc3f"), 320, 1216) == 82_107_141_120


def test_op_work_by_hand():
    bf16 = 2
    # a 1x2x3 image of 4 channels, win 3: 6 pixels x 9 displacements x 2 x 4
    ref = ((1, 2, 3, 4), bf16)
    assert ops.work("cost_volume", [ref, ref, 3, 1, True, 0.25]) == (
        6 * 9 * 8, 2 * 24 * bf16 + 6 * 9 * bf16)
    g = ((1, 2, 3, 9), bf16)
    assert ops.work("cost_volume_dref", [g, ref, 3, 1, True, 0.25]) == (
        6 * 9 * 8, 54 * bf16 + 2 * 24 * bf16)
    img, flow = ((2, 4, 5, 3), bf16), ((2, 4, 5, 2), bf16)
    assert ops.work("warp_bilinear", [img, flow, True, 0]) == (
        8 * 120, 120 * bf16 + 80 * bf16 + 120 * bf16)
    assert ops.work("warp_dimages", [flow, img, 4, 0]) == (8 * 120, 80 * bf16 + 2 * 120 * bf16)
    assert ops.work("warp_dflow", [img, flow, img, True, 0]) == (
        8 * 120, 120 * bf16 + 2 * 80 * bf16 + 120 * bf16)
    # a row window: the gradient of 8 source rows from 4 rows of g
    assert ops.work("warp_dimages", [flow, img, 8, 2])[1] == 80 * bf16 + 120 * bf16 + 240 * bf16


def test_bound_is_the_larger_of_bytes_and_operations():
    img, flow = ((64, 320, 640, 3), 2), ((64, 320, 640, 2), 2)
    flops, nbytes = ops.work("warp_bilinear", [img, flow, True, 0])
    assert ops.bound_seconds("warp_bilinear", [img, flow, True, 0]) == nbytes / ops.HBM_BYTES_PER_S
    ref = ((8, 80, 160, 32), 2)
    flops, nbytes = ops.work("cost_volume", [ref, ref, 9, 1, True, 1.0])
    assert ops.bound_seconds("cost_volume", [ref, ref, 9, 1, True, 1.0]) == max(
        flops / 989e12, nbytes / ops.HBM_BYTES_PER_S)
