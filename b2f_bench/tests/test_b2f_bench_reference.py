"""The benchmark's plain reference against the program's CPU path (its
plain twins) at a small size, in float32: both configurations'
forwards, and the hard recipe's loss and gradients of a train step.

Run with: python -m pytest b2f_bench/tests -q
"""

import json
from pathlib import Path

import pytest
import torch

from b2f_bench import inputs, weights
from b2f_bench.reference import pwc, recipe, spynet

ROOT = Path(__file__).resolve().parents[2]
H, W, B = 64, 128, 2
SEED = 2 ** 33 + 5


def _options(config: str, **extra) -> dict:
    cfg = json.loads((ROOT / "b2f_bench" / "configs" / f"{config}.json").read_text())
    return {**cfg["options"], "compute_dtype": "float32", **extra}


def _traffic_options() -> dict:
    return json.loads((ROOT / "b2f_bench" / "traffic" / "train_hard_b64.json").read_text())[
        "options"]


def _program(opts: dict, params: dict):
    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.models.factory import model_and_config

    net, _ = model_and_config(Options(**opts).derive())
    weights.bind(net, params)
    return net


REFERENCES = {"pwc3f": pwc, "spynet3f": spynet}


@pytest.mark.parametrize("config", ["pwc3f", "spynet3f"])
@pytest.mark.parametrize("with_warped", [False, True])
def test_forward_matches_the_program(config, with_warped):
    opts = _options(config)
    ref = REFERENCES[config]
    params = weights.make_params(ref.param_shapes(opts), SEED, "cpu")
    x = inputs.render(SEED, B, H, W, 3, 2, 8.0, "cpu")
    with torch.no_grad():
        want = ref.forward(params, x, opts, with_warped)
        got = _program(opts, params)(x, with_warped)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g["flow_scale"] == r["flow_scale"]
        for key in ("flow", "occ"):
            torch.testing.assert_close(g[key], r[key], rtol=1e-4, atol=1e-4)
        assert len(g["warped"]) == len(r["warped"])
        for a, b in zip(g["warped"], r["warped"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("config", ["pwc3f", "spynet3f"])
def test_train_step_matches_the_program(config):
    """The recipe's loss and every parameter's gradient of one step."""
    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train.multiscale import multiscale_loss

    opts = {**_options(config), **_traffic_options()}
    ref = REFERENCES[config]
    params = weights.make_params(ref.param_shapes(opts), SEED, "cpu")
    x = inputs.render(SEED + 1, B, H, W, 3, 2, 8.0, "cpu")

    leaves = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    want = recipe.loss(ref.forward(leaves, x, opts, True), x, opts)
    want.backward()

    net = _program(opts, {n: p.clone() for n, p in params.items()})
    opt = Options(**opts).derive()
    got, _ = multiscale_loss(net(x, True), {"images": x}, opt, build_criterions(opt))
    got.backward()

    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    for name, p in net.named_parameters():
        g, r = p.grad, leaves[name].grad
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3 * r.abs().max().item(),
                                   msg=lambda m: f"{name}: {m}")
