"""CPU parity of back2future_tpu_torch.models against back2future_tpu.models.

Weights are drawn once by the port's seeded init, crossed to a flax tree
by the params bridge, and both networks run the same numpy input in f32.
Tolerance rtol/atol 1e-4: the conv sums run in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu.models.pwc import PWCConfig as JaxPWCConfig
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu_torch.models import (
    PWCConfig, PWCNet, load_flax_params, pwc_config_from_options, to_flax_params,
)

torch.set_num_threads(1)

H, W = 64, 128
TOL = dict(rtol=1e-4, atol=1e-4)

VARIANTS = {
    "past_flow": dict(past_flow=True),
    "frames2": dict(frames=2),
    "two_frame": dict(two_frame=1),
    "sum_cvs_residual": dict(sum_cvs=True, residual=1),
    "skip0": dict(skip=0),
    "siamese0": dict(siamese=0),
    "rescale_flow": dict(rescale_flow=1),
    "occ_input": dict(occ_input=1),
}


def make_input(frames, seed=0):
    return np.random.default_rng(seed).standard_normal((1, H, W, 3 * frames)).astype(np.float32)


def jax_config(cfg: PWCConfig) -> JaxPWCConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = jnp.float32
    return JaxPWCConfig(**fields)


def run_both(cfg: PWCConfig, seed=0):
    """-> (torch outputs, jax outputs as numpy, torch net, x)."""
    net = PWCNet(cfg, generator=torch.Generator().manual_seed(seed))
    x = make_input(cfg.frames, seed)
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    want = jax.jit(JaxPWCNet(jax_config(cfg)).apply)({"params": tree}, jnp.asarray(x))
    want = jax.tree_util.tree_map(np.asarray, want)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    return got, want, net, x


def assert_outputs_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["flow_scale"] == w["flow_scale"]
        for key in ("flow", "flow_past", "occ"):
            assert (g[key] is None) == (w[key] is None), key
            if g[key] is not None:
                np.testing.assert_allclose(g[key].numpy(), w[key], err_msg=key, **TOL)
        assert len(g["warped"]) == len(w["warped"])
        for a, b in zip(g["warped"], w["warped"]):
            np.testing.assert_allclose(a.numpy(), b, err_msg="warped", **TOL)


@pytest.fixture(scope="module")
def flagship():
    return run_both(PWCConfig())


@pytest.fixture(scope="module")
def flax_init_tree():
    """A flax-initialised tree of a config that has every module kind:
    feat_1 (skip=0), the feature pyramid, and flow/past/occ decoders."""
    cfg = PWCConfig(levels=4, win=3, skip=0, past_flow=True)
    tree = jax.jit(JaxPWCNet(jax_config(cfg)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 9)))["params"]
    return cfg, jax.tree_util.tree_map(np.asarray, tree)


def test_bridge_round_trip(flax_init_tree):
    cfg, tree = flax_init_tree
    net = PWCNet(cfg)
    load_flax_params(net, {"params": tree})
    back = to_flax_params(net)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, value in flat:
        np.testing.assert_array_equal(flat_back[path], value)
    assert net.feat_1.c0.weight.shape == (16, 3, 3, 3)
    np.testing.assert_array_equal(net.feat_2.c0.weight.detach().numpy(),
                                  tree["feat_2"]["c0"]["conv"]["kernel"].transpose(3, 2, 0, 1))


def test_bridge_rejects_mismatch(flax_init_tree):
    cfg, tree = flax_init_tree
    net = PWCNet(cfg)
    missing = {k: v for k, v in tree.items() if k != "feat_2"}
    with pytest.raises(KeyError):
        load_flax_params(net, missing)
    extra = dict(tree, feat_9=tree["feat_2"])
    with pytest.raises(KeyError):
        load_flax_params(net, extra)
    bad = jax.tree_util.tree_map(lambda a: a, tree)   # new containers
    bad["feat_2"]["c0"]["conv"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        load_flax_params(net, bad)


def test_flagship_matches_flax(flagship):
    got, want, _, _ = flagship
    assert len(got) == 5
    assert got[0]["flow"].shape == (1, H, W, 2)
    assert [g["flow_scale"] for g in got] == [20.0, 10.0, 5.0, 2.5, 1.25]
    assert_outputs_match(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_flax(variant):
    got, want, _, _ = run_both(PWCConfig(levels=4, **VARIANTS[variant]), seed=1)
    assert_outputs_match(got, want)


def test_pyramid_from_pyramids_equal_forward(flagship):
    got, _, net, x = flagship
    xt = torch.from_numpy(x)
    with torch.no_grad():
        cs = {f: net.pyramid(xt[..., 3 * (f - 1):3 * f]) for f in (1, 2, 3)}
        out = net.from_pyramids(xt, cs)
    # per-frame vs frame-stacked conv batches sum in another order
    assert_outputs_match(out, [{k: v.numpy() if isinstance(v, torch.Tensor) else
                                ([u.numpy() for u in v] if k == "warped" else v)
                                for k, v in g.items()} for g in got])


def test_with_warped_false_same_flow_and_occ(flagship):
    got, _, net, x = flagship
    with torch.no_grad():
        out = net(torch.from_numpy(x), with_warped=False)
    for a, b in zip(out, got):
        assert a["warped"] == []
        assert torch.equal(a["flow"], b["flow"])
        assert torch.equal(a["occ"], b["occ"])


def test_config_from_options():
    from back2future_tpu.config import Options

    cfg = pwc_config_from_options(Options(compute_dtype="bfloat16").derive())
    assert cfg == PWCConfig(dtype=torch.bfloat16)
    assert (cfg.frames, cfg.levels, cfg.win, cfg.skip, cfg.siamese) == (3, 7, 9, 2, 1)
