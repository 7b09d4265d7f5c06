"""CPU tests of the port's launcher entry points (back2future_tpu_torch.graft_entry)
against the repo's `__graft_entry__.py`.

* `models/flax_init.py` reproduces the JAX package's `init(PRNGKey(0))`
  of the flagship net bit for bit, every leaf, hard (from JAX's
  `entry()`) and soft (past-flow decoders); its threefry, fold_in and
  uniform against `jax.random` on their own.
* `entry()`: the port's bf16 forward on a seeded input against JAX's
  `entry()` forward (jitted, its own params): the finest flow within
  5e-2 of max|flow| (bf16 rounds every conv and cost volume on each
  side, in other orders, through 5 decoder levels and 4 feature warps;
  chip_smoke.py holds the card's bf16 forward to the same share) and
  the occlusion softmax within 5e-2.
* `python -m back2future_tpu_torch.graft_entry 8 --cpu`
  (`dryrun_multichip(8, device="cpu")`: 8 gloo ranks on a data x
  spatial mesh of (4, 2), as the JAX package's dry run, each data slot's
  sample in row bands over its two ranks) prints the JAX package's
  recorded losses, 49.97828 (hard) and 100.98643 (soft)
  (MULTICHIP_r05.json), at rtol 1e-4.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jax_graft
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu_torch import graft_entry
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options
from back2future_tpu_torch.models import flax_init
from back2future_tpu_torch.models.bridge import flax_to_torch_names

torch.set_num_threads(1)

HARD_LOSS = 49.97828    # MULTICHIP_r05.json, dryrun_multichip(8) [hard]
SOFT_LOSS = 100.98643   # MULTICHIP_r05.json, dryrun_multichip(8) [soft]


@pytest.fixture(scope="module")
def jax_entry():
    fn, (params, x) = jax_graft.entry()
    return fn, jax.tree_util.tree_map(np.asarray, params)


def test_threefry_primitives_match_jax():
    key = jax.random.PRNGKey(5)
    assert flax_init.prng_key(5) == tuple(int(v) for v in np.asarray(key))
    folded = jax.random.fold_in(key, 0xDEADBEEF)
    assert flax_init.fold_in((0, 5), 0xDEADBEEF) == tuple(int(v) for v in np.asarray(folded))
    want = np.asarray(jax.random.uniform(folded, (4, 3, 7), jnp.float32, -0.25, 0.25))
    got = flax_init.uniform(flax_init.fold_in((0, 5), 0xDEADBEEF), (4, 3, 7), -0.25, 0.25)
    np.testing.assert_array_equal(got, want)


def assert_init_equal(net, tree):
    want = flax_to_torch_names(tree)
    got = flax_init.flax_init_tree(net, 0)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_hard_init_matches_jax_entry_params(jax_entry):
    _, params = jax_entry
    net = PWCNet(pwc_config_from_options(Options().derive()))
    assert_init_equal(net, params)


def test_soft_init_matches_jax():
    kw = dict(pme_criterion="OBGCC", past_flow=True, const_vel=1.0,
              smooth_second_order=True, compute_dtype="float32")
    jopt = JaxOptions(**kw).derive()
    tree = jax.jit(JaxPWCNet(jax_pwc_config(jopt)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 9)))["params"]
    net = PWCNet(pwc_config_from_options(Options(**kw).derive()))
    assert any(name.startswith("past_decoder_") for name, _ in net.named_parameters())
    assert_init_equal(net, jax.tree_util.tree_map(np.asarray, tree))


def test_entry_matches_jax_entry(jax_entry):
    jfn, params = jax_entry
    fn, (x0,) = graft_entry.entry(device="cpu")
    assert x0.shape == (1, 64, 128, 9) and x0.device.type == "cpu"
    x = np.random.default_rng(3).standard_normal((2, 64, 128, 9)).astype(np.float32) * 0.5
    want_flow, want_occ = (np.asarray(v, np.float32) for v in jax.jit(jfn)(params, jnp.asarray(x)))
    flow, occ = fn(torch.from_numpy(x))
    assert flow.dtype == torch.bfloat16 and flow.shape == want_flow.shape == (2, 64, 128, 2)
    assert occ.shape == want_occ.shape
    np.testing.assert_allclose(flow.float().numpy(), want_flow, rtol=0,
                               atol=5e-2 * np.abs(want_flow).max())
    np.testing.assert_allclose(occ.float().numpy(), want_occ, rtol=0, atol=5e-2)


def test_dryrun_multichip_reaches_jax_anchors(capfd, monkeypatch):
    monkeypatch.setenv("B2F_DIST_TIMEOUT", "120")
    graft_entry.main(["8", "--cpu"])
    out = capfd.readouterr().out
    losses = {kind: float(v) for kind, v in re.findall(
        r"dryrun_multichip\(8\): mesh=\{'data': 4, 'spatial': 2\} \(gloo, cpu\) "
        r"\[(hard|soft)\] "
        r"loss=([0-9.]+) ok", out)}
    assert set(losses) == {"hard", "soft"}, out
    np.testing.assert_allclose(losses["hard"], HARD_LOSS, rtol=1e-4)
    np.testing.assert_allclose(losses["soft"], SOFT_LOSS, rtol=1e-4)
