"""CPU parity of the port's FlowEstimator against the JAX FlowEstimator,
and the port's import hygiene (no jax, no flax).

Both estimators are built from the same weights (the port's seeded init
crossed by the params bridge) and the same PWCConfig, in f32. Flow
tolerance rtol/atol 1e-4 (conv sums in another order); the thresholded
occlusion masks may flip only where the softmax sits within float noise
of OCC_THRESHOLD, so at most 0.1% of their pixels may differ.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu.api import FlowEstimator as JaxFlowEstimator
from back2future_tpu.models.pwc import PWCConfig as JaxPWCConfig
from back2future_tpu_torch import api
from back2future_tpu_torch.models import PWCConfig, PWCNet, to_flax_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
H, W = 70, 140   # snapped to 64x128 and resized back


def frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((H, W, 3), dtype=np.float32) for _ in range(n)]


def assert_results_match(got, want):
    flow, fwd_occ, bwd_occ = got
    assert flow.shape == want[0].shape and flow.dtype == np.float32
    np.testing.assert_allclose(flow, want[0], **TOL)
    for a, b in ((fwd_occ, want[1]), (bwd_occ, want[2])):
        assert a.dtype == bool and a.shape == b.shape
        assert np.mean(a != b) <= 1e-3


@pytest.fixture(scope="module")
def estimators():
    cfg = PWCConfig()
    tree = to_flax_params(PWCNet(cfg, generator=torch.Generator().manual_seed(3)))
    port = api.init((tree, cfg), device="cpu")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    jax_cfg = JaxPWCConfig(**dict(fields, dtype=jnp.float32))
    ref = JaxFlowEstimator(jax.tree_util.tree_map(jnp.asarray, tree), jax_cfg)
    return port, ref


@pytest.fixture(scope="module")
def batch_results(estimators):
    port, ref = estimators
    stacks = [np.stack(f) for f in zip(frames(3, 1), frames(3, 2))]   # B=2
    return port.compute_flow_batch(*stacks), ref.compute_flow_batch(*stacks)


def test_compute_flow_matches_jax(estimators):
    port, ref = estimators
    ims = frames(3, 0)
    got, want = port(*ims), ref(*ims)
    assert got[0].shape == (H, W, 2) and got[1].shape == (H, W)
    assert_results_match(got, want)


def test_compute_flow_batch_matches_jax(batch_results):
    got, want = batch_results
    assert got[0].shape == (2, H, W, 2)
    assert_results_match(got, want)


def test_compute_flow_video_matches_windows(estimators):
    port, ref = estimators
    video = frames(5, 4)
    got = port.compute_flow_video(np.stack(video))
    assert got[0].shape == (3, H, W, 2)
    assert_results_match(got, ref.compute_flow_video(np.stack(video)))
    for t in range(3):
        window = port(*video[t:t + 3])
        assert_results_match(tuple(r[t] for r in got), window)


def test_init_random_weights_and_dtype():
    est = api.init(None, device="cpu", seed=0)
    assert est.config == PWCConfig(dtype=torch.bfloat16)
    f32 = api.init(None, device="cpu", dtype="float32", seed=0)
    assert f32.config.dtype == torch.float32
    torch.testing.assert_close(est.net.feat_2.c0.weight, f32.net.feat_2.c0.weight)
    with pytest.raises(ValueError):
        api.init(None, device="cpu", dtype="float16")
    with pytest.raises(TypeError):
        api.init("Ours-Hard", device="cpu")


def test_init_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        api.init(None, device="cuda")


def test_port_imports_no_jax():
    """A fresh interpreter imports the port, its train step and losses
    included, and runs a tiny CPU forward without loading jax, flax,
    optax or msgpack."""
    code = (
        "import sys, numpy as np\n"
        "import back2future_tpu_torch\n"
        "from back2future_tpu_torch import api, data, losses, ops, models, runtime, train\n"
        "est = api.init(None, device='cpu', dtype='float32')\n"
        "ims = [np.random.default_rng(k).random((64, 128, 3), dtype=np.float32)"
        " for k in range(3)]\n"
        "flow, fo, bo = est(*ims)\n"
        "assert flow.shape == (64, 128, 2) and np.isfinite(flow).all()\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'msgpack') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_jax_import_in_port_sources():
    offending = [str(p.relative_to(ROOT))
                 for p in (ROOT / "back2future_tpu_torch").rglob("*.py")
                 if any(s in p.read_text() for s in ("import jax", "from jax",
                                                     "import flax", "from flax",
                                                     "import optax", "from optax"))]
    assert not offending
