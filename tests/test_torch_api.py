"""CPU parity of the port's FlowEstimator against the JAX FlowEstimator,
of the port's own copies of the JAX package's framework-free helpers
(Options, colour normalisation, resize, the API's pre/post-processing),
and the port's import hygiene (no jax, no flax, no JAX package).

Both estimators are built from the same weights (the port's seeded init
crossed by the params bridge) and the same PWCConfig, in f32. Flow
tolerance rtol/atol 1e-4 (conv sums in another order); the thresholded
occlusion masks may flip only where the softmax sits within float noise
of OCC_THRESHOLD, so at most 0.1% of their pixels may differ.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu import api as jax_api
from back2future_tpu.api import FlowEstimator as JaxFlowEstimator
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.data import augment as jax_augment
from back2future_tpu.data import resample as jax_resample
from back2future_tpu.models.pwc import PWCConfig as JaxPWCConfig
from back2future_tpu_torch import api
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.data import augment, resample
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
    with pytest.raises(FileNotFoundError):
        api.init("Ours-Hard", device="cpu")
    with pytest.raises(TypeError):
        api.init((None,), device="cpu")


@pytest.mark.parametrize("model", [None, *sorted(jax_api.PRETRAINED_PATHS)],
                         ids=["default", *sorted(jax_api.PRETRAINED_PATHS)])
def test_init_checkpoint_names_follow_jax(model, tmp_path, monkeypatch):
    """With no converted checkpoint under the working directory, the
    port's init and the JAX package's raise the same FileNotFoundError,
    for the default model and for each pretrained name."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")   # JAX's init leaves jax's cache setting alone
    assert api.PRETRAINED_PATHS == jax_api.PRETRAINED_PATHS
    args = () if model is None else (model,)
    with pytest.raises(FileNotFoundError) as port_err:
        api.init(*args, device="cpu")
    with pytest.raises(FileNotFoundError) as jax_err:
        jax_api.init(*args)
    assert str(port_err.value) == str(jax_err.value)


def test_init_existing_checkpoint_is_not_loaded_yet(tmp_path, monkeypatch):
    """The default name's checkpoint directory, existing but empty, raises
    the JAX package's FileNotFoundError text; holding a JAX-written
    model_1.msgpack and options.json, it loads (the name is kept from the
    slice before checkpoint loading was ported)."""
    from back2future_tpu.config import Options as JaxOptions
    from back2future_tpu.train import checkpoint as jax_checkpoint
    from back2future_tpu.train.state import create_train_state as jax_create_train_state

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    default = tmp_path / api.PRETRAINED_PATHS["Ours-Soft-ft-KITTI"]
    default.mkdir(parents=True)
    for path in ((), (str(default),)):
        with pytest.raises(FileNotFoundError) as port_err:
            api.init(*path, device="cpu")
        with pytest.raises(FileNotFoundError) as jax_err:
            jax_api.init(*path)
        assert str(port_err.value) == str(jax_err.value)
    opt = JaxOptions(levels=4, pwc_ws=3, compute_dtype="float32").derive()
    cfg = PWCConfig(levels=4, win=3)
    tree = to_flax_params(PWCNet(cfg, generator=torch.Generator().manual_seed(5)))
    state = jax_create_train_state(jax.tree_util.tree_map(jnp.asarray, tree), opt)
    jax_checkpoint.save_checkpoint(default, state, opt, 1)
    est = api.init(device="cpu")
    assert est.config == cfg
    want = PWCNet(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in est.net.state_dict().items())


def test_init_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        api.init(None, device="cuda")


def test_port_imports_no_jax():
    """A fresh interpreter imports the port, its train step, epoch loop,
    checkpoints, utilities, CLIs (the .t7 converter, the parity harness,
    the tool counterparts and the serving CLIs too), learning demo, every criterion, the
    .t7 reader, SPyNet, data pipeline and flow I/O included, runs a tiny
    CPU forward of each model family, the host C++ occlusion and a C++
    resize, without loading the JAX package, jax, flax, optax or msgpack."""
    code = (
        "import sys, numpy as np\n"
        "import back2future_tpu_torch\n"
        "from back2future_tpu_torch import api, data, io, losses, ops, models, runtime, train\n"
        "from back2future_tpu_torch import eval, learn_demo, main, utils\n"
        "from back2future_tpu_torch import (convert_t7, demo, export_serving, flow_viz_demo,"
        " make_manifests, overfit_probe, parity, serve_bench)\n"
        "from back2future_tpu_torch.io import t7\n"
        "from back2future_tpu_torch.models import convert, factory, spynet\n"
        "import torch\n"
        "spy, _ = factory.model_and_config(back2future_tpu_torch.config.Options("
        "netType='spynet', levels=3).derive())\n"
        "assert spy(torch.zeros(1, 16, 16, 9), with_warped=False)[0]['flow'].shape =="
        " (1, 16, 16, 2)\n"
        "from back2future_tpu_torch.losses import (make_kl_smoothness, make_l2_criterion,"
        " make_mbcc, make_ossim_l1)\n"
        "from back2future_tpu_torch.train import checkpoint, loop\n"
        "from back2future_tpu_torch.data import roaming\n"
        "from back2future_tpu_torch.runtime import host_build\n"
        "assert io.get_occ(np.ones((4, 5)), np.zeros((4, 5, 2))).shape == (4, 5)\n"
        "from back2future_tpu_torch.data import resample\n"
        "x = np.random.default_rng(0).random((37, 50, 9), dtype=np.float32)\n"
        "assert resample.resize(x, 64, 128).shape == (64, 128, 9) and resample._LIB is not None\n"
        "est = api.init(None, device='cpu', dtype='float32')\n"
        "ims = [np.random.default_rng(k).random((64, 128, 3), dtype=np.float32)"
        " for k in range(3)]\n"
        "flow, fo, bo = est(*ims)\n"
        "assert flow.shape == (64, 128, 2) and np.isfinite(flow).all()\n"
        "bad = [m for m in ('back2future_tpu', 'jax', 'flax', 'optax', 'msgpack')"
        " if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_jax_import_in_port_sources():
    """Neither the port nor chip_smoke.py imports jax, flax, optax or the
    JAX package (`back2future_tpu`, not `back2future_tpu_torch`)."""
    jax_package = re.compile(r"^\s*(from|import)\s+back2future_tpu(\.|\s|$)", re.M)
    sources = [*(ROOT / "back2future_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    offending = [str(p.relative_to(ROOT)) for p in sources
                 if any(s in p.read_text() for s in ("import jax", "from jax",
                                                     "import flax", "from flax",
                                                     "import optax", "from optax"))
                 or jax_package.search(p.read_text())]
    assert not offending


# ------------------------------------------ the port's copies of JAX helpers

OPTION_SETS = [dict(), dict(dataset="Kitti2015", frames=5, no_occ=True),
               dict(dataset="Sintel", optimize="epe", epe=1.0, scale=0.5),
               dict(netType="spynet", past_flow=True, wire="compact", cropWidth=320,
                    cropHeight=192)]


@pytest.mark.parametrize("kw", OPTION_SETS, ids=["default", "kitti", "sintel_epe", "spynet"])
def test_options_match_jax(kw):
    """Same fields, defaults and derived options as the JAX Options, and
    an option set written by one package reads in the other."""
    fields = [(f.name, f.default) for f in dataclasses.fields(Options)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JaxOptions)]
    got, want = Options(**kw).derive(), JaxOptions(**kw).derive()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(JaxOptions.from_json(got.to_json())) == dataclasses.asdict(want)
    assert dataclasses.asdict(Options.from_json(want.to_json())) == dataclasses.asdict(got)


def test_options_reject_what_jax_rejects():
    for kw, error in ((dict(wire="u8"), ValueError),
                      (dict(wire="compact", normalize_images=0), ValueError),
                      (dict(frames=4), AssertionError)):
        for cls in (Options, JaxOptions):
            with pytest.raises(error):
                cls(**kw).derive()


def test_color_normalize_matches_jax():
    img = np.random.default_rng(11).random((5, 7, 9), dtype=np.float32)
    np.testing.assert_array_equal(augment.color_normalize(img), jax_augment.color_normalize(img))
    np.testing.assert_array_equal(augment.IMAGENET_MEAN, jax_augment.IMAGENET_MEAN)
    np.testing.assert_array_equal(augment.IMAGENET_STD, jax_augment.IMAGENET_STD)


@pytest.mark.parametrize("mode", ["bilinear", "simple"])
@pytest.mark.parametrize("size", [(64, 128), (41, 13), (70, 140)], ids=["down", "odd", "same"])
def test_resize_matches_jax(mode, size):
    """The JAX package resizes with its C++ resampler where it is built
    (f32 weights) and with numpy otherwise (f64 weights); the port is the
    numpy path: bilinear within 1e-5, nearest exact."""
    rng = np.random.default_rng(12)
    for img in (rng.random((70, 140, 3), dtype=np.float32), rng.random((70, 140), dtype=np.float32)):
        got, want = resample.resize(img, *size, mode), jax_resample.resize(img, *size, mode)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if mode == "bilinear" else 0)
    with pytest.raises(ValueError):
        resample.resize(img, 10, 10, "bicubic")


def test_api_processing_matches_jax():
    rng = np.random.default_rng(13)
    stacks = [rng.random((2, 70, 140, 3), dtype=np.float32) for _ in range(3)]
    got, want = api._preprocess_triplets(stacks, 3), jax_api._preprocess_triplets(stacks, 3)
    assert got[1:] == want[1:] == (2, 70, 140)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    flow = rng.standard_normal((2, 64, 128, 2)).astype(np.float32)
    occ = rng.random((2, 64, 128, 2), dtype=np.float32)
    for o in (occ, None):
        for a, b in zip(api._postprocess_results(flow, o, 2, 70, 140),
                        jax_api._postprocess_results(flow, o, 2, 70, 140)):
            np.testing.assert_array_equal(a, b)
    assert api.OCC_THRESHOLD == jax_api.OCC_THRESHOLD
    assert [api._round_down_64(v) for v in (10, 64, 130, 1242)] == \
        [jax_api._round_down_64(v) for v in (10, 64, 130, 1242)]
    with pytest.raises(ValueError):
        api._preprocess_triplets(stacks[:2], 3)
