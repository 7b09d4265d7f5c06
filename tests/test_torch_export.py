"""The port's serving export on the CPU: `FlowEstimator.export` ->
`load_exported` (the counterpart of tests/test_api_ckpt.py::TestExport),
`warmup`, the exported graph's ops, the pyramid cache after an export,
and the port's artifact against the JAX package's.

The round trip serves the same programs as the live estimator, so its
results are equal bit for bit. Against JAX (its `export` ->
`load_exported`, from the same bridged weights, f32): flow rtol/atol
1e-4 and at most 0.1% of mask pixels flipped (`assert_results_match` of
tests/test_torch_api.py: conv sums in another order).
"""

import json
import subprocess
import sys
import textwrap
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()   # torch.export and opcheck import torch._dynamo

import jax
import jax.numpy as jnp

from back2future_tpu.api import FlowEstimator as JaxFlowEstimator
from back2future_tpu.api import load_exported as jax_load_exported
from back2future_tpu.models.pwc import PWCConfig as JaxPWCConfig
from back2future_tpu_torch import api
from back2future_tpu_torch.models import PWCConfig, PWCNet, to_flax_params
from back2future_tpu_torch.ops import pyramid
from test_torch_api import assert_results_match

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = PWCConfig(levels=4, win=3)          # skip 2: output levels 3 and 4
SIZES = [(96, 130), (2, 96, 130)]         # buckets (1, 64, 128) and (2, 64, 128)


def frames(n=3, seed=0, size=(96, 130)):
    rng = np.random.default_rng(seed)
    return [rng.random((*size, 3)).astype(np.float32) for _ in range(n)]


def tree(cfg):
    return to_flax_params(PWCNet(cfg, generator=torch.Generator().manual_seed(3)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The live f32 estimator and the artifact it exported at SIZES."""
    est = api.init((tree(CFG), CFG), device="cpu")
    art = tmp_path_factory.mktemp("export") / "art"
    est.export(art, SIZES)
    return est, art


def test_artifact_files_and_meta(pair):
    _, art = pair
    assert sorted(p.name for p in art.iterdir()) == [
        "forward_1x64x128.pt2", "forward_2x64x128.pt2", "meta.json"]
    meta = json.loads((art / "meta.json").read_text())
    assert meta["format"] == "back2future_tpu_torch.export.v1"
    assert (meta["frames"], meta["buckets"], meta["dtype"], meta["device"], meta["stem"]) == \
        (3, [[1, 64, 128], [2, 64, 128]], "float32", "cpu", False)
    assert meta["torch_version"] == torch.__version__
    # the program keeps no example batch beside its weights
    assert torch.export.load(art / "forward_2x64x128.pt2").example_inputs is None


def test_roundtrip_matches_live(pair):
    est, art = pair
    served = api.load_exported(art, device="cpu")
    ims = frames()
    for a, b in zip(est(*ims), served(*ims)):
        np.testing.assert_array_equal(a, b)
    two = [np.stack([im, im[::-1]]) for im in ims]
    for a, b in zip(est.compute_flow_batch(*two), served.compute_flow_batch(*two)):
        np.testing.assert_array_equal(a, b)


def test_exported_graph_calls_the_ops(pair):
    """Levels 4 and 3 decode 2 cost volumes each (past and future frame)
    and warp both non-reference frames' features once between them: 4
    `b2f::cost_volume` and 2 `b2f::warp_bilinear` nodes, and none of the
    twins' ops inlined (the warp twin's advanced-index gather, the cost
    volume twin's padding), nor the resize taps' construction."""
    _, art = pair
    program = torch.export.load(art / "forward_1x64x128.pt2")
    targets = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    b2f = {k: v for k, v in targets.items() if k.startswith("b2f.")}
    assert b2f == {"b2f.cost_volume.default": 4, "b2f.warp_bilinear.default": 2}
    assert not [k for k in targets if k.startswith(("aten.index.", "aten.constant_pad_nd",
                                                    "aten.pad."))]
    # export warms the bucket first: the resize taps are constants
    assert not [k for k in targets if k.startswith("aten.arange")]


def test_unseen_bucket_raises(pair):
    _, art = pair
    served = api.load_exported(art, device="cpu")
    with pytest.raises(ValueError, match="no exported executable"):
        served(*frames(size=(96, 200)))
    with pytest.raises(ValueError, match="no exported executable"):
        served.compute_flow_batch(*[np.stack([im] * 3) for im in frames()])


def test_bad_format_rejected(tmp_path):
    art = tmp_path / "bad"
    art.mkdir()
    (art / "meta.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a back2future_tpu_torch export artifact"):
        api.load_exported(art, device="cpu")


def test_device_mismatch_rejected_at_load(pair, tmp_path):
    """A CPU artifact refuses the card, and one exported on the card
    refuses the CPU, at load."""
    _, art = pair
    with pytest.raises(ValueError, match="exported for device 'cpu'"):
        api.load_exported(art, device="cuda")
    moved = tmp_path / "art"
    moved.mkdir()
    meta = json.loads((art / "meta.json").read_text())
    (moved / "meta.json").write_text(json.dumps(dict(meta, device="cuda")))
    with pytest.raises(ValueError, match="exported for device 'cuda'"):
        api.load_exported(moved, device="cpu")


def test_fresh_process_serves_without_model_code(pair):
    """A new interpreter loads the artifact and computes flow without any
    module of back2future_tpu_torch.models (or JAX) imported."""
    est, art = pair
    want = est(*frames())[0]
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        from back2future_tpu_torch.api import load_exported
        torch.set_num_threads(1)   # as this test module: the same conv sums
        served = load_exported({str(art)!r}, device="cpu")
        rng = np.random.default_rng(0)
        ims = [rng.random((96, 130, 3)).astype(np.float32) for _ in range(3)]
        flow, fwd, bwd = served(*ims)
        np.save(sys.argv[1], flow)
        bad = [m for m in sys.modules
               if m.startswith("back2future_tpu_torch.models") or m in ("jax", "back2future_tpu")]
        assert not bad, bad
        print("served-without-model-code ok")
    """)
    out_file = art.parent / "fresh_flow.npy"
    res = subprocess.run([sys.executable, "-c", script, str(out_file)], cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "HOME": str(art.parent)},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "served-without-model-code ok" in res.stdout
    np.testing.assert_array_equal(np.load(out_file), want)


def test_warmup_runs_each_bucket_without_warnings():
    est = api.init((tree(CFG), CFG), device="cpu")
    shapes = []
    est.net.register_forward_pre_hook(lambda module, args: shapes.append(tuple(args[0].shape)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        est.warmup([(96, 130), (2, 70, 200), (96, 130)])
        est(*frames())
    assert shapes == [(1, 64, 128, 9), (2, 64, 192, 9), (1, 64, 128, 9), (1, 64, 128, 9)]


def test_frames2_model_exports_and_serves(tmp_path):
    """A two-frame model has no occlusion head: the exported program
    returns occ None and the served masks are all False."""
    cfg = PWCConfig(frames=2, levels=4, win=3)
    est = api.init((tree(cfg), cfg), device="cpu")
    est.export(tmp_path / "art", [(96, 130)])
    served = api.load_exported(tmp_path / "art", device="cpu")
    ims = frames(2)
    got, want = served(*ims), est(*ims)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[1].any() and not got[2].any()


def test_eager_forward_after_export_is_real_and_unchanged():
    """The pyramid's cached taps never hold a tensor made while tracing:
    an eager forward, an export traced while the cache holds nothing for
    its sizes, then the eager forward again gives a real tensor, equal to
    the first."""
    net = PWCNet(CFG, generator=torch.Generator().manual_seed(3)).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 64, 128, 9),
                                                                  dtype=np.float32))
    with torch.inference_mode():
        before = net(x, with_warped=False)[0]["flow"]
    pyramid._TAPS.clear()
    pyramid._NEAREST.clear()
    with torch.no_grad():
        torch.export.export(api._FinestForward(net), (x,))
    assert not pyramid._TAPS and not pyramid._NEAREST
    with torch.inference_mode():
        after = net(x, with_warped=False)[0]["flow"]
    assert type(after) is torch.Tensor
    assert torch.equal(after, before)


def test_export_matches_jax_export(pair, tmp_path, monkeypatch):
    """The port's artifact against the JAX package's, exported from the
    same weights in f32 and served by each package's load_exported."""
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    _, art = pair
    params = jax.tree_util.tree_map(jnp.asarray, tree(CFG))
    fields = {k: getattr(CFG, k) for k in CFG.__dataclass_fields__}
    jax_est = JaxFlowEstimator(params, JaxPWCConfig(**dict(fields, dtype=jnp.float32)))
    jax_est.export(tmp_path / "jax_art", [(96, 130)])
    jax_served = jax_load_exported(tmp_path / "jax_art")
    served = api.load_exported(art, device="cpu")
    ims = frames(seed=5)
    assert_results_match(served(*ims), jax_served(*ims))
    # a JAX artifact is not the port's
    with pytest.raises(ValueError, match="not a back2future_tpu_torch export artifact"):
        api.load_exported(tmp_path / "jax_art", device="cpu")
