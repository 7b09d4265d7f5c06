"""CPU parity of the port's tool counterparts against the JAX package's
tools on the same inputs:

* `python -m back2future_tpu_torch.make_manifests`: the `.dat` and
  `_split.dat` files of the kitti2015-multiview, kitti2015-flow, sintel
  and frames layouts byte for byte equal to tools/make_manifests.py's,
  on small directory trees made by the test.
* `.flow_viz_demo`: the 2x2 evidence panels of one JAX-written f32
  checkpoint (levels 4, win 3) on a generated RoamingImages set within
  one level of 255 of tools/flow_viz_demo.py's, its EPE lines within
  1e-3 px.
* `.overfit_probe`: the first step's loss and EPE against
  tools/overfit_probe.py's at rtol 1e-3, both from the port's seeded
  weights (JAX's fresh init is replaced by them) and one tiny f32 config
  added to both tools' fixed flags (crop 32x64, levels 4, win 3).
* `.demo`: flow.flo of the same JAX-written checkpoint on the same PNG
  frames within 1e-4 of tools/demo.py's, the PNGs of the same shapes.
* `.export_serving`: an artifact that `load_exported` serves bit for bit
  as the live estimator; `.serve_bench --cpu --iters 1 --export`: one
  JSON line per resolution and path with the timing keys (the
  checkpoint's tiny net, at two small resolutions in place of the
  KITTI and Sintel sizes).
"""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp

from back2future_tpu import config as jax_config
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.data import resample as jax_resample
from back2future_tpu.io.png16 import read_png
from back2future_tpu.train import checkpoint as jax_checkpoint
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu_torch import config as port_config
from back2future_tpu_torch import (api, demo, export_serving, flow_viz_demo, make_manifests,
                                   overfit_probe, serve_bench)
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.data import roaming
from back2future_tpu_torch.data.resample import TWINS_ENV
from back2future_tpu_torch.io import load_flo
from back2future_tpu_torch.io.png16 import write_png
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def load_tool(name):
    """A module of tools/ by its path (tools/ itself stays off sys.path:
    its profile.py would shadow the standard library's)."""
    spec = importlib.util.spec_from_file_location(f"_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def touch(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Empty files named as each layout names its frames."""
    root = tmp_path_factory.mktemp("layouts")
    kitti = root / "kitti"
    for scene in (0, 1, 7):
        for frame in range(8, 13):
            touch(kitti / "training" / "image_2" / f"{scene:06d}_{frame:02d}.png")
        touch(kitti / "training" / "flow_occ" / f"{scene:06d}_10.png")
    sintel = root / "sintel"
    for scene, n in (("alley_1", 5), ("market_2", 4)):
        for i in range(1, n + 1):
            touch(sintel / "clean" / scene / f"frame_{i:04d}.png")
        if scene == "alley_1":
            for i in range(1, n):
                touch(sintel / "flow" / scene / f"frame_{i:04d}.flo")
    frames = root / "frames"
    for i in (1, 2, 3, 4, 6, 7, 8):
        touch(frames / f"img_{i:04d}.png")
    touch(frames / "notes.txt")
    return root


MANIFEST_CASES = {
    "kitti2015-multiview": ("kitti", []),
    "kitti2015-flow": ("kitti", ["--ref", "10"]),
    "sintel": ("sintel", ["--val_fraction", "0.5", "--seed", "3"]),
    "frames": ("frames", ["--pattern", "img_%04d.png", "--val_fraction", "0.3"]),
}


@pytest.mark.parametrize("layout", sorted(MANIFEST_CASES))
def test_make_manifests_writes_the_tools_files(layouts, layout, tmp_path, capsys):
    tree, extra = MANIFEST_CASES[layout]
    tool = load_tool("make_manifests")
    outs = {}
    for name, main in (("jax", tool.main), ("port", make_manifests.main)):
        out = tmp_path / name / "datasets" / "Set.dat"
        main([layout, str(layouts / tree), str(out), *extra])
        outs[name] = out
    assert capsys.readouterr().out.splitlines()[0].startswith("wrote ")
    for suffix in (".dat", "_split.dat"):
        want = outs["jax"].with_name("Set" + suffix).read_bytes()
        got = outs["port"].with_name("Set" + suffix).read_bytes()
        assert got == want and want, suffix


@pytest.fixture(scope="module")
def roaming_set(tmp_path_factory):
    """A 6-scene RoamingImages set at 320x640, the size flow_viz_demo loads
    (3 frames, 2 val scenes), and
    a JAX-written f32 checkpoint of a seeded tiny PWCNet."""
    root = tmp_path_factory.mktemp("tools_roaming")
    roaming.main(["--out", str(root / "set"), "--n", "6", "--height", "320", "--width", "640",
                  "--frames", "3", "--val_fraction", "0.34", "--seed", "0"])
    opt = JaxOptions(levels=4, pwc_ws=3, compute_dtype="float32").derive()
    net = PWCNet(pwc_config_from_options(Options(levels=4, pwc_ws=3).derive()),
                 generator=torch.Generator().manual_seed(5))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    jax_checkpoint.save_checkpoint(root / "ckpt", jax_create_train_state(tree, opt), opt, 1)
    return root


def test_flow_viz_demo_panels_match_the_tools(roaming_set, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    monkeypatch.setattr(jax_resample, "_native", (None,))
    monkeypatch.setenv(TWINS_ENV, "1")
    args = ["--checkpoint", str(roaming_set / "ckpt"), "--data", str(roaming_set / "set"),
            "--n", "2", "--cpu"]
    lines = {}
    for name, main in (("jax", load_tool("flow_viz_demo").main), ("port", flow_viz_demo.main)):
        capsys.readouterr()
        main(args + ["--out", str(tmp_path / name)])
        lines[name] = capsys.readouterr().out.strip().splitlines()
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["val00_panel.png", "val01_panel.png"]
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        want, got = read_png(tmp_path / "jax" / n), read_png(tmp_path / "port" / n)
        assert got.shape == want.shape == (2 * 320, 2 * 640, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, n
    epe = {k: [float(re.search(r"EPE ([0-9.]+) px", line).group(1)) for line in v]
           for k, v in lines.items()}
    np.testing.assert_allclose(epe["port"], epe["jax"], atol=1e-3)


def test_overfit_probe_first_step_matches_the_tool(roaming_set, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    monkeypatch.setattr(jax_resample, "_native", (None,))
    monkeypatch.setenv(TWINS_ENV, "1")
    tiny = ["--cropWidth", "64", "--cropHeight", "32", "--levels", "4", "--pwc_ws", "3",
            "--compute_dtype", "float32", "--cache", str(tmp_path / "cache")]
    for module in (jax_config, port_config):
        monkeypatch.setattr(module, "parse_args",
                            lambda argv, parse=module.parse_args: parse(list(argv) + tiny))
    port_opt = port_config.parse_args(["--dataset", "RoamingImages"])
    net = PWCNet(pwc_config_from_options(port_opt),
                 generator=torch.Generator().manual_seed(port_opt.manualSeed))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    monkeypatch.setattr(jax_checkpoint, "load_or_convert",
                        lambda opt: (tree, None, opt.epochNumber))
    args = ["--data", str(roaming_set / "set"), "--steps", "1", "--batch", "2", "--cpu"]
    values = {}
    for name, main in (("jax", load_tool("overfit_probe").main), ("port", overfit_probe.main)):
        capsys.readouterr()
        main(args)
        out = capsys.readouterr().out
        m = re.search(r"step +1 loss +([-0-9.]+) epe +([-0-9.]+)", out)
        assert m, out
        values[name] = [float(m.group(1)), float(m.group(2))]
        assert "done in" in out
    np.testing.assert_allclose(values["port"], values["jax"], rtol=1e-3)
    assert np.isfinite(values["port"]).all() and values["port"][0] > 0


@pytest.fixture(scope="module")
def demo_frames(tmp_path_factory):
    """Three seeded 8-bit PNG frames, 96x130 (snapped to 64x128 inside)."""
    root = tmp_path_factory.mktemp("demo_frames")
    rng = np.random.default_rng(11)
    paths = []
    for k in range(3):
        paths.append(str(root / f"frame_{k}.png"))
        write_png(paths[-1], rng.integers(0, 256, (96, 130, 3), dtype=np.uint8))
    return paths


def test_demo_matches_the_tool(roaming_set, demo_frames, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    for name, main in (("jax", load_tool("demo").main), ("port", demo.main)):
        main([*demo_frames, "--model", str(roaming_set / "ckpt"), "--out", str(tmp_path / name),
              "--cpu"])
        assert capsys.readouterr().out.startswith(f"wrote {tmp_path / name}/flow.flo")
    want, got = (load_flo(tmp_path / name / "flow.flo") for name in ("jax", "port"))
    assert got.shape == want.shape == (96, 130, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for png in ("flow.png", "fwd_occ.png", "bwd_occ.png"):
        assert read_png(tmp_path / "port" / png).shape == read_png(tmp_path / "jax" / png).shape


def test_export_serving_writes_a_served_artifact(roaming_set, demo_frames, tmp_path, capsys):
    ckpt = str(roaming_set / "ckpt")
    export_serving.main(["--model", ckpt, "--out", str(tmp_path / "art"), "--sizes", "96x130",
                         "2x96x130", "--dtype", "float32", "--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"exported 2 bucket(s) to {tmp_path / 'art'}:"
    assert [line.strip() for line in out[1:]] == ["forward_1x64x128.pt2", "forward_2x64x128.pt2",
                                                  "meta.json"]
    served = api.load_exported(tmp_path / "art", device="cpu")
    live = api.init(ckpt, device="cpu", dtype="float32")
    ims = [read_png(p).astype(np.float32) / 255 for p in demo_frames]
    for a, b in zip(served(*ims), live(*ims)):
        np.testing.assert_array_equal(a, b)


def test_serve_bench_prints_a_line_per_path(roaming_set, capsys, monkeypatch):
    monkeypatch.setattr(serve_bench, "RESOLUTIONS", [("kitti", 70, 140), ("sintel", 96, 130)])
    serve_bench.main(["--cpu", "--iters", "1", "--export", "--checkpoint",
                      str(roaming_set / "ckpt")])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["path"], r["resolution"]) for r in records] == [
        ("eager", "kitti"), ("exported", "kitti"), ("eager", "sintel"), ("exported", "sintel")]
    keys = ("warmup_s", "total_ms", "pre_ms", "forward_ms", "fetch_ms", "post_ms")
    for r in records:
        assert all(isinstance(r[k], float) and r[k] >= 0 for k in keys), r
        assert r["device"] == "cpu" and r["iters"] == 1
