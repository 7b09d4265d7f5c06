"""CPU parity of the port's Torch7 reader/writer (io/t7.py), its `.t7`
checkpoint conversion (models/convert.py) and its two CLIs
(`python -m back2future_tpu_torch.convert_t7`, `.parity`) against the
JAX package's (back2future_tpu/io/t7.py, models/convert.py,
tools/convert_t7.py, tools/parity.py).

* Every round trip of tests/test_t7.py, read by both readers into equal
  objects (heap-id sharing resolving to one object in both), each file
  written by the port's T7Writer byte for byte the JAX writer's.
* The structured nngraph fixtures of tests/nngraph_fixture.py (gModule
  forwardnodes with cyclic references, the DataParallelTable unwrap,
  flattened storage, strided and offset views, the SpatialConvolutionMM
  fold) read equal in both, and convert to the same flax-named tree
  exactly, with past_flow 0 and 1; both raise the same error for a
  count mismatch and for clones that are not value-equal.
* A converted fixture serves the same flow in both packages (f32,
  rtol/atol 1e-4: conv sums in another order).
* The convert_t7 CLI writes model_0.pt / optimState_0.pt / options.json
  that `init(path)` serves; its `--inspect` lines are the JAX tool's.
* The parity CLI's JSON against tools/parity.py's on the same
  checkpoint and frames: the same keys, values within 1e-4; the exit code
  follows the tolerance.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp

from back2future_tpu import api as jax_api
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.io import t7 as jax_t7
from back2future_tpu.io.png16 import write_png
from back2future_tpu.models import convert as jax_convert
from back2future_tpu.models.pwc import PWCConfig as JaxPWCConfig
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.train import checkpoint as jax_checkpoint
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu_torch import api, convert_t7, parity
from back2future_tpu_torch.io import flow_io, t7
from back2future_tpu_torch.models import PWCConfig, PWCNet, load_flax_params, to_flax_params
from back2future_tpu_torch.models import convert

from nngraph_fixture import TV, build_gmodule, clone_conv, save_nngraph_t7, wrap_dpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)


def assert_same_object(got, want, path="", pairs=None):
    """Two deserialised t7 objects are equal, and share where the other
    shares: an object met twice in one is the same object twice in the
    other."""
    pairs = {} if pairs is None else pairs
    if isinstance(want, (dict, list, np.ndarray)):
        if id(want) in pairs:
            assert pairs[id(want)] is got, f"{path}: sharing differs"
            return
        pairs[id(want)] = got
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_object(got[k], want[k], f"{path}/{k}", pairs)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_object(a, b, f"{path}[{i}]", pairs)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def both_write(tmp_path, obj, name):
    """Write `obj` with each package's save_t7; the files are byte for
    byte equal. -> the port's file."""
    mine, theirs = tmp_path / f"{name}.port.t7", tmp_path / f"{name}.jax.t7"
    t7.save_t7(mine, obj)
    jax_t7.save_t7(theirs, obj)
    assert mine.read_bytes() == theirs.read_bytes()
    return mine


def both_read(path):
    got, want = t7.load_t7(path), jax_t7.load_t7(path)
    assert_same_object(got, want)
    return got


ARRAYS = {dt.__name__: (np.arange(24).reshape(2, 3, 4) % 7).astype(dt)
          for dt in (np.float32, np.float64, np.int32, np.int64, np.uint8)}
ROUND_TRIPS = {
    **{f"scalar_{i}": v for i, v in enumerate((None, True, False, 3, 2.5, "hello"))},
    **{f"tensor_{k}": v for k, v in ARRAYS.items()},
    "table": {"a": 1, "b": [1.5, "x", None], "c": {"d": True}},
    "list": [10, 20, 30],
    "torch_class": {"torch_type": "nn.SpatialConvolution",
                    "weight": np.zeros((4, 3, 3, 3), np.float32),
                    "bias": np.zeros((4,), np.float32), "nInputPlane": 3, "nOutputPlane": 4},
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_round_trips_match_jax(tmp_path, case):
    obj = ROUND_TRIPS[case]
    back = both_read(both_write(tmp_path, obj, case))
    if isinstance(obj, np.ndarray):
        assert back.dtype == obj.dtype
        np.testing.assert_array_equal(back, obj)
    elif isinstance(obj, dict) and "weight" in obj:
        assert back["torch_type"] == obj["torch_type"] and back["weight"].shape == (4, 3, 3, 3)
    else:
        assert back == obj


def test_shared_reference_resolves_to_one_object(tmp_path):
    w = np.ones((2, 2), np.float32)
    mod = {"torch_type": "nn.Linear", "weight": w}
    back = both_read(both_write(tmp_path, [mod, mod, w], "shared"))
    assert back[0] is back[1] and back[0]["weight"] is back[2]


def pwc_params(frames=3, levels=5, past_flow=False, seed=0):
    """The port's seeded PWCNet as a flax-named tree of numpy arrays."""
    net = PWCNet(PWCConfig(frames=frames, levels=levels, past_flow=past_flow),
                 generator=torch.Generator().manual_seed(seed))
    return to_flax_params(net)


def assert_same_tree(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype, path
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}/{k}")


FIXTURES = {
    "gmodule": dict(),
    "gmodule_past_flow": dict(past_flow=True),
    "forwardnodes_only": dict(include_modules_key=False),
    "dpt_flat_frames5": dict(frames=5, flatten_storage=True, dpt=True),
    "spatialconvolutionmm": dict(conv_type="nn.SpatialConvolutionMM", mm_folded=True),
}


def fixture_file(tmp_path, case):
    kw = dict(FIXTURES[case])
    dpt = kw.pop("dpt", False)
    frames, past_flow = kw.get("frames", 3), kw.get("past_flow", False)
    params = pwc_params(frames=frames, past_flow=past_flow, seed=len(case))
    gm = build_gmodule(params, levels=5, **kw)
    path = tmp_path / f"{case}.t7"
    save_nngraph_t7(path, wrap_dpt(gm) if dpt else gm)
    return path, params, dict(frames=frames, levels=5, past_flow=past_flow)


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_nngraph_fixtures_read_and_convert_as_in_jax(tmp_path, case):
    path, params, kw = fixture_file(tmp_path, case)
    both_read(path)
    got = convert.convert_t7_checkpoint(str(path), **kw)
    want = jax.tree_util.tree_map(np.asarray, jax_convert.convert_t7_checkpoint(str(path), **kw))
    assert_same_tree(got, want)
    assert_same_tree(got, params)
    assert convert.inspect_t7(str(path)) == jax_convert.inspect_t7(str(path))


def test_strided_and_offset_views_read_as_in_jax(tmp_path):
    storage = np.arange(64, dtype=np.float32)
    obj = {"plain": TV(storage, (4, 4), (4, 1), 0), "offset": TV(storage, (3, 4), (4, 1), 8),
           "transposed": TV(storage, (4, 4), (1, 4), 0),
           "strided_rows": TV(storage, (4, 4), (8, 1), 0)}
    path = tmp_path / "views.t7"
    save_nngraph_t7(path, obj)
    back = both_read(path)
    np.testing.assert_array_equal(back["transposed"], storage[:16].reshape(4, 4).T)
    np.testing.assert_array_equal(back["strided_rows"], storage.reshape(8, 8)[:4, :4])
    np.testing.assert_array_equal(back["offset"], storage[8:20].reshape(3, 4))


def test_conversion_errors_match_jax(tmp_path):
    """A conv count that does not fit the graph, and siamese clones that
    are not value-equal (so dedup keeps them), raise the same ValueError
    in both packages."""
    params = pwc_params()
    bad_clone = build_gmodule(params, levels=5)
    first = next(m for m in bad_clone["modules"] if "weight" in m)
    clones = [m for m in bad_clone["modules"][1:] if "weight" in m
              and m["weight"].storage is first["weight"].storage]
    assert clones
    broken = clone_conv(first)
    broken["weight"] = TV(first["weight"].storage + 1.0, first["weight"].shape,
                          first["weight"].stride, first["weight"].offset)
    for node in bad_clone["forwardnodes"]:
        if node["data"].get("module") is clones[0]:
            node["data"]["module"] = broken
    bad_clone["modules"] = [broken if m is clones[0] else m for m in bad_clone["modules"]]
    cases = {"count": {"torch_type": "nn.gModule", "modules": [
                 {"torch_type": "nn.SpatialConvolution",
                  "weight": np.zeros((16, 3, 3, 3), np.float32),
                  "bias": np.zeros(16, np.float32)}]},
             "clone": bad_clone}
    for name, obj in cases.items():
        path = tmp_path / f"{name}.t7"
        save_nngraph_t7(path, obj)
        with pytest.raises(ValueError) as jax_err:
            jax_convert.convert_t7_checkpoint(str(path), frames=3, levels=5)
        with pytest.raises(ValueError) as port_err:
            convert.convert_t7_checkpoint(str(path), frames=3, levels=5)
        assert "conv count mismatch" in str(port_err.value)
        assert str(port_err.value) == str(jax_err.value), name


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The DataParallelTable-wrapped gModule fixture of a seeded levels-5
    PWCNet, its flax tree, and the seeded frames of a triplet."""
    root = tmp_path_factory.mktemp("t7conv")
    params = pwc_params(seed=4)
    path = root / "real.t7"
    save_nngraph_t7(path, wrap_dpt(build_gmodule(params, levels=5)))
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        p = root / f"f{i}.png"
        write_png(p, (rng.random((48, 80, 3)) * 255).astype(np.uint8))
        frames.append(str(p))
    return root, path, params, frames


def test_converted_fixture_serves_the_same_flow(converted):
    _, path, _, _ = converted
    tree = convert.convert_t7_checkpoint(str(path), levels=5)
    cfg = PWCConfig(levels=5)
    net = PWCNet(cfg)
    load_flax_params(net, tree)
    x = np.random.default_rng(1).standard_normal((1, 64, 128, 9)).astype(np.float32)
    jax_tree = jax_convert.convert_t7_checkpoint(str(path), levels=5)
    want = JaxPWCNet(JaxPWCConfig(levels=5)).apply({"params": jax_tree}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("flow", "occ"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]), err_msg=key, **TOL)


def test_convert_cli_round_trip_and_inspect(converted, capsys):
    root, path, params, _ = converted
    out = root / "cli_out"
    convert_t7.main([str(path), str(out), "--levels", "5"])
    assert capsys.readouterr().out.strip() == f"wrote {out / 'model_0.pt'}"
    assert {p.name for p in out.iterdir()} == {"model_0.pt", "optimState_0.pt", "options.json"}
    est = api.init(str(out), device="cpu", dtype="float32")
    assert est.config == PWCConfig(levels=5)
    assert_same_tree(to_flax_params(est.net), params)
    convert_t7.main([str(path), "--inspect"])
    lines = capsys.readouterr().out.splitlines()
    load_tool("convert_t7").main([str(path), "--inspect"])
    assert lines == capsys.readouterr().out.splitlines()
    assert lines[:2] == ["nn.DataParallelTable", "nn.gModule"] and len(lines) > 40
    with pytest.raises(SystemExit):
        convert_t7.main([str(path)])


def load_tool(name):
    """A module of tools/ by its path (tools/ itself stays off sys.path:
    its profile.py would shadow the standard library's)."""
    spec = importlib.util.spec_from_file_location(f"_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tools_parity():
    return load_tool("parity")


def test_parity_cli_matches_tools_parity(converted, tools_parity, capsys, monkeypatch):
    """On one f32 checkpoint written by the JAX package (the port reads its
    msgpack pair): the port's parity JSON equals tools/parity.py's (keys,
    values within 1e-4), against a reference flow and occlusion map made
    from JAX's own output; a tolerance below the AEPE exits 1."""
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    root, _, params, frames = converted
    opt = JaxOptions(levels=5, compute_dtype="float32").derive()
    ckpt = root / "jax_ckpt"
    jax_checkpoint.save_checkpoint(
        ckpt, jax_create_train_state(jax.tree_util.tree_map(jnp.asarray, params), opt), opt, 1)
    flow, fwd_occ, _ = tools_parity.run_triplet(str(ckpt), frames)
    ref = np.asarray(flow) + np.float32(0.01)
    flow_io.write_flo(root / "ref.flo", ref)
    write_png(root / "ref_occ.png", np.repeat(np.asarray(fwd_occ)[..., None] * 255, 3, -1)
              .astype(np.uint8))
    args = ["--checkpoint", str(ckpt), "--frames", *frames, "--ref_flo", str(root / "ref.flo"),
            "--ref_fwd_occ", str(root / "ref_occ.png")]
    results = {}
    for name, main in (("jax", tools_parity.main), ("port", parity.main)):
        capsys.readouterr()
        rc = main(args + ["--out", str(root / name), "--cpu", "--tolerance", "1.0"])
        results[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0
    got, want = results["port"], results["jax"]
    assert set(got) == set(want) and got["pass"] is True
    for k in want:
        if k != "out":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["aepe_px"], np.hypot(0.01, 0.01) * 20, rtol=1e-3)
    np.testing.assert_allclose(flow_io.load_flo(root / "port" / "flow.flo"),
                               flow_io.load_flo(root / "jax" / "flow.flo"), **TOL)
    assert {p.name for p in (root / "port").iterdir()} == \
        {"flow.flo", "flow.png", "fwd_occ.png", "bwd_occ.png"}
    assert parity.main(args + ["--out", str(root / "strict"), "--cpu", "--tolerance", "0.1"]) == 1


def test_parity_cli_from_t7(converted, capsys):
    """`--t7` converts and serves (the options' bf16 compute dtype): the
    flow written equals run_triplet on the converted tree."""
    root, path, _, frames = converted
    out = root / "from_t7"
    assert parity.main(["--t7", str(path), "--frames", *frames, "--levels", "5",
                        "--out", str(out), "--cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result) == {"out", "fwd_occ_rate", "bwd_occ_rate"}
    tree = convert.convert_t7_checkpoint(str(path), levels=5)
    flow, _, _ = parity.run_triplet((tree, PWCConfig(levels=5, dtype=torch.bfloat16)), frames,
                                    device="cpu")
    np.testing.assert_array_equal(flow_io.load_flo(out / "flow.flo"), flow)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            parity.main(["--t7", str(path), "--frames", *frames, "--levels", "5"])
