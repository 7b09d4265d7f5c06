"""CPU parity of the port's observability and CLI front end against the
JAX package: `SymbolLogger` TSVs and SVG plots byte for byte (fresh and
resumed from a Lua-style header with its trailing tab), `TeeLogger`,
`parse_args` field for field on several argv sets (and the same errors),
the loop's console lines string for string, and `maybe_profile`'s
Chrome trace.
"""

import dataclasses
import json

import pytest
import torch

from back2future_tpu.config import parse_args as jax_parse_args
from back2future_tpu.train.loop import _fmt_console as jax_fmt_console
from back2future_tpu.utils import SymbolLogger as JaxSymbolLogger
from back2future_tpu.utils import TeeLogger as JaxTeeLogger
from back2future_tpu_torch.config import parse_args
from back2future_tpu_torch.train.loop import _fmt_console
from back2future_tpu_torch.utils import StepTimer, SymbolLogger, TeeLogger, maybe_profile

torch.set_num_threads(1)

ROWS = [{"avg loss (train set)": 17.4553, "avg epe (train set)": 1.75671},
        {"avg loss (train set)": 1.2e-7, "avg epe (train set)": float("nan")},
        {"avg loss (train set)": -3.0e5},
        {"avg loss (train set)": 0.0, "avg epe (train set)": float("inf")}]


@pytest.mark.parametrize("resumed", [False, True], ids=["fresh", "lua_header"])
def test_symbol_logger_bytes_match_jax(tmp_path, resumed):
    paths = {}
    for pkg, cls in (("jax", JaxSymbolLogger), ("port", SymbolLogger)):
        path = tmp_path / pkg / "train.log"
        if resumed:   # a reference-written log: trailing tab after the last name
            path.parent.mkdir()
            path.write_text("avg loss (train set)\tavg epe (train set)\t\n"
                            " 2.0000e+01\t 3.0000e+00\t\n")
        logger = cls(path)
        logger.style({"avg epe (train set)": "+"})
        for row in ROWS:
            logger.add(row)
        with pytest.raises(ValueError):
            logger.add({"unknown": 1.0})
        paths[pkg] = (path, logger.plot())
        assert logger.read()["avg loss (train set)"][-1] == 0.0
    (jax_file, jax_svg), (file, svg) = paths["jax"], paths["port"]
    assert file.read_bytes() == jax_file.read_bytes()
    assert svg.name == "train.svg" and svg.read_bytes() == jax_svg.read_bytes()


def test_tee_logger_matches_jax(tmp_path, capsys):
    for pkg, cls in (("jax", JaxTeeLogger), ("port", TeeLogger)):
        with cls(tmp_path / pkg / "log"):
            print("line one")
            print({"a": 1}, end="")
        print("after")
    out = capsys.readouterr().out
    assert out == "line one\n{'a': 1}after\n" * 2
    assert (tmp_path / "port" / "log").read_text() == (tmp_path / "jax" / "log").read_text() \
        == "line one\n{'a': 1}"


ARGV_SETS = {
    "defaults": [],
    "bools_and_toy": ["--ground_truth", "1", "--cont", "true", "--no_occ", "yes",
                      "--past_flow", "0", "--epochSize", "2", "--fineWidth", "128",
                      "--fineHeight", "64", "--LR", "1e-3", "--platform", "cpu"],
    "tuples": ["--mesh_shape", "4,2", "--mesh_axes", "data,spatial", "--nGPU", "8"],
    "derived_kitti": ["--dataset", "Kitti2015", "--frames", "5", "--optimize", "epe",
                      "--epe", "1", "--wire", "compact"],
    "derived_crop_scale": ["--scale", "0.5", "--cropWidth", "320", "--cropHeight", "192",
                           "--netType", "spynet", "--convert_to_soft", "1",
                           "--adam_reset_per_epoch", "false"],
}


@pytest.mark.parametrize("name", sorted(ARGV_SETS))
def test_parse_args_matches_jax(tmp_path, name):
    argv = ARGV_SETS[name] + ["--expName", name]
    want = jax_parse_args(argv + ["--cache", str(tmp_path / "jax")])
    got = parse_args(argv + ["--cache", str(tmp_path / "port")])
    w, g = dataclasses.asdict(want), dataclasses.asdict(got)
    assert set(w) == set(g)
    for k in w:
        if k not in ("cache", "save"):
            assert g[k] == w[k], k
    assert got.save == str(tmp_path / "port" / name)
    logged = json.loads((tmp_path / "port" / name / "log").read_text())
    assert logged["expName"] == name


@pytest.mark.parametrize("argv", [["--wire", "bogus"],
                                  ["--wire", "compact", "--normalize_images", "0"]],
                         ids=["unknown_wire", "compact_unnormalised"])
def test_parse_args_rejects_what_jax_rejects(tmp_path, argv):
    with pytest.raises(ValueError) as jax_err:
        jax_parse_args(argv + ["--cache", str(tmp_path)])
    with pytest.raises(ValueError) as port_err:
        parse_args(argv + ["--cache", str(tmp_path)])
    assert str(port_err.value) == str(jax_err.value)


CONSOLE_LOGS = [
    {"loss": 17.4761, "pme": 15.1, "sflow": 0.004, "socc": 0.0, "gocc": 2.3},
    {"loss": 1.0, "pme": 0.5, "sflow": 0.25, "socc": 0.125, "gocc": 0.1, "sup_flow": 0.0,
     "epe": 1.745, "epe_nocc": 1.7, "epe_occ": 9.5, "occ_acc": 0.75, "occ_acc_bwd": 0.5,
     "occ_acc_vis": 1.0, "occ_acc_fwd": 0.0},
    {},
]


@pytest.mark.parametrize("logs", CONSOLE_LOGS, ids=["unsupervised", "ground_truth", "empty"])
def test_console_lines_match_jax(logs):
    args = (3, 7, 16, 0.123456, 2.5, logs, 5e-5)
    assert _fmt_console(*args) == jax_fmt_console(*args)


def test_step_timer_and_profile(tmp_path):
    timer = StepTimer()
    timer.data_loaded()
    timer.step_done()
    assert timer.data_time >= 0 and timer.step_time >= 0
    with maybe_profile(""):
        pass
    with maybe_profile(str(tmp_path / "trace")):
        torch.ones(8).add_(1)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("add_" in e.get("name", "") for e in trace["traceEvents"])
