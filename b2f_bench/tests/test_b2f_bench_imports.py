"""What the harness loads: no top-level `jax`, `jaxlib`, `flax` or
`back2future_tpu` (the JAX package; compared by whole top-level names,
as `back2future_tpu_torch` begins with it) after importing every module
of the harness and the program's modules it drives; and nothing of the
program in the plain reference.

Run with: python -m pytest b2f_bench/tests -q
"""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "b2f_bench"
HARNESS = ["b2f_bench.run", "b2f_bench.calibrate", "b2f_bench.faults", "b2f_bench.harness",
           "b2f_bench.kinds.serve", "b2f_bench.kinds.train", "b2f_bench.metrics.mfu",
           "b2f_bench.metrics.kernel_roofline", "b2f_bench.metrics.device_idle",
           "b2f_bench.metrics.enqueue_ms", "back2future_tpu_torch.models.factory",
           "back2future_tpu_torch.train", "back2future_tpu_torch.losses",
           "back2future_tpu_torch.config"]
REFERENCE = ["b2f_bench.reference.common", "b2f_bench.reference.pwc",
             "b2f_bench.reference.spynet", "b2f_bench.reference.recipe"]


def _top_level_after(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    return set(__import__("json").loads(proc.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_not_the_jax_package():
    loaded = _top_level_after(HARNESS)
    assert "back2future_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "back2future_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    loaded = _top_level_after(REFERENCE)
    assert not loaded & {"back2future_tpu_torch", "back2future_tpu", "jax", "jaxlib", "flax"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(n.split(".")[0].startswith("back2future") for n in names), path
