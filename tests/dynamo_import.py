"""Import torch._dynamo with tools/ off sys.path (for the port's test files).

torch.optim imports torch._dynamo at its first call, which imports the
standard library's `profile` through cProfile. Test files that are
collected earlier in the same worker (test_learn_demo.py,
test_parity_demo.py) put tools/ first on sys.path, where tools/profile.py
would shadow it. A test file that builds a torch optimiser calls
`import_dynamo_from_stdlib_path()` before it imports anything that puts
tools/ on the path.
"""

import sys
from pathlib import Path

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def import_dynamo_from_stdlib_path() -> None:
    saved = sys.path[:]
    sys.path[:] = [p for p in saved if Path(p or ".").resolve() != TOOLS]
    shadow = sys.modules.get("profile")
    if shadow is not None and Path(getattr(shadow, "__file__", "") or ".").parent == TOOLS:
        del sys.modules["profile"]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.path[:] = saved
