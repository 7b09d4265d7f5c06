"""CPU test of the port's `run()` (train/loop.py) on a data x spatial mesh
of ranks against its data-parallel `run()`, as tests/test_loop.py holds
the JAX package's `--mesh_axes data,spatial` run against pure data
parallelism.

`run()` with `--platform cpu -nGPU 4 --mesh_shape 2,2 --mesh_axes
data,spatial` (rank 0 in this process, ranks 1-3 spawned; each data
slot's two ranks load its half of every batch and compute row bands of
it: at 32x64, levels 4 and win 9, levels 1-3 in bands, level 4 whole)
against `run()` with `-nGPU 2` on the data axis alone, on the toy tree
of tests/test_multiprocess.py (2 train / 3 val samples), 2 epochs of 2
steps from one seeded net: train.log and test.log within rtol 2e-3 and
atol 1e-5 (tests/test_loop.py's tolerance); rank 0 writes the logs and
the checkpoints, the spatial ranks keep `.host{r}` side logs.
"""

import numpy as np
import torch

from back2future_tpu_torch.config import Options
from back2future_tpu_torch.train.loop import run
from back2future_tpu_torch.utils import SymbolLogger
from test_multiprocess import _toy_tree

torch.set_num_threads(1)


def options(root, **kw):
    base = dict(dataset="toy", datasets_dir=str(root / "datasets"), data_root=str(root),
                cache=str(root / "ckpt"), optimize="pme", frames=3, levels=4, pwc_ws=9,
                compute_dtype="float32", cropHeight=32, cropWidth=64, batchSize=2,
                epochSize=2, nEpochs=2, nDonkeys=0, epochStore=2, platform="cpu", LR=1e-3)
    base.update(kw)
    return Options(**base).derive(make_dirs=True)


def test_spatial_run_matches_data_parallel_run(tmp_path, monkeypatch):
    monkeypatch.setenv("B2F_DIST_TIMEOUT", "120")
    _toy_tree(tmp_path)
    plain = options(tmp_path, expName="data", nGPU=2)
    spatial = options(tmp_path, expName="spatial", nGPU=4, mesh_shape=(2, 2),
                      mesh_axes=("data", "spatial"))
    run(plain)
    state = run(spatial)
    assert not torch.distributed.is_initialized() and state.step == 4
    assert state.model.spatial_comm is not None
    for log in ("train.log", "test.log"):
        want = SymbolLogger(tmp_path / "ckpt" / "data" / log).read()
        got = SymbolLogger(tmp_path / "ckpt" / "spatial" / log).read()
        assert list(got) == list(want) and len(got[next(iter(got))]) == 2
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-5, err_msg=k)
        for r in (1, 2, 3):
            assert (tmp_path / "ckpt" / "spatial" / f"{log}.host{r}").exists()
    assert (tmp_path / "ckpt" / "spatial" / "model_2.pt").exists()
