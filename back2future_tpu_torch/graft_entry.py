"""Launcher entry points of the port (counterpart of __graft_entry__.py):
a forward to compile-check and a data-parallel dry run.

    python -m back2future_tpu_torch.graft_entry 8 [--soft] [--cpu]

`entry()` returns the flagship bf16 forward (the multi-frame PWC net,
the reference's default `-netType pwc`, models/pwc.lua:87-508) and its
example input: `fn(x)` gives the finest level's (flow, occ).

`dryrun_multichip(n)` runs ONE step of the full unsupervised training
step (OBCC photometric + flow/occ smoothness + occlusion prior, the
reference's default `-optimize pme` recipe, train.lua:417-472) over
n ranks on tiny shapes, as the JAX package's dry run does over a mesh of
n devices: for an even n > 2 a data x spatial mesh of (n//2, 2), whose
global batch of B = n//2 samples is split over the data axis and whose
image rows are sharded over the spatial one (parallel/spatial.py: at
64 rows, levels 1-4 in bands of 32 .. 4 rows, levels 5-7 whole); else
n data-parallel ranks of one sample each. The batch is made with
`randn * 0.1` from RandomState(0) at 64x128, and the step runs through
DDP (parallel/launch.py starts the ranks). Both nets start from
the JAX package's `init(PRNGKey(0))` (models/flax_init.py), so the dry
run of n = 8 logs the losses that the JAX package's recorded, 49.97828
(hard) and 100.98643 (soft) (MULTICHIP_r05.json), up to f32 sum order.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Options
from .models import PWCNet, pwc_config_from_options
from .models.flax_init import load_flax_init

H, W = 64, 128
RECIPES = {
    False: dict(pme_criterion="OBCC", past_flow=False),
    True: dict(pme_criterion="OBGCC", past_flow=True, const_vel=1.0,
               smooth_second_order=True),
}


def _make_model(compute_dtype: str = "float32", **kw):
    opt = Options(compute_dtype=compute_dtype, reference_grads=True, **kw).derive()
    return opt, load_flax_init(PWCNet(pwc_config_from_options(opt)), 0)


def entry(device="cuda"):
    """-> (fn, example_args): the flagship 3-frame forward in bf16 on
    `device`, from the JAX package's PRNGKey(0) weights; fn(x) with x
    (B, H, W, 9) float32 returns the finest (flow, occ)."""
    _, net = _make_model("bfloat16")
    device = torch.device(device)
    net = net.to(device).eval()
    x = torch.zeros((1, H, W, 9), dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(x):
        g = net(x, with_warped=False)[0]
        return g["flow"], g["occ"]

    return fn, (x,)


def _rank_device(rank: int, device: str) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _dryrun_rank(rank: int, world: int, recipes: List[bool], images: np.ndarray,
                 device: str, spatial: int) -> List[Dict]:
    """One rank of the dry run: one train step per recipe on its data
    slot's sample (its row band of it with a spatial axis); its loss (the
    global batch's) and the kernel launches of the step."""
    from .losses import build_criterions
    from .parallel import distributed
    from .runtime.cuda_build import KERNELS, reset_launches
    from .train import create_train_state, make_train_step

    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # f32 convs and matmuls in f32, not TF32: the recorded losses are f32's
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    distributed.init_mesh_groups(spatial)
    d = distributed.data_index()
    out = []
    try:
        for soft in recipes:
            opt, net = _make_model("float32", optimize="pme", frames=3, levels=7,
                                   batchSize=distributed.data_count(), **RECIPES[soft])
            net = net.to(dev)
            if spatial > 1:
                net.spatial_comm = distributed.spatial_comm()
            state = create_train_state(net, opt)
            step = make_train_step(net, opt, build_criterions(opt))
            batch = {"images": torch.from_numpy(images[d:d + 1]).to(dev)}
            reset_launches()
            state, logs = step(state, batch)
            loss = float(logs["loss"])
            out.append({"soft": soft, "loss": loss, "device": str(dev),
                        "launches": {k: v.launches for k, v in KERNELS.items() if v.launches},
                        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                       if dev.type == "cuda" else 0)})
    finally:
        distributed.init_mesh_groups(1)
    return out


def dryrun_multichip(n_devices: int, soft: Optional[bool] = None, device: str = "cuda",
                     backend: Optional[str] = None, timeout: float = 1200.0) -> List[List[Dict]]:
    """One pme train step over the ranks of a mesh (module docstring).

    `soft` None runs the hard and then the soft recipe in the same ranks
    (one `ok` line each), False or True one of them. `device` "cuda"
    puts rank r on card r over NCCL (more ranks than cards raise) or,
    with `backend="gloo"`, on card r mod the count, so ranks may share a
    card; "cpu" runs the ranks on the CPU over gloo. The kernels are
    built before the ranks start. Returns each rank's records (loss,
    device, kernel launches of the step, peak device memory) in rank
    order."""
    from .parallel.launch import run_ranks

    spatial = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    b = n_devices // spatial
    recipes = [False, True] if soft is None else [bool(soft)]
    if device == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device is available")
        backend = backend or "nccl"
        if backend == "nccl" and n_devices > torch.cuda.device_count():
            raise ValueError(f"dryrun_multichip({n_devices}): {n_devices} NCCL ranks need "
                             f"{n_devices} cards, "
                             f"this host has {torch.cuda.device_count()}; pass "
                             f"backend='gloo' to let ranks share a card")
        from .runtime import cuda_build

        cuda_build.build()
    images = (np.random.RandomState(0).randn(b, H, W, 9).astype(np.float32) * 0.1)
    results = run_ranks(_dryrun_rank, n_devices, (recipes, images, device, spatial),
                        backend=backend, rank0_here=False, timeout=timeout)
    for i, soft_i in enumerate(recipes):
        losses = [r[i]["loss"] for r in results]
        if not np.isfinite(losses[0]):
            raise RuntimeError(f"non-finite loss {losses[0]}")
        if len(set(losses)) != 1:
            raise RuntimeError(f"ranks disagree on the global loss: {losses}")
        kind = "soft" if soft_i else "hard"
        mesh = {"data": b, "spatial": spatial} if spatial > 1 else {"data": b}
        print(f"dryrun_multichip({n_devices}): mesh={mesh} ({backend}, "
              f"{results[0][i]['device']}) [{kind}] loss={losses[0]:.5f} ok", flush=True)
    return results


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    counts = [a for a in argv if not a.startswith("-")]
    n = int(counts[0]) if counts else 8
    dryrun_multichip(n, soft=True if "--soft" in argv else None,
                     device="cpu" if "--cpu" in argv else "cuda")


if __name__ == "__main__":
    main()
