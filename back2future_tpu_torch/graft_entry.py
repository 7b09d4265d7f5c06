"""Launcher entry points of the port (counterpart of __graft_entry__.py):
a forward to compile-check and a data-parallel dry run.

    python -m back2future_tpu_torch.graft_entry 8 [--soft] [--cpu]

`entry()` returns the flagship bf16 forward (the multi-frame PWC net,
the reference's default `-netType pwc`, models/pwc.lua:87-508) and its
example input: `fn(x)` gives the finest level's (flow, occ).

`dryrun_multichip(n)` runs ONE step of the full unsupervised training
step (OBCC photometric + flow/occ smoothness + occlusion prior, the
reference's default `-optimize pme` recipe, train.lua:417-472) over
data-parallel ranks on tiny shapes, as the JAX package's dry run does
over a mesh of n devices: its global batch is B = n//2 for an even
n > 2 (the JAX mesh's data axis; its spatial axis is not ported, ROADMAP
item 11 (e)) and n otherwise, made with `randn * 0.1` from
RandomState(0) at 64x128, and the step runs on B ranks of one sample
each through DDP (parallel/launch.py starts them). Both nets start from
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
                 device: str) -> List[Dict]:
    """One rank of the dry run: one train step per recipe on its sample;
    its loss (the global batch's) and the kernel launches of the step."""
    from .losses import build_criterions
    from .runtime.cuda_build import KERNELS, reset_launches
    from .train import create_train_state, make_train_step

    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # f32 convs and matmuls in f32, not TF32: the recorded losses are f32's
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for soft in recipes:
        opt, net = _make_model("float32", optimize="pme", frames=3, levels=7,
                               batchSize=world, **RECIPES[soft])
        net = net.to(dev)
        state = create_train_state(net, opt)
        step = make_train_step(net, opt, build_criterions(opt))
        batch = {"images": torch.from_numpy(images[rank:rank + 1]).to(dev)}
        reset_launches()
        state, logs = step(state, batch)
        loss = float(logs["loss"])
        out.append({"soft": soft, "loss": loss, "device": str(dev),
                    "launches": {k: v.launches for k, v in KERNELS.items() if v.launches}})
    return out


def dryrun_multichip(n_devices: int, soft: Optional[bool] = None, device: str = "cuda",
                     backend: Optional[str] = None, timeout: float = 1200.0) -> List[List[Dict]]:
    """One pme train step over data-parallel ranks (module docstring).

    `soft` None runs the hard and then the soft recipe in the same ranks
    (one `ok` line each), False or True one of them. `device` "cuda"
    puts rank r on card r over NCCL (more ranks than cards raise) or,
    with `backend="gloo"`, on card r mod the count, so ranks may share a
    card; "cpu" runs the ranks on the CPU over gloo. The kernels are
    built before the ranks start. Returns each rank's records (loss,
    device, kernel launches of the step) in rank order."""
    from .parallel.launch import run_ranks

    b = n_devices // 2 if n_devices % 2 == 0 and n_devices > 2 else n_devices
    recipes = [False, True] if soft is None else [bool(soft)]
    if device == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device is available")
        backend = backend or "nccl"
        if backend == "nccl" and b > torch.cuda.device_count():
            raise ValueError(f"dryrun_multichip({n_devices}): {b} NCCL ranks need {b} cards, "
                             f"this host has {torch.cuda.device_count()}; pass "
                             f"backend='gloo' to let ranks share a card")
        from .runtime import cuda_build

        cuda_build.build()
    images = (np.random.RandomState(0).randn(b, H, W, 9).astype(np.float32) * 0.1)
    results = run_ranks(_dryrun_rank, b, (recipes, images, device), backend=backend,
                        rank0_here=False, timeout=timeout)
    for i, soft_i in enumerate(recipes):
        losses = [r[i]["loss"] for r in results]
        if not np.isfinite(losses[0]):
            raise RuntimeError(f"non-finite loss {losses[0]}")
        if len(set(losses)) != 1:
            raise RuntimeError(f"ranks disagree on the global loss: {losses}")
        kind = "soft" if soft_i else "hard"
        print(f"dryrun_multichip({n_devices}): mesh={{'data': {b}}} ({backend}, "
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
