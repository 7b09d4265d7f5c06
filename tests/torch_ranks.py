"""Rank functions for the port's multi-rank CPU tests
(tests/test_torch_parallel.py): module-level, so that a rank started
with the spawn method can import them, and free of JAX, which a rank
never needs.
"""

import torch


def cluster_checks(rank: int, world: int) -> dict:
    """The collectives and cross-rank checks of parallel.distributed in a
    group of `world` ranks: what each gave or raised."""
    from back2future_tpu_torch.parallel import distributed

    out = {"rank": distributed.process_index(), "world": distributed.process_count()}
    out["sum"] = float(distributed.all_reduce_sum(torch.tensor(float(rank + 1))))
    distributed.sync_hosts()
    distributed.assert_same_across_hosts("agree", "same-on-all-hosts")
    try:
        distributed.assert_same_across_hosts("diverge", f"host-{rank}-value")
        out["diverge"] = None
    except RuntimeError as e:
        out["diverge"] = str(e)
    try:
        distributed.host_local_batch_size(3)
        out["batch3"] = None
    except ValueError as e:
        out["batch3"] = str(e)
    out["batch4"] = distributed.host_local_batch_size(4)
    return out


def _options(kw: dict):
    from back2future_tpu_torch.config import Options

    return Options(**kw).derive()


def one_step(rank: int, world: int, cases: dict, batches: dict, seed: int,
             two_steps=()) -> dict:
    """For each case (name -> Options keywords): the port's net of `seed`,
    one train step on this rank's slice of the case's global batch; the
    step's logs, every parameter gradient as the optimiser received it
    (None gradients left out), and the parameters after its last step. The
    cases named in `two_steps` take a second step on the same slice,
    whose logs and gradients come under "second"."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.models.factory import model_and_config
    from back2future_tpu_torch.train import create_train_state, make_train_step

    out = {}
    for name, kw in cases.items():
        opt = _options(kw)
        net = model_and_config(opt, generator=torch.Generator().manual_seed(seed))[0]
        state = create_train_state(net, opt)
        step = make_train_step(net, opt, build_criterions(opt))
        batch = batches[name]
        b = batch["images"].shape[0] // world
        local = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]) for k, v in batch.items()}
        update = state.optimizer.step
        records = []
        for _ in range(2 if name in two_steps else 1):
            grads = {}

            def step_after_capture(grads=grads):
                grads.update({n: p.grad.numpy().copy() for n, p in net.named_parameters()
                              if p.grad is not None})
                update()

            state.optimizer.step = step_after_capture
            state, logs = step(state, local)
            records.append({"logs": {k: float(v) for k, v in logs.items()}, "grads": grads})
        out[name] = {**records[0],
                     "params": {n: p.detach().numpy().copy() for n, p in net.named_parameters()}}
        if len(records) > 1:
            out[name]["second"] = records[1]
    return out


def one_step_seeds(rank: int, world: int, cases: dict, batches: dict, seeds) -> dict:
    """`one_step` for each seed of `seeds`, by seed: one spawn of the
    ranks for several nets."""
    return {seed: one_step(rank, world, cases, batches, seed) for seed in seeds}


def spatial_group_checks(rank: int, world: int) -> dict:
    """A 2 x 2 data x spatial mesh of ranks (parallel/distributed.py
    `init_mesh_groups`): its slots, loss shares and reductions, and the
    row ops of parallel/spatial.py over the spatial group's gloo
    communicator in f32 and bf16, forward and backward, against the whole
    tensor (the bands' gradients against the whole gradient of the two
    ranks' summed losses)."""
    import numpy as np

    from back2future_tpu_torch.parallel import distributed
    from back2future_tpu_torch.parallel.spatial import gather_rows, halo_rows, shard_rows

    distributed.init_mesh_groups(2)
    try:
        comm = distributed.spatial_comm()
        s = comm.index
        out = {"data_index": distributed.data_index(), "data_count": distributed.data_count(),
               "spatial": distributed.spatial_count(),
               "loss_share": (distributed.loss_share(True), distributed.loss_share(False)),
               "data_sum": float(distributed.all_reduce_data(torch.tensor(float(rank + 1)))),
               "world_sum": float(distributed.all_reduce_sum(torch.tensor(float(rank + 1))))}
        ok = True
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(distributed.data_index())
            x = torch.from_numpy(rng.standard_normal((2, 8, 3, 2)).astype(np.float32)).to(dtype)
            g = [torch.from_numpy(rng.standard_normal((2, 8, 3, 2)).astype(np.float32))
                 .to(dtype) for _ in range(2)]
            band = x[:, 4 * s:4 * s + 4].clone().requires_grad_()
            whole = gather_rows(band, comm)
            ok &= torch.equal(whole, x)
            whole.backward(g[s])
            summed = (g[0].float() + g[1].float()).to(dtype)
            ok &= torch.equal(band.grad, summed[:, 4 * s:4 * s + 4])
            band.grad = None
            halo = halo_rows(band, 2, comm)
            padded = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 2, 2)).to(dtype)
            ok &= torch.equal(halo, padded[:, 4 * s:4 * s + 8])
            halo.backward(g[s])
            acc = torch.zeros(2, 12, 3, 2)
            for t in range(2):
                acc[:, 4 * t:4 * t + 8] += g[t].float()
            ok &= torch.equal(band.grad, acc[:, 2:10].to(dtype)[:, 4 * s:4 * s + 4])
            ok &= torch.equal(shard_rows(x, comm), x[:, 4 * s:4 * s + 4])
        out["ok"] = bool(ok)
        return out
    finally:
        distributed.init_mesh_groups(1)


def spatial_step(rank: int, world: int, cases: dict, batches: dict, seed: int,
                 spatial: int) -> dict:
    """For each case: the port's net of `seed` on a data x spatial mesh
    with `spatial` ranks a spatial group (rank = d * spatial + s), one
    train step of DDP on data slot d's slice of the global batch, whole
    rows (the net computes its row band); the step's logs, every
    parameter gradient the optimiser received, the channels of every
    tensor the net gathered whole and (image rows, flow rows, channels,
    y0) of every warp it made."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.models import pwc
    from back2future_tpu_torch.models.factory import model_and_config
    from back2future_tpu_torch.parallel import distributed
    from back2future_tpu_torch.train import create_train_state, make_train_step

    seen = {"gathered": [], "warps": []}
    gather, warp = pwc.gather_rows, pwc.warp_bilinear

    def gather_rows(x, comm):
        seen["gathered"].append(x.shape[-1])
        return gather(x, comm)

    def warp_bilinear(images, flow, **kw):
        seen["warps"].append((images.shape[1], flow.shape[1], images.shape[-1], kw.get("y0", 0)))
        return warp(images, flow, **kw)

    pwc.gather_rows, pwc.warp_bilinear = gather_rows, warp_bilinear
    distributed.init_mesh_groups(spatial)
    try:
        d, n = distributed.data_index(), distributed.data_count()
        out = {}
        for name, kw in cases.items():
            opt = _options(kw)
            net = model_and_config(opt, generator=torch.Generator().manual_seed(seed))[0]
            net.spatial_comm = distributed.spatial_comm()
            state = create_train_state(net, opt)
            step = make_train_step(net, opt, build_criterions(opt))
            batch = batches[name]
            b = batch["images"].shape[0] // n
            local = {k: torch.from_numpy(v[d * b:(d + 1) * b]) for k, v in batch.items()}
            grads = {}
            update = state.optimizer.step

            def capture():
                grads.update({k: p.grad.numpy().copy() for k, p in net.named_parameters()
                              if p.grad is not None})
                update()

            state.optimizer.step = capture
            for v in seen.values():
                v.clear()
            state, logs = step(state, local)
            out[name] = {"logs": {k: float(v) for k, v in logs.items()}, "grads": grads,
                         "plan": net._rows(batch["images"].shape[1]).plan,
                         **{k: list(v) for k, v in seen.items()}}
        return out
    finally:
        distributed.init_mesh_groups(1)
        pwc.gather_rows, pwc.warp_bilinear = gather, warp


# ------------------------------------------------- criteria on row bands

LOSS_B, LOSS_H, LOSS_W = 4, 16, 24
LOSS_CRITERIA = ("OBCC", "OBGCC", "MBCC", "SSIM", "SSIML1", "OSSIM", "OSSIML1", "smooth1",
                 "smooth2", "KL", "occ_prior", "const_vel", "L2")
# the criteria taken with sizeAverage on (the others sum)
LOSS_SIZE_AVERAGED = ("OBCC", "MBCC", "SSIML1", "OSSIM", "smooth1", "KL", "const_vel", "L2")
# the inputs that take a gradient, where a criterion reads them
LOSS_GRAD_INPUTS = ("flow", "flow_past", "occ", "warped1", "warped2")


def loss_inputs(seed: int = 0) -> dict:
    """A global batch of criterion inputs (numpy, f32): flows of a few
    pixels (some targets leave the image), a softmax occlusion map with
    values below the KL's clamp, two warped frames and the target, the
    ground truth and a mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (LOSS_B, LOSS_H, LOSS_W)

    def normal(*tail, scale=1.0):
        return (rng.standard_normal(shape + tail) * scale).astype(np.float32)

    logits = normal(2, scale=3.0)
    occ = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"flow": normal(2, scale=3.0), "flow_past": normal(2, scale=3.0),
            "occ": occ.astype(np.float32), "warped1": normal(3), "warped2": normal(3),
            "target": normal(3), "flow_gt": normal(2, scale=3.0),
            "mask": (rng.random(shape) > 0.3).astype(np.float32)}


def loss_criterion(name: str, reference_grads: bool):
    """(fn(inputs, band) -> the criterion's value, the factor of its share
    of the global value with `data` slots: 1/data for a mean over a fixed
    per-sample size)."""
    from back2future_tpu_torch import losses as L

    sa, rg = name in LOSS_SIZE_AVERAGED, reference_grads
    if name in ("OBCC", "OBGCC", "MBCC", "SSIM", "SSIML1", "OSSIM", "OSSIML1"):
        cfg = L.PhotoConfig(frames=3, size_average=sa, past_flow=True, beta=0.8, gamma=1.2,
                            penalty={"OBCC": "Quadratic", "MBCC": "Lorentzian"}.get(name, "L1"),
                            alpha={"SSIML1": 0.85, "OSSIML1": 0.85, "OBGCC": 0.7}.get(name, 1.0),
                            reference_grads=rg)
        factory = {"OBCC": L.make_obcc, "OBGCC": L.make_obgcc, "MBCC": L.make_mbcc,
                   "SSIM": L.make_mssim_l1, "SSIML1": L.make_mssim_l1,
                   "OSSIM": L.make_ossim_l1, "OSSIML1": L.make_ossim_l1}[name]
        crit = factory(cfg, 0.5)

        def fn(t, band):
            return crit(t["flow"], t["flow_past"], t["occ"], (t["warped1"], t["warped2"]),
                        t["target"], band=band)
    elif name in ("smooth1", "smooth2"):
        cfg = L.SmoothConfig(penalty="L1" if name == "smooth1" else "Lorentzian",
                             size_average=sa, second_order=name == "smooth2",
                             reference_grads=rg)
        crit = L.make_flow_smoothness(cfg)

        def fn(t, band):
            return crit(t["flow"], t["target"], band=band)
    elif name == "KL":
        crit = L.make_kl_smoothness(sa, rg)

        def fn(t, band):
            return crit(t["occ"], t["target"], band=band)
    elif name == "occ_prior":
        crit = L.make_occ_prior(sa, 1.0, rg)

        def fn(t, band):
            return crit(t["occ"], t["target"], band=band)
    elif name == "const_vel":
        crit = L.make_const_vel(sa, rg)

        def fn(t, band):
            return crit(t["flow"], t["flow_past"], band=band)
    else:
        crit = L.make_l2_criterion(sa, rg)

        def fn(t, band):
            return crit(t["flow"], t["flow_gt"], t["mask"], band=band)[0]
    return fn, sa and name != "L2"


def loss_band_grads(rank: int, world: int, spatials=(2, 4)) -> dict:
    """For each spatial axis S of `spatials` (a data x spatial mesh of the
    world), each criterion and `reference_grads`: this rank's share of
    the criterion on its data slot's batch slice and its row band, and
    the gradients of its band's inputs (None where it takes none)."""
    from back2future_tpu_torch.parallel import distributed
    from back2future_tpu_torch.parallel.spatial import Band

    whole = loss_inputs()
    out = {}
    try:
        for spatial in spatials:
            distributed.init_mesh_groups(spatial)
            comm = distributed.spatial_comm()
            d, n = distributed.data_index(), distributed.data_count()
            b, h = LOSS_B // n, LOSS_H // spatial
            band = Band(comm, comm.index * h, LOSS_H)
            for name in LOSS_CRITERIA:
                for rg in (True, False):
                    fn, averaged = loss_criterion(name, rg)
                    t = {k: torch.from_numpy(v[d * b:(d + 1) * b, band.y0:band.y0 + h].copy())
                         for k, v in whole.items()}
                    for k in LOSS_GRAD_INPUTS:
                        t[k].requires_grad_()
                    value = fn(t, band) * (1.0 / n if averaged else 1.0)
                    value.backward()
                    out[spatial, name, rg] = {
                        "value": float(value),
                        "grads": {k: None if t[k].grad is None else t[k].grad.numpy()
                                  for k in LOSS_GRAD_INPUTS}}
        return out
    finally:
        distributed.init_mesh_groups(1)
