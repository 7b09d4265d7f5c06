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
