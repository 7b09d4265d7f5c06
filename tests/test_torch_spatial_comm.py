"""CPU tests of the port's row sharding primitives
(back2future_tpu_torch.parallel.spatial, the spatial axis of
parallel/mesh.py and the data x spatial groups of parallel/distributed.py).

* `halo_rows`, `gather_rows` and `shard_rows`, forward and backward, on
  S = 2 and 3 slots that are threads of this process (`ThreadGroup`),
  against the unsharded tensors: the bands assembled, and each band's
  gradient against the whole tensor's gradient of the slots' summed
  losses, bit for bit in f32 and bf16 (the sums are of at most S terms,
  in slot order).
* `level_plan` at the sizes of the flagship and of the dry run.
* `shard_batch(..., spatial=True)` and `Mesh.slot_devices` against the
  JAX package's placement on a data x spatial mesh of CPU devices.
* A failing slot breaks its group's barrier: the others raise at once,
  and its own error is the one raised.
* The process-group backend (`GroupComm`, gloo) on a 2 x 2 mesh of
  spawned ranks: the subgroups, data slots, loss shares and data-group
  reductions, and the three ops in f32 and bf16 against the whole tensor.
"""

import threading

import numpy as np
import pytest
import torch

import jax

import torch_ranks
from back2future_tpu.parallel import mesh as jax_mesh
from back2future_tpu_torch.parallel import launch, mesh
from back2future_tpu_torch.parallel.spatial import (
    ThreadGroup, gather_rows, halo_rows, level_plan, run_slots, shard_rows,
)

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


def whole_tensor(h, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((2, h, 5, 3)).astype(np.float32)).to(dtype)


def on_slots(size, fn):
    """fn(comm) on `size` threaded slots of one group; results in slot order."""
    group = ThreadGroup(size, timeout=60)
    return run_slots([lambda s=s: fn(group.comm(s)) for s in range(size)], [group])


def band_of(x, s, size):
    h = x.shape[1] // size
    return x[:, s * h:(s + 1) * h]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("size,k", [(2, 1), (2, 4), (3, 1), (3, 2)])
def test_halo_rows_forward_backward(size, k, dtype):
    h = 4
    x = whole_tensor(size * h, dtype)
    padded = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, k, k)).to(dtype)
    grads = [whole_tensor(h + 2 * k, dtype, seed=10 + s) for s in range(size)]

    def slot(comm):
        band = band_of(x, comm.index, size).clone().requires_grad_()
        out = halo_rows(band, k, comm)
        out.backward(grads[comm.index])
        return out.detach(), band.grad

    results = on_slots(size, slot)
    want_grad = torch.zeros_like(padded, dtype=torch.float32)
    for s, (out, _) in enumerate(results):
        assert torch.equal(out, padded[:, s * h:s * h + h + 2 * k])
        want_grad[:, s * h:s * h + h + 2 * k] += grads[s].float()
    got = torch.cat([g for _, g in results], dim=1)
    assert torch.equal(got, want_grad[:, k:k + size * h].to(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("size", [2, 3])
def test_gather_rows_forward_backward(size, dtype):
    x = whole_tensor(size * 3, dtype)
    grads = [whole_tensor(size * 3, dtype, seed=20 + s) for s in range(size)]

    def slot(comm):
        band = band_of(x, comm.index, size).clone().requires_grad_()
        out = gather_rows(band, comm)
        out.backward(grads[comm.index])
        return out.detach(), band.grad

    results = on_slots(size, slot)
    total = sum(g.float() for g in grads).to(dtype)
    for s, (out, grad) in enumerate(results):
        assert torch.equal(out, x)
        assert torch.equal(grad, band_of(total, s, size))


@pytest.mark.parametrize("size", [2, 3])
def test_shard_rows_forward_backward(size):
    x = whole_tensor(size * 2, torch.float32)
    grads = [whole_tensor(2, torch.float32, seed=30 + s) for s in range(size)]

    def slot(comm):
        whole = x.clone().requires_grad_()
        out = shard_rows(whole, comm)
        out.backward(grads[comm.index])
        return out.detach(), whole.grad

    results = on_slots(size, slot)
    for s, (out, _) in enumerate(results):
        assert torch.equal(out, band_of(x, s, size))
    # the slots' gradients of the replicated tensor are parts of its whole
    # gradient: they sum to it
    assert torch.equal(sum(g for _, g in results), torch.cat(grads, dim=1))


def test_level_plan():
    # the flagship: 320 rows, levels 7, frames 3 (halo 4): levels 1-6
    # in bands of 160 .. 5 rows, level 7 (5 rows) whole
    assert level_plan(320, 2, 7, 4) == (True,) * 6 + (False,)
    # the dry run's 64 rows: levels 1-4 in bands of 32 .. 4 rows
    assert level_plan(64, 2, 7, 4) == (True,) * 4 + (False,) * 3
    assert level_plan(64, 2, 7, 8) == (True,) * 3 + (False,) * 4   # frames 5: halo 8
    assert level_plan(64, 3, 7, 1) == (False,) * 7                 # 3 does not divide 64
    assert level_plan(48, 3, 5, 4) == (True,) * 3 + (False,) * 2
    assert level_plan(64, 1, 7, 4) == (True,) * 5 + (False,) * 2


def test_shard_batch_spatial_matches_jax():
    rng = np.random.default_rng(1)
    batch = {"x": rng.standard_normal((4, 6, 3)).astype(np.float32),
             "odd": rng.standard_normal((4, 5)).astype(np.float32),   # 5 rows: not split
             "flat": rng.standard_normal((4,)).astype(np.float32)}
    jmesh = jax_mesh.make_mesh(jax.devices()[:4], shape=(2, 2), axes=("data", "spatial"))
    want = jax_mesh.shard_batch(batch, jmesh, spatial=True)
    pmesh = mesh.make_mesh(["cpu"] * 4, shape=(2, 2), axes=("data", "spatial"))
    assert pmesh.shape == dict(jmesh.shape) == {"data": 2, "spatial": 2}
    assert len(pmesh.slot_devices()) == 4 and len(pmesh.data_devices()) == 2
    got = mesh.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, pmesh,
                           spatial=True)
    assert len(got) == 4
    for key, arr in want.items():
        slot_of = {d: i for i, d in enumerate(jmesh.devices.flat)}
        for shard in arr.addressable_shards:
            np.testing.assert_array_equal(got[slot_of[shard.device]][key].numpy(),
                                          np.asarray(shard.data), err_msg=key)
    # without `spatial` the mesh places by its data axis alone, as JAX's
    plain = mesh.shard_batch(torch.from_numpy(batch["x"]), pmesh)
    jplain = jax_mesh.shard_batch({"x": batch["x"]}, jmesh)["x"]
    for shard in jplain.addressable_shards:
        d = list(jmesh.devices.flat).index(shard.device) // 2
        np.testing.assert_array_equal(plain[d].numpy(), np.asarray(shard.data))
    # a partial batch is replicated whole, rows included
    part = mesh.shard_batch(torch.from_numpy(batch["x"][:3]), pmesh, spatial=True,
                            allow_partial=True)
    assert all(torch.equal(p, torch.from_numpy(batch["x"][:3])) for p in part)


def test_failing_slot_breaks_the_barrier():
    group = ThreadGroup(2, timeout=60)
    entered = threading.Event()

    def bad():
        entered.wait(10)
        raise RuntimeError("slot 1 failed")

    def good():
        entered.set()
        return group.comm(0).all_gather(torch.ones(2))

    with pytest.raises(RuntimeError, match="slot 1 failed"):
        run_slots([good, bad], [group])
    # the group is usable again afterwards
    assert [t.tolist() for t in on_slots(2, lambda c: c.all_gather(torch.ones(1) * c.index)[1])] \
        == [[1.0], [1.0]]


def test_group_comm_on_a_2x2_mesh_of_ranks(monkeypatch):
    monkeypatch.setenv("B2F_DIST_TIMEOUT", "120")
    results = launch.run_ranks(torch_ranks.spatial_group_checks, 4, (), rank0_here=False,
                               timeout=300)
    for rank, r in enumerate(results):
        assert r["data_index"] == rank // 2 and r["data_count"] == 2 and r["spatial"] == 2
        assert r["loss_share"] == (0.25, 0.5)   # 1/(D*S) for sizeAverage, 1/S for sums
        # the data group of band s holds ranks s and s + 2
        assert r["data_sum"] == (rank % 2 + 1) + (rank % 2 + 3)
        assert r["world_sum"] == 10
        assert r["ok"], r
