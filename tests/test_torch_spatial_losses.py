"""CPU tests of the port's criteria on row bands (losses/common.py,
parallel/spatial.py `Band`) against the same criteria on whole tensors.

Every criterion of the library: OBCC, OBGCC, MBCC, the SSIM family
(SSIM, SSIML1, OSSIM, OSSIML1), first- and second-order smoothness, KL,
the occlusion prior, const_vel and the L2, with `reference_grads` on and
off, on a (4, 16, 24) batch whose rows are cut in S = 2 and S = 4 bands
(so bands touch the image's top and bottom edges, and inner edges).

* Values: S slots that are threads of one process (`ThreadGroup`), under
  `no_grad`; the slots' values summed against the whole value at rtol
  1e-5. The threads stand in for ranks, so the two world reductions the
  criteria make (the SSIM family's min/max, the L2's mask count) reduce
  over the slots here.
* Gradients: 4 gloo ranks as a data x spatial mesh of (2, 2), then of
  (1, 4); each rank's share of the criterion on its data slot's half (the
  whole batch at S = 4) and its band, `backward`, against the whole
  criterion's gradient of the global batch in those rows: within 1e-5 of
  max|g| per input; the shares summed against the whole value at rtol
  1e-5. Where a criterion gives an input no gradient (the reference
  backwards' flow), the bands give none either.

One worker: ~20 s.
"""

import threading

import numpy as np
import pytest
import torch

import torch_ranks
from back2future_tpu_torch.losses import photometric, supervised
from back2future_tpu_torch.parallel import launch
from back2future_tpu_torch.parallel.spatial import Band, ThreadGroup, run_slots

torch.set_num_threads(1)

CASES = [(name, s, rg) for name in torch_ranks.LOSS_CRITERIA for s in (2, 4)
         for rg in (True, False)]
IDS = [f"{n}-S{s}-{'ref' if rg else 'autograd'}" for n, s, rg in CASES]

_slot = threading.local()


def _slot_reduce(op):
    """A world reduction over the thread slots of the calling thread's
    spatial group (the identity outside a slot)."""
    def reduce(t):
        comm = getattr(_slot, "comm", None)
        return t if comm is None else op(torch.stack(comm.all_gather(t)), 0)
    return reduce


def whole_inputs():
    return {k: torch.from_numpy(v) for k, v in torch_ranks.loss_inputs().items()}


def whole_value_and_grads(name, rg):
    fn, _ = torch_ranks.loss_criterion(name, rg)
    t = whole_inputs()
    for k in torch_ranks.LOSS_GRAD_INPUTS:
        t[k].requires_grad_()
    value = fn(t, None)
    value.backward()
    return float(value), {k: None if t[k].grad is None else t[k].grad.numpy()
                          for k in torch_ranks.LOSS_GRAD_INPUTS}


@pytest.mark.parametrize("name,spatial,rg", CASES, ids=IDS)
def test_criterion_on_thread_bands_sums_to_the_whole_value(monkeypatch, name, spatial, rg):
    monkeypatch.setattr(photometric, "all_reduce_max", _slot_reduce(torch.amax))
    monkeypatch.setattr(supervised, "all_reduce_sum", _slot_reduce(torch.sum))
    fn, _ = torch_ranks.loss_criterion(name, rg)
    whole = whole_inputs()
    h = torch_ranks.LOSS_H // spatial
    group = ThreadGroup(spatial, timeout=60)

    def slot(s):
        def run():
            _slot.comm = comm = group.comm(s)
            try:
                with torch.no_grad():
                    return float(fn({k: v[:, s * h:(s + 1) * h] for k, v in whole.items()},
                                    Band(comm, s * h, torch_ranks.LOSS_H)))
            finally:
                _slot.comm = None
        return run

    parts = run_slots([slot(s) for s in range(spatial)], [group])
    with torch.no_grad():
        want = float(fn(whole, None))
    np.testing.assert_allclose(sum(parts), want, rtol=1e-5)


@pytest.fixture(scope="module")
def rank_grads():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("B2F_DIST_TIMEOUT", "120")
        return launch.run_ranks(torch_ranks.loss_band_grads, 4, rank0_here=False, timeout=300)


@pytest.mark.parametrize("name,spatial,rg", CASES, ids=IDS)
def test_criterion_gradients_on_rank_bands_match_the_whole(rank_grads, name, spatial, rg):
    value, grads = whole_value_and_grads(name, rg)
    data = 4 // spatial
    b, h = torch_ranks.LOSS_B // data, torch_ranks.LOSS_H // spatial
    np.testing.assert_allclose(sum(r[spatial, name, rg]["value"] for r in rank_grads), value,
                               rtol=1e-5)
    for k, want in grads.items():
        for rank, r in enumerate(rank_grads):
            got = r[spatial, name, rg]["grads"][k]
            if want is None:
                assert got is None, (k, rank)
                continue
            d, s = divmod(rank, spatial)
            part = want[d * b:(d + 1) * b, s * h:(s + 1) * h]
            np.testing.assert_allclose(got, part, rtol=0, atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{k} rank {rank}")
