"""CPU parity of the port's metrics and its eval step against the JAX
package (back2future_tpu/train/metrics.py, train/step.py).

* `decode_occ` for the 1-, 2- and 3-channel heads, on the half-way ties
  (round half to even in both) and argmax ties (the first maximum in
  both), exactly.
* `fl_all`, `occ_f1` and `full_res_metrics` on seeded inputs, with and
  without an occlusion head, an empty occluded region and masked pixels:
  rtol 1e-5 (sums in another order).
* `make_eval_step`'s logs, and the train step's ground-truth logs of its
  first step, against JAX's jitted steps from the same weights (the tiny
  f32 config: levels 4, win 3, B=2, 32x64): rtol/atol 1e-4.
"""


import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp

from back2future_tpu.config import Options
from back2future_tpu.losses import build_criterions as jax_build_criterions
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.train import metrics as jax_metrics
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu.train.step import make_eval_step as jax_make_eval_step
from back2future_tpu.train.step import make_train_step as jax_make_train_step
from back2future_tpu_torch.losses import build_criterions
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from back2future_tpu_torch.train import metrics

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **tol)


TIES = {
    1: np.array([0.0, 0.25, 0.5, 0.75, 1.0, 0.125, 0.375, 0.625], np.float32)[:, None],
    2: np.array([[0.5, 0.0], [0.0, 0.5], [0.25, 0.75], [1.0, 0.0], [0.75, 0.25],
                 [0.0, 1.0], [0.5, 0.5], [0.25, 0.25]], np.float32),
    3: np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [0, 0, 1], [0, 1, 0],
                 [1, 0, 0], [0.5, 0.5, 0.25]], np.float32),
}


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_decode_occ_matches_jax(channels):
    rng = np.random.default_rng(channels)
    noise = rng.random((3, 5, 7, channels), dtype=np.float32)
    for occ in (TIES[channels].reshape(2, 4, 1, channels), noise):
        want = np.asarray(jax_metrics.decode_occ(jnp.asarray(occ)))
        got = metrics.decode_occ(_t(occ)).numpy()
        np.testing.assert_array_equal(got, want)
    assert set(np.unique(metrics.decode_occ(_t(TIES[channels])).numpy())) <= {0.0, 0.5, 1.0}


def _gt_batch(rng, b, h, w):
    return {"flow_gt": rng.standard_normal((b, h, w, 2)).astype(np.float32) * 0.2,
            "occ_gt": rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (b, h, w, 2),
                                 p=[0.2, 0.6, 0.2]),
            "mask": (rng.random((b, h, w)) > 0.1).astype(np.float32)}


@pytest.mark.parametrize("occ_channels", [0, 1, 2, 3])
def test_full_res_metrics_match_jax(occ_channels):
    rng = np.random.default_rng(10 + occ_channels)
    batch = _gt_batch(rng, 2, 12, 20)
    flow = batch["flow_gt"] + rng.standard_normal((2, 12, 20, 2)).astype(np.float32) * 0.3
    occ = (rng.random((2, 12, 20, occ_channels), dtype=np.float32) if occ_channels else None)
    variants = [batch, dict(batch, occ_gt=np.full_like(batch["occ_gt"], 0.5))]   # none occluded
    for bt in variants:
        want = jax_metrics.full_res_metrics(
            jnp.asarray(flow), None if occ is None else jnp.asarray(occ),
            {k: jnp.asarray(v) for k, v in bt.items()}, 20.0, False)
        got = metrics.full_res_metrics(_t(flow), None if occ is None else _t(occ),
                                       {k: _t(v) for k, v in bt.items()}, 20.0, False)
        assert all(v.shape == () for v in got.values())
        _close(got, want, rtol=1e-5, atol=1e-6)
    epe_px = rng.random((2, 12, 20), dtype=np.float32) * 8
    gt_px = rng.standard_normal((2, 12, 20, 2)).astype(np.float32) * 40
    np.testing.assert_allclose(
        metrics.fl_all(_t(epe_px), _t(gt_px), _t(batch["mask"])).item(),
        float(jax_metrics.fl_all(jnp.asarray(epe_px), jnp.asarray(gt_px),
                                 jnp.asarray(batch["mask"]))), rtol=1e-6)
    sharp = np.asarray(jax_metrics.decode_occ(jnp.asarray(rng.random((2, 12, 20, 2),
                                                                     dtype=np.float32))))
    lbl = batch["occ_gt"][..., 0]
    assert metrics.occ_f1(_t(sharp), _t(lbl)).item() == pytest.approx(
        float(jax_metrics.occ_f1(jnp.asarray(sharp), jnp.asarray(lbl))), rel=1e-6)


def tiny_options(**kw) -> Options:
    base = dict(levels=4, pwc_ws=3, frames=3, batchSize=2, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32", LR=1e-3, ground_truth=True)
    base.update(kw)
    return Options(**base).derive()


@pytest.fixture(scope="module")
def gt_steps():
    """Seeded port weights, a ground-truth batch, and JAX's eval-step logs
    and first train-step logs from those weights."""
    opt = tiny_options()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(4))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    rng = np.random.default_rng(6)
    batch = dict(_gt_batch(rng, 2, 32, 64),
                 images=rng.standard_normal((2, 32, 64, 9)).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxPWCNet(jax_pwc_config(opt))
    crits = jax_build_criterions(opt)
    eval_logs = jax_make_eval_step(jmodel, opt, crits)(tree, jbatch)
    step = jax_make_train_step(jmodel, opt, crits, donate=False)
    _, train_logs = step(jax_create_train_state(tree, opt), jbatch)
    return opt, net, batch, eval_logs, train_logs


def test_eval_step_logs_match_jax(gt_steps):
    opt, net, batch, want, _ = gt_steps
    before = {k: v.clone() for k, v in net.state_dict().items()}
    logs = make_eval_step(net, opt, build_criterions(opt))({k: _t(v) for k, v in batch.items()})
    assert "occ_f1" in logs and "fl_all" in logs
    assert all(not v.requires_grad and v.shape == () for v in logs.values())
    _close(logs, want, **TOL)
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    assert all(p.grad is None for p in net.parameters())


def test_train_step_ground_truth_logs_match_jax(gt_steps):
    opt, net, batch, _, want = gt_steps
    init = {k: v.clone() for k, v in net.state_dict().items()}
    state = create_train_state(net, opt)
    try:
        state, logs = make_train_step(net, opt, build_criterions(opt))(
            state, {k: _t(v) for k, v in batch.items()})
    finally:
        net.load_state_dict(init)
    assert state.step == 1 and "epe" in logs and "occ_acc_fwd" in logs
    _close(logs, want, **TOL)
    # without flow_gt, or with no occlusion head, the metrics are left out
    no_occ = tiny_options(no_occ=True)
    noocc_net = PWCNet(pwc_config_from_options(no_occ), generator=torch.Generator().manual_seed(4))
    for o, n, b, keys in ((opt, net, {"images": batch["images"]}, set()),
                          (no_occ, noocc_net, batch, {"epe", "epe_nocc", "epe_occ", "fl_all"})):
        logs = make_eval_step(n, o, build_criterions(o))({k: _t(v) for k, v in b.items()})
        assert set(logs) - {"loss", "pme", "sflow", "socc", "gocc", "sup_flow", "sup_occ"} == keys
