"""CPU parity of the port's remaining criteria and its supervised branch
against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port, in f32 (on CPU tensors):

* MBCC (what "BCC" runs), MSSIM(L1) and OSSIM(L1): value and gradient
  against `jax.value_and_grad` with reference gradients on and off, past
  flow on and off, with and without occ, penalties L1, Lorentzian and
  Quadratic. Value rtol 1e-5; gradients rtol 1e-5, atol 1e-6 (MBCC) and
  atol 5e-5 * max|g| for the SSIM family: its divisions by
  sigma_x + sigma_y + C2 (C2 = 9e-4) and mu_x^2 + mu_y^2 + C1 amplify the
  f32 rounding of the depthwise Gaussian's sums, which XLA's conv and
  torch's add in another order (measured: 1.8e-5 * max|g|). In f64 the
  two agree to rtol 1e-10 (`test_ssim_family_exact_in_f64`), so the
  formulas are the same;
* the KL occlusion smoothness and the supervised L2: rtol 1e-5, atol 1e-6;
* the 2-frame `bcc` and `ssim`;
* `build_criterions` over every name of the JAX factory table and every
  `smooth_occ_penalty`: every callable's value on the same inputs;
* `convert_gt_occ` exactly; `multiscale_loss` with `optimize="epe"` and
  its parameter gradients against one JAX `value_and_grad` (rtol 1e-3,
  atol 1e-5 * max|g| per leaf, as test_torch_train_ops.py);
* 3 train steps each with SSIML1 + past flow, OSSIM, and epe against JAX
  `make_train_step` (rtol 1e-3; params atol LR/10, as test_torch_train.py).
"""

import functools

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp

import back2future_tpu.losses as jax_losses
from back2future_tpu.config import Options
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.train.multiscale import convert_gt_occ as jax_convert_gt_occ
from back2future_tpu.train.multiscale import multiscale_loss as jax_multiscale_loss
from back2future_tpu.train.state import create_train_state as jax_create_train_state
from back2future_tpu.train.step import make_train_step as jax_make_train_step
import back2future_tpu_torch.losses as losses
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.train import create_train_state, make_train_step, multiscale_loss
from back2future_tpu_torch.train.multiscale import convert_gt_occ

torch.set_num_threads(1)

SHAPE = (2, 8, 12)     # B, H, W
SCALE = 2.5            # the level's flow scale: what the out-of-image masks see
SSIM_GRAD_ATOL_FRAC = 5e-5


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def group(seed):
    """flow (moving some pixels out of the image), flow_past, occ, two
    warped frames and the target."""
    b, h, w = SHAPE
    return dict(flow=rand((b, h, w, 2), seed, 1.0), flow_past=rand((b, h, w, 2), seed + 1, 1.0),
                occ=sigmoid(rand((b, h, w, 2), seed + 2)), w1=rand((b, h, w, 3), seed + 3),
                w2=rand((b, h, w, 3), seed + 4), target=rand((b, h, w, 3), seed + 5))


def compare(port_fn, jax_fn, arrays, grad_atol_frac=None, rtol=1e-5, dtype=np.float32):
    """Value and gradient w.r.t. every array (None: not an input); the
    gradient's atol is 1e-6, or grad_atol_frac * max|g|."""
    names = [k for k, v in arrays.items() if v is not None]
    nones = {k: None for k, v in arrays.items() if v is None}
    want_val, want_grads = jax.value_and_grad(lambda d: jax_fn(**d, **nones))(
        {k: jnp.asarray(arrays[k].astype(dtype)) for k in names})
    tens = {k: (torch.tensor(v.astype(dtype), requires_grad=True) if v is not None else None)
            for k, v in arrays.items()}
    got = port_fn(**tens)
    grads = torch.autograd.grad(got, [tens[k] for k in names], allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want_val), rtol=rtol)
    for k, gr in zip(names, grads):
        want = np.asarray(want_grads[k])
        gr = np.zeros_like(want) if gr is None else gr.numpy()
        atol = 1e-6 if grad_atol_frac is None else grad_atol_frac * np.abs(want).max()
        np.testing.assert_allclose(gr, want, rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------- pme criteria

# pme_criterion -> (factory name, alpha) as build_criterions sets them
PME = {"BCC": ("make_mbcc", 1.0), "SSIM": ("make_mssim_l1", 1.0),
       "SSIML1": ("make_mssim_l1", 0.85), "OSSIM": ("make_ossim_l1", 1.0),
       "OSSIML1": ("make_ossim_l1", 0.85)}
# the JAX OSSIM backward indexes occ, so it needs one under reference grads
PME_CASES = [(n, p, pf, occ, rg) for n in sorted(PME) for p in ("L1", "Quadratic", "Lorentzian")
             for pf in (True, False) for occ in (True, False) for rg in (True, False)
             if occ or not (n.startswith("O") and rg)]


def pme_call(fn):
    return lambda flow, flow_past, occ, w1, w2, target: fn(flow, flow_past, occ, (w1, w2), target)


def pme_pair(name, penalty, past_flow, reference_grads, frames=3):
    factory, alpha = PME[name]
    kw = dict(frames=frames, penalty=penalty, size_average=False, past_flow=past_flow,
              alpha=alpha, reference_grads=reference_grads)
    return (getattr(losses, factory)(losses.PhotoConfig(**kw), SCALE),
            getattr(jax_losses, factory)(jax_losses.PhotoConfig(**kw), SCALE))


@pytest.mark.parametrize("name,penalty,past_flow,with_occ,reference_grads", PME_CASES,
                         ids=["-".join(map(str, c)) for c in PME_CASES])
def test_pme_criterion_matches_jax(name, penalty, past_flow, with_occ, reference_grads):
    port_fn, jax_fn = pme_pair(name, penalty, past_flow, reference_grads)
    arrays = group(40)
    if not past_flow:
        arrays["flow_past"] = None
    if not with_occ:
        arrays["occ"] = None
    compare(pme_call(port_fn), pme_call(jax_fn), arrays,
            grad_atol_frac=None if name == "BCC" else SSIM_GRAD_ATOL_FRAC)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("name", ["SSIM", "SSIML1", "OSSIM", "OSSIML1"])
def test_ssim_family_exact_in_f64(name, reference_grads):
    """In f64 the SSIM family's value and gradients agree to 1e-10: what
    f32 leaves apart is rounding, not the formulas."""
    with jax.enable_x64(True):
        port_fn, jax_fn = pme_pair(name, "L1", True, reference_grads)
        compare(pme_call(port_fn), pme_call(jax_fn), group(41), rtol=1e-10,
                grad_atol_frac=1e-12, dtype=np.float64)


@pytest.mark.parametrize("name", ["BCC", "SSIML1", "OSSIM"])
def test_pme_criterion_two_frames_matches_jax(name):
    """frames=2: one warped frame, the whole flow for the mask, no occ."""
    port_fn, jax_fn = pme_pair(name, "L1", False, name != "OSSIM", frames=2)
    arrays = group(42)

    def call(fn):
        return lambda flow, w1, target: fn(flow, None, None, (w1,), target)

    compare(call(port_fn), call(jax_fn),
            dict(flow=arrays["flow"], w1=arrays["w1"], target=arrays["target"]),
            grad_atol_frac=None if name == "BCC" else SSIM_GRAD_ATOL_FRAC)


def test_ssim_factories_are_cached():
    cfg = losses.PhotoConfig(penalty="L1", alpha=0.85)
    assert losses.make_mssim_l1(cfg, 2.0) is losses.make_mssim_l1(cfg, 2.0)
    assert losses.make_ossim_l1(cfg, 2.0) is not losses.make_mssim_l1(cfg, 2.0)
    assert losses.make_mbcc(cfg, 1.0) is losses.make_mbcc(cfg, 1.0)


# ------------------------------------------------- KL, L2 and 2-frame criteria

@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("size_average", [True, False], ids=["mean", "sum"])
def test_kl_smoothness_matches_jax(size_average, reference_grads):
    arrays = group(50)
    # about a tenth of the occlusion values below the clamp (eps = 0.05)
    occ = sigmoid(rand(SHAPE + (2,), 51, 2.0))
    assert 0.02 < (occ < 0.05).mean() < 0.3
    compare(losses.make_kl_smoothness(size_average, reference_grads),
            jax_losses.make_kl_smoothness(size_average, reference_grads),
            dict(occ=occ, target=arrays["target"]))


@pytest.mark.parametrize("mask_dims", [3, 4])
@pytest.mark.parametrize("reference_grads", [True, False], ids=["ref_grads", "autodiff"])
@pytest.mark.parametrize("size_average", [True, False], ids=["mean", "sum"])
def test_l2_criterion_matches_jax(size_average, reference_grads, mask_dims):
    arrays = group(60)
    mask = (rand(SHAPE, 61) > -0.5).astype(np.float32)
    if mask_dims == 4:
        mask = mask[..., None]
    port_l2 = losses.make_l2_criterion(size_average, reference_grads)
    jax_l2 = jax_losses.make_l2_criterion(size_average, reference_grads)
    compare(lambda flow, gt: port_l2(flow, gt, torch.tensor(mask))[0],
            lambda flow, gt: jax_l2(flow, gt, jnp.asarray(mask))[0],
            dict(flow=arrays["flow"], gt=arrays["flow_past"]))
    _, got_map = port_l2(torch.tensor(arrays["flow"]), torch.tensor(arrays["flow_past"]),
                         torch.tensor(mask))
    _, want_map = jax_l2(jnp.asarray(arrays["flow"]), jnp.asarray(arrays["flow_past"]),
                         jnp.asarray(mask))
    assert not got_map.requires_grad
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("penalty", ["L1", "Quadratic", "Lorentzian"])
def test_two_frame_bcc_matches_jax(penalty):
    arrays = group(70)
    compare(lambda img, target: losses.bcc(img, target, penalty),
            lambda img, target: jax_losses.bcc(img, target, penalty),
            dict(img=arrays["w1"], target=arrays["target"]))


@pytest.mark.parametrize("size_average", [True, False], ids=["mean", "sum"])
def test_two_frame_ssim_matches_jax(size_average):
    arrays = group(71)
    compare(lambda img, target: losses.ssim(img, target, size_average),
            lambda img, target: jax_losses.ssim(img, target, size_average),
            dict(img=arrays["w1"], target=arrays["target"]), grad_atol_frac=SSIM_GRAD_ATOL_FRAC)


def test_gaussian_helpers_match_jax():
    from back2future_tpu.losses import common as jax_common
    from back2future_tpu_torch.losses import common

    np.testing.assert_array_equal(common.gaussian3_kernel(), jax_common.gaussian3_kernel())
    assert common.gaussian3_center_weight() == jax_common.gaussian3_center_weight()
    x = rand((2, 5, 7, 3), 72)
    np.testing.assert_allclose(common.depthwise_gauss3(torch.tensor(x)).numpy(),
                               np.asarray(jax_common.depthwise_gauss3(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_exports_match_jax():
    assert losses.__all__ == jax_losses.__all__


# --------------------------------------------------------- build_criterions

OCC_PENALTIES = ["Quadratic", "L1", "Lorentzian", "Dirac", "KL"]


@pytest.mark.parametrize("occ_penalty", OCC_PENALTIES)
@pytest.mark.parametrize("name", sorted(jax_losses._PME_FACTORIES))
def test_build_criterions_matches_jax(name, occ_penalty):
    """Every callable of the factory, on the same inputs, for every pme
    criterion and occlusion smoothness penalty (past flow on, so MSSIM's
    normalisation reads it)."""
    opt = Options(levels=4, pwc_ws=3, batchSize=2, dataset="synthetic", pme_criterion=name,
                  smooth_occ_penalty=occ_penalty, past_flow=True, pme_penalty="L1").derive()
    port, ref = losses.build_criterions(opt), jax_losses.build_criterions(opt)
    a = group(80)
    mask = (rand(SHAPE, 81) > 0).astype(np.float32)
    T = {k: torch.tensor(v) for k, v in a.items()}
    J = {k: jnp.asarray(v) for k, v in a.items()}
    pairs = [
        (port.pme(SCALE)(T["flow"], T["flow_past"], T["occ"], (T["w1"], T["w2"]), T["target"]),
         ref.pme(SCALE)(J["flow"], J["flow_past"], J["occ"], (J["w1"], J["w2"]), J["target"])),
        (port.flow_smooth(T["flow"], T["target"]), ref.flow_smooth(J["flow"], J["target"])),
        (port.occ_smooth(T["occ"], T["target"]), ref.occ_smooth(J["occ"], J["target"])),
        (port.occ_prior(T["occ"], T["target"]), ref.occ_prior(J["occ"], J["target"])),
        (port.const_vel(T["flow"], T["flow_past"]), ref.const_vel(J["flow"], J["flow_past"])),
        (port.l2(T["flow"], T["flow_past"], torch.tensor(mask))[0],
         ref.l2(J["flow"], J["flow_past"], jnp.asarray(mask))[0]),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, err_msg=str(i))


def test_build_criterions_rejects_unknown_names():
    base = dict(levels=4, pwc_ws=3, batchSize=2, dataset="synthetic")
    with pytest.raises(ValueError, match="pme_criterion"):
        losses.build_criterions(Options(**base, pme_criterion="NCC").derive())
    crits = losses.build_criterions(Options(**base, smooth_occ_penalty="Huber").derive())
    with pytest.raises(ValueError, match="penalty"):
        crits.occ_smooth(torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2, 3))


# ---------------------------------------------------- the supervised branch

def test_convert_gt_occ_matches_jax():
    rng = np.random.default_rng(90)
    occ = rng.choice(np.float32([0.0, 0.5, 1.0, 0.25]), size=(2, 6, 7, 2))
    for x in (occ, occ[..., 0], occ[..., :1]):
        got = convert_gt_occ(torch.tensor(x))
        assert got.dtype == torch.float32 and got.shape == (2, 6, 7, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_convert_gt_occ(jnp.asarray(x))))


def tiny_options(**kw) -> Options:
    base = dict(levels=4, pwc_ws=3, frames=3, batchSize=2, cropWidth=0, cropHeight=0,
                dataset="synthetic", sizeAverage=False, optimize="pme",
                compute_dtype="float32", LR=1e-3)
    base.update(kw)
    return Options(**base).derive()


def gt_batch(seed, b=2, h=32, w=64):
    """Images, ground-truth flow (in flownet units), three-state occlusion
    (both channels) and a 0/1 mask."""
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, h, w, 9)).astype(np.float32),
            "flow_gt": (rng.standard_normal((b, h, w, 2)) * 0.2).astype(np.float32),
            "occ_gt": rng.choice(np.float32([0.0, 0.5, 1.0]), size=(b, h, w, 2),
                                 p=[0.1, 0.8, 0.1]),
            "mask": (rng.random((b, h, w)) > 0.1).astype(np.float32)}


# the branches of multiscale_loss this slice adds: the supervised one, and
# the unsupervised one with an SSIM criterion
LOSS_CASES = {
    "epe_sum": dict(optimize="epe", epe=1.0),
    "epe_mean_autodiff_rescale": dict(optimize="epe", epe=1.0, sizeAverage=True,
                                      reference_grads=False, rescale_flow=1),
    "ssiml1_past_flow": dict(pme_criterion="SSIML1", past_flow=True, const_vel=1.0),
    "ossim_kl": dict(pme_criterion="OSSIM", smooth_occ_penalty="KL"),
}


@pytest.fixture(scope="module", params=sorted(LOSS_CASES))
def loss_case(request):
    """Port model with seeded weights, a batch with ground truth, and JAX's
    loss, components and parameter gradients (one value_and_grad jit)."""
    opt = tiny_options(**LOSS_CASES[request.param])
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    batch = gt_batch(91)
    model, crits = JaxPWCNet(jax_pwc_config(opt)), jax_losses.build_criterions(opt)

    @jax.jit
    def loss_fn(params, batch):
        return jax_multiscale_loss(model.apply({"params": params}, batch["images"]), batch,
                                   opt, crits)

    (loss, comps), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    return (opt, net, batch, float(loss), {k: float(v) for k, v in comps.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def test_multiscale_loss_and_param_grads_match_jax(loss_case):
    opt, net, batch, want_loss, want_comps, want_grads = loss_case
    net.zero_grad()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    outputs = net(tb["images"], with_warped=opt.optimize == "pme")
    loss, comps = multiscale_loss(outputs, tb, opt, losses.build_criterions(opt))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4)
    if opt.optimize == "epe":
        assert all(g["warped"] == [] for g in outputs)
        assert comps["sup_flow"].item() > 0 and comps["sup_occ"].item() > 0
    for k, v in comps.items():
        np.testing.assert_allclose(v.item(), want_comps[k], rtol=1e-4, atol=1e-7, err_msg=k)
    loss.backward()
    n = 0
    for name, p in net.named_parameters():
        *mods, leaf = name.split(".")
        want = functools.reduce(lambda d, m: d[m], mods + ["conv"], want_grads)
        want = want["kernel"].transpose(3, 2, 0, 1) if leaf == "weight" else want["bias"]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want_grads))


STEPS = 3
# Params after the steps: rtol 1e-3, atol a tenth of LR (test_torch_train.py),
# but for at most this share of the elements, each within the 2 LR a step
# that an Adam update spans: where a gradient sits within float noise of
# zero, Adam's normalised step may take either sign in the two packages.
# The SSIM family's divisions and the L2's 1/|diff| raise that noise well
# above OBCC's (measured: 4.8e-4 of the elements for OSSIM, 1.3e-4 for
# epe, none for SSIML1); the one-step parameter gradients are held to
# rtol 1e-3 in test_multiscale_loss_and_param_grads_match_jax.
LOOSE_SHARE = 1e-3
STEP_CASES = {
    "ssiml1_past_flow": (dict(pme_criterion="SSIML1", past_flow=True, const_vel=1.0), False),
    "ossim": (dict(pme_criterion="OSSIM"), False),
    "epe": (dict(optimize="epe", epe=1.0, ground_truth=True), True),
}


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def jax_steps(request):
    """Seeded port weights, the batch, and JAX's losses and params after
    STEPS steps of its jitted train step."""
    kw, with_gt = STEP_CASES[request.param]
    opt = tiny_options(**kw)
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))
    batch = gt_batch(92) if with_gt else {"images": gt_batch(92)["images"]}
    step = jax_make_train_step(JaxPWCNet(jax_pwc_config(opt)), opt,
                               jax_losses.build_criterions(opt), donate=False)
    state = jax_create_train_state(tree, opt)
    logs = []
    for _ in range(STEPS):
        state, lg = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        logs.append({k: float(v) for k, v in lg.items()})
    return request.param, opt, net, batch, logs, jax.tree_util.tree_map(np.asarray, state.params)


def test_train_steps_match_jax(jax_steps):
    case, opt, net, batch, want_logs, want_params = jax_steps
    state = create_train_state(net, opt)
    step = make_train_step(net, opt, losses.build_criterions(opt))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_logs = []
    for _ in range(STEPS):
        state, logs = step(state, tb)
        got_logs.append({k: v.item() for k, v in logs.items()})
    assert set(got_logs[0]) == set(want_logs[0])
    for got, want in zip(got_logs, want_logs):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6,
                                       err_msg=f"{case} {k}")
    assert got_logs[-1]["loss"] < got_logs[0]["loss"]
    got = to_flax_params(net)
    total, loose = 0, []
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        keys = [k.key for k in path]
        node = got
        for k in keys:
            node = node[k]
        d = np.abs(node - want)
        assert d.max() <= 2 * opt.LR * STEPS, "/".join(keys)
        loose += ["/".join(keys)] * int((d > 1e-3 * np.abs(want) + 0.1 * opt.LR).sum())
        total += d.size
    assert len(loose) <= LOOSE_SHARE * total, (case, len(loose), total)
