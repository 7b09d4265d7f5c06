"""The port's kernel entry points as `torch.library` custom ops, on the CPU.

Every `b2f::*` op passes `torch.library.opcheck` (schema, autograd
registration, fake tensor, AOT dispatch) on CPU tensors in f32; on the
CPU each op runs its plain twin, so its outputs and gradients equal the
twins' bit for bit (the backward ops only for the inputs that need a
gradient, with reference gradients on and off), and they match the JAX
package's functions (references computed once per module): the cost
volume and its `jax.vjp` rtol/atol 1e-5 (sums in another order), the
warp and its `jax.vjp` (reference gradients) or `_warp_autodiff`'s
(autodiff) atol 1e-5, the stem units and `jax.vjp` of `_stem_xla` rtol
1e-4 / atol 1e-4 x max|g| (conv sums in another order through two
convs).
"""

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()   # torch.export and opcheck import torch._dynamo

import jax
import jax.numpy as jnp

from back2future_tpu.ops import stem_pallas
from back2future_tpu.ops.cost_volume import cost_volume as jax_cost_volume
from back2future_tpu.ops.warp import _warp_autodiff
from back2future_tpu.ops.warp import warp_bilinear as jax_warp_bilinear
from back2future_tpu_torch import ops
from back2future_tpu_torch.models import ConvUnit, to_flax_params

torch.set_num_threads(1)

b2f = torch.ops.b2f
CV_SHAPE, CV_ARGS = (2, 7, 9, 6), (5, 2, False, 0.25)    # win, dilation, fwd, scale
WARP_SHAPE = (2, 7, 9, 5)
STEM_SHAPE = (2, 16, 64)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def units():
    gen = torch.Generator().manual_seed(6)
    return ConvUnit(3, 16, generator=gen), ConvUnit(16, 32, generator=gen)


def inputs():
    """The numpy inputs of every op: cost volume (ref, frame, g), warp
    (images, flow far enough to clamp, g), stem (x, g2, g3)."""
    n, h, w = STEM_SHAPE
    return dict(ref=rand(CV_SHAPE, 1), frame=rand(CV_SHAPE, 2),
                g_cv=rand(CV_SHAPE[:3] + (CV_ARGS[0] ** 2,), 3),
                images=rand(WARP_SHAPE, 4), flow=rand(WARP_SHAPE[:3] + (2,), 5, scale=4.0),
                g_warp=rand(WARP_SHAPE, 6), x=rand((n, h, w, 3), 7),
                g2=rand((n, h // 2, w // 2, 16), 8), g3=rand((n, h // 4, w // 4, 32), 9))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's outputs and vjps on `inputs()`."""
    a = {k: jnp.asarray(v) for k, v in inputs().items()}
    win, dil, fwd, scale = CV_ARGS
    cv, vjp = jax.vjp(lambda r, f: jax_cost_volume(r, f, win, dil, fwd) * scale,
                      a["ref"], a["frame"])
    out = {"cv": cv, "cv_grads": vjp(a["g_cv"])}
    for name, fn in (("warp", jax_warp_bilinear), ("warp_autodiff", _warp_autodiff)):
        y, vjp = jax.vjp(fn, a["images"], a["flow"])
        out[name], out[name + "_grads"] = y, vjp(a["g_warp"])
    unit2, unit3 = units()
    p2, p3 = (jax.tree_util.tree_map(jnp.asarray, to_flax_params(u)) for u in (unit2, unit3))
    (f2, f3), vjp = jax.vjp(lambda x, q2, q3: stem_pallas._stem_xla(x, q2, q3, jnp.float32),
                            a["x"], p2, p3)
    out["stem"] = (f2, f3)
    out["stem_grads"] = vjp((a["g2"], a["g3"]))
    return jax.tree_util.tree_map(np.asarray, out)


def torch_inputs(grad=True):
    return {k: torch.from_numpy(v).requires_grad_(grad) for k, v in inputs().items()}


def op_cases():
    """(op, args) of every op, f32 CPU tensors, inputs requiring grad
    where the op is differentiable."""
    t, c = torch_inputs(), torch_inputs(grad=False)
    unit2, unit3 = units()
    return {
        "cost_volume": (b2f.cost_volume, (t["ref"], t["frame"], *CV_ARGS)),
        "cost_volume_dref": (b2f.cost_volume_dref, (c["g_cv"], c["frame"], *CV_ARGS)),
        "cost_volume_dframe": (b2f.cost_volume_dframe, (c["g_cv"], c["ref"], *CV_ARGS)),
        "warp_bilinear": (b2f.warp_bilinear, (t["images"], t["flow"], True)),
        "warp_bilinear_autodiff": (b2f.warp_bilinear, (t["images"], t["flow"], False)),
        "warp_dimages": (b2f.warp_dimages, (c["flow"], c["g_warp"])),
        "warp_dflow": (b2f.warp_dflow, (c["images"], c["flow"], c["g_warp"], True)),
        "warp_dflow_autodiff": (b2f.warp_dflow, (c["images"], c["flow"], c["g_warp"], False)),
        "stem": (b2f.stem, (t["x"], *ops.unit_params(unit2), *ops.unit_params(unit3))),
    }


@pytest.mark.parametrize("case", sorted(op_cases()))
def test_opcheck_on_cpu(case):
    op, args = op_cases()[case]
    result = torch.library.opcheck(op.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_every_kernel_op_is_registered():
    """The ops of the kernels on a path, each with CPU and CUDA kernels,
    a fake (Meta) and, for the forward ops, an autograd formula."""
    forward = ("cost_volume", "warp_bilinear", "stem")
    backward = ("cost_volume_dref", "cost_volume_dframe", "warp_dimages", "warp_dflow")
    for name in forward + backward:
        qualname = f"b2f::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key), (name, key)
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, "Autograd") \
            == (name in forward), name


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)],
                         ids=["both", "ref", "frame"])
def test_cost_volume_op_grads_are_the_twins(jax_refs, need):
    n = inputs()
    ref, frame = (torch.from_numpy(n[k]).requires_grad_(r) for k, r in zip(("ref", "frame"), need))
    out = ops.cost_volume(ref, frame, *CV_ARGS)
    assert torch.equal(out, ops.cost_volume_reference(ref.detach(), frame.detach(), *CV_ARGS))
    np.testing.assert_allclose(out.detach().numpy(), jax_refs["cv"], rtol=1e-5, atol=1e-5)
    g = torch.from_numpy(n["g_cv"])
    out.backward(g)
    twins = ops.cost_volume_backward_reference(g, ref.detach(), frame.detach(), *CV_ARGS)
    for t, twin, want, r in zip((ref, frame), twins, jax_refs["cv_grads"], need):
        if not r:
            assert t.grad is None
            continue
        assert torch.equal(t.grad, twin)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reference_grads", [True, False], ids=["reference", "autodiff"])
@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)],
                         ids=["both", "images", "flow"])
def test_warp_op_grads_are_the_twins(jax_refs, need, reference_grads):
    n = inputs()
    images, flow = (torch.from_numpy(n[k]).requires_grad_(r)
                    for k, r in zip(("images", "flow"), need))
    out = ops.warp_bilinear(images, flow, reference_grads=reference_grads)
    assert torch.equal(out, ops.warp_bilinear_reference(images.detach(), flow.detach()))
    np.testing.assert_allclose(out.detach().numpy(), jax_refs["warp"], atol=1e-5)
    g = torch.from_numpy(n["g_warp"])
    out.backward(g)
    twins = ops.warp_bilinear_backward_reference(images.detach(), flow.detach(), g,
                                                 reference_grads)
    key = "warp_grads" if reference_grads else "warp_autodiff_grads"
    for t, twin, want, r in zip((images, flow), twins, jax_refs[key], need):
        if not r:
            assert t.grad is None
            continue
        assert torch.equal(t.grad, twin)
        np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-5)


def test_backward_ops_are_the_twins():
    """Called directly, each backward op returns its twin's output."""
    c = torch_inputs(grad=False)
    d_ref, d_frame = ops.cost_volume_backward_reference(c["g_cv"], c["ref"], c["frame"], *CV_ARGS)
    assert torch.equal(b2f.cost_volume_dref(c["g_cv"], c["frame"], *CV_ARGS), d_ref)
    assert torch.equal(b2f.cost_volume_dframe(c["g_cv"], c["ref"], *CV_ARGS), d_frame)
    for rg in (True, False):
        d_img, d_flow = ops.warp_bilinear_backward_reference(c["images"], c["flow"], c["g_warp"],
                                                             rg)
        assert torch.equal(b2f.warp_dimages(c["flow"], c["g_warp"]), d_img)
        assert torch.equal(b2f.warp_dflow(c["images"], c["flow"], c["g_warp"], rg), d_flow)


def test_stem_op_grads_are_the_twin_chain(jax_refs):
    """The stem op and its backward, the twin chain recomputed from the
    frames, equal the twin chain and its autograd bit for bit; both match
    JAX's XLA stem."""
    n = inputs()
    unit2, unit3 = units()
    params = [*ops.unit_params(unit2), *ops.unit_params(unit3)]
    results = []
    for fn in (lambda x: ops.fused_stem(x, unit2, unit3),
               lambda x: ops.stem_reference(x, params[:4], params[4:])):
        x = torch.from_numpy(n["x"]).requires_grad_()
        f2, f3 = fn(x)
        grads = torch.autograd.grad((f2, f3), [x, *params],
                                    (torch.from_numpy(n["g2"]), torch.from_numpy(n["g3"])))
        results.append(((f2, f3), grads))
    (got_out, got_grads), (want_out, want_grads) = results
    assert all(torch.equal(a, b) for a, b in zip(got_out, want_out))
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
    for a, b in zip(got_out, jax_refs["stem"]):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4, atol=1e-4)
    dx, d2, d3 = jax_refs["stem_grads"]
    np.testing.assert_allclose(got_grads[0].numpy(), dx, rtol=1e-4,
                               atol=1e-4 * np.abs(dx).max())
    for grads, tree in ((got_grads[1:5], d2), (got_grads[5:], d3)):
        flat = [tree[c]["conv"][k] for c in ("c0", "c1") for k in ("kernel", "bias")]
        for got, want in zip(grads, flat):
            want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("op", ["cost_volume", "warp_bilinear", "stem"])
def test_plain_ops_route_is_unchanged_on_cpu(op):
    """Inside plain_ops() a CPU op gives the same outputs and gradients:
    on the CPU both routes are the twins."""
    unit2, unit3 = units()
    g = inputs()

    def run():
        t = torch_inputs()
        if op == "cost_volume":
            out, gout, leaves = ops.cost_volume(t["ref"], t["frame"], *CV_ARGS), "g_cv", \
                (t["ref"], t["frame"])
        elif op == "warp_bilinear":
            out, gout, leaves = ops.warp_bilinear(t["images"], t["flow"]), "g_warp", \
                (t["images"], t["flow"])
        else:
            out, gout, leaves = ops.fused_stem(t["x"], unit2, unit3)[1], "g3", (t["x"],)
        return out.detach(), torch.autograd.grad(out, leaves, torch.from_numpy(g[gout]))

    default = run()
    with ops.plain_ops():
        plain = run()
    assert torch.equal(default[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(default[1], plain[1]))
