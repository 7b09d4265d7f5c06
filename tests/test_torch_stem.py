"""CPU parity of the port's fused feature stem (ops/stem.py) against the
JAX package's (back2future_tpu/ops/stem_pallas.py).

On CPU tensors the port's `fused_stem` runs its plain twin inside the
op `b2f::stem`, so these tests hold the twin and the op's autograd
formula against JAX; the CUDA kernels K5/K6 are held against the
twin on the card (tests/test_torch_kernels.py). JAX references are
computed once per module: `fused_stem` with B2F_STEM_PALLAS=1 runs the
Pallas kernels in interpret mode, as tests/test_pallas.py runs them.

Tolerances (f32): stem outputs rtol 1e-5 / atol 1e-4 (the JAX kernel's
block-Toeplitz matmuls sum in another order than the conv); gradients
rtol 1e-4 / atol 1e-3; the whole net rtol/atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu.models.pwc import PWCConfig as JaxPWCConfig
from back2future_tpu.models.pwc import PWCNet as JaxPWCNet
from back2future_tpu.ops import stem_pallas
from back2future_tpu_torch import ops
from back2future_tpu_torch.models import ConvUnit, PWCConfig, PWCNet, to_flax_params
from back2future_tpu_torch.models import pwc as pwc_module

torch.set_num_threads(1)

SHAPES = [(2, 16, 64), (1, 32, 128)]


def units():
    gen = torch.Generator().manual_seed(4)
    return ConvUnit(3, 16, generator=gen), ConvUnit(16, 32, generator=gen)


def jax_tree(unit):
    return jax.tree_util.tree_map(jnp.asarray, to_flax_params(unit))


def frames(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape + (3,)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_stem(monkeypatch_module):
    """Per shape: the input, the cotangents, JAX's fused (Pallas,
    interpret mode) and XLA stems, and jax.vjp of the fused stem w.r.t.
    the input and both units' params."""
    monkeypatch_module.setenv("B2F_STEM_PALLAS", "1")
    unit2, unit3 = units()
    p2, p3 = jax_tree(unit2), jax_tree(unit3)
    out = {}
    for k, shape in enumerate(SHAPES):
        x = frames(shape, 10 + k)
        (f2, f3), vjp = jax.vjp(lambda xx, a, b: stem_pallas.fused_stem(xx, a, b, jnp.float32),
                                jnp.asarray(x), p2, p3)
        n, h, w = shape
        rng = np.random.default_rng(20 + k)
        g2 = rng.standard_normal((n, h // 2, w // 2, 16)).astype(np.float32)
        g3 = rng.standard_normal((n, h // 4, w // 4, 32)).astype(np.float32)
        dx, d2, d3 = vjp((jnp.asarray(g2), jnp.asarray(g3)))
        xla = stem_pallas._stem_xla(jnp.asarray(x), p2, p3, jnp.float32)
        out[shape] = dict(x=x, g=(g2, g3), fused=(np.asarray(f2), np.asarray(f3)),
                          xla=tuple(map(np.asarray, xla)),
                          grads=jax.tree_util.tree_map(np.asarray, (dx, d2, d3)))
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_stem_eligible_truth_table():
    grid = [(h, w, c, fm2, fm3) for h in (4, 8, 12, 16, 30, 320) for w in (32, 64, 96, 128, 1216)
            for c in (3, 16) for fm2, fm3 in ((16, 32), (16, 16))]
    got = [ops.stem_eligible(*args) for args in grid]
    assert got == [stem_pallas.stem_eligible(*args) for args in grid]
    assert any(got) and not all(got)


@pytest.mark.parametrize("value", ["", "0", "1", "true", " YES ", "on", "off", "2", "False"])
def test_stem_enabled_parses_as_jax(value, monkeypatch):
    monkeypatch.setenv("B2F_STEM_PALLAS", value)
    assert ops.stem_enabled() == stem_pallas.stem_pallas_enabled()


@pytest.mark.parametrize("shape", SHAPES, ids=["2x16x64", "1x32x128"])
def test_fused_stem_matches_jax(jax_stem, shape):
    case = jax_stem[shape]
    unit2, unit3 = units()
    with torch.no_grad():
        f2, f3 = ops.fused_stem(torch.from_numpy(case["x"]), unit2, unit3)
    for got, fused, xla in zip((f2, f3), case["fused"], case["xla"]):
        np.testing.assert_allclose(got.numpy(), fused, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x16x64", "1x32x128"])
def test_fused_stem_grads_match_jax(jax_stem, shape):
    case = jax_stem[shape]
    unit2, unit3 = units()
    x = torch.tensor(case["x"], requires_grad=True)
    f2, f3 = ops.fused_stem(x, unit2, unit3)
    torch.autograd.backward((f2, f3), tuple(map(torch.from_numpy, case["g"])))
    dx, d2, d3 = case["grads"]
    np.testing.assert_allclose(x.grad.numpy(), dx, rtol=1e-4, atol=1e-3)
    for unit, want in ((unit2, d2), (unit3, d3)):
        for conv in ("c0", "c1"):
            mod = getattr(unit, conv)
            np.testing.assert_allclose(mod.weight.grad.numpy(),
                                       want[conv]["conv"]["kernel"].transpose(3, 2, 0, 1),
                                       rtol=1e-4, atol=1e-3, err_msg=conv)
            np.testing.assert_allclose(mod.bias.grad.numpy(), want[conv]["conv"]["bias"],
                                       rtol=1e-4, atol=1e-3, err_msg=conv)


def test_fused_stem_grads_only_where_needed():
    unit2, unit3 = units()
    unit3.requires_grad_(False)
    x = torch.tensor(frames((1, 8, 64), 30))
    f2, f3 = ops.fused_stem(x, unit2, unit3)
    (f2.sum() + f3.sum()).backward()
    assert x.grad is None and unit3.c0.weight.grad is None
    assert unit2.c0.weight.grad is not None and unit2.c1.bias.grad is not None


MODEL_CFG = dict(frames=3, levels=5, win=3, skip=2)


@pytest.fixture(scope="module")
def jax_model_with_stem(monkeypatch_module):
    """The port net's seeded weights, the input, and the JAX net's
    outputs on them with the fused stem on (Pallas in interpret mode)."""
    monkeypatch_module.setenv("B2F_STEM_PALLAS", "1")
    net = PWCNet(PWCConfig(**MODEL_CFG), generator=torch.Generator().manual_seed(6))
    x = np.random.default_rng(7).standard_normal((1, 16, 64, 9)).astype(np.float32)
    model = JaxPWCNet(JaxPWCConfig(**MODEL_CFG, dtype=jnp.float32))
    outs = model.apply({"params": jax_tree(net)}, jnp.asarray(x))
    return net, x, [{k: np.asarray(g[k]) for k in ("flow", "occ")} for g in outs]


@pytest.mark.parametrize("on", [True, False], ids=["stem_on", "stem_off"])
def test_model_with_stem_matches_jax(jax_model_with_stem, on, monkeypatch):
    """The port net with B2F_STEM_PALLAS on matches the JAX net with the
    fused stem; the fused stem is entered once per forward when on,
    never when off (and the outputs are the same either way)."""
    net, x, want = jax_model_with_stem
    calls = []

    def counting(*args):
        calls.append(1)
        return ops.fused_stem(*args)

    monkeypatch.setattr(pwc_module, "fused_stem", counting)
    monkeypatch.setenv("B2F_STEM_PALLAS", "1" if on else "0")
    with torch.no_grad():
        got = net(torch.from_numpy(x), with_warped=False)
        net.pyramid(torch.from_numpy(x[..., :3]))
    assert len(calls) == (2 if on else 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["flow"].numpy(), w["flow"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["occ"].numpy(), w["occ"], rtol=1e-4, atol=1e-4)


def test_stem_not_fusable_off_the_eligible_shapes(monkeypatch):
    """Shapes the JAX package does not fuse (W % 64 != 0) and nets without
    the default stem run the plain ConvUnits, whatever the switch says."""
    monkeypatch.setenv("B2F_STEM_PALLAS", "1")
    calls = []
    monkeypatch.setattr(pwc_module, "fused_stem", lambda *a: calls.append(1))
    with torch.no_grad():
        PWCNet(PWCConfig(**MODEL_CFG))(torch.zeros(1, 16, 96, 9), with_warped=False)
        PWCNet(PWCConfig(**dict(MODEL_CFG, skip=0)))(torch.zeros(1, 16, 64, 9),
                                                     with_warped=False)
    assert not calls


def test_stem_unit_cuda_rejects_cpu_tensors():
    """`stem_unit_cuda` launches the kernel only: a CPU tensor raises, it
    never falls back to the twin."""
    unit2, _ = units()
    with pytest.raises(ValueError, match="CUDA"):
        ops.stem_unit_cuda(torch.zeros(1, 8, 64, 3), ops.unit_params(unit2), "a")
