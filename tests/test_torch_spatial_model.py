"""CPU tests of the port's row-sharded PWC forward (models/pwc.py
`RowLayout`, api.FlowEstimator with `spatial=True`) against the JAX
package.

* `init(..., mesh=make_mesh(4 CPU slots, (2, 2), data x spatial),
  spatial=True).compute_flow_batch` at 64x128, levels 7 (levels 1-4 in
  row bands, 5-7 whole), frames 3 and 5, against JAX's FlowEstimator on
  a data x spatial mesh of 4 virtual CPU devices and against JAX's
  unsharded estimator: flows at rtol and atol 1e-4 (as
  tests/test_api_ckpt.py holds JAX's own spatial estimator), occlusion
  masks within 1e-3 of their pixels; and against the port's unsharded
  estimator within 1e-5.
* The fused stem (`B2F_STEM_PALLAS=1`), a replicated region whose level-2
  and level-3 outputs are split into bands: the sharded forward, every
  output of every level, against the port's unsharded forward with the
  stem on (tests/test_torch_stem.py holds that one against JAX's Pallas
  kernels), within 1e-5 of the largest value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu import api as jax_api
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.models.pwc import pwc_config_from_options as jax_pwc_config
from back2future_tpu.parallel import mesh as jax_mesh
from back2future_tpu_torch import api
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.parallel import mesh
from back2future_tpu_torch.parallel.spatial import ThreadGroup, run_slots

torch.set_num_threads(1)

H, W = 64, 128


def case(frames):
    kw = dict(levels=7, frames=frames, dataset="synthetic", compute_dtype="float32")
    net = PWCNet(pwc_config_from_options(Options(**kw).derive()),
                 generator=torch.Generator().manual_seed(frames))
    rng = np.random.default_rng(frames)
    ims = [rng.random((4, H, W, 3)).astype(np.float32) for _ in range(frames)]
    return net, jax_pwc_config(JaxOptions(**kw).derive()), ims


def port_mesh():
    return mesh.make_mesh(["cpu"] * 4, shape=(2, 2), axes=("data", "spatial"))


@pytest.mark.parametrize("frames", [3, 5])
def test_spatial_estimator_matches_jax(frames):
    net, jcfg, ims = case(frames)
    tree = to_flax_params(net)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jmesh = jax_mesh.make_mesh(jax.devices()[:4], shape=(2, 2), axes=("data", "spatial"))
    want = jax_api.init((jtree, jcfg), mesh=jmesh, spatial=True).compute_flow_batch(*ims)
    est = api.init((tree, net.cfg), device="cpu", mesh=port_mesh(), spatial=True)
    assert len(est.replicas) == 4 and est.spatial == 2
    assert est.replicas[0]._rows(H).plan == (True,) * (4 if frames == 3 else 3) + (False,) * (
        3 if frames == 3 else 4)
    got = est.compute_flow_batch(*ims)
    single = api.init((tree, net.cfg), device="cpu").compute_flow_batch(*ims)
    outs = [want]
    if frames == 3:
        outs.append(jax_api.init((jtree, jcfg)).compute_flow_batch(*ims))
    for ref in outs:
        for g, w in zip(got, ref):
            assert g.shape == w.shape
            if g.dtype == bool:
                assert (g != w).mean() <= 1e-3
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    for g, s in zip(got, single):
        if g.dtype == bool:
            assert (g != s).mean() <= 1e-3
        else:
            np.testing.assert_allclose(g, s, rtol=1e-5, atol=1e-5 * np.abs(s).max())


def test_spatial_forward_with_the_fused_stem(monkeypatch):
    monkeypatch.setenv("B2F_STEM_PALLAS", "1")
    net, _, ims = case(3)
    x = torch.from_numpy(np.concatenate(ims, -1)[:2])
    assert net._stem_fusable(x[..., :3])
    with torch.no_grad():
        want = net(x)
        group = ThreadGroup(2, timeout=120)
        slots = []
        for s in range(2):
            r = PWCNet(net.cfg)
            r.load_state_dict(net.state_dict())
            r.spatial_comm = group.comm(s)
            slots.append(r)

        def forward(r):
            with torch.no_grad():
                return r(x)

        outs = run_slots([lambda r=r: forward(r) for r in slots], [group])
    for got in outs:
        for lw, lg in zip(want, got):
            for k in ("flow", "occ"):
                scale = lw[k].abs().max().item()
                assert (lg[k] - lw[k]).abs().max().item() <= 1e-5 * max(scale, 1.0), k
            for a, b in zip(lw["warped"], lg["warped"]):
                assert (a - b).abs().max().item() <= 1e-5 * max(a.abs().max().item(), 1.0)
