"""CPU tests of the port's checkpoints against the JAX package's.

* The port's flax msgpack reader (io/flax_msgpack.py) against
  `flax.serialization.msgpack_restore`, exactly: on the files the JAX
  package's `save_checkpoint` writes for its three optax layouts (Adam;
  decay + clip + Adam; SGD), with bf16 and 0-d leaves, and on seeded
  random nested trees of every msgpack width. Truncated, chunked,
  complex, unknown-dtype and unknown-ext inputs raise.
* The port's own format: save -> load of params, Adam state and the step
  counter bit for bit; `latest_checkpoint` over mixed names.
* JAX-written checkpoints in the port: the optax moments of each layout
  land in the torch rule exactly (transposed by the bridge's map);
  `init(path)` serves JAX `init(path)`'s `compute_flow` within 1e-4;
  `load_or_convert` with `convert_to_soft` gives the JAX surgery's params
  exactly, and both packages raise the same guards.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dynamo_import import import_dynamo_from_stdlib_path

import_dynamo_from_stdlib_path()

import jax
import jax.numpy as jnp
import msgpack
import optax
from flax import serialization

from back2future_tpu import api as jax_api
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.train import checkpoint as jax_checkpoint
from back2future_tpu.train.optim import make_optimizer as jax_make_optimizer
from back2future_tpu.train.state import TrainState as JaxTrainState
from back2future_tpu_torch import api
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.io import flax_msgpack
from back2future_tpu_torch.models import PWCNet, pwc_config_from_options, to_flax_params
from back2future_tpu_torch.models.bridge import flax_to_torch_names
from back2future_tpu_torch.train import checkpoint
from back2future_tpu_torch.train import create_train_state

torch.set_num_threads(1)

TINY = dict(levels=4, pwc_ws=3, frames=3, batchSize=2, dataset="synthetic",
            compute_dtype="float32", LR=1e-3)


def tiny(cls=Options, **kw):
    return cls(**dict(TINY, **kw)).derive()


def assert_same_tree(got, want, path=""):
    """The port reader's tree equals flax's: same keys and scalars, arrays
    equal bit for bit (bf16 leaves widened to float32)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.shape == want.shape, path
        if want.dtype.name == "bfloat16":
            assert got.dtype == np.float32
            want = want.astype(np.float32)
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def seeded_tree(seed: int, opt):
    """The port's seeded tiny net as a flax-named tree of jnp arrays."""
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(seed))
    return jax.tree_util.tree_map(jnp.asarray, to_flax_params(net))


LAYOUTS = {"adam": dict(), "adam_wd_clip": dict(weightDecay=0.01, grad_clip=0.5),
           "sgd": dict(optimizer="sgd", momentum=0.9)}


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """For each optax layout: a JAX TrainState after 2 updates of random
    gradients, saved by the JAX package's save_checkpoint."""
    out = {}
    for name, kw in LAYOUTS.items():
        opt = tiny(JaxOptions, **kw)
        params = seeded_tree(1, opt)
        tx = jax_make_optimizer(opt, 1)
        opt_state = tx.init(params)
        rng = np.random.default_rng(2)

        @jax.jit
        def update(grads, opt_state, params):
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        for _ in range(2):
            grads = jax.tree_util.tree_map(
                lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
            params, opt_state = update(grads, opt_state, params)
        state = JaxTrainState(params=params, opt_state=opt_state,
                              step=jnp.asarray(7, jnp.int32), epoch=2)
        d = tmp_path_factory.mktemp(name)
        jax_checkpoint.save_checkpoint(d, state, opt, 2)
        out[name] = (d, opt, jax.tree_util.tree_map(np.asarray, params),
                     jax.tree_util.tree_map(np.asarray, opt_state))
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reader_matches_flax_on_jax_checkpoints(jax_written, layout):
    d = jax_written[layout][0]
    for name in ("model_2.msgpack", "optimState_2.msgpack"):
        data = (d / name).read_bytes()
        assert_same_tree(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))
    node = checkpoint._rule_state(flax_msgpack.load(d / "optimState_2.msgpack")["opt_state"])
    assert set(node) == ({"trace"} if layout == "sgd" else {"count", "mu", "nu"})


def random_tree(rng, depth=0):
    """A nested dict with the leaves flax writes: arrays of many dtypes
    and sizes (0-d, empty, over 64 KiB), numpy scalars, Python ints of
    every width, floats, str, bytes, bool and None."""
    dtypes = [np.float16, np.float32, np.float64, np.int8, np.int16, np.int32, np.int64,
              np.uint8, np.uint16, np.uint32, np.uint64, np.bool_]
    tree = {}
    for i in range(int(rng.integers(3, 20))):
        kind = int(rng.integers(0, 9 if depth < 2 else 8))
        if kind == 0:
            dt = dtypes[int(rng.integers(len(dtypes)))]
            shape = tuple(int(s) for s in rng.integers(0, 6, size=int(rng.integers(0, 4))))
            value = (rng.random(shape) * 100).astype(dt)
        elif kind == 1:
            value = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
        elif kind == 2:
            value = np.float32(rng.standard_normal())          # ext 3
        elif kind == 3:
            value = int(rng.choice([0, 5, 127, -1, -32, -33, 200, -200, 40000, -40000,
                                    2 ** 31, -2 ** 31 - 1, 2 ** 63 + 5, -2 ** 62]))
        elif kind == 4:
            value = float(rng.standard_normal())
        elif kind == 5:
            value = "s" * int(rng.choice([0, 5, 31, 32, 300, 70000]))
        elif kind == 6:
            value = bytes(rng.integers(0, 256, int(rng.choice([0, 3, 300, 70000])), np.uint8))
        elif kind == 7:
            value = [None, True, False][int(rng.integers(3))]
        else:
            value = random_tree(rng, depth + 1)
        tree[f"k{i}"] = value
    if depth == 0:
        tree["big"] = rng.standard_normal(20000).astype(np.float32)   # ext 32
        tree["fixext16"] = np.arange(5, dtype=np.uint8)               # a 16-byte payload
    return tree


@pytest.mark.parametrize("seed", range(6))
def test_reader_matches_flax_on_random_trees(seed):
    data = serialization.to_bytes(random_tree(np.random.default_rng(seed)))
    assert_same_tree(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_raises(monkeypatch):
    good = serialization.to_bytes({"a": np.arange(300, dtype=np.float32), "b": {"c": 1}})
    for cut in (1, 5, 40, len(good) // 2, len(good) - 1):
        with pytest.raises(ValueError, match="truncated"):
            flax_msgpack.msgpack_restore(good[:cut])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.msgpack_restore(good + b"\x00")
    with pytest.raises(ValueError, match="complex"):
        flax_msgpack.msgpack_restore(serialization.to_bytes({"z": complex(1, 2)}))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    chunked = serialization.to_bytes({"a": np.arange(300, dtype=np.float32)})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.msgpack_restore(chunked)

    def ext(code, payload):
        return msgpack.packb({"x": msgpack.ExtType(code, payload)}, use_bin_type=True)

    with pytest.raises(ValueError, match="unknown dtype"):
        flax_msgpack.msgpack_restore(ext(1, msgpack.packb(((2,), "float13", b"\0" * 4),
                                                          use_bin_type=True)))
    with pytest.raises(ValueError, match="holds"):
        flax_msgpack.msgpack_restore(ext(1, msgpack.packb(((3,), "float32", b"\0" * 8),
                                                          use_bin_type=True)))
    for size in (1, 2, 4, 8, 16, 17, 300):   # fixext 1..16, ext 8, ext 16 headers
        with pytest.raises(ValueError, match="unknown msgpack ext type 7"):
            flax_msgpack.msgpack_restore(ext(7, b"\1" * size))


def test_port_format_round_trips(tmp_path):
    opt = tiny()
    net = PWCNet(pwc_config_from_options(opt), generator=torch.Generator().manual_seed(3))
    state = create_train_state(net, opt, epoch=5)
    loss = sum((p.float() ** 2).sum() for p in net.parameters())
    loss.backward()
    state.optimizer.step()
    state = dataclasses.replace(state, step=11)
    model_path, optim_path = checkpoint.save_checkpoint(tmp_path, state, opt, 5)
    assert (model_path.name, optim_path.name) == ("model_5.pt", "optimState_5.pt")
    assert Options.from_json((tmp_path / "options.json").read_text()) == opt

    loaded, next_epoch = checkpoint.load_train_checkpoint(tmp_path, opt, device="cpu")
    assert next_epoch == 6 and loaded.step == 11 and loaded.epoch == 5
    for (name, p), q in zip(net.named_parameters(), loaded.model.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.rule.state[p][k],
                               loaded.optimizer.rule.state[q][k]), (name, k)
    params, cfg = checkpoint.load_model_checkpoint(tmp_path)
    assert cfg == pwc_config_from_options(opt)
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in params.items())


def test_model_factory_follows_jax():
    from back2future_tpu.models.factory import model_and_config as jax_model_and_config
    from back2future_tpu_torch.models.factory import model_and_config, model_for_config

    net, cfg = model_and_config(tiny(), generator=torch.Generator().manual_seed(0))
    assert isinstance(net, PWCNet) and cfg == net.cfg == pwc_config_from_options(tiny())
    assert isinstance(model_for_config(cfg), PWCNet)
    # netType spynet builds what JAX's factory builds: the same config
    # fields (the dtype as each package spells it) and the same parameter
    # names and shapes (JAX's created by an init at the tiny size)
    spy_net, spy_cfg = model_and_config(tiny(netType="spynet"),
                                        generator=torch.Generator().manual_seed(0))
    jax_net, jax_cfg = jax_model_and_config(tiny(JaxOptions, netType="spynet"))
    assert type(spy_net).__name__ == type(jax_net).__name__ == "SPyNet"
    assert isinstance(model_for_config(spy_cfg), type(spy_net))
    want_fields = dataclasses.asdict(jax_cfg)
    got_fields = dataclasses.asdict(spy_cfg)
    assert set(got_fields) == set(want_fields)
    assert {k: v for k, v in got_fields.items() if k != "dtype"} == \
        {k: v for k, v in want_fields.items() if k != "dtype"}
    assert str(got_fields["dtype"]).split(".")[-1] == jnp.dtype(want_fields["dtype"]).name
    jax_params = jax_net.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 64, 3 * jax_cfg.frames)))["params"]
    assert {name: tuple(v.shape) for name, v in flax_to_torch_names(jax_params).items()} == \
        {name: tuple(p.shape) for name, p in spy_net.named_parameters()}
    bogus = dataclasses.replace(tiny(), netType="bogus")
    with pytest.raises(ValueError) as jax_err:
        jax_model_and_config(dataclasses.replace(tiny(JaxOptions), netType="bogus"))
    with pytest.raises(ValueError) as port_err:
        model_and_config(bogus)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(TypeError):
        model_for_config(object())


def test_latest_checkpoint_over_mixed_names(tmp_path):
    assert checkpoint.latest_checkpoint(tmp_path / "none") == (None, 0)
    for name in ("model_1.pt", "model_3.msgpack", "model_2.pt", "model_x.pt", "model_9.ckpt",
                 "optimState_12.pt", "model_10.msgpack"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoint.latest_checkpoint(tmp_path) == (tmp_path / "model_10.msgpack", 10)
    (tmp_path / "model_10.pt").write_bytes(b"")     # a tie: the port's own file
    assert checkpoint.latest_checkpoint(tmp_path) == (tmp_path / "model_10.pt", 10)
    (tmp_path / "model_11.orbax").mkdir()
    with pytest.raises(ValueError, match="msgpack"):
        checkpoint.latest_checkpoint(tmp_path)
    with pytest.raises(ValueError, match="msgpack"):
        checkpoint.load_model_checkpoint(tmp_path / "model_11.orbax")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_optax_state_lands_in_the_torch_rule(jax_written, layout):
    d, jax_opt, params, opt_state = jax_written[layout]
    opt = tiny(**LAYOUTS[layout])
    state, next_epoch = checkpoint.load_train_checkpoint(d, opt, device="cpu")
    assert next_epoch == 3 and state.step == 7 and state.epoch == 2
    want_params = flax_to_torch_names(params)
    node = checkpoint._rule_state(serialization.to_state_dict(opt_state))
    moments = ({"momentum_buffer": node["trace"]} if layout == "sgd"
               else {"exp_avg": node["mu"], "exp_avg_sq": node["nu"]})
    moments = {k: flax_to_torch_names(v) for k, v in moments.items()}
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want_params[name])
        rule_state = state.optimizer.rule.state[p]
        for k, flat in moments.items():
            np.testing.assert_array_equal(rule_state[k].numpy(), flat[name], err_msg=name)
        if layout != "sgd":
            assert rule_state["step"].item() == 2.0
    other = dict(optimizer="adam") if layout == "sgd" else dict(optimizer="sgd")
    with pytest.raises(ValueError, match="the options ask for"):
        checkpoint.load_train_checkpoint(d, tiny(**other), device="cpu")


def test_init_serves_jax_checkpoint_like_jax_init(jax_written, monkeypatch):
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    d = jax_written["adam"][0]
    rng = np.random.default_rng(8)
    ims = [rng.random((70, 140, 3), dtype=np.float32) for _ in range(3)]
    want = jax_api.init(str(d))(*ims)
    est = api.init(str(d), device="cpu")
    assert est.config == pwc_config_from_options(tiny())
    got = est(*ims)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for a, b in zip(got[1:], want[1:]):
        assert np.mean(a != b) <= 1e-3
    assert api.init(str(d / "model_2.msgpack"), device="cpu", dtype="bfloat16").config.dtype \
        == torch.bfloat16


def test_init_rejects_what_jax_rejects(tmp_path, monkeypatch):
    """An empty directory raises JAX init's FileNotFoundError; a SPyNet
    checkpoint raises JAX init's ValueError from its options alone (its
    model file here is not even msgpack)."""
    monkeypatch.setenv("B2F_COMPILE_CACHE", "0")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError) as jax_err:
        jax_api.init(str(empty))
    with pytest.raises(FileNotFoundError) as port_err:
        api.init(str(empty), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    spy = tmp_path / "spy"
    spy.mkdir()
    (spy / "options.json").write_text(JaxOptions(netType="spynet").derive().to_json())
    (spy / "model_1.msgpack").write_bytes(b"not msgpack")
    with pytest.raises(ValueError) as port_err:
        api.init(str(spy), device="cpu")
    # back2future_tpu/api.py:481-486, with the SPyNet config's class name
    assert str(port_err.value) == (f"checkpoint at {str(spy)!r} was trained with netType="
                                   f"SPyNetConfig; load() serves the PWC family only")


def test_load_or_convert_matches_jax_surgery(jax_written, tmp_path):
    hard_ckpt = jax_written["adam"][0] / "model_2.msgpack"
    soft = dict(pme_criterion="OBGCC", past_flow=True, retrain=str(hard_ckpt),
                convert_to_soft=True, epochNumber=4, cache=str(tmp_path))
    want, _, epoch0 = jax_checkpoint.load_or_convert(tiny(JaxOptions, **soft))
    net, cfg, port_epoch0 = checkpoint.load_or_convert(tiny(**soft))
    assert epoch0 == port_epoch0 == 4 and cfg.past_flow
    got = to_flax_params(net)
    assert set(got) == set(want)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    for kw in (dict(past_flow=False), ):
        with pytest.raises(ValueError) as jax_err:
            jax_checkpoint.load_or_convert(tiny(JaxOptions, **dict(soft, **kw)))
        with pytest.raises(ValueError) as port_err:
            checkpoint.load_or_convert(tiny(**dict(soft, **kw)))
        assert str(port_err.value) == str(jax_err.value)
