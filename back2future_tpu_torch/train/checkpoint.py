"""Checkpoint / resume / conversion (counterpart of
back2future_tpu/train/checkpoint.py:69-245; train.lua:179-185,
util.lua:50-140, model.lua:38-142).

  * Every `epochStore` epochs the model and the optimiser state are saved
    SEPARATELY, as the reference does (train.lua:179-185):
    `model_<e>.pt` (the module's `state_dict`), `optimState_<e>.pt`
    (`{"optimizer": the update rule's state_dict, "step", "epoch"}`),
    both by `torch.save`, plus the `options.json` sidecar
    (`Options.to_json`, which the JAX package reads too). They load with
    `weights_only=True`.
  * The JAX package's msgpack pairs load too: `model_<e>.msgpack` through
    the port's own flax msgpack reader (io/flax_msgpack.py) and the params
    bridge, `optimState_<e>.msgpack` by carrying the optax moments into
    the torch rule (`mu` -> `exp_avg`, `nu` -> `exp_avg_sq`, `count` ->
    Adam's `step`, `trace` -> SGD's `momentum_buffer`; kernels HWIO ->
    OIHW by the bridge's name map). The JAX package's orbax directories
    (a JAX library format) are refused with a ValueError.
  * `latest_checkpoint` finds the newest `model_<e>` (util.lua:127-140)
    for `-cont`; `load_or_convert` is the startup decision of
    model.lua:38-142: `-cont` > `-retrain` (with the hard -> soft surgery
    of `convert_to_soft`) > a fresh init from
    `torch.Generator().manual_seed(opt.manualSeed)`.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Mapping, Optional, Tuple

import torch

from ..config import Options
from ..io.flax_msgpack import load as load_msgpack
from ..models.bridge import check_names, flax_to_torch_names, load_flax_params
from ..models.factory import Model, ModelConfig, config_for_options, model_for_config
from ..models.surgery import convert_net_hard_to_soft
from .optim import make_optimizer
from .state import TrainState

_MODEL = re.compile(r"model_(\d+)\.(pt|msgpack|orbax)")
# on a tie of epochs the port's own file wins
_PREFERENCE = {"pt": 2, "msgpack": 1, "orbax": 0}


def _orbax_error(path) -> ValueError:
    return ValueError(
        f"{path} is an orbax checkpoint (the JAX package's save_checkpoint(backend='orbax')); "
        f"the port reads the msgpack backend's model_<e>.msgpack / optimState_<e>.msgpack "
        f"files and its own .pt files")


def save_checkpoint(save_dir: str | Path, state: TrainState, opt: Options,
                    epoch: int) -> Tuple[Path, Path]:
    """Save model_<e>.pt + optimState_<e>.pt (+ the options.json sidecar).
    The model's keys are the bare net's, under DDP too: a
    DistributedDataParallel wrapper is unwrapped first, so a file never
    holds its `module.` prefix and loads in `init(path)` as any other."""
    model = state.model
    if isinstance(model, torch.nn.parallel.DistributedDataParallel):
        model = model.module
    d = Path(save_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "options.json").write_text(opt.to_json())
    model_path = d / f"model_{epoch}.pt"
    optim_path = d / f"optimState_{epoch}.pt"
    torch.save(model.state_dict(), model_path)
    torch.save({"optimizer": state.optimizer.rule.state_dict(), "step": int(state.step),
                "epoch": int(epoch)}, optim_path)
    return model_path, optim_path


def latest_checkpoint(save_dir: str | Path) -> Tuple[Optional[Path], int]:
    """Newest model_<e>.pt / model_<e>.msgpack in a directory -> (path,
    epoch) (util.lua:127-140); (None, 0) when there is none. ValueError
    when the newest is an orbax directory."""
    best, best_key = None, (0, -1)
    d = Path(save_dir)
    if d.is_dir():
        for p in d.glob("model_*"):
            m = _MODEL.fullmatch(p.name)
            if m:
                key = (int(m.group(1)), _PREFERENCE[m.group(2)])
                if key > best_key:
                    best, best_key = p, key
    if best is not None and best.suffix == ".orbax":
        raise _orbax_error(best)
    return best, best_key[0]


def checkpoint_options(path: Path) -> Optional[Options]:
    """The options of the run that wrote the checkpoint file `path`: its
    options.json sidecar, or None."""
    sidecar = path.parent / "options.json"
    if sidecar.exists():
        return Options.from_json(sidecar.read_text())
    return None


def resolve_checkpoint(path: str | Path) -> Path:
    """A model_<e> file, or the newest one of a directory."""
    p = Path(path)
    if p.suffix == ".orbax":
        raise _orbax_error(p)
    if p.is_dir():
        p, _ = latest_checkpoint(p)
        if p is None:
            raise FileNotFoundError(f"no model_<e> checkpoint under {path}")
    return p


def load_model_checkpoint(path: str | Path, opt: Optional[Options] = None
                          ) -> Tuple[Any, ModelConfig]:
    """-> (params, model config). `path` may be a model_<e>.pt or
    model_<e>.msgpack file or a directory holding them (newest wins); the
    options.json sidecar (or an explicit `opt`, else `Options().derive()`)
    says which graph the params belong to. `params` is a `state_dict` for
    a .pt file and the flax-named tree of numpy arrays for a .msgpack
    file; `load_params` takes either."""
    p = resolve_checkpoint(path)
    opt = opt or checkpoint_options(p) or Options().derive()
    cfg = config_for_options(opt)
    if p.suffix == ".pt":
        return torch.load(p, map_location="cpu", weights_only=True), cfg
    return load_msgpack(p), cfg


def load_params(net: torch.nn.Module, params: Mapping) -> None:
    """Load what `load_model_checkpoint` returned into `net`, in place."""
    if any(isinstance(v, Mapping) for v in params.values()):
        load_flax_params(net, params)
    else:
        net.load_state_dict(params)


def build_from_params(cfg: ModelConfig, params: Mapping) -> Model:
    """The module of `cfg` (on the CPU) holding `params`."""
    net = model_for_config(cfg, generator=torch.Generator())
    load_params(net, params)
    return net


def _rule_state(tree: Mapping) -> Mapping:
    """The optax state of the update rule inside a chain's state dict:
    the map holding Adam's count/mu/nu or SGD's trace, wherever the
    chain (decay, clip) put it."""
    found = []

    def visit(node):
        if isinstance(node, Mapping):
            if {"count", "mu", "nu"} <= set(node) or "trace" in node:
                found.append(node)
            else:
                for v in node.values():
                    visit(v)

    visit(tree)
    if len(found) != 1:
        raise ValueError(f"expected one Adam or SGD state in the optax state, found {len(found)}")
    return found[0]


def load_optax_state(optimizer, net: torch.nn.Module, opt_state: Mapping) -> None:
    """Carry the JAX package's optax state (as flax's state dict) into the
    torch update rule of `optimizer`, built over `net.parameters()`."""
    node = _rule_state(opt_state)
    rule = optimizer.rule
    names = [n for n, _ in net.named_parameters()]
    if "trace" in node:
        if not isinstance(rule, torch.optim.SGD):
            raise ValueError("the checkpoint holds SGD momentum; the options ask for "
                             f"{type(rule).__name__}")
        moments = {"momentum_buffer": flax_to_torch_names(node["trace"])}
        extra = {}
    else:
        if not isinstance(rule, torch.optim.Adam):
            raise ValueError("the checkpoint holds Adam moments; the options ask for "
                             f"{type(rule).__name__}")
        moments = {"exp_avg": flax_to_torch_names(node["mu"]),
                   "exp_avg_sq": flax_to_torch_names(node["nu"])}
        extra = {"step": torch.tensor(float(node["count"]), dtype=torch.float32)}
    for flat in moments.values():
        check_names(net, flat)
    state = {i: {**{k: extra[k].clone() for k in extra},
                 **{k: torch.from_numpy(flat[name]) for k, flat in moments.items()}}
             for i, name in enumerate(names)}
    rule.load_state_dict({"state": state, "param_groups": rule.state_dict()["param_groups"]})


def load_train_checkpoint(save_dir: str | Path, opt: Options, epoch: Optional[int] = None,
                          device="cuda") -> Tuple[TrainState, int]:
    """Full resume: -> (TrainState on `device`, next_epoch). Restores the
    params AND the optimiser moments (model.lua:51-130 retrain +
    optimState; `epoch` None picks the newest, as -cont does). `device`
    defaults to the card, as `api.init`'s does; "cpu" loads on the CPU."""
    d = Path(save_dir)
    if epoch is None:
        mp, epoch = latest_checkpoint(d)
        if mp is None:
            raise FileNotFoundError(f"no checkpoints under {save_dir}")
    else:
        mp = d / f"model_{epoch}.pt"
        if not mp.exists():
            mp = d / f"model_{epoch}.msgpack"
    params, cfg = load_model_checkpoint(mp, opt)
    net = build_from_params(cfg, params).to(device)
    optimizer = make_optimizer(opt, net.parameters(), epoch)
    if mp.suffix == ".pt":
        # on the CPU: Adam's step counters stay host tensors (a device one
        # would be read back every step); load_state_dict moves the moments
        saved = torch.load(d / f"optimState_{epoch}.pt", map_location="cpu", weights_only=True)
        optimizer.rule.load_state_dict(saved["optimizer"])
    else:
        saved = load_msgpack(d / f"optimState_{epoch}.msgpack")
        load_optax_state(optimizer, net, saved["opt_state"])
    state = TrainState(model=net, optimizer=optimizer, step=int(saved["step"]), epoch=epoch)
    return state, epoch + 1


def load_or_convert(opt: Options) -> Tuple[Model, ModelConfig, int]:
    """The model.lua:38-142 startup decision -> (module on the CPU,
    config, epoch0). Order: -cont auto-resume > -retrain
    (+ convert_to_soft surgery) > fresh init."""
    cfg = config_for_options(opt)

    def fresh() -> Model:
        return model_for_config(cfg, generator=torch.Generator().manual_seed(opt.manualSeed))

    if opt.cont:
        mp, epoch = latest_checkpoint(opt.save)
        if mp is not None:
            params, _ = load_model_checkpoint(mp, opt)
            return build_from_params(cfg, params), cfg, epoch + 1

    if opt.retrain != "none":
        if opt.convert_to_soft:
            # load hard weights into a past_flow graph (model.lua:56-116);
            # Options.derive() clears convert_to_soft for every netType but pwc
            if not opt.past_flow:
                raise ValueError("convert_to_soft requires -past_flow 1 "
                                 "(the soft graph it converts into)")
            hard_params, hard_cfg = load_model_checkpoint(
                opt.retrain, dataclasses.replace(opt, past_flow=False))
            net = convert_net_hard_to_soft(build_from_params(hard_cfg, hard_params), fresh())
        else:
            params, _ = load_model_checkpoint(opt.retrain, opt)
            net = build_from_params(cfg, params)
        return net, cfg, opt.epochNumber

    return fresh(), cfg, opt.epochNumber
