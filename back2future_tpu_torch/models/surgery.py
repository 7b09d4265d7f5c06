"""Hard -> soft constraint model surgery (counterpart of
back2future_tpu/models/surgery.py).

The reference turns its hard-constraint model (one future-flow decoder,
past frames warped by the negated future flow) into a soft-constraint one
(separate past-flow decoders) by copying weights through hard-coded
nngraph indices (model.lua:56-116). Here decoders are named
(`flow_decoder_<l>` / `past_decoder_<l>`), so the surgery is a structural
copy that works for any level count. It works on the flax-named numpy
tree of `models.bridge`, so it is held against the JAX function leaf by
leaf; `convert_net_hard_to_soft` applies it to the port's modules.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .bridge import load_flax_params, to_flax_params
from .pwc import PWCNet


def _copy_checked(name: str, src: Any, like: Any) -> Any:
    """A copy of `src` with the tree structure and leaf shapes of `like`."""
    if isinstance(like, Mapping):
        if not isinstance(src, Mapping) or set(src) != set(like):
            raise ValueError(f"structure mismatch in {name}")
        return {k: _copy_checked(name, src[k], like[k]) for k in like}
    src, like = np.asarray(src), np.asarray(like)
    if src.shape != like.shape:
        raise ValueError(f"shape mismatch in {name}: {src.shape} vs {like.shape}")
    return src.copy()


def convert_hard_to_soft(hard_params: Mapping[str, Any],
                         soft_params: Mapping[str, Any]) -> Dict[str, Any]:
    """Fill a soft (past_flow=True) param tree from a hard-model tree:
    every module that exists in both is copied, and each
    `past_decoder_<l>` is seeded from the hard `flow_decoder_<l>`.

    Both trees are flax-named (`models.bridge`); `soft_params` gives the
    target structure. Raises KeyError where a soft module has no source
    and ValueError on a structure or shape mismatch."""
    out = {}
    for name, sub in soft_params.items():
        if name in hard_params:
            src = hard_params[name]
        elif name.startswith("past_decoder_"):
            src = hard_params[f"flow_decoder_{name[len('past_decoder_'):]}"]
        else:
            raise KeyError(f"no source for soft-model module {name!r}")
        out[name] = _copy_checked(name, src, sub)
    return out


def convert_net_hard_to_soft(hard: PWCNet, soft: PWCNet) -> PWCNet:
    """Load `soft` (a PWCNet with past_flow=True) in place with the
    surgery of `hard`'s weights; returns `soft`."""
    load_flax_params(soft, convert_hard_to_soft(to_flax_params(hard), to_flax_params(soft)))
    return soft
