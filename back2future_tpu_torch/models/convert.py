"""Reference .t7 checkpoint -> flax-named param tree conversion (the port's
own copy of back2future_tpu/models/convert.py, held against it by
tests/test_torch_t7.py).

The reference's pretrained models are serialized nngraph gModules
(back2future.lua:113-116; saved via saveDataParallel, util.lua:50-78).
Conversion walks the serialized graph, collects the SpatialConvolution
modules in construction order, de-duplicates the weight-shared siamese
clones (models/pwc.lua:187-195 clones share storage, so clone weights are
value-identical), and assigns them to the flax module names:

  construction order (models/pwc.lua:87-508, frames F, levels L, skip 2):
    1. feature pyramid ConvUnits for frame 1: levels 2..L, 2 convs each
       (clones for frames 2..F are skipped via value-dedup)
    2. per level l = L..l_st (coarsest -> finest):
       occlusion decoder (6 convs)          -> occ_decoder_l
       flow decoder (6 convs)               -> flow_decoder_l
       [past-flow decoder (6 convs) when past_flow] -> past_decoder_l

Weight layout: torch (outC, inC, kH, kW) -> flax (kH, kW, inC, outC).

The result is the flax-named numpy tree the JAX package produces; it
reaches a torch module only through the params bridge's one name map
(`models.bridge.load_flax_params`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..io.t7 import _deep_recursion, load_t7

_CONV_TYPES = ("nn.SpatialConvolution", "cudnn.SpatialConvolution",
               "nn.SpatialConvolutionMM")


def iter_modules(obj: Any, seen: Optional[set] = None):
    """DFS over a deserialized t7 object, yielding nn-module dicts in
    serialization order (nngraph stores nodes in graph order)."""
    if seen is None:
        seen = set()
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, dict):
        if "torch_type" in obj and str(obj["torch_type"]).startswith(
                ("nn.", "cudnn.")):
            yield obj
        for key in ("modules", "forwardnodes", "data", "module", "children",
                    "payload"):
            if key in obj:
                yield from iter_modules(obj[key], seen)
        for k, v in obj.items():
            if k not in ("torch_type", "weight", "bias", "gradWeight",
                         "gradBias", "output", "gradInput"):
                yield from iter_modules(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from iter_modules(v, seen)


def collect_convs(model_t7: Any) -> List[Dict[str, np.ndarray]]:
    """All convolution modules (with weights) in serialization order."""
    convs = []
    with _deep_recursion():  # nngraph node chains recurse deeply
        convs_iter = list(iter_modules(model_t7))
    for m in convs_iter:
        if str(m.get("torch_type")) in _CONV_TYPES and "weight" in m:
            w = np.asarray(m["weight"], np.float32)
            if w.ndim == 2:  # SpatialConvolutionMM folded layout
                kh = int(m.get("kH", 3))
                kw = int(m.get("kW", 3))
                nin = int(m.get("nInputPlane", w.shape[1] // (kh * kw)))
                w = w.reshape(w.shape[0], nin, kh, kw)
            convs.append({
                "weight": w,
                "bias": np.asarray(m["bias"], np.float32)
                if m.get("bias") is not None else None,
                "type": m["torch_type"],
            })
    return convs


def dedupe_siamese(convs: List[Dict], n_frames: int,
                   n_pyramid_convs: int) -> List[Dict]:
    """Drop the value-identical clone copies of the feature pyramid
    (frames 2..F repeat the frame-1 convs; models/pwc.lua:187-195)."""
    if n_frames <= 1 or len(convs) < n_pyramid_convs * 2:
        return convs
    head = convs[:n_pyramid_convs]
    rest = convs[n_pyramid_convs:]
    dropped = 0
    while dropped < (n_frames - 1) * n_pyramid_convs and rest:
        cand = rest[0]
        ref = head[dropped % n_pyramid_convs]
        if (cand["weight"].shape == ref["weight"].shape
                and np.array_equal(cand["weight"], ref["weight"])):
            rest.pop(0)
            dropped += 1
        else:
            break
    return head + rest


def _to_flax_conv(conv: Dict) -> Dict[str, np.ndarray]:
    w = np.transpose(conv["weight"], (2, 3, 1, 0))  # OIHW -> HWIO
    out = {"kernel": np.ascontiguousarray(w)}
    if conv["bias"] is not None:
        out["bias"] = conv["bias"]
    return out


def assign_params(convs: List[Dict], *, frames: int = 3, levels: int = 7,
                  skip: int = 2, past_flow: bool = False) -> Dict[str, Any]:
    """Ordered conv list -> flax param tree for models.pwc.PWCNet."""
    l_st = max(skip + 1, 1)
    n_out_levels = levels - l_st + 1
    n_pyr = 2 * (levels - 1)  # ConvUnit(2 convs) per level 2..levels
    decoders_per_level = (1 if frames <= 2 else 2) + (1 if past_flow else 0)
    expected = n_pyr + n_out_levels * decoders_per_level * 6
    convs = dedupe_siamese(list(convs), frames, n_pyr)
    if len(convs) != expected:
        raise ValueError(
            f"conv count mismatch: have {len(convs)} after clone dedup, "
            f"expected {expected} (pyramid {n_pyr} + "
            f"{n_out_levels} levels x {decoders_per_level} decoders x 6)")

    params: Dict[str, Any] = {}
    it = iter(convs)

    for l in range(2, levels + 1):
        params[f"feat_{l}"] = {"c0": {"conv": _to_flax_conv(next(it))},
                               "c1": {"conv": _to_flax_conv(next(it))}}

    def decoder():
        d = {}
        for i in range(5):
            d[f"c{i}"] = {"conv": _to_flax_conv(next(it))}
        d["out"] = {"conv": _to_flax_conv(next(it))}
        return d

    # coarsest -> finest, occ decoder before flow decoder(s)
    # (models/pwc.lua:286-352)
    for l in range(levels, l_st - 1, -1):
        if frames > 2:
            params[f"occ_decoder_{l}"] = decoder()
        params[f"flow_decoder_{l}"] = decoder()
        if past_flow:
            params[f"past_decoder_{l}"] = decoder()
    return params


def convert_t7_checkpoint(path: str, *, frames: int = 3, levels: int = 7,
                          skip: int = 2,
                          past_flow: bool = False) -> Dict[str, Any]:
    """Load a reference .t7 model file and return flax params."""
    model = load_t7(path)
    # unwrap DataParallelTable (back2future.lua:113-116)
    if isinstance(model, dict) and \
            model.get("torch_type") == "nn.DataParallelTable":
        model = model["modules"][0]
    convs = collect_convs(model)
    return assign_params(convs, frames=frames, levels=levels, skip=skip,
                         past_flow=past_flow)


def inspect_t7(path: str) -> List[str]:
    """Human-readable module listing for mapping verification."""
    model = load_t7(path)
    lines = []
    for m in iter_modules(model):
        t = m.get("torch_type", "?")
        if "weight" in m and isinstance(m["weight"], np.ndarray):
            lines.append(f"{t} weight={tuple(m['weight'].shape)}")
        else:
            lines.append(str(t))
    return lines
