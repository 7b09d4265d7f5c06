"""The JAX package's seeded initialisation, reproduced in numpy.

The repo's `__graft_entry__.py` `entry()` and `dryrun_multichip()`
initialise the flagship net with `PWCNet.init(PRNGKey(0), ...)`, and the
losses they record (49.97828 hard, 100.98643 soft, MULTICHIP_r05.json)
hold for those weights only. The port's counterparts need the same
weights on a machine without the JAX package, so this module recomputes
them: every conv of the package (models/layers.py `Conv`) draws its
kernel and its bias with `uniform(key, shape, -stdv, stdv)`,
stdv = 1/sqrt(kh*kw*in), from a key that flax derives from the root key
and the param's place:

* the key of a param is `fold_in(root, h)`, where h is the first 4 bytes
  (big-endian) of the SHA-1 of the conv's module path joined without a
  separator, then the scope's param counter as minimal big-endian bytes
  (1 for the kernel, 2 for the bias, created in that order);
* `fold_in(key, h)` is `threefry2x32(key, (0, h))`;
* `uniform` hashes the flat index i of each element as the counter pair
  (i >> 32, i & 0xffffffff), XORs the two output words, keeps the top 23
  bits as the mantissa of a float in [1, 2), subtracts 1, scales to
  [min, max) and clamps at min (the partitionable threefry of JAX 0.5+).

`tests/test_torch_graft_entry.py` holds the result against the JAX
package's init, leaf by leaf.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds on uint32 arrays (JAX's
    `_threefry2x32_lowering`)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """`PRNGKey(seed)` for a seed below 2**64: (seed >> 32, seed & 0xffffffff)."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return int(y0[0]), int(y1[0])


def _flax_fold(key: Tuple[int, int], suffix: Tuple) -> Tuple[int, int]:
    """flax's `_fold_in_static` (no separator): one fold_in of a SHA-1."""
    m = hashlib.sha1()
    for x in suffix:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def uniform(key: Tuple[int, int], shape: Tuple[int, ...], minval: float,
            maxval: float) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # one rounding of the product and the sum, as XLA's fused multiply-add
    fused = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, fused).reshape(shape)


def flax_init_tree(module: torch.nn.Module, seed: int = 0) -> Dict[str, np.ndarray]:
    """Torch parameter name -> float32 array (OIHW kernels) of the JAX
    package's `init(PRNGKey(seed))` for the net whose torch twin is
    `module`: every parameter of which is a conv's `weight` or `bias`
    (the PWC family)."""
    root = prng_key(seed)
    params = dict(module.named_parameters())
    out = {}
    for name in params:
        *mods, leaf = name.split(".")
        if leaf not in ("weight", "bias"):
            raise KeyError(f"{name}: not a conv parameter")
        kernel = params[".".join(mods + ["weight"])]
        o, i, kh, kw = kernel.shape
        stdv = 1.0 / float(kh * kw * i) ** 0.5
        key = _flax_fold(root, (*mods, "conv", 1 if leaf == "weight" else 2))
        if leaf == "weight":
            out[name] = np.ascontiguousarray(
                uniform(key, (kh, kw, i, o), -stdv, stdv).transpose(3, 2, 0, 1))
        else:
            out[name] = uniform(key, (o,), -stdv, stdv)
    return out


@torch.no_grad()
def load_flax_init(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Copy `flax_init_tree(module, seed)` into `module`, in place."""
    tree = flax_init_tree(module, seed)
    for name, p in module.named_parameters():
        p.copy_(torch.from_numpy(tree[name]))
    return module
