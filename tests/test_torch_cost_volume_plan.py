"""The tile plan of K1's tensor-core kernel (csrc/cost_volume_fwd_mma.cu),
modelled in plain torch and held against the cost volume's twin and the
JAX package's `cost_volume` and `cost_volume_pallas` (interpret mode).

The kernel cannot be compiled or run on the CPU; this model repeats its
index arithmetic step by step with the same constants, so a fault in the
plan shows here:
- tiles of TH x TW pixels; C in chunks of CK channels (two k16 steps,
  the tail zero-filled, a last chunk of <= 16 channels one k16 step);
- staged frame "slot" rows ty + u*min(dil, TH), passes of FC frame
  columns starting at x0 - pad;
- per (tile row, qy row u) a 16 x FC product over the chunk (the m16 x
  three n8 `mma.sync` tiles), summed in f32 over the chunks;
- the band: sum (i, j) of pass p goes to q = ix*win + iy where
  p*FC + j - i = u*dil, u < win, mirrored when fwd;
- the output tile rows staged at a shift of (run + out_off) % 8 elements
  and stored in 8-element (16-byte) chunks, whole chunks aligned in
  device memory, ends element by element.
Tolerance: f32 1e-5 (channel sums in another order).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from back2future_tpu.ops import cost_volume as jax_cost_volume
from back2future_tpu.ops.cost_volume_pallas import cost_volume_pallas
from back2future_tpu_torch import ops

torch.set_num_threads(1)

SOURCE = Path(__file__).resolve().parent.parent / "back2future_tpu_torch/csrc/cost_volume_fwd_mma.cu"
TH, TW, FC, CK, QG = 4, 16, 24, 32, 3   # the kernel's constants
TOL = dict(rtol=1e-5, atol=1e-5)


def take(img, rows, cols):
    """img[rows][:, cols] of an (H, W, C) image, 0 outside it."""
    h, w, _ = img.shape
    r = torch.as_tensor(rows)
    c = torch.as_tensor(cols)
    inside = ((r >= 0) & (r < h))[:, None] & ((c >= 0) & (c < w))[None, :]
    got = img[r.clamp(0, h - 1)][:, c.clamp(0, w - 1)]
    return got * inside[..., None]


def plan_cost_volume(ref, frame, win, dil, fwd, scale=1.0, out_off=0):
    """K1's bf16 kernel, step by step, in f32: (B, H, W, win*win)."""
    b, h, w, c = ref.shape
    q = win * win
    pad = (win - 1) // 2 * dil
    step = min(dil, TH)
    slots = TH + (win - 1) * step
    chunks = math.ceil(c / CK)
    passes = math.ceil((TW + 2 * pad) / FC)
    out_row = (TW * q + 7 + 7) // 8 * 8
    slot_rows = [s if dil <= TH else s % TH + (s // TH) * dil for s in range(slots)]
    # the band: column j of pass p against pixel i -> (u = (p*FC + j - i) / dil)
    i = torch.arange(TW)[:, None]
    flat = torch.full((out_off + b * h * w * q,), float("nan"))
    for bi in range(b):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                out_s = torch.full((TH, out_row), float("nan"))   # unwritten: never stored
                runs = [((bi * h + y0 + ty) * w + x0) * q for ty in range(TH)]
                shifts = [(run + out_off) % 8 for run in runs]
                for p in range(passes):
                    acc = torch.zeros(TH, win, TW, FC)
                    for k in range(chunks):
                        c0 = k * CK
                        ksteps = min(CK // 16, math.ceil((c - c0) / 16))
                        chan = slice(c0, min(c0 + 16 * ksteps, c))
                        ref_s = torch.zeros(TH, TW, 16 * ksteps)
                        frm_s = torch.zeros(slots, FC, 16 * ksteps)   # tail channels stay 0
                        n_ch = chan.stop - chan.start
                        ref_s[..., :n_ch] = take(ref[bi, ..., chan], range(y0, y0 + TH),
                                                 range(x0, x0 + TW))
                        frm_s[..., :n_ch] = take(frame[bi, ..., chan],
                                                 [y0 - pad + r for r in slot_rows],
                                                 range(x0 - pad + p * FC, x0 - pad + (p + 1) * FC))
                        rows = torch.arange(TH)[:, None] + torch.arange(win)[None, :] * step
                        acc += torch.einsum("tik,tujk->tuij", ref_s, frm_s[rows])
                    d = p * FC + torch.arange(FC)[None, :] - i
                    band = (d >= 0) & (d % dil == 0) & (d // dil < win)
                    ux = d // dil
                    ix = win - 1 - ux if fwd else ux
                    for ty in range(TH):
                        for uy in range(win):
                            iy = win - 1 - uy if fwd else uy
                            idx = shifts[ty] + i * q + ix * win + iy
                            assert int(idx[band].max()) < out_row
                            out_s[ty, idx[band]] = acc[ty, uy][band] * scale
                for ty in range(TH):
                    if y0 + ty >= h:
                        continue
                    n = min(TW, w - x0) * q
                    base = out_off + runs[ty] - shifts[ty]   # element 0 of the staged row
                    for lo in range(0, out_row, 8):
                        if lo + 8 <= shifts[ty] or lo >= shifts[ty] + n:
                            continue
                        if lo >= shifts[ty] and lo + 8 <= shifts[ty] + n:   # one 16-byte store
                            assert (base + lo) % 8 == 0
                            flat[base + lo:base + lo + 8] = out_s[ty, lo:lo + 8]
                        else:
                            for kk in range(max(lo, shifts[ty]), min(lo + 8, shifts[ty] + n)):
                                flat[base + kk] = out_s[ty, kk]
    out = flat[out_off:].view(b, h, w, q)
    assert not torch.isnan(out).any(), "an output element was never written"
    return out


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_plan_constants_are_the_kernels():
    src = SOURCE.read_text()
    for name, value in dict(TH=TH, TW=TW, FC=FC, CK=CK, QG=QG).items():
        assert re.search(rf"constexpr int {name} = {value};", src), name


# win x dil x direction x C (one chunk with a zero tail, one whole chunk);
# 9 x 37 pixels: ragged tiles in both directions, a width that is not a
# multiple of 16
PLAN_CASES = [(win, dil, fwd, c) for win in (3, 5, 7, 9) for dil in (1, 2)
              for fwd in (True, False) for c in (20, 32)]


def plan_inputs(c):
    return rand((2, 9, 37, c), 1 + c), rand((2, 9, 37, c), 2 + c)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX cost volume, XLA and Pallas (interpret mode), per case. Both
    channel counts go through one call per (win, dil, fwd): the C = 20
    inputs zero-padded to 32 channels, which leaves their sums as they
    are, behind the C = 32 inputs in the batch."""
    cache = {}

    def get(win, dil, fwd, c):
        key = (win, dil, fwd)
        if key not in cache:
            pad = lambda x: np.pad(x, ((0, 0),) * 3 + ((0, 12),))   # noqa: E731
            (r32, f32), (r20, f20) = plan_inputs(32), plan_inputs(20)
            r = jnp.asarray(np.concatenate([r32, pad(r20)]))
            f = jnp.asarray(np.concatenate([f32, pad(f20)]))
            cache[key] = (np.asarray(jax_cost_volume(r, f, win=win, dilation=dil, fwd=fwd)),
                          np.asarray(cost_volume_pallas(r, f, win, dil, fwd)))
        part = slice(0, 2) if c == 32 else slice(2, 4)
        return tuple(out[part] for out in cache[key])
    return get


@pytest.mark.parametrize("win,dil,fwd,c", PLAN_CASES)
def test_plan_matches_twin_and_jax(jax_outputs, win, dil, fwd, c):
    ref, frame = map(torch.from_numpy, plan_inputs(c))
    got = plan_cost_volume(ref, frame, win, dil, fwd)
    assert got.shape == (2, 9, 37, win * win)
    torch.testing.assert_close(got, ops.cost_volume_reference(ref, frame, win, dil, fwd), **TOL)
    want_xla, want_pallas = jax_outputs(win, dil, fwd, c)
    np.testing.assert_allclose(got.numpy(), want_xla, **TOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)


# several chunks (C = 72: a last chunk of 8 channels, one k16 step; the
# main path's 64 and 192), widths of the main path's levels 6 and 7 (38,
# 19), a dilation past TH (slots in groups of TH rows, several passes),
# and every output misalignment
MORE_CASES = {
    "c72_w19": dict(shape=(1, 5, 19, 72), win=9, dil=1, fwd=True, out_off=0),
    "c192_w19_past": dict(shape=(1, 5, 19, 192), win=9, dil=1, fwd=False, out_off=3),
    "c64_w38": dict(shape=(1, 6, 38, 64), win=9, dil=1, fwd=True, out_off=5),
    "dil5_win5": dict(shape=(1, 11, 23, 16), win=5, dil=5, fwd=True, out_off=1),
    "dil5_win9_past": dict(shape=(1, 7, 21, 24), win=9, dil=5, fwd=False, out_off=6),
    "dil3_win7": dict(shape=(2, 8, 17, 8), win=7, dil=3, fwd=True, out_off=7),
    "1x1": dict(shape=(1, 1, 1, 3), win=3, dil=1, fwd=False, out_off=2),
    "c20_off4": dict(shape=(1, 4, 16, 20), win=9, dil=2, fwd=True, out_off=4),
}


@pytest.mark.parametrize("case", sorted(MORE_CASES))
def test_plan_more_shapes(case):
    kw = MORE_CASES[case]
    ref, frame = torch.from_numpy(rand(kw["shape"], 3)), torch.from_numpy(rand(kw["shape"], 4))
    got = plan_cost_volume(ref, frame, kw["win"], kw["dil"], kw["fwd"], scale=0.25,
                           out_off=kw["out_off"])
    want = ops.cost_volume_reference(ref, frame, kw["win"], kw["dil"], kw["fwd"], scale=0.25)
    torch.testing.assert_close(got, want, **TOL)
    want_xla = np.asarray(jax_cost_volume(jnp.asarray(ref.numpy()), jnp.asarray(frame.numpy()),
                                          win=kw["win"], dilation=kw["dil"], fwd=kw["fwd"]))
    np.testing.assert_allclose(got.numpy(), want_xla * 0.25, **TOL)
