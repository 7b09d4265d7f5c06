"""The cost volume's backward in bf16 on the tensor cores
(csrc/cost_volume_bwd_mma.cu), modelled in plain torch and held against
the backward twin and JAX's `jax.vjp` of `cost_volume_pallas` (interpret
mode).

(a) The shift identity the kernel rests on: the op is bilinear, so
    d_frame = dref_form(g', ref, not fwd) with g'[y,x,q] = g[y+qy, x+qx, q]
    (`cost_volume_gshift_reference`), for every window, dilation and
    direction.
(b) The kernel cannot be compiled or run on the CPU; this model repeats
    its index arithmetic step by step with the same constants (read from
    the `.cu`), so a fault in the plan shows here: TH x TW tiles on the
    dilation lattice, CG-channel groups; g staged as the tile's rows
    (d_ref) or as its haloed tile (d_frame, which so reads the shifted
    gradient in place), each row's run in the image in 16-byte chunks
    aligned in device memory from its `shift`, the run's end chunks and
    everything outside the image element by element or zero, pixel by
    pixel at dil > 1; ROWS frame slots x KC columns in 16-byte chunks
    through the XOR swizzle, columns past TW + win - 1 zero-filled; per
    lane the banded A fragment, the B fragments of `ldmatrix.x4.trans` and
    the `mma` m16n8k16 sums, rebuilt from the fragments by PTX's layouts;
    the sums stored in pairs per lane.
Tolerance: f32 1e-5 (channel sums in another order).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu.ops.cost_volume_pallas import cost_volume_pallas
from back2future_tpu_torch import ops

torch.set_num_threads(1)

SOURCE = Path(__file__).resolve().parent.parent / "back2future_tpu_torch/csrc/cost_volume_bwd_mma.cu"
TH, TW, CG, KC = 8, 16, 32, 32          # the product kernel's constants
CCH, NT8, KS = CG // 8, CG // 8, KC // 16
TOL = dict(rtol=1e-5, atol=1e-5)

SHAPE = (7, 37)                         # ragged tiles in both directions
CHANNELS = (20, 32, 192)                # a zero-padded group, one group, six groups
CASES = [(win, dil, fwd) for win in (3, 5, 7, 9) for dil in (1, 2, 3) for fwd in (True, False)]
SCALE = 0.25


def test_plan_constants_are_the_kernels():
    src = SOURCE.read_text()
    for name, value in dict(TH=TH, TW=TW, CG=CG, KC=KC).items():
        assert re.search(rf"constexpr int {name} = {value};", src), name


def swz(chunk):
    return chunk ^ ((chunk >> 3) & 3)


def device_memory(t, off):
    """The elements of `t` as device memory holds them from `off` elements
    past a 16-byte boundary: index off + e is element e; NaN around it,
    which a copy may read but no result may use."""
    flat = t.flatten()
    return torch.cat([torch.full((off,), float("nan")), flat, torch.full((16,), float("nan"))])


LANE = torch.arange(32)
GID, TIG = LANE >> 2, LANE & 3
R, HALF = torch.arange(4).view(4, 1), torch.arange(2).view(1, 2)


def a_rows_cols(ks):
    """(row, column) of each lane's A fragment elements (lane, r, h) by
    PTX's m16n8k16 layout, and the column within the band step ks."""
    row = GID.view(32, 1, 1) + 8 * (R & 1)
    col = 2 * TIG.view(32, 1, 1) + HALF + 8 * (R >> 1)
    return row, col, ks * 16 + col


def ldmatrix_x4_trans(rows):
    """`ldmatrix.x4.trans`: rows (32 lanes, 8 values), lane l giving row
    l % 8 of matrix l // 8; returns (32 lanes, 4 regs, 2 halves): lane t
    holds elements (2*(t%4) + h, t//4) of each matrix."""
    m = rows.view(4, 8, 8)   # matrix, row, column
    k = (2 * TIG).view(32, 1, 1) + HALF.view(1, 1, 2)
    col = GID.view(32, 1, 1).expand(32, 4, 2)
    mat = torch.arange(4).view(1, 4, 1).expand(32, 4, 2)
    return m[mat, k.expand(32, 4, 2), col]


def mma(acc, a_frag, b_lo, b_hi):
    """acc (32, 4) += A (from a_frag (32, 4, 2)) . B (from the two
    registers (32, 2) each), rebuilt by PTX's m16n8k16 layouts."""
    a = torch.zeros(16, 16)
    row, col, _ = a_rows_cols(0)
    a[row.expand(32, 4, 2), col.expand(32, 4, 2)] = a_frag
    bm = torch.zeros(16, 8)
    k = 2 * TIG.view(32, 1) + HALF.view(1, 2)
    bm[k, GID.view(32, 1).expand(32, 2)] = b_lo
    bm[k + 8, GID.view(32, 1).expand(32, 2)] = b_hi
    d = a @ bm
    kk = torch.arange(4).view(1, 4)
    return acc + d[GID.view(32, 1) + 8 * (kk >> 1), 2 * TIG.view(32, 1) + (kk & 1)]


def plan_dref(g, frame, win, dil, fwd, scale=1.0, g_off=0, dframe=False):
    """The product kernel, step by step, in f32: dref_form(g, frame) for
    d_ref; for d_frame (`dframe`, `frame` = ref, `fwd` already mirrored)
    the same form on the shifted gradient, read from the haloed g tile."""
    b, h, w, c = frame.shape
    q, n = win * win, (win - 1) // 2
    rows, cols = TH + win - 1, TW + win - 1
    gr, gc, go = (rows, cols, n) if dframe else (TH, TW, 0)   # staged g rows, columns, offset
    g_row = (gc * q + 14) // 8 * 8
    tiles_x = math.ceil(w / (TW * dil)) * dil
    tiles_y = math.ceil(h / (TH * dil)) * dil
    groups = math.ceil(c / CG)
    mem = device_memory(g, g_off)
    gflat = g.flatten()
    framep = torch.cat([frame, torch.zeros(b, h, w, CG)], dim=-1)   # channels past C read 0
    out = torch.full((b, h, w, c), float("nan"))
    for blk in range(tiles_x * tiles_y * b * groups):
        c0 = blk % groups * CG
        t = blk // groups
        tx, t = t % tiles_x, t // tiles_x
        ty_t, bi = t % tiles_y, t // tiles_y
        y0 = ty_t // dil * TH * dil + ty_t % dil
        x0 = tx // dil * TW * dil + tx % dil

        g_s = torch.full((gr, g_row), float("nan"))
        shifts = [0] * gr
        if dil == 1:
            cs, ce = max(0, go - x0), min(gc, w - x0 + go)
            nrun = (ce - cs) * q
            for s in range(gr):
                y = y0 + s - go
                if not 0 <= y < h or nrun <= 0:
                    g_s[s] = 0
                    continue
                first = ((bi * h + y) * w + x0 - go + cs) * q
                shifts[s] = shift = (first + g_off - cs * q) % 8
                for m in range(g_row // 8):
                    lo = 8 * m - shift - cs * q
                    if lo >= 0 and lo + 8 <= nrun:   # one 16-byte copy
                        assert (g_off + first + lo) % 8 == 0
                        g_s[s, 8 * m:8 * m + 8] = mem[g_off + first + lo:g_off + first + lo + 8]
                    else:
                        k = torch.arange(8)
                        ok = (lo + k >= 0) & (lo + k < nrun)
                        vals = torch.zeros(8)
                        vals[ok] = gflat[first + lo + k[ok]]
                        g_s[s, 8 * m:8 * m + 8] = vals
        else:
            g_s[:] = 0
            for s in range(gr):
                for col in range(gc):
                    y, x = y0 + (s - go) * dil, x0 + (col - go) * dil
                    if 0 <= y < h and 0 <= x < w:
                        g_s[s, col * q:(col + 1) * q] = g[bi, y, x]
        assert not torch.isnan(g_s).any(), "a staged g value was never written"
        e = torch.arange(rows * KC * CCH)
        p, cc = e // CCH, c0 + (e % CCH) * 8
        s, j = p // KC, p % KC
        y, x = y0 + (s - n) * dil, x0 + (j - n) * dil
        inside = (j < cols) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
        chunk = framep[bi, y.clamp(0, h - 1), x.clamp(0, w - 1)]
        chunk = chunk.gather(1, (cc.view(-1, 1) + torch.arange(8)).clamp(max=c + CG - 1))
        f_s = torch.full((rows * KC * CCH, 8), float("nan"))
        f_s[swz(e)] = chunk * inside.view(-1, 1)
        for ty in range(TH):
            y = y0 + ty * dil
            if y >= h:
                continue
            acc = torch.zeros(NT8, 32, 4)
            jb, cb = (LANE & 7) + ((LANE >> 3) & 1) * 8, LANE >> 4
            for u in range(win):
                iy = win - 1 - u if fwd else u
                row = ty + u if dframe else ty
                grow = g_s[row, shifts[row]:]
                for ks in range(KS):
                    i, _, j_band = a_rows_cols(ks)
                    v = j_band - i
                    band = (v >= 0) & (v < win)
                    ix = win - 1 - v if fwd else v
                    idx = (j_band if dframe else i) * q + ix * win + iy
                    a = torch.where(band, grow[idx.clamp(0, gc * q - 1)], torch.zeros(()))
                    for pp in range(NT8 // 2):
                        rows_l = f_s[swz(((ty + u) * KC + ks * 16 + jb) * CCH + 2 * pp + cb)]
                        bfr = ldmatrix_x4_trans(rows_l)
                        acc[2 * pp] = mma(acc[2 * pp], a, bfr[:, 0], bfr[:, 1])
                        acc[2 * pp + 1] = mma(acc[2 * pp + 1], a, bfr[:, 2], bfr[:, 3])
            for half in range(2):
                xs = x0 + (GID + 8 * half) * dil
                for nt in range(NT8):
                    for k in range(2):
                        ch = c0 + nt * 8 + 2 * TIG + k
                        ok = (xs < w) & (ch < c)
                        out[bi, y, xs[ok], ch[ok]] = acc[nt][ok, 2 * half + k] * scale
    assert not torch.isnan(out).any(), "an output element was never written"
    return out


def plan_backward(g, ref, frame, win, dil, fwd, scale, g_off=0):
    """(d_ref, d_frame) as the bf16 kernels compute them: d_ref from (g,
    frame, fwd); d_frame from (g, ref, not fwd) with the haloed g tile."""
    return (plan_dref(g, frame, win, dil, fwd, scale, g_off),
            plan_dref(g, ref, win, dil, not fwd, scale, g_off, dframe=True))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def inputs(win, c):
    """(g, ref, frame) of one case at SHAPE, B = 2."""
    g = rand((2, *SHAPE, win * win), 10 + win + c)
    return g, rand((2, *SHAPE, c), 1 + c), rand((2, *SHAPE, c), 2 + c)


@pytest.fixture(scope="module")
def jax_grads():
    """(d_ref, d_frame) of JAX's `jax.vjp` of `cost_volume_pallas`
    (interpret mode) per case and C. All three channel counts go through
    one call per (win, dil, fwd): each zero-padded to 192 channels, which
    leaves their gradients as they are, behind one another in the batch."""
    cache = {}

    def get(win, dil, fwd, c):
        key = (win, dil, fwd)
        if key not in cache:
            parts = [inputs(win, cc) for cc in CHANNELS]
            pad = lambda x: np.pad(x, ((0, 0),) * 3 + ((0, 192 - x.shape[-1]),))   # noqa: E731
            g = jnp.asarray(np.concatenate([p[0] for p in parts]))
            ref = jnp.asarray(np.concatenate([pad(p[1]) for p in parts]))
            frame = jnp.asarray(np.concatenate([pad(p[2]) for p in parts]))
            _, vjp = jax.vjp(lambda r, f: cost_volume_pallas(r, f, win, dil, fwd), ref, frame)
            cache[key] = tuple(np.asarray(d) * SCALE for d in vjp(g))
        k = CHANNELS.index(c)
        return tuple(d[2 * k:2 * k + 2, ..., :c] for d in cache[key])
    return get


@pytest.mark.parametrize("win,dil,fwd", CASES)
def test_shift_identity(jax_grads, win, dil, fwd):
    """d_frame = dref_form(g', ref, not fwd): against the twin's own
    d_frame and JAX's."""
    g, ref, frame = map(torch.from_numpy, inputs(win, 20))
    got = ops.dref_form(ops.cost_volume_gshift_reference(g, win, dil, fwd), ref, win, dil,
                        not fwd, SCALE)
    twin_ref, twin_frame = ops.cost_volume_backward_reference(g, ref, frame, win, dil, fwd, SCALE)
    torch.testing.assert_close(got, twin_frame, **TOL)
    want_ref, want_frame = jax_grads(win, dil, fwd, 20)
    np.testing.assert_allclose(got.numpy(), want_frame, **TOL)
    np.testing.assert_allclose(twin_ref.numpy(), want_ref, **TOL)


# the plan at C = 20 (one group, a zero tail) for every case; at 32 and 192
# (one and six groups) for the main path's win 9, dil 1 both ways and two
# dilations
PLAN_CASES = [case + (20,) for case in CASES] + [
    (9, 1, True, 32), (9, 1, False, 32), (9, 1, True, 192), (9, 1, False, 192),
    (5, 2, False, 192), (7, 3, True, 32)]


@pytest.mark.parametrize("win,dil,fwd,c", PLAN_CASES)
def test_plan_matches_twin_and_jax(jax_grads, win, dil, fwd, c):
    g, ref, frame = map(torch.from_numpy, inputs(win, c))
    d_ref, d_frame = plan_backward(g, ref, frame, win, dil, fwd, SCALE)
    twin = ops.cost_volume_backward_reference(g, ref, frame, win, dil, fwd, SCALE)
    torch.testing.assert_close(d_ref, twin[0], **TOL)
    torch.testing.assert_close(d_frame, twin[1], **TOL)
    want_ref, want_frame = jax_grads(win, dil, fwd, c)
    np.testing.assert_allclose(d_ref.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(d_frame.numpy(), want_frame, **TOL)


# misaligned g (every shift of a staged row), the main path's levels 6
# and 7 (10x20, 5x10 at B=8 cut to B=1), a dilation past TH, a 1x1 image,
# an image narrower than a tile's halo
MORE_CASES = {
    "l7_c192_off3": dict(shape=(1, 5, 10, 192), win=9, dil=1, fwd=True, g_off=3),
    "l6_c128_off7": dict(shape=(1, 10, 20, 128), win=9, dil=1, fwd=False, g_off=7),
    "dil9_win3": dict(shape=(1, 11, 23, 16), win=3, dil=9, fwd=True, g_off=0),
    "dil5_win5_off2": dict(shape=(1, 13, 21, 8), win=5, dil=5, fwd=False, g_off=2),
    "1x1": dict(shape=(1, 1, 1, 3), win=3, dil=1, fwd=False, g_off=4),
    "h19_w70": dict(shape=(1, 19, 70, 8), win=9, dil=1, fwd=True, g_off=6),
    "w5_off1": dict(shape=(2, 4, 5, 8), win=9, dil=1, fwd=False, g_off=1),
}


@pytest.mark.parametrize("case", sorted(MORE_CASES))
def test_plan_more_shapes(case):
    kw = MORE_CASES[case]
    shape, win = kw["shape"], kw["win"]
    g = torch.from_numpy(rand(shape[:3] + (win * win,), 5))
    ref, frame = torch.from_numpy(rand(shape, 6)), torch.from_numpy(rand(shape, 7))
    args = (win, kw["dil"], kw["fwd"])
    got = plan_backward(g, ref, frame, *args, SCALE, kw["g_off"])
    want = ops.cost_volume_backward_reference(g, ref, frame, *args, SCALE)
    torch.testing.assert_close(got[0], want[0], **TOL)
    torch.testing.assert_close(got[1], want[1], **TOL)
