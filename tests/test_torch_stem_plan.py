"""The tile plan of K5's tensor-core kernel (csrc/stem_unit_a_mma.cu),
modelled lane by lane in plain torch and held against the stem's twin
(`ops.unit_reference`) and the JAX package's `stem_pallas._stem_xla`.

The kernel cannot be compiled or run on the CPU; this model repeats its
index arithmetic step by step with the same constants, so a fault in the
plan shows here:
- staging: per thread one octet of 8 input pixels of a region row, read
  from the 8-pixel-aligned column 2*ox0 - 8 into a raw copy of the region
  (three 16-byte copies when W % 8 == 0 and the tensor is 16-byte
  aligned, else element by element); then per thread whole 16-byte
  chunks of the region, 2 pixels padded to 4 channels (channel 3 zero)
  and shifted SHIFT pixels, from 4 aligned words of the raw row, region
  rows RCH 16-byte chunks apart;
- conv 1: per m16 tile of mid pixels and per ky one `ldmatrix.x4` of the
  region (the 4 padded pixels 2mx .. 2mx+3 of a row, k = 4 kx + c) and
  two `mma.m16n8k16`, B fragments built from the HWIO weights with zero
  taps at kx = 3 and c = 3, fragments distributed as PTX lays them out;
- conv 2: 9 taps of A by `ldmatrix.x4` from the swizzled mid tile;
- the epilogues through the swizzled mid and output tiles, and 16-byte
  output stores with ragged edges masked.
Every `ldmatrix` phase and epilogue store is also checked to hit distinct
shared-memory banks, as the kernel's layout promises.
Sums are f32 and the mid map is not rounded (the model runs in f32):
tolerance 1e-5 against the twin and against JAX (the sums' order).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from back2future_tpu.ops import stem_pallas
from back2future_tpu_torch import ops
from back2future_tpu_torch.models import ConvUnit, to_flax_params

torch.set_num_threads(1)

SOURCE = Path(__file__).resolve().parent.parent / "back2future_tpu_torch/csrc/stem_unit_a_mma.cu"
CIN, CP, CMID, COUT = 3, 4, 16, 16   # the kernel's constants
TH, TW, RCH, SHIFT, KSTEPS1, KSTEPS2, RAW_ROW = 8, 32, 37, 5, 3, 9, 560
CONSTANTS = dict(CIN=CIN, CP=CP, CMID=CMID, COUT=COUT, TH=TH, TW=TW, RCH=RCH, SHIFT=SHIFT,
                 KSTEPS1=KSTEPS1, KSTEPS2=KSTEPS2, RAW_ROW=RAW_ROW)
WARPS, NT = TH, 32 * TH
MH, MW = TH + 2, TW + 2
MPIX = MH * MW
MTILES1 = (MPIX + 15) // 16
IH, IW = 2 * MH + 1, 2 * MW + 2
OCTETS = (IW + SHIFT + 7) // 8
TOL = dict(rtol=1e-5, atol=1e-5)

LANE = torch.arange(32)
GROUP, TIG = LANE // 4, LANE % 4   # PTX's groupID and threadID_in_group


def align128(n):
    return (n + 127) // 128 * 128


IN_BYTES = align128(IH * RCH * 16)
MID_BYTES = align128(MPIX * CMID * 2)
OUT_BYTES = TH * TW * COUT * 2
PITCH = IW // 2 + 1   # chunks built per region row
RAW_BYTES = align128(IH * RAW_ROW)


def swz(chunk):
    return chunk ^ ((chunk >> 3) & 1)


def distinct_banks(byte_addrs, width):
    """Lanes accessing `width` bytes each at `byte_addrs` (one phase):
    distinct words must lie in distinct banks (32 banks of 4 bytes)."""
    words = {a // 4 + k for a in byte_addrs for k in range(width // 4)}
    assert len({w % 32 for w in words}) == len(words), f"bank conflict at {sorted(byte_addrs)}"


def ldmatrix_x4(smem, byte_addrs):
    """ldmatrix.x4 of the bf16 array `smem` (one element per 2 bytes):
    matrix m takes its 8 rows from lanes 8m .. 8m+7; lane t receives row
    t/4, elements 2*(t%4) + {0, 1} of each matrix -> (4, 32, 2)."""
    assert all(a % 16 == 0 for a in byte_addrs)
    for m in range(4):
        distinct_banks(set(byte_addrs[8 * m:8 * m + 8]), 16)
    rows = torch.stack([smem[a // 2:a // 2 + 8] for a in byte_addrs]).view(4, 8, 8)
    return rows[:, GROUP[:, None], 2 * TIG[:, None] + torch.arange(2)[None, :]]


def mma(d, a, b):
    """mma.m16n8k16.row.col: d (32, 4) += A (16 x 16) B (16 x 8), from the
    lanes' fragments a (4, 32, 2) and b (2, 32, 2), as PTX lays them out."""
    A, B = torch.zeros(16, 16), torch.zeros(16, 8)
    e = torch.arange(2)
    for i in range(4):
        A[(GROUP + 8 * (i % 2))[:, None], (2 * TIG + 8 * (i // 2))[:, None] + e] = a[i]
    for i in range(2):
        B[(2 * TIG + 8 * i)[:, None] + e, GROUP[:, None]] = b[i]
    D = A @ B
    out = d.clone()
    for h in range(2):
        out[:, 2 * h:2 * h + 2] += D[(GROUP + 8 * h)[:, None], 2 * TIG[:, None] + e]
    return out


def weight_fragments(w1, w2):
    """`Weights::load`: w1f[ky][nt] and w2f[tap][nt], each (2, 32, 2):
    register r of lane t holds B[k][n], n = nt*8 + t/4, k = 2*(t%4) + 8r +
    {0, 1}; conv 1's k = 4 kx + c, zero at kx = 3 or c = 3."""
    w1f = [[torch.zeros(2, 32, 2) for _ in range(2)] for _ in range(KSTEPS1)]
    w2f = [[torch.zeros(2, 32, 2) for _ in range(2)] for _ in range(KSTEPS2)]
    for t in range(32):
        n0, k0 = t // 4, 2 * (t % 4)
        for nt in range(2):
            n = nt * 8 + n0
            for r in range(2):
                for e in range(2):
                    k = k0 + 8 * r + e
                    kx, c = k // CP, k % CP
                    for ky in range(KSTEPS1):
                        w1f[ky][nt][r, t, e] = w1[ky, kx, c, n] if kx < 3 and c < CIN else 0.0
                    for tap in range(KSTEPS2):
                        w2f[tap][nt][r, t, e] = w2[tap // 3, tap % 3, k, n]
    return w1f, w2f


def init_acc(bias):
    """The bias in the accumulator layout: lane t's columns 2*(t%4) + {0, 1}."""
    acc = []
    for nt in range(2):
        cols = bias[nt * 8 + 2 * TIG[:, None] + torch.arange(2)[None, :]]
        acc.append(torch.cat([cols, cols], 1))
    return acc


def leaky(v):
    return torch.where(v >= 0, v, 0.2 * v)


def stage_input(flat_x, x_off, n, iy0, gxa, h, w):
    """`load_octet` + `store_region` of every thread: the region as a bf16
    array of IN_BYTES / 2 elements (NaN where never written)."""
    vec = w % 8 == 0 and x_off % 8 == 0   # 16-byte aligned: x_off in elements of 2 bytes
    in_s = torch.full((IN_BYTES // 2,), float("nan"))
    raw = torch.full((RAW_BYTES // 2,), float("nan"))
    for task in range(min(NT, IH * OCTETS)):
        r, o = divmod(task, OCTETS)
        gy, gx = iy0 + r, gxa + 8 * o
        vals = torch.zeros(24)
        if 0 <= gy < h:
            pix = (n * h + gy) * w + gx
            if vec and gx >= 0 and gx + 8 <= w:
                assert ((x_off + pix * CIN) * 2) % 16 == 0, "a 16-byte load off its boundary"
                vals = flat_x[x_off + pix * CIN:x_off + pix * CIN + 24].clone()
            else:
                for e in range(24):
                    if 0 <= gx + e // CIN < w:
                        vals[e] = flat_x[x_off + (pix + e // CIN) * CIN + e % CIN]
        slot = (r * RAW_ROW + 48 * o) // 2   # the octet's place in the raw region
        raw[slot:slot + 24] = vals
    for c0 in range(0, IH * PITCH, NT):   # `store_region`, one chunk per thread
        cs = range(c0, min(c0 + NT, IH * PITCH))
        words = [(c // PITCH) * (RAW_ROW // 4) + 3 * (c % PITCH) + 7 for c in cs]
        for q in range(4):   # the 4 word loads, each one phase of the warps
            for lo in range(0, len(words), 32):
                distinct_banks([4 * (wd + q) for wd in words[lo:lo + 32]], 4)
        for c, wd in zip(cs, words):
            r, k = divmod(c, PITCH)
            got = raw[2 * wd:2 * wd + 8]   # elements of words wd .. wd + 3
            assert not torch.isnan(got).any(), "a raw word read before it was written"
            # (w0 >> 16) | (w1 << 16), w1 >> 16, w2, w3 & 0xffff
            base = (r * RCH * 16 + 16 * k) // 2
            in_s[base:base + 8] = torch.stack([got[1], got[2], got[3], torch.tensor(0.0),
                                               got[4], got[5], got[6], torch.tensor(0.0)])
    return in_s


def conv1(in_s, w1f, b1, oy0, ox0, ho, wo):
    """Conv 1 of every warp into the swizzled mid tile (NaN where unwritten)."""
    mid = torch.full((MID_BYTES // 2,), float("nan"))
    for warp in range(WARPS):
        for tile in range(warp, MTILES1, WARPS):
            p = torch.clamp(tile * 16 + LANE % 16, max=MPIX - 1)
            my, mx = p // MW, p % MW
            q0 = 2 * my * RCH + mx + LANE // 16
            acc = init_acc(b1)
            for ky in range(KSTEPS1):
                a = ldmatrix_x4(in_s, (16 * (q0 + ky * RCH)).tolist())
                assert not torch.isnan(a).any(), "conv 1 read an unwritten region pixel"
                acc = [mma(acc[nt], a, w1f[ky][nt]) for nt in range(2)]
            for h in range(2):
                p = tile * 16 + GROUP + 8 * h
                for nt in range(2):
                    addrs = 16 * swz(p * 2 + nt) + 4 * TIG
                    distinct_banks(addrs[p < MPIX].tolist(), 4)
                    for t in range(32):
                        pt = int(p[t])
                        if pt >= MPIX:
                            continue
                        gy, gx = oy0 - 1 + pt // MW, ox0 - 1 + pt % MW
                        inside = 0 <= gy < ho and 0 <= gx < wo
                        v = leaky(acc[nt][t, 2 * h:2 * h + 2]) if inside else torch.zeros(2)
                        mid[int(addrs[t]) // 2:int(addrs[t]) // 2 + 2] = v
    return mid


def conv2_and_output(mid, w2f, b2):
    """Conv 2 of every warp, leaky, into the swizzled output tile."""
    out_s = torch.full((OUT_BYTES // 2,), float("nan"))
    for warp in range(WARPS):
        q0 = warp * MW + LANE % 16
        acc = [init_acc(b2), init_acc(b2)]
        for tap in range(KSTEPS2):
            q = q0 + (tap // 3) * MW + tap % 3
            for i in range(2):
                a = ldmatrix_x4(mid, (16 * swz((q + 16 * i) * 2 + LANE // 16)).tolist())
                assert not torch.isnan(a).any(), "conv 2 read an unwritten mid pixel"
                acc[i] = [mma(acc[i][nt], a, w2f[tap][nt]) for nt in range(2)]
        for i in range(2):
            for h in range(2):
                p = warp * TW + 16 * i + GROUP + 8 * h
                for nt in range(2):
                    addrs = 16 * swz(p * 2 + nt) + 4 * TIG
                    distinct_banks(addrs.tolist(), 4)
                    for t in range(32):
                        out_s[int(addrs[t]) // 2:int(addrs[t]) // 2 + 2] = \
                            leaky(acc[i][nt][t, 2 * h:2 * h + 2])
    return out_s


def plan_unit_a(x, p, x_off=0):
    """K5's bf16 kernel, step by step, in f32: (N, ceil(H/2), ceil(W/2), 16)
    from (N, H, W, 3) and the OIHW parameters; `x_off` elements before the
    input in its buffer (its misalignment)."""
    n_img, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    flat_x = torch.cat([torch.full((x_off,), float("nan")), x.reshape(-1)])
    w1, b1, w2, b2 = p
    w1, w2 = (k.permute(2, 3, 1, 0) for k in (w1, w2))   # OIHW -> HWIO
    w1f, w2f = weight_fragments(w1, w2)
    out = torch.full((n_img * ho * wo * COUT,), float("nan"))
    for n in range(n_img):
        for oy0 in range(0, ho, TH):
            for ox0 in range(0, wo, TW):
                in_s = stage_input(flat_x, x_off, n, 2 * oy0 - 3, 2 * ox0 - 8, h, w)
                mid = conv1(in_s, w1f, b1, oy0, ox0, ho, wo)
                out_s = conv2_and_output(mid, w2f, b2)
                for k in range(TH * TW * 2 // NT):   # `store_output`
                    e = k * NT + torch.arange(NT)
                    distinct_banks((16 * swz(e[:8])).tolist(), 16)
                    for ee in e.tolist():
                        px = ee >> 1
                        oy, ox = oy0 + px // TW, ox0 + px % TW
                        if oy < ho and ox < wo:
                            dst = ((n * ho + oy) * wo + ox) * COUT + (ee & 1) * 8
                            src = 16 * swz(ee) // 2
                            out[dst:dst + 8] = out_s[src:src + 8]
    out = out.view(n_img, ho, wo, COUT)
    assert not torch.isnan(out).any(), "an output element was never written"
    return out


def test_plan_constants_are_the_kernels():
    src = SOURCE.read_text()
    for name, value in CONSTANTS.items():
        assert re.search(rf"constexpr int [^;]*\b{name} = {value}[,;]", src), name


def test_swizzle_spreads_any_eight_rows_two_chunks_apart():
    for start in range(64):
        distinct_banks([16 * swz(start + 2 * k) for k in range(8)], 16)


def units():
    gen = torch.Generator().manual_seed(5)
    return ConvUnit(3, 16, generator=gen), ConvUnit(16, 32, generator=gen)


# (N, H, W, x_off): Wo % 32 of 1 and 31, Ho % 8 not 0, odd H and W, W % 8
# of 0 and of 1 to 7 (the 16-byte loads and the element-by-element path),
# a misaligned tensor, a single pixel
PLAN_CASES = {
    "ho9_wo33_w65": (1, 17, 65, 0),
    "ho5_wo31_w62": (1, 10, 62, 0),
    "ho4_wo32_w64": (2, 8, 64, 0),
    "ho3_wo36_w72": (1, 5, 72, 0),
    "w67_w3": (1, 6, 67, 0),
    "w69_w5": (1, 3, 69, 0),
    "w71_w7": (1, 4, 71, 0),
    "w66_w2": (1, 3, 66, 0),
    "w68_w4": (1, 2, 68, 0),
    "w64_off3": (1, 7, 64, 3),
    "1x1": (1, 1, 1, 0),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_twin_and_jax(case):
    n, h, w, x_off = PLAN_CASES[case]
    unit2, unit3 = units()
    p = tuple(t.detach() for t in ops.unit_params(unit2))
    x = torch.from_numpy(
        np.random.default_rng(h * 100 + w).standard_normal((n, h, w, 3)).astype(np.float32))
    got = plan_unit_a(x, p, x_off)
    torch.testing.assert_close(got, ops.unit_reference(x, p), **TOL)
    p2, p3 = (jax.tree_util.tree_map(jnp.asarray, to_flax_params(u)) for u in (unit2, unit3))
    want, _ = stem_pallas._stem_xla(jnp.asarray(x.numpy()), p2, p3, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
