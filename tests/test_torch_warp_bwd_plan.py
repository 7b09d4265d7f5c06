"""The plan of the warp's backward kernels (csrc/warp_bwd_tiled.cu),
modelled block by block in plain torch and held against the backward twin
(`ops.warp_bilinear_backward_reference`) and the JAX package's `jax.vjp`
of `warp_bilinear` with `B2F_DIMG_PALLAS=1` (the Pallas `d_images_pallas`
in interpret mode).

The kernels cannot be compiled or run on the CPU; this model repeats
their index arithmetic with the same constants, so a fault in the plan
shows here. K4, the image gradient:
- a block owns a TH x TW tile of output pixels (one thread each for its
  corners) and a slice of at most CS channels in QS 4-channel quads;
  thread t takes quad t % QS of the pixels t / QS + PIX * k, and of the
  window pixels t / QS + PIX * k, whose row and column it steps without
  a division;
- the launch allows the window route where its grid holds 1.5 blocks an
  SM or more; then a block takes it when the bounding box of all its
  pixels' corners holds at most WINDOW_PIX pixels, else the direct route;
- window route: each pixel's (up to) 4 adds counted per window pixel
  (their place among its adds from the count's integer atomic), an
  exclusive scan of the counts (2 window pixels a thread, a shuffle scan
  per warp, the warps' totals), each add placed at start + place, and
  each (window pixel, quad) summing its adds and flushing the sum, none
  where no add lands or the sum is all 0;
- direct route: each (pixel, quad) adding its 4 corners straight into the
  image gradient.
K4 at C = 3, its own pixel kernel:
- a block owns a TH3 x TW3 tile, thread t pixel (t / TW3, t % TW3); its g
  read as a pair and an element (the pair first where the pixel's first
  element is pair-aligned, else last), its flow as a pair;
- the launch allows the window route where its grid holds half a block
  an SM or more; then a block whose box holds at most WINDOW3 pixels sums
  every add that is not 0 into a channel-major f32 window (shared
  atomics); else each pixel adds its 4 corners directly;
- the direct route's adds of a pixel's 3 values, none where all are 0,
  into the f32 accumulator of 3 channels a pixel: an 8-byte-aligned pair
  and an element; the window's flush: each window row a run of pixels,
  each group of 4 pixels that a run touches as 3 16-byte-aligned
  reductions (none for 4 floats that are all 0), pixel by pixel where
  the group reaches past the accumulator's end; then one pass that
  casts;
- the row window: a flow and g of rows y0 .. y0 + h - 1 of images of
  H_src rows.
W-dflow, the flow gradient:
- C = 3: one thread per pixel; a block's g staged as 3 * NT_FLOW
  contiguous elements; each corner pair (tl, tr) or (bl, br) read as one
  6-element span where the +1 column is inside the image, 3 elements
  (and 0 for the +1 corner) where it is not; no bottom row where the +1
  row is outside;
- any other C: G lanes a pixel (8 where the channels hold 8 packs of VEC,
  else 4), lane l summing packs l, l + G, ... of the four dot products,
  then an xor-shuffle tree over the group; with packs of 16 bytes (VEC 4
  in f32) or single elements (VEC 1, unaligned tensors).
Every sum is f32 in another order than the twin's and JAX's: tolerance
1e-5, relative to the largest value (far past the border, one corner
pixel collects every pixel's gradient, hundreds of terms).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from back2future_tpu.ops.warp import warp_bilinear as jax_warp_bilinear
from back2future_tpu_torch import ops
from back2future_tpu_torch.ops.warp import _corners

torch.set_num_threads(1)

SOURCE = Path(__file__).resolve().parent.parent / "back2future_tpu_torch/csrc/warp_bwd_tiled.cu"
TH, TW, CS, NT = 16, 16, 32, 256   # the kernel's constants
CONSTANTS = dict(TH=TH, TW=TW, CS=CS, NT=NT)
TP = TH * TW
QS = CS // 4          # lanes per pixel, one per 4-channel quad
PIX = NT // QS        # pixels a block's threads take at once
WINDOW_PIX = 2 * TP


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))

NT_FLOW = 128        # W-dflow's threads per block
CONSTANTS.update(NT_FLOW=NT_FLOW)
TH3, TW3 = 8, 32     # K4's C = 3 tile, a thread a pixel
NT3 = TH3 * TW3
WINDOW3 = 2 * NT3
CONSTANTS.update(TH3=TH3, TW3=TW3)

# 28 x 80 leaves partial tiles and holds more than WINDOW_PIX pixels, so
# that flows can spread past the window
B, H, W = 2, 28, 80
CHANNELS = (3, 20, 32, 64)
FLOWS = ("zero", "smooth", "random", "outliers", "far")


def make_flow(kind: str, seed: int) -> np.ndarray:
    """zero; smooth: a 2x bilinear upsample of a coarse random field (1
    pixel std at half size); random: i.i.d. at scale W/2; outliers: the
    smooth flow with 4 pixels per image sent 1-2 widths away; far: the
    smooth flow moved 2 widths right and 2 heights up, past the border."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.standard_normal((B, 2, H // 2, W // 2)).astype(np.float32))
    smooth = F.interpolate(coarse, scale_factor=2, mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    if kind == "zero":
        return np.zeros((B, H, W, 2), np.float32)
    if kind == "smooth":
        return smooth
    if kind == "random":
        return rng.standard_normal((B, H, W, 2)).astype(np.float32) * (W / 2)
    if kind == "outliers":
        out = smooth.copy()
        for b in range(B):
            ys, xs = rng.integers(0, H, 4), rng.integers(0, W, 4)
            out[b, ys, xs] = rng.uniform(W, 2 * W, (4, 2)) * rng.choice([-1, 1], (4, 2))
        return out.astype(np.float32)
    assert kind == "far"
    return (smooth + np.array([2 * W, -2 * H], np.float32)).astype(np.float32)


def inputs(c: int, kind: str):
    seed = 100 * c + FLOWS.index(kind)
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, H, W, c)).astype(np.float32)
    g = rng.standard_normal((B, H, W, c)).astype(np.float32)
    return img, make_flow(kind, seed), g


def exclusive_scan(counts: torch.Tensor) -> torch.Tensor:
    """The kernel's scan of a window's counts: window pixels 2t, 2t+1 for
    thread t, an inclusive shuffle scan of the threads' sums in each warp
    of 32, then the totals of the warps before; returns the WINDOW_PIX + 1
    starts (the last one the total), as the kernel leaves them."""
    cnt = torch.zeros(WINDOW_PIX, dtype=torch.long)
    cnt[:counts.numel()] = counts
    sums = cnt.view(NT, 2).sum(1)
    incl = sums.clone().view(NT // 32, 32)
    o = 1
    while o < 32:   # __shfl_up_sync: lanes >= o add the value o lanes down
        shifted = torch.zeros_like(incl)
        shifted[:, o:] = incl[:, :-o]
        incl = incl + shifted
        o *= 2
    warp_totals = incl[:, -1]
    before = torch.cumsum(warp_totals, 0) - warp_totals
    run = (before[:, None] + incl - sums.view(NT // 32, 32)).reshape(NT)
    starts = (run[:, None] + torch.cumsum(cnt.view(NT, 2), 1) - cnt.view(NT, 2)).reshape(-1)
    return torch.cat([starts, warp_totals.sum().view(1)])[:WINDOW_PIX + 1]


def k4_blocks(b: int, h: int, w: int, c: int) -> int:
    """K4's grid: tiles across W and H, slices, images."""
    return b * -(-h // TH) * -(-w // TW) * -(-c // CS)


def k4_window_allowed(blocks: int, sms: int) -> bool:
    """The launch's rule: the window route where the grid holds 1.5
    blocks an SM or more."""
    return 2 * blocks >= 3 * sms


def k4_model(flow: torch.Tensor, g: torch.Tensor, sms: int = 1):
    """K4's plan, block by block, on a card of `sms` SMs: (the f32 image
    gradient, the route of each block as (slice channels, "window" or
    "direct"))."""
    b, h, w, c = g.shape
    window = k4_window_allowed(k4_blocks(b, h, w, c), sms)
    (x0, y0, x1, y1), (wx, wy), (x1_in, y1_in), _ = _corners(flow, h, w)
    d_img = torch.zeros(b * h * w, c)
    routes = []
    for bi in range(b):
        for ty0 in range(0, h, TH):
            for tx0 in range(0, w, TW):
                tile = (bi, slice(ty0, ty0 + TH), slice(tx0, tx0 + TW))
                cx0, cy0, cx1, cy1 = (v[tile].reshape(-1) for v in (x0, y0, x1, y1))
                twx, twy = wx[tile].reshape(-1), wy[tile].reshape(-1)
                tx1_in, ty1_in = x1_in[tile].reshape(-1), y1_in[tile].reshape(-1)
                n = cx0.numel()
                # the adds: pixel, corner j (bit 0: +1 column, bit 1: +1 row)
                inside = torch.stack([torch.ones_like(tx1_in), tx1_in, ty1_in,
                                      tx1_in & ty1_in], 1).reshape(-1)
                ys = torch.stack([cy0, cy0, cy1, cy1], 1).reshape(-1)
                xs = torch.stack([cx0, cx1, cx0, cx1], 1).reshape(-1)
                weight = torch.stack([twx * twy, (1 - twx) * twy, twx * (1 - twy),
                                      (1 - twx) * (1 - twy)], 1).reshape(-1)
                pix = torch.arange(n).repeat_interleave(4)
                ylo, yhi, xlo, xhi = cy0.min(), cy1.max(), cx0.min(), cx1.max()
                ww = int(xhi - xlo + 1)
                wpix = int(yhi - ylo + 1) * ww
                for c0 in range(0, c, CS):
                    cs = min(CS, c - c0)
                    gt = g[tile + (slice(c0, c0 + cs),)].reshape(n, cs)
                    if not window or wpix > WINDOW_PIX:
                        routes.append((cs, "direct"))
                        gidx = (bi * h + ys) * w + xs
                        d_img[:, c0:c0 + cs].index_add_(
                            0, gidx[inside], (weight[:, None] * gt[pix])[inside])
                        continue
                    routes.append((cs, "window"))
                    at = ((ys - ylo) * ww + xs - xlo)[inside]
                    assert 0 <= at.min() and at.max() < wpix
                    counts = torch.bincount(at, minlength=wpix)
                    start = exclusive_scan(counts)
                    assert torch.equal(start[:wpix + 1],
                                       torch.cat([torch.zeros(1, dtype=torch.long),
                                                  torch.cumsum(counts, 0)]))
                    # each add's place among its window pixel's (the order of
                    # the count's atomics: any order is a place)
                    order = torch.argsort(at, stable=True)
                    place = torch.empty_like(at)
                    place[order] = torch.arange(at.numel()) - start[at[order]]
                    slots = start[at] + place
                    assert torch.equal(torch.sort(slots).values, torch.arange(at.numel()))
                    listed = torch.empty_like(at)
                    listed[slots] = torch.arange(at.numel())
                    # each (window pixel, quad) sums its adds, then one flush
                    contrib = (weight[inside][:, None] * gt[pix[inside]])[listed]
                    owner = at[listed]
                    sums = torch.zeros(wpix, cs).index_add_(0, owner, contrib)
                    nq = -(-cs // 4)
                    padded = torch.zeros(wpix, 4 * nq)
                    padded[:, :cs] = sums
                    quads = padded.view(wpix, nq, 4)
                    live = (counts > 0)[:, None] & (quads != 0).any(-1)
                    wp, q = live.nonzero(as_tuple=True)
                    gidx = (bi * h + ylo + wp // ww) * w + xlo + wp % ww
                    for v in range(4):
                        ch = 4 * q + v
                        keep = ch < cs
                        d_img[gidx[keep], c0 + ch[keep]] += quads[wp, q, v][keep]
    return d_img.view(b, h, w, c), routes


def dflow_model(img: torch.Tensor, flow: torch.Tensor, g: torch.Tensor, vec: int,
                reference_grads: bool = True) -> torch.Tensor:
    """W-dflow's plan in f32 (`vec`: elements a pack, 4 or 1): the flow
    gradient (B, H, W, 2)."""
    b, h, w, c = img.shape
    (x0, y0, x1, y1), (wx, wy), (x1_in, y1_in), (x_cl, y_cl) = _corners(flow, h, w)
    flat_img, flat_g = img.reshape(-1), g.reshape(-1, c)
    row = ((torch.arange(b).view(b, 1, 1) * h + y0) * w + x0).reshape(-1)
    x1_in, y1_in = x1_in.reshape(-1), y1_in.reshape(-1)
    npix = row.numel()
    if c == 3:
        # g staged per block: 3 * n contiguous elements, thread t's at 3t
        staged = torch.cat([flat_g.reshape(-1)[3 * p0:3 * min(p0 + NT_FLOW, npix)]
                            for p0 in range(0, npix, NT_FLOW)]).view(-1, 3)
        assert torch.equal(staged, flat_g)
        span = torch.arange(6)
        top = flat_img[(3 * row)[:, None] + torch.where(x1_in[:, None], span, span % 3)]
        top[:, 3:] *= x1_in[:, None]
        bot_row = torch.where(y1_in, row + w, row)
        bot = flat_img[(3 * bot_row)[:, None] + torch.where(x1_in[:, None], span, span % 3)]
        bot[:, 3:] *= x1_in[:, None]
        bot *= y1_in[:, None]
        tl, tr = (top[:, :3] * staged).sum(1), (top[:, 3:] * staged).sum(1)
        bl, br = (bot[:, :3] * staged).sum(1), (bot[:, 3:] * staged).sum(1)
    else:
        group = 8 if c // vec >= 8 and vec > 1 else 4
        x1 = torch.where(x1_in, 1, 0)
        y1 = torch.where(y1_in, w, 0)
        corners = [row, row + x1, row + y1, row + y1 + x1]
        lanes = torch.zeros(group, 4, npix)   # lane, corner, pixel
        for lane in range(group):
            for c0 in range(lane * vec, c, group * vec):
                ch = slice(c0, c0 + vec)
                for j, at in enumerate(corners):
                    lanes[lane, j] += (img.reshape(-1, c)[at, ch] * flat_g[:, ch]).sum(1)
        o = group // 2
        while o:   # __shfl_xor_sync: every lane adds lane ^ o's value
            lanes = lanes + lanes[torch.arange(group) ^ o]
            o //= 2
        assert torch.allclose(lanes, lanes[:1].expand_as(lanes))
        tl, tr, bl, br = lanes[0]
        tr, br = tr * x1_in, br * x1_in
        bl, br = bl * y1_in, br * y1_in
    wx, wy = wx.reshape(-1), wy.reshape(-1)
    dfx = -wy * tl + wy * tr - (1 - wy) * bl + (1 - wy) * br
    dfy = -wx * tl + wx * bl - (1 - wx) * tr + (1 - wx) * br
    if not reference_grads:
        dfx = torch.where(x_cl.reshape(-1), 0.0, dfx)
        dfy = torch.where(y_cl.reshape(-1), 0.0, dfy)
    return torch.stack([dfx, dfy], -1).view(b, h, w, 2)


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp of the JAX package's warp with the Pallas image gradient
    (interpret mode) for every channel count and flow: (d_img, d_flow)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("B2F_DIMG_PALLAS", "1")

        @jax.jit
        def vjp(img, flow, g):
            return jax.vjp(jax_warp_bilinear, img, flow)[1](g)

        for c in CHANNELS:
            for kind in FLOWS:
                img, flow, g = inputs(c, kind)
                out[(c, kind)] = tuple(map(np.asarray, vjp(*map(jnp.asarray, (img, flow, g)))))
    return out


def test_plan_constants_are_the_kernels():
    src = SOURCE.read_text()
    for name, value in CONSTANTS.items():
        assert re.search(rf"constexpr int [^;]*\b{name} = {value}[,;]", src), name
    for line in ("constexpr int QS = CS / 4;", "constexpr int PIX = NT / QS;",
                 "constexpr int WINDOW_PIX = 2 * TP;", "constexpr int NT3 = TH3 * TW3;",
                 "constexpr int WINDOW3 = 2 * NT3;"):
        assert line in src, line
    # the window rules of the quad tiles and of the C = 3 kernel
    for rule, line in (("window_pays", "return sms > 0 && 2 * blocks >= 3LL * sms;"),
                       ("pixels_window_pays", "return sms > 0 && 2 * blocks >= sms;")):
        body = re.search(rf"bool {rule}\(long long blocks\) \{{(.*?)\n\}}", src, re.S)
        assert body and line in body.group(1), rule


def test_k4_lanes_cover_the_tile_once():
    got = sorted((t // QS + PIX * k, t % QS) for t in range(NT) for k in range(TP // PIX))
    assert got == [(p, q) for p in range(TP) for q in range(QS)]


@pytest.mark.parametrize("ww", [1, 5, 17, 31, 32, 33, 64])
def test_k4_window_steps_rows_and_columns(ww):
    """The gather's window pixels t / QS + PIX * k, with their row and
    column advanced by PIX without a division, are the divmod of each."""
    wpix = ww * max(1, WINDOW_PIX // ww)
    for t in range(0, NT, QS):
        wp = t // QS
        r, col = wp // ww, wp % ww
        while wp < wpix:
            assert (r, col) == divmod(wp, ww)
            wp += PIX
            col += PIX
            while col >= ww:
                col -= ww
                r += 1


@pytest.mark.parametrize("wpix", [1, 37, 63, 64, 300, WINDOW_PIX])
def test_k4_scan_of_the_window_counts(wpix):
    counts = torch.from_numpy(np.random.default_rng(wpix).integers(0, 6, wpix))
    start = exclusive_scan(counts)
    want = torch.cat([torch.zeros(1, dtype=torch.long), torch.cumsum(counts, 0)])
    assert torch.equal(start[:wpix + 1], want)


@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("c", CHANNELS)
def test_k4_plan_matches_twin_and_jax(jax_grads, c, kind):
    img, flow, g = inputs(c, kind)
    got, routes = k4_model(torch.from_numpy(flow), torch.from_numpy(g))
    twin, _ = ops.warp_bilinear_backward_reference(*map(torch.from_numpy, (img, flow, g)))
    close(got.numpy(), twin.numpy())
    close(got.numpy(), jax_grads[(c, kind)][0])
    assert len(routes) == k4_blocks(B, H, W, c)
    # where each route is taken: smooth flows stay in the window, random
    # ones spread past it (their box is the image), and so do the blocks
    # with an outlier
    taken = {route for _, route in routes}
    want = {"zero": {"window"}, "smooth": {"window"}, "far": {"window"},
            "random": {"direct"}, "outliers": {"window", "direct"}}[kind]
    assert taken == want, routes


@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("c,vec", [(c, v) for c in CHANNELS for v in ((1,) if c == 3 else (4, 1))])
def test_dflow_plan_matches_twin_and_jax(jax_grads, c, vec, kind):
    """At C = 3 the rows kernel (vec unused); else lane groups with 16-byte
    packs (4 f32) or single elements."""
    img, flow, g = map(torch.from_numpy, inputs(c, kind))
    for reference_grads in (True, False):
        got = dflow_model(img, flow, g, vec, reference_grads)
        _, twin = ops.warp_bilinear_backward_reference(img, flow, g, reference_grads)
        close(got.numpy(), twin.numpy())
        if reference_grads:
            close(got.numpy(), jax_grads[(c, kind)][1])


@pytest.mark.parametrize("c", CHANNELS)
def test_k4_plan_by_grid(jax_grads, c):
    """On an H100's 132 SMs this grid (20-40 blocks) is too small for the
    window route: every block adds directly, and the result is the
    same."""
    img, flow, g = inputs(c, "smooth")
    got, routes = k4_model(torch.from_numpy(flow), torch.from_numpy(g), sms=132)
    assert {route for _, route in routes} == {"direct"}
    close(got.numpy(), jax_grads[(c, "smooth")][0])


def test_k4_window_allowed_at_the_train_levels():
    """The train step's feature warps (B=8, 320x640, levels 3-6) on an
    H100's 132 SMs: 400, 240, 144 and 64 blocks, the window route allowed
    at levels 3-4, where it was measured to be the faster, not at 5-6."""
    grids = [k4_blocks(8, 320 >> (lv - 1), 640 >> (lv - 1), c)
             for lv, c in zip(range(3, 7), (32, 64, 96, 128))]
    assert grids == [400, 240, 144, 64]
    assert [k4_window_allowed(n, 132) for n in grids] == [True, True, False, False]


# ------------------------------------------------------------ K4 at C = 3

def pixel3_loads(first: int):
    """load_pixel3's loads of a pixel whose first element is at element
    `first` of an aligned buffer: (element, count) each, the pair first
    where `first` is even."""
    return [(first, 2), (first + 2, 1)] if first % 2 == 0 else [(first, 1), (first + 1, 2)]


def pixel3_adds(q: int):
    """add_pixel3's reductions at pixel q of the 3-channel accumulator:
    (float index, count) each."""
    return [(3 * q, 2), (3 * q + 2, 1)] if q % 2 == 0 else [(3 * q, 1), (3 * q + 1, 2)]


def c3_blocks(b: int, h: int, w: int) -> int:
    return b * -(-h // TH3) * -(-w // TW3)


def c3_window_allowed(blocks: int, sms: int) -> bool:
    """The C = 3 launch's rule: the window route where the grid holds half
    a block an SM or more."""
    return 2 * blocks >= sms


def k4_c3_model(flow: torch.Tensor, g: torch.Tensor, h_src: int = -1, y0: int = 0,
                sms: int = 1, window=None):
    """K4's C = 3 kernel, block by block and thread by thread, on a card
    of `sms` SMs; `window` None as the launch allows it (by the grid),
    True wherever the box fits, False direct on every block: (the image
    gradient in g's dtype, the f32 accumulator, the route of each
    block)."""
    b, h, w, c = g.shape
    assert c == 3
    hs = h if h_src < 0 else h_src
    if window is None:
        window = c3_window_allowed(c3_blocks(b, h, w), sms)
    (x0, y0c, x1, y1), (wx, wy), (x1_in, y1_in), _ = _corners(flow, hs, w, y0)
    flat_g = g.reshape(-1)
    acc = torch.zeros(b * hs * w * 3)
    routes = []

    npix = b * hs * w

    def flush(q: int, v: torch.Tensor) -> None:
        if not bool((v != 0).any()):
            return
        for at, n in pixel3_adds(q):
            assert at % n == 0   # 8-byte aligned
            acc[at:at + n] += v[at - 3 * q:at - 3 * q + n]

    def flush_window(sums: torch.Tensor, src0: int, ylo: int, xlo: int, ww: int,
                     wpix: int) -> None:
        """flush_window3: thread t takes items t, t + NT3, ..."""
        covered = []
        per_row = (ww + 6) // 4
        for t in range(NT3):
            for item in range(t, wpix // ww * per_row, NT3):
                r = item // per_row
                q0 = src0 + (ylo + r) * w + xlo
                gq = (q0 // 4 + item - r * per_row) * 4
                if gq >= q0 + ww:
                    continue
                v = torch.zeros(12)
                for i in range(4):
                    if 0 <= gq + i - q0 < ww:
                        v[3 * i:3 * i + 3] = sums[r * ww + gq + i - q0]
                        covered.append(r * ww + gq + i - q0)
                if gq + 4 <= npix:
                    for j in range(3):
                        if bool((v[4 * j:4 * j + 4] != 0).any()):
                            assert (3 * gq + 4 * j) % 4 == 0   # 16-byte aligned
                            acc[3 * gq + 4 * j:3 * gq + 4 * j + 4] += v[4 * j:4 * j + 4]
                else:
                    for i in range(4):
                        if gq + i < npix:
                            flush(gq + i, v[3 * i:3 * i + 3])
        assert sorted(covered) == list(range(wpix)), "each window pixel flushed once"

    for bi in range(b):
        for ty0 in range(0, h, TH3):
            for tx0 in range(0, w, TW3):
                ts = torch.arange(NT3)
                ys, xs = ty0 + ts // TW3, tx0 + ts % TW3
                live = (ys < h) & (xs < w)
                ys, xs = ys[live], xs[live]
                # each thread's g by its loads; its corners and weights
                p = (bi * h + ys) * w + xs
                gv = torch.stack([torch.cat([flat_g[e:e + n] for e, n in pixel3_loads(3 * int(q))])
                                  for q in p])
                assert torch.equal(gv, g[bi, ys, xs])
                cx0, cy0, cx1, cy1 = (v[bi, ys, xs] for v in (x0, y0c, x1, y1))
                twx, twy = wx[bi, ys, xs], wy[bi, ys, xs]
                tx1, ty1 = x1_in[bi, ys, xs], y1_in[bi, ys, xs]
                ins = [torch.ones_like(tx1), tx1, ty1, tx1 & ty1]
                weights = [twx * twy, (1 - twx) * twy, twx * (1 - twy), (1 - twx) * (1 - twy)]
                weights = [torch.where(i, wt, 0.0) for i, wt in zip(ins, weights)]
                cy = [cy0, cy0, cy0 + 1, cy0 + 1]
                cx = [cx0, cx0 + 1, cx0, cx0 + 1]
                ylo, yhi, xlo, xhi = cy0.min(), cy1.max(), cx0.min(), cx1.max()
                ww = int(xhi - xlo + 1)
                wpix = int(yhi - ylo + 1) * ww
                src0 = bi * hs * w
                if not window or wpix > WINDOW3:
                    routes.append("direct")
                    for j in range(4):
                        for i in ins[j].nonzero().flatten().tolist():
                            flush(src0 + int(cy[j][i]) * w + int(cx[j][i]), weights[j][i] * gv[i])
                    continue
                routes.append("window")
                at = [(cy[j] - ylo) * ww + cx[j] - xlo for j in range(4)]
                # f32 shared atomics into a channel-major window, none that
                # adds 0
                win = torch.zeros(3, WINDOW3)
                for j in range(4):
                    v = weights[j][:, None] * gv
                    keep = ins[j] & (v != 0).any(1)
                    win.index_add_(1, at[j][keep], v[keep].T)
                sums = win[:, :wpix].T
                flush_window(sums, src0, int(ylo), int(xlo), ww, wpix)
    acc = acc.view(b, hs, w, 3)
    return acc.to(g.dtype), acc, routes


# the routes of the C = 3 kernel: the window wherever the box fits, or
# direct on every block
C3_ROUTES = {"window": True, "direct": False}


def test_c3_window_fits_the_shared_memory():
    """The window's f32 sums, 3 channels of WINDOW3 pixels, fit the 7 KB
    that the kernel's build report allows (`test_warp_bwd_tiled_kernel_info`)."""
    assert WINDOW3 == 2 * NT3 and 3 * WINDOW3 * 4 <= 7 << 10


@pytest.mark.parametrize("first", range(6))
def test_c3_pixel_loads_cover_the_pixel_once(first):
    loads = pixel3_loads(first)
    assert sorted(e for at, n in loads for e in range(at, at + n)) == [first, first + 1, first + 2]
    assert all(at % 2 == 0 for at, n in loads if n == 2), "pairs aligned"


@pytest.mark.parametrize("q", range(6))
def test_c3_pixel_adds_cover_the_channels_once(q):
    adds = pixel3_adds(q)
    assert sorted(e for at, n in adds for e in range(at, at + n)) == list(range(3 * q, 3 * q + 3))
    assert all(at % n == 0 for at, n in adds), "8- or 4-byte aligned"


@pytest.mark.parametrize("route", C3_ROUTES)
@pytest.mark.parametrize("kind", FLOWS)
def test_k4_c3_plan_matches_twin_and_jax(jax_grads, kind, route):
    img, flow, g = inputs(3, kind)
    got, acc, routes = k4_c3_model(torch.from_numpy(flow), torch.from_numpy(g),
                                   window=C3_ROUTES[route])
    twin, _ = ops.warp_bilinear_backward_reference(*map(torch.from_numpy, (img, flow, g)))
    close(got.numpy(), twin.numpy())
    close(got.numpy(), jax_grads[(3, kind)][0])
    assert len(routes) == c3_blocks(B, H, W)
    want = {"zero": {"window"}, "smooth": {"window"}, "far": {"window"},
            "random": {"direct"}, "outliers": {"window", "direct"}}[kind]
    assert set(routes) == (want if route == "window" else {"direct"}), routes


@pytest.mark.parametrize("kind", ["smooth", "random", "outliers"])
def test_k4_c3_plan_direct_and_by_grid(jax_grads, kind):
    """Direct on every block, and by the grid on an H100's 132 SMs (24
    blocks, fewer than half a block an SM: direct): the same image
    gradient."""
    img, flow, g = inputs(3, kind)
    flow, g = torch.from_numpy(flow), torch.from_numpy(g)
    direct, _, routes = k4_c3_model(flow, g, window=False)
    assert set(routes) == {"direct"}
    by_grid, _, routes = k4_c3_model(flow, g, sms=132)
    assert set(routes) == {"direct"} and torch.equal(by_grid, direct)
    close(direct.numpy(), jax_grads[(3, kind)][0])


@pytest.mark.parametrize("route", C3_ROUTES)
@pytest.mark.parametrize("kind", ["smooth", "random", "outliers"])
def test_k4_c3_plan_row_window(kind, route):
    """Bands of 10, 9 and 9 rows of the 28-row images (y0 = 0, 10, 19)
    against the twin with the same window, and summed against the whole
    image's gradient."""
    img, flow, g = map(torch.from_numpy, inputs(3, kind))
    whole = ops.warp_dimages_reference(flow, g)
    total = torch.zeros_like(whole)
    for y0, y1 in ((0, 10), (10, 19), (19, H)):
        fl, gb = flow[:, y0:y1].contiguous(), g[:, y0:y1].contiguous()
        got, _, _ = k4_c3_model(fl, gb, H, y0, window=C3_ROUTES[route])
        assert got.shape == (B, H, W, 3)
        close(got.numpy(), ops.warp_dimages_reference(fl, gb, H, y0).numpy())
        total += got
    close(total.numpy(), whole.numpy())


@pytest.mark.parametrize("route", C3_ROUTES)
@pytest.mark.parametrize("kind", ["zero", "smooth", "far"])
@pytest.mark.parametrize("shape", [(1, 7, 13), (2, 9, 35), (1, 3, 2)])
def test_k4_c3_plan_odd_sizes(shape, kind, route):
    """Images whose pixel count is not a multiple of 4, and rows that are
    not: far flows pile every add on the last pixel, whose group of 4
    reaches past the accumulator's end."""
    rng = np.random.default_rng(sum(shape))
    flow = torch.from_numpy(rng.standard_normal(shape + (2,)).astype(np.float32))
    flow = {"zero": flow * 0, "smooth": flow * 0.5,
            "far": flow + torch.tensor([3.0 * shape[2], 3.0 * shape[1]])}[kind]
    g = torch.from_numpy(rng.standard_normal(shape + (3,)).astype(np.float32))
    got, _, routes = k4_c3_model(flow, g, window=C3_ROUTES[route])
    assert set(routes) == {route}
    close(got.numpy(), ops.warp_dimages_reference(flow, g).numpy())


def test_k4_c3_plan_bf16_cast():
    """bf16 g: the accumulator sums in f32 and the one pass rounds it to
    bf16 once, as the twin does."""
    _, flow, g = inputs(3, "smooth")
    flow, g = torch.from_numpy(flow).bfloat16(), torch.from_numpy(g).bfloat16()
    got, acc, _ = k4_c3_model(flow, g, window=True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, acc[..., :3].bfloat16())
    twin = ops.warp_dimages_reference(flow, g)
    np.testing.assert_allclose(got.float().numpy(), twin.float().numpy(), rtol=1e-2,
                               atol=1e-2 * twin.float().abs().max().item())


def test_k4_c3_window_allowed_at_the_spynet_levels():
    """SPyNet's pme step (B=8, 320x640 down to 10x20) on an H100's 132
    SMs: 6400, 1600, 400, 120, 48 and 16 blocks; the window route allowed
    at the four finest levels, where it was measured to be the faster,
    not at 20x40 and 10x20."""
    grids = [c3_blocks(8, 320 >> j, 640 >> j) for j in range(6)]
    assert grids == [6400, 1600, 400, 120, 48, 16]
    assert [c3_window_allowed(n, 132) for n in grids] == [True, True, True, True, False, False]
