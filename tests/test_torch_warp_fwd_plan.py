"""The plan of the warp's gather (csrc/warp_fwd_tiled.cu), modelled thread
by thread in plain torch and held against the gather's twin
(`ops.warp_bilinear_reference`) and the JAX package's `warp_bilinear`.

The kernels cannot be compiled or run on the CPU; this model repeats
their index arithmetic with the same constants, so a fault in the plan
shows here. Both kernels run a persistent grid (at most the blocks the
SMs hold at once) in a grid-stride loop:
- a thread's pixel (b, y, x) advances by the grid's stride without a
  division (one carry from x into y and one from y into b);
- lanes kernel (every C but 3): G lanes a pixel; lane l reads packs
  l + G * j (j < PPL) of VEC elements of each of the four corners, or
  with PPL = 0 packs l, l + G, ... up to C; one load of a group covers a
  contiguous segment of a corner row, and a warp's stores cover its
  32 / G consecutive pixels whole; (VEC, G, PPL) from C and the element
  size by the launch's table, single elements where C or the pointers
  take no 16-byte packs;
- rows kernel (C = 3): one thread per pixel, NT_ROWS a block; each
  corner pair read as one 6-element span where the +1 column is inside
  the image (3 pair loads at an even element, else an element, 2 pairs
  and an element), else 3 elements repeated for the clamped corner; no bottom load where the +1 row is outside (the top row
  repeated); its 3 outputs stored where they go.
Every sum is f32 in another order than the twin's and JAX's: tolerance
1e-5, relative to the largest value.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from back2future_tpu.ops.warp import warp_bilinear as jax_warp_bilinear
from back2future_tpu_torch import ops
from back2future_tpu_torch.ops.warp import _corners

torch.set_num_threads(1)

SOURCE = Path(__file__).resolve().parent.parent / "back2future_tpu_torch/csrc/warp_fwd_tiled.cu"
NT, NT_ROWS = 256, 128   # the kernels' constants
# the launch's lane plan: packs of VEC a pixel -> (G, PPL); any other count
# loops in groups of 4 (PPL = 0)
PLAN = {4: (4, 1), 8: (8, 1), 12: (4, 3), 16: (8, 2), 24: (8, 3), 32: (8, 4)}

H, W = 13, 37             # partial tiles and odd rows, so the walk carries
CHANNELS = (3, 20, 32, 64)
FLOWS = ("random", "smooth", "far", "ties")


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))


def make_flow(kind: str, b: int, seed: int) -> np.ndarray:
    """random: i.i.d. at scale W/2, past the border; smooth: a 2x bilinear
    upsample of a coarse random field (1 pixel std at half size); far: the
    smooth flow moved 2 widths right and 2 heights up; ties: every source
    coordinate on the border (column 0 or W-1, row 0 or H-1, in turns) or
    an integer 0-2 pixels away."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.standard_normal((b, H, W, 2)) * (W / 2)).astype(np.float32)
    if kind == "ties":
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        to = rng.integers(0, 4, (b, H, W))
        u = np.where(to == 0, -xs, np.where(to >= 1, W - 1 - xs, 0)).astype(np.float32)
        v = np.where(to == 2, H - 1 - ys, np.where(to == 0, -ys, 0)).astype(np.float32)
        near = to == 3
        u[near] = rng.integers(-2, 3, near.sum())
        v[near] = rng.integers(-2, 3, near.sum())
        return np.stack([u, v], -1)
    coarse = torch.from_numpy(rng.standard_normal((b, 2, -(-H // 2), -(-W // 2))).astype(
        np.float32))
    smooth = F.interpolate(coarse, scale_factor=2, mode="bilinear", align_corners=False)
    smooth = smooth[:, :, :H, :W].permute(0, 2, 3, 1).numpy()
    if kind == "smooth":
        return np.ascontiguousarray(smooth)
    assert kind == "far"
    return (smooth + np.array([2 * W, -2 * H], np.float32)).astype(np.float32)


def inputs(c: int, kind: str, b: int):
    seed = 1000 * b + 10 * c + FLOWS.index(kind)
    img = np.random.default_rng(seed).standard_normal((b, H, W, c)).astype(np.float32)
    return img, make_flow(kind, b, seed)


def lane_plan(c: int, elem_bytes: int, aligned: bool = True):
    """(VEC, G, PPL) of the launch for C channels of `elem_bytes` bytes, or
    None for the rows kernel (C = 3)."""
    if c == 3:
        return None
    vec = 16 // elem_bytes
    if c % vec == 0 and aligned:
        return (vec,) + PLAN.get(c // vec, (4, 0))
    return 1, 4, 0


class Walk:
    """The kernels' walk of a thread's pixel index p and its (b, y, x),
    vectorised over threads."""

    def __init__(self, p0: torch.Tensor, stride: int, h: int, w: int):
        self.p, self.h, self.w = p0.clone(), h, w
        self.b, self.x, self.y = p0 // (h * w), p0 % w, (p0 // w) % h
        self.stride = stride
        self.sb, self.sx, self.sy = stride // (h * w), stride % w, (stride // w) % h

    def step(self):
        self.p = self.p + self.stride
        self.x = self.x + self.sx
        carry = self.x >= self.w
        self.x = torch.where(carry, self.x - self.w, self.x)
        self.y = self.y + self.sy + carry.long()
        carry = self.y >= self.h
        self.y = torch.where(carry, self.y - self.h, self.y)
        self.b = self.b + self.sb + carry.long()

    def check(self, live):
        """(b, y, x) are the divmod of p wherever p is a pixel."""
        p = self.p[live]
        assert torch.equal(self.b[live], p // (self.h * self.w))
        assert torch.equal(self.y[live], (p // self.w) % self.h)
        assert torch.equal(self.x[live], p % self.w)


def corners_at(f: torch.Tensor, x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """warp_corners.cuh's corners_at in f32: (x0, y0, x1, y1, wx, wy)."""
    xc = torch.clamp(f[:, 0] + x.float(), 0.0, w - 1.0)
    yc = torch.clamp(f[:, 1] + y.float(), 0.0, h - 1.0)
    x0f, y0f = torch.floor(xc), torch.floor(yc)
    wx, wy = 1.0 - (xc - x0f), 1.0 - (yc - y0f)
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.where(x0 + 1 <= w - 1, x0 + 1, x0)
    y1 = torch.where(y0 + 1 <= h - 1, y0 + 1, y0)
    return x0, y0, x1, y1, wx, wy


def blend(wx, wy, tl, tr, bl, br):
    """The kernels' f32 sum, tl + tr + bl + br, with their weights."""
    wx, wy = wx.unsqueeze(-1), wy.unsqueeze(-1)
    return wx * wy * tl + (1 - wx) * wy * tr + wx * (1 - wy) * bl + (1 - wx) * (1 - wy) * br


def lane_elements(c: int, vec: int, g: int, ppl: int):
    """Per lane, its loads in order: the element offsets of each pack."""
    if ppl:
        return [[(l + g * j) * vec for j in range(ppl)] for l in range(g)]
    return [list(range(l * vec, c, g * vec)) for l in range(g)]


def lanes_model(img: torch.Tensor, flow: torch.Tensor, vec: int, g: int, ppl: int, grid: int):
    """The lanes kernel on a grid of `grid` blocks: the output, and the
    count of times each output element was written."""
    b, h, w, c = img.shape
    npix = b * h * w
    if ppl:
        assert c == g * ppl * vec
    groups = NT // g
    stride = grid * groups
    flat_img, flat_flow = img.reshape(-1), flow.reshape(npix, 2)
    out = torch.full((npix * c,), float("nan"))
    writes = torch.zeros(npix * c, dtype=torch.long)
    # group gid = blockIdx * groups + t / G; its first pixel is gid
    walk = Walk(torch.arange(stride), stride, h, w)
    live = walk.p < npix
    plane = h * w * c
    elements = lane_elements(c, vec, g, ppl)
    while live.any():
        walk.check(live)
        f = flat_flow[torch.where(live, walk.p, 0)]
        x0, y0, x1, y1, wx, wy = corners_at(f, walk.x, walk.y, h, w)
        tl = walk.b * plane + (y0 * w + x0) * c
        dx, dy = (x1 - x0) * c, (y1 - y0) * w * c
        p = walk.p[live]
        for lane in range(g):
            for e0 in elements[lane]:
                e = e0 + torch.arange(vec)
                at = (tl[live].unsqueeze(-1) + e)
                corners = [flat_img[at + off.unsqueeze(-1)] for off in
                           (0 * dx[live], dx[live], dy[live], dy[live] + dx[live])]
                dst = p.unsqueeze(-1) * c + e
                out[dst] = blend(wx[live], wy[live], *corners)
                writes.index_add_(0, dst.reshape(-1), torch.ones(dst.numel(), dtype=torch.long))
        walk.step()
        live = walk.p < npix
    return out.view(b, h, w, c), writes


def span_loads(start: torch.Tensor):
    """load_span6's loads at element `start`, as (offset, length) each: 3
    pairs where start is even, else an element, 2 pairs and an element
    (the last load of an even start has length 0)."""
    even = start % 2 == 0
    return [(torch.zeros_like(start), torch.where(even, 2, 1)),
            (torch.where(even, 2, 1), torch.full_like(start, 2)),
            (torch.where(even, 4, 3), torch.full_like(start, 2)),
            (torch.full_like(start, 5), torch.where(even, 0, 1))]


def check_span(start: torch.Tensor):
    """A corner pair's loads at element `start`: each of its 6 elements
    read once, each pair at an even element (a pair load's alignment)."""
    cover = torch.zeros(start.numel(), 6, dtype=torch.long)
    rows = torch.arange(start.numel())
    for off, n in span_loads(start):
        assert ((start + off)[n == 2] % 2 == 0).all()
        for k in range(2):
            hit = k < n
            cover[rows[hit], (off + k)[hit]] += 1
    assert (cover == 1).all()


def rows_model(img: torch.Tensor, flow: torch.Tensor, grid: int):
    """The rows kernel on a grid of `grid` blocks: the output, and the
    count of times each output element was written."""
    b, h, w, c = img.shape
    assert c == 3
    npix = b * h * w
    stride = grid * NT_ROWS
    flat_img, flat_flow = img.reshape(-1), flow.reshape(npix, 2)
    out = torch.full((npix * 3,), float("nan"))
    writes = torch.zeros(npix * 3, dtype=torch.long)
    # thread t of block i: pixel i * NT_ROWS + t first
    walk = Walk(torch.arange(stride), stride, h, w)
    live = walk.p < npix
    six = torch.arange(6)
    while live.any():
        walk.check(live)
        f = flat_flow[torch.where(live, walk.p, 0)]
        x0, y0, x1, y1, wx, wy = corners_at(f, walk.x, walk.y, h, w)
        x1_in, y1_in = x1 > x0, y1 > y0
        row0 = ((walk.b * h + y0) * w + x0) * 3
        row1 = torch.where(y1_in, row0 + w * 3, row0)            # bottom repeats top
        for start in (row0[live & x1_in], row1[live & x1_in & y1_in]):
            check_span(start)
        span = torch.where(x1_in.unsqueeze(-1), six, six % 3)   # tr repeats tl when clamped
        top = flat_img[(row0.unsqueeze(-1) + span)[live]]
        bot = flat_img[(row1.unsqueeze(-1) + span)[live]]
        res = blend(wx[live], wy[live], top[:, :3], top[:, 3:], bot[:, :3], bot[:, 3:])
        dst = 3 * walk.p[live].unsqueeze(-1) + torch.arange(3)
        out[dst] = res
        writes.index_add_(0, dst.reshape(-1), torch.ones(dst.numel(), dtype=torch.long))
        walk.step()
        live = walk.p < npix
    return out.view(b, h, w, 3), writes


@pytest.fixture(scope="module")
def jax_out():
    """The JAX package's warp (f32) of every input."""
    return {(c, kind, b): np.asarray(jax_warp_bilinear(*map(jnp.asarray, inputs(c, kind, b))))
            for c in CHANNELS for kind in FLOWS for b in (1, 2)}


def test_plan_constants_are_the_kernels():
    src = SOURCE.read_text()
    for name, value in (("NT", NT), ("NT_ROWS", NT_ROWS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    for packs, (g, ppl) in PLAN.items():
        line = f"case {packs}: return launch_lanes<T, VEC, {g}, {ppl}>("
        assert line in src, line
    for line in ("default: return launch_lanes<T, VEC, 4, 0>(",
                 "return launch_lanes<T, 1, 4, 0>(", "if (C == 3) {"):
        assert line in src, line


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [8, 16, 20, 32, 64, 96, 128, 192, 5])
def test_lanes_cover_each_pixel_once(c, elem_bytes):
    """Each element of a pixel is read and written by exactly one lane;
    one load of a group covers a contiguous segment; the model's widths
    unroll (PPL > 0)."""
    vec, g, ppl = lane_plan(c, elem_bytes)
    elements = lane_elements(c, vec, g, ppl)
    got = sorted(e0 + v for lane in elements for e0 in lane for v in range(vec))
    assert got == list(range(c))
    for j in range(max(map(len, elements))):
        seg = sorted(e0 + v for lane in elements if j < len(lane) for v in range(vec)
                     for e0 in lane[j:j + 1])
        assert seg == list(range(seg[0], seg[0] + len(seg)))
    if c in (32, 64, 96, 128):
        assert ppl > 0 and g * ppl * vec == c
    assert 32 % g == 0


@pytest.mark.parametrize("g", [4, 8])
def test_lanes_warp_stores_are_contiguous(g):
    """The 32 / G groups of a warp hold consecutive pixels, so the warp's
    stores (all of its lanes' packs) cover one contiguous run."""
    groups = NT // g
    for block in range(3):
        for warp in range(NT // 32):
            gids = {block * groups + (warp * 32 + lane) // g for lane in range(32)}
            assert sorted(gids) == list(range(min(gids), min(gids) + 32 // g))


@pytest.mark.parametrize("grid", [1, 2, 3, 7])
def test_walk_carries(grid):
    """The division-free walk against divmod, for strides shorter and
    longer than a row and than an image."""
    for stride in (grid * 8, grid * 64, grid * NT_ROWS, grid * NT):
        walk = Walk(torch.arange(stride), stride, H, W)
        for _ in range(4 * 2 * H * W // stride + 2):
            walk.check(torch.ones_like(walk.p, dtype=torch.bool))
            walk.step()


@pytest.mark.parametrize("grid", [0, 2, 3])
@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("c", CHANNELS)
def test_gather_plan_matches_twin_and_jax(jax_out, c, kind, b, elem_bytes, grid):
    """The plan of the element size's launch (`elem_bytes`: the lane plan;
    the sums are f32 either way) on a grid of `grid` blocks (0: every block the pixels
    need, one pixel a thread), against the twin and JAX; every output
    element written exactly once."""
    img, flow = map(torch.from_numpy, inputs(c, kind, b))
    plan = lane_plan(c, elem_bytes)
    npix = b * H * W
    if plan is None:
        got, writes = rows_model(img, flow, grid or -(-npix // NT_ROWS))
    else:
        vec, g, ppl = plan
        got, writes = lanes_model(img, flow, vec, g, ppl, grid or -(-npix // (NT // g)))
    assert (writes == 1).all()
    twin = ops.warp_bilinear_reference(img, flow)
    close(got.numpy(), twin.numpy())
    close(got.numpy(), jax_out[(c, kind, b)])


@pytest.mark.parametrize("c", [20, 32])
def test_gather_plan_unaligned(jax_out, c):
    """Where the pointers take no 16-byte packs: single elements in groups
    of 4."""
    img, flow = map(torch.from_numpy, inputs(c, "random", 2))
    assert lane_plan(c, 2, aligned=False) == (1, 4, 0)
    got, writes = lanes_model(img, flow, 1, 4, 0, 2)
    assert (writes == 1).all()
    close(got.numpy(), jax_out[(c, "random", 2)])


def test_corners_are_the_twins():
    """The model's corners_at against the twin's `_corners` (the kernel's
    arithmetic, which the twin repeats)."""
    _, flow = inputs(3, "ties", 2)
    flow = torch.from_numpy(flow)
    (x0, y0, x1, y1), (wx, wy), _, _ = _corners(flow, H, W)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    got = corners_at(flow.reshape(-1, 2), xs.repeat(2, 1, 1).reshape(-1),
                     ys.repeat(2, 1, 1).reshape(-1), H, W)
    for a, want in zip(got, (x0, y0, x1, y1, wx, wy)):
        assert torch.equal(a, want.reshape(-1))
