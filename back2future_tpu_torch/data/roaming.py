"""Generate a RoamingImages-style synthetic pretraining dataset.

The port's copy of tools/make_roaming.py, with the same flags, `main(argv)`
and seeding, so that the same arguments write byte-identical files
(tests/test_torch_data.py):

    python -m back2future_tpu_torch.data.roaming --out DIR --n N

The reference's primary pretraining set, RoamingImages (README.md:78,
83-87; datasets/RoamingImages.dat + an 80k-line split), is an external
download that ships only as a manifest — the data itself is textured
layers roaming over a background with LINEAR motion, i.e. exactly the
hard-constraint assumption the Ours-Hard model is pretrained under
(models/pwc.lua:438's negative-multiplier past warps). This tool
regenerates an equivalent dataset from scratch so the full three-stage
recipe (hard pretrain -> convert_to_soft -> soft fine-tune) is runnable
end-to-end without any external blob:

  * per scene: a background plus 1..`layers` foreground rectangles, each
    with a constant per-frame velocity; `frames` frames rendered with
    subpixel bilinear sampling (so ground-truth flow is genuinely
    fractional);
  * ground-truth forward flow at the reference (center) frame = the
    per-pixel velocity of the topmost covering layer (linear motion:
    displacement to frame ref+1);
  * 3-state occlusion maps derived with the reference's own z-buffer
    algorithm (io/occ.get_occ = flowExtensions.lua:172-239) from the
    layered depth + flow; `_occ_<F>.disp` for a wider F-frame window
    uses flow scaled by the window's maximum frame distance (F-1)/2
    (linear motion again);
  * manifest + split in the reference .dat format (donkey.lua:70-94),
    loadable by `--dataset RoamingImages --ground_truth 1`.

Textures are smooth random fields by default; pass `--images <dir>` to
crop textures from real photos instead (closer to the original set).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..io.flow_io import write_disp, write_flo
from ..io.occ import get_occ
from ..io.png16 import read_png, write_png
from .manifest import SampleSpec, write_manifest
from .resample import resize

BG_DEPTH = 10.0  # any layer (depth 1..K) beats the background z-buffer


def _smooth_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Multi-octave random RGB field in [0,1]: noise at blob scales
    64/16/4 px, bilinearly upsampled and summed with decreasing
    amplitude. The octave mix matters for *learnability*: the coarse
    octave drives the pyramid's top levels, while the mid/fine octaves
    put real image gradient at the finer levels (a single 16 px octave
    leaves the photometric loss nearly flat there — measured: the hard
    recipe stalls at the zero-flow EPE on such data). Staying piecewise-
    smooth keeps subpixel-bilinear warping nearly lossless, which is
    what makes the brightness-constancy ground truth tight."""
    tex = np.zeros((h, w, 3), np.float32)
    for blob, amp in ((64, 1.0), (16, 0.5), (4, 0.25)):
        coarse = rng.random((max(h // blob, 2), max(w // blob, 2), 3))
        tex += amp * resize(coarse.astype(np.float32), h, w, "bilinear")
    # stretch to full [0,1] contrast (the octave sum is bell-shaped)
    tex -= tex.min()
    tex /= max(float(tex.max()), 1e-6)
    return tex


def _photo_texture(rng: np.random.Generator, pool, h: int, w: int):
    """Random crop from a user-supplied photo pool (resized up if small)."""
    img = read_png(str(pool[rng.integers(len(pool))]))
    img = img.astype(np.float32) / (65535.0 if img.dtype == np.uint16 else 255.0)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img[..., :3]
    if img.shape[0] < h or img.shape[1] < w:
        img = resize(img, max(h, img.shape[0]), max(w, img.shape[1]), "bilinear")
    y = rng.integers(img.shape[0] - h + 1)
    x = rng.integers(img.shape[1] - w + 1)
    return img[y:y + h, x:x + w]


def _sample_bilinear(tex: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    """Gather tex (th, tw, 3) at float coords (ys (H,), xs (W,)) with
    border clamp; returns (H, W, 3)."""
    th, tw = tex.shape[:2]
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, th - 2)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, tw - 2)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    t00 = tex[y0][:, x0]
    t01 = tex[y0][:, x0 + 1]
    t10 = tex[y0 + 1][:, x0]
    t11 = tex[y0 + 1][:, x0 + 1]
    return ((1 - wy) * ((1 - wx) * t00 + wx * t01)
            + wy * ((1 - wx) * t10 + wx * t11)).astype(np.float32)


def render_scene(rng: np.random.Generator, h: int, w: int, frames: int,
                 n_layers: int, max_speed: float, texture_fn):
    """One scene -> (frames list of (H,W,3) images, flow (H,W,2),
    depth (H,W)) with ground truth at the center frame."""
    rc = (frames - 1) // 2  # 0-based reference index
    margin = int(np.ceil(max_speed * rc)) + 2

    bg_tex = texture_fn(rng, h + 2 * margin, w + 2 * margin)
    bg_v = rng.uniform(-max_speed / 2, max_speed / 2, size=2)  # (vx, vy)

    layers = []
    for k in range(n_layers):
        lh = int(rng.integers(h // 4, h // 2 + 1))
        lw = int(rng.integers(w // 4, w // 2 + 1))
        tex = texture_fn(rng, lh, lw)
        # position of the layer's top-left at the reference frame; keep it
        # inside-ish so layers actually occlude things
        p0 = np.array([rng.uniform(-lw / 4, w - 3 * lw / 4),
                       rng.uniform(-lh / 4, h - 3 * lh / 4)])  # (x, y)
        v = rng.uniform(-max_speed, max_speed, size=2)
        layers.append((tex, p0, v, float(k + 1)))  # depth k+1 (smaller=closer is k=0)

    imgs = []
    flow = None
    depth = None
    for t in range(-rc, frames - rc):
        # background: texture coords drift opposite the apparent motion
        oy = margin - bg_v[1] * t
        ox = margin - bg_v[0] * t
        frame = _sample_bilinear(bg_tex, np.arange(h) + oy, np.arange(w) + ox)
        if t == 0:
            flow = np.empty((h, w, 2), np.float32)
            flow[..., 0] = bg_v[0]
            flow[..., 1] = bg_v[1]
            depth = np.full((h, w), BG_DEPTH, np.float64)
        # paint layers back-to-front (largest depth first = painted first)
        for tex, p0, v, d in sorted(layers, key=lambda l: -l[3]):
            lh, lw = tex.shape[:2]
            px, py = p0 + v * t
            ys = np.arange(h) - py
            xs = np.arange(w) - px
            cover = ((ys >= 0) & (ys <= lh - 1))[:, None] & \
                    ((xs >= 0) & (xs <= lw - 1))[None, :]
            patch = _sample_bilinear(tex, ys, xs)
            frame = np.where(cover[..., None], patch, frame)
            if t == 0:
                flow[..., 0] = np.where(cover, v[0], flow[..., 0])
                flow[..., 1] = np.where(cover, v[1], flow[..., 1])
                depth = np.where(cover, d, depth)
        imgs.append(frame)
    return imgs, flow, depth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="dataset root (creates "
                    "<out>/data scenes and <out>/datasets manifests)")
    ap.add_argument("--n", type=int, default=100, help="number of scenes")
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--frames", type=int, default=7,
                    help="frames per scene (>= the training window; 7 "
                         "covers -frames 2/3/5/7)")
    ap.add_argument("--layers", type=int, default=2,
                    help="max foreground layers per scene (1..N sampled)")
    ap.add_argument("--max_speed", type=float, default=8.0,
                    help="max layer speed, px/frame")
    ap.add_argument("--val_fraction", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", default=None,
                    help="directory of source PNGs to crop textures from "
                         "(default: smooth synthetic fields)")
    ap.add_argument("--name", default="RoamingImages")
    args = ap.parse_args(argv)

    out = Path(args.out)
    data = out / "data"
    ds_dir = out / "datasets"
    data.mkdir(parents=True, exist_ok=True)
    ds_dir.mkdir(parents=True, exist_ok=True)

    if args.images:
        pool = sorted(Path(args.images).glob("*.png"))
        if not pool:
            raise SystemExit(f"--images {args.images}: no .png files")
        texture_fn = lambda rng, h, w: _photo_texture(rng, pool, h, w)  # noqa: E731
    else:
        texture_fn = _smooth_texture

    rc1 = (args.frames - 1) // 2 + 1  # 1-based reference frame index
    specs, split = [], []
    rng_split = np.random.default_rng(args.seed + 1)
    for s in range(args.n):
        rng = np.random.default_rng((args.seed, s))
        n_layers = int(rng.integers(1, args.layers + 1))
        imgs, flow, depth = render_scene(
            rng, args.height, args.width, args.frames, n_layers,
            args.max_speed, texture_fn)

        scene = data / f"s{s:05d}"
        scene.mkdir(exist_ok=True)
        for t, img in enumerate(imgs, start=1):
            write_png(scene / f"frame_{t:02d}.png",
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
        write_flo(scene / f"flow_{rc1:02d}.flo", flow)
        # z-buffer occlusions exactly as the reference derives them;
        # wider windows scale the flow by their max frame distance
        for f_win in (3, 5, 7):
            if f_win > args.frames:
                break
            occ = get_occ(depth, flow * ((f_win - 1) // 2))
            write_disp(scene / f"flow_{rc1:02d}_occ_{f_win}.disp",
                       occ.astype(np.float32))

        rel = f"[PATH]/s{s:05d}"
        specs.append(SampleSpec(f"{rel}/frame_%02d.png",
                                f"{rel}/flow_%02d.flo", rc1, 1))
        split.append("2" if rng_split.random() < args.val_fraction else "1")
        if (s + 1) % 50 == 0 or s + 1 == args.n:
            print(f"{s + 1}/{args.n} scenes", flush=True)

    write_manifest(ds_dir / f"{args.name}.dat", specs)
    (ds_dir / f"{args.name}_split.dat").write_text("\n".join(split) + "\n")
    print(f"wrote {args.n} scenes under {data}, manifests under {ds_dir}")


if __name__ == "__main__":
    main()
