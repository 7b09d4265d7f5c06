"""The port's host data pipeline (back2future_tpu_torch.data) against the
JAX package's back2future_tpu.data, on seeded numpy inputs at 64x128.

Both packages resize, rotate and jitter float32 data with their C++
libraries (f32 weights) and keep NumPy paths (f64 weights and maps) for
other dtypes; the port's NumPy paths are the twins of its C++ functions
(data/resample.py `numpy_twins`). The parity tests here put both
packages on their NumPy paths (`jax_numpy`: the JAX package's
`resample._native = (None,)`, the port's B2F_HOST_TWINS=1) and hold the
port bit for bit against the JAX package there: manifests, augmentation,
samples, batches in sync and thread modes, and the generator's files.
One test holds the port's twins against the JAX package's default C++
path within IMAGE_TOL / FLOW_TOL; tests/test_torch_native_resample.py
holds the two C++ paths bit for bit. The port's process mode, under
fork and under spawn, is held against its own sync mode (a JAX loader in
this process may choose spawn, so the two packages meet in sync and
thread modes only).
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import back2future_tpu.data as jax_data
from back2future_tpu.config import Options as JaxOptions
from back2future_tpu.data import augment as jax_augment
from back2future_tpu.data import manifest as jax_manifest
from back2future_tpu.data import resample as jax_resample
from back2future_tpu.data import sample as jax_sample
from back2future_tpu.data import wire as jax_wire
import back2future_tpu_torch.data as data
from back2future_tpu_torch.config import Options
from back2future_tpu_torch.data import augment, loader, manifest, resample, roaming, sample, wire

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 128
# port (NumPy twins, f64 weights) against the JAX package's native f32 path: the
# weights differ in their last bits (max seen 1.1e-6 on images, 1.8e-7 on
# flow at 64x128), nearest gathers and occlusion not at all
IMAGE_TOL = 1e-5      # normalised images, mask
FLOW_TOL = 1e-6       # flow / flownet_factor


@pytest.fixture
def jax_numpy(monkeypatch):
    """Both packages on their NumPy paths (no C++ resampler or jitter)."""
    monkeypatch.setattr(jax_resample, "_native", (None,))
    monkeypatch.setenv(resample.TWINS_ENV, "1")


def generate(root, *extra):
    roaming.main(["--out", str(root), "--height", str(H), "--width", str(W),
                  "--max_speed", "5", *extra])
    return root


@pytest.fixture(scope="module")
def roam(tmp_path_factory):
    """Six generated scenes of 5 frames (occlusion maps for 3 and 5)."""
    return generate(tmp_path_factory.mktemp("roam"), "--n", "6", "--frames", "5",
                    "--val_fraction", "0.34")


def specs_of(pkg, root, ground_truth=True):
    return pkg.load_manifest(root / "datasets" / "RoamingImages.dat",
                             ground_truth=ground_truth, root=str(root / "data"))


def as_rows(specs):
    return [dataclasses.astuple(s) for s in specs]


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_exports_match_jax():
    assert data.__all__ == jax_data.__all__
    assert wire.WIRE_FORMATS == jax_wire.WIRE_FORMATS


def test_data_import_is_light():
    """Spawned loader workers import the package: it must not pull in
    torch (nor jax or the JAX package)."""
    code = ("import sys, back2future_tpu_torch.data, back2future_tpu_torch.data.roaming\n"
            "bad = [m for m in ('torch', 'jax', 'back2future_tpu') if m in sys.modules]\n"
            "assert not bad, bad\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# -------------------------------------------------------------------- manifests

@pytest.mark.parametrize("ground_truth", [False, True])
@pytest.mark.parametrize("name", ["Kitti2015", "Sintel"])
def test_repo_manifests_parse_as_in_jax(name, ground_truth):
    path = ROOT / "datasets" / f"{name}.dat"
    try:
        want = jax_manifest.load_manifest(path, ground_truth, root="/data")
    except Exception as e:   # Kitti2015.dat has no flow column
        with pytest.raises(type(e)):
            manifest.load_manifest(path, ground_truth, root="/data")
        return
    got = manifest.load_manifest(path, ground_truth, root="/data")
    assert as_rows(got) == as_rows(want) and len(got) > 1000
    for g, w in zip(got[::97], want[::97]):
        for frames in (2, 3, 5, 7):
            assert g.frame_indices(frames) == w.frame_indices(frames)
            assert g.image_paths(frames) == w.image_paths(frames)
            assert g.occ_paths(frames) == w.occ_paths(frames)
        assert g.flow_path() == w.flow_path()


@pytest.mark.parametrize("name", ["Kitti2015", "Sintel", "RoamingImages"])
def test_repo_splits_as_in_jax(name):
    path = ROOT / "datasets" / f"{name}_split.dat"
    for got, want in zip(manifest.load_split(path), jax_manifest.load_split(path)):
        np.testing.assert_array_equal(got, want)


def test_write_manifest_byte_identical(tmp_path):
    specs = [manifest.SampleSpec("[PATH]/a_%02d.png", "[PATH]/f_%02d.flo", 3, 2),
             manifest.SampleSpec("[PATH]/b_%02d.png", None, 4, 1)]
    manifest.write_manifest(tmp_path / "port.dat", specs)
    jax_manifest.write_manifest(tmp_path / "jax.dat",
                                [jax_manifest.SampleSpec(*dataclasses.astuple(s)) for s in specs])
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()


def test_manifest_cache_hit_stale_and_off(tmp_path, monkeypatch):
    path = tmp_path / "toy.dat"
    manifest.write_manifest(path, [manifest.SampleSpec("[PATH]/img_%02d.png", None, r, 1)
                                   for r in range(2, 6)])
    cache = tmp_path / "cache"
    monkeypatch.delenv("B2F_MANIFEST_CACHE", raising=False)
    first = manifest.load_manifest_cached(path, False, root="/d", cache_dir=cache)
    assert len(list(cache.glob("*_manifestCache.json"))) == 1
    # a hit parses nothing, and the JAX package reads the port's cache too
    monkeypatch.setattr(manifest, "load_manifest", None)
    monkeypatch.setattr(jax_manifest, "load_manifest", None)
    assert manifest.load_manifest_cached(path, False, root="/d", cache_dir=cache) == first
    assert as_rows(jax_manifest.load_manifest_cached(path, False, root="/d",
                                                     cache_dir=cache)) == as_rows(first)
    monkeypatch.undo()
    monkeypatch.delenv("B2F_MANIFEST_CACHE", raising=False)
    # stale: the manifest changed (size and mtime), so it is parsed again
    manifest.write_manifest(path, [manifest.SampleSpec("[PATH]/img_%02d.png", None, r, 1)
                                   for r in range(2, 9)])
    stale = manifest.load_manifest_cached(path, False, root="/d", cache_dir=cache)
    assert len(stale) == 7
    assert as_rows(stale) == as_rows(jax_manifest.load_manifest(path, False, root="/d"))
    # another root or ground_truth is another key
    assert manifest.load_manifest_cached(path, False, root="/e", cache_dir=cache)[0] \
        .image_pattern == "/e/img_%02d.png"
    # off: no cache file is written
    monkeypatch.setenv("B2F_MANIFEST_CACHE", "0")
    off = tmp_path / "off"
    assert len(manifest.load_manifest_cached(path, False, root="/d", cache_dir=off)) == 7
    assert not off.exists()


# ---------------------------------------------------------------- augmentation

def _frames(seed, n=3, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.random((h, w, 3), dtype=np.float32) for _ in range(n)]


def _gt(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    flow = (rng.standard_normal((h, w, 2)) * 3).astype(np.float32)
    occ = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), size=(h, w, 2))
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    return flow, occ, mask


def test_sample_geometric_draws_as_jax():
    for seed in range(20):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = augment.sample_geometric(r1, H, W, 48, 96)
        want = jax_augment.sample_geometric(r2, H, W, 48, 96)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert r1.random() == r2.random()


PHOTOMETRIC = {
    "color_jitter": lambda m, img, rng: m.color_jitter(img, rng),
    "pca_lighting": lambda m, img, rng: m.pca_lighting(img, rng),
    "gaussian_noise": lambda m, img, rng: m.gaussian_noise(img, rng, 0.05),
    "preprocess": lambda m, img, rng: m.preprocess(img, rng),
    "preprocess_raw": lambda m, img, rng: m.preprocess(img, rng, normalize=False),
    "color_normalize": lambda m, img, rng: m.color_normalize(img),
}


@pytest.mark.parametrize("fn", sorted(PHOTOMETRIC))
def test_photometric_bitwise_as_jax_numpy_path(jax_numpy, fn):
    img = np.concatenate(_frames(1), axis=-1)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    got = PHOTOMETRIC[fn](augment, img.copy(), r1)
    want = PHOTOMETRIC[fn](jax_augment, img.copy(), r2)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert r1.random() == r2.random()   # the same rng stream was drawn


GEOMETRIC = {
    "rotate_nearest": lambda m, img: m.rotate_nearest(img, 0.17),
    "translate": lambda m, img: m.translate(img, 3.6, -2.4),
    "rotate_flow_vectors": lambda m, img: m.rotate_flow_vectors(img[..., :2], -0.13),
}


@pytest.mark.parametrize("fn", sorted(GEOMETRIC))
def test_geometric_bitwise_as_jax(fn):
    img = np.concatenate(_frames(2), axis=-1)
    np.testing.assert_array_equal(GEOMETRIC[fn](augment, img), GEOMETRIC[fn](jax_augment, img))
    np.testing.assert_array_equal(augment.rotation_flow_field(H, W, 0.07),
                                  jax_augment.rotation_flow_field(H, W, 0.07))


def test_frame_transforms_as_jax():
    params = augment.sample_geometric(np.random.default_rng(3), H, W, 48, 96)
    jparams = jax_augment.GeometricParams(*dataclasses.astuple(params))
    for nf, ref0 in ((2, 0), (3, 1), (5, 2), (7, 3)):
        assert augment._frame_transforms(params, nf, ref0) == \
            jax_augment._frame_transforms(jparams, nf, ref0)


@pytest.mark.parametrize("seed", range(6))
def test_augment_paths_bitwise_as_jax_numpy_path(jax_numpy, seed):
    """augment_sample (then the load crop) and augment_sample_cropped: the
    port's equal the JAX package's, and each other."""
    frames, (flow, occ, mask) = _frames(seed), _gt(seed + 100)
    params = augment.sample_geometric(np.random.default_rng(seed), H, W, 48, 96)
    jparams = jax_augment.GeometricParams(*dataclasses.astuple(params))
    full = augment.augment_sample(frames, flow, occ, mask, params, 1)
    for g, w in zip(full, jax_augment.augment_sample(frames, flow, occ, mask, jparams, 1)):
        np.testing.assert_array_equal(g, w)
    cropped = augment.augment_sample_cropped(frames, flow, occ, mask, params, 1, 48, 96)
    for g, w in zip(cropped, jax_augment.augment_sample_cropped(frames, flow, occ, mask,
                                                                jparams, 1, 48, 96)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ih, iw = full[0].shape[:2]
    y0, x0 = min(params.crop_y, max(ih - 48, 0)), min(params.crop_x, max(iw - 96, 0))
    for g, f in zip(cropped, full):
        np.testing.assert_array_equal(g, f[y0:y0 + 48, x0:x0 + 96])


WINDOWS = {
    "rotate": lambda m, src: m.rotate_nearest_window(src, 0.21, -3, 5, 40, 70, True, False),
    "rotate_flipv": lambda m, src: m.rotate_nearest_window(src, -0.4, 7, -2, 50, 60, False, True),
    "bilinear": lambda m, src: m.resize_bilinear_window(src, H, W, 100, 190, 11, 17, 40, 80),
    "bilinear_buf": lambda m, src: m.resize_bilinear_window(src[5:40, 9:90], H, W, 100, 190,
                                                            11, 17, 40, 80, by0=5, bx0=9),
    "bilinear_flips": lambda m, src: m.resize_bilinear_window(src, H, W, 90, 170, 3, 4, 50,
                                                              60, flip_h=True, flip_v=True),
    "nearest": lambda m, src: m.resize_nearest_window(src, 100, 190, 11, 17, 40, 80, True, True),
}


@pytest.mark.parametrize("fn", sorted(WINDOWS))
def test_windowed_resample_as_jax_numpy_path(jax_numpy, fn):
    src = np.concatenate(_frames(4), axis=-1)
    np.testing.assert_array_equal(WINDOWS[fn](resample, src), WINDOWS[fn](jax_resample, src))


# --------------------------------------------------------------------- samples

SAMPLE_CONFIGS = {
    "plain": dict(augment=0, rand_crop=0),
    "rand_crop": dict(augment=0, rand_crop=1),
    "augment_fast": dict(augment=1),
    "augment_slow": dict(augment=1, fast=False),
    "augment_noise": dict(augment=1, gaussian_noise=0.02),
    "augment_compact": dict(augment=1, wire="compact"),
    "compact": dict(augment=0, rand_crop=0, wire="compact"),
    "no_gt": dict(augment=1, ground_truth=False),
    "scale": dict(augment=0, scale=0.75, fine_height=40, fine_width=80),
    "frames5": dict(augment=1, frames=5),
    "raw": dict(augment=1, normalize_images=0),
}


def sample_configs(name):
    kw = dict(SAMPLE_CONFIGS[name])
    fast = kw.pop("fast", True)
    kw = dict(dict(frames=3, ground_truth=True, fine_height=48, fine_width=96,
                   load_height=56, load_width=112), **kw)
    return fast, sample.SampleConfig(**kw), jax_sample.SampleConfig(**kw)


@pytest.mark.parametrize("name", sorted(SAMPLE_CONFIGS))
def test_train_sample_bitwise_as_jax_numpy_path(roam, jax_numpy, monkeypatch, name):
    fast, cfg, jcfg = sample_configs(name)
    monkeypatch.setenv("B2F_FAST_AUGMENT", "1" if fast else "0")
    specs, jspecs = specs_of(manifest, roam), specs_of(jax_manifest, roam)
    for i in (0, 3):
        r1, r2 = np.random.default_rng(i), np.random.default_rng(i)
        got = sample.train_sample(specs[i], cfg, r1)
        want = jax_sample.train_sample(jspecs[i], jcfg, r2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert r1.random() == r2.random()


@pytest.mark.parametrize("name", ["plain", "compact", "scale", "frames5"])
def test_test_sample_bitwise_as_jax_numpy_path(roam, jax_numpy, name):
    _, cfg, jcfg = sample_configs(name)
    specs, jspecs = specs_of(manifest, roam), specs_of(jax_manifest, roam)
    for g, w in zip(sample.test_sample(specs[1], cfg), jax_sample.test_sample(jspecs[1], jcfg)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fast", [True, False])
def test_train_sample_near_jax_native_path(roam, monkeypatch, fast):
    """The port's NumPy twins against the JAX package's default C++ path
    (f32 weights, where it builds): within IMAGE_TOL / FLOW_TOL; masks and
    occlusion exact."""
    monkeypatch.setenv("B2F_FAST_AUGMENT", "1" if fast else "0")
    monkeypatch.setenv(resample.TWINS_ENV, "1")
    _, cfg, jcfg = sample_configs("augment_fast")
    specs, jspecs = specs_of(manifest, roam), specs_of(jax_manifest, roam)
    for i in range(3):
        got = sample.train_sample(specs[i], cfg, np.random.default_rng(i))
        want = jax_sample.train_sample(jspecs[i], jcfg, np.random.default_rng(i))
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=IMAGE_TOL)
        np.testing.assert_allclose(got[1][..., :2], want[1][..., :2], rtol=0, atol=FLOW_TOL)
        np.testing.assert_array_equal(got[1][..., 2:], want[1][..., 2:])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=IMAGE_TOL)


def test_make_data_rejects_short_samples():
    cfg = sample.SampleConfig(fine_height=80, fine_width=96)
    z = np.zeros((64, 128, 9), np.float32)
    with pytest.raises(ValueError, match="smaller than the fine/crop size"):
        sample.make_data(z, z[..., :2], z[..., :2], z[..., 0], cfg, None)


def test_sample_config_from_options_as_jax():
    kw = dict(dataset="RoamingImages", ground_truth=True, augment=1, gaussian_noise=0.01,
              rand_crop=0, wire="compact", scale=0.5, frames=5)
    got = sample.SampleConfig.from_options(Options(**kw).derive())
    want = jax_sample.SampleConfig.from_options(JaxOptions(**kw).derive())
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.defer_normalize and not got.deterministic and got.ref0 == 2


def test_png_frames_never_reach_pil(roam, monkeypatch):
    """PNGs decode with the port's own codec; another format needs PIL
    and says so where it is missing."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    spec = specs_of(manifest, roam)[0]
    img = sample.default_image_loader(spec.image_paths(3)[0])
    assert img.shape == (H, W, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, jax_sample.default_image_loader(spec.image_paths(3)[0]))
    with pytest.raises(ImportError, match="only PNG frames decode without PIL"):
        sample.default_image_loader(str(roam / "frame.jpg"))


@pytest.mark.parametrize("key", ["images", "flow_gt", "occ_gt", "mask"])
def test_encode_batch_as_jax(key):
    rng = np.random.default_rng(6)
    batch = {"images": rng.random((2, 8, 16, 9), dtype=np.float32),
             "flow_gt": rng.standard_normal((2, 8, 16, 2)).astype(np.float32),
             "occ_gt": rng.choice(np.array([0, .5, 1], np.float32), size=(2, 8, 16, 2)),
             "mask": (rng.random((2, 8, 16)) > .5).astype(np.float32)}
    got, want = wire.encode_batch(batch, "compact"), jax_wire.encode_batch(batch, "compact")
    assert got[key].dtype == want[key].dtype
    np.testing.assert_array_equal(got[key], want[key])
    assert wire.encode_batch(batch, "f32") is batch
    with pytest.raises(ValueError, match="unknown wire format"):
        wire.encode_batch(batch, "f16")


# ---------------------------------------------------------------------- loader

LOADER_REGIMES = {     # PrefetchLoader keyword arguments beyond the dataset
    "random": dict(),
    "scene_k2": dict(scene_batches=2),
    "cyclic_fill": dict(scene_batches=1_000_000_000, batch_size=8),
    "sweep": dict(scene_batches=1_000_000_000),
    "sequential": dict(sequential=True, train=False, batch_size=2),
    "epoch3": dict(epoch=3),
    "shard": dict(shard=(1, 2)),
}


def build_loaders(roam, regime, n_workers, mode, **cfg_over):
    """The port's and the JAX package's loaders over the first 5 scenes,
    B=4, 3 batches; `cfg_over` overrides SampleConfig fields."""
    kw = {**dict(batch_size=4, n_batches=3, manual_seed=7), **LOADER_REGIMES[regime]}
    epoch = kw.pop("epoch", None)
    train = kw.pop("train", True)
    cfg_kw = {**dict(frames=3, ground_truth=True, augment=1, fine_height=48, fine_width=96,
                     load_height=56, load_width=112), **cfg_over}
    out = []
    for pkg, man in ((data, manifest), (jax_data, jax_manifest)):
        ds = pkg.FlowDataset(specs_of(man, roam), pkg.SampleConfig(**cfg_kw),
                             indices=np.arange(5), train=train)
        ld = pkg.PrefetchLoader(ds, n_workers=n_workers, worker_mode=mode, **kw)
        if epoch is not None:
            ld.set_epoch(epoch)
        out.append(ld)
    return out


@pytest.mark.parametrize("regime", sorted(LOADER_REGIMES))
@pytest.mark.parametrize("mode", ["sync", "thread"])
def test_loader_batches_bitwise_as_jax(roam, jax_numpy, mode, regime):
    port, jax_ld = build_loaders(roam, regime, 0 if mode == "sync" else 2, "thread")
    got, want = list(port), list(jax_ld)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    assert port.epoch == jax_ld.epoch


def test_loader_epochs_advance_and_replay(roam):
    port, _ = build_loaders(roam, "random", 0, "thread")
    e0, e1 = list(port), list(port)
    assert not np.array_equal(e0[0]["images"], e1[0]["images"])
    port.set_epoch(1)
    for g, w in zip(port, e1):
        assert_batches_equal(g, w)


def test_sweep_and_fill_cover_scenes_as_documented(roam):
    """The sweep's remainder favours the leading scenes (copied as it is):
    batch b holds scenes [bB, (b+1)B) mod n every epoch."""
    port, _ = build_loaders(roam, "sweep", 0, "thread", augment=0, rand_crop=0)
    seen = [port._run_job(slot, 0) for slot in range(3)]
    again = [port._run_job(slot, 5) for slot in range(3)]
    for a, b in zip(seen, again):
        assert_batches_equal(a, b)
    fill, _ = build_loaders(roam, "cyclic_fill", 0, "thread", augment=0, rand_crop=0)
    b0 = fill._run_job(0, 0)["images"]
    np.testing.assert_array_equal(b0[0], b0[5])   # 5 scenes cycled into 8 slots


@pytest.mark.parametrize("start", ["fork", "spawn"])
def test_process_mode_matches_sync(roam, monkeypatch, start):
    monkeypatch.setenv("B2F_MP_START", start)
    proc, _ = build_loaders(roam, "scene_k2", 2, "process")
    sync, _ = build_loaders(roam, "scene_k2", 0, "process")
    got = list(proc)
    assert len(got) == 3
    for g, w in zip(got, sync):
        assert_batches_equal(g, w)


def test_start_method_follows_cuda():
    assert not loader._cuda_live()   # no CUDA context in the tests


def test_deterministic_sample_memo(roam):
    """With nothing drawn (augment 0, rand_crop 0) samples are memoized:
    replaying an epoch in sync mode loads nothing."""
    cfg = sample.SampleConfig(frames=3, ground_truth=True, fine_height=48, fine_width=96,
                              rand_crop=0)
    ds = loader.FlowDataset(specs_of(manifest, roam), cfg, indices=np.arange(5))
    memo = loader.PrefetchLoader(ds, batch_size=4, n_batches=3, n_workers=0,
                                 scene_batches=1_000_000_000)
    assert ds.deterministic and memo._sample_cache is not None
    first = list(memo)
    calls = []
    orig = ds.load
    ds.load = lambda i, rng=None: (calls.append(i), orig(i, rng))[1]
    memo.set_epoch(0)
    for g, w in zip(memo, first):
        assert_batches_equal(g, w)
    assert not calls


def _boom(path):
    raise OSError("decode failed")


def _die(path):
    os._exit(7)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_worker_error_propagates(roam, monkeypatch, mode):
    monkeypatch.setenv("B2F_MP_START", "fork")
    port, _ = build_loaders(roam, "random", 2, mode)
    port.dataset.image_loader = _boom
    with pytest.raises((OSError, RuntimeError), match="decode failed"):
        list(port)


def test_dead_worker_is_detected(roam, monkeypatch):
    monkeypatch.setenv("B2F_MP_START", "fork")
    port, _ = build_loaders(roam, "random", 2, "process")
    port.dataset.image_loader = _die
    with pytest.raises(RuntimeError, match="loader worker died"):
        list(port)


def test_unpicklable_dataset_under_spawn_is_diagnosed(roam, monkeypatch):
    monkeypatch.setenv("B2F_MP_START", "spawn")
    port, _ = build_loaders(roam, "random", 2, "process")
    port.dataset.image_loader = lambda path: None
    with pytest.raises(RuntimeError, match="not picklable"):
        list(port)


# ------------------------------------------------------------- device_prefetch

def test_device_prefetch_on_cpu(roam):
    port, _ = build_loaders(roam, "random", 0, "thread")
    host = list(port)
    pulled = []

    def source():
        for b in host:
            pulled.append(1)
            yield b

    it = loader.device_prefetch(source(), "cpu", depth=2)
    first = next(it)
    assert len(pulled) == 3    # depth batches in flight beyond the one handed out
    got = [first, *it]
    assert len(got) == len(host)
    for g, w in zip(got, host):
        assert sorted(g) == sorted(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


# ------------------------------------------------------------------- generator

def test_generator_files_byte_identical_to_jax_tool(tmp_path, jax_numpy):
    spec = importlib.util.spec_from_file_location("make_roaming_jax",
                                                  ROOT / "tools" / "make_roaming.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = ["--n", "3", "--height", str(H), "--width", str(W), "--frames", "7",
            "--val_fraction", "0.34", "--seed", "4"]
    roaming.main(["--out", str(tmp_path / "port"), *args])
    tool.main(["--out", str(tmp_path / "jax"), *args])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == 2 + 3 * (7 + 1 + 3)   # manifests; frames, flow, occ 3/5/7
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_generator_workers_write_the_same_files(tmp_path):
    """Scenes rendered by spawned processes (`main(argv, workers)`) are
    byte for byte the serial run's: each depends only on (seed, index)."""
    args = ["--n", "3", "--height", "32", "--width", "64", "--frames", "3",
            "--val_fraction", "0.34", "--seed", "5"]
    roaming.main(["--out", str(tmp_path / "serial"), *args])
    roaming.main(["--out", str(tmp_path / "pool"), *args], workers=2)
    files = sorted(p.relative_to(tmp_path / "serial")
                   for p in (tmp_path / "serial").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "pool")
                           for p in (tmp_path / "pool").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "pool" / rel).read_bytes() == (tmp_path / "serial" / rel).read_bytes()


def test_generator_cli(tmp_path):
    res = subprocess.run([sys.executable, "-m", "back2future_tpu_torch.data.roaming", "--out",
                          str(tmp_path), "--n", "2", "--height", "32", "--width", "64",
                          "--frames", "3"], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert res.returncode == 0, res.stderr
    specs = manifest.load_manifest(tmp_path / "datasets" / "RoamingImages.dat", True,
                                   root=str(tmp_path / "data"))
    assert [s.ref for s in specs] == [2, 2]
    assert all(Path(p).exists() for s in specs for p in s.image_paths(3))
    assert all(Path(p).exists() for p in specs[0].occ_paths(3))
