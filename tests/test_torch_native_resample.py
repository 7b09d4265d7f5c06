"""The port's C++ host resampler (runtime/src/resample.cc, reached through
data/resample.py and data/augment.py) and the threaded median filter of
runtime/src/getocc.cc, on seeded numpy inputs at 64x128 and one KITTI
frame stack (375x1242x9 -> 320x1216).

Each of the six C++ entry points is held bit for bit against the JAX
package's library (back2future_tpu/runtime/src/resample.cc, which the JAX
package's own calls reach by default), and against the port's NumPy twins
(`resample.numpy_twins()`) within tests/test_torch_data.py's IMAGE_TOL
and FLOW_TOL, nearest and rotate exactly; the two row-threaded resizes
and `get_occ` give the same bits at 1, 2, 3 and 7 threads; `preprocess`
leaves the generator as its twin does; a train sample, a sync-mode batch
and the generator's files of the port on its default path equal the JAX
package's on its default path; a broken `resample.cc` fails its build
loudly.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import back2future_tpu.data as jax_data
from back2future_tpu.data import augment as jax_augment
from back2future_tpu.data import manifest as jax_manifest
from back2future_tpu.data import resample as jax_resample
from back2future_tpu.data import sample as jax_sample
from back2future_tpu.io import occ as jax_occ
import back2future_tpu_torch.data as data
from back2future_tpu_torch.data import augment, manifest, resample, roaming, sample
from back2future_tpu_torch.io import occ
from back2future_tpu_torch.runtime import host_build

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 128
IMAGE_TOL = 1e-5      # as tests/test_torch_data.py: normalised images
FLOW_TOL = 1e-6       # resized [0, 1] rasters and flow / flownet_factor
THREADS = (1, 2, 3, 7)


@pytest.fixture(autouse=True)
def default_paths(monkeypatch):
    """Both packages on their default (C++) paths, whatever the caller's
    environment says."""
    monkeypatch.delenv(resample.TWINS_ENV, raising=False)
    assert jax_resample._native_lib() is not None, "the JAX package's resampler did not build"


def raster(seed, h=H, w=W, c=3):
    return np.random.default_rng(seed).random((h, w, c), dtype=np.float32)


def twin(fn, *args, **kw):
    with resample.numpy_twins():
        return fn(*args, **kw)


def assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ full-plane

RESIZES = [   # (h, w, c, out_h, out_w)
    (H, W, 3, 97, 203), (H, W, 3, 32, 64), (H, W, 1, 37, 91), (H, W, 2, 64, 200),
    (H, W, 9, 48, 96), (63, 127, 9, 128, 256), (7, 5, 2, 13, 3), (H, W, 3, 1, 5),
    (H, W, 3, 2, 129),
]


@pytest.mark.parametrize("mode", ["bilinear", "simple"])
@pytest.mark.parametrize("case", RESIZES, ids=lambda c: "x".join(map(str, c)))
def test_resize_bitwise_as_jax_library_and_near_twin(case, mode):
    h, w, c, oh, ow = case
    x = raster(sum(case), h, w, c)
    got = resample.resize(x, oh, ow, mode)
    assert_bitwise(got, jax_resample.resize(x, oh, ow, mode))
    want = twin(resample.resize, x, oh, ow, mode)
    assert want.dtype == np.float32 and want.shape == (oh, ow, c)
    if mode == "simple":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL)


@pytest.mark.parametrize("mode", ["bilinear", "simple"])
def test_resize_squeeze_passthrough_and_dtypes_as_jax(mode):
    x2 = raster(1)[..., 0]
    assert_bitwise(resample.resize(x2, 80, 50, mode), jax_resample.resize(x2, 80, 50, mode))
    same = resample.resize(x2, H, W, mode)
    assert_bitwise(same, x2)
    assert same is not x2
    # other dtypes take the NumPy path in both packages
    for dt in (np.float64, np.uint8):
        xd = (raster(2) * 200).astype(dt)
        assert_bitwise(resample.resize(xd, 50, 70, mode), jax_resample.resize(xd, 50, 70, mode))
    with pytest.raises(ValueError, match="unknown resize mode"):
        resample.resize(raster(3), 10, 10, "cubic")


@pytest.mark.parametrize("mode", ["bilinear", "simple"])
def test_kitti_frame_stack_resize(mode, monkeypatch):
    """One KITTI frame stack to the serving size: bitwise as JAX's
    library at every thread count (`OMP_NUM_THREADS`, which
    `host_threads()` reads), within FLOW_TOL of the twin."""
    x = raster(4, 375, 1242, 9)
    want = jax_resample.resize(x, 320, 1216, mode)
    for t in THREADS:
        monkeypatch.setenv("OMP_NUM_THREADS", str(t))
        assert_bitwise(resample.resize(x, 320, 1216, mode), want)
    np.testing.assert_allclose(twin(resample.resize, x, 320, 1216, mode), want, rtol=0,
                               atol=FLOW_TOL if mode == "bilinear" else 0)


@pytest.mark.parametrize("mode", ["bilinear", "simple"])
@pytest.mark.parametrize("out_h", [1, 2, 3, 6, 7, 8, 97])
def test_resize_thread_counts_agree(mode, out_h, monkeypatch):
    """Heights below the thread count leave threads without rows."""
    x = raster(out_h, 9, 20, 3)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    one = resample.resize(x, out_h, 33, mode)
    for t in THREADS[1:] + (64,):
        monkeypatch.setenv("OMP_NUM_THREADS", str(t))
        assert_bitwise(resample.resize(x, out_h, 33, mode), one)


@pytest.mark.parametrize("h, w", [(1, 9), (2, 5), (7, 40), (H, W)])
def test_get_occ_thread_counts_agree(h, w, monkeypatch):
    rng = np.random.default_rng(h * w)
    depth = rng.uniform(1, 5, size=(h, w))
    flow = np.round(rng.uniform(-4, 4, size=(h, w, 2)) * 2) / 2
    want = jax_occ._native_get_occ(depth, flow)
    for t in THREADS:
        monkeypatch.setenv("OMP_NUM_THREADS", str(t))
        np.testing.assert_array_equal(occ.get_occ(depth, flow), want)


def test_host_threads_as_openmp(monkeypatch):
    import os

    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    assert host_build.host_threads() == len(os.sched_getaffinity(0))
    monkeypatch.setenv("OMP_NUM_THREADS", "3,2")
    assert host_build.host_threads() == 3
    monkeypatch.setenv("OMP_NUM_THREADS", "5")
    assert host_build.host_threads() == 5


# ------------------------------------------------------------- windowed

WINDOWS = {   # name -> (call, exact against the twin)
    "rotate": (lambda m, s: m.rotate_nearest_window(s, 0.21, -3, 5, 40, 70, True, False), True),
    "rotate_flipv": (lambda m, s: m.rotate_nearest_window(s, -0.4, 7, -2, 50, 60, False, True),
                     True),
    "rotate_outside": (lambda m, s: m.rotate_nearest_window(s, 1.3, -20, 100, 30, 50, True, True),
                       True),
    "rotate_whole": (lambda m, s: m.rotate_nearest_window(s, 0.0, 0, 0, H, W), True),
    "bilinear": (lambda m, s: m.resize_bilinear_window(s, H, W, 100, 190, 11, 17, 40, 80), False),
    "bilinear_buf": (lambda m, s: m.resize_bilinear_window(s[5:40, 9:90], H, W, 100, 190, 11, 17,
                                                           40, 80, by0=5, bx0=9), False),
    "bilinear_flips": (lambda m, s: m.resize_bilinear_window(s, H, W, 90, 170, 3, 4, 50, 60,
                                                             flip_h=True, flip_v=True), False),
    "bilinear_edge": (lambda m, s: m.resize_bilinear_window(s, H, W, 101, 203, 61, 150, 40, 53),
                      False),
    "nearest": (lambda m, s: m.resize_nearest_window(s, 100, 190, 11, 17, 40, 80, True, True),
                True),
    "nearest_edge": (lambda m, s: m.resize_nearest_window(s, 99, 201, 59, 141, 40, 60), True),
}


@pytest.mark.parametrize("c", [1, 2, 3, 9])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_windowed_bitwise_as_jax_library_and_near_twin(name, c):
    src = raster(c + 10, c=c)
    fn, exact = WINDOWS[name]
    got = fn(resample, src)
    assert_bitwise(got, fn(jax_resample, src))
    want = twin(fn, resample, src)
    np.testing.assert_allclose(got, want, rtol=0, atol=0 if exact else FLOW_TOL)


# ---------------------------------------------------------- photometric

@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("c", [3, 9, 15])
def test_preprocess_bitwise_as_jax_and_rng_as_twin(c, normalize):
    img = raster(c, c=c)
    r_port, r_jax, r_twin = (np.random.default_rng(c) for _ in range(3))
    got = augment.preprocess(img, r_port, normalize)
    assert_bitwise(got, jax_augment.preprocess(img, r_jax, normalize))
    want = twin(augment.preprocess, img, r_twin, normalize)
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_TOL)
    assert r_port.bit_generator.state == r_twin.bit_generator.state == \
        r_jax.bit_generator.state
    np.testing.assert_array_equal(img, raster(c, c=c))   # the input is untouched


def test_preprocess_gates_as_jax():
    """Float64 input, C % 3 != 0 and more than 64 frame groups take the
    NumPy path in both packages."""
    for img in (raster(1).astype(np.float64), raster(2, 8, 8, 195)):
        r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
        assert_bitwise(augment.preprocess(img, r1), jax_augment.preprocess(img, r2))
        assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("ops", [(0,), (1,), (2,), (2, 0, 1), (1, 2, 0)])
def test_photo_pipeline_entry_bitwise_as_jax_library(ops):
    """photo_pipeline_f32 called directly, each op alone and in orders,
    with lighting and normalisation switched separately."""
    import ctypes

    fp = ctypes.POINTER(ctypes.c_float)
    rgb = np.array([0.01, -0.02, 0.005], np.float32)
    order = np.array(ops, np.int64)
    alphas = np.linspace(0.97, 1.03, len(ops))
    for lighting, norm in ((0, 0), (1, 0), (1, 1)):
        outs = []
        for lib in (resample.native_lib(), jax_resample._native_lib()):
            img = raster(len(ops), c=9)
            lib.photo_pipeline_f32(
                img.ctypes.data_as(fp), H, W, 9,
                order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                alphas.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ops),
                rgb.ctypes.data_as(fp), lighting, augment.IMAGENET_MEAN.ctypes.data_as(fp),
                augment.IMAGENET_STD.ctypes.data_as(fp), norm)
            outs.append(img)
        assert_bitwise(*outs)


# ------------------------------------------------- samples, batches, files

@pytest.fixture(scope="module")
def roam(tmp_path_factory):
    root = tmp_path_factory.mktemp("roam_native")
    roaming.main(["--out", str(root), "--height", str(H), "--width", str(W), "--max_speed", "5",
                  "--n", "5", "--frames", "3", "--val_fraction", "0.2"])
    return root


def specs_of(pkg, root):
    return pkg.load_manifest(root / "datasets" / "RoamingImages.dat", ground_truth=True,
                             root=str(root / "data"))


CFG = dict(frames=3, ground_truth=True, augment=1, fine_height=48, fine_width=96,
           load_height=56, load_width=112)


@pytest.mark.parametrize("fast", [True, False])
def test_train_sample_bitwise_as_jax_default_path(roam, monkeypatch, fast):
    monkeypatch.setenv("B2F_FAST_AUGMENT", "1" if fast else "0")
    specs, jspecs = specs_of(manifest, roam), specs_of(jax_manifest, roam)
    for i in range(3):
        r1, r2 = np.random.default_rng(i), np.random.default_rng(i)
        got = sample.train_sample(specs[i], sample.SampleConfig(**CFG), r1)
        want = jax_sample.train_sample(jspecs[i], jax_sample.SampleConfig(**CFG), r2)
        for g, w in zip(got, want):
            assert_bitwise(g, w)
        assert r1.random() == r2.random()


def test_sync_batches_bitwise_as_jax_default_path(roam):
    loaders = []
    for pkg, man in ((data, manifest), (jax_data, jax_manifest)):
        ds = pkg.FlowDataset(specs_of(man, roam), pkg.SampleConfig(**CFG),
                             indices=np.arange(4), train=True)
        loaders.append(pkg.PrefetchLoader(ds, batch_size=2, n_batches=2, manual_seed=7,
                                          n_workers=0))
    got, want = (list(ld) for ld in loaders)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert_bitwise(g[k], w[k])


def test_generator_files_byte_identical_to_jax_tool_on_default_paths(tmp_path):
    spec = importlib.util.spec_from_file_location("make_roaming_jax_native",
                                                  ROOT / "tools" / "make_roaming.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = ["--n", "2", "--height", str(H), "--width", str(W), "--frames", "3",
            "--val_fraction", "0.5", "--seed", "6"]
    roaming.main(["--out", str(tmp_path / "port"), *args])
    tool.main(["--out", str(tmp_path / "jax"), *args])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


# ----------------------------------------------------------------- build

def test_resample_build_failure_raises(tmp_path, monkeypatch):
    src = (host_build.SRC_DIR / "resample.cc").read_text()
    (tmp_path / "resample.cc").write_text(src.replace("extern \"C\" {", "extern \"C\" { oops", 1))
    (tmp_path / "parallel_rows.h").write_text((host_build.SRC_DIR / "parallel_rows.h").read_text())
    monkeypatch.setattr(host_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(host_build, "_LIBS", {})
    monkeypatch.setattr(resample, "_LIB", None)
    with pytest.raises(RuntimeError, match="host build of resample failed"):
        resample.resize(raster(0), 10, 20)
    assert not list((tmp_path / "_build").glob("*.so"))
    # no silent fallback to the twins: every float32 entry raises the same way
    with pytest.raises(RuntimeError, match="host build of resample failed"):
        augment.preprocess(raster(0), np.random.default_rng(0))
