"""The port's flow I/O (back2future_tpu_torch.io) and host C++ helpers
(runtime/host_build.py) against the JAX package's back2future_tpu.io, on
seeded numpy inputs: files written by one package are byte-identical to
the other's and read back equal in both; `get_occ` and the PNG de-filter
agree exactly with the JAX package's native library and its Python
oracles."""

import struct
import zlib

import numpy as np
import pytest

from back2future_tpu.io import flow_io as jax_flow_io
from back2future_tpu.io import occ as jax_occ
from back2future_tpu.io import png16 as jax_png16
from back2future_tpu.io import transforms as jax_transforms
from back2future_tpu.io import viz as jax_viz
from back2future_tpu_torch import io as port_io
from back2future_tpu_torch.io import flow_io, occ, png16, transforms, viz
from back2future_tpu_torch.runtime import host_build

H, W = 64, 128


def _flow(seed, h=H, w=W, scale=20.0):
    return (np.random.default_rng(seed).standard_normal((h, w, 2)) * scale).astype(np.float32)


def test_io_exports_match_jax():
    import back2future_tpu.io as jax_io

    assert port_io.__all__ == jax_io.__all__


# ---------------------------------------------------------------- flow files

FLOW_FORMATS = {
    "flo": (lambda m, p, f: m.write_flo(p, f), lambda m, p: m.load_flo(p)),
    "pfm_le": (lambda m, p, f: m.write_pfm(p, f), lambda m, p: m.load_pfm(p)),
    "pfm_be": (lambda m, p, f: m.write_pfm(p, f, scale=1.0), lambda m, p: m.load_pfm(p)),
    "kitti_png": (lambda m, p, f: m.write_kitti_png(p, f, (f[..., 0] > 0)),
                  lambda m, p: m.load_kitti_png(p)),
    "disp": (lambda m, p, f: m.write_disp(p, f[..., 0]), lambda m, p: m.load_disp(p)),
}


@pytest.mark.parametrize("fmt", sorted(FLOW_FORMATS))
def test_flow_files_byte_identical_and_cross_read(tmp_path, fmt):
    write, read = FLOW_FORMATS[fmt]
    flow = _flow(1)
    ext = {"kitti_png": "png", "pfm_le": "pfm", "pfm_be": "pfm"}.get(fmt, fmt)
    port_path, jax_path = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
    write(flow_io, port_path, flow)
    write(jax_flow_io, jax_path, flow)
    assert port_path.read_bytes() == jax_path.read_bytes()
    for reader, path in ((flow_io, jax_path), (jax_flow_io, port_path), (flow_io, port_path)):
        got, want = read(reader, path), read(jax_flow_io, jax_path)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ext", ["flo", "pfm", "png"])
def test_load_flow_dispatch_matches_jax(tmp_path, ext):
    flow = _flow(2)
    path = tmp_path / f"f.{ext}"
    if ext == "png":
        jax_flow_io.write_kitti_png(path, flow)
    else:
        getattr(jax_flow_io, f"write_{ext}")(path, flow)
    got, want = flow_io.load_flow(path), jax_flow_io.load_flow(path)
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="unknown flow format"):
        flow_io.load_flow(tmp_path / "f.bin")


def test_golden_flo_reads_as_in_jax():
    from pathlib import Path

    golden = Path(__file__).parent / "golden" / "parity_flow.flo"
    np.testing.assert_array_equal(flow_io.load_flo(golden), jax_flow_io.load_flo(golden))


def test_bad_magic_raises(tmp_path):
    path = tmp_path / "bad.flo"
    path.write_bytes(struct.pack("<f", 1.0) + struct.pack("<ii", 1, 1) + b"\0" * 8)
    with pytest.raises(ValueError, match="bad .flo magic"):
        flow_io.load_flo(path)
    with pytest.raises(ValueError, match="bad .disp magic"):
        flow_io.load_disp(path)


# ------------------------------------------------------------------ PNG codec

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4])
def test_png_byte_identical_and_cross_read(tmp_path, dtype, channels):
    rng = np.random.default_rng(3)
    shape = (17, 23) if channels is None else (17, 23, channels)
    img = rng.integers(0, np.iinfo(dtype).max + 1, size=shape, dtype=np.int64).astype(dtype)
    png16.write_png(tmp_path / "port.png", img)
    jax_png16.write_png(tmp_path / "jax.png", img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    want = img if img.ndim == 3 else img[..., None]
    for reader in (png16, jax_png16):
        for name in ("port.png", "jax.png"):
            got = reader.read_png(tmp_path / name)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got, want)


def test_png_rejects_other_dtypes(tmp_path):
    with pytest.raises(TypeError):
        png16.write_png(tmp_path / "x.png", np.zeros((2, 2), np.float32))
    (tmp_path / "y.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png16.read_png(tmp_path / "y.png")


def _filter_rows(rows: np.ndarray, ftypes, bpp: int) -> np.ndarray:
    """PNG encoder filters (the forward of each de-filter type), byte by
    byte, for a small test image."""
    h, stride = rows.shape
    out = np.zeros((h, stride + 1), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        line = rows[y].astype(np.int32)
        ft = int(ftypes[y])
        out[y, 0] = ft
        for x in range(stride):
            a = line[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[y, 1 + x] = (line[x] - pred) & 0xFF
        prev = line
    return out


def _png_bytes(img: np.ndarray, ftypes) -> bytes:
    h, w, c = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    rows = (np.ascontiguousarray(img.astype(">u2")).view(np.uint8) if depth == 16
            else img).reshape(h, -1)
    raw = _filter_rows(rows, ftypes, max(1, c * depth // 8)).tobytes()

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint8, 3), (np.uint8, 4),
                                            (np.uint16, 1), (np.uint16, 3)])
def test_png_reads_all_five_filter_types(tmp_path, dtype, channels):
    """A PNG whose rows use filters 0-4 (None, Sub, Up, Average, Paeth),
    twice each, decodes to the image in both packages."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, np.iinfo(dtype).max + 1, size=(10, 9, channels),
                       dtype=np.int64).astype(dtype)
    path = tmp_path / "filters.png"
    path.write_bytes(_png_bytes(img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]))
    np.testing.assert_array_equal(png16.read_png(path), img)
    np.testing.assert_array_equal(jax_png16.read_png(path), img)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_cpp_defilter_matches_python(bpp):
    """The C++ de-filter against the Python oracle (in both packages),
    over random scanlines of all five filter types."""
    rng = np.random.default_rng(bpp)
    h, stride = 40, 12 * bpp
    lines = rng.integers(0, 256, size=(h, stride), dtype=np.uint8)
    ftypes = rng.integers(0, 5, size=h).astype(np.uint8)
    ftypes[:5] = [0, 1, 2, 3, 4]
    want = lines.copy()
    png16._defilter_python(want, ftypes, bpp)
    twin = lines.copy()
    jax_png16._defilter_python(twin, ftypes, bpp)
    np.testing.assert_array_equal(want, twin)
    got = lines.copy()
    png16._defilter(got, ftypes, bpp)
    np.testing.assert_array_equal(got, want)


def test_cpp_defilter_rejects_bad_filter_type():
    lines = np.zeros((2, 4), np.uint8)
    with pytest.raises(ValueError, match="bad PNG filter type"):
        png16._defilter(lines, np.array([0, 5], np.uint8), 1)


# ------------------------------------------------------------------- occlusion

def _occ_inputs(seed, h, w, ties: bool):
    rng = np.random.default_rng(seed)
    depth = rng.integers(1, 4, size=(h, w)).astype(np.float64)
    if ties:   # KITTI-like 1/64 quantisation: many exact .5 displacements
        flow = np.round(rng.uniform(-4, 4, size=(h, w, 2)) * 2) / 2
        flow[::3, ::2] = 0.5 * np.sign(rng.standard_normal((len(range(0, h, 3)),
                                                             len(range(0, w, 2)), 2)))
    else:
        flow = rng.uniform(-5, 5, size=(h, w, 2))
    return depth, flow


@pytest.mark.parametrize("ties", [False, True], ids=["random", "half_ties"])
def test_get_occ_matches_oracle_and_jax_native(ties):
    depth, flow = _occ_inputs(5, 24, 40, ties)
    if ties:
        assert (np.abs(flow - np.trunc(flow)) == 0.5).sum() > 100
    got = occ.get_occ(depth, flow)
    want = occ.get_occ_reference(depth, flow)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_occ.get_occ_reference(depth, flow), want)
    jax_native = jax_occ._native_get_occ(depth, flow)
    assert jax_native is not None, "the JAX package's getocc library did not build"
    np.testing.assert_array_equal(got, jax_native)
    assert set(np.unique(got)) <= {0.0, 0.5, 1.0}


def test_get_occ_at_size_matches_jax_native():
    depth, flow = _occ_inputs(6, H, W, ties=True)
    np.testing.assert_array_equal(occ.get_occ(depth, flow), jax_occ._native_get_occ(depth, flow))


# ------------------------------------------------------ viz and transforms

def test_viz_matches_jax():
    flow = _flow(7, 16, 24, scale=3.0)
    flow[0, :4] = [[0, 0], [0, 1], [1, 0], [0, -1]]
    u, v = flow[..., 0], flow[..., 1]
    np.testing.assert_array_equal(viz.compute_norm(u, v), jax_viz.compute_norm(u, v))
    np.testing.assert_array_equal(viz.compute_angle(u, v), jax_viz.compute_angle(u, v))
    for max_norm in (None, 2.0):
        got, got_mx = viz.xy2rgb(flow, max_norm)
        want, want_mx = jax_viz.xy2rgb(flow, max_norm)
        np.testing.assert_array_equal(got, want)
        assert got_mx == want_mx


@pytest.mark.parametrize("angle", [0.0, 0.3, -1.1])
def test_rotate_flow_matches_jax(angle):
    flow = _flow(8, 16, 24)
    np.testing.assert_array_equal(transforms.rotate_flow(flow, angle),
                                  jax_transforms.rotate_flow(flow, angle))


@pytest.mark.parametrize("order", ["simple", "bilinear"])
@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_scale_flow_matches_jax_numpy_path(monkeypatch, order, scale):
    import back2future_tpu.data.resample as jax_resample

    monkeypatch.setattr(jax_resample, "_native", (None,))
    flow = _flow(9, 16, 24)
    np.testing.assert_array_equal(transforms.scale_flow(flow, scale, order),
                                  jax_transforms.scale_flow(flow, scale, order))


# ----------------------------------------------------------- host build

def test_host_build_flags_and_cache():
    assert "-fopenmp" not in host_build.CXX_FLAGS
    assert set(host_build.CXX_FLAGS) == {"-O3", "-shared", "-fPIC", "-std=c++17"}
    for name in ("getocc", "pngfilter"):
        so = host_build.build(name)
        assert so.exists() and so.parent == host_build.BUILD_DIR
        assert host_build.build(name) == so == host_build.library_path(name)
        assert host_build.load_library(name) is host_build.load_library(name)


def test_host_build_failure_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(host_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="host build of broken failed"):
        host_build.load_library("broken")
    assert not list((tmp_path / "_build").glob("*.so"))
    (tmp_path / "fine.cc").write_text('extern "C" int f() { return 1; }\n')
    monkeypatch.setattr(host_build, "CXX", "no-such-compiler-b2f")
    with pytest.raises(RuntimeError, match="compiler not found"):
        host_build.load_library("fine")
