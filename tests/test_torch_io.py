"""The port's image decoder, histogram equalization, dataset loaders and
EuRoC rectification against cv2, the JAX package's native decoder and
the JAX loaders, on the CPU.

Tolerances:
  * decoder: bit-exact against cv2.imread and the native decoder on PNGs
    whose rows use all five filters (gray8, gray16, RGB8) and on 8- and
    16-bit PGM; the C unfilter bit-exact against the plain per-byte
    version; RGB8 -> gray exact against the native weights and within 1
    gray level of cv2's IMREAD_GRAYSCALE (its own fixed-point weights);
  * equalize: bit-exact against cv2.equalizeHist;
  * KITTI frames bit-exact against the JAX loader on both of its decode
    routes (native library pinned, and pinned absent: the cv2 route);
    TUM depth bit-exact; TUM intensity exact against the native route,
    within 1 gray level of the cv2 route;
  * rectification: R0, R1, P0, P1 within 1e-6 relative of
    cv2.stereoRectify (measured 4e-14), maps within 1e-3 px of
    cv2.initUndistortRectifyMap (measured: equal), the rectified images
    within 0 gray levels of the JAX EuRoC loader (cv2.remap: measured
    equal), the rectified camera's fx, cx and baseline within 1e-6
    relative of the JAX loader's.
"""

import os
import struct
import subprocess
import zlib

import cv2
import numpy as np
import pytest
import torch
import yaml

from vslam_tpu.io import datasets as jds
from vslam_tpu.io import rectification as jrect
from vslam_tpu.utils import native
from vslam_tpu_torch.io import datasets as tds
from vslam_tpu_torch.io import image
from vslam_tpu_torch.io import rectification as trect

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(7)


# ---------------------------------------------------------------------------
# A small PNG / PGM writer (cv2 writes only the Sub filter)
# ---------------------------------------------------------------------------


def write_png(path, arr, filters=(0, 1, 2, 3, 4), color=None, interlace=0):
    """arr (h, w) uint8/uint16 gray or (h, w, 3) uint8 RGB, through the
    port's writer; `color` and `interlace` overwrite its header's fields,
    for the formats the decoder refuses."""
    buf = image.encode_png(arr, filters)
    if color is not None or interlace:
        ihdr = bytearray(buf[16:29])
        ihdr[9] = ihdr[9] if color is None else color
        ihdr[12] = interlace
        buf = buf[:8] + image._png_chunk(b"IHDR", bytes(ihdr)) + buf[33:]
    with open(path, "wb") as f:
        f.write(buf)


def write_pgm(path, arr):
    maxval = 65535 if arr.dtype == np.uint16 else 255
    h, w = arr.shape
    body = arr.astype(">u2").tobytes() if arr.dtype == np.uint16 else arr.tobytes()
    with open(path, "wb") as f:
        f.write(f"P5\n# a comment\n{w} {h}\n{maxval}\n".encode() + body)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The native decoder, built privately from native/src (a lazy build
    elsewhere in the run may race or be missing)."""
    so = tmp_path_factory.mktemp("native") / "libvslam_native.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17",
                    os.path.join(REPO, "native", "src", "vslam_native.cpp"), "-o", str(so),
                    "-shared", "-lz", "-lpthread"], check=True, timeout=300)
    return str(so)


@pytest.fixture(params=["native", "cv2"])
def jax_route(request, monkeypatch, native_lib):
    """Pin the JAX loaders' decode route: the native library, or none
    (they then read with cv2)."""
    if request.param == "native":
        monkeypatch.setattr(native, "_SO_PATH", native_lib)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_lib_tried", False)
        assert native.get_lib() is not None
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
@pytest.mark.parametrize("filters", [(0, 1, 2, 3, 4), (4,), (3, 1)])
def test_png_decoder_matches_cv2_and_native(tmp_path, native_lib, monkeypatch, kind, filters):
    shape = {"gray8": (61, 77), "gray16": (45, 50), "rgb8": (40, 53, 3)}[kind]
    dtype = np.uint16 if kind == "gray16" else np.uint8
    arr = RNG.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / f"{kind}.png")
    write_png(path, arr, filters)
    got = image.decode_image(path)
    monkeypatch.setattr(native, "_SO_PATH", native_lib)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    nat = native.decode_image(path)
    assert got.dtype == nat.dtype == (np.uint16 if kind == "gray16" else np.uint8)
    np.testing.assert_array_equal(got, nat)
    if kind == "rgb8":
        np.testing.assert_array_equal(got, image.rgb_to_gray(arr))
        diff = np.abs(got.astype(int) - cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(int))
        assert diff.max() <= 1
    else:
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_png_decoder_reads_cv2_written_files(tmp_path):
    g8 = RNG.integers(0, 256, (33, 70), dtype=np.uint8)
    g16 = RNG.integers(0, 65536, (20, 31), dtype=np.uint16)
    for name, arr in (("g8", g8), ("g16", g16)):
        cv2.imwrite(str(tmp_path / f"{name}.png"), arr)
        np.testing.assert_array_equal(image.decode_image(str(tmp_path / f"{name}.png")), arr)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pgm_decoder_matches_cv2_and_native(tmp_path, native_lib, monkeypatch, dtype):
    arr = RNG.integers(0, np.iinfo(dtype).max + 1, (23, 41)).astype(dtype)
    path = str(tmp_path / "img.pgm")
    write_pgm(path, arr)
    got = image.decode_image(path)
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    monkeypatch.setattr(native, "_SO_PATH", native_lib)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    np.testing.assert_array_equal(got, native.decode_image(path))


@pytest.mark.parametrize("bpp,stride", [(1, 37), (2, 64), (3, 45)])
def test_c_unfilter_matches_plain_version(bpp, stride):
    """Every filter through the C unfilter, bit-exact against the
    per-byte version on random scanlines; an unknown filter type raises
    naming it."""
    h = 25
    raw = RNG.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(h) % 5
    ref = image.unfilter_reference(raw.reshape(-1), h, stride, bpp)
    np.testing.assert_array_equal(image.unfilter(raw.reshape(-1), h, stride, bpp), ref)
    raw[h - 2, 0] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        image.unfilter(raw.reshape(-1), h, stride, bpp)


@pytest.mark.parametrize("case", ["rgba", "palette", "gray+alpha", "rgb16", "interlaced",
                                  "jpeg", "bad filter"])
def test_unsupported_images_raise_naming_the_format(tmp_path, case):
    path = str(tmp_path / "img")
    if case == "jpeg":
        cv2.imwrite(path + ".jpg", RNG.integers(0, 256, (8, 8), dtype=np.uint8))
        path += ".jpg"
        match = "not a PNG"
    elif case == "bad filter":
        arr = RNG.integers(0, 256, (4, 6), dtype=np.uint8)
        write_png(path, arr, filters=(0,))
        buf = bytearray(open(path, "rb").read())
        raw = bytearray(zlib.decompress(bytes(buf[33 + 8:-12])))
        raw[0] = 7
        data = zlib.compress(bytes(raw))
        head = bytes(buf[:33])
        with open(path, "wb") as f:
            f.write(head + struct.pack(">I", len(data)) + b"IDAT" + data
                    + struct.pack(">I", zlib.crc32(b"IDAT" + data)) + bytes(buf[-12:]))
        match = "filter type 7"
    else:
        color, arr, match = {
            "rgba": (6, RNG.integers(0, 256, (4, 6, 3), dtype=np.uint8), "RGBA"),
            "palette": (3, RNG.integers(0, 256, (4, 6), dtype=np.uint8), "palette"),
            "gray+alpha": (4, RNG.integers(0, 256, (4, 6), dtype=np.uint8), "gray\\+alpha"),
            "rgb16": (2, RNG.integers(0, 65536, (4, 6), dtype=np.uint16), "RGB at 16 bits"),
            "interlaced": (0, RNG.integers(0, 256, (4, 6), dtype=np.uint8), "interlaced"),
        }[case]
        write_png(path, arr, color=color, interlace=int(case == "interlaced"))
    with pytest.raises(ValueError, match=match):
        image.decode_image(path)


def test_missing_image_raises():
    with pytest.raises(FileNotFoundError):
        image.decode_image("/nonexistent/frame.png")


def test_equalize_matches_cv2():
    cases = [RNG.integers(0, 256, (64, 80), dtype=np.uint8),
             RNG.integers(40, 60, (50, 50), dtype=np.uint8),
             np.full((9, 9), 17, np.uint8),
             RNG.normal(128, 25, (120, 160)).clip(0, 255).astype(np.uint8),
             np.concatenate([np.zeros(100, np.uint8), np.full(3, 255, np.uint8)]).reshape(1, -1)]
    for img in cases:
        got = image.equalize(img.astype(np.float32))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, cv2.equalizeHist(img).astype(np.float32))


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """A 5-frame KITTI sequence: frames 0-2 written by cv2 (Sub rows),
    3-4 by the test writer with every filter."""
    root = tmp_path_factory.mktemp("kitti")
    for d in ("image_0", "image_1"):
        (root / d).mkdir()
    rng = np.random.default_rng(11)
    frames = []
    for t in range(5):
        pair = rng.integers(0, 256, (2, 48, 70), dtype=np.uint8)
        for side, img in zip(("image_0", "image_1"), pair):
            path = str(root / side / f"{t:06d}.png")
            cv2.imwrite(path, img) if t < 3 else write_png(path, img)
        frames.append(pair)
    np.savetxt(root / "times.txt", np.arange(5) * 0.1)
    with open(root / "calib.txt", "w") as f:
        f.write("P0: 500 0 35 0 0 501 24 0 0 0 1 0\n")
        f.write(f"P1: 500 0 35 {-500 * 0.4} 0 501 24 0 0 0 1 0\n")
        f.write("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    return root, frames


@pytest.mark.parametrize("equalize_hist", [False, True])
def test_kitti_loader_matches_jax(kitti_dir, jax_route, equalize_hist):
    root, written = kitti_dir
    port = tds.KittiDataset(str(root), equalize_hist=equalize_hist)
    ref = jds.KittiDataset(str(root), equalize_hist=equalize_hist)
    assert len(port) == len(ref) == 5
    for k in ("fx", "fy", "cx", "cy", "baseline_m"):
        assert float(getattr(port.cam, k)) == float(getattr(ref.cam, k))
    assert (port.cam.rows, port.cam.cols) == (ref.cam.rows, ref.cam.cols) == (48, 70)
    assert abs(float(port.cam.baseline_m) - 0.4) < 1e-6
    for fp, fj, pair in zip(port, ref, written):
        assert (fp.index, fp.timestamp) == (fj.index, fj.timestamp)
        assert fp.img_left.dtype == np.float32
        np.testing.assert_array_equal(fp.img_left, fj.img_left)
        np.testing.assert_array_equal(fp.img_right, fj.img_right)
        if not equalize_hist:
            np.testing.assert_array_equal(fp.img_left, pair[0])


def test_prefetch_keeps_order_and_stops_early(kitti_dir):
    root, written = kitti_dir
    ds = tds.KittiDataset(str(root))
    it = iter(ds)
    first = next(it)
    np.testing.assert_array_equal(first.img_left, written[0][0])
    it.close()  # the pool shuts down with loads still pending
    assert [f.index for f in ds] == list(range(5))


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A 4-frame TUM RGB-D sequence: RGB8 intensity (channels differ),
    16-bit depth at 5000 units per meter (written by cv2 and by the test
    writer)."""
    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(12)
    with open(root / "rgb.txt", "w") as fr, open(root / "depth.txt", "w") as fd:
        fr.write("# timestamp filename\n")
        fd.write("# timestamp filename\n")
        for t in range(4):
            rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
            d16 = rng.integers(0, 30000, (48, 64)).astype(np.uint16)
            if t % 2:
                write_png(str(root / "rgb" / f"{t}.png"), rgb)
                write_png(str(root / "depth" / f"{t}.png"), d16)
            else:
                cv2.imwrite(str(root / "rgb" / f"{t}.png"), rgb[..., ::-1])  # cv2 is BGR
                cv2.imwrite(str(root / "depth" / f"{t}.png"), d16)
            fr.write(f"{t * 0.1:.6f} rgb/{t}.png\n")
            fd.write(f"{t * 0.1 + 0.005:.6f} depth/{t}.png\n")
    return root


@pytest.mark.parametrize("depth_scale", [None, 1e-3])
def test_tum_loader_matches_jax(tum_dir, jax_route, depth_scale):
    port = tds.TumRgbdDataset(str(tum_dir), depth_scale=depth_scale)
    ref = jds.TumRgbdDataset(str(tum_dir), depth_scale=depth_scale)
    assert len(port) == len(ref) == 4
    assert float(port.cam.fx) == float(ref.cam.fx)
    for fp, fj in zip(port, ref):
        assert fp.is_depth and (fp.index, fp.timestamp) == (fj.index, fj.timestamp)
        np.testing.assert_array_equal(fp.img_right, fj.img_right)  # depth in meters
        if jax_route == "native":
            np.testing.assert_array_equal(fp.img_left, fj.img_left)
        else:
            assert np.abs(fp.img_left - fj.img_left).max() <= 1.0


def test_load_dataset_dispatch(kitti_dir, tum_dir):
    assert isinstance(tds.load_dataset(str(kitti_dir[0]), "KITTI"), tds.KittiDataset)
    assert isinstance(tds.load_dataset(str(tum_dir), "icl"), tds.TumRgbdDataset)
    with pytest.raises(ValueError, match="unknown dataset format"):
        tds.load_dataset(str(tum_dir), "bag")


# ---------------------------------------------------------------------------
# EuRoC rectification
# ---------------------------------------------------------------------------

K = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]])
DIST = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
K1 = np.array([[457.587, 0.0, 379.999], [0.0, 456.134, 255.238], [0.0, 0.0, 1.0]])
DIST1 = np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05])
SIZE = (752, 480)  # (cols, rows)
# EuRoC MH_01's body-from-camera extrinsics (cam0, cam1 sensor.yaml).
T_B_C0 = np.array([[0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
                   [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
                   [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
                   [0.0, 0.0, 0.0, 1.0]])
T_B_C1 = np.array([[0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
                   [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
                   [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
                   [0.0, 0.0, 0.0, 1.0]])


def _shifted(dx):
    T = np.eye(4)
    T[0, 3] = dx
    return T


@pytest.mark.parametrize("rig", ["euroc", "aligned"])
def test_stereo_rectify_matches_cv2(rig):
    K_b, D_b, T_b0, T_b1 = ((K1, DIST1, T_B_C0, T_B_C1) if rig == "euroc"
                            else (K, DIST, np.eye(4), _shifted(0.11)))
    T = np.linalg.inv(T_b1) @ T_b0
    ref = cv2.stereoRectify(K, DIST, K_b, D_b, SIZE, T[:3, :3], T[:3, 3].reshape(3, 1),
                            flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)[:4]
    got = trect.stereo_rectify(K, DIST, K_b, D_b, SIZE, T[:3, :3], T[:3, 3])
    for name, a, b in zip(("R0", "R1", "P0", "P1"), got, ref):
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-6 * scale, name
    for k, (Kc, Dc) in enumerate(((K, DIST), (K_b, D_b))):
        mu, mv = trect._build_map_numpy(Kc, Dc, got[k], got[2 + k], SIZE)
        cu, cv_ = cv2.initUndistortRectifyMap(Kc, Dc, ref[k], ref[2 + k], SIZE, cv2.CV_32FC1)
        assert np.abs(mu - cu).max() <= 1e-3 and np.abs(mv - cv_).max() <= 1e-3


def test_remap_matches_cv2():
    rng = np.random.default_rng(5)
    for h, w in ((480, 752), (37, 53)):
        img = rng.uniform(0, 255, (h, w)).astype(np.float32)
        mu = rng.uniform(-3, w + 2, (h, w)).astype(np.float32)
        mv = rng.uniform(-3, h + 2, (h, w)).astype(np.float32)
        np.testing.assert_array_equal(trect.remap_linear(img, mu, mv),
                                      cv2.remap(img, mu, mv, cv2.INTER_LINEAR))


def test_numpy_maps_match_cv2():
    """_build_map_numpy reproduces cv2.initUndistortRectifyMap (JAX's
    tests/test_rectification.py case)."""
    mu, mv = trect._build_map_numpy(K, DIST, np.eye(3), K.copy(), SIZE)
    cu, cv_ = cv2.initUndistortRectifyMap(K, DIST, np.eye(3), K.copy(), SIZE, cv2.CV_32FC1)
    np.testing.assert_allclose(mu, cu, atol=1e-3)
    np.testing.assert_allclose(mv, cv_, atol=1e-3)


def test_undistortion_transports_points():
    """A dot painted at the DISTORTED projection of a 3D point lands at the
    ideal pinhole projection after rectification (JAX's case)."""
    rig = trect.StereoRectifier.identity_test_rig(K, DIST, SIZE)
    raw = np.zeros((SIZE[1], SIZE[0]), np.float32)
    expected = []
    for X in np.array([[0.5, 0.2, 4.0], [-0.8, -0.3, 6.0], [0.1, 0.45, 3.0]]):
        x, y = X[0] / X[2], X[1] / X[2]
        xd, yd = trect._distort_radtan(x, y, DIST)
        raw[int(round(K[1, 1] * yd + K[1, 2])), int(round(K[0, 0] * xd + K[0, 2]))] = 255.0
        expected.append((K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]))
    out = rig.rectify(raw, 0)
    for ue, ve in expected:
        v, u = np.unravel_index(np.argmax(out), out.shape)
        assert abs(u - ue) < 1.5 and abs(v - ve) < 1.5, ((u, v), (ue, ve))
        out[max(v - 3, 0):v + 4, max(u - 3, 0):u + 4] = 0.0


def _write_sensor_yaml(path, K_, dist, T_BS):
    doc = {
        "sensor_type": "camera",
        "T_BS": {"rows": 4, "cols": 4, "data": [float(v) for v in T_BS.reshape(-1)]},
        "rate_hz": 20,
        "resolution": [SIZE[0], SIZE[1]],
        "camera_model": "pinhole",
        "intrinsics": [float(K_[0, 0]), float(K_[1, 1]), float(K_[0, 2]), float(K_[1, 2])],
        "distortion_model": "radial-tangential",
        "distortion_coefficients": [float(v) for v in dist],
    }
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    """A 2-frame EuRoC mav0 directory with MH_01's calibration."""
    root = tmp_path_factory.mktemp("euroc")
    mav = root / "mav0"
    for c in ("cam0", "cam1"):
        (mav / c / "data").mkdir(parents=True)
    _write_sensor_yaml(mav / "cam0" / "sensor.yaml", K, DIST, T_B_C0)
    _write_sensor_yaml(mav / "cam1" / "sensor.yaml", K1, DIST1, T_B_C1)
    rng = np.random.default_rng(3)
    with open(mav / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t in range(2):
            for c in ("cam0", "cam1"):
                cv2.imwrite(str(mav / c / "data" / f"{t}.png"),
                            rng.uniform(0, 255, (SIZE[1], SIZE[0])).astype(np.uint8))
            f.write(f"{1403636579763555584 + t * 50000000},{t}.png\n")
    return root


def test_euroc_loader_matches_jax(euroc_dir, jax_route):
    port = tds.EurocDataset(str(euroc_dir))
    ref = jds.EurocDataset(str(euroc_dir))
    assert port.rectifier is not None and ref.rectifier is not None
    for k in ("fx", "cx", "baseline_m"):
        a, b = float(getattr(port.cam, k)), float(getattr(ref.cam, k))
        assert abs(a - b) <= 1e-6 * abs(b), k
    assert abs(float(port.cam.baseline_m) - 0.11) < 0.01
    for fp, fj in zip(port, ref):
        assert fp.timestamp == fj.timestamp
        np.testing.assert_array_equal(fp.img_left, fj.img_left)
        np.testing.assert_array_equal(fp.img_right, fj.img_right)
    # The warp moved pixels (distortion is strong at the borders).
    raw = cv2.imread(str(euroc_dir / "mav0" / "cam0" / "data" / "0.png"), 0)
    assert np.abs(next(iter(port)).img_left - raw.astype(np.float32)).mean() > 1.0


def test_jax_rectifier_is_the_cv2_branch():
    """The JAX rectifier the parity tests compare with takes its cv2 branch
    here (its numpy branch builds another camera)."""
    assert jrect.cv2 is not None
