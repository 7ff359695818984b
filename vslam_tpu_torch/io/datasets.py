"""Dataset loaders: KITTI odometry, EuRoC MAV, TUM RGB-D, ICL-NUIM (port
of vslam_tpu/io/datasets.py).

Replaces the reference's srrg txt_io message-file playback
(SLAMAssembly::loadCamerasFromMessageFile + playbackMessageFile,
slam_assembly.cpp:99-206,343-492) with direct readers for the public
dataset layouts named in its configurations/ directory.  Each loader is
an iterator of frames (host numpy f32, as in the JAX package; the engine
uploads them) plus a CameraParams of host tensors (the engine moves it to
its device).  Images are decoded by io/image.py (no cv2), two threads
ahead of the consumer by up to eight frames, in order: zlib and the C
unfilter release the GIL, so decoding overlaps the engine's work.
"""

from __future__ import annotations

import collections
import csv
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from vslam_tpu_torch.io import image
from vslam_tpu_torch.io.image import equalize
from vslam_tpu_torch.ops import camera as cam_ops

DECODE_THREADS = 2
LOOK_AHEAD = 8  # frames decoded ahead of the consumer


@dataclass
class StereoFrame:
    img_left: np.ndarray  # (H, W) f32
    img_right: np.ndarray  # (H, W) f32 (depth_m for RGB-D datasets)
    timestamp: float
    index: int
    is_depth: bool = False


def imread_gray(path: str) -> np.ndarray:
    """A PNG/PGM file as (H, W) f32 gray levels (RGB becomes gray with
    the native decoder's weights)."""
    return image.decode_image(path).astype(np.float32)


def prefetch(loaders: list[Callable[[], StereoFrame]]) -> Iterator[StereoFrame]:
    """Run the frame loaders on DECODE_THREADS threads, LOOK_AHEAD frames
    ahead of the consumer, and yield their frames in order.  The pool is
    shut down (pending loads cancelled) when the consumer stops."""
    pool = ThreadPoolExecutor(max_workers=DECODE_THREADS, thread_name_prefix="decode")
    pending: collections.deque = collections.deque()
    todo = iter(loaders)
    try:
        for load in todo:
            pending.append(pool.submit(load))
            if len(pending) >= LOOK_AHEAD:
                break
        while pending:
            frame = pending.popleft().result()
            nxt = next(todo, None)
            if nxt is not None:
                pending.append(pool.submit(nxt))
            yield frame
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


# ---------------------------------------------------------------------------
# KITTI odometry
# ---------------------------------------------------------------------------


class KittiDataset:
    """KITTI odometry sequence directory:
    <seq>/image_0/*.png, image_1/*.png, times.txt, calib.txt."""

    def __init__(self, path: str, equalize_hist: bool = False):
        self.path = path
        self.equalize_hist = equalize_hist
        self.left, self.right = (
            sorted(os.path.join(path, d, f) for f in os.listdir(os.path.join(path, d))
                   if f.endswith(".png"))
            for d in ("image_0", "image_1"))
        times_file = os.path.join(path, "times.txt")
        self.times = (np.loadtxt(times_file).reshape(-1) if os.path.exists(times_file)
                      else np.arange(len(self.left)) * 0.1)
        self.cam = self._load_calib()

    def _load_calib(self) -> cam_ops.CameraParams:
        """Parse P0/P1 projection matrices (KITTI calib.txt)."""
        P = {}
        with open(os.path.join(self.path, "calib.txt")) as f:
            for line in f:
                key, _, rest = line.partition(":")
                vals = np.array(rest.split(), dtype=np.float64) if rest.strip() else []
                if len(vals) == 12:
                    P[key.strip()] = vals.reshape(3, 4)
        P0, P1 = P["P0"], P["P1"]
        baseline = -P1[0, 3] / P1[0, 0]  # the right camera's -fx*b entry
        rows, cols = image.decode_image(self.left[0]).shape
        return cam_ops.make_camera(P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2], baseline,
                                   rows=rows, cols=cols, device="cpu")

    def __len__(self):
        return len(self.left)

    def _frame(self, i: int) -> StereoFrame:
        il, ir = imread_gray(self.left[i]), imread_gray(self.right[i])
        if self.equalize_hist:
            il, ir = equalize(il), equalize(ir)
        return StereoFrame(il, ir, float(self.times[i]), i)

    def __iter__(self) -> Iterator[StereoFrame]:
        return prefetch([lambda i=i: self._frame(i) for i in range(len(self))])


# ---------------------------------------------------------------------------
# EuRoC MAV
# ---------------------------------------------------------------------------


class EurocDataset:
    """EuRoC mav0 layout: cam0/data/*.png + cam0/data.csv (+ cam1).

    EuRoC images are RAW (radial-tangential distorted, unrectified): when
    the per-camera sensor.yaml files are present, undistort+rectify maps
    are precomputed from them (io/rectification.py, the reference's
    initUndistortRectifyMap role, node.cpp:225-244) and applied to every
    frame; `cam` then holds the rectified intrinsics.  Without sensor.yaml
    the loader falls back to nominal rectified intrinsics on raw images
    and says so — accuracy will suffer."""

    def __init__(self, path: str, cam_params: Optional[cam_ops.CameraParams] = None):
        from vslam_tpu_torch.io import rectification

        self.base = path
        mav = os.path.join(path, "mav0") if os.path.isdir(os.path.join(path, "mav0")) else path
        self.cam0_dir = os.path.join(mav, "cam0", "data")
        self.cam1_dir = os.path.join(mav, "cam1", "data")
        self.entries = []
        with open(os.path.join(mav, "cam0", "data.csv")) as f:
            for row in csv.reader(f):
                if row and not row[0].startswith("#"):
                    self.entries.append((int(row[0]), row[1].strip()))
        self.rectifier = rectification.rectifier_from_euroc(mav)
        if cam_params is not None:
            self.cam = cam_params
        elif self.rectifier is not None:
            self.cam = self.rectifier.cam
        else:
            print("[euroc] no cam0/cam1 sensor.yaml found — feeding RAW "
                  "(distorted) images with nominal intrinsics")
            # EuRoC stereo (rectified nominal): fx 435.2, baseline 0.11 m.
            self.cam = cam_ops.make_camera(
                435.2046959714599, 435.2046959714599, 367.4517211914062,
                252.2008514404297, 0.110073808127187, rows=480, cols=752, device="cpu")

    def __len__(self):
        return len(self.entries)

    def _frame(self, i: int) -> StereoFrame:
        ts_ns, fname = self.entries[i]
        il = imread_gray(os.path.join(self.cam0_dir, fname))
        ir = imread_gray(os.path.join(self.cam1_dir, fname))
        if self.rectifier is not None:
            il, ir = self.rectifier.rectify(il, 0), self.rectifier.rectify(ir, 1)
        return StereoFrame(il, ir, ts_ns * 1e-9, i)

    def __iter__(self) -> Iterator[StereoFrame]:
        return prefetch([lambda i=i: self._frame(i) for i in range(len(self))])


# ---------------------------------------------------------------------------
# TUM RGB-D / ICL-NUIM
# ---------------------------------------------------------------------------


class TumRgbdDataset:
    """TUM RGB-D layout: rgb.txt + depth.txt (ts filename pairs), depth
    scale 1/5000 m per unit; ICL-NUIM uses the same layout."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, path: str, cam_params: Optional[cam_ops.CameraParams] = None,
                 max_dt: float = 0.02, depth_scale: Optional[float] = None):
        """depth_scale: meters per 16-bit depth unit.  None = the TUM PNG
        convention (1/5000).  The config key
        `depth_scale_factor_intensity_to_meters` (reference
        parameters.h:251) overrides it when explicitly set — e.g. 1e-3
        for millimeter-encoded xtion/ROS-bag exports."""
        self.depth_scale = float(depth_scale) if depth_scale else self.DEPTH_SCALE
        self.base = path
        rgb = self._parse_list(os.path.join(path, "rgb.txt"))
        depth = self._parse_list(os.path.join(path, "depth.txt"))
        # Associate rgb and depth by nearest timestamp.
        self.pairs = []
        d_ts = np.asarray([t for t, _ in depth])
        for t, f in rgb:
            j = int(np.argmin(np.abs(d_ts - t)))
            if abs(d_ts[j] - t) <= max_dt:
                self.pairs.append((t, f, depth[j][1]))
        # TUM fr1 defaults (freiburg1).
        self.cam = cam_params or cam_ops.make_camera(
            517.3, 516.5, 318.6, 255.3, 0.075, rows=480, cols=640, device="cpu")

    @staticmethod
    def _parse_list(path: str):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, fname = line.split()[:2]
                out.append((float(ts), fname))
        return out

    def __len__(self):
        return len(self.pairs)

    def _frame(self, i: int) -> StereoFrame:
        ts, rgb_f, depth_f = self.pairs[i]
        img = imread_gray(os.path.join(self.base, rgb_f))
        d16 = image.decode_image(os.path.join(self.base, depth_f))
        depth_m = d16.astype(np.float32) * self.depth_scale
        return StereoFrame(img, depth_m, ts, i, is_depth=True)

    def __iter__(self) -> Iterator[StereoFrame]:
        return prefetch([lambda i=i: self._frame(i) for i in range(len(self))])


def load_dataset(path: str, fmt: str, **kw):
    fmt = fmt.lower()
    if fmt == "kitti":
        return KittiDataset(path, **kw)
    if fmt == "euroc":
        return EurocDataset(path, **kw)
    if fmt in ("tum", "icl"):
        return TumRgbdDataset(path, **kw)
    raise ValueError(f"unknown dataset format '{fmt}' (kitti|euroc|tum|icl)")
