"""Build a CUDA source of the port with nvcc at first use and load it
with ctypes.

Each `csrc/*.cu` file has a plain C interface; it is compiled for sm_90a
into `build/vslam_tpu_torch/lib<stem>_<hash>.so` (the hash covers the
source and the flags, so an edited source rebuilds) and loaded with
ctypes.  `CudaLibrary.start` begins the nvcc run in the background, so
several sources compile at once; `load` waits for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vslam_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


class CudaLibrary:
    """One csrc/*.cu source, its nvcc build and the loaded ctypes handle.

    `build_log` holds nvcc's output (register and shared-memory use, from
    -Xptxas -v) and `build_seconds` the time from `start` to the load."""

    def __init__(self, source: str):
        self.src = CSRC / source
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None
        self._proc = None
        self._t0 = None

    def _target(self) -> Path:
        tag = hashlib.sha256(self.src.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.src.stem}_{tag}.so"

    def start(self) -> "CudaLibrary":
        """Begin the nvcc build unless it is built, loaded or under way."""
        if self._lib is not None or self._t0 is not None:
            return self
        self._t0 = time.perf_counter()
        so = self._target()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            self._tmp = so.with_suffix(f".{os.getpid()}.tmp")
            self._proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(self._tmp), str(self.src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        return self

    def load(self) -> ctypes.CDLL:
        """The loaded library; builds it first if needed (raises if nvcc fails)."""
        if self._lib is not None:
            return self._lib
        self.start()
        so = self._target()
        if self._proc is not None:
            self.build_log = self._proc.communicate()[0]
            failed = self._proc.returncode != 0
            self._proc = None
            if failed:
                self._t0 = None
                raise RuntimeError(f"nvcc failed for {self.src}:\n{self.build_log}")
            os.replace(self._tmp, so)
        self.build_seconds = time.perf_counter() - self._t0
        self._lib = ctypes.CDLL(str(so))
        return self._lib
