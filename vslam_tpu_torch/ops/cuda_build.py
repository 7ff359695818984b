"""Build a C/CUDA source of the port at first use, load it with ctypes,
and launch and count its kernels.

Each `csrc/*.cu` file has a plain C interface; it is compiled for sm_90a
into `build/vslam_tpu_torch/lib<stem>_<hash>.so` (the hash covers the
source, every `csrc/*.cuh` header it may include, and the flags, so an
edited source or header rebuilds) and loaded with ctypes.
`CudaLibrary.start` begins the nvcc run in the background, so several
sources compile at once; `load` waits for it.  `HostLibrary` does the
same for a host-only `csrc/*.cpp` source with the host compiler (g++).
A build writes a per-process temporary file and renames it into place,
so processes that build the same source at once do not collide; `load`
is thread-safe.

`CudaKernel` is every hand-written kernel's wrapper: a source's
`<symbol>_launch` and `<symbol>_occupancy` entry points, called on the
current stream, their errors raised, and each launch counted under the
kernel's name.  A kernel registers its counter when it is made;
`counters()` holds them all (ops/program.py withholds a capture's
launches from them and adds them back at each replay).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vslam_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _cuda_tool(name: str) -> str | None:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    return path if os.path.exists(path) else None


def nvcc() -> str:
    path = _cuda_tool("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def loop_shared_loads(sass: str, kernel: str) -> int:
    """Shared-memory loads (LDS*) in the largest loop of `kernel` in a
    `cuobjdump -sass` listing: the pixel loop, so the loads of one pixel
    when that loop is not unrolled.  `kernel` is a substring of the
    mangled name; raises KeyError if no function matches."""
    body = None
    for block in sass.split("Function : ")[1:]:
        if kernel in block.split("\n", 1)[0]:
            body = block
            break
    if body is None:
        raise KeyError(kernel)
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = 0
    for addr, text in ins:
        br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if br and int(br.group(1), 16) < addr:  # a backward branch closes a loop
            start = int(br.group(1), 16)
            n = sum(1 for a, t in ins if start <= a <= addr
                    and re.match(r"(@!?U?P\w+\s+)?LDS\b", t))
            best = max(best, n)
    return best


class CudaLibrary:
    """One csrc/*.cu source, its nvcc build and the loaded ctypes handle.

    `build_log` holds nvcc's output (register and shared-memory use, from
    -Xptxas -v)."""

    flags = NVCC_FLAGS

    def __init__(self, source: str):
        self.src = CSRC / source
        self.build_log = ""
        self._lib = None
        self._proc = None
        self._started = False
        self._lock = threading.Lock()

    def compiler(self) -> str:
        return nvcc()

    def _target(self) -> Path:
        digest = hashlib.sha256(self.src.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
        digest.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.src.stem}_{digest.hexdigest()[:16]}.so"

    def start(self) -> "CudaLibrary":
        """Begin the nvcc build unless it is built, loaded or under way."""
        if self._lib is not None or self._started:
            return self
        self._started = True
        so = self._target()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            self._tmp = so.with_suffix(f".{os.getpid()}.tmp")
            self._proc = subprocess.Popen(
                [self.compiler(), *self.flags, "-o", str(self._tmp), str(self.src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        return self

    def load(self) -> ctypes.CDLL:
        """The loaded library; builds it first if needed (raises if the
        compiler fails)."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is not None:
                return self._lib
            self.start()
            so = self._target()
            if self._proc is not None:
                self.build_log = self._proc.communicate()[0]
                failed = self._proc.returncode != 0
                self._proc = None
                if failed:
                    self._started = False
                    raise RuntimeError(f"{Path(self.compiler()).name} failed for "
                                       f"{self.src}:\n{self.build_log}")
                os.replace(self._tmp, so)
            self._lib = ctypes.CDLL(str(so))
        return self._lib

    def sass(self) -> str:
        """`cuobjdump -sass` of the built library (raises RuntimeError if
        the toolkit has no cuobjdump)."""
        tool = _cuda_tool("cuobjdump")
        if tool is None:
            raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin)")
        self.load()
        return subprocess.run([tool, "-sass", str(self._target())], capture_output=True,
                              text=True, check=True, timeout=300).stdout


class HostLibrary(CudaLibrary):
    """A host-only csrc/*.cpp source with a plain C interface, built with
    the host compiler (g++, or $CXX) into the same cache."""

    flags = HOST_FLAGS

    def compiler(self) -> str:
        path = shutil.which(os.environ.get("CXX", "g++"))
        if path is None:
            raise RuntimeError("no host C++ compiler found (g++ or $CXX)")
        return path


# Every CudaKernel by name, in the order they were made.
_KERNELS: dict[str, "CudaKernel"] = {}
# One CudaLibrary a source, shared by the kernels it holds.
_LIBRARIES: dict[str, CudaLibrary] = {}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def counters() -> dict:
    """The launch counter of every kernel of the process, by name."""
    return dict(_KERNELS)


class CudaKernel:
    """One kernel of a csrc/*.cu source with a plain C interface:

        int <symbol>_launch(<launch_args>..., cudaStream_t, int device);
        int <symbol>_occupancy(<occupancy_args>..., int *blocks, int device);

    both returning a cudaError_t.  The argument types are letters: "p" a
    pointer, "i" an int, "f" a float.  `launches` goes up by one each time
    the kernel is launched, and nowhere else (`batches` counts the same
    launches by batch size); the kernels of one source share one build
    (`library`).
    A name is taken once a process."""

    def __init__(self, name: str, source: str, symbol: str, launch_args: str,
                 occupancy_args: str = ""):
        if name in _KERNELS:
            raise ValueError(f"a CUDA kernel named {name!r} exists")
        self.name, self.symbol = name, symbol
        self.launch_args, self.occupancy_args = launch_args, occupancy_args
        self.launches = 0
        self.batches = Counter()
        if source not in _LIBRARIES:
            _LIBRARIES[source] = CudaLibrary(source)
        self.library = _LIBRARIES[source]
        self._entries = None  # the bound (launch, occupancy) functions
        _KERNELS[name] = self

    def build(self) -> ctypes.CDLL:
        """Compile the source with nvcc (once per source version), load it
        and declare the entry points' signatures."""
        lib = self.library.load()
        if self._entries is None:
            entries = []
            for suffix, args in (("launch", self.launch_args),
                                 ("occupancy", self.occupancy_args)):
                fn = getattr(lib, f"{self.symbol}_{suffix}")
                fn.restype = ctypes.c_int
                fn.argtypes = [_CTYPES[c] for c in args + "pi"]  # + stream or int*, device
                entries.append(fn)
            self._entries = tuple(entries)
        return lib

    def blocks_per_sm(self, device: torch.device, *template_args: int) -> int:
        """Resident blocks of the instantiation `template_args` selects on
        one SM of `device`."""
        self.build()
        n = ctypes.c_int(0)
        err = self._entries[1](*template_args, ctypes.byref(n), device.index)
        if err != 0:
            raise RuntimeError(f"{self.name} occupancy query failed: cudaError {err}")
        return n.value

    def _launch(self, device: torch.device, batch: int, *args) -> None:
        """One launch on `device`'s current stream, counted at `batch`."""
        self.build()
        err = self._entries[0](*args, torch.cuda.current_stream(device).cuda_stream,
                               device.index)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1
        self.batches[batch] += 1
