"""Device times of the port's kernels and the bounds they are held to.

chip_smoke.py times every kernel with these helpers.  Run as a module,
it times an earlier design of K1 and of the dense BRIEF kernel beside
this checkout's, on the same card, in turns (earlier, this, this,
earlier), warm and with L2 flushed:

    python -m vslam_tpu_torch.frontend.kernel_timing --earlier DIR [--out FILE]

DIR holds the earlier fast_brief_frontend.cu and dense_brief.cu, with the
C interface they had before the pattern tables were compiled in (a
device pattern pointer for K1; dense_brief_set_patterns for the dense
kernel), e.g. from `git show <commit>:vslam_tpu_torch/csrc/<file>`.

Bounds: the least time the card could take is the larger of the bytes
the function must move (each input read once, each output written once)
over the memory rate, and its f32 operations over the f32 rate (NVIDIA
H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s without tensor cores).  The
shared-load floor is the distinct pattern taps a pixel reads from shared
memory at one 32-lane load per SM and clock.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations a pixel: 256 BRIEF compares; FAST's 16 ring taps x 8
# (two compares, two differences, two clamps, two sums) + 3; the blur's
# 4 adds, 4 FMAs (2 each) and 2 multiplies; NMS's 9 maxima and a compare.
K1_OPS_PER_PIXEL = 256 + 16 * 8 + 3 + 4 + 8 + 2 + 10
DENSE_OPS_PER_PIXEL = 256
# The staged detector's kernel (csrc/fast_cells.cu): FAST's 16 ring taps
# x 8 and NMS's 8 compares a pixel; its shared loads a pixel: the ring and
# the centre, and the 3x3 window.
FAST_CELLS_OPS_PER_PIXEL = 16 * 8 + 8
FAST_CELLS_TAPS = 17 + 9


def box_blur_work(B: int, H: int, W: int, radius: int) -> tuple[int, int]:
    """(bytes, f32 operations) the box blur kernel (csrc/box_blur.cu)
    needs for a (B, H, W) stack at `radius`: each f32 pixel read once and
    written once (8 bytes), 3k operations at k = 2r + 1 (k - 1 adds, k
    FMAs, one multiply)."""
    px = B * H * W
    return 8 * px, 3 * (2 * radius + 1) * px


def box_blur_taps(radius: int) -> float:
    """Shared loads an output pixel of the box blur kernel's design at
    `radius`, for its shared-load floor: the vertical pass sums k words
    for each of a 128-column tile's 128 + 2r halo-wide columns, and the
    FMA chain reads k."""
    k = 2 * radius + 1
    return k * (128 + 2 * radius) / 128 + k


def cuda_ms(fn, runs: int = 20, setup=None) -> float:
    """Median device time of fn() in ms, after a warm-up: CUDA events
    around fn alone.  Before each timed call the card spins for ~0.1 ms,
    so fn's kernels are queued before its start event fires and the time
    is the card's, not the host's enqueue; `setup` runs before the spin
    (an L2 flush)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        torch.cuda._sleep(200_000)  # GPU clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def l2_flush(device, mib: int = 128):
    """A callable that writes `mib` MiB (over twice the H100's 50 MB L2),
    so the next kernel finds its inputs in HBM."""
    scratch = torch.empty(mib << 18, dtype=torch.float32, device=device)
    return lambda: scratch.fill_(1.0)


def k1_work(B: int, H: int, W: int) -> tuple[int, int]:
    """(bytes, f32 operations) K1 needs for a (B, H, W) stack."""
    n_bands, Wo = -(-H // 16), -(-W // 128) * 128
    px = B * H * W
    nbytes = 4 * px + 4 + 4 * 8 * px + 4 * px + 2 * 4 * B * n_bands * Wo
    return nbytes, K1_OPS_PER_PIXEL * px


def dense_work(B: int, H: int, W: int, itemsize: int = 4) -> tuple[int, int]:
    """(bytes, f32 operations) the dense kernel needs for a (B, H, W) stack."""
    px = B * H * W
    return itemsize * px + 4 * 8 * px, DENSE_OPS_PER_PIXEL * px


def fast_cells_work(B: int, H: int, W: int, bin_size: int) -> tuple[int, int]:
    """(bytes, f32 operations) the staged detector's kernel needs for a
    (B, H, W) stack: each pixel read once, each cell's score and index
    written once."""
    px = B * H * W
    return 4 * px + 8 * B * (H // bin_size) * (W // bin_size), FAST_CELLS_OPS_PER_PIXEL * px


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations": which sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def distinct_taps(pattern: np.ndarray) -> int:
    """Distinct (dr, dc) points of a (256, 2, 2) pattern."""
    return len({tuple(p) for p in np.asarray(pattern).reshape(-1, 2)})


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def smem_floor_ms(pixels: int, taps: int, device=0) -> float:
    """Shared-load floor: `taps` 4-byte loads a pixel at 32 lanes per SM
    and clock on every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 1e3 * pixels * taps / (sms * 32 * sm_clock_hz())


# ---------------------------------------------------------------------------
# The earlier design beside this one
# ---------------------------------------------------------------------------


def _earlier_kernels(directory: str):
    """Build the earlier K1 and dense kernel from `directory` (their own
    C interfaces) and return launch functions matching this checkout's."""
    from vslam_tpu_torch.frontend import cuda_build, dense_brief, fast_brief

    libs = {}
    for stem in ("fast_brief_frontend", "dense_brief"):
        so = os.path.join(str(cuda_build.BUILD_DIR), f"earlier_{stem}.so")
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                        os.path.join(directory, f"{stem}.cu")], check=True,
                       capture_output=True, text=True)
        libs[stem] = ctypes.CDLL(so)
    k1 = libs["fast_brief_frontend"].fast_brief_frontend_launch
    k1.restype = ctypes.c_int
    k1.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int]
    dn = libs["dense_brief"]
    dn.dense_brief_set_patterns.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    dn.dense_brief_launch.restype = ctypes.c_int
    dn.dense_brief_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    tables = np.ascontiguousarray(dense_brief.TABLES.reshape(-1, 256, 4).astype(np.int8))
    if dn.dense_brief_set_patterns(tables.ctypes.data, len(tables), 0) != 0:
        raise RuntimeError("earlier dense kernel: pattern upload failed")
    pat = torch.from_numpy(fast_brief.PATTERN.reshape(256, 4).copy()).cuda()

    def k1_launch(imgs, thr):
        B, H, W = imgs.shape
        nb, Wo = -(-H // 16), -(-W // 128) * 128
        out = (torch.empty((B, 8, H, W), dtype=torch.int32, device="cuda"),
               torch.empty((B, H, W), device="cuda"),
               torch.empty((B, nb, Wo), device="cuda"),
               torch.empty((B, nb, Wo), dtype=torch.int32, device="cuda"))
        err = k1(imgs.data_ptr(), thr.data_ptr(), pat.data_ptr(), B, H, W, 9, 20, 16,
                 *(o.data_ptr() for o in out), torch.cuda.current_stream().cuda_stream, 0)
        if err:
            raise RuntimeError(f"earlier K1 launch failed: cudaError {err}")
        return out

    def dense_launch(smooth, table):
        B, H, W = smooth.shape
        planes = torch.empty((B, 8, H, W), dtype=torch.int32, device="cuda")
        err = dn.dense_brief_launch(smooth.data_ptr(), 0, B, H, W, table, 8,
                                    planes.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream, 0)
        if err:
            raise RuntimeError(f"earlier dense launch failed: cudaError {err}")
        return planes

    return k1_launch, dense_launch


def compare_with_earlier(directory: str) -> dict:
    """Time the earlier and this checkout's kernels at the main-path shapes,
    in turns; check that both give the same words."""
    from vslam_tpu_torch.frontend import dense_brief as db
    from vslam_tpu_torch.frontend import fast_brief as fb

    old_k1, old_dense = _earlier_kernels(directory)
    rng = np.random.default_rng(0)

    def u8(*shape):
        return torch.from_numpy(np.round(rng.uniform(0, 255, shape)).astype(np.float32)).cuda()

    imgs, thr = u8(2, 376, 1241), torch.tensor([18.0], device="cuda")
    cases = {"K1": (lambda: old_k1(imgs, thr), lambda: fb.K1.launch(imgs, thr, 9, 20, 16))}
    # K2 a pair at 376 x 1241, K3 one 188 x 620 level, K4 one bank (5) at 480 x 752.
    for name, (sm, table) in {"K2": (u8(2, 376, 1241), 0), "K3": (u8(1, 188, 620), 0),
                              "K4": (u8(1, 480, 752), 6)}.items():
        cases[name] = (lambda sm=sm, t=table: (old_dense(sm, t),),
                       lambda sm=sm, t=table: (db.KERNEL.launch(sm, t),))
    flush = l2_flush("cuda")
    out = {}
    for name, (old, new) in cases.items():
        for a, b in zip(old(), new()):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: the earlier and this design differ")
        row = {"earlier_ms": [], "ms": [], "earlier_cold_ms": [], "cold_ms": []}
        for fn, key in ((old, "earlier"), (new, "this"), (new, "this"), (old, "earlier")):
            pre = "earlier_" if key == "earlier" else ""
            row[pre + "ms"].append(cuda_ms(fn))
            row[pre + "cold_ms"].append(cuda_ms(fn, setup=flush))
        out[name] = row
        print(f"[earlier] {name}: " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                                                for k, v in row.items()), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True, help="directory of the earlier .cu files")
    ap.add_argument("--out", default="build/kernel_timing.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    t0 = time.perf_counter()
    result = {"card": card, "runs": compare_with_earlier(args.earlier)}
    result["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
