"""The CUDA sources' inputs that the CPU can check: the compiled-in
pattern tables, the build cache's key, the wrappers' refusals and the
SASS load counter.  (The kernels themselves run only on the card:
tests/test_torch_cuda.py.)"""

import os
import re
import shutil
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vslam_tpu_torch.frontend import dense_brief as db
from vslam_tpu_torch.frontend import detect  # noqa: F401  (registers fast_cells)
from vslam_tpu_torch.frontend import fast_brief as fb
from vslam_tpu_torch.frontend import orb
from vslam_tpu_torch.ops import cuda_build
from vslam_tpu_torch.ops import hamming

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _header_array(name: str, shape) -> np.ndarray:
    text = db.HEADER.read_text()
    decl = r"constexpr [\w ]+ " + name + r"\[[^=]*=\s*\{(.*?)\n\};"
    body = re.search(decl, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)]).reshape(shape)


def test_pattern_header_holds_the_tables_bit_for_bit():
    tables = _header_array("kBriefPattern", (17, 256, 4))
    np.testing.assert_array_equal(tables, db.TABLES.reshape(17, 256, 4))
    np.testing.assert_array_equal(tables[0], fb.PATTERN.reshape(256, 4))
    assert np.abs(tables).max() <= 13  # the kernels' halo


def test_pattern_header_is_the_generated_text():
    assert db.HEADER.read_text() == db.pattern_header()


@pytest.mark.parametrize("table", range(17))
def test_header_bit_order_is_a_permutation_with_few_live_taps(table):
    order = _header_array("kBriefOrder", (17, 256))[table]
    assert sorted(order) == list(range(256))
    assert db.live_taps(db.TABLES[table], order) <= 12
    assert db.live_taps(db.TABLES[table], range(256)) > 60  # the pattern's own order


def test_library_target_changes_when_a_header_changes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    lib = cuda_build.CudaLibrary("dense_brief.cu")
    first = lib._target()
    assert first == cuda_build.CudaLibrary("dense_brief.cu")._target()
    (csrc / "brief_patterns.cuh").write_text(
        (csrc / "brief_patterns.cuh").read_text().replace("{0, 2, -1, -5}", "{0, 2, -1, -4}", 1))
    second = lib._target()
    assert second != first
    (csrc / "brief_core.cuh").write_text((csrc / "brief_core.cuh").read_text() + "\n")
    assert lib._target() not in (first, second)
    assert cuda_build.CudaLibrary("fast_brief_frontend.cu")._target().name.startswith(
        "libfast_brief_frontend_")


@pytest.mark.parametrize("table,band,dtype,ok", [
    (0, 8, torch.float32, True), (16, 8, torch.float32, True),
    (0, 64, torch.bfloat16, True), (3, 16, torch.float32, False),
    (3, 8, torch.bfloat16, False), (17, 8, torch.float32, False),
    (0, 4, torch.float32, False), (0, 8, torch.float16, False),
])
def test_dense_wrapper_takes_only_built_instantiations(table, band, dtype, ok):
    if ok:
        db.KERNEL._check(table, band, dtype)
        assert db.KERNEL.sass_name(table, band, dtype).startswith("dense_brief_kernelILi")
    else:
        with pytest.raises(ValueError):
            db.KERNEL._check(table, band, dtype)


def test_loop_shared_loads_counts_the_pixel_loop():
    sass = """
        Function : _ZN12_GLOBAL__N_122fast_brief_tile_kernelEPKfS1_iiiiiiiPiPfS3_S2_
        /*0000*/                   LDS R4, [R2+0x10] ;
        /*0010*/                   LDS.64 R4, [R2] ;
        /*0020*/              @P0 LDS R5, [R2+0x20] ;
        /*0030*/                   STS [R2], R5 ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   LDS R6, [R3] ;
        /*0060*/                   LDS.U.128 R8, [R3+0x40] ;
        /*0070*/                   BRA 0x60 ;
        /*0080*/                   EXIT ;
        Function : other
        /*0000*/                   BRA 0x0 ;
"""
    assert cuda_build.loop_shared_loads(sass, fb.K1.sass_name) == 2
    assert cuda_build.loop_shared_loads(sass, "other") == 0
    with pytest.raises(KeyError):
        cuda_build.loop_shared_loads(sass, "missing")


def _c_signatures(source) -> dict:
    """{function: argument letters} of the `extern "C"` functions of a
    csrc source: "p" a pointer, "i" an int, "f" a float."""
    text = (cuda_build.CSRC / source).read_text()
    out = {}
    for fn, params in re.findall(r'extern "C" int\s+(\w+)\(([^)]*)\)', text):
        out[fn] = "".join("p" if "*" in a else a.split()[0][0] for a in params.split(","))
        assert all("*" in a or a.split()[0] in ("int", "float") for a in params.split(",")), \
            (fn, params)
    return out


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "fast_cells", "box_blur",
                                  "hamming_match"])
def test_kernel_signatures_match_their_sources(name):
    """Each registered kernel's ctypes signatures, declared as data, are
    its source's C interface: the launch's and the occupancy query's
    arguments, then the stream (or the blocks pointer) and the device."""
    kernel = cuda_build.counters()[name]
    c = _c_signatures(kernel.library.src.name)
    assert c[f"{kernel.symbol}_launch"] == kernel.launch_args + "pi"
    assert c[f"{kernel.symbol}_occupancy"] == kernel.occupancy_args + "pi"


def test_a_cuda_kernel_counts_its_launches_and_raises_on_a_cuda_error(monkeypatch):
    """CudaKernel's one launch call passes the arguments, the current
    stream and the device index; a cudaError raises naming the kernel and
    counts nothing; a launch that succeeds counts once at its batch size.
    Kernels of one source share its build, and a name is taken once."""
    monkeypatch.setattr(cuda_build, "_KERNELS", dict(cuda_build._KERNELS))
    k = cuda_build.CudaKernel("probe", "box_blur.cu", "box_blur", "piiiip", "i")
    assert cuda_build.counters()["probe"] is k and k.library is orb.BOX_BLUR.library
    assert db.K2.library is db.K3.library is db.K4.library
    with pytest.raises(ValueError, match="probe"):
        cuda_build.CudaKernel("probe", "fast_cells.cu", "fast_cells", "ppiiiiiipp", "i")
    calls, err = [], [700]
    monkeypatch.setattr(k, "build", lambda: None)
    monkeypatch.setattr(k, "_entries", (lambda *a: calls.append(a) or err[0],
                                        lambda *a: calls.append(a) or err[0]))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=42))
    dev = torch.device("cuda", 3)
    with pytest.raises(RuntimeError, match="probe launch failed: cudaError 700"):
        k._launch(dev, 2, 11, 2)
    assert k.launches == 0 and not k.batches
    err[0] = 0
    k._launch(dev, 2, 11, 2)
    assert calls[-1] == (11, 2, 42, 3) and k.launches == 1 and k.batches == Counter({2: 1})
    err[0] = 2
    with pytest.raises(RuntimeError, match="probe occupancy query failed: cudaError 2"):
        k.blocks_per_sm(dev, 7)
    assert calls[-1][0] == 7 and calls[-1][2] == 3 and k.launches == 1


def _match_inputs(Q=70, D=90, A=None):
    g = torch.Generator().manual_seed(Q * D)
    q_uv = torch.rand((Q, 2) if A is None else (A, Q, 2), generator=g) * 100
    d_uv4 = torch.rand(D, 4, generator=g) * 100
    desc = torch.randint(-2**31, 2**31 - 1, (Q + D, 8), dtype=torch.int32, generator=g)
    q_mask = torch.rand(q_uv.shape[:-1], generator=g) < 0.9
    return (q_uv, desc[:Q], q_mask, d_uv4[:, :2], desc[Q:], torch.rand(D, generator=g) < 0.9)


def test_hamming_match_refuses_cpu_inputs_and_cpu_matching_never_launches(monkeypatch):
    """The kernel takes CUDA tensors only and raises before any build on a
    CPU input; match_stereo / match_projective on CPU tensors run the
    plain version and never reach the kernel."""
    from vslam_tpu_torch.frontend import matching

    k = hamming.HAMMING_MATCH
    q_uv, q_desc, q_mask, d_uv, d_desc, d_mask = _match_inputs()

    def refuse(*args, **kwargs):
        raise AssertionError("the matching kernel ran on CPU tensors")

    monkeypatch.setattr(k, "build", refuse)
    with pytest.raises(ValueError, match="CUDA"):
        k.match(k.STEREO, q_uv[None], q_desc, q_mask, d_uv, d_desc, d_mask, (1.5, 0.0, 200.0),
                60)
    monkeypatch.setattr(k, "match", refuse)
    n0 = k.launches
    s = matching.match_stereo(q_uv, q_desc, q_mask, d_uv, d_desc, d_mask, 256, 99.0, -99.0,
                              99.0)
    p = matching.match_projective(q_uv, q_desc, q_mask, d_uv, d_desc, d_mask, 30.0, 256)
    assert k.launches == n0 and s.valid.any() and p.valid.any()


@pytest.mark.parametrize("x, dtype, want", [
    (60, torch.int32, 60.0), (2**40, torch.int32, 0.0), (2**31 + 5, torch.int32, -(2**31 - 5)),
    (59.999999999, torch.int32, 60.0), (1.50000001, torch.float32, 1.5),
    (1e40, torch.float32, float("inf")), (-3, torch.float32, -3.0),
])
def test_hamming_match_number_gates_compare_as_torch_does(x, dtype, want):
    """A number gate is passed as the value torch compares with: rounded
    to f32, an int distance gate first wrapped to int32."""
    got = hamming.HAMMING_MATCH._gate(x, 1, torch.device("cpu"), dtype, "g")
    assert got[:2] == (0, 0) and (got[2] == want or (got[2] - want) / want < 1e-6)
    ref = torch.tensor([60], dtype=torch.int32) <= x if dtype == torch.int32 \
        else torch.tensor([1.5], dtype=torch.float32) <= x
    assert bool(ref) == (60.0 <= got[2] if dtype == torch.int32 else 1.5 <= got[2])


def test_hamming_match_launch_arguments(monkeypatch):
    """What the wrapper hands the kernel past its device check: the
    descriptors' strides (row-major, or word-major as BRIEF256R's banks
    give them), strided uv rows, a mask shared by the problems, tensor
    gates by pointer with one value a problem, the partial buffer's size;
    and what it refuses."""
    k = hamming.HAMMING_MATCH
    calls = []
    monkeypatch.setattr(k, "_launch", lambda dev, batch, *args: calls.append((batch, args)))
    q_uv, q_desc, q_mask, d_uv, d_desc, d_mask = _match_inputs(A=3)
    radius = torch.tensor([5.0, 6.0, 7.0])
    gate = torch.tensor([40, 50, 60], dtype=torch.int32)
    idx, valid, best = k._match(k.PROJECTIVE, q_uv, q_desc, q_mask[0], d_uv, d_desc, d_mask,
                                (radius, 0.0, 0.0), gate)
    assert idx.shape == valid.shape == best.shape == (3, 70)
    assert (idx.dtype, valid.dtype, best.dtype) == (torch.int32, torch.bool, torch.int32)
    batch, a = calls[-1]
    assert batch == 3 and a[:4] == (k.PROJECTIVE, 3, 70, 90)
    assert a[5:7] == (8, 1) and a[13:15] == (8, 1)  # descriptor strides
    assert a[8:10] == (140, 2) and a[11] == 0 and a[16] == 4  # uv strides, shared mask
    assert a[18:21] == (radius.data_ptr(), 1, 0.0) and a[21:27] == (0, 0, 0.0, 0, 0, 0.0)
    assert a[27:30] == (gate.data_ptr(), 1, 0.0)
    assert a[31] == 3 * (2 * 70 + 2 * 90)  # ceil(90 / 64) x 70 + ceil(70 / 64) x 90, a problem
    word_major = q_desc.t().contiguous().t()
    k._match(k.STEREO, q_uv[:1], word_major, q_mask[:1], d_uv, d_desc, d_mask,
             (torch.tensor(1.5), 0.0, 2**40), torch.tensor(60, dtype=torch.int32))
    a = calls[-1][1]
    assert a[5:7] == (1, 70) and a[11] == 70 and a[19] == 0
    assert a[26] == float(np.float32(2**40))
    bad = [
        (q_uv.double(), q_desc, q_mask, d_uv, d_desc, d_mask),
        (q_uv, q_desc[:, :4], q_mask, d_uv, d_desc, d_mask),
        (q_uv, q_desc.long(), q_mask, d_uv, d_desc, d_mask),
        (q_uv, q_desc, q_mask.int(), d_uv, d_desc, d_mask),
        (q_uv, q_desc, q_mask, d_uv.t().contiguous().t(), d_desc, d_mask),
        (q_uv, q_desc, q_mask, d_uv, d_desc, d_mask[:-1]),
        (q_uv[..., :1], q_desc, q_mask, d_uv, d_desc, d_mask),
        (q_uv, q_desc, q_mask[:, ::2].repeat(1, 2)[:, :70].t().contiguous().t(), d_uv, d_desc,
         d_mask),
    ]
    n = len(calls)
    for args in bad:
        with pytest.raises(ValueError):
            k._match(k.PROJECTIVE, *args, (radius, 0.0, 0.0), gate)
    for g0, h in ((radius.double(), gate), (radius[:2], gate), (radius, gate.float()),
                  (radius, True), (radius, "60")):
        with pytest.raises(ValueError):
            k._match(k.PROJECTIVE, q_uv, q_desc, q_mask, d_uv, d_desc, d_mask, (g0, 0.0, 0.0), h)
    assert len(calls) == n
