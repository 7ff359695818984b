"""The CUDA sources' inputs that the CPU can check: the compiled-in
pattern tables, the build cache's key, the wrappers' refusals and the
SASS load counter.  (The kernels themselves run only on the card:
tests/test_torch_cuda.py.)"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from vslam_tpu_torch.frontend import cuda_build
from vslam_tpu_torch.frontend import dense_brief as db
from vslam_tpu_torch.frontend import fast_brief as fb

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
