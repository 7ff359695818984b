"""The staged FAST detector kernel's roofline bound and its reader."""

import pytest

from perfbench import profile, spec, window
from perfbench.roofline import fast_cells

NAME = ("void (anonymous namespace)::fast_cells_kernel(float const*, float const*, int, int,"
        " int, int, int, int, int, int, float*, int*)")


def test_fast_cells_bound_at_kitti_size():
    assert fast_cells.work(2, 376, 1241, 16) == (4 * 2 * 376 * 1241 + 8 * 2 * 23 * 77,
                                                 136 * 2 * 376 * 1241)
    assert round(1e6 * fast_cells.least_seconds(2, 376, 1241, 16), 2) == 1.89  # operations
    assert round(1e6 * fast_cells.least_seconds(2, 188, 620, 16), 2) == 0.47
    # A bin of one pixel: 12 bytes a pixel, and the bytes bound it.
    nbytes, _ = fast_cells.work(1, 64, 64, 1)
    assert fast_cells.least_seconds(1, 64, 64, 1) == nbytes / 3.35e12
    assert fast_cells.frame_launches(376, 1241, 2) == [(2, 376, 1241), (2, 188, 620)]
    assert fast_cells.frame_launches(376, 1241, 1) == [(2, 376, 1241)]


def _slice(frames, launches, other=()):
    ks = [(NAME, 0, d) for d in launches] + [(n, 0, 1000) for n in other]
    return profile.Slice(frames=frames, window_s=1.0, busy_s=0.5, kernels=ks, device_ops=ks,
                         cpu=[])


@pytest.mark.parametrize("cell", ["proslam-kitti.loop1024", "proslam-kitti.firstlap256"])
def test_fast_cells_roofline_reads_only_the_launches_it_counts(cell):
    read = spec.reader("fast_cells_roofline")
    w = window.Window(cell=cell, shape=(376, 1241), octaves=2)
    l0 = fast_cells.least_seconds(2, 376, 1241, 16)
    l1 = fast_cells.least_seconds(2, 188, 620, 16)
    frames = 4
    each = []
    for _ in range(frames):  # each launch at twice its bound
        each += [round(2e9 * l0), round(2e9 * l1)]
    w.trace = _slice(frames, each, other=["dense_brief_kernel", "fast_brief_tile_kernel"])
    assert abs(read(w) - 50.0) < 0.05  # durations are whole nanoseconds
    for n in (len(each) - 1, len(each) + 1, frames):  # any other count reads nothing
        w.trace = _slice(frames, (each * 2)[:n])
        assert read(w) is None
    w.trace = _slice(frames, [], other=["dense_brief_kernel"])  # a program without it
    assert read(w) is None
    w.trace = None
    assert read(w) is None
