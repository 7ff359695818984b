"""The box blur kernel's roofline bound, its launches a frame on each
staged route, and the reader of box_blur_roofline."""

import pytest

from perfbench import profile, spec, window
from perfbench.roofline import box_blur, dense_brief, fast_cells

NAME = ("void (anonymous namespace)::box_blur_kernel<{r}>(float const*, int, int, int, float,"
        " float*)")
# The route of each cell's configuration: (shape, octaves, launches a frame).
CELLS = {
    "proslam-kitti.loop1024": ((376, 1241), 2, 3),
    "proslam-kitti.firstlap256": ((376, 1241), 2, 3),
    "proslam-euroc.mh1024": ((480, 752), 2, 5),
}


def test_box_blur_bound():
    px = 2 * 480 * 752
    assert box_blur.work(2, 480, 752, 2) == (8 * px, 15 * px)
    assert box_blur.work(2, 480, 752, 7) == (8 * px, 45 * px)
    # The bytes bind at both radii: 8 bytes a pixel at 3.35 TB/s.
    for r in (2, 7):
        assert box_blur.least_seconds(2, 480, 752, r) == 8 * px / 3.35e12
    assert round(1e6 * box_blur.least_seconds(2, 480, 752, 7), 2) == 1.72
    # Far past any radius the port runs, the operations would bind.
    assert box_blur.least_seconds(1, 64, 64, 100) == 3 * 201 * 64 * 64 / 67e12


@pytest.mark.parametrize("descriptor, shape, octaves, want", [
    ("BRIEF256", (376, 1241), 2, [(2, 376, 1241, 2), (1, 188, 620, 2), (1, 188, 620, 2)]),
    ("BRIEF256", (376, 1241), 1, [(2, 376, 1241, 2)]),
    ("BRIEF256", (376, 1241), 3, [(2, 376, 1241, 2), (1, 188, 620, 2), (1, 188, 620, 2),
                                  (1, 94, 310, 2), (1, 94, 310, 2)]),
    ("BRIEF256R", (480, 752), 2, [(2, 480, 752, 2), (1, 480, 752, 2), (2, 480, 752, 7),
                                  (1, 480, 752, 2), (2, 480, 752, 7)]),
    ("ORB256", (480, 752), 2, []),
])
def test_frame_launches(descriptor, shape, octaves, want):
    assert box_blur.frame_launches(*shape, octaves, descriptor) == want


def test_frame_bounds():
    assert round(1e6 * sum(box_blur.least_seconds(*s) for s in
                           box_blur.frame_launches(376, 1241, 2, "BRIEF256")), 2) == 2.79
    assert round(1e6 * sum(box_blur.least_seconds(*s) for s in
                           box_blur.frame_launches(480, 752, 2, "BRIEF256R")), 2) == 6.90


def _slice(frames, launches, other=()):
    ks = [(NAME.format(r=r), 0, d) for r, d in launches] + [(n, 0, 1000) for n in other]
    return profile.Slice(frames=frames, window_s=1.0, busy_s=0.5, kernels=ks, device_ops=ks,
                         cpu=[])


def _frame_launches(cell):
    (H, W), octaves, _ = CELLS[cell]
    descriptor = "BRIEF256R" if "euroc" in cell else "BRIEF256"
    return box_blur.frame_launches(H, W, octaves, descriptor)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_box_blur_roofline_reads_only_the_launches_it_counts(cell):
    read = spec.reader("box_blur_roofline")
    shape, octaves, per_frame = CELLS[cell]
    w = window.Window(cell=cell, shape=shape, octaves=octaves)
    launches = _frame_launches(cell)
    assert len(launches) == per_frame
    frames = 4
    each = []
    for _ in range(frames):  # each launch at twice its bound
        each += [(s[3], round(2e9 * box_blur.least_seconds(*s))) for s in launches]
    w.trace = _slice(frames, each, other=["dense_brief_kernel<8, float, 0>",
                                          "fast_cells_kernel"])
    assert abs(read(w) - 50.0) < 0.05  # durations are whole nanoseconds
    for n in (len(each) - 1, len(each) + 1, frames):  # any other count reads nothing
        w.trace = _slice(frames, (each * 2)[:n])
        assert read(w) is None
    w.trace = _slice(frames, [], other=["dense_brief_kernel"])  # a program without it
    assert read(w) is None
    w.trace = None
    assert read(w) is None


def test_no_other_roofline_counts_the_box_blur():
    for r in (2, 7):
        name = NAME.format(r=r)
        assert dense_brief.SYMBOL not in name and fast_cells.SYMBOL not in name
    w = window.Window(cell="proslam-kitti.loop1024", shape=(376, 1241), octaves=2)
    frames = 2
    dense = [("void dense_brief_kernel<8, float, 0>(float const*, int, int, int, int*)", 0,
              10_000)] * (3 * frames)
    cells = [("fast_cells_kernel", 0, 10_000)] * (2 * frames)
    blur = [(NAME.format(r=2), 0, 5_000)] * (3 * frames)
    w.trace = profile.Slice(frames=frames, window_s=1.0, busy_s=0.5,
                            kernels=dense + cells + blur, device_ops=dense + cells + blur,
                            cpu=[])
    with_blur = {m: spec.reader(m)(w) for m in ("dense_brief_roofline", "fast_cells_roofline")}
    w.trace = profile.Slice(frames=frames, window_s=1.0, busy_s=0.5, kernels=dense + cells,
                            device_ops=dense + cells, cpu=[])
    assert with_blur == {m: spec.reader(m)(w) for m in with_blur}
    assert None not in with_blur.values()
