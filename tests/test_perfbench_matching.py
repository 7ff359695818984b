"""The reader of matching.match_us_per_frame: the descriptor matching
kernel's traced device time a frame."""

import pytest

from perfbench import profile, spec, window

TILES = ("void (anonymous namespace)::hamming_match_tiles_kernel<{form}>(int, int, int, "
         "(anonymous namespace)::Rows, (anonymous namespace)::Cols, "
         "(anonymous namespace)::Gate, (anonymous namespace)::Gate, "
         "(anonymous namespace)::Gate, unsigned int*, unsigned int*)")
RESOLVE = ("(anonymous namespace)::hamming_match_resolve_kernel(int, int, int, int, int, "
           "unsigned int const*, unsigned int const*, int const*, int, float, int*, "
           "unsigned char*, int*)")
OTHERS = ["void dense_brief_kernel<8, float, 0>(float const*, int, int, int, int*)",
          "fast_cells_kernel", "void (anonymous namespace)::box_blur_kernel<2>(float const*, "
          "int, int, int, float, float*)",
          "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<int>>"]
CELLS = ["proslam-kitti.loop1024", "proslam-kitti.firstlap256", "proslam-euroc.mh1024"]


def _call(form, tiles_ns, resolve_ns):
    """One match call's two launches."""
    return [(TILES.format(form=form), 0, tiles_ns), (RESOLVE, 0, resolve_ns)]


def _window(frames, kernels, cell=CELLS[0]):
    w = window.Window(cell=cell, shape=(376, 1241), octaves=2)
    w.trace = profile.Slice(frames=frames, window_s=1.0, busy_s=0.5, kernels=kernels,
                            device_ops=kernels, cpu=[])
    return w


@pytest.mark.parametrize("attempts", [[1, 1, 1, 1], [1, 2, 3, 1], [3, 3, 3, 3]])
def test_reads_the_kernel_us_a_frame(attempts):
    """A stereo call and 1-3 projective attempts a frame: the summed
    durations (ns) over the frames, in us, at any attempt count."""
    read = spec.reader("matching.match_us_per_frame")
    ks = []
    for n in attempts:
        ks += _call(0, 6_000, 2_000)
        for _ in range(n):
            ks += _call(1, 5_000, 2_000)
    want = 1e-3 * sum(d for _, _, d in ks) / len(attempts)
    assert read(_window(len(attempts), ks)) == pytest.approx(want)
    assert read(_window(len(attempts), ks)) == pytest.approx(
        (8.0 + 7.0 * sum(attempts) / len(attempts)))


@pytest.mark.parametrize("cell", CELLS)
def test_reads_nothing_without_the_kernel(cell):
    """The parent's program: the matching is element-wise torch kernels,
    none named for the kernel; no trace or no frame reads nothing too."""
    read = spec.reader("matching.match_us_per_frame")
    assert read(_window(4, [(n, 0, 1_000) for n in OTHERS] * 40, cell)) is None
    assert read(_window(4, [], cell)) is None
    w = _window(4, _call(0, 1, 1) * 8, cell)
    w.trace = None
    assert read(w) is None
    assert read(_window(0, _call(0, 1, 1) * 8, cell)) is None


@pytest.mark.parametrize("launches", [1, 3, 7])
def test_reads_nothing_below_two_launches_a_frame(launches):
    read = spec.reader("matching.match_us_per_frame")
    ks = (_call(0, 6_000, 2_000) * 4)[:launches]
    assert read(_window(4, ks)) is None
    assert read(_window(4, (_call(0, 6_000, 2_000) * 4)[:8])) == pytest.approx(8.0)


def test_other_kernels_do_not_count():
    read = spec.reader("matching.match_us_per_frame")
    ks = (_call(0, 6_000, 2_000) + _call(1, 5_000, 2_000)) * 2
    alone = read(_window(2, ks))
    mixed = read(_window(2, ks + [(n, 0, 50_000) for n in OTHERS] * 10))
    assert alone == mixed == pytest.approx(15.0)


def test_no_other_metric_reads_the_kernel():
    """The matching kernel's launches move no other kernel's roofline."""
    frames = 2
    ks = ([(OTHERS[0], 0, 10_000)] * 3 + [(OTHERS[1], 0, 10_000)] * 2
          + [(OTHERS[2], 0, 5_000)] * 3) * frames
    names = ("dense_brief_roofline", "fast_cells_roofline", "box_blur_roofline")
    w = _window(frames, ks)
    before = {m: spec.reader(m)(w) for m in names}
    w = _window(frames, ks + (_call(0, 6_000, 2_000) + _call(1, 5_000, 2_000)) * frames)
    assert before == {m: spec.reader(m)(w) for m in names}
    assert None not in before.values()


def test_the_metric_is_declared_for_every_cell():
    bench = spec.load()
    (m,) = [m for m in bench["per_layer"] if m["name"] == "matching.match_us_per_frame"]
    assert m["unit"] == "us/frame" and m["better"] == "lower" and m["moves"] == "fps"
    assert m["source"] == "device_trace" and sorted(m["workloads"]) == sorted(CELLS)
    for cell in CELLS:
        assert m in spec.metrics_for(bench, cell, True)
